"""Set-up of the program's data and state (program_span), in s: the
program's ``cdae.reset`` phase (the CSR, the padded rows, the tables, the
dense matrix) plus its ``cdae.batches`` phase (the epoch's batches built
on the device at their first use, in the first epoch of set-up). Phases
tally whether or not a profiler runs. None where the program has no
``cdae.reset`` phase, or where the traced stretch ran no work on the
device (a run on the CPU)."""


def read(t):
    if t.trace.busy_s <= 0:
        return None
    try:
        from cdae_tpu_torch.utils.profiling import tallies
    except ImportError:
        return None
    spans = tallies().spans
    if "cdae.reset" not in spans:
        return None
    return sum(spans.get(name, (0, 0.0))[1]
               for name in ("cdae.reset", "cdae.batches"))

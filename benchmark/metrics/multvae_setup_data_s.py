"""Set-up of Mult-VAE's data and state (program_span), in s: the
program's ``multvae.reset`` phase (the tables, Adam's moments, the CSR on
the device) plus one build of an epoch's permuted pairs, its
``multvae.pairs`` phase (set-up's first epoch builds one, every later
epoch one more: the mean of its calls). Phases tally whether or not a
profiler runs. None where the program has no ``multvae.reset`` phase, or
where the traced stretch ran no work on the device (a run on the CPU)."""


def read(t):
    if t.trace.busy_s <= 0:
        return None
    try:
        from cdae_tpu_torch.utils.profiling import tallies
    except ImportError:
        return None
    spans = tallies().spans
    if "multvae.reset" not in spans:
        return None
    calls, seconds = spans.get("multvae.pairs", (0, 0.0))
    return spans["multvae.reset"][1] + (seconds / calls if calls else 0.0)

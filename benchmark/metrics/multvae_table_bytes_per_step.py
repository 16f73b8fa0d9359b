"""Bytes of tables a Mult-VAE training step's Adam sweep moves
(program_counter): the program's ``table_bytes`` counter (each element of
the 8 tables: the table and both moments read and written, the gradient
read, reckoned from shapes) over its count of ``multvae.step`` spans. Both
tally only while a profiler runs: the traced stretch's steps. None where
the program has no such counter, or where no work ran on the device."""


def read(t):
    if t.kind != "train" or t.trace.busy_s <= 0:
        return None
    try:
        from cdae_tpu_torch.utils.profiling import tallies
    except ImportError:
        return None
    tl = tallies()
    steps, _ = tl.spans.get("multvae.step", (0, 0.0))
    moved = tl.counters.get("table_bytes")
    return moved / steps if steps and moved is not None else None

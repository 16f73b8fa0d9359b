"""Bytes of item tables a training step's update moves
(program_counter): the program's ``table_bytes`` counter (the item-side
tables, their accumulators and gradients that the sparse step's B2 apply,
or its row update, reads and writes, reckoned from shapes) over its count
of ``cdae.step`` spans. Both tally only while a profiler runs: the traced
stretch's steps. None where the program has no such counter (the dense
step, a program without it), or where no work ran on the device."""


def read(t):
    if t.kind != "train" or t.trace.busy_s <= 0:
        return None
    try:
        from cdae_tpu_torch.utils.profiling import tallies
    except ImportError:
        return None
    tl = tallies()
    steps, _ = tl.spans.get("cdae.step", (0, 0.0))
    moved = tl.counters.get("table_bytes")
    return moved / steps if steps and moved is not None else None

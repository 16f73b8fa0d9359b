"""Host time of a training step's pooled negatives (program_span): the
program's ``cdae.step.pool`` seconds over its count of ``cdae.step``
spans, in ms, over the traced stretch (the only stretch in which the
program tallies its spans): the host's enqueue of the pool's block under
the profiler. None where the program has no such span (exact negatives,
the dense step, a program without it), or where no work ran on the
device."""


def read(t):
    if t.kind != "train" or t.trace.busy_s <= 0:
        return None
    try:
        from cdae_tpu_torch.utils.profiling import tallies
    except ImportError:
        return None
    spans = tallies().spans
    steps, _ = spans.get("cdae.step", (0, 0.0))
    calls, seconds = spans.get("cdae.step.pool", (0, 0.0))
    return 1e3 * seconds / steps if steps and calls else None

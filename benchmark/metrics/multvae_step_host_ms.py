"""Host time a Mult-VAE training step (program_span): the mean of the
program's ``multvae.step`` spans, in ms. The program tallies its spans
only while a profiler runs, so this is the traced stretch's: the host's
enqueue of a step under the profiler, to set beside
``train_step_device_ms``. None where the program has no such span, or
where no work ran on the device."""


def read(t):
    if t.kind != "train" or t.trace.busy_s <= 0:
        return None
    try:
        from cdae_tpu_torch.utils.profiling import tallies
    except ImportError:
        return None
    calls, seconds = tallies().spans.get("multvae.step", (0, 0.0))
    return 1e3 * seconds / calls if calls else None

"""Host time of a request's rows (program_span): the mean of the
program's ``serve.rows`` spans (``rows_from_csr`` and the copies of its
arrays to the device), in ms, over the traced stretch, the only stretch
in which the program tallies its spans. None where the program has no
such span, or where no work ran on the device."""


def read(t):
    if t.kind != "serve" or t.trace.busy_s <= 0:
        return None
    try:
        from cdae_tpu_torch.utils.profiling import tallies
    except ImportError:
        return None
    calls, seconds = tallies().spans.get("serve.rows", (0, 0.0))
    return 1e3 * seconds / calls if calls else None

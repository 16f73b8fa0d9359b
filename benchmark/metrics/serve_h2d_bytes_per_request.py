"""Bytes copied from host to device a request (program_counter): the
program's ``h2d_bytes`` counter (every host array its models copy to a
CUDA device) over the count of its ``serve.request`` spans. Both tally
only while a profiler runs: the traced stretch's requests. None where the
program has no such counter or span, or where no work ran on the
device."""


def read(t):
    if t.kind != "serve" or t.trace.busy_s <= 0:
        return None
    try:
        from cdae_tpu_torch.utils.profiling import tallies
    except ImportError:
        return None
    tl = tallies()
    calls, _ = tl.spans.get("serve.request", (0, 0.0))
    copied = tl.counters.get("h2d_bytes")
    return copied / calls if calls and copied is not None else None

"""Share of the traced stretch in which no operation ran on the device
(device_trace), in %. One reader for ``device_idle_share.<kind>``, each
name listing its cells in BENCHMARK.json."""


def read(t):
    if t.trace.window_s <= 0 or t.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.trace.busy_s / t.trace.window_s)

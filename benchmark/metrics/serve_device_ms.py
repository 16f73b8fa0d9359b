"""Device time a request (device_trace): the union of device work in the
traced requests over their count, in ms. One reader for
``serve_device_ms.<mix>``, each name listing its cells in BENCHMARK.json."""


def read(t):
    if t.kind != "serve" or t.units <= 0 or t.trace.busy_s <= 0:
        return None
    return 1e3 * t.trace.busy_s / t.units

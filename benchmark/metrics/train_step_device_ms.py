"""Device time a training step (device_trace): the union of device work
in the traced epochs over their steps, in ms."""


def read(t):
    if t.kind != "train" or t.units <= 0 or t.trace.busy_s <= 0:
        return None
    return 1e3 * t.trace.busy_s / t.units

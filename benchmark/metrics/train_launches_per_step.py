"""Kernel launches a training step (device_trace): kernels in the traced
epochs over their steps. Layer: the epoch loop."""


def read(t):
    if t.kind != "train" or t.units <= 0 or t.trace.kernels == 0:
        return None
    return t.trace.kernels / t.units

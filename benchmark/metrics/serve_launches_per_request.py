"""Kernel launches a request (device_trace): kernels in the traced
requests over their count."""


def read(t):
    if t.kind != "serve" or t.units <= 0 or t.trace.kernels == 0:
        return None
    return t.trace.kernels / t.units

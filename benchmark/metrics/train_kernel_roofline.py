"""The hand kernels' share of their roofline in the training cells
(device_trace): the least time of every counted launch (harness/counts.py)
over their traced device time, in %."""


def read(t):
    if t.kind != "train":
        return None
    return t.roofline

"""The training step's share of the card's peak (host_clock): the needed
FLOPs of the untraced window's steps (harness/counts.py train_user_flops)
over its wall time and 495 TFLOP/s, in %."""

from benchmark.harness.counts import TF32_FLOPS_PER_S


def read(t):
    if t.kind != "train" or t.window_s <= 0 or t.window_flops <= 0:
        return None
    return 100.0 * t.window_flops / t.window_s / TF32_FLOPS_PER_S

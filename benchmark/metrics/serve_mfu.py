"""Serving's share of the card's peak (host_clock): the needed FLOPs of
the untraced window's requests (harness/counts.py serve_flops: encoder
and full-catalog decode) over its wall time and 495 TFLOP/s, in %."""

from benchmark.harness.counts import TF32_FLOPS_PER_S


def read(t):
    if t.kind != "serve" or t.window_s <= 0 or t.window_flops <= 0:
        return None
    return 100.0 * t.window_flops / t.window_s / TF32_FLOPS_PER_S

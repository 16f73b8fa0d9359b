"""Input mask-out (denoising) corruption (port of
cdae_tpu/ops/corruption.py).

Each observed item is independently KEPT when its uniform draw exceeds
``ratio``, i.e. with probability (1 - ratio). When ``scaled`` is on, kept
inputs are multiplied by 1/(1 - ratio). The caller passes the uniforms, so
the same draws can be fed to cdae_tpu and to the port.
"""

from __future__ import annotations

import torch


def corrupt_mask(
    uniforms: torch.Tensor,  # (B, L) f32 in [0, 1)
    mask: torch.Tensor,  # (B, L) bool -- real (unpadded) positions
    corruption_ratio: float,
) -> torch.Tensor:
    """Bernoulli keep-mask over real positions; (B, L) bool."""
    if corruption_ratio <= 0.0:
        return mask
    return mask & (uniforms > corruption_ratio)


def input_scale(corruption_ratio: float, scaled: bool) -> float:
    """Input rescale factor for the kept items."""
    if scaled and corruption_ratio < 1.0:
        return 1.0 / (1.0 - corruption_ratio)
    return 1.0

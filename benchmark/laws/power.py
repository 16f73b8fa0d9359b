"""Popularity law: the item of popularity rank r (from 0) is drawn with
weight (r + 1) ** -``popularity_exponent``."""

from __future__ import annotations

import torch


def log_weights(data: dict, rank: torch.Tensor) -> torch.Tensor:
    """The log weight of each item from its rank (float32, on the
    generator's device)."""
    return -float(data["popularity_exponent"]) * torch.log1p(rank)

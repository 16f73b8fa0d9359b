"""Batched masked top-k over the item catalog (port of cdae_tpu/ops/topk.py).

Each user's rated items are set to -inf, then the k best columns are taken
with ``jax.lax.top_k``'s order: larger score first, lower item id first on
equal scores (a stable descending sort gives exactly that).
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def stable_topk(x: torch.Tensor, k: int):
    """(vals, idx) of the k largest entries per row; ties keep the lower
    column first, as ``lax.top_k`` does (``torch.topk`` does not promise
    an order among ties)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def mask_rated(
    scores: torch.Tensor,  # (B, I) float
    rated_items: torch.Tensor,  # (B, L) int, padded with I (out of range)
) -> torch.Tensor:
    """Set each user's rated item scores to -inf (padding ids >= I are
    dropped, like an out-of-bounds scatter in JAX)."""
    B, I = scores.shape
    # scatter into one spare column that absorbs every out-of-range id
    ext = torch.cat([scores, scores.new_zeros((B, 1))], dim=1)
    col = torch.where((rated_items >= 0) & (rated_items < I), rated_items, I)
    ext.scatter_(1, col.long(), NEG_INF)
    return ext[:, :I]


def topk_unrated(
    scores: torch.Tensor,  # (B, I)
    rated_items: torch.Tensor,  # (B, L) padded with I
    k: int,
):
    """Top-k item ids + scores excluding rated items. Returns (ids, vals).

    Catalogs smaller than k are padded with -inf slots whose ids come back
    as the sentinel ``I`` (never matches a real item in the metrics)."""
    I = scores.shape[1]
    masked = mask_rated(scores, rated_items)
    if I < k:
        pad = masked.new_full((masked.shape[0], k - I), NEG_INF)
        masked = torch.cat([masked, pad], dim=1)
    vals, ids = stable_topk(masked, k)
    ids = torch.where(ids >= I, I, ids)
    return ids.to(torch.int32), vals

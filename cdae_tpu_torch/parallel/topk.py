"""Distributed full-catalog top-k with rated-item exclusion (port of
cdae_tpu/parallel/topk.py).

Score columns live item-sharded over the 'model' axis: each rank takes a
LOCAL top-k over its item block, the (n_model * k) candidates are
all-gathered over 'model', and the final top-k is taken from them --
O(k * n_model) values on the wire instead of O(num_items).
"""

from __future__ import annotations

import torch

from cdae_tpu_torch.ops.topk import NEG_INF, stable_topk
from cdae_tpu_torch.parallel.mesh import Mesh


def local_rated(rated_items: torch.Tensor, offset: int, width: int
                ) -> torch.Tensor:
    """Global rated ids (padded with any id >= the catalog) as columns of
    the block [offset, offset + width): ids outside it become ``width``."""
    local = rated_items.long() - offset
    in_shard = (local >= 0) & (local < width)
    return torch.where(in_shard, local, width)


def merge_topk(mesh: Mesh, vals: torch.Tensor, gids: torch.Tensor, k: int):
    """The top-k of every rank's (B, k) candidates of a 'model' group:
    all-gathered in rank order (ascending global ids), then a stable sort,
    so equal scores keep the lower global id, as ``lax.top_k`` does."""
    all_vals = mesh.all_gather(vals, "model", dim=1)
    all_ids = mesh.all_gather(gids, "model", dim=1)
    fvals, fidx = stable_topk(all_vals, k)
    return all_ids.gather(1, fidx).to(torch.int32), fvals


def distributed_topk_unrated(
    mesh: Mesh,
    scores: torch.Tensor,  # (B, I / n_model): this rank's item block
    rated_items: torch.Tensor,  # (B, L) GLOBAL ids, padded with I
    k: int,
):
    """Top-k ids + scores per user over an item-sharded score matrix.

    ``scores`` is this rank's block of columns [m * w, (m + 1) * w); every
    rank of a 'model' group passes its block of the same users. Returns
    (ids, vals), ids GLOBAL, equal on every rank of the group."""
    B, width = scores.shape
    offset = mesh.m * width
    col = local_rated(rated_items, offset, width)
    ext = torch.cat([scores, scores.new_zeros((B, 1))], dim=1)
    ext.scatter_(1, col, NEG_INF)  # the spare column absorbs the rest
    vals, ids = stable_topk(ext[:, :width], k)
    return merge_topk(mesh, vals, ids.long() + offset, k)

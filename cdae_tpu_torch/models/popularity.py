"""Global item-popularity baseline (port of cdae_tpu/models/popularity.py).

The item counts of the training data are the scores; a user's list is the
most popular items they have not rated. ``cdae_tpu``'s CLI trains and
evaluates it before every ``--task train``, and so does the port's.
"""

from __future__ import annotations

import numpy as np
import torch

from cdae_tpu_torch.data.dataset import Interactions
from cdae_tpu_torch.models.base import ModelState, RecsysModel, resolve_device
from cdae_tpu_torch.ops.sampling import is_rated
from cdae_tpu_torch.ops.topk import stable_topk, topk_unrated


def _pop_topk(counts: torch.Tensor, rated_items: torch.Tensor,
              rated_mask: torch.Tensor, k: int, cand: int) -> torch.Tensor:
    """Top-k unrated ids (B, k) by popularity: the ``cand`` most popular
    items (ties by lower id), each tested against the rated rows, and the
    first k survivors of each row. When some row keeps fewer than k of the
    candidates, the batch falls back to the full masked top-k, so the
    answer is exact for every batch."""
    B = rated_items.shape[0]
    I = counts.shape[0]
    cand = min(cand, I)
    _, top_ids = stable_topk(counts[None, :], cand)
    top_ids = top_ids[0]
    lengths = rated_mask.sum(dim=1)
    ok = ~is_rated(rated_items, lengths, top_ids)  # (B, cand)
    if bool((ok.sum(dim=1) < min(k, I)).any()):
        ids, _ = topk_unrated(counts[None, :].expand(B, I), rated_items, k)
        return ids
    rank = torch.cumsum(ok, dim=1) - ok.to(torch.int64)
    slot = torch.where(ok & (rank < k), rank, k)  # the target slot, or drop
    out = torch.full((B, k + 1), I, dtype=torch.int32, device=counts.device)
    out.scatter_(1, slot, top_ids.to(torch.int32)[None, :].expand(B, cand))
    return out[:, :k]


class Popularity(RecsysModel):
    name = "Popularity"

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def reset(self, data: Interactions, seed: int = 0) -> ModelState:
        counts = np.bincount(data.items, minlength=data.num_items).astype(
            np.float32)
        return ModelState(
            params={"counts": self._tensor(counts)},
            padded=data.padded(),
            num_users=data.num_users,
            num_items=data.num_items,
        )

    def train_one_iteration(self, state, seed: int = 0):
        return state  # counting is the whole training

    def batch_scores(self, state, uids, rated_items, rated_mask):
        B = len(uids)
        return state.params["counts"][None, :].expand(B, state.num_items)

    def batch_topk(self, state, uids, rated_items, rated_mask, k: int = 10):
        """The candidate walk of ``_pop_topk`` (the evaluator takes it
        instead of building (B, I) broadcast scores)."""
        return _pop_topk(state.params["counts"], self._tensor(rated_items),
                         self._tensor(rated_mask), k, 128)

    def predict(self, state, users, items):
        return state.params["counts"][self._tensor(items, torch.long)]

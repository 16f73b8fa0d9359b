"""Model protocol + user batching (port of cdae_tpu/models/base.py).

The protocol the solver and evaluators rely on:

  reset(data, seed)          -> state (parameters on the model's device)
  train_one_iteration(state, seed) -> state (one epoch; params in place)
  current_loss(state, sample_size) = data_loss + penalty_loss
  batch_scores(state, uids, rated_items, rated_mask) -> (B, num_items)
  batch_topk(state, uids, rated_items, rated_mask, k) -> (B, k) ids | None
  predict(state, users, items) -> per-pair predictions
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from cdae_tpu_torch.data.dataset import Interactions, PaddedUserBatch


@dataclasses.dataclass
class UserMinibatch:
    """A fixed-size slice of the users (last batch padded, weight 0)."""

    uids: np.ndarray  # (B,)
    items: np.ndarray  # (B, L) sorted asc, padded with num_items
    ratings: np.ndarray  # (B, L)
    mask: np.ndarray  # (B, L) bool
    lengths: np.ndarray  # (B,)
    weight: np.ndarray  # (B,) 1.0 for real rows, 0.0 for batch padding


def ceil_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def iter_user_batches(
    pb: PaddedUserBatch,
    batch_size: int,
    bucket_by_length: bool = False,
) -> Iterator[UserMinibatch]:
    """Slice all users into fixed-size minibatches; pads the last batch.
    ``bucket_by_length`` sorts users by interaction count and trims each
    batch's item axis to the next power of two of its longest row."""
    U = pb.num_users
    order = (np.argsort(pb.lengths, kind="stable") if bucket_by_length
             else np.arange(U))
    for start in range(0, U, batch_size):
        sel = order[start : start + batch_size]
        pad = batch_size - len(sel)
        weight = np.ones(batch_size, dtype=np.float32)
        if pad > 0:
            sel = np.concatenate([sel, np.zeros(pad, dtype=sel.dtype)])
            weight[batch_size - pad :] = 0.0
        items = pb.items[sel]
        ratings = pb.ratings[sel]
        mask = pb.mask[sel]
        lengths = pb.lengths[sel] * weight.astype(np.int32)
        if bucket_by_length:
            L = min(ceil_pow2(max(int(lengths.max()), 1)), pb.max_len)
            items = items[:, :L]
            ratings = ratings[:, :L]
            mask = mask[:, :L]
        yield UserMinibatch(
            uids=pb.uids[sel],
            items=items,
            ratings=ratings,
            mask=mask & (weight[:, None] > 0),
            lengths=lengths,
            weight=weight,
        )


def iter_user_batches_csr(
    csr,
    num_items: int,
    batch_size: int,
    bucket_by_length: bool = True,
) -> Iterator[UserMinibatch]:
    """Fixed-size user minibatches straight from CSR, without the full
    (U, max_len) padded matrix; same batches as ``iter_user_batches``
    over ``Interactions.padded()``."""
    lengths_all = csr.row_lengths().astype(np.int32)
    U = len(lengths_all)
    global_max = max(int(lengths_all.max()) if U else 1, 1)
    order = (np.argsort(lengths_all, kind="stable") if bucket_by_length
             else np.arange(U))
    for start in range(0, U, batch_size):
        sel = order[start : start + batch_size]
        pad = batch_size - len(sel)
        weight = np.ones(batch_size, dtype=np.float32)
        if pad > 0:
            sel = np.concatenate([sel, np.zeros(pad, sel.dtype)])
            weight[batch_size - pad :] = 0.0
        lengths = lengths_all[sel] * weight.astype(np.int32)
        L = min(ceil_pow2(max(int(lengths.max()), 1)), global_max)
        items = np.full((batch_size, L), num_items, dtype=np.int32)
        ratings = np.zeros((batch_size, L), dtype=np.float32)
        counts = np.minimum(lengths, L).astype(np.int64)
        total = int(counts.sum())
        if total:
            row_of = np.repeat(np.arange(batch_size), counts)
            cum0 = np.concatenate([[0], np.cumsum(counts)[:-1]])
            pos = np.arange(total) - np.repeat(cum0, counts)
            src = np.repeat(csr.indptr[sel], counts) + pos
            items[row_of, pos] = csr.indices[src]
            ratings[row_of, pos] = csr.values[src]
        lengths = np.minimum(lengths, L)
        yield UserMinibatch(
            uids=sel.astype(np.int32),
            items=items,
            ratings=ratings,
            mask=np.arange(L)[None, :] < lengths[:, None],
            lengths=lengths,
            weight=weight,
        )


@dataclasses.dataclass
class ModelState:
    """Parameters (a dict of tensors on the model's device) + the host
    views of the training data a model scores from."""

    params: dict
    padded: Optional[PaddedUserBatch]
    num_users: int
    num_items: int
    step: int = 0
    aux: dict = dataclasses.field(default_factory=dict)


class RecsysModel:
    """Base class; concrete models implement the protocol methods."""

    name = "RecsysModel"

    def reset(self, data: Interactions, seed: int = 0):
        raise NotImplementedError

    def train_one_iteration(self, state, seed: int = 0):
        """One epoch; ``seed`` is the solver's, the step seeds derive from
        it and ``state.step``."""
        raise NotImplementedError

    def current_loss(self, state, sample_size: int = 0) -> float:
        """data_loss + penalty_loss (``sample_size`` goes to data_loss)."""
        return self.data_loss(state, sample_size) + self.penalty_loss(state)

    def data_loss(self, state, sample_size: int = 0) -> float:
        """Training-data loss estimate. ``sample_size`` > 0 asks for an
        estimate over that many instances, 0 for the full dataset; models
        that do not subsample ignore it, as in cdae_tpu."""
        return 0.0

    def penalty_loss(self, state) -> float:
        return 0.0

    def batch_scores(self, state, uids, rated_items, rated_mask):
        """Full-catalog scores for a user minibatch; (B, num_items)."""
        raise NotImplementedError

    def predict(self, state, users, items):
        """Pointwise predictions for (user, item) pairs."""
        raise NotImplementedError

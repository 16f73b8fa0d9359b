"""Grouped sparse feature instances for the feature-group models (port of
cdae_tpu/data/instances.py).

Each instance carries features that live in feature GROUPS; a feature's
global index is its in-group index plus the group's offset. LinearModel,
FactorModel and NegMF (models/linear.py) train on this view.

Dense layout, numpy on the host as in cdae_tpu (the models move what they
need to their device): ``idx (N, F) int32`` global feature indices,
``vals (N, F)`` float32, ``mask (N, F)`` bool for ragged instances, and a
static ``group_of (F,)`` map saying which group each slot belongs to (the
factor model's interactions only span slots of different groups).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from cdae_tpu_torch.data.dataset import Interactions


@dataclasses.dataclass
class GroupedInstances:
    idx: np.ndarray  # (N, F) int32 global feature indices
    vals: np.ndarray  # (N, F) float32
    mask: np.ndarray  # (N, F) bool
    labels: np.ndarray  # (N,) float32
    group_of: Tuple[int, ...]  # static: group id of each feature slot
    group_dims: Tuple[int, ...]  # per-group dimension
    total_dim: int

    def __len__(self) -> int:
        return self.idx.shape[0]

    def head(self, n: int) -> "GroupedInstances":
        """The first ``n`` instances, in dataset order (the unit of
        ``data_loss(sample_size)``)."""
        n = min(int(n), len(self))
        return GroupedInstances(
            idx=self.idx[:n], vals=self.vals[:n], mask=self.mask[:n],
            labels=self.labels[:n], group_of=self.group_of,
            group_dims=self.group_dims, total_dim=self.total_dim,
        )

    @property
    def num_slots(self) -> int:
        return self.idx.shape[1]

    @classmethod
    def from_interactions(cls, data: Interactions) -> "GroupedInstances":
        """The recsys schema: group 0 is the user id, group 1 the item id
        at offset ``num_users``, every value 1, the rating as the label."""
        n = len(data)
        idx = np.stack(
            [data.users.astype(np.int32),
             (data.items + data.num_users).astype(np.int32)],
            axis=1,
        )
        return cls(
            idx=idx,
            vals=np.ones((n, 2), dtype=np.float32),
            mask=np.ones((n, 2), dtype=bool),
            labels=data.ratings.astype(np.float32),
            group_of=(0, 1),
            group_dims=(data.num_users, data.num_items),
            total_dim=data.num_users + data.num_items,
        )

    @classmethod
    def from_arrays(
        cls,
        group_indices: Sequence[np.ndarray],  # per-group (N,) in-group idx
        group_dims: Sequence[int],
        labels: np.ndarray,
        group_values: Optional[Sequence[np.ndarray]] = None,
    ) -> "GroupedInstances":
        """One slot per group: ``group_indices[g]`` offset by the dims of
        the groups before it; values 1 unless ``group_values`` gives
        them."""
        offsets = np.concatenate([[0], np.cumsum(group_dims)])[:-1]
        cols = [
            np.asarray(gi, dtype=np.int32) + int(off)
            for gi, off in zip(group_indices, offsets)
        ]
        idx = np.stack(cols, axis=1)
        n, f = idx.shape
        if group_values is None:
            vals = np.ones((n, f), dtype=np.float32)
        else:
            vals = np.stack(
                [np.asarray(v, dtype=np.float32) for v in group_values], axis=1
            )
        return cls(
            idx=idx,
            vals=vals,
            mask=np.ones((n, f), dtype=bool),
            labels=np.asarray(labels, dtype=np.float32),
            group_of=tuple(range(len(group_dims))),
            group_dims=tuple(int(d) for d in group_dims),
            total_dim=int(sum(group_dims)),
        )

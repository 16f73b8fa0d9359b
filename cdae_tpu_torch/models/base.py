"""Model protocol + user batching (port of cdae_tpu/models/base.py).

The protocol the solver and evaluators rely on:

  reset(data, seed)          -> state (parameters on the model's device)
  train_one_iteration(state, seed) -> state (one epoch; params in place)
  current_loss(state, sample_size) = data_loss + penalty_loss
  batch_scores(state, uids, rated_items, rated_mask) -> (B, num_items)
  batch_topk(state, uids, rated_items, rated_mask, k) -> (B, k) ids | None
  topk_ids(state, uids, rated_items, rated_mask, k) -> (B, k) ids
  predict(state, users, items) -> per-pair predictions
  recommend(state, uids, train_data, k) -> (B, k) top-k unrated ids
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from cdae_tpu_torch.data.dataset import Interactions, PaddedUserBatch
from cdae_tpu_torch.ops.pallas_kernels import csr_rows
from cdae_tpu_torch.ops.topk import topk_unrated
from cdae_tpu_torch.parallel.mesh import Collectives, Mesh
from cdae_tpu_torch.utils.profiling import count, profiler_active, span

# the auto rule of dense_mode (cdae_tpu's): the int8 dense_R holds U * I
# cells, and a dense step's ~10 f32 (B, I) slabs take batch_size * I * 40
# bytes (tests lower these to drive the sparse steps at fixture scale)
_DENSE_MAX_CELLS = 1_500_000_000
_DENSE_MAX_SLAB_BYTES = 4_000_000_000


def dense_fits(num_users: int, num_items: int, batch_size: int) -> bool:
    """Whether dense mode's int8 (U, I) matrix and its (B, I) slabs fit
    (the rule ``dense_mode=None`` follows); ``batch_size`` 0 asks of the
    matrix alone."""
    return (num_users * num_items <= _DENSE_MAX_CELLS
            and batch_size * num_items * 40 <= _DENSE_MAX_SLAB_BYTES)


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
    slots_per_batch: Optional[int] = None,
) -> Iterator[UserMinibatch]:
    """User minibatches straight from CSR, without the full (U, max_len)
    padded matrix; with a fixed ``batch_size`` the same batches as
    ``iter_user_batches`` over ``Interactions.padded()``.

    ``slots_per_batch`` (token-budget batching): the batch size adapts per
    pow-2 length bucket so that B * L stays near the budget, B =
    clamp(pow2(slots / L), 8, batch_size), one shape per bucket. On a
    heavy-tailed degree distribution this keeps the long buckets' (B, L, D)
    gradient temporaries bounded while the short buckets keep large
    batches; only the minibatch cadence of AdaGrad changes."""
    lengths_all = csr.row_lengths().astype(np.int32)
    U = len(lengths_all)
    global_max = max(int(lengths_all.max()) if U else 1, 1)
    order = (np.argsort(lengths_all, kind="stable") if bucket_by_length
             else np.arange(U))

    def emit(sel, B):
        pad = B - len(sel)
        weight = np.ones(B, dtype=np.float32)
        if pad > 0:
            sel = np.concatenate([sel, np.zeros(pad, sel.dtype)])
            weight[B - pad :] = 0.0
        lengths = lengths_all[sel] * weight.astype(np.int32)
        L = min(ceil_pow2(max(int(lengths.max()), 1)), global_max)
        items = np.full((B, L), num_items, dtype=np.int32)
        ratings = np.zeros((B, L), dtype=np.float32)
        counts = np.minimum(lengths, L).astype(np.int64)
        total = int(counts.sum())
        if total:
            row_of = np.repeat(np.arange(B), counts)
            cum0 = np.concatenate([[0], np.cumsum(counts)[:-1]])
            pos = np.arange(total) - np.repeat(cum0, counts)
            src = np.repeat(csr.indptr[sel], counts) + pos
            items[row_of, pos] = csr.indices[src]
            ratings[row_of, pos] = csr.values[src]
        lengths = np.minimum(lengths, L)
        return UserMinibatch(
            uids=sel.astype(np.int32),
            items=items,
            ratings=ratings,
            mask=np.arange(L)[None, :] < lengths[:, None],
            lengths=lengths,
            weight=weight,
        )

    if slots_per_batch:
        if not bucket_by_length:
            raise ValueError("slots_per_batch requires bucket_by_length")
        buckets = _length_buckets(lengths_all[order], global_max)
        for start, end, B in _bucket_runs(buckets, batch_size,
                                          slots_per_batch):
            for s in range(start, end, B):
                yield emit(order[s:min(s + B, end)], B)
        return
    for start in range(0, U, batch_size):
        yield emit(order[start : start + batch_size], batch_size)


def _length_buckets(sorted_lengths: np.ndarray, global_max: int
                    ) -> np.ndarray:
    """The pow-2 item-axis length of each user, in ascending length order,
    capped at the longest row as the batches cap it."""
    pow2 = np.vectorize(ceil_pow2, otypes=[np.int64])(
        np.maximum(sorted_lengths, 1))
    return np.minimum(pow2, global_max)


def _bucket_runs(buckets: np.ndarray, batch_size: int, slots: int):
    """(start, end, B) of each length bucket of the sorted users, with the
    bucket's batch size fit to the ``slots`` budget."""
    start, U = 0, len(buckets)
    while start < U:
        Lb = int(buckets[start])
        end = start + int(np.searchsorted(buckets[start:], Lb, "right"))
        B = slots // max(Lb, 1)
        B = max(8, min(batch_size, 1 << max(int(B).bit_length() - 1, 3)))
        yield start, end, B
        start = end


def count_user_batches_csr(
    csr,
    batch_size: int,
    slots_per_batch: Optional[int] = None,
) -> int:
    """The number of batches ``iter_user_batches_csr`` yields for the same
    arguments, from the row lengths alone (no batch arrays), so a caller
    can stride over an epoch without building it."""
    lengths_all = csr.row_lengths().astype(np.int32)
    U = len(lengths_all)
    if not slots_per_batch:
        return -(-U // batch_size) if U else 0
    global_max = max(int(lengths_all.max()) if U else 1, 1)
    buckets = _length_buckets(np.sort(lengths_all), global_max)
    return sum(-(-(end - start) // B) for start, end, B
               in _bucket_runs(buckets, batch_size, slots_per_batch))


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; a CUDA device without a usable GPU
    raises (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


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
    """Base class; concrete models implement the protocol methods. Models
    that hold tensors set ``device``."""

    name = "RecsysModel"
    # the process mesh a sharded wrapper runs its inner model on; None: one
    # process (a 1 x 1 mesh on the model's device)
    mesh: Optional[Mesh] = None

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        """``x`` as a tensor on the model's device; the bytes of a host
        array copied to a CUDA device count in ``h2d_bytes`` while a
        profiler runs."""
        if (profiler_active() and self.device.type == "cuda"
                and not isinstance(x, torch.Tensor)):
            count("h2d_bytes", np.asarray(x).nbytes)
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _collectives(self, num_users: int, num_items: int) -> Collectives:
        """The step collectives of a model of these dimensions on its mesh:
        on one process every collective returns its input and every block
        is the whole table."""
        mesh = self.mesh if self.mesh is not None else Mesh(1, 1,
                                                            self.device)
        return mesh.collectives(num_users, num_items)

    def _dense_R(self, data) -> torch.Tensor:
        """The int8 (U, I) interaction matrix dense_R on the device: this
        rank's block of it on a mesh, the whole matrix on one process."""
        coll = self._collectives(data.num_users, data.num_items)
        return coll.dense_block(self._tensor(data.users, torch.long),
                                self._tensor(data.items, torch.long))

    def _dense_user_batches(self, state: ModelState):
        """(k, B) uid and weight tensors of a user-slab route (B =
        ``cfg.batch_size`` capped at U), built once per state: ``arange(k *
        B) % U``, so the last batch wraps around to uid 0 with weight 0."""
        if "dense_batches" not in state.aux:
            U = state.num_users
            B = min(self.cfg.batch_size, max(U, 1))
            k = max(-(-U // B), 1)
            uids = np.arange(k * B, dtype=np.int64) % max(U, 1)
            weight = (np.arange(k * B) < U).astype(np.float32)
            state.aux["dense_batches"] = (
                self._tensor(uids.reshape(k, B)),
                self._tensor(weight.reshape(k, B)),
            )
        return state.aux["dense_batches"]

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

    def batch_topk(self, state, uids, rated_items, rated_mask, k: int = 10):
        """(B, k) top-k unrated ids by a model's own route, or None: the
        caller then scores the whole (B, I) slab (``topk_ids``)."""
        return None

    def topk_ids(self, state, uids, rated_items, rated_mask, k: int = 10
                 ) -> torch.Tensor:
        """(B, k) top-k unrated ids of a batch: the model's ``batch_topk``
        where it answers, else one ``batch_scores`` over the whole (B, I)
        slab, then ``topk_unrated``. Both rank alike: the larger score
        first, the lower id first on equal scores."""
        ids = self.batch_topk(state, uids, rated_items, rated_mask, k)
        if ids is None:
            with span("serve.scores"):
                scores = self.batch_scores(state, uids, rated_items,
                                           rated_mask)
            with span("serve.topk"):
                ids, _ = topk_unrated(scores, rated_items, k)
        return ids

    def predict(self, state, users, items):
        """Pointwise predictions for (user, item) pairs."""
        raise NotImplementedError

    def _rated_rows(self, uids: np.ndarray, d_uids: torch.Tensor,
                    data: Interactions):
        """(B, L) int32 rated items, padded with ``num_items``, and their
        bool mask on the model's device for the users ``uids`` (``d_uids``:
        the same, int64 on the device): the rows ``rows_from_csr`` gives,
        built there from the device copy of ``data``'s CSR. L (the longest
        row, at least 1) comes from the host CSR, so nothing waits for the
        device."""
        indptr = data.csr().indptr
        lengths = indptr[uids + 1] - indptr[uids]
        L = max(int(lengths.max()) if len(uids) else 1, 1)
        d_indptr, d_indices = data.csr_on(self.device, self._tensor)
        return csr_rows(d_indptr, d_indices, d_uids, L, data.num_items)

    def recommend(self, state, uids, train_data: Interactions,
                  k: int = 10) -> torch.Tensor:
        """Top-k UNRATED item ids per user, the library's serving call
        (ref recsys_model_base.hpp:77-104: a per-user heap scan of the
        whole catalog). ``train_data`` gives the rated sets to exclude and
        the input of models that score from the rated rows (CDAE). The
        rated rows are built on the model's device (``csr_rows``) from
        ``train_data``'s CSR, copied there by the first request and kept;
        the top-k is ``topk_ids`` (CDAE's fused decode + top-k over a large
        catalog, else the (B, I) slab). Returns (B, k) int32 ids on the
        model's device; id == num_items marks a slot past a user's unrated
        items (a catalog smaller than k, or a user who rated all but fewer
        than k of it)."""
        with span("serve.request"):
            uids = np.array(uids, dtype=np.int64).reshape(-1)  # contiguous
            with span("serve.rows"):
                if len(uids) and (uids.min() < 0
                                  or uids.max() >= train_data.num_users):
                    raise IndexError(
                        f"uids outside [0, {train_data.num_users})")
                d_uids = self._tensor(uids)  # one copy for rows and top-k
                rated, mask = self._rated_rows(uids, d_uids, train_data)
            ids = self.topk_ids(state, d_uids, rated, mask, k)
            # no row is longer than rated.shape[1]: only past this can a
            # user have fewer than k unrated items
            if state.num_items - rated.shape[1] < k:
                ids = _past_unrated(ids, rated, mask, state.num_items)
        return ids


def _past_unrated(ids: torch.Tensor, rated: torch.Tensor, mask: torch.Tensor,
                  num_items: int) -> torch.Tensor:
    """``ids`` (B, k) with num_items in every slot j >= the user's count of
    unrated items: num_items less the distinct ids of the user's sorted
    rated row in ``rated`` (B, L) where ``mask``."""
    new = mask.clone()  # a row's first entry of each id
    new[:, 1:] &= rated[:, 1:] != rated[:, :-1]
    unrated = num_items - new.sum(dim=1, keepdim=True)
    slot = torch.arange(ids.shape[1], device=ids.device)[None, :]
    return torch.where(slot >= unrated, num_items, ids)

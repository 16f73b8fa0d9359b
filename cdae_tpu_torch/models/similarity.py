"""Neighbourhood models: SimilarityBase, ItemCF, UserCF (port of
cdae_tpu/models/similarity.py; ref similarity_base.hpp, itemcf.hpp,
usercf.hpp).

At reset, for every index entity (the item for ItemCF, the user for
UserCF) co-occurrences with every other entity through the shared data axis
are counted, normalised (Jaccard c/(n_a+n_b-c), Cosine c/sqrt(n_a*n_b),
similarity_base.hpp:79-87) and the top-k neighbours kept
(similarity_base.hpp:88-92). The count is a blocked binary matmul (f32, so
exact; TF32 stays off), normalisation is elementwise, and each block's
neighbours come from ``stable_topk``, whose order on equal similarities
(lower id first) is ``lax.top_k``'s: the neighbour lists equal cdae_tpu's
bit for bit. Every block is queued, and the lists stay on the device.

Scoring sums neighbour similarities into (B, num_items) scores:

  ItemCF (itemcf.hpp:22-50): score[i] = sum_{j in rated(u)} sim(j -> i)
  UserCF (usercf.hpp:21-54): score[i] = sum_{v in topk(u)} sim(u, v)*1[v rated i]

through ``scatter_add_rows`` over the flat keys b*I + id; pad ids map past
B*I and add nothing. On a CUDA tensor that runs kernel B8, whose sums run
in a fixed order (ascending position, cdae_tpu's CPU order), so a top-N
list is the same bits on every run although Jaccard scores tie often; an
atomic scatter-add would not promise that.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from cdae_tpu_torch.data.dataset import Interactions, rows_from_csr
from cdae_tpu_torch.models.base import ModelState, RecsysModel, resolve_device
from cdae_tpu_torch.ops.scatter import scatter_add_rows
from cdae_tpu_torch.ops.topk import stable_topk

SIM_TYPES = ("JACCARD", "COSINE")


@dataclasses.dataclass(frozen=True)
class SimilarityConfig:
    """SimilarityType + topk (ref similarity_base.hpp:34-40).
    ``block_size``: index rows per co-occurrence block. ``sharded``: the
    mesh-parallel build (``build_topk_neighbors_sharded``) over the
    processes of the group; None = sharded when there is more than one
    process (cdae_tpu's "more than one device"), False = serial on the one
    device."""

    sim_type: str = "JACCARD"  # JACCARD | COSINE
    topk: int = 50
    block_size: int = 1024
    sharded: Optional[bool] = None
    dtype: Any = torch.float32


def _neighbor_block_math(A_blk: torch.Tensor, A: torch.Tensor,
                         counts_blk: torch.Tensor, counts: torch.Tensor,
                         row_offset: int, sim_type: str, topk: int):
    """One block of the neighbour build: count -> normalise -> top-k.
    ``A_blk`` (B, M) and ``A`` (N, M) binary rows, ``counts_*`` their row
    sums, ``row_offset`` the global id of A_blk[0]. Returns (B, topk) ids
    padded with N (int32) and sims padded with 0."""
    C = A_blk @ A.T  # (B, N)
    if sim_type == "JACCARD":
        denom = counts_blk[:, None] + counts[None, :] - C
        S = C / torch.clamp(denom, min=1e-12)
    else:  # COSINE
        # the root in f64, rounded once to f32: the correctly rounded f32
        # root, as XLA's (torch's f32 sqrt on a CPU is off by one ulp on
        # some inputs)
        root = torch.sqrt((counts_blk[:, None] * counts[None, :]).double())
        S = C / torch.clamp(root.to(C.dtype), min=1e-12)
    B, N = C.shape
    dev = C.device
    is_self = (torch.arange(N, device=dev)[None, :]
               == row_offset + torch.arange(B, device=dev)[:, None])
    # only co-occurring candidates are eligible (ref builds the candidate
    # set from shared data entities, similarity_base.hpp:66-77)
    S = torch.where((C > 0) & ~is_self, S, float("-inf"))
    sims, ids = stable_topk(S, topk)
    valid = torch.isfinite(sims)
    return (torch.where(valid, ids, N).to(torch.int32),
            torch.where(valid, sims, 0.0))


def _binarize_rows(rows: torch.Tensor, M: int) -> torch.Tensor:
    """Padded index rows (N, L) int (pad >= M) -> dense (N, M) 0/1 f32,
    built on the device from the padded rows."""
    N = rows.shape[0]
    out = torch.zeros((N, M + 1), dtype=torch.float32, device=rows.device)
    col = torch.where((rows >= 0) & (rows < M), rows, M).long()
    out.scatter_(1, col, 1.0)
    return out[:, :M]


def _build_topk_neighbors_dev(A: torch.Tensor, sim_type: str, topk: int,
                              block_size: int = 1024):
    """(N, K) neighbour ids (int32, padded with N) and sims of the binary
    rows ``A`` (N, M), as device tensors; K = min(topk, max(N - 1, 1))."""
    sim_type = sim_type.upper()
    if sim_type not in SIM_TYPES:
        raise ValueError(f"unknown sim_type {sim_type!r}; expected one of "
                         f"{SIM_TYPES}")
    N = A.shape[0]
    counts = torch.sum(A, dim=1)
    k = min(topk, max(N - 1, 1))
    outs = [_neighbor_block_math(A[start:start + block_size], A,
                                 counts[start:start + block_size], counts,
                                 start, sim_type, k)
            for start in range(0, N, block_size)]
    return (torch.cat([i for i, _ in outs]),
            torch.cat([s for _, s in outs]))


def build_topk_neighbors_rows(rows: np.ndarray, M: int, sim_type: str,
                              topk: int, block_size: int = 1024,
                              device="cuda"):
    """``build_topk_neighbors`` from padded index rows (N, L) (pad >= M):
    only the rows go to the device, which binarises them. Returns numpy
    (ids, sims), read back once."""
    dev = resolve_device(device)
    A = _binarize_rows(torch.as_tensor(rows, device=dev), M)
    ids, sims = _build_topk_neighbors_dev(A, sim_type, topk, block_size)
    return ids.cpu().numpy(), sims.cpu().numpy()


def build_topk_neighbors(binary: np.ndarray, sim_type: str, topk: int,
                         block_size: int = 1024, device="cuda"):
    """The full neighbour graph of binary rows (N, M): numpy (N, K) ids
    padded with N and (N, K) sims."""
    A = torch.as_tensor(binary, dtype=torch.float32,
                        device=resolve_device(device))
    ids, sims = _build_topk_neighbors_dev(A, sim_type, topk, block_size)
    return ids.cpu().numpy(), sims.cpu().numpy()


def _build_topk_neighbors_sharded_dev(A: torch.Tensor, sim_type: str,
                                      topk: int, mesh, block_size: int = 1024):
    """``_build_topk_neighbors_dev`` over the ranks of ``mesh``: rank r
    builds the row block [r * per, (r + 1) * per) against the replicated
    binary matrix ``A`` with no collective (each row's count, normalise
    and top-k touch only that row), then the blocks are all-gathered. The
    lists equal the serial build's."""
    sim_type = sim_type.upper()
    if sim_type not in SIM_TYPES:
        raise ValueError(f"unknown sim_type {sim_type!r}; expected one of "
                         f"{SIM_TYPES}")
    N = A.shape[0]
    counts = torch.sum(A, dim=1)
    k = min(topk, max(N - 1, 1))
    per = max(-(-N // mesh.size), 1)
    lo = min(mesh.rank * per, N)
    hi = min(lo + per, N)
    ids = torch.full((per, k), N, dtype=torch.int32, device=A.device)
    sims = torch.zeros((per, k), dtype=A.dtype, device=A.device)
    for start in range(lo, hi, block_size):
        stop = min(start + block_size, hi)
        i_blk, s_blk = _neighbor_block_math(A[start:stop], A,
                                            counts[start:stop], counts,
                                            start, sim_type, k)
        ids[start - lo:stop - lo] = i_blk
        sims[start - lo:stop - lo] = s_blk
    return (mesh.all_gather_world(ids)[:N],
            mesh.all_gather_world(sims)[:N])


def build_topk_neighbors_sharded(binary: np.ndarray, sim_type: str,
                                 topk: int, mesh=None, device=None,
                                 block_size: int = 1024):
    """The mesh-parallel neighbour build (cdae_tpu's): every rank calls
    it with the same binary rows (N, M) and gets the whole graph, numpy
    (N, K) ids padded with N and (N, K) sims, equal to the serial build."""
    from cdae_tpu_torch.parallel.mesh import make_mesh

    mesh = mesh if mesh is not None else make_mesh(device=device)
    A = torch.as_tensor(binary, dtype=torch.float32, device=mesh.device)
    ids, sims = _build_topk_neighbors_sharded_dev(A, sim_type, topk, mesh,
                                                  block_size)
    return ids.cpu().numpy(), sims.cpu().numpy()


def _flat_keys(ids: torch.Tensor, num_items: int) -> torch.Tensor:
    """(B, ...) item ids -> int64 keys b*I + id; ids outside [0, I) map to
    B*I, past the last row, so they add nothing."""
    B = ids.shape[0]
    b = torch.arange(B, device=ids.device).reshape((B,) + (1,) * (ids.dim()
                                                                  - 1))
    ids = ids.long()
    valid = (ids >= 0) & (ids < num_items)
    return torch.where(valid, b * num_items + ids, B * num_items).reshape(-1)


def _itemcf_terms(nbr_ids, nbr_sims, rated_items, rated_mask,
                  num_items: int):
    """ItemCF's score terms: the flat keys (P,) int64 and values (P,) of
    sim(j -> i) for every rated j of row b and neighbour i of j, P =
    B * L * K in (b, l, k) order."""
    I = num_items
    rated = rated_items.long().clamp(0, I - 1)
    ids = nbr_ids[rated]  # (B, L, K)
    sims = nbr_sims[rated] * rated_mask.to(nbr_sims.dtype)[..., None]
    return _flat_keys(ids, I), sims.reshape(-1)


def _usercf_terms(nbr_ids, nbr_sims, uids, all_user_items, all_user_mask,
                  num_items: int):
    """UserCF's score terms: the flat keys (P,) int64 and values (P,) of
    sim(u_b, v_k) for every item of every neighbour v_k, P = B * K * L in
    (b, k, l) order."""
    U = all_user_items.shape[0]
    nbrs = nbr_ids[uids].long()  # (B, K) padded with U
    sims = nbr_sims[uids]  # (B, K)
    nbrs_c = nbrs.clamp(0, U - 1)
    items = all_user_items[nbrs_c]  # (B, K, L)
    mask = all_user_mask[nbrs_c] & (nbrs[..., None] < U)
    vals = sims[..., None] * mask.to(sims.dtype)
    return _flat_keys(items, num_items), vals.reshape(-1)


def _cf_scores(keys, vals, B: int, num_items: int) -> torch.Tensor:
    """(B, I) scores: the terms summed at their keys."""
    out = scatter_add_rows(vals.new_zeros(B * num_items), keys, vals)
    return out.reshape(B, num_items)


def _itemcf_scores(nbr_ids, nbr_sims, rated_items, rated_mask,
                   num_items: int) -> torch.Tensor:
    """score[b, i] = sum_{j in rated(b)} sim(j -> i)."""
    keys, vals = _itemcf_terms(nbr_ids, nbr_sims, rated_items, rated_mask,
                               num_items)
    return _cf_scores(keys, vals, rated_items.shape[0], num_items)


def _usercf_scores(nbr_ids, nbr_sims, uids, all_user_items, all_user_mask,
                   num_items: int) -> torch.Tensor:
    """score[b, i] = sum_k sim(u_b, v_k) * 1[v_k rated i]."""
    keys, vals = _usercf_terms(nbr_ids, nbr_sims, uids, all_user_items,
                               all_user_mask, num_items)
    return _cf_scores(keys, vals, uids.shape[0], num_items)


class SimilarityBase(RecsysModel):
    """The shared neighbour build; subclasses pick the axis."""

    index_axis = "item"  # entities that get neighbour lists

    def __init__(self, config: Optional[SimilarityConfig] = None,
                 device="cuda", **kw):
        self.device = resolve_device(device)
        self.cfg = config if config is not None else SimilarityConfig(**kw)
        if self.cfg.sim_type.upper() not in SIM_TYPES:
            raise ValueError(f"unknown sim_type {self.cfg.sim_type!r}; "
                             f"expected one of {SIM_TYPES}")

    def reset(self, data: Interactions, seed: int = 0) -> ModelState:
        from cdae_tpu_torch.parallel.distributed import world_size

        if self.index_axis == "item":
            csr, N, M = data.csr_by_item(), data.num_items, data.num_users
        else:
            csr, N, M = data.csr(), data.num_users, data.num_items
        rows, _, _, _ = rows_from_csr(csr, np.arange(N), M)
        A = _binarize_rows(self._tensor(rows), M)
        sharded = self.cfg.sharded
        if sharded is None:
            sharded = world_size() > 1
        if sharded:
            from cdae_tpu_torch.parallel.mesh import make_mesh

            ids, sims = _build_topk_neighbors_sharded_dev(
                A, self.cfg.sim_type, self.cfg.topk,
                make_mesh(device=self.device), self.cfg.block_size)
        else:
            ids, sims = _build_topk_neighbors_dev(A, self.cfg.sim_type,
                                                  self.cfg.topk,
                                                  self.cfg.block_size)
        return ModelState(params={"nbr_ids": ids, "nbr_sims": sims},
                          padded=data.padded(), num_users=data.num_users,
                          num_items=data.num_items)

    def train_one_iteration(self, state, seed: int = 0):
        return state  # ref similarity_base.hpp:117-119: no-op

    def data_loss(self, state, sample_size: int = 0) -> float:
        return 0.0  # ref similarity_base.hpp:101-104

    def predict(self, state, users, items):
        users = np.asarray(users)
        pb = state.padded
        scores = self.batch_scores(state, users, pb.items[users],
                                   pb.mask[users])
        return scores[torch.arange(len(users), device=self.device),
                      self._tensor(items, torch.long)]


class ItemCF(SimilarityBase):
    name = "ItemCF"
    index_axis = "item"

    def batch_scores(self, state, uids, rated_items, rated_mask):
        return _itemcf_scores(state.params["nbr_ids"],
                              state.params["nbr_sims"],
                              self._tensor(rated_items),
                              self._tensor(rated_mask), state.num_items)


class UserCF(SimilarityBase):
    name = "UserCF"
    index_axis = "user"

    def _user_rows(self, state):
        """Every user's padded rated items and mask on the device, staged
        once per state."""
        if "user_rows" not in state.aux:
            pb = state.padded
            state.aux["user_rows"] = (self._tensor(pb.items),
                                      self._tensor(pb.mask))
        return state.aux["user_rows"]

    def batch_scores(self, state, uids, rated_items, rated_mask):
        items, mask = self._user_rows(state)
        return _usercf_scores(state.params["nbr_ids"],
                              state.params["nbr_sims"],
                              self._tensor(uids, torch.long), items, mask,
                              state.num_items)

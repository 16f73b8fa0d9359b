"""Sharded trainers over a ('data', 'model') mesh of processes, drop-in for
Solver / Evaluation (port of cdae_tpu/parallel/trainer.py).

Each wrapper holds the single-device model (``inner``) and this rank's
blocks of its tables (parallel/mesh.py layouts), and trains by calling the
inner model's own step functions with this rank's ``Collectives``: a CDAE
state holds it (the epoch, loss and scoring are CDAE's own), the MF
family's steps take it as their ``coll`` argument. Every rank runs every
call: the collectives inside the steps, the evaluation (``batch_topk`` is
a collective too) and the delegating methods, which gather the tables
explicitly (``gathered``) where GSPMD gathered them implicitly. Only rank
0 logs and writes.

cdae_tpu switches its Pallas kernels off on these paths (a GSPMD
workaround: a Pallas kernel is a single-device program). The port keeps
its hand-written kernels on, per rank, on the rank's block: B1 at the
block's offsets, B8 into the rank's own rows, one B2 launch over its
tables, B3 / B5 / B6 for its score block, B7 for its batch rows.

Usage (every rank, after parallel/distributed.py ``initialize()``):
    mesh = make_mesh(n_model=2)
    model = ShardedCDAE(CDAEConfig(...), mesh=mesh)
    Solver(model, max_iteration=50).train(train, test, ["TOPN"])
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cdae_tpu_torch.data.dataset import Interactions
from cdae_tpu_torch.models.base import ModelState, RecsysModel
from cdae_tpu_torch.models.cdae import (
    CDAE,
    CDAEConfig,
    CDAEState,
    _serve_hidden,
)
from cdae_tpu_torch.parallel.mesh import (
    Mesh,
    cdae_param_specs,
    gather_params,
    make_mesh,
    mf_param_specs,
    shard_params,
)
from cdae_tpu_torch.parallel.topk import local_rated, merge_topk


class _Sharded(RecsysModel):
    """What every sharded wrapper shares: the mesh, the layouts of its
    tables, the explicit gather of the whole tables, and the delegating
    methods that run the inner model on them."""

    inner: RecsysModel

    def _set_mesh(self, mesh: Optional[Mesh], device) -> None:
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.device = self.mesh.device

    def _reset_inner(self, data: Interactions, seed: int) -> ModelState:
        """The inner model's reset on this rank's mesh, so dense_R is built
        as this rank's block alone (cdae_tpu's P('data', 'model')), kept as
        ``dense_R_block``: no rank holds the whole matrix."""
        self.inner.mesh = self.mesh
        state = self.inner.reset(data, seed)
        if "dense_R" in state.aux:
            state.aux["dense_R_block"] = state.aux.pop("dense_R")
        return state

    def _shard(self, state: ModelState, specs, **coll_kw) -> None:
        """Keep the layouts and whole shapes of ``state``'s tables, then
        cut them to this rank's blocks; ``coll_kw`` shapes the step
        collectives (parallel/mesh.py ``Collectives``)."""
        self._specs = specs
        self._shapes = {k: tuple(v.shape) for k, v in state.params.items()}
        state.params = shard_params(self.mesh, state.params, specs)
        self.coll = self.mesh.collectives(state.num_users, state.num_items,
                                          **coll_kw)
        state.aux["layout"] = (self.mesh, specs, self._shapes)

    def gathered(self, state: ModelState) -> ModelState:
        """``state`` with its tables whole (a collective: every rank
        calls it); the aux views are shared."""
        return dataclasses.replace(state, params=gather_params(
            self.mesh, state.params, self._specs, self._shapes))

    # the npz checkpoint through the Solver writes and reads whole tables
    def checkpoint_view(self, state: ModelState) -> ModelState:
        return self.gathered(state)

    def restore_view(self, state: ModelState, view: ModelState) -> None:
        state.params = shard_params(self.mesh, view.params, self._specs)
        state.step = view.step

    def _check_batch(self, batch_size: int) -> None:
        nd = self.mesh.shape["data"]
        if batch_size % nd:
            raise ValueError(f"batch_size={batch_size} must divide over "
                             f"n_data={nd}")

    def set_learn_rate(self, lr: float) -> None:
        self.inner.set_learn_rate(lr)

    def data_loss(self, state, sample_size: int = 0) -> float:
        return self.inner.data_loss(self.gathered(state), sample_size)

    def penalty_loss(self, state) -> float:
        return self.inner.penalty_loss(self.gathered(state))

    def batch_scores(self, state, uids, rated_items, rated_mask):
        return self.inner.batch_scores(self.gathered(state), uids,
                                       rated_items, rated_mask)

    def predict(self, state, users, items):
        return self.inner.predict(self.gathered(state), users, items)


def _pad_rows(n_data: int, uids, *rows):
    """A batch padded to a multiple of ``n_data`` rows (uid 0, rated rows
    all padding); returns (B, uids, rows...)."""
    uids = torch.as_tensor(uids, dtype=torch.long)
    B = uids.shape[0]
    pad = (-B) % n_data
    if not pad:
        return (B, uids) + tuple(r for r, _ in rows)
    out = [torch.cat([uids, uids.new_zeros(pad)])]
    for r, fill in rows:
        out.append(torch.cat([r, r.new_full((pad,) + tuple(r.shape[1:]),
                                            fill)]))
    return (B, *out)


class ShardedCDAE(_Sharded):
    """CDAE trained over the mesh: the batch over 'data', W / V / b' over
    'model', Wu / Uu over 'data'. ``dense_mode=True`` runs the dense step
    on the rank's (B / n_data, I / n_model) slabs; otherwise (None too, as
    in cdae_tpu) the sparse step. The fused step (B4) is never taken, as in
    cdae_tpu. The state holds this rank's ``Collectives`` (``aux["coll"]``),
    so the inner CDAE's own epoch, loss and scores run on its blocks."""

    name = "ShardedCDAE"

    def __init__(self, config: Optional[CDAEConfig] = None,
                 mesh: Optional[Mesh] = None, device=None, **kw):
        cfg = config if config is not None else CDAEConfig(**kw)
        cfg = dataclasses.replace(cfg, dense_mode=bool(cfg.dense_mode),
                                  fused_step=False)
        self._set_mesh(mesh, device)
        self.inner = CDAE(cfg, device=self.device)
        self.cfg = self.inner.cfg
        self.loss = self.inner.loss
        # the single-device order, step seeds and num_corruptions loop
        self.train_one_iteration = self.inner.train_one_iteration
        self.data_loss = self.inner.data_loss

    def reset(self, data: Interactions, seed: int = 0) -> CDAEState:
        self._check_batch(self.cfg.batch_size)
        state = self._reset_inner(data, seed)
        self._shard(state, cdae_param_specs(state.params))
        state.aux["coll"] = self.coll
        return state

    def user_representations(self, state: CDAEState) -> np.ndarray:
        return self.inner.user_representations(self.gathered(state))

    def batch_scores(self, state: CDAEState, uids, rated_items, rated_mask):
        """The whole (B, I) scores on every rank, from the ranks' blocks
        (the batch padded to divide over 'data')."""
        B, uids, rated_items, rated_mask = _pad_rows(
            self.mesh.shape["data"], uids,
            (torch.as_tensor(rated_items, device=self.device),
             state.num_items),
            (torch.as_tensor(rated_mask, device=self.device), False))
        return self.inner.batch_scores(state, uids, rated_items,
                                       rated_mask)[:B]

    def batch_topk(self, state: CDAEState, uids, rated_items, rated_mask,
                   k: int = 10):
        """Per-shard top-k over the rank's score block merged over 'model'
        (parallel/topk.py), then the rows gathered over 'data': the (B, I)
        scores are never whole on one device. The block's top-k is B5 on
        its block of dense_R (with dense_R resident and the kernels on), B6
        on its rated ids as local columns (the kernels on), else the plain
        streaming loop -- the single-device ``batch_topk``'s routes. An
        uneven catalog (I % n_model != 0) returns None on every rank, as in
        cdae_tpu, and so does a k outside [1, _MAX_K]: the evaluator and
        ``recommend`` then take ``batch_scores``."""
        from cdae_tpu_torch.ops.pallas_kernels import (
            _MAX_K, fused_topk_scores, fused_topk_scores_csr,
            streaming_topk_scores)

        I = state.num_items
        if I % self.mesh.shape["model"] != 0 or not 1 <= k <= _MAX_K:
            return None  # uneven item shards or k past the kernels': scores
        dev = self.device
        B, uids, rated_items, rated_mask = _pad_rows(
            self.mesh.shape["data"], uids,
            (torch.as_tensor(rated_items, device=dev), I),
            (torch.as_tensor(rated_mask, device=dev), False))
        uids = uids.to(dev)
        coll, p, cfg = self.coll, state.params, self.cfg
        R_block = state.aux.get("dense_R_block")
        z = _serve_hidden(p, uids, rated_items, rated_mask, cfg=cfg,
                          coll=coll, dense_R=R_block)
        sl = coll.rows(uids.shape[0])
        table = p["V"] if cfg.asymmetric else p["W"]
        lo, hi = coll.items
        if cfg.use_pallas and R_block is not None:
            ids, vals = fused_topk_scores(z, table, p["b_prime"],
                                          coll.batch_rows(R_block, uids), k=k)
        else:
            local = torch.sort(local_rated(rated_items[sl], lo, hi - lo),
                               dim=1).values
            if cfg.use_pallas:
                ids, vals = fused_topk_scores_csr(
                    z, table, p["b_prime"], local.int(), k=k, w=64)
            else:
                ids, vals = streaming_topk_scores(z, table, p["b_prime"],
                                                  local, k=k)
        # a tail slot's id is the block width: the catalog's sentinel I
        gids = torch.where(ids.long() >= hi - lo, I, ids.long() + lo)
        gids, _ = merge_topk(self.mesh, vals, gids, k)
        return coll.data_gather(gids)[:B]


def _replicated(params) -> dict:
    return {k: () for k in params}


class ShardedIMF(_Sharded):
    """IMF's dense (B, I) slab over the mesh: uv / ub over 'data', iv / ib
    over 'model', each rank's (B / n_data, I / n_model) slab block through
    IMF's own slab step (B1 at the block's offsets with ``fast_rng``, one
    B2 launch over its item blocks, B8 for its user rows). Dense mode is
    mandatory: the sharded step IS the slab step."""

    name = "ShardedIMF"

    def __init__(self, config=None, mesh: Optional[Mesh] = None,
                 device=None, **kw):
        from cdae_tpu_torch.models.mf import IMF, MFConfig

        cfg = config if config is not None else MFConfig(**kw)
        cfg = dataclasses.replace(cfg, dense_mode=True)
        self._set_mesh(mesh, device)
        self.inner = IMF(cfg, device=self.device)
        self.cfg = self.inner.cfg
        self.loss = self.inner.loss

    def reset(self, data: Interactions, seed: int = 0):
        state = self._reset_inner(data, seed)
        if "dense_R_block" not in state.aux:
            raise ValueError(
                "ShardedIMF requires dense mode (U*I slab); use single-chip "
                "IMF for catalogs beyond the dense budget"
            )
        self._check_batch(min(self.cfg.batch_size, max(state.num_users, 1)))
        self._shard(state, mf_param_specs(state.params))
        return state

    def train_one_iteration(self, state, seed: int = 0):
        return self.inner.train_one_iteration(state, seed, coll=self.coll)


class ShardedFISM(_Sharded):
    """Dense-slab FISM over the mesh (pointwise only): x / bu over 'data',
    P / Q / bi over 'model', each rank's slab block through FISM's own
    slab step. Dense mode is mandatory -- the sparse per-user step stays
    single-device."""

    name = "ShardedFISM"

    def __init__(self, config=None, mesh: Optional[Mesh] = None,
                 device=None, **kw):
        from cdae_tpu_torch.models.fism import FISM, FISMConfig

        cfg = config if config is not None else FISMConfig(**kw)
        cfg = dataclasses.replace(cfg, dense_mode=True)
        self._set_mesh(mesh, device)
        self.inner = FISM(cfg, device=self.device)
        self.cfg = self.inner.cfg
        self.loss = self.inner.loss

    def reset(self, data: Interactions, seed: int = 0):
        state = self._reset_inner(data, seed)
        if "dense_R_block" not in state.aux:
            raise ValueError(
                "ShardedFISM requires the dense (U, I) slab budget; use "
                "single-chip FISM for larger catalogs"
            )
        self._check_batch(min(self.cfg.batch_size, max(state.num_users, 1)))
        self._shard(state, mf_param_specs(state.params))
        return state

    def train_one_iteration(self, state, seed: int = 0):
        return self.inner.train_one_iteration(state, seed, coll=self.coll)


class ShardedALS(_Sharded):
    """ALS / WRMF over the mesh: every row's normal-equation solve is
    independent (ref als.hpp:100-121), so each rank solves its contiguous
    row block of a sweep (in ``solve_batch`` chunks, as the single-device
    sweep), and the blocks are all-gathered before the next sweep reads
    them -- the user side, then the item side against the updated users.
    The factor tables stay whole on every rank; no hand kernel runs."""

    name = "ShardedALS"
    weighted = False

    def __init__(self, config=None, mesh: Optional[Mesh] = None,
                 device=None, **kw):
        from cdae_tpu_torch.models.als import ALS, WRMF, ALSConfig

        cfg = config if config is not None else ALSConfig(**kw)
        self._set_mesh(mesh, device)
        self.inner = (WRMF if self.weighted else ALS)(cfg, device=self.device)
        self.cfg = self.inner.cfg
        self.loss = self.inner.loss

    def reset(self, data: Interactions, seed: int = 0):
        from cdae_tpu_torch.data.dataset import PaddedUserBatch

        state = self.inner.reset(data, seed)
        nd, r = self.mesh.size, self.mesh.rank

        def block(pb):
            """This rank's row block of a side, staged as the single-device
            sweep stages a whole side."""
            N = pb.num_users
            per = max(-(-N // nd), 1)
            lo = min(r * per, N)
            hi = min(lo + per, N)
            sub = PaddedUserBatch(
                uids=pb.uids[lo:hi], items=pb.items[lo:hi],
                ratings=pb.ratings[lo:hi], mask=pb.mask[lo:hi],
                lengths=pb.lengths[lo:hi], num_items=pb.num_items)
            return lo, hi, per, self.inner._stage_side(sub)

        state.aux["dev_user_side"] = block(state.padded)
        state.aux["dev_item_side"] = block(state.aux["by_item"])
        self._shard(state, _replicated(state.params))
        return state

    def _sweep(self, X, Y, side):
        from cdae_tpu_torch.models.als import _sweep

        lo, hi, per, staged = side
        cfg = self.cfg
        out = _sweep(X[lo:hi], Y, staged, cfg.lambda_, cfg.scalar,
                     self.inner.weighted, cfg.w_solver)
        out = torch.cat([out, out.new_zeros((per - (hi - lo), X.shape[1]))])
        return self.mesh.all_gather_world(out)[:X.shape[0]]

    def train_one_iteration(self, state, seed: int = 0):
        p = state.params
        p["p"] = self._sweep(p["p"], p["q"], state.aux["dev_user_side"])
        p["q"] = self._sweep(p["q"], p["p"], state.aux["dev_item_side"])
        state.step += 1
        return state


class ShardedWRMF(ShardedALS):
    name = "ShardedWRMF"
    weighted = True


class ShardedNegMF(_Sharded):
    """Data-parallel NegMF (per-instance independence, ref
    neg_mf.hpp:79-95): the tables replicate, every rank draws the whole
    batch's negatives and takes the step on its rows of the batch (B8 for
    its row sums), and the sums are completed over 'data' before the
    AdaGrad step, so every rank steps identically."""

    name = "ShardedNegMF"

    def __init__(self, inner=None, mesh: Optional[Mesh] = None,
                 device=None, **kw):
        from cdae_tpu_torch.models.linear import FactorModelConfig, NegMF

        if inner is not None and not isinstance(inner, NegMF):
            raise TypeError(f"ShardedNegMF wraps NegMF, got {type(inner)}")
        self._set_mesh(mesh, device if device is not None or inner is None
                       else inner.device)
        if inner is None:
            inner = (NegMF(FactorModelConfig(**kw), device=self.device)
                     if kw else NegMF(device=self.device))
        elif inner.device != self.device:
            inner = type(inner)(inner.cfg, device=self.device)
        self.inner = inner
        self.cfg = inner.cfg
        self.loss = inner.loss

    def reset(self, data: Interactions, seed: int = 0):
        self._check_batch(self.cfg.batch_size)
        state = self.inner.reset(data, seed)
        state.aux.pop("dense_R", None)  # the DP epoch is the instance one
        self._shard(state, _replicated(state.params), split_items=False,
                    split_users=False)
        return state

    def train_one_iteration(self, state, seed: int = 0):
        return self.inner.train_one_iteration(state, seed, coll=self.coll)


class ShardedPairwise(_Sharded):
    """Data-parallel trainer for the instance epoch of the MF family
    (BPR / WARP / IMF / PMF): per-interaction independence (ref
    bpr.hpp:72-106) makes batch-axis data parallelism exact up to the
    order of float sums. The tables replicate; every rank takes the whole
    batch's draws, runs its rows of the batch through the model's own step
    and completes the aggregated table gradients over 'data' before the
    one B2 launch, so every rank steps identically.

    Unlike cdae_tpu (which turns its kernels off here), each rank keeps
    the port's routes: B8's fixed-order sums, B7 for WARP's violators at
    its rows' offset. ``row_update`` is off, as in cdae_tpu (ShardedMFTP
    is the huge-catalog trainer).

    Usage: ShardedPairwise(BPR(MFConfig(...)), mesh=make_mesh())."""

    name = "ShardedPairwise"

    def __init__(self, inner, mesh: Optional[Mesh] = None, device=None):
        from cdae_tpu_torch.models.mf import _MFBase

        if not isinstance(inner, _MFBase):
            raise TypeError("ShardedPairwise wraps an _MFBase model "
                            f"(BPR/WARP/IMF/PMF), got {type(inner)}")
        self._set_mesh(mesh, device if device is not None else inner.device)
        cfg = inner.cfg
        if cfg.row_update is not False:
            cfg = dataclasses.replace(cfg, row_update=False)
        if cfg is not inner.cfg or inner.device != self.device:
            inner = type(inner)(cfg, device=self.device)
        self.inner = inner
        self.cfg = inner.cfg
        self.loss = inner.loss
        self.name = f"Sharded{inner.name}"

    def reset(self, data: Interactions, seed: int = 0):
        # the sparse instance epoch: dense-mode slabs have their own
        # sharded trainer (ShardedIMF)
        self._check_batch(self.cfg.batch_size)
        state = self.inner.reset(data, seed)
        state.aux.pop("dense_R", None)
        state.aux.pop("dense_ratings", None)
        self._shard(state, _replicated(state.params), split_items=False,
                    split_users=False)
        return state

    def train_one_iteration(self, state, seed: int = 0):
        return self.inner.train_one_iteration(state, seed, coll=self.coll)

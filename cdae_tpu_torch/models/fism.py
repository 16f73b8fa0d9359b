"""FISM -- Factored Item Similarity Models (KDD'13) -- pointwise and
pairwise, on PyTorch (port of cdae_tpu/models/fism.py).

Model (ref fism.hpp:170-218):
  x_u    = sum_{j in R_u} p_j                 (cached per user, params["x"])
  s(u,i) = b_u + b_i + scale * x~_u . q_i
  scale  = 1/(|R_u|-1)^alpha for rated i (x~_u = x_u - p_i),
           1/|R_u|^alpha     for unrated i (x~_u = x_u)

Two routes, as in cdae_tpu:
  * the dense slab (``dense_mode`` auto-on while the (U, I) int8 rated mask
    and the (B, I) slabs fit): every gather and scatter of the pointwise
    step becomes a matmul over the (B, I) rated rows, negatives are
    Bernoulli over the complement with num_neg * |R_u| expected draws;
  * the sparse step (``dense_mode=False``, and FISMPair always): user-major
    batches of all of a user's positives (``bucket_by_length`` trims each
    batch's item axis to a power of two), num_neg * L exact complement
    draws (``sample_unrated``), and the Q + b_i and P gradients summed into
    the tables by ``scatter_add_rows``. On a CUDA device the default
    ``scatter_mode="auto"``, like every mode but ``"scatter"``, sums
    through kernel B8 (a fixed summation order: the route is reproducible
    bit for bit on the card); on the CPU auto stays one ``index_add``.
Both apply one AdaGrad step per batch without beta (accumulators at 1e-4;
kernel B2 on a CUDA device) and refresh x for the batch's users from the
updated P by a delta-add (padding rows repeat uid 0 at weight 0); an epoch
ends with an exact rebuild of x.

Random draws: step b of an epoch draws from the step seed ``step_seed(seed,
state.step, b, 0)`` (utils/random.py), so a resumed run replays the
unbroken run's draws: the sparse step's complement draws and the dense
step's (B, I) uniforms come from a ``torch.Generator`` seeded with it, or
with ``fast_rng`` from B1's hash stream. The steps take injected draws
(``neg``; ``u01``), so tests feed them the very draws cdae_tpu makes.

Differences from cdae_tpu: parameters are updated in place; FISMPair's
aggregations go through ``scatter_add_rows`` (cdae_tpu uses the native
scatter; the sum is the same).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from cdae_tpu_torch.data.dataset import Interactions
from cdae_tpu_torch.models.base import (
    ModelState,
    RecsysModel,
    dense_fits,
    iter_user_batches,
    resolve_device,
)
from cdae_tpu_torch.ops.losses import Loss
from cdae_tpu_torch.ops.pallas_kernels import hw_uniform
from cdae_tpu_torch.ops.penalties import Penalty
from cdae_tpu_torch.ops.sampling import sample_unrated
from cdae_tpu_torch.ops.scatter import row_plan, scatter_add_rows
from cdae_tpu_torch.solver.optimizer import ADAGRAD_INIT, dense_adagrad_steps
from cdae_tpu_torch.utils.random import step_seed

_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class FISMConfig:
    """Every field of cdae_tpu's FISMConfig (ref fism.hpp:8-20)."""

    lambda_: float = 0.01
    loss: str = "SQUARE"
    penalty: str = "L2"
    num_dim: int = 10
    num_neg: int = 5
    alpha: int = 1
    using_bias_term: bool = True
    using_factor_term: bool = True
    using_global_mean: bool = False
    using_adagrad: bool = True
    learn_rate: float = 0.01  # the SGD solver's step size sets it
    batch_size: int = 128  # users per batch
    scatter_mode: str = "auto"  # ops/scatter.py; auto is B8 on CUDA
    bucket_by_length: bool = True  # trim each sparse batch's item axis to
    # the next power of two of its longest row (users sorted by length)
    dense_mode: Optional[bool] = None  # the (B, I) slab step; None = auto
    # when the (U, I) rated mask and the slabs fit
    fast_rng: bool = False  # B1's hash stream for the draws
    dtype: Any = torch.float32


def _scales(lengths: torch.Tensor, alpha: int, dtype):
    """(rated-scale, unrated-scale) per user (ref fism.hpp:128-134)."""
    n = lengths.to(dtype)
    rated = 1.0 / torch.clamp(n - 1.0, min=1.0) ** alpha
    unrated = 1.0 / torch.clamp(n, min=1.0) ** alpha
    return rated, unrated


class FISM(RecsysModel):
    name = "FISM"
    pairwise = False

    def __init__(self, config: Optional[FISMConfig] = None, device="cuda",
                 **kw):
        self.device = resolve_device(device)
        self.cfg = config if config is not None else FISMConfig(**kw)
        self.loss = Loss.create(self.cfg.loss)
        self.penalty = Penalty.create(self.cfg.penalty)
        self._lr = self.cfg.learn_rate

    def set_learn_rate(self, lr: float) -> None:
        """SGDSolver protocol: the solver owns the step size."""
        self._lr = float(lr)

    # ------------------------------------------------------------- reset ----
    def reset(self, data: Interactions, seed: int = 0) -> ModelState:
        cfg = self.cfg
        U, I, D = data.num_users, data.num_items, cfg.num_dim
        dev, dt = self.device, cfg.dtype
        gen = torch.Generator(device=dev).manual_seed(seed)

        def uniform(shape):  # DMatrix::Random()*0.001 (ref fism.hpp:66-69)
            u = torch.rand(shape, generator=gen, dtype=torch.float32,
                           device=dev)
            return (u * 0.002 - 0.001).to(dt)

        def acc(shape):
            return torch.full(shape, ADAGRAD_INIT, dtype=torch.float32,
                              device=dev)

        params: Dict[str, torch.Tensor] = {
            "bu": torch.zeros((U,), dtype=dt, device=dev),
            "bi": torch.zeros((I,), dtype=dt, device=dev),
            "bu_ag": acc((U,)),
            "bi_ag": acc((I,)),
            "P": uniform((I, D)),
            "Q": uniform((I, D)),
            "P_ag": acc((I, D)),
            "Q_ag": acc((I, D)),
        }
        state = ModelState(params=params, padded=data.padded(), num_users=U,
                           num_items=I)
        # x cache: x_u = sum_{j in R_u} P_j (ref fism.hpp:71-78)
        items, mask, _ = self._padded_rows(state)
        params["x"] = _rebuild_x(params["P"], items, mask)
        if cfg.using_global_mean and len(data):
            state.aux["global_mean"] = float(np.mean(data.ratings))
        dense = cfg.dense_mode
        if dense is None:
            dense = dense_fits(U, I, cfg.batch_size)
        if dense and not self.pairwise:
            state.aux["dense_R"] = self._dense_R(data)
        return state

    def _padded_rows(self, state: ModelState):
        """Every user's padded items (long) and mask (dtype), and lengths,
        on the device, built once per state."""
        if "padded_rows" not in state.aux:
            pb = state.padded
            state.aux["padded_rows"] = (
                self._tensor(pb.items, torch.long),
                self._tensor(pb.mask).to(self.cfg.dtype),
                self._tensor(pb.lengths, torch.long),
            )
        return state.aux["padded_rows"]

    # ------------------------------------------------------------- train ----
    def _sparse_batches(self, state: ModelState):
        """The sparse route's user batches (uids, items, mask, lengths,
        weight) on the device. They do not change between epochs (no
        shuffle, as in cdae_tpu), so they are built once per state."""
        if "sparse_batches" not in state.aux:
            state.aux["sparse_batches"] = [
                (self._tensor(mb.uids, torch.long),
                 self._tensor(mb.items, torch.long),
                 self._tensor(mb.mask, torch.bool),
                 self._tensor(mb.lengths, torch.long),
                 self._tensor(mb.weight, torch.float32))
                for mb in iter_user_batches(
                    state.padded, self.cfg.batch_size,
                    bucket_by_length=self.cfg.bucket_by_length)
            ]
        return state.aux["sparse_batches"]

    def train_one_iteration(self, state: ModelState, seed: int = 0,
                            draws: Optional[Sequence[dict]] = None,
                            coll=None) -> ModelState:
        """One epoch, in place: the slab route when ``dense_R`` is
        resident, else the sparse (or pairwise) step over the user
        batches. ``draws[b]`` (optional) holds keyword draws for step b
        (``u01`` for the slab step, ``neg`` for the others). ``coll``
        (parallel/trainer.py ShardedFISM): one rank's epoch of the sharded
        slab on its block of dense_R (``dense_R_block``), x rebuilt for
        its user block from its P block."""
        params, cfg = state.params, self.cfg
        R = state.aux.get("dense_R" if coll is None else "dense_R_block")
        if R is not None and not self.pairwise:
            uid_mat, w_mat = self._dense_user_batches(state)
            shard = {} if coll is None else {"coll": coll}
            for j in range(uid_mat.shape[0]):
                _fism_dense_step(
                    params, R, uid_mat[j], w_mat[j], self._lr,
                    step_seed(seed, state.step, j, 0), cfg=cfg,
                    loss=self.loss, **shard,
                    **(draws[j] if draws is not None else {}))
            # per-batch refreshes are exact for the batch's users, but P
            # rows they share with other users moved: rebuild every x_u
            if coll is None:
                params["x"] = R.to(cfg.dtype) @ params["P"]
            else:
                params["x"] = coll.model_sum(R.to(cfg.dtype) @ params["P"])
        else:
            step = _fism_pair_step if self.pairwise else _fism_step
            for b, batch in enumerate(self._sparse_batches(state)):
                step(params, *batch, self._lr,
                     step_seed(seed, state.step, b, 0), cfg=cfg,
                     loss=self.loss,
                     **(draws[b] if draws is not None else {}))
            items, mask, _ = self._padded_rows(state)
            params["x"] = _rebuild_x(params["P"], items, mask)
        state.step += 1
        return state

    # -------------------------------------------------------------- loss ----
    def data_loss(self, state, sample_size: int = 0) -> float:
        return 0.0  # FISM trains through the SGD solver; unused in the ref

    def penalty_loss(self, state) -> float:
        return 0.0

    # ----------------------------------------------------------- scoring ----
    def batch_scores(self, state: ModelState, uids, rated_items, rated_mask
                     ) -> torch.Tensor:
        """Catalog scores with the UNRATED scale for every item, exactly
        the reference recommend() (fism.hpp:170-196)."""
        u = self._tensor(uids, torch.long)
        lengths = self._padded_rows(state)[2]
        return _fism_scores(state.params, u, lengths[u], alpha=self.cfg.alpha)

    def predict(self, state: ModelState, users, items) -> torch.Tensor:
        """Pointwise predictions honouring the rated/unrated split (ref
        fism.hpp:198-215); membership by searchsorted on the sorted padded
        rows."""
        p = state.params
        u_np = np.asarray(users)
        u = self._tensor(u_np, torch.long)
        i = self._tensor(items, torch.long)
        rated_rows = self._tensor(state.padded.items[u_np], torch.long)
        lengths = self._tensor(state.padded.lengths[u_np])
        pos = torch.searchsorted(rated_rows.contiguous(), i[:, None])[:, 0]
        pos = torch.clamp(pos, 0, rated_rows.shape[1] - 1)
        is_rated = rated_rows.gather(1, pos[:, None])[:, 0] == i
        s_rated, s_unrated = _scales(lengths, self.cfg.alpha, p["x"].dtype)
        x = p["x"][u]
        q = p["Q"][i]
        dot_unrated = torch.sum(x * q, -1) * s_unrated
        dot_rated = torch.sum((x - p["P"][i]) * q, -1) * s_rated
        return (p["bu"][u] + p["bi"][i]
                + torch.where(is_rated, dot_rated, dot_unrated))


def _fism_scores(params, uids, lengths, *, alpha):
    _, s_unrated = _scales(lengths, alpha, params["x"].dtype)
    return (params["bu"][uids][:, None] + params["bi"][None, :]
            + (params["x"][uids] @ params["Q"].t()) * s_unrated[:, None])


def _rebuild_x(P, all_items, all_mask_f):
    """x_u = sum over the user's padded row of P rows (masked)."""
    rows = P[torch.clamp(all_items, 0, P.shape[0] - 1)]
    return torch.einsum("uld,ul->ud", rows, all_mask_f)


def _refresh_x_rows(params, uids, items, mask_f, weight):
    """Exact x refresh for the batch's users from the updated P, in place.
    Delta-add (not a set): padding rows repeat a live uid at weight 0, and
    a duplicate set could clobber the live row."""
    I = params["P"].shape[0]
    rows = params["P"][torch.clamp(items, 0, I - 1)]
    x_new = torch.einsum("bld,bl->bd", rows, mask_f)
    delta = torch.where(weight[:, None] > 0, x_new - params["x"][uids], 0.0)
    params["x"].index_add_(0, uids, delta)


def _fism_adagrad(params, grads, lr: float, cfg: FISMConfig):
    """AdaGrad without beta (ref fism.hpp:119-121: grad /= sqrt(acc)), in
    place, over every table of ``grads``: one launch of kernel B2 on CUDA
    tensors, its plain version on CPU tensors."""
    dense_adagrad_steps(
        [(params[name], params[name + "_ag"], g.contiguous())
         for name, g in grads.items()],
        lr, 0.0, cfg.using_adagrad, use_kernel=True)
    return params


def _step_uniforms(seed: int, shape, cfg: FISMConfig, device, block=None):
    """(B, I) uniforms in [0, 1) of the slab step: hw_uniform (B1) with
    ``fast_rng``, else a generator seeded with ``seed``. ``block`` = (row
    offset, column offset, whole shape): that block of the whole draw."""
    r0, c0, full = block if block is not None else (0, 0, tuple(shape))
    if cfg.fast_rng:
        return hw_uniform(seed, tuple(shape), device=device, row_offset=r0,
                          col_offset=c0)
    gen = torch.Generator(device=device).manual_seed(int(seed) & _MASK32)
    u = torch.rand(tuple(full), generator=gen, device=device)
    return u if block is None else u[r0:r0 + shape[0], c0:c0 + shape[1]]


def _fism_step(params, uids, items, mask, lengths, weight, lr: float,
               seed: int, *, cfg: FISMConfig, loss: Loss,
               neg: Optional[torch.Tensor] = None):
    """Batched pointwise FISM step (ref fism.hpp:92-166), in place.
    ``neg`` (B, num_neg * L) injects the complement draws (default:
    ``sample_unrated`` with ``seed``)."""
    I, D = params["P"].shape
    B, L = items.shape
    lam = cfg.lambda_
    dt = params["P"].dtype
    w = weight.to(dt)
    mask_f = mask.to(dt) * w[:, None]
    items_c = torch.clamp(items, 0, I - 1)

    s_rated, s_unrated = _scales(lengths, cfg.alpha, dt)
    x = params["x"][uids]  # (B, D)
    bu_u = params["bu"][uids]
    P_rows = params["P"][items_c]  # (B, L, D)
    Q_pos = params["Q"][items_c]  # (B, L, D)

    # positives: pred_i = bu + bi + s_r * (x - p_i) . q_i
    pred_pos = (bu_u[:, None] + params["bi"][items_c]
                + torch.einsum("bld,bld->bl", x[:, None, :] - P_rows, Q_pos)
                * s_rated[:, None])
    g_pos = loss.gradient(pred_pos, loss.positive_label) * mask_f  # (B, L)

    # negatives: num_neg per positive (ref fism.hpp:92-104)
    nn = max(cfg.num_neg, 0)
    Nn = max(nn * L, 1)
    if neg is None:
        neg = sample_unrated(seed, items, lengths, I, Nn, hw=cfg.fast_rng)
    neg = neg.to(torch.long)
    neg_c = torch.clamp(neg, 0, I - 1)
    # the sentinel id I (empty complement) zero-weights its slot
    neg_mask = (mask_f.repeat(1, nn) * (neg < I).to(dt) if nn > 0
                else torch.zeros((B, Nn), dtype=dt, device=items.device))
    Q_neg = params["Q"][neg_c]  # (B, Nn, D)
    pred_neg = (bu_u[:, None] + params["bi"][neg_c]
                + torch.einsum("bd,bnd->bn", x, Q_neg) * s_unrated[:, None])
    g_neg = loss.gradient(pred_neg, loss.negative_label) * neg_mask

    grads = {}
    sm = cfg.scatter_mode
    # one flat index vector over positives and negatives: Q's and bi's
    # gradients ride ONE row aggregation, bi as an extra value column; P's
    # ids (the positives) are its prefix, so one plan serves both sums
    all_idx = torch.cat([items.reshape(-1), neg.reshape(-1)])
    plan = row_plan(all_idx, I, sm)
    if cfg.using_bias_term:
        grads["bu"] = torch.zeros_like(params["bu"]).index_add_(
            0, uids, torch.sum(g_pos, 1) + torch.sum(g_neg, 1)
            + lam * bu_u * w)

    def bi_vals():
        return torch.cat([
            (g_pos + lam * params["bi"][items_c] * mask_f).reshape(-1),
            (g_neg + lam * params["bi"][neg_c] * neg_mask).reshape(-1),
        ])

    if cfg.using_factor_term:
        # Q gradients (ref fism.hpp:145-160)
        gq_pos = ((g_pos * s_rated[:, None])[..., None]
                  * (x[:, None, :] - P_rows) + lam * Q_pos) * mask_f[..., None]
        gq_neg = ((g_neg * s_unrated[:, None])[..., None] * x[:, None, :]
                  + lam * Q_neg) * neg_mask[..., None]
        q_vals = torch.cat([gq_pos.reshape(-1, D), gq_neg.reshape(-1, D)])
        if cfg.using_bias_term:
            agg = scatter_add_rows(
                torch.zeros((I, D + 1), dtype=q_vals.dtype,
                            device=q_vals.device),
                all_idx, torch.cat([q_vals, bi_vals()[:, None]], dim=1),
                mode=sm, plan=plan)
            grads["Q"] = agg[:, :D]
            grads["bi"] = agg[:, D]
        else:
            grads["Q"] = scatter_add_rows(torch.zeros_like(params["Q"]),
                                          all_idx, q_vals, mode=sm, plan=plan)
        # P gradients: every rated j gets the sum over the row's instances
        # of g * q * scale, minus the self term for positive j (ref
        # fism.hpp:136-144 skips jid == iid)
        S = (torch.einsum("bl,bld->bd", g_pos, Q_pos) * s_rated[:, None]
             + torch.einsum("bn,bnd->bd", g_neg, Q_neg)
             * s_unrated[:, None])  # (B, D)
        gp = (S[:, None, :] - (g_pos * s_rated[:, None])[..., None] * Q_pos
              + lam * P_rows) * mask_f[..., None]
        grads["P"] = scatter_add_rows(torch.zeros_like(params["P"]),
                                      items.reshape(-1), gp.reshape(-1, D),
                                      mode=sm, plan=plan)
    elif cfg.using_bias_term:
        grads["bi"] = scatter_add_rows(torch.zeros_like(params["bi"]),
                                       all_idx, bi_vals(), mode=sm, plan=plan)

    _fism_adagrad(params, grads, lr, cfg)
    if cfg.using_factor_term:
        _refresh_x_rows(params, uids, items, mask_f, w)
    return params


def _fism_dense_step(params, R, uids, weight, lr: float, seed: int, *,
                     cfg: FISMConfig, loss: Loss,
                     u01: Optional[torch.Tensor] = None, coll=None):
    """Full-catalog slab pointwise FISM step (ref fism.hpp:92-166 as
    matmuls), in place. With R's (B, I) rated rows and x the cache, every
    gather and scatter of the sparse step becomes a matmul:

      pred = bu + bi + (x Q^T - R * sum_d P*Q) * scale
      dQ   = g~^T x - diag(sum_b g~*R) P     (g~ = loss grad * touch * scale)
      dP   = R^T (g~ Q) - diag(sum_b g~*R) Q  (self term k = i excluded)

    Negatives are Bernoulli over the complement with num_neg * |R_u|
    expected draws; ``u01`` injects the (B, I) uniforms (default from
    ``seed``).

    ``coll`` (parallel/mesh.py ``Collectives``; None: the single-device
    step): one rank's step of a sharded slab. ``R`` is the rank's block of
    dense_R (``coll.batch_rows`` reads it); the step takes its rows of the
    batch (``uids`` / ``weight`` whole) by its block of P, Q and bi; x and
    bu are user blocks. Row sums over the item block (lengths, S = gs Q,
    the x refresh) are completed over
    'model', the item gradients over 'data' before the one B2 launch, and
    the user rows go to their owners."""
    dt = params["P"].dtype
    uids_all, weight_all, block = uids, weight, None
    if coll is not None:
        sl = coll.rows(uids.shape[0])
        uids, weight = uids[sl], weight[sl]
        block = (sl.start, coll.col_offset, (uids_all.shape[0],
                                             coll.num_items))

    def msum(t):
        return t if coll is None else coll.model_sum(t)

    def user_rows(name):
        if coll is None:
            return params[name][uids]
        return coll.gather_users(params[name], uids_all)[sl]

    w_user = weight.to(dt)  # (B,)
    R_rows = R[uids] if coll is None else coll.batch_rows(R, uids_all)
    rows = R_rows.to(dt) * w_user[:, None]  # (B, I)
    I = rows.shape[1] if coll is None else coll.num_items
    lengths = msum(torch.sum(rows, dim=1))
    s_rated, s_unrated = _scales(lengths, cfg.alpha, dt)
    p_neg = torch.clamp(
        cfg.num_neg * lengths / torch.clamp(I - lengths, min=1.0), 0.0, 1.0)
    if u01 is None:
        u01 = _step_uniforms(seed, rows.shape, cfg, rows.device, block)
    neg_sel = ((1.0 - rows) * (u01 < p_neg[:, None]).to(dt)
               * w_user[:, None])
    touch = rows + neg_sel  # (B, I) instances this step
    x = user_rows("x")  # (B, D), exact at batch entry
    bu_u = user_rows("bu")
    base = x @ params["Q"].t()  # (B, I)
    corr = torch.sum(params["P"] * params["Q"], dim=1)  # (I,) p_i . q_i
    scale = torch.where(rows > 0, s_rated[:, None], s_unrated[:, None])
    pred = (bu_u[:, None] + params["bi"][None, :]
            + (base - rows * corr[None, :]) * scale)
    labels = torch.where(rows > 0, loss.positive_label, loss.negative_label)
    g = loss.gradient(pred, labels.to(dt)) * touch  # (B, I)
    gs = g * scale
    lam = cfg.lambda_
    grads = {}
    if cfg.using_bias_term:
        bu_rows = msum(torch.sum(g, dim=1)) + lam * bu_u * w_user
        if coll is None:
            grads["bu"] = torch.zeros_like(params["bu"]).index_add_(
                0, uids, bu_rows)
        else:
            own, owned = coll.own_users(uids_all)
            grads["bu"] = torch.zeros_like(params["bu"]).index_add_(
                0, own, torch.where(owned, coll.data_gather(bu_rows), 0.0))
        grads["bi"] = (torch.sum(g, dim=0)
                       + lam * params["bi"] * torch.sum(touch, dim=0))
    if cfg.using_factor_term:
        touch_i = torch.sum(touch, dim=0)  # (I,)
        rated_g = torch.sum(gs * rows, dim=0)  # (I,) self-term weights
        grads["Q"] = (gs.t() @ x - rated_g[:, None] * params["P"]
                      + lam * params["Q"] * touch_i[:, None])
        S_rows = msum(gs @ params["Q"])  # (B, D)
        grads["P"] = (rows.t() @ S_rows - rated_g[:, None] * params["Q"]
                      + lam * params["P"] * torch.sum(rows, dim=0)[:, None])
    if coll is not None:
        # bu is whole per owner already; the item blocks' grads are partial
        grads.update(coll.data_sum_all(
            {k: v for k, v in grads.items() if k != "bu"}))
    _fism_adagrad(params, grads, lr, cfg)
    if cfg.using_factor_term:
        # exact x refresh for the batch's users from the UPDATED P
        x_new = msum(rows @ params["P"])
        delta = torch.where(w_user[:, None] > 0, x_new - x, 0.0)
        if coll is None:
            params["x"].index_add_(0, uids, delta)
        else:
            own, owned = coll.own_users(uids_all)
            params["x"].index_add_(0, own, torch.where(
                owned[:, None], coll.data_gather(delta), 0.0))
    return params


def _fism_pair_step(params, uids, items, mask, lengths, weight, lr: float,
                    seed: int, *, cfg: FISMConfig, loss: Loss,
                    neg: Optional[torch.Tensor] = None):
    """Batched pairwise FISM step (rebuilt from fism_pair.hpp:100-161), in
    place: for each positive i and sampled negative j, the gradient of
    s(u,i) - s(u,j) against truth 1, with x~_u = x_u - p_i on BOTH sides
    (as in the reference). ``neg`` (B, max(num_neg, 1) * L) injects the
    complement draws."""
    I, D = params["P"].shape
    B, L = items.shape
    lam = cfg.lambda_
    dt = params["P"].dtype
    w = weight.to(dt)
    mask_f = mask.to(dt) * w[:, None]
    items_c = torch.clamp(items, 0, I - 1)

    s_rated, _ = _scales(lengths, cfg.alpha, dt)
    x = params["x"][uids]
    P_rows = params["P"][items_c]
    Q_pos = params["Q"][items_c]

    nn = max(cfg.num_neg, 1)
    Nn = nn * L
    if neg is None:
        neg = sample_unrated(seed, items, lengths, I, Nn, hw=cfg.fast_rng)
    neg = neg.to(torch.long)
    neg3 = neg.reshape(B, nn, L)
    neg_valid = (neg3 < I).to(dt)
    neg_c = torch.clamp(neg3, 0, I - 1)  # (B, nn, L)
    Q_neg = params["Q"][neg_c]  # (B, nn, L, D)

    xt = x[:, None, :] - P_rows  # (B, L, D) x~ per positive
    pred_i = (params["bi"][items_c]
              + torch.einsum("bld,bld->bl", xt, Q_pos) * s_rated[:, None])
    # the negative side by the plain rating rule with the same x~; bu
    # cancels in the pair difference
    pred_j = (params["bi"][neg_c]
              + torch.einsum("bld,bnld->bnl", xt, Q_neg)
              * s_rated[:, None, None])  # (B, nn, L)
    diff = pred_i[:, None, :] - pred_j
    g = loss.gradient(diff, 1.0) * mask_f[:, None, :] * neg_valid  # (B,nn,L)
    g_sum = torch.sum(g, dim=1)  # (B, L) over the negative slots

    sm = cfg.scatter_mode
    all_idx = torch.cat([items.reshape(-1), neg.reshape(-1)])
    plan = row_plan(all_idx, I, sm)  # bi's, Q's and (its prefix) P's sums
    grads = {}
    if cfg.using_bias_term:
        grads["bi"] = scatter_add_rows(
            torch.zeros_like(params["bi"]), all_idx,
            torch.cat([
                (g_sum + nn * lam * params["bi"][items_c] * mask_f)
                .reshape(-1),
                (-g + lam * params["bi"][neg_c] * mask_f[:, None, :])
                .reshape(-1),
            ]), mode=sm, plan=plan)

    # Q: qi_grad = g * x~ * s + lam q_i ; qj_grad = -g * x~ * s + lam q_j
    gq_i = ((g_sum * s_rated[:, None])[..., None] * xt
            + nn * lam * Q_pos) * mask_f[..., None]
    gq_j = (-(g * s_rated[:, None, None])[..., None] * xt[:, None, :, :]
            + lam * Q_neg) * mask_f[:, None, :, None]
    grads["Q"] = scatter_add_rows(
        torch.zeros_like(params["Q"]), all_idx,
        torch.cat([gq_i.reshape(-1, D), gq_j.reshape(-1, D)]), mode=sm,
        plan=plan)

    # P: each rated k != i gets g * (q_i - q_j) * s + lam p_k per pair
    dq = (torch.einsum("bnl,bld->bd", g, Q_pos)
          - torch.einsum("bnl,bnld->bd", g, Q_neg))  # sum of g (q_i - q_j)
    self_term = (g_sum[..., None] * Q_pos
                 - torch.einsum("bnl,bnld->bld", g, Q_neg))
    gp = ((dq[:, None, :] - self_term) * s_rated[:, None, None]
          + lam * P_rows) * mask_f[..., None]
    grads["P"] = scatter_add_rows(torch.zeros_like(params["P"]),
                                  items.reshape(-1), gp.reshape(-1, D),
                                  mode=sm, plan=plan)

    _fism_adagrad(params, grads, lr, cfg)
    _refresh_x_rows(params, uids, items, mask_f, w)
    return params


class FISMPair(FISM):
    """Pairwise FISM (rebuilt from the reference's broken fism_pair.hpp);
    default LOG loss, like BPR. It always runs the sparse pair step."""

    name = "FISMPair"
    pairwise = True

    def __init__(self, config: Optional[FISMConfig] = None, device="cuda",
                 **kw):
        if config is None and "loss" not in kw:
            kw["loss"] = "LOG"
        super().__init__(config, device, **kw)

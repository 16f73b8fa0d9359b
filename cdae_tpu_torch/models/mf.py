"""Matrix-factorization family on PyTorch: PMF, IMF, BPR, WARP (port of
cdae_tpu/models/mf.py).

Shared layout, as in cdae_tpu: {uv (U, D), iv (I, D), ub (U,), ib (I,)}
with AdaGrad accumulators (init 1e-4) and the score
  s(u, i) = ub_u + ib_i + uv_u . iv_i

  PMF  -- observed-ratings MF (ref pmf.hpp:80-104)
  IMF  -- implicit MF: each positive + num_neg sampled negatives
          (ref imf.hpp:71-115)
  BPR  -- pairwise ranking on s(u,i) - s(u,j), LOG loss, no user-bias
          update (ref bpr.hpp:60-106)
  WARP -- rank-weighted pairwise: the first violating negative out of at
          most num_tries candidates, weight l[items_left / cnt]
          (ref warp.hpp:55-117)

Two epoch shapes, as in cdae_tpu:

* The instance epoch shuffles the (user, item) instances into fixed-size
  minibatches; a step gathers its rows, computes per-instance (PMF, IMF)
  or per-pair (BPR, WARP) gradient contributions, sums them into the
  tables (ops/scatter.py) and applies one AdaGrad step (kernel B2: one
  launch over the step's dense tables), or with ``row_update`` updates only
  the touched rows (duplicate-safe delta AdaGrad). IMF and BPR draw their
  negatives by ``sample_unrated`` over the step's padded rated rows (int32,
  gathered once a step). WARP has three routes here: the dense path (the
  (U, I) int8 rated mask; with ``use_pallas``, on by default on a CUDA
  device, the violator count and picks are kernel B7), the pool path
  (``warp_pool``: one shared pool of P candidates a step; pool membership
  from the rated mask, or from the CSR rows by ``is_rated`` without it --
  the same truth table, so the same bits) and the scan path (no mask, no
  pool: num_tries complement candidates per slot, the first violator).
* The user slab (``dense_mode=True``; PMF and IMF also by the auto rule
  while the (U, I) matrix and the (B, I) slabs fit): users in fixed order,
  B a step; every gather and scatter of the item side becomes a (B, I)
  matmul over the users' rated rows, and the user rows take a delta
  AdaGrad. IMF draws Bernoulli complement negatives with num_neg * |R_u|
  expected draws; BPR pairs each positive with M = num_shared_neg shared
  catalog draws per user (rated draws dropped, one exact rescue draw when
  all M are rated); WARP scores a shared pool of P = warp_pool (default
  1024) ids and Rao-Blackwellizes the pick and the try count. The (B, I,
  M), (B, I, P) and (B, I, num_tries) cubes are taken in user chunks of at
  most ``_CUBE_ELEMS`` elements: every reduction over I, P, M or num_tries
  is per user, so the chunks change no number.

Kernels: every fixed-order ``scatter_mode`` (all but ``"scatter"``, the
default ``"auto"`` included) sums with kernel B8 on a CUDA device -- the
steps' aggregations, the slabs' negative-row scatters and
``row_adagrad_delta``'s per-row sums (the slabs' user rows and
``row_update``) -- so every route is reproducible bit for bit on the card.
``gather_mode="mxu"`` sends the pointwise and pairwise steps' row gathers
to kernel B9. ``fast_rng`` draws from B1's hash stream (``hw_uniform``,
``hw_randint``). ``use_pallas`` off keeps every draw and sum the same but
runs B1's and B2's plain versions.

Random draws. cdae_tpu's threefry and TPU hardware streams cannot be
reproduced in torch. Each epoch's permutation comes from a generator seeded
by (solver seed, ``state.step``), and step b's draws from the step seeds
``step_seed(seed, state.step, b, k)``, k = 1, 2, 3 (cdae_tpu's split of the
step key), so a resumed run replays the unbroken run's draws. Every step
also takes injected draws, so tests feed it the very draws cdae_tpu makes:
IMF and BPR ``neg``; the IMF slab ``u01``; the BPR slab ``j`` and
``u_rank``; WARP's dense path ``sel_seed``, ``u1`` and ``v``, its pool path
``pool``, ``u1`` and ``noise``, its scan path ``cand`` and its slab
``pool``.

Differences from cdae_tpu: parameters are updated in place; an epoch is a
Python loop of steps (``epoch_chunk``, which bounds a TPU program's length,
is accepted and does nothing); the BPR slab's rescue draw is computed every
step and selected with ``torch.where`` (cdae_tpu's ``lax.cond`` runs it
only on a step that needs it; a host-side test would cost a device sync a
step); the batched bisections are ``torch.searchsorted``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from cdae_tpu_torch.data.dataset import Interactions
from cdae_tpu_torch.models.base import (
    ModelState,
    RecsysModel,
    dense_fits,
    resolve_device,
)
from cdae_tpu_torch.ops.losses import Loss
from cdae_tpu_torch.ops.pallas_kernels import (
    gather_rows_mxu,
    hw_uniform,
    hw_uniform_plain,
    warp_violator_select,
)
from cdae_tpu_torch.ops.penalties import Penalty
from cdae_tpu_torch.ops.sampling import hw_randint, is_rated, sample_unrated
from cdae_tpu_torch.ops.scatter import row_plan, scatter_add_rows
from cdae_tpu_torch.solver.optimizer import (
    ADAGRAD_INIT,
    dense_adagrad_steps,
    row_adagrad_delta,
)
from cdae_tpu_torch.utils.random import step_seed

_MASK32 = 0xFFFFFFFF
# the most elements of one user chunk of a slab's 3-D cube
_CUBE_ELEMS = 1 << 28


@dataclasses.dataclass(frozen=True)
class MFConfig:
    """Every field of cdae_tpu's MFConfig, so CLI flags and checkpoints
    carry over."""

    learn_rate: float = 0.1
    beta: float = 1.0
    lambda_: float = 0.01
    loss: str = "SQUARE"
    penalty: str = "L2"
    num_dim: int = 10
    num_neg: int = 5
    using_bias_term: bool = True
    using_adagrad: bool = True
    batch_size: int = 1024  # instances per minibatch; users per slab
    num_tries: int = 64  # WARP: candidate negatives per update (truncation)
    dense_mode: Optional[bool] = None  # True: the per-user slab step; None:
    # PMF/IMF auto (the (U, I) matrix fits), BPR/WARP off (WARP then keeps
    # the instance epoch with the (U, I) rated mask while U*I <= 1.5e9)
    num_shared_neg: int = 32  # BPR slab: M shared draws per user
    fast_rng: Optional[bool] = None  # B1's hash draws; None = off, as in
    # cdae_tpu
    row_update: Optional[bool] = None  # touched-rows delta AdaGrad; None =
    # on above 131072 items
    epoch_chunk: Optional[int] = None  # accepted, no effect: it bounds a
    # TPU program's length, and the port dispatches step by step anyway
    use_pallas: Optional[bool] = None  # WARP's violator kernel (B7), and
    # the kernels (not the plain versions) of B1 and B2; None = on a CUDA
    # device
    warp_pool: Optional[int] = None  # WARP: the pool path (P candidates a
    # step); the slab's pool size (default 1024)
    gather_mode: str = "auto"  # auto|native|mxu ("mxu" is kernel B9)
    scatter_mode: str = "auto"  # ops/scatter.py: pallas* is kernel B8, and
    # on CUDA every mode but "scatter" (one index_add) is too
    dtype: Any = torch.float32


def _init_mf_params(gen: torch.Generator, U: int, I: int, D: int, dt,
                    device, scale: float = 0.01) -> Dict[str, torch.Tensor]:
    """U(-scale, scale) factors (uv, then iv, from ``gen``), zero biases,
    f32 accumulators at 1e-4."""
    def uniform(shape):
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        return (u * (2.0 * scale) - scale).to(dt)

    def acc(shape):
        return torch.full(shape, ADAGRAD_INIT, dtype=torch.float32,
                          device=device)

    return {
        "uv": uniform((U, D)),
        "iv": uniform((I, D)),
        "ub": torch.zeros((U,), dtype=dt, device=device),
        "ib": torch.zeros((I,), dtype=dt, device=device),
        "uv_ag": acc((U, D)),
        "iv_ag": acc((I, D)),
        "ub_ag": acc((U,)),
        "ib_ag": acc((I,)),
    }


def _adagrad_apply(params, grads, cfg: MFConfig, coll=None):
    """One dense accumulate-then-apply AdaGrad step over every table of
    ``grads``, in place: one launch of the adagrad_update kernel (B2) when
    ``use_pallas`` is on. With ``coll`` (a sharded step) gradients summed
    from the rank's rows alone are summed over 'data' first."""
    if coll is not None and not coll.gather_contribs:
        grads = coll.data_sum_all(grads)
    dense_adagrad_steps(
        [(params[name], params[name + "_ag"], g) for name, g in grads.items()],
        cfg.learn_rate, cfg.beta, cfg.using_adagrad,
        use_kernel=bool(cfg.use_pallas))
    return params


def _use_mxu_gather(cfg: MFConfig) -> bool:
    """cdae_tpu's rule: only an explicit ``gather_mode="mxu"``."""
    return cfg.gather_mode == "mxu"


def _gather_factor_bias(factors, bias, idx, cfg: MFConfig, coll=None):
    """(rows, bias) of the tables at ``idx``: plain row indexing, or with
    ``gather_mode="mxu"`` one B9 gather of ``[factors | bias]`` (the bias
    rides as an extra column). With ``coll`` and the item tables split over
    'model', item rows gathered from their owners (``coll.gather_items``)."""
    if coll is not None and coll.items_split:
        return coll.gather_items(factors, idx), coll.gather_items(bias, idx)
    if _use_mxu_gather(cfg):
        D = factors.shape[1]
        tbl = torch.cat([factors, bias[:, None]], dim=1).to(torch.float32)
        rows = gather_rows_mxu(tbl, idx.reshape(-1).long())
        rows = rows.reshape(*idx.shape, D + 1)
        return rows[..., :D], rows[..., D]
    return factors[idx], bias[idx]


def _use_row_update(cfg: MFConfig, num_items: int) -> bool:
    if cfg.row_update is not None:
        return cfg.row_update
    return num_items > 131072


# ------------------------------------------------------------ pointwise ----

def _pointwise_contribs(uv_u, iv_i, ub_u, ib_i, labels, w, cfg: MFConfig,
                        loss: Loss):
    """Pointwise update math on gathered rows (ref pmf.hpp:80-104): g =
    loss'(s(u,i), y) * w; each touch adds its own 2*lambda*param term.
    Returns per-instance rows (d_uv (P, D), d_iv (P, D), d_ub (P,), d_ib
    (P,))."""
    lam2 = 2.0 * cfg.lambda_
    pred = ub_u + ib_i + torch.sum(uv_u * iv_i, dim=-1)
    g = loss.gradient(pred, labels) * w
    d_uv = g[:, None] * iv_i + (lam2 * uv_u) * w[:, None]
    d_iv = g[:, None] * uv_u + (lam2 * iv_i) * w[:, None]
    d_ub = g + lam2 * ub_u * w
    d_ib = g + lam2 * ib_i * w
    return d_uv, d_iv, d_ub, d_ib


def _num_items(params, coll) -> int:
    """The catalog size of a step: the item table's rows, or a sharded
    step's whole catalog."""
    return params["iv"].shape[0] if coll is None else coll.num_items


def _rows_of(coll, B: int, *xs):
    """A sharded step's rows ``coll.rows(B)`` of each batch array (None
    stays None); without ``coll`` the arrays themselves."""
    if coll is None:
        return xs
    sl = coll.rows(B)
    return tuple(None if x is None else x[sl] for x in xs)


def _row_aggregate(n: int, idx, vals, sm: str, coll=None, items=False):
    """(n, C) sums of ``vals`` rows at ``idx`` (one B8 plan and reduce
    where the scatter mode runs B8). With ``coll`` in its contribution-
    gathering form (ShardedMFTP) the rows of every 'data' rank are
    all-gathered first, and item ids sum into this rank's own item block
    only."""
    if coll is not None and coll.gather_contribs:
        idx = coll.data_gather(idx)
        vals = coll.data_gather(vals)
    if coll is not None and items:
        idx = coll.own_items(idx)
    return scatter_add_rows(
        torch.zeros((n, vals.shape[1]), dtype=vals.dtype,
                    device=vals.device),
        idx, vals, mode=sm, plan=row_plan(idx, n, sm))


def _pointwise_grads(params, u, i, labels, w, cfg: MFConfig, loss: Loss,
                     coll=None):
    """Per-instance contributions of the PMF/IMF rule summed into full
    tables: one aggregation over the user ids and one over the item ids,
    each with its bias as an extra value column (B8's modes: a plan each).
    The rows come from one gather per table pair (B9's with
    ``gather_mode="mxu"``)."""
    uv_u, ub_u = _gather_factor_bias(params["uv"], params["ub"], u, cfg)
    iv_i, ib_i = _gather_factor_bias(params["iv"], params["ib"], i, cfg,
                                     coll)
    d_uv, d_iv, d_ub, d_ib = _pointwise_contribs(uv_u, iv_i, ub_u, ib_i,
                                                 labels, w, cfg, loss)
    grads = {}
    for side, idx, d_f, d_b in (("u", u, d_uv, d_ub), ("i", i, d_iv, d_ib)):
        table = params[side + "v"]
        n, D = table.shape
        vals = (torch.cat([d_f, d_b[:, None]], dim=1)
                if cfg.using_bias_term else d_f)
        acc = _row_aggregate(n, idx, vals, cfg.scatter_mode, coll,
                             items=side == "i")
        grads[side + "v"] = acc[:, :D].contiguous()
        if cfg.using_bias_term:
            grads[side + "b"] = acc[:, D].contiguous()
    return grads


def _pointwise_apply(params, u, i, labels, w, cfg: MFConfig, loss: Loss,
                     coll=None):
    """One pointwise minibatch update, in place: full-table
    accumulate-then-apply AdaGrad, or with ``row_update`` the touched rows'
    delta AdaGrad (B8's per-row sums where the scatter mode runs B8). With
    ``coll`` (a sharded step; the instances are the rank's rows) the dense
    apply, its gradients completed over 'data'."""
    if coll is not None or not _use_row_update(cfg, params["iv"].shape[0]):
        return _adagrad_apply(
            params,
            _pointwise_grads(params, u, i, labels, w, cfg, loss, coll), cfg,
            coll)
    d_uv, d_iv, d_ub, d_ib = _pointwise_contribs(
        params["uv"][u], params["iv"][i], params["ub"][u], params["ib"][i],
        labels, w, cfg, loss)
    live = w > 0
    updates = [("uv", u, d_uv, live[:, None]), ("iv", i, d_iv, live[:, None])]
    if cfg.using_bias_term:
        updates += [("ub", u, d_ub, live), ("ib", i, d_ib, live)]
    for name, idx, g, lv in updates:
        row_adagrad_delta(params[name], params[name + "_ag"], idx, g, lv,
                          cfg.learn_rate, cfg.beta, cfg.using_adagrad,
                          mode=cfg.scatter_mode)
    return params


# ------------------------------------------------------------- pairwise ----

def _pair_contribs(uv_u, iv_i, iv_j, ib_i, ib_j, w, cfg: MFConfig,
                   loss: Loss, rank_weight=None, update_bias=True):
    """Pair-update math on gathered rows (ref bpr.hpp:72-106,
    warp.hpp:90-117): g = loss'(s(u,i) - s(u,j), 1) [* rank_weight] per
    (row, slot), each touch with its own 2*lambda*param term. Returns
    (d_uv_rows (B, D), pos_vals (B, C), neg_vals (B, nn, C), with_bias),
    C = D (+1 bias column when with_bias)."""
    lam2 = 2.0 * cfg.lambda_
    diff = iv_i[:, None, :] - iv_j  # (B, nn, D)
    pred = ib_i[:, None] - ib_j + torch.sum(uv_u[:, None, :] * diff, dim=-1)
    g = loss.gradient(pred, 1.0) * w
    if rank_weight is not None:
        g = g * rank_weight
    gsum = torch.sum(g, dim=1)
    wsum = torch.sum(w, dim=1)
    d_uv_rows = (torch.sum(g[..., None] * diff, dim=1)
                 + (lam2 * uv_u) * wsum[:, None])
    pos_vals = gsum[:, None] * uv_u + (lam2 * iv_i) * wsum[:, None]
    neg_vals = -g[..., None] * uv_u[:, None, :] + (lam2 * iv_j) * w[..., None]
    with_bias = update_bias and cfg.using_bias_term
    if with_bias:
        pos_vals = torch.cat(
            [pos_vals, (gsum + lam2 * ib_i * wsum)[:, None]], dim=1)
        neg_vals = torch.cat(
            [neg_vals, (-g + lam2 * ib_j * w)[..., None]], dim=2)
    return d_uv_rows, pos_vals, neg_vals, with_bias


def _pairwise_grads(params, u, i, j, w, cfg: MFConfig, loss: Loss,
                    rank_weight=None, update_bias=True, coll=None):
    """Pair contributions of (u, i) against nn negatives j (B, nn), summed
    into full tables: B user rows, and one aggregation of the B positive
    and B*nn negative item rows (bias as an extra value column). The
    B*(1+nn) item rows come from one gather and the B user rows from
    another (B9's with ``gather_mode="mxu"``)."""
    B = u.shape[0]
    iv_rows, ib_rows = _gather_factor_bias(
        params["iv"], params["ib"], torch.cat([i, j.reshape(-1)]), cfg, coll)
    iv_i, ib_i = iv_rows[:B], ib_rows[:B]
    iv_j = iv_rows[B:].reshape(B, -1, iv_rows.shape[-1])
    ib_j = ib_rows[B:].reshape(B, -1)
    uv_u = (gather_rows_mxu(params["uv"].to(torch.float32), u.long())
            if _use_mxu_gather(cfg) else params["uv"][u])
    d_uv_rows, pos_vals, neg_vals, with_bias = _pair_contribs(
        uv_u, iv_i, iv_j, ib_i, ib_j, w, cfg, loss,
        rank_weight=rank_weight, update_bias=update_bias,
    )
    D = params["uv"].shape[1]
    I = params["iv"].shape[0]
    C = pos_vals.shape[-1]
    sm = cfg.scatter_mode
    item_ids = torch.cat([i, j.reshape(-1)])
    # item and user sums have different ids: a plan each (B8's modes)
    acc = _row_aggregate(I, item_ids,
                         torch.cat([pos_vals, neg_vals.reshape(-1, C)]), sm,
                         coll, items=True)
    grads = {
        "uv": _row_aggregate(params["uv"].shape[0], u, d_uv_rows, sm, coll),
        "iv": acc[:, :D].contiguous(),
    }
    if with_bias:
        grads["ib"] = acc[:, D].contiguous()
    return grads


def _pairwise_apply(params, u, i, j, w, cfg: MFConfig, loss: Loss,
                    rank_weight=None, update_bias=True, coll=None):
    """One pairwise minibatch update, in place: full-table
    accumulate-then-apply AdaGrad, or with ``row_update`` the touched rows'
    delta AdaGrad (duplicates within a batch see a sequential accumulator;
    B8's per-row sums where the scatter mode runs B8). With ``coll`` (a
    sharded step; the pairs are the rank's rows) the dense apply, its
    gradients completed over 'data'."""
    if coll is not None or not _use_row_update(cfg, params["iv"].shape[0]):
        return _adagrad_apply(
            params,
            _pairwise_grads(params, u, i, j, w, cfg, loss,
                            rank_weight=rank_weight, update_bias=update_bias,
                            coll=coll),
            cfg, coll,
        )
    d_uv_rows, pos_vals, neg_vals, with_bias = _pair_contribs(
        params["uv"][u], params["iv"][i], params["iv"][j],
        params["ib"][i], params["ib"][j], w, cfg, loss,
        rank_weight=rank_weight, update_bias=update_bias,
    )
    D = params["uv"].shape[1]
    C = pos_vals.shape[-1]
    lr, beta, ada, sm = (cfg.learn_rate, cfg.beta, cfg.using_adagrad,
                         cfg.scatter_mode)
    acc_idx = torch.cat([i, j.reshape(-1)])
    acc_vals = torch.cat([pos_vals, neg_vals.reshape(-1, C)])
    u_live = torch.any(w > 0, dim=1)
    live = torch.cat([u_live, (w > 0).reshape(-1)])
    row_adagrad_delta(params["iv"], params["iv_ag"], acc_idx,
                      acc_vals[:, :D], live[:, None], lr, beta, ada, mode=sm)
    if with_bias:
        row_adagrad_delta(params["ib"], params["ib_ag"], acc_idx,
                          acc_vals[:, D], live, lr, beta, ada, mode=sm)
    row_adagrad_delta(params["uv"], params["uv_ag"], u, d_uv_rows,
                      u_live[:, None], lr, beta, ada, mode=sm)
    return params


# ----------------------------------------------------------------- slabs ----

def _dense_mf_grads(params, rows, labels, w_mat, uids, cfg: MFConfig,
                    loss: Loss, coll=None, uids_all=None):
    """The slab form of ``_pointwise_grads``: the (B, I) touch matrix
    ``w_mat`` carries per-(user, item) multiplicities and every gather and
    scatter is a matmul (ref pmf.hpp:80-104 / imf.hpp:86-115). Returns
    (item-table grads, user-row grads), all from the pre-update tables.
    With ``coll`` (a sharded slab: the rank's rows of the batch
    ``uids_all`` by its item block) the user rows come from their owners
    and the row sums over the item block are completed over 'model'; the
    item grads are the rank's rows' part."""
    lam2 = 2.0 * cfg.lambda_
    if coll is None:
        uv_u, ub_u = params["uv"][uids], params["ub"][uids]  # (B, D), (B,)
    else:
        sl = coll.rows(uids_all.shape[0])
        uv_u = coll.gather_users(params["uv"], uids_all)[sl]
        ub_u = coll.gather_users(params["ub"], uids_all)[sl]
    pred = (ub_u[:, None] + params["ib"][None, :]
            + uv_u @ params["iv"].t())
    # the truth slab, then one gradient pass (gradients are elementwise)
    truth = torch.where(rows > 0, labels,
                        torch.as_tensor(loss.negative_label, dtype=pred.dtype,
                                        device=pred.device))
    g = loss.gradient(pred, truth) * w_mat
    def msum(x):
        return x if coll is None else coll.model_sum(x)

    row_touch = msum(torch.sum(w_mat, dim=1))  # (B,) touches per user
    col_touch = torch.sum(w_mat, dim=0)  # (I,)
    grads = {"iv": g.t() @ uv_u + lam2 * col_touch[:, None] * params["iv"]}
    row_grads = {"uv": msum(g @ params["iv"])
                 + lam2 * row_touch[:, None] * uv_u}
    if cfg.using_bias_term:
        grads["ib"] = torch.sum(g, dim=0) + lam2 * col_touch * params["ib"]
        row_grads["ub"] = (msum(torch.sum(g, dim=1))
                           + lam2 * row_touch * ub_u)
    return grads, row_grads


def _dense_row_apply(params, row_grads, uids, w_user, cfg: MFConfig,
                     coll=None, uids_all=None, weight_all=None):
    """Per-user-row AdaGrad by the duplicate-safe delta-add (the slab's
    padding rows repeat uid 0 at weight 0); each row's sums are B8's where
    the scatter mode runs B8. With ``coll`` the rows' gradients are
    gathered over 'data' and each rank updates its own user block."""
    for name, g in row_grads.items():
        if coll is not None:
            rows, owned = coll.own_users(uids_all)
            live = (weight_all > 0) & owned
            g, idx = coll.data_gather(g), rows
        else:
            live, idx = w_user > 0, uids
        live = live[:, None] if g.dim() == 2 else live
        row_adagrad_delta(params[name], params[name + "_ag"], idx, g, live,
                          cfg.learn_rate, cfg.beta, cfg.using_adagrad,
                          mode=cfg.scatter_mode)
    return params


def _slab_rows(coll, R, uids, weight, dt):
    """A slab step's (uids, weight, rows, lengths, block) of the batch:
    the whole batch, or a sharded step's rows of it by its block of R
    (``coll.batch_rows``; lengths completed over 'model'; ``block`` the
    draw block for ``_uniforms``)."""
    w_user = weight.to(dt)
    if coll is None:
        rows = R[uids].to(dt) * w_user[:, None]
        return uids, w_user, rows, torch.sum(rows, dim=1), None
    B_all = uids.shape[0]
    sl = coll.rows(B_all)
    rows = coll.batch_rows(R, uids).to(dt) * w_user[sl][:, None]
    uids, w_user = uids[sl], w_user[sl]
    lengths = coll.model_sum(torch.sum(rows, dim=1))
    return uids, w_user, rows, lengths, (sl.start, coll.col_offset,
                                         (B_all, coll.num_items))


def _user_chunks(B: int, per_user: int):
    """Slices of [0, B) whose cube (users x ``per_user`` elements) stays
    within ``_CUBE_ELEMS``."""
    step = max(1, _CUBE_ELEMS // max(per_user, 1))
    return [slice(s, min(s + step, B)) for s in range(0, B, step)]


# ----------------------------------------------------------------- draws ----

def _uniforms(seed: int, shape, cfg: MFConfig, device,
              block=None) -> torch.Tensor:
    """(rows, cols) float32 uniforms in [0, 1): ``hw_uniform`` (B1; its
    plain version with ``use_pallas`` off) with ``fast_rng``, else a
    generator seeded with ``seed``. ``block`` = (row offset, column offset,
    whole shape): ``shape`` is that block of the whole draw (a sharded
    step's), which B1 draws alone and a generator cuts from the whole."""
    r0, c0, full = block if block is not None else (0, 0, shape)
    if cfg.fast_rng:
        draw = hw_uniform if cfg.use_pallas else hw_uniform_plain
        return draw(seed, tuple(shape), device=device, row_offset=r0,
                    col_offset=c0)
    gen = torch.Generator(device=device).manual_seed(int(seed) & _MASK32)
    u = torch.rand(tuple(full), generator=gen, device=device)
    return u if block is None else u[r0:r0 + shape[0], c0:c0 + shape[1]]


def _randint(seed: int, shape, maxval, cfg: MFConfig, device,
             salt: int = 0) -> torch.Tensor:
    """ints uniform in [0, maxval) (a number or a tensor broadcastable to
    ``shape``): ``hw_randint`` with ``fast_rng`` (cdae_tpu's salt), else a
    generator seeded with ``seed`` (float64 uniforms scaled and
    floored)."""
    if cfg.fast_rng:
        return hw_randint(seed, shape, maxval, salt=salt, device=device,
                          use_kernel=bool(cfg.use_pallas))
    gen = torch.Generator(device=device).manual_seed(int(seed) & _MASK32)
    u = torch.rand(shape, generator=gen, dtype=torch.float64, device=device)
    mx = torch.as_tensor(maxval, device=device)
    return torch.minimum((u * mx).to(torch.int64), mx - 1)


def _count_uniforms(seed: int, shape, cfg: MFConfig, device) -> torch.Tensor:
    """(B, nn) uniforms in [1e-7, 1) of WARP's try-count draw."""
    u = _uniforms(seed, shape, cfg, device)
    if cfg.fast_rng:
        return torch.clamp(u, min=1e-7)
    return 1e-7 + (1.0 - 1e-7) * u


# --------------------------------------------------------------- scoring ----

def _mf_batch_scores(params, uids) -> torch.Tensor:
    return (params["ub"][uids][:, None] + params["ib"][None, :]
            + params["uv"][uids] @ params["iv"].t())


def _mf_data_loss(params, u, i, r, *, loss: Loss) -> torch.Tensor:
    pred = params["ub"][u] + params["ib"][i] + torch.sum(
        params["uv"][u] * params["iv"][i], dim=-1)
    return torch.sum(loss.evaluate(pred, r))


class _MFBase(RecsysModel):
    """Shared reset, epochs, losses and scoring of the MF family."""

    dense_auto = True  # dense_mode None: the slab by the auto rule
    uses_ratings = False  # the slab needs the (U, I) rating matrix

    def __init__(self, config: Optional[MFConfig] = None, device="cuda",
                 **kw):
        self.device = resolve_device(device)
        self.cfg = config if config is not None else MFConfig(**kw)
        if self.cfg.fast_rng is None:
            self.cfg = dataclasses.replace(self.cfg, fast_rng=False)
        if self.cfg.use_pallas is None:
            self.cfg = dataclasses.replace(
                self.cfg, use_pallas=self.device.type == "cuda")
        self.loss = Loss.create(self.cfg.loss)
        self.penalty = Penalty.create(self.cfg.penalty)

    # ------------------------------------------------------------- reset ----
    def reset(self, data: Interactions, seed: int = 0) -> ModelState:
        cfg = self.cfg
        U, I = data.num_users, data.num_items
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = _init_mf_params(gen, U, I, cfg.num_dim, cfg.dtype,
                                 self.device)
        state = ModelState(params=params, padded=data.padded(), num_users=U,
                           num_items=I)
        state.aux["coo"] = (data.users, data.items, data.ratings)
        dense = cfg.dense_mode
        if dense is None:
            dense = self.dense_auto and dense_fits(U, I, cfg.batch_size)
        if dense:
            state.aux["dense_R"] = self._dense_R(data)
            if self.uses_ratings:
                # the host build keeps the first occurrence of a pair
                state.aux["dense_ratings"] = self._tensor(
                    data.dense_matrix(binary=False))
        return state

    def _device_data(self, state: ModelState):
        """(users, items, ratings, padded rated rows (U, L) int32, lengths)
        on the device, built once per state."""
        if "device_data" not in state.aux:
            users, items, ratings = state.aux["coo"]
            pb = state.padded
            state.aux["device_data"] = (
                self._tensor(users, torch.long),
                self._tensor(items, torch.long),
                self._tensor(ratings, torch.float32),
                self._tensor(pb.items, torch.int32),
                self._tensor(pb.lengths, torch.int32),
            )
        return state.aux["device_data"]

    def _epoch_extras(self, state: ModelState) -> tuple:
        """Per-user device tables threaded into ``_step`` (row-gathered by
        user id each step). Default none."""
        return ()

    def _needs_rated(self, extras: tuple) -> bool:
        """Whether ``_step`` reads the step users' padded rated rows."""
        return False

    # ------------------------------------------------------------- train ----
    def train_one_iteration(self, state: ModelState, seed: int = 0,
                            perm=None, draws: Optional[Sequence[dict]] = None,
                            coll=None) -> ModelState:
        """One epoch, in place. With ``dense_R`` resident: the user slabs in
        fixed order. Else the instance epoch: shuffle the instances
        (``perm``, or a permutation from the seed of (``seed``,
        ``state.step``)), pad to whole batches of ``batch_size`` with
        weight-0 instances, and run one ``_step`` per batch. ``draws[b]``
        (optional) holds keyword draws for step (or slab) b. ``coll``
        (parallel/trainer.py): one rank's epoch of a sharded run -- the same
        batches and draws, each step given the collectives (a slab reads
        the rank's block of dense_R, ``dense_R_block``)."""
        cfg = self.cfg
        shard = {} if coll is None else {"coll": coll}
        R = state.aux.get("dense_R" if coll is None else "dense_R_block")
        if R is not None:
            ratings = state.aux.get("dense_ratings", R) if coll is None else R
            uid_mat, w_mat = self._dense_user_batches(state)
            for j in range(uid_mat.shape[0]):
                keys = tuple(step_seed(seed, state.step, j, k)
                             for k in (1, 2))
                self._dense_step(
                    state.params, R, ratings, uid_mat[j], w_mat[j], keys,
                    cfg=cfg, loss=self.loss, **shard,
                    **(draws[j] if draws is not None else {}))
            state.step += 1
            return state
        users, items, ratings, pad_items, lengths = self._device_data(state)
        n = users.shape[0]
        bs = cfg.batch_size
        num_batches = max(-(-n // bs), 1)
        total = num_batches * bs
        if perm is None:
            gen = torch.Generator().manual_seed(
                step_seed(seed, state.step, -1, 0) & _MASK32)
            perm = torch.randperm(n, generator=gen)
        perm = self._tensor(perm, torch.long)
        if tuple(perm.shape) != (n,):
            raise ValueError(f"perm has shape {tuple(perm.shape)}, expected "
                             f"({n},)")
        sel_all = torch.cat([perm, perm.new_zeros(total - n)])
        w_all = (torch.arange(total, device=self.device) < n).to(
            torch.float32)
        extras = self._epoch_extras(state)
        needs_rated = self._needs_rated(extras)
        for b in range(num_batches):
            sel = sel_all[b * bs:(b + 1) * bs]
            u = users[sel]
            keys = tuple(step_seed(seed, state.step, b, k) for k in (1, 2, 3))
            self._step(
                state.params, u, items[sel], ratings[sel],
                w_all[b * bs:(b + 1) * bs],
                pad_items[u] if needs_rated else None, lengths[u], keys,
                *(e[u] for e in extras), cfg=cfg, loss=self.loss, **shard,
                **(draws[b] if draws is not None else {}),
            )
        state.step += 1
        return state

    # -------------------------------------------------------------- loss ----
    def data_loss(self, state: ModelState, sample_size: int = 0) -> float:
        """The loss over every training instance (``sample_size`` is
        accepted and ignored, as in cdae_tpu)."""
        users, items, ratings, _, _ = self._device_data(state)
        return float(_mf_data_loss(state.params, users, items, ratings,
                                   loss=self.loss))

    def penalty_loss(self, state: ModelState) -> float:
        p = state.params
        pen = self.penalty.evaluate
        total = pen(p["uv"]) + pen(p["iv"]) + pen(p["ub"]) + pen(p["ib"])
        return float(self.cfg.lambda_ * total)

    # ----------------------------------------------------------- scoring ----
    def batch_scores(self, state: ModelState, uids, rated_items, rated_mask
                     ) -> torch.Tensor:
        return _mf_batch_scores(state.params, self._tensor(uids, torch.long))

    def predict(self, state: ModelState, users, items) -> torch.Tensor:
        p = state.params
        u = self._tensor(users, torch.long)
        i = self._tensor(items, torch.long)
        return p["ub"][u] + p["ib"][i] + torch.sum(p["uv"][u] * p["iv"][i],
                                                   dim=-1)


class PMF(_MFBase):
    """Rating MF over the observed entries (ref pmf.hpp)."""

    name = "PMF"
    uses_ratings = True

    @staticmethod
    def _step(params, u, i, r, w, rated, lengths, keys, *extras,
              cfg: MFConfig, loss: Loss, coll=None):
        u, i, r, w = _rows_of(coll, u.shape[0], u, i, r, w)
        return _pointwise_apply(params, u, i, r, w, cfg, loss, coll)

    @staticmethod
    def _dense_step(params, R, ratings, uids, weight, keys, *, cfg: MFConfig,
                    loss: Loss, coll=None):
        """One slab over the observed ratings; ``coll``: a sharded slab
        (``R`` / ``ratings`` the rank's column blocks)."""
        uids_all, weight_all = uids, weight
        uids, w_user, rows, _, _ = _slab_rows(coll, R, uids, weight,
                                              params["uv"].dtype)
        grads, row_grads = _dense_mf_grads(params, rows, ratings[uids], rows,
                                           uids, cfg, loss, coll, uids_all)
        _adagrad_apply(params, grads, cfg, coll)
        return _dense_row_apply(params, row_grads, uids, w_user, cfg, coll,
                                uids_all, weight_all)


class IMF(_MFBase):
    """Implicit MF: each positive + num_neg sampled negatives (ref
    imf.hpp:71-115), labels by the loss's positive/negative conventions."""

    name = "IMF"

    def _needs_rated(self, extras: tuple) -> bool:
        return self.cfg.num_neg > 0

    @staticmethod
    def _step(params, u, i, r, w, rated, lengths, keys, *extras,
              cfg: MFConfig, loss: Loss, neg: Optional[torch.Tensor] = None,
              coll=None):
        """One minibatch: each positive and num_neg exact complement draws
        (``neg`` (B, num_neg) injects them; default ``sample_unrated`` from
        the step seed k1); the sentinel id I gets weight 0. With ``coll``
        (a sharded step) the whole batch's draws are taken, then the
        rank's rows of them."""
        I = _num_items(params, coll)
        nn = max(cfg.num_neg, 0)
        if nn == 0:
            u, i, r, w = _rows_of(coll, u.shape[0], u, i, r, w)
            return _pointwise_apply(
                params, u, i, torch.full_like(r, loss.positive_label), w,
                cfg, loss, coll)
        if neg is None:
            neg = sample_unrated(keys[0], rated, lengths, I, nn,
                                 hw=cfg.fast_rng,
                                 use_kernel=bool(cfg.use_pallas))
        neg = torch.as_tensor(neg, device=u.device).long()
        u, i, w, neg = _rows_of(coll, u.shape[0], u, i, w, neg)
        B = u.shape[0]
        all_u = u[:, None].expand(B, nn + 1)
        all_i = torch.cat([i[:, None], neg], dim=1)
        labels = torch.cat([
            torch.full((B, 1), loss.positive_label, device=u.device),
            torch.full((B, nn), loss.negative_label, device=u.device)], dim=1)
        all_w = w[:, None] * (all_i < I).to(w.dtype)
        return _pointwise_apply(
            params, all_u.reshape(-1),
            torch.clamp(all_i, 0, I - 1).reshape(-1), labels.reshape(-1),
            all_w.reshape(-1), cfg, loss, coll)

    @staticmethod
    def _dense_step(params, R, ratings, uids, weight, keys, *, cfg: MFConfig,
                    loss: Loss, u01: Optional[torch.Tensor] = None,
                    coll=None):
        """One slab: Bernoulli complement negatives with p = num_neg * |R_u|
        / (I - |R_u|) (``u01`` (B, I) injects the uniforms; default B1's
        with ``fast_rng``, else a generator, from the step seed k1).
        ``coll``: a sharded slab (``R`` the rank's column block; the
        uniforms the block of the whole slab's, B1 at its offsets)."""
        dt = params["uv"].dtype
        uids_all, weight_all = uids, weight
        uids, w_user, rows, lengths, block = _slab_rows(coll, R, uids,
                                                        weight, dt)
        I = rows.shape[1] if coll is None else coll.num_items
        p_neg = torch.clamp(
            cfg.num_neg * lengths / torch.clamp(I - lengths, min=1.0),
            0.0, 1.0)
        if u01 is None:
            u01 = _uniforms(keys[0], rows.shape, cfg, rows.device, block)
        neg_sel = ((1.0 - rows) * (u01 < p_neg[:, None]).to(dt)
                   * w_user[:, None])
        labels = torch.full_like(rows, loss.positive_label)
        grads, row_grads = _dense_mf_grads(params, rows, labels,
                                           rows + neg_sel, uids, cfg, loss,
                                           coll, uids_all)
        _adagrad_apply(params, grads, cfg, coll)
        return _dense_row_apply(params, row_grads, uids, w_user, cfg, coll,
                                uids_all, weight_all)


class BPR(_MFBase):
    """Bayesian personalized ranking (ref bpr.hpp). Default loss LOG;
    num_neg pairs per positive. The sparse step (default) draws num_neg
    exact complement negatives per positive; the slab (``dense_mode=True``,
    opt-in) shares M = num_shared_neg catalog draws per user among the
    user's positives at weight num_neg / M_live."""

    name = "BPR"
    dense_auto = False  # the slab's cadence is a measured trade: opt-in

    def __init__(self, config: Optional[MFConfig] = None, device="cuda",
                 **kw):
        if config is None and "loss" not in kw:
            kw["loss"] = "LOG"
        super().__init__(config, device, **kw)

    def _needs_rated(self, extras: tuple) -> bool:
        return True

    @staticmethod
    def _step(params, u, i, r, w, rated, lengths, keys, *extras,
              cfg: MFConfig, loss: Loss, neg: Optional[torch.Tensor] = None,
              coll=None):
        """One minibatch of pairs against max(num_neg, 1) exact complement
        draws (``neg`` injects them; default ``sample_unrated`` from k1).
        With ``coll``: the whole batch's draws, then the rank's rows."""
        I = _num_items(params, coll)
        nn = max(cfg.num_neg, 1)
        if neg is None:
            neg = sample_unrated(keys[0], rated, lengths, I, nn,
                                 hw=cfg.fast_rng,
                                 use_kernel=bool(cfg.use_pallas))
        neg = torch.as_tensor(neg, device=u.device).long()
        u, i, w, neg = _rows_of(coll, u.shape[0], u, i, w, neg)
        # the sentinel id I (empty complement) zero-weights its pairs
        pair_w = w[:, None] * (neg < I).to(w.dtype)
        return _pairwise_apply(params, u, i, torch.clamp(neg, 0, I - 1),
                               pair_w, cfg, loss, coll=coll)

    @staticmethod
    def _dense_step(params, R, ratings, uids, weight, keys, *, cfg: MFConfig,
                    loss: Loss, j: Optional[torch.Tensor] = None,
                    u_rank: Optional[torch.Tensor] = None):
        """One slab with shared negatives (ref bpr.hpp:72-106 per pair; ub
        never updates). ``j`` (B, M) injects the catalog draws (default from
        k1) and ``u_rank`` (B, 1) the rescue's rank in [0, free) (default
        from k2, cdae_tpu's salt): a row whose M draws are all rated takes
        its (u_rank+1)-th unrated item in slot 0."""
        dt = params["uv"].dtype
        I = params["iv"].shape[0]
        B = uids.shape[0]
        M = max(cfg.num_shared_neg, 1)
        nn = max(cfg.num_neg, 1)
        lam2 = 2.0 * cfg.lambda_
        dev = uids.device
        w_user = weight.to(dt)
        rows01 = R[uids].to(dt)  # (B, I) 0/1 positives
        rows = rows01 * w_user[:, None]
        uv_u = params["uv"][uids]
        S = uv_u @ params["iv"].t() + params["ib"][None, :]  # (B, I)
        if j is None:
            j = _randint(keys[0], (B, M), I, cfg, dev)
        j = torch.as_tensor(j, device=dev).long()
        # 1 iff the draw is unrated and the row is real
        live = (1.0 - rows01.gather(1, j)) * w_user[:, None]
        L_u = torch.sum(rows, dim=1)  # (B,)
        need = ((torch.sum(live, dim=1) <= 0) & (L_u < float(I))
                & (w_user > 0))
        # the rescue, every step (selected by ``need``)
        j_rescue = _rescue_draw(rows01, keys[1], cfg, u_rank)
        hit = need[:, None] & (torch.arange(M, device=dev) == 0)[None, :]
        j = torch.where(hit, j_rescue[:, None], j)
        live = torch.where(hit, 1.0, live)
        m_live = torch.sum(live, dim=1)  # >= 1 iff the complement is not empty
        a = torch.where(m_live > 0, nn / torch.clamp(m_live, min=1.0), 0.0)
        t = S.gather(1, j)  # (B, M)
        pos_w = torch.empty_like(S)
        neg_w = torch.empty_like(t)
        for c in _user_chunks(B, I * M):
            g = loss.gradient(S[c, :, None] - t[c, None, :], 1.0)  # (b, I, M)
            pos_w[c] = rows[c] * a[c, None] * torch.bmm(
                g, live[c, :, None])[..., 0]
            neg_w[c] = live[c] * a[c, None] * torch.bmm(
                rows[c, None, :], g)[:, 0]
        # a row without a live negative forms no pairs and takes no 2*lambda
        # terms (ref: each rides an actual pair update)
        has_pair = (m_live > 0).to(dt)
        pos_touch = rows * (w_user * nn * has_pair)[:, None]
        neg_touch = torch.where(m_live > 0, a * L_u, 0.0)[:, None] * live
        col_touch = torch.sum(pos_touch, dim=0)  # (I,)
        iv_j = params["iv"][j]  # (B, M, D)
        D = iv_j.shape[-1]
        d_iv = pos_w.t() @ uv_u + lam2 * col_touch[:, None] * params["iv"]
        neg_vals = ((-neg_w)[:, :, None] * uv_u[:, None, :]
                    + lam2 * neg_touch[:, :, None] * iv_j).reshape(-1, D)
        if cfg.using_bias_term:
            neg_bias = -neg_w + lam2 * neg_touch * params["ib"][j]
            neg_vals = torch.cat([neg_vals, neg_bias.reshape(-1, 1)], dim=1)
        # the B*M negative rows: one aggregation (bias as a column)
        jf = j.reshape(-1)
        sm = cfg.scatter_mode
        agg = scatter_add_rows(
            torch.zeros((I, neg_vals.shape[1]), dtype=neg_vals.dtype,
                        device=dev), jf, neg_vals, mode=sm,
            plan=row_plan(jf, I, sm))
        grads = {"iv": d_iv + agg[:, :D]}
        if cfg.using_bias_term:
            grads["ib"] = (torch.sum(pos_w, dim=0)
                           + lam2 * col_touch * params["ib"]) + agg[:, D]
        # user rows from the pre-update iv
        d_uv = (pos_w @ params["iv"]
                - torch.einsum("bm,bmd->bd", neg_w, iv_j)
                + lam2 * (w_user * nn * has_pair)[:, None] * L_u[:, None]
                * uv_u)
        _adagrad_apply(params, grads, cfg)
        return _dense_row_apply(params, {"uv": d_uv}, uids, w_user, cfg)


def _rescue_draw(rows01, seed: int, cfg: MFConfig,
                 u_rank: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The BPR slab's rescue: one exact uniform draw from each (B, I) 0/1
    row's unrated items, the (u+1)-th zero of the row = #{i : zcum[i] <= u}
    (zcum the running count of zeros, monotone) for u uniform in [0, free)
    (``u_rank`` (B, 1), default from ``seed`` with cdae_tpu's salt)."""
    zeros = rows01 <= 0
    if u_rank is None:
        free = torch.clamp(zeros.sum(dim=1, dtype=torch.int32), min=1)
        u_rank = _randint(seed, (rows01.shape[0], 1), free[:, None], cfg,
                          rows01.device, salt=0x7E5C)
    zcum = torch.cumsum(zeros, dim=1, dtype=torch.int32)
    j = torch.searchsorted(zcum, torch.as_tensor(u_rank, device=zcum.device)
                           .to(torch.int32).contiguous(), right=True)[:, 0]
    return torch.clamp(j, 0, rows01.shape[1] - 1)


class WARP(_MFBase):
    """Weighted approximate-rank pairwise (ref warp.hpp). Default HINGE
    loss, beta=0, lambda=0.1 (WARPConfig warp.hpp:12-23).

    Routes: the dense path (the instance epoch with the (U, I) int8 rated
    mask: dense_mode None and U*I <= 1.5e9), the pool path (``warp_pool``,
    with the mask or, without it, the CSR rows), the scan path (no mask, no
    pool) and the slab (``dense_mode=True``)."""

    name = "WARP"
    dense_auto = False  # the slab's cadence is a measured trade: opt-in

    def __init__(self, config: Optional[MFConfig] = None, device="cuda",
                 **kw):
        if config is None:
            kw.setdefault("loss", "HINGE")
            kw.setdefault("beta", 0.0)
            kw.setdefault("lambda_", 0.1)
        super().__init__(config, device, **kw)

    def _epoch_extras(self, state: ModelState) -> tuple:
        U, I = state.num_users, state.num_items
        use_dense = self.cfg.dense_mode
        if use_dense is None:
            use_dense = dense_fits(U, I, 0)  # the (U, I) mask alone
        if not use_dense:
            return ()
        if "rated_mask" not in state.aux:
            users, items, _ = state.aux["coo"]
            R = torch.zeros((U, I), dtype=torch.int8, device=self.device)
            R[self._tensor(users, torch.long),
              self._tensor(items, torch.long)] = 1
            state.aux["rated_mask"] = R
        return (state.aux["rated_mask"],)

    def _needs_rated(self, extras: tuple) -> bool:
        return not extras  # the pool path's CSR membership; the scan path

    @staticmethod
    def _step(params, u, i, r, w, rated, lengths, keys, *extras,
              cfg: MFConfig, loss: Loss, coll=None, **draws):
        """One minibatch: with the rated mask threaded in, the pool path
        (``warp_pool``) or the dense path; without it, the pool path on the
        CSR rows or the scan path. ``coll``: a sharded step (each path
        takes the rank's rows of the whole batch's draws)."""
        kw = dict(cfg=cfg, loss=loss, coll=coll, **draws)
        if extras:
            if cfg.warp_pool:
                return WARP._pool_path(params, u, i, w, lengths, keys,
                                       extras[0], **kw)
            return WARP._dense_path(params, u, i, w, lengths, keys,
                                    extras[0], **kw)
        if cfg.warp_pool:
            return WARP._pool_path(params, u, i, w, lengths, keys, None,
                                   rated=rated, **kw)
        return WARP._scan_path(params, u, i, w, rated, lengths, keys, **kw)

    @staticmethod
    def _rank_weighted_apply(params, u, i, j, w, lengths, cnt, found,
                             cfg: MFConfig, loss: Loss, coll=None):
        """The pair update of every route: rank weight l[items_left / cnt],
        pairs weighted by ``found``; ub and ib never update (ref
        warp.hpp:90-117 has those updates commented out)."""
        I = _num_items(params, coll)
        items_left = torch.clamp(I - lengths, min=1)
        rw = _warp_harmonic(I, params["iv"].device)[
            torch.clamp(items_left[:, None] // cnt, 0, I - 1).long()]
        return _pairwise_apply(params, u, i, j.long(), w[:, None] * found,
                               cfg, loss, rank_weight=rw, update_bias=False,
                               coll=coll)

    @staticmethod
    def _geometric_counts(p, u1, T):
        """cnt ~ Geometric(p) truncated at T from uniforms ``u1`` (the
        rejection loop's try count), and whether a violator was found."""
        log1mp = torch.log1p(-torch.clamp(p, 0.0, 1.0 - 1e-7))[:, None]
        cnt_f = 1.0 + torch.floor(torch.log(u1)
                                  / torch.clamp(log1mp, max=-1e-12))
        # saturate before the cast: p = 0 gives counts past int32
        cnt = torch.clamp(cnt_f, max=float(T + 1)).to(torch.int32)
        return torch.clamp(cnt, 1, T), cnt <= T

    @staticmethod
    def _dense_path(params, u, i, w, lengths, keys, mask_rows, *,
                    cfg: MFConfig, loss: Loss, sel_seed: Optional[int] = None,
                    u1: Optional[torch.Tensor] = None,
                    v: Optional[torch.Tensor] = None, coll=None):
        """One WARP step from the full score rows. ``keys`` = (k1, k2, ...),
        the step seeds of the count uniforms and of the picks. Injected
        draws replace them: ``sel_seed`` (B7's int32 seed, default k2),
        ``u1`` ((B, nn) uniforms in [1e-7, 1), default from k1) and ``v``
        ((B, nn) ranks in [0, max(nviol, 1)) of the picks on the cumsum
        route, default from k2). ``coll`` (a data-parallel sharded step,
        the item table whole): the rank's rows, B7 at their row offset,
        the count uniforms and ranks cut from the whole batch's draws."""
        I = params["iv"].shape[0]
        B_all = u.shape[0]
        nn = max(cfg.num_neg, 1)
        T = max(cfg.num_tries, 1)
        dev = params["iv"].device
        k1, k2 = keys[0], keys[1]
        r0 = 0
        if coll is not None:
            r0 = coll.rows(B_all).start
            if u1 is None:
                u1 = _count_uniforms(k1, (B_all, nn), cfg, dev)
            u, i, w, lengths, mask_rows, u1 = _rows_of(
                coll, B_all, u, i, w, lengths, mask_rows, u1)
        B = u.shape[0]
        uv_u = params["uv"][u]
        use_kernel = bool(cfg.use_pallas)
        if use_kernel:
            # B7: violator count + nn uniform picks, no (B, I) array
            yui = params["ib"][i] + torch.sum(uv_u * params["iv"][i], dim=-1)
            nviol, j = warp_violator_select(
                k2 if sel_seed is None else sel_seed, uv_u, params["iv"],
                params["ib"], yui - 1.0, mask_rows, nn, row_offset=r0,
            )
        else:
            scores = uv_u @ params["iv"].t() + params["ib"][None, :]
            yui = scores.gather(1, i[:, None])[:, 0]
            viol = (scores > (yui[:, None] - 1.0)) & (mask_rows == 0)
            nviol = viol.sum(dim=1, dtype=torch.int32)
        free = torch.clamp(I - lengths, min=1)
        p = nviol.to(torch.float32) / free.to(torch.float32)
        if u1 is None:
            u1 = _count_uniforms(k1, (B, nn), cfg, dev)
        cnt, found = WARP._geometric_counts(p, u1, T)
        found = found & (nviol[:, None] > 0)
        if not use_kernel:
            # the (v+1)-th violator: first column whose running count > v
            if v is None and coll is not None:
                # the whole batch's draw at this rank's rows' ranges
                mx = torch.ones((B_all, 1), dtype=nviol.dtype, device=dev)
                mx[r0:r0 + B] = torch.clamp(nviol, min=1)[:, None]
                v = _randint(k2, (B_all, nn), mx, cfg, dev,
                             salt=0x5D1F)[r0:r0 + B]
            if v is None:
                v = _randint(k2, (B, nn), torch.clamp(nviol, min=1)[:, None],
                             cfg, dev, salt=0x5D1F)
            cum = torch.cumsum(viol, dim=1, dtype=torch.int32)
            j = torch.searchsorted(cum, v.to(cum.dtype).contiguous(),
                                   right=True)
            j = torch.clamp(j, 0, I - 1)
        return WARP._rank_weighted_apply(params, u, i, j, w, lengths, cnt,
                                         found, cfg, loss, coll)

    @staticmethod
    def _pool_path(params, u, i, w, lengths, keys, mask_rows, *,
                   cfg: MFConfig, loss: Loss, rated=None,
                   pool: Optional[torch.Tensor] = None,
                   u1: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None, coll=None):
        """Pooled-candidate rejection process (``warp_pool`` = P): one
        shared pool of P uniform ids a step (``pool``, default from k1);
        cnt ~ Geometric(p^) with p^ the violator share of the instance's
        unrated pool entries (``u1`` (B, nn), default from k2), and j
        uniform over the instance's pool violators by the argmax of iid
        noise (``noise`` (B, nn, P), default from k3). Pool membership
        comes from ``mask_rows`` (the step users' rows of the rated mask)
        or else from the padded CSR ``rated`` rows (``is_rated``): the same
        truth table, so the same update. ``coll`` (a data-parallel sharded
        step, the item table whole): the rank's rows of the whole batch's
        draws."""
        I = params["iv"].shape[0]
        B = u.shape[0]
        nn = max(cfg.num_neg, 1)
        T = max(cfg.num_tries, 1)
        P = int(cfg.warp_pool)
        dev = params["iv"].device
        if coll is not None:
            if u1 is None:
                u1 = _count_uniforms(keys[1], (B, nn), cfg, dev)
            if noise is None:
                noise = _uniforms(keys[2], (B, nn * P), cfg,
                                  dev).reshape(B, nn, P)
            u, i, w, lengths, mask_rows, rated, u1, noise = _rows_of(
                coll, B, u, i, w, lengths, mask_rows, rated, u1, noise)
            B = u.shape[0]
        uv_u = params["uv"][u]
        yui = params["ib"][i] + torch.sum(uv_u * params["iv"][i], dim=-1)
        if pool is None:
            pool = _randint(keys[0], (1, P), I, cfg, dev, salt=0x90A7)[0]
        pool = torch.as_tensor(pool, device=dev).long()
        s_pool = uv_u @ params["iv"][pool].t() + params["ib"][pool][None, :]
        if mask_rows is not None:
            unrated = mask_rows[:, pool] == 0  # (B, P)
        else:
            unrated = ~is_rated(rated, lengths, pool)
        viol = (s_pool > (yui[:, None] - 1.0)) & unrated
        nv = viol.sum(dim=1, dtype=torch.int32)
        pool_live = unrated.sum(dim=1, dtype=torch.int32)
        p = nv.to(torch.float32) / torch.clamp(pool_live.to(torch.float32),
                                               min=1.0)
        if u1 is None:
            u1 = _count_uniforms(keys[1], (B, nn), cfg, dev)
        if noise is None:
            noise = _uniforms(keys[2], (B, nn * P), cfg, dev).reshape(B, nn, P)
        cnt, found = WARP._geometric_counts(p, u1, T)
        found = found & (nv[:, None] > 0)
        # per-slot uniform pool violator: the argmax of iid noise (the first
        # of equal maxima, as in cdae_tpu)
        masked = torch.where(viol[:, None, :], noise, -1.0)
        j = pool[torch.argmax(masked, dim=2)]  # (B, nn)
        return WARP._rank_weighted_apply(params, u, i, j, w, lengths, cnt,
                                         found, cfg, loss, coll)

    @staticmethod
    def _scan_path(params, u, i, w, rated, lengths, keys, *, cfg: MFConfig,
                   loss: Loss, cand: Optional[torch.Tensor] = None,
                   coll=None):
        """num_tries complement candidates per (instance, slot) (``cand``
        (B, nn * num_tries) injects them, the sentinel I included; default
        ``sample_unrated`` from k1) and the first violator among them.
        ``coll`` (a sharded step): the rank's rows of the whole batch's
        candidates, item rows from their owners where the item table is
        split (ShardedMFTP)."""
        I = _num_items(params, coll)
        nn = max(cfg.num_neg, 1)
        T = max(cfg.num_tries, 1)
        if cand is None:
            cand = sample_unrated(keys[0], rated, lengths, I, nn * T,
                                  hw=cfg.fast_rng,
                                  use_kernel=bool(cfg.use_pallas))
        cand = torch.as_tensor(cand, device=u.device)
        u, i, w, lengths, cand = _rows_of(coll, u.shape[0], u, i, w, lengths,
                                          cand)
        B = u.shape[0]
        cand_raw = cand.long().reshape(B, nn, T)
        cand_valid = cand_raw < I  # the sentinel: an empty complement
        cand = torch.clamp(cand_raw, 0, I - 1)
        uv_u = params["uv"][u]

        def item_rows(idx):
            if coll is not None and coll.items_split:
                return (coll.gather_items(params["iv"], idx),
                        coll.gather_items(params["ib"], idx))
            return params["iv"][idx], params["ib"][idx]

        iv_i, ib_i = item_rows(i)
        iv_c, ib_c = item_rows(cand)
        yui = ib_i + torch.sum(uv_u * iv_i, dim=-1)
        # ub cancels in yui - yuj; ib does not
        yuj = ib_c + torch.einsum("bd,bntd->bnt", uv_u, iv_c)
        violation = (yuj > (yui[:, None, None] - 1.0)) & cand_valid
        found = torch.any(violation, dim=-1)
        first = torch.argmax(violation.to(torch.uint8), dim=-1)  # first True
        j = cand.gather(2, first[..., None])[..., 0]
        return WARP._rank_weighted_apply(params, u, i, j, w, lengths,
                                         (first + 1).to(torch.int32), found,
                                         cfg, loss, coll)

    @staticmethod
    def _dense_step(params, R, ratings, uids, weight, keys, *, cfg: MFConfig,
                    loss: Loss, pool: Optional[torch.Tensor] = None):
        """One slab with pooled violators (ref warp.hpp:63-117
        restructured, as cdae_tpu's): one (B, D) x (D, I) product scores
        every positive; a pool of P = warp_pool (default 1024) uniform ids
        (``pool``, default from k1) stands in for the complement draws; the
        pick and the try count are Rao-Blackwellized -- every pool violator
        takes the slot's update at weight 1/nviol, and the rank weight is
        its expectation under the truncated Geometric(p^),
          rwsum = nn * sum_{c=1..T} p^ (1-p^)^(c-1) l[items_left // c],
          ftot  = nn * (1 - (1-p^)^T).
        The (B, I, P) violation cube and the (B, I, T) power cube are taken
        in user chunks. Only the P pool rows scatter; ub and ib never
        update."""
        dt = params["uv"].dtype
        I = params["iv"].shape[0]
        B = uids.shape[0]
        nn = max(cfg.num_neg, 1)
        T = max(cfg.num_tries, 1)
        P = int(cfg.warp_pool or 1024)
        lam2 = 2.0 * cfg.lambda_
        dev = uids.device
        w_user = weight.to(dt)
        rows01 = R[uids].to(dt)
        rows = rows01 * w_user[:, None]
        uv_u = params["uv"][uids]
        S = uv_u @ params["iv"].t() + params["ib"][None, :]  # (B, I)
        if pool is None:
            pool = _randint(keys[0], (1, P), I, cfg, dev, salt=0x90A7)[0]
        pool = torch.as_tensor(pool, device=dev).long()
        S_p = S[:, pool]  # (B, P)
        unrated_p = (rows01[:, pool] == 0).to(dt) * w_user[:, None]
        live_p = unrated_p > 0
        pool_live = torch.clamp(torch.sum(unrated_p, dim=1), min=1.0)
        L_u = torch.sum(rows, dim=1)
        items_left = torch.clamp(I - L_u.to(torch.int32), min=1)
        c_grid = torch.arange(1, T + 1, dtype=torch.int32, device=dev)
        lw = _warp_harmonic(I, dev)[torch.clamp(
            items_left[:, None] // c_grid[None, :], 0, I - 1).long()]  # (B, T)
        c_exp = (c_grid - 1).to(torch.float32)
        pos_w = torch.empty_like(S)
        pos_touch = torch.empty_like(S)
        n_w = torch.empty_like(S_p)
        n_touch = torch.empty_like(S_p)
        for c in _user_chunks(B, I * max(P, T)):
            # the violation cube: a pool score beats the positive's margin
            viol = ((S_p[c, None, :] > (S[c, :, None] - 1.0))
                    & live_p[c, None, :]).to(torch.float32)  # (b, I, P)
            nv = torch.sum(viol, dim=2)  # (b, I)
            p_hat = nv / pool_live[c, None]
            log1mp = torch.log1p(-torch.clamp(p_hat, 0.0, 1.0 - 1e-7))
            pow_c = torch.exp(log1mp[:, :, None] * c_exp)  # (b, I, T)
            rwsum = nn * p_hat * torch.bmm(pow_c, lw[c, :, None])[..., 0]
            ftot = (nn * (1.0 - torch.exp(float(T) * log1mp))).to(dt)
            nv1 = torch.clamp(nv, min=1.0)
            coef = rows[c] * rwsum / nv1
            g = loss.gradient(S[c, :, None] - S_p[c, None, :], 1.0) * viol
            pos_w[c] = coef * torch.sum(g, dim=2)
            n_w[c] = torch.bmm(coef[:, None, :], g)[:, 0]
            n_touch[c] = torch.bmm((rows[c] * ftot / nv1)[:, None, :],
                                   viol)[:, 0]
            pos_touch[c] = rows[c] * ftot
        col_touch = torch.sum(pos_touch, dim=0)  # (I,)
        iv_pool = params["iv"][pool]  # (P, D)
        pool_vals = (-(n_w.t() @ uv_u)
                     + lam2 * torch.sum(n_touch, dim=0)[:, None] * iv_pool)
        d_iv = (pos_w.t() @ uv_u + lam2 * col_touch[:, None] * params["iv"]
                + scatter_add_rows(torch.zeros_like(params["iv"]), pool,
                                   pool_vals, mode=cfg.scatter_mode))
        # user rows from the pre-update iv
        d_uv = (pos_w @ params["iv"] - n_w @ iv_pool
                + lam2 * torch.sum(pos_touch, dim=1)[:, None] * uv_u)
        _adagrad_apply(params, {"iv": d_iv}, cfg)
        return _dense_row_apply(params, {"uv": d_uv}, uids, w_user, cfg)


@functools.lru_cache(maxsize=8)
def _warp_harmonic_np(num_items: int) -> np.ndarray:
    """l[n] = 1 + 1/2 + ... + 1/(n+1), the rank weight table (f32)."""
    l = 1.0 + np.concatenate(
        [[0.0], np.cumsum(1.0 / np.arange(2.0, num_items + 1.0))]
    )[:num_items]
    return l.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _warp_harmonic(num_items: int, device) -> torch.Tensor:
    return torch.as_tensor(_warp_harmonic_np(num_items), device=device)

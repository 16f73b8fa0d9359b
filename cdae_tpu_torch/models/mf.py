"""Matrix-factorization family on PyTorch: WARP (port of
cdae_tpu/models/mf.py, the parts WARP trains and serves with).

Shared layout, as in cdae_tpu: {uv (U, D), iv (I, D), ub (U,), ib (I,)}
with AdaGrad accumulators (init 1e-4) and the score
  s(u, i) = ub_u + ib_i + uv_u . iv_i
Each epoch shuffles the (user, item) instances into fixed-size minibatches;
a step gathers its rows, computes per-pair gradient contributions, sums
them into the tables (ops/scatter.py) and applies one AdaGrad step, or with
``row_update`` updates only the touched rows (duplicate-safe delta AdaGrad).

WARP (ref warp.hpp): for each positive and each of num_neg slots, draw
complement candidates until the first violator (s(u, j) > s(u, i) - 1),
capped at num_tries, and weight the pair by the harmonic rank weight
l[items_left / cnt]. The dense path samples that process in closed form:
cnt ~ Geometric(p = |violators| / |unrated|) truncated at num_tries, and j
uniform over the violators. With ``use_pallas`` on (the default on a CUDA
device) the violator count and the picks come from the hand-written kernel
``warp_violator_select`` (kernel B7); with it off, from the full (B, I)
scores, a cumulative count and one ``searchsorted`` per pick. The step's
AdaGrad sweep over uv and iv is one launch of kernel B2. With
``gather_mode="mxu"`` the step's row gathers are kernel B9
(``gather_rows_mxu``: one call for the B*(1+nn) item rows with the bias
column, one for the B user rows). On a CUDA device every ``scatter_mode``
but ``"scatter"``, the default ``"auto"`` included, sums the step's rows
with kernel B8 (``scatter_add_rows``), whose fixed summation order makes
the step reproducible bit for bit on the card.

Random draws. cdae_tpu's threefry and TPU hardware streams cannot be
reproduced in torch. Each epoch's permutation comes from a generator seeded
by (solver seed, ``state.step``), and step b's draws from the step seeds
``step_seed(seed, state.step, b, 1)`` (the count uniforms, cdae_tpu's k1)
and ``(..., 2)`` (the picks, k2), so a resumed run replays the unbroken
run's draws. ``train_one_iteration`` and ``WARP._dense_path`` also take
injected draws (the permutation; B7's seed, the count uniforms and the pick
ints), so tests feed them the very draws cdae_tpu makes.

Differences from cdae_tpu: parameters are updated in place; the epoch is a
Python loop of steps (``epoch_chunk``, which bounds a TPU program's length,
is accepted and does nothing); no padded (U, L) item matrix is kept, only
the row lengths WARP needs. Not ported yet, and raising: the slab step
(``dense_mode=True``), the pool path (``warp_pool``) and the scan path (no
rated mask) of WARP; PMF, IMF and BPR (ROADMAP A8).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from cdae_tpu_torch.data.dataset import Interactions
from cdae_tpu_torch.models.base import ModelState, RecsysModel, resolve_device
from cdae_tpu_torch.ops.losses import Loss
from cdae_tpu_torch.ops.pallas_kernels import (
    gather_rows_mxu,
    hw_uniform,
    hw_uniform_plain,
    warp_violator_select,
)
from cdae_tpu_torch.ops.penalties import Penalty
from cdae_tpu_torch.ops.sampling import hw_randint
from cdae_tpu_torch.ops.scatter import row_plan, scatter_add_rows
from cdae_tpu_torch.solver.optimizer import (
    ADAGRAD_INIT,
    dense_adagrad_steps,
    row_adagrad_delta,
)
from cdae_tpu_torch.utils.random import step_seed

_MASK32 = 0xFFFFFFFF
_LATER = ("is not ported to cdae_tpu_torch yet: it comes with a later "
          "slice (ROADMAP {entry})")


@dataclasses.dataclass(frozen=True)
class MFConfig:
    """Every field of cdae_tpu's MFConfig, so CLI flags and checkpoints
    carry over. The knobs of the paths not ported yet (num_shared_neg for
    the BPR slab, warp_pool) are kept; their paths raise."""

    learn_rate: float = 0.1
    beta: float = 1.0
    lambda_: float = 0.01
    loss: str = "SQUARE"
    penalty: str = "L2"
    num_dim: int = 10
    num_neg: int = 5
    using_bias_term: bool = True
    using_adagrad: bool = True
    batch_size: int = 1024  # instances per minibatch
    num_tries: int = 64  # WARP: candidate negatives per update (truncation)
    dense_mode: Optional[bool] = None  # True: the per-user slab step;
    # WARP's None keeps the instance epoch with the (U, I) rated mask
    num_shared_neg: int = 32  # BPR slab only
    fast_rng: Optional[bool] = None  # hash draws (hw_uniform) for WARP's
    # count uniforms and picks; None = off, as in cdae_tpu
    row_update: Optional[bool] = None  # touched-rows delta AdaGrad; None =
    # on above 131072 items
    epoch_chunk: Optional[int] = None  # accepted, no effect: it bounds a
    # TPU program's length, and the port dispatches step by step anyway
    use_pallas: Optional[bool] = None  # WARP: the violator kernel (B7) and
    # the AdaGrad kernel (B2); None = on a CUDA device
    warp_pool: Optional[int] = None  # WARP pool path (not ported)
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


def _adagrad_apply(params, grads, cfg: MFConfig):
    """One dense accumulate-then-apply AdaGrad step over every table of
    ``grads``, in place: one launch of the adagrad_update kernel (B2) when
    ``use_pallas`` is on."""
    dense_adagrad_steps(
        [(params[name], params[name + "_ag"], g) for name, g in grads.items()],
        cfg.learn_rate, cfg.beta, cfg.using_adagrad,
        use_kernel=bool(cfg.use_pallas))
    return params


def _use_mxu_gather(cfg: MFConfig) -> bool:
    """cdae_tpu's rule: only an explicit ``gather_mode="mxu"``."""
    return cfg.gather_mode == "mxu"


def _gather_factor_bias(factors, bias, idx, cfg: MFConfig):
    """(rows, bias) of the tables at ``idx``: plain row indexing, or with
    ``gather_mode="mxu"`` one B9 gather of ``[factors | bias]`` (the bias
    rides as an extra column)."""
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
                    rank_weight=None, update_bias=True):
    """Pair contributions of (u, i) against nn negatives j (B, nn), summed
    into full tables: B user rows, and one aggregation of the B positive
    and B*nn negative item rows (bias as an extra value column). The
    B*(1+nn) item rows come from one gather and the B user rows from
    another (B9's with ``gather_mode="mxu"``)."""
    B = u.shape[0]
    iv_rows, ib_rows = _gather_factor_bias(
        params["iv"], params["ib"], torch.cat([i, j.reshape(-1)]), cfg)
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
    acc = scatter_add_rows(
        torch.zeros((I, C), dtype=pos_vals.dtype, device=pos_vals.device),
        item_ids, torch.cat([pos_vals, neg_vals.reshape(-1, C)]), mode=sm,
        plan=row_plan(item_ids, I, sm))
    grads = {
        "uv": scatter_add_rows(torch.zeros_like(params["uv"]), u, d_uv_rows,
                               mode=sm,
                               plan=row_plan(u, params["uv"].shape[0], sm)),
        "iv": acc[:, :D].contiguous(),
    }
    if with_bias:
        grads["ib"] = acc[:, D].contiguous()
    return grads


def _pairwise_apply(params, u, i, j, w, cfg: MFConfig, loss: Loss,
                    rank_weight=None, update_bias=True):
    """One pairwise minibatch update, in place: full-table
    accumulate-then-apply AdaGrad, or with ``row_update`` the touched rows'
    delta AdaGrad (duplicates within a batch see a sequential
    accumulator)."""
    if not _use_row_update(cfg, params["iv"].shape[0]):
        return _adagrad_apply(
            params,
            _pairwise_grads(params, u, i, j, w, cfg, loss,
                            rank_weight=rank_weight, update_bias=update_bias),
            cfg,
        )
    d_uv_rows, pos_vals, neg_vals, with_bias = _pair_contribs(
        params["uv"][u], params["iv"][i], params["iv"][j],
        params["ib"][i], params["ib"][j], w, cfg, loss,
        rank_weight=rank_weight, update_bias=update_bias,
    )
    D = params["uv"].shape[1]
    C = pos_vals.shape[-1]
    lr, beta, ada = cfg.learn_rate, cfg.beta, cfg.using_adagrad
    acc_idx = torch.cat([i, j.reshape(-1)])
    acc_vals = torch.cat([pos_vals, neg_vals.reshape(-1, C)])
    u_live = torch.any(w > 0, dim=1)
    live = torch.cat([u_live, (w > 0).reshape(-1)])
    row_adagrad_delta(params["iv"], params["iv_ag"], acc_idx,
                      acc_vals[:, :D], live[:, None], lr, beta, ada)
    if with_bias:
        row_adagrad_delta(params["ib"], params["ib_ag"], acc_idx,
                          acc_vals[:, D], live, lr, beta, ada)
    row_adagrad_delta(params["uv"], params["uv_ag"], u, d_uv_rows,
                      u_live[:, None], lr, beta, ada)
    return params


def _mf_batch_scores(params, uids) -> torch.Tensor:
    return (params["ub"][uids][:, None] + params["ib"][None, :]
            + params["uv"][uids] @ params["iv"].t())


def _mf_data_loss(params, u, i, r, *, loss: Loss) -> torch.Tensor:
    pred = params["ub"][u] + params["ib"][i] + torch.sum(
        params["uv"][u] * params["iv"][i], dim=-1)
    return torch.sum(loss.evaluate(pred, r))


class _MFBase(RecsysModel):
    """Shared reset, instance epoch, losses and scoring of the MF family."""

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
        state = ModelState(params=params, padded=None, num_users=U,
                           num_items=I)
        state.aux["coo"] = (data.users, data.items, data.ratings)
        state.aux["lengths"] = data.csr().row_lengths().astype(np.int32)
        return state

    def _device_data(self, state: ModelState):
        """(users, items, ratings, per-user lengths) on the device, built
        once per state."""
        if "device_data" not in state.aux:
            users, items, ratings = state.aux["coo"]
            state.aux["device_data"] = (
                self._tensor(users, torch.long),
                self._tensor(items, torch.long),
                self._tensor(ratings, torch.float32),
                self._tensor(state.aux["lengths"], torch.int32),
            )
        return state.aux["device_data"]

    def _epoch_extras(self, state: ModelState) -> tuple:
        """Per-user device tables threaded into ``_step`` (row-gathered by
        user id each step). Default none."""
        return ()

    # ------------------------------------------------------------- train ----
    def train_one_iteration(self, state: ModelState, seed: int = 0,
                            perm=None, draws: Optional[Sequence[dict]] = None
                            ) -> ModelState:
        """One epoch: shuffle the instances (``perm``, or a permutation
        from the seed of (``seed``, ``state.step``)), pad to whole batches
        of ``batch_size`` with weight-0 instances, and run one ``_step`` per
        batch. ``draws[b]`` (optional) holds keyword draws for step b's
        ``_step``. Updates ``state.params`` in place."""
        if self.cfg.dense_mode:
            raise NotImplementedError(
                f"{self.name}'s per-user slab step (dense_mode=True) "
                + _LATER.format(entry="A8"))
        users, items, _, lengths = self._device_data(state)
        n = users.shape[0]
        bs = self.cfg.batch_size
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
        for b in range(num_batches):
            sel = sel_all[b * bs:(b + 1) * bs]
            u = users[sel]
            keys = (step_seed(seed, state.step, b, 1),
                    step_seed(seed, state.step, b, 2))
            self._step(
                state.params, u, items[sel], w_all[b * bs:(b + 1) * bs],
                lengths[u], keys,
                *(e[u] for e in extras), cfg=self.cfg, loss=self.loss,
                **(draws[b] if draws is not None else {}),
            )
        state.step += 1
        return state

    # -------------------------------------------------------------- loss ----
    def data_loss(self, state: ModelState, sample_size: int = 0) -> float:
        """The loss over every training instance (``sample_size`` is
        accepted and ignored, as in cdae_tpu)."""
        users, items, ratings, _ = self._device_data(state)
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


class WARP(_MFBase):
    """Weighted approximate-rank pairwise (ref warp.hpp). Default HINGE
    loss, beta=0, lambda=0.1 (WARPConfig warp.hpp:12-23).

    Only the dense path trains here: the instance epoch with the (U, I)
    int8 rated mask (dense_mode=None and U*I <= 1.5e9). The slab
    (dense_mode=True), the pool path (warp_pool) and the scan path (no
    mask) raise (ROADMAP A8)."""

    name = "WARP"

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
            use_dense = U * I <= 1_500_000_000
        if not use_dense:
            return ()
        if "rated_mask" not in state.aux:
            users, items, _ = state.aux["coo"]
            R = torch.zeros((U, I), dtype=torch.int8, device=self.device)
            R[self._tensor(users, torch.long),
              self._tensor(items, torch.long)] = 1
            state.aux["rated_mask"] = R
        return (state.aux["rated_mask"],)

    @staticmethod
    def _step(params, u, i, w, lengths, keys, *extras, cfg: MFConfig,
              loss: Loss, **draws):
        """One minibatch: the dense path when the rated mask is threaded
        in; the pool and scan paths are not ported."""
        if extras and not cfg.warp_pool:
            return WARP._dense_path(params, u, i, w, lengths, keys,
                                    extras[0], cfg=cfg, loss=loss, **draws)
        if cfg.warp_pool:
            raise NotImplementedError(
                "WARP's pool path (warp_pool) " + _LATER.format(entry="A8"))
        raise NotImplementedError(
            "WARP's scan path (no (U, I) rated mask: dense_mode=False or "
            "U*I > 1.5e9) " + _LATER.format(entry="A8"))

    @staticmethod
    def _dense_path(params, u, i, w, lengths, keys, mask_rows, *,
                    cfg: MFConfig, loss: Loss, sel_seed: Optional[int] = None,
                    u1: Optional[torch.Tensor] = None,
                    v: Optional[torch.Tensor] = None):
        """One WARP step from the full score rows. ``keys`` = (k1, k2), the
        step seeds of the count uniforms and of the picks. Injected draws
        replace them: ``sel_seed`` (B7's int32 seed, default k2), ``u1``
        ((B, nn) uniforms in [1e-7, 1), default from k1) and ``v`` ((B, nn)
        ranks in [0, max(nviol, 1)) of the picks on the cumsum route,
        default from k2)."""
        I = params["iv"].shape[0]
        B = u.shape[0]
        nn = max(cfg.num_neg, 1)
        T = max(cfg.num_tries, 1)
        dev = params["iv"].device
        k1, k2 = keys
        uv_u = params["uv"][u]
        use_kernel = bool(cfg.use_pallas)
        if use_kernel:
            # B7: violator count + nn uniform picks, no (B, I) array
            yui = params["ib"][i] + torch.sum(uv_u * params["iv"][i], dim=-1)
            nviol, j = warp_violator_select(
                k2 if sel_seed is None else sel_seed, uv_u, params["iv"],
                params["ib"], yui - 1.0, mask_rows, nn,
            )
        else:
            scores = uv_u @ params["iv"].t() + params["ib"][None, :]
            yui = scores.gather(1, i[:, None])[:, 0]
            viol = (scores > (yui[:, None] - 1.0)) & (mask_rows == 0)
            nviol = viol.sum(dim=1, dtype=torch.int32)
        free = torch.clamp(I - lengths, min=1)
        p = nviol.to(torch.float32) / free.to(torch.float32)
        # cnt ~ Geometric(p) truncated at T: the rejection loop's try count
        if u1 is None:
            u1 = _count_uniforms(k1, (B, nn), cfg, dev)
        log1mp = torch.log1p(-torch.clamp(p, 0.0, 1.0 - 1e-7))[:, None]
        cnt_f = 1.0 + torch.floor(torch.log(u1)
                                  / torch.clamp(log1mp, max=-1e-12))
        # saturate before the cast: p = 0 gives counts past int32
        cnt = torch.clamp(cnt_f, max=float(T + 1)).to(torch.int32)
        found = (nviol[:, None] > 0) & (cnt <= T)
        cnt = torch.clamp(cnt, 1, T)
        if not use_kernel:
            # the (v+1)-th violator: first column whose running count > v
            if v is None:
                v = _pick_ranks(k2, (B, nn), torch.clamp(nviol, min=1)[:, None],
                                cfg, dev)
            cum = torch.cumsum(viol, dim=1, dtype=torch.int32)
            j = torch.searchsorted(cum, v.to(cum.dtype).contiguous(),
                                   right=True)
            j = torch.clamp(j, 0, I - 1)
        items_left = torch.clamp(I - lengths, min=1)
        rw = _warp_harmonic(I, dev)[
            torch.clamp(items_left[:, None] // cnt, 0, I - 1).long()]
        pair_w = w[:, None] * found
        return _pairwise_apply(
            params, u, i, j.long(), pair_w, cfg, loss, rank_weight=rw,
            update_bias=False,  # ref warp.hpp:90-117 bias updates commented out
        )


def _count_uniforms(seed: int, shape, cfg: MFConfig, device) -> torch.Tensor:
    """(B, nn) uniforms in [1e-7, 1) of the count draw: hw_uniform with
    ``fast_rng`` (its kernel when ``use_pallas`` is on), else a generator
    seeded with ``seed``."""
    if cfg.fast_rng:
        draw = hw_uniform if cfg.use_pallas else hw_uniform_plain
        return torch.clamp(draw(seed, tuple(shape), device=device), min=1e-7)
    gen = torch.Generator(device=device).manual_seed(seed & _MASK32)
    u = torch.rand(shape, generator=gen, device=device)
    return 1e-7 + (1.0 - 1e-7) * u


def _pick_ranks(seed: int, shape, maxval: torch.Tensor, cfg: MFConfig,
                device) -> torch.Tensor:
    """int (B, nn) uniform in [0, maxval) for the cumsum route's picks:
    ``hw_randint`` with ``fast_rng`` (cdae_tpu's salt), else a generator
    seeded with ``seed``."""
    if cfg.fast_rng:
        return hw_randint(seed, shape, maxval, salt=0x5D1F, device=device,
                          use_kernel=bool(cfg.use_pallas))
    gen = torch.Generator(device=device).manual_seed(seed & _MASK32)
    u = torch.rand(shape, generator=gen, dtype=torch.float64, device=device)
    return torch.minimum((u * maxval).to(torch.int64), maxval - 1)


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

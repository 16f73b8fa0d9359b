"""Feature-group models on PyTorch: LinearModel, FactorModel, NegMF (port
of cdae_tpu/models/linear.py).

They work in the GLOBAL feature-index space of data/instances.py's
GroupedInstances (the user, item, ... groups laid end to end):

  LinearModel -- s(x) = mean + sum_f w_f x_f; per-feature AdaGrad whose
                 accumulators start at ZERO (g / sqrt(acc) after acc +=
                 g^2, so a first touch steps by sign(g) * lr)
  FactorModel -- order-2 factorization machine whose pairwise terms only
                 span slots of DIFFERENT groups:
                 s(x) = mean + sum_f w_f x_f
                        + sum_{f < f', g(f) != g(f')} x_f x_f' v_f . v_f'
  NegMF       -- FactorModel over (user, item) instances plus num_neg
                 sampled negatives per positive, labelled -1 for LOG and
                 HINGE, else 0

The cross-group term uses the O(F * D) identity
  sum_{f != f'} (v_f x_f) . (v_f' x_f') = |sum_f v_f x_f|^2 - sum_f |v_f x_f|^2
minus each group's own pairs. A minibatch step computes every instance's
contribution (per-touch lambda * param, masked by (x != 0) * weight) from
the tables as they were before the step, sums them into full tables and
applies one zero-init AdaGrad step (plain torch elementwise ops, as
cdae_tpu computes it outside any Pallas kernel).

Kernels: every row sum goes through ops/scatter.py ``scatter_add_rows`` in
the default mode, which on a CUDA device runs kernel B8 (one plan and one
reduce of the step's B * F ids over ``[contrib_w | contrib_V]``), so a run
on the card is reproducible bit for bit; on the CPU it is one index_add.
NegMF's dense slab sums its user rows the same way and writes its item
block from column sums.

Random draws. cdae_tpu's threefry streams cannot be reproduced in torch.
Each epoch's permutation comes from a generator seeded by (solver seed,
``state.step``) and step b's draws from ``step_seed(seed, state.step, b,
1)``, so a resumed run replays the unbroken run's draws. Every draw can be
injected, so tests feed the very draws cdae_tpu makes: the permutation
(``perm``), NegMF's per-step complement uniforms (``draws[b]["u"]``, handed
to ``sample_unrated``) and the dense slab's (B, I) uniforms
(``draws[b]["u01"]``).

Differences from cdae_tpu: the tables are replaced by new tensors a step,
not donated buffers; NegMF's sparse epoch runs step by step from Python
(cdae_tpu runs it as one ``lax.scan``); the instances move to the device
once a state and each batch is indexed there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cdae_tpu_torch.data.instances import GroupedInstances
from cdae_tpu_torch.models.base import ModelState, RecsysModel, resolve_device
from cdae_tpu_torch.ops.losses import Loss
from cdae_tpu_torch.ops.penalties import Penalty
from cdae_tpu_torch.ops.sampling import sample_unrated
from cdae_tpu_torch.ops.scatter import scatter_add_rows
from cdae_tpu_torch.utils.random import step_seed

_MASK32 = 0xFFFFFFFF
# ops/scatter.py's mode for every row sum: "auto" runs B8 on a CUDA device
# and index_add on the CPU ("pallas" runs B8's plain version there)
_SCATTER_MODE = "auto"


@dataclasses.dataclass(frozen=True)
class LinearModelConfig:
    """Every field of cdae_tpu's LinearModelConfig."""

    lambda_: float = 0.001
    loss: str = "SQUARE"
    penalty: str = "L2"
    using_global_mean: bool = True
    using_adagrad: bool = True
    learn_rate: float = 0.1
    batch_size: int = 4096
    dtype: Any = torch.float32


@dataclasses.dataclass(frozen=True)
class FactorModelConfig:
    """Every field of cdae_tpu's FactorModelConfig."""

    lambda_: float = 0.01
    loss: str = "SQUARE"
    penalty: str = "L2"
    num_dim: int = 5
    using_bias_term: bool = True
    using_factor_term: bool = True
    using_global_mean: bool = True
    using_adagrad: bool = True
    learn_rate: float = 0.1
    num_neg: int = 5  # NegMF only
    batch_size: int = 4096
    dense_mode: Optional[bool] = None  # NegMF only: True opts into the
    # full-catalog (B, I) slab step; None and False keep the instance epoch
    dtype: Any = torch.float32


def _zero_init_adagrad(p, a, g, lr, use: bool):
    """AdaGrad with accumulators that start at zero: accumulate, then
    divide by sqrt(acc); coordinates with acc == 0 (never touched) do not
    move. With ``use`` off, plain SGD. Returns the new (p, a)."""
    if not use:
        return p - lr * g, a
    a2 = a + g * g
    step = torch.where(a2 > 0, g / torch.sqrt(torch.clamp(a2, min=1e-30)),
                       0.0)
    return p - lr * step, a2


def _row_sums(num_rows: int, idx: torch.Tensor, vals: torch.Tensor
              ) -> torch.Tensor:
    """(num_rows, C) or (num_rows,) sums of ``vals`` rows at ``idx``: one
    B8 plan and reduce on a CUDA device, one index_add on the CPU."""
    base = torch.zeros((num_rows,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                       device=vals.device)
    return scatter_add_rows(base, idx, vals, mode=_SCATTER_MODE)


def _uniform_table(gen: torch.Generator, shape, dt, device) -> torch.Tensor:
    """U(-0.01, 0.01) from ``gen`` (cdae_tpu's DMatrix::Random() * 0.01)."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return (u * 0.02 - 0.01).to(dt)


def _instance_batches(n: int, bs: int, perm: torch.Tensor):
    """(b, sel, w) of each batch b of an epoch over ``n`` instances in
    ``perm`` order; the last batch is padded with index 0 at weight 0."""
    num_batches = max(-(-n // bs), 1)
    total = num_batches * bs
    sel_all = torch.cat([perm, perm.new_zeros(total - n)])
    w_all = (torch.arange(total, device=perm.device) < n).to(torch.float32)
    for b in range(num_batches):
        yield b, sel_all[b * bs:(b + 1) * bs], w_all[b * bs:(b + 1) * bs]


class LinearModel(RecsysModel):
    name = "LinearModel"
    config_cls = LinearModelConfig

    def __init__(self, config=None, device="cuda", **kw):
        self.device = resolve_device(device)
        self.cfg = config if config is not None else self.config_cls(**kw)
        self.loss = Loss.create(self.cfg.loss)
        self.penalty = Penalty.create(self.cfg.penalty)
        self._lr = self.cfg.learn_rate

    def set_learn_rate(self, lr: float) -> None:
        self._lr = float(lr)

    @staticmethod
    def _instances(data) -> GroupedInstances:
        if isinstance(data, GroupedInstances):
            return data
        return GroupedInstances.from_interactions(data)

    def _init_params(self, gen, gi: GroupedInstances) -> Dict[str, Any]:
        T = gi.total_dim
        return {
            "w": _uniform_table(gen, (T,), self.cfg.dtype, self.device),
            "w_ag": torch.zeros((T,), dtype=self.cfg.dtype,
                                device=self.device),
        }

    def reset(self, data, seed: int = 0) -> ModelState:
        gi = self._instances(data)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        state = ModelState(
            params=self._init_params(gen, gi), padded=None,
            num_users=gi.group_dims[0] if gi.group_dims else 0,
            num_items=gi.group_dims[1] if len(gi.group_dims) > 1 else 0,
        )
        mean = float(np.mean(gi.labels)) if len(gi) else 0.0
        state.aux["instances"] = gi
        state.aux["global_mean"] = mean if self.cfg.using_global_mean else 0.0
        return state

    def _device_instances(self, state: ModelState):
        """(idx (N, F) long, vals * mask (N, F), labels (N,)) on the
        device, built once per state."""
        if "device_instances" not in state.aux:
            gi: GroupedInstances = state.aux["instances"]
            state.aux["device_instances"] = (
                self._tensor(gi.idx, torch.long),
                self._tensor(gi.vals * gi.mask, self.cfg.dtype),
                self._tensor(gi.labels, self.cfg.dtype),
            )
        return state.aux["device_instances"]

    def _epoch_perm(self, n: int, seed: int, step: int, perm) -> torch.Tensor:
        """The epoch's instance order: ``perm`` when given, else a
        permutation from the seed of (``seed``, ``step``)."""
        if perm is None:
            gen = torch.Generator().manual_seed(
                step_seed(seed, step, -1, 0) & _MASK32)
            perm = torch.randperm(n, generator=gen)
        perm = self._tensor(perm, torch.long)
        if tuple(perm.shape) != (n,):
            raise ValueError(f"perm has shape {tuple(perm.shape)}, expected "
                             f"({n},)")
        return perm

    def _step(self, params, idx, vals, labels, w, mean, group_of):
        return _linear_step(params, idx, vals, labels, w, mean, self._lr,
                            cfg=self.cfg, loss=self.loss)

    def train_one_iteration(self, state: ModelState, seed: int = 0,
                            perm=None) -> ModelState:
        """One epoch, tables replaced in ``state.params``: the instances in
        ``perm`` order (or a permutation from the seed of (``seed``,
        ``state.step``)), batch_size a step, the last batch padded with
        instance 0 at weight 0."""
        idx, vals, labels = self._device_instances(state)
        perm = self._epoch_perm(idx.shape[0], seed, state.step, perm)
        mean = state.aux["global_mean"]
        group_of = tuple(state.aux["instances"].group_of)
        for _, sel, w in _instance_batches(idx.shape[0], self.cfg.batch_size,
                                           perm):
            state.params = self._step(state.params, idx[sel], vals[sel],
                                      labels[sel], w, mean, group_of)
        state.step += 1
        return state

    def data_loss(self, state: ModelState, sample_size: int = 0) -> float:
        """The loss over the first ``sample_size`` instances (0: all)."""
        gi: GroupedInstances = state.aux["instances"]
        if sample_size > 0:
            gi = gi.head(sample_size)
        preds = self._predict_instances(state, gi)
        labels = self._tensor(gi.labels, preds.dtype)
        return float(torch.sum(self.loss.evaluate(preds, labels)))

    def penalty_loss(self, state: ModelState) -> float:
        return float(0.5 * self.cfg.lambda_
                     * self.penalty.evaluate(state.params["w"]))

    def _predict_instances(self, state: ModelState, gi: GroupedInstances):
        vals = self._tensor(gi.vals * gi.mask, self.cfg.dtype)
        idx = self._tensor(gi.idx, torch.long)
        return state.aux["global_mean"] + torch.sum(
            state.params["w"][idx] * vals, dim=-1)

    def predict(self, state: ModelState, users, items) -> torch.Tensor:
        """mean + w[u] + w[U + i] (group 0 the user, group 1 the item)."""
        i_off = state.aux["instances"].group_dims[0]
        w = state.params["w"]
        u = self._tensor(users, torch.long)
        i = self._tensor(items, torch.long) + i_off
        return state.aux["global_mean"] + w[u] + w[i]


def _linear_step(params, idx, vals, labels, w, mean, lr, *, cfg, loss):
    """One minibatch of LinearModel: per slot g * x + lambda * w[idx] *
    (x != 0) * weight, summed into the (T,) table, then one zero-init
    AdaGrad step."""
    w_idx = params["w"][idx]
    pred = mean + torch.sum(w_idx * vals, dim=-1)
    g = loss.gradient(pred, labels) * w
    contrib = g[:, None] * vals + cfg.lambda_ * w_idx * (
        (vals != 0).to(vals.dtype) * w[:, None])
    grad = _row_sums(params["w"].shape[0], idx.reshape(-1),
                     contrib.reshape(-1))
    out = dict(params)
    out["w"], out["w_ag"] = _zero_init_adagrad(
        params["w"], params["w_ag"], grad, lr, cfg.using_adagrad)
    return out


# ----------------------------------------------------------- FactorModel ----

def _group_slots(group_of: Sequence[int]) -> Dict[int, list]:
    """group id -> the slots of that group, in slot order."""
    out: Dict[int, list] = {}
    for f, gid in enumerate(group_of):
        out.setdefault(gid, []).append(f)
    return dict(sorted(out.items()))


def _fm_forward(params, idx, vals, mean, group_of: Tuple[int, ...]):
    """The factorization machine's score with cross-group pairs only."""
    w_terms = torch.sum(params["w"][idx] * vals, dim=-1)
    Vx = params["V"][idx] * vals[..., None]  # (B, F, D)
    total = torch.sum(Vx, dim=1)  # (B, D)
    all_pairs = torch.sum(total * total, -1) - torch.sum(Vx * Vx, (-2, -1))
    same = torch.zeros_like(all_pairs)
    for sel in _group_slots(group_of).values():
        if len(sel) < 2:
            continue
        sub = Vx[:, sel, :]
        s = torch.sum(sub, dim=1)
        same = same + torch.sum(s * s, -1) - torch.sum(sub * sub, (-2, -1))
    return mean + w_terms + 0.5 * (all_pairs - same)


def _fm_step(params, idx, vals, labels, w, mean, lr, *, cfg, loss,
             group_of: Tuple[int, ...], coll=None):
    """One minibatch of FactorModel: per-instance contributions with
    per-touch lambda, all from the tables as they were before the step
    (dpred/dv_f = x_f * sum of the other groups' v x), summed by ONE row
    aggregation of ``[contrib_w | contrib_V]`` over the B * F ids, then one
    zero-init AdaGrad step per table. ``coll`` (a data-parallel sharded
    step, the tables replicated): the instances are the rank's, and the
    row sums are completed over 'data' before the AdaGrad step."""
    pred = _fm_forward(params, idx, vals, mean, group_of)
    g = loss.gradient(pred, labels) * w  # (B,)
    touched = (vals != 0).to(vals.dtype) * w[:, None]  # (B, F)
    B, F = idx.shape
    cols = []
    if cfg.using_bias_term:
        cols.append((g[:, None] * vals
                     + cfg.lambda_ * params["w"][idx] * touched)[..., None])
    if cfg.using_factor_term:
        V_idx = params["V"][idx]
        Vx = V_idx * vals[..., None]  # (B, F, D)
        total = torch.sum(Vx, dim=1)  # (B, D)
        per_group = {gid: torch.sum(Vx[:, sel, :], dim=1)
                     for gid, sel in _group_slots(group_of).items()}
        other = torch.stack([total - per_group[group_of[f]]
                             for f in range(F)], dim=1)  # (B, F, D)
        cols.append(g[:, None, None] * vals[..., None] * other
                    + cfg.lambda_ * V_idx * touched[..., None])
    out = dict(params)
    if not cols:
        return out
    contrib = torch.cat(cols, dim=-1)
    acc = _row_sums(params["w"].shape[0], idx.reshape(-1),
                    contrib.reshape(B * F, contrib.shape[-1]))
    if coll is not None:
        acc = coll.data_sum(acc)
    if cfg.using_bias_term:
        out["w"], out["w_ag"] = _zero_init_adagrad(
            params["w"], params["w_ag"], acc[:, 0], lr, cfg.using_adagrad)
    if cfg.using_factor_term:
        out["V"], out["V_ag"] = _zero_init_adagrad(
            params["V"], params["V_ag"], acc[:, int(cfg.using_bias_term):],
            lr, cfg.using_adagrad)
    return out


class FactorModel(LinearModel):
    name = "FactorModel"
    config_cls = FactorModelConfig

    def _init_params(self, gen, gi: GroupedInstances) -> Dict[str, Any]:
        T, D, dt = gi.total_dim, self.cfg.num_dim, self.cfg.dtype
        params = super()._init_params(gen, gi)  # w first from ``gen``
        params["V"] = _uniform_table(gen, (T, D), dt, self.device)
        params["V_ag"] = torch.zeros((T, D), dtype=dt, device=self.device)
        return params

    def _step(self, params, idx, vals, labels, w, mean, group_of):
        return _fm_step(params, idx, vals, labels, w, mean, self._lr,
                        cfg=self.cfg, loss=self.loss, group_of=group_of)

    def penalty_loss(self, state: ModelState) -> float:
        p = state.params
        return float(0.5 * self.cfg.lambda_
                     * (self.penalty.evaluate(p["w"])
                        + self.penalty.evaluate(p["V"])))

    def _predict_instances(self, state: ModelState, gi: GroupedInstances):
        return _fm_forward(
            state.params, self._tensor(gi.idx, torch.long),
            self._tensor(gi.vals * gi.mask, self.cfg.dtype),
            state.aux["global_mean"], tuple(gi.group_of))

    def predict(self, state: ModelState, users, items) -> torch.Tensor:
        gi: GroupedInstances = state.aux["instances"]
        i_off = gi.group_dims[0]
        idx = torch.stack([self._tensor(users, torch.long),
                           self._tensor(items, torch.long) + i_off], dim=1)
        vals = torch.ones(idx.shape, dtype=self.cfg.dtype, device=self.device)
        return _fm_forward(state.params, idx, vals, state.aux["global_mean"],
                           tuple(gi.group_of))

    def batch_scores(self, state: ModelState, uids, rated_items, rated_mask
                     ) -> torch.Tensor:
        """(B, I) catalog scores for TOPN: mean + w_u + w_i + v_u . v_i (the
        two-group recsys case of the forward)."""
        i_off = state.aux["instances"].group_dims[0]
        p = state.params
        u = self._tensor(uids, torch.long)
        I = state.num_items
        w_i = p["w"][i_off:i_off + I]
        V_i = p["V"][i_off:i_off + I]
        return (state.aux["global_mean"] + p["w"][u][:, None]
                + w_i[None, :] + p["V"][u] @ V_i.t())


def _negmf_dense_step(params, R, uids, weight, mean, lr, *, cfg, loss,
                      i_off: int, seed: int = 0,
                      u01: Optional[torch.Tensor] = None):
    """NegMF's full-catalog slab step. In the two-group case the score is
    mean + w_u + w_i + v_u . v_i, so the whole (B, I) slab is one GEMM and
    the item side's sums are column sums. Negatives are Bernoulli over the
    complement with p = clip(num_neg * |R_u| / (I - |R_u|), 0, 1), from
    ``u01`` (B, I) uniforms in [0, 1) (injected, or from a generator seeded
    with ``seed``). Per-touch lambda as in ``_fm_step``: each touch
    regularizes both its features. The user rows sum through one B8 plan
    and reduce over ``uids`` (wrap rows repeat uids at weight 0 and add
    exact zeros); the item block is written from the column sums."""
    dt = params["V"].dtype
    w_user = weight.to(dt)
    rows = R[uids].to(dt) * w_user[:, None]  # (B, I)
    I = rows.shape[1]
    lengths = torch.sum(rows, dim=1)
    p_neg = torch.clamp(
        cfg.num_neg * lengths / torch.clamp(I - lengths, min=1.0), 0.0, 1.0)
    if u01 is None:
        gen = torch.Generator(device=rows.device).manual_seed(
            int(seed) & _MASK32)
        u01 = torch.rand(rows.shape, generator=gen, device=rows.device)
    u01 = torch.as_tensor(u01, device=rows.device)
    neg_sel = ((1.0 - rows) * (u01 < p_neg[:, None]).to(dt)
               * w_user[:, None])
    touch = rows + neg_sel
    neg_label = -1.0 if loss.name in ("LOG", "HINGE") else 0.0
    labels = torch.where(rows > 0, loss.positive_label, neg_label).to(dt)

    Vu = params["V"][uids]  # (B, D)
    Vi = params["V"][i_off:i_off + I]  # (I, D)
    wu = params["w"][uids]
    wi = params["w"][i_off:i_off + I]
    pred = mean + wu[:, None] + wi[None, :]
    if cfg.using_factor_term:
        pred = pred + Vu @ Vi.t()
    g = loss.gradient(pred, labels) * touch  # (B, I)
    lam = cfg.lambda_
    touch_u = torch.sum(touch, dim=1)  # (B,)
    touch_i = torch.sum(touch, dim=0)  # (I,)
    cols = []
    if cfg.using_bias_term:
        cols.append((torch.sum(g, dim=1) + lam * wu * touch_u)[:, None])
    if cfg.using_factor_term:
        cols.append(g @ Vi + lam * Vu * touch_u[:, None])
    out = dict(params)
    if not cols:
        return out
    user_rows = _row_sums(params["w"].shape[0], uids, torch.cat(cols, dim=1))
    if cfg.using_bias_term:
        grad_w = user_rows[:, 0].clone()
        grad_w[i_off:i_off + I] += torch.sum(g, dim=0) + lam * wi * touch_i
        out["w"], out["w_ag"] = _zero_init_adagrad(
            params["w"], params["w_ag"], grad_w, lr, cfg.using_adagrad)
    if cfg.using_factor_term:
        grad_V = user_rows[:, int(cfg.using_bias_term):].clone()
        grad_V[i_off:i_off + I] += g.t() @ Vu + lam * Vi * touch_i[:, None]
        out["V"], out["V_ag"] = _zero_init_adagrad(
            params["V"], params["V_ag"], grad_V, lr, cfg.using_adagrad)
    return out


def _negmf_sparse_step(params, users, items, w, rated, lengths, mean, lr, *,
                       cfg, loss, i_off: int, num_items: int, seed: int = 0,
                       u: Optional[torch.Tensor] = None, coll=None):
    """One NegMF minibatch of B (user, item) positives: num_neg exact
    complement negatives per positive by ``sample_unrated`` over the
    users' padded rated rows (``u`` (B, num_neg) injects its uniforms,
    else the generator seeded with ``seed``); the sentinel id I of an empty
    complement is zero-weighted and clipped. Then one ``_fm_step`` over the
    B * (num_neg + 1) instances, groups (user, item). ``coll`` (a
    data-parallel sharded step): the whole batch's negatives are drawn,
    then the rank's rows of the batch take the step."""
    B = users.shape[0]
    I = num_items
    nn = max(cfg.num_neg, 0)
    dev = users.device
    step_kw = dict(cfg=cfg, loss=loss, group_of=(0, 1), coll=coll)
    if nn == 0:
        if coll is not None:
            sl = coll.rows(B)
            users, items, w = users[sl], items[sl], w[sl]
            B = users.shape[0]
        idx = torch.stack([users, items + i_off], dim=1)
        vals = torch.ones(idx.shape, dtype=cfg.dtype, device=dev)
        labels = torch.full((B,), loss.positive_label, dtype=cfg.dtype,
                            device=dev)
        return _fm_step(params, idx, vals, labels, w, mean, lr, **step_kw)
    neg = sample_unrated(seed, rated, lengths, I, nn, u=u)  # (B, nn)
    if coll is not None:
        sl = coll.rows(B)
        users, items, w, neg = users[sl], items[sl], w[sl], neg[sl]
        B = users.shape[0]
    neg_label = -1.0 if loss.name in ("LOG", "HINGE") else 0.0
    all_u = users[:, None].expand(B, nn + 1)
    all_i = torch.cat([items[:, None], torch.clamp(neg, 0, I - 1)], dim=1)
    labels = torch.cat([
        torch.full((B, 1), loss.positive_label, dtype=cfg.dtype, device=dev),
        torch.full((B, nn), neg_label, dtype=cfg.dtype, device=dev)], dim=1)
    idx = torch.stack([all_u.reshape(-1), all_i.reshape(-1) + i_off], dim=1)
    vals = torch.ones(idx.shape, dtype=cfg.dtype, device=dev)
    ww = (w[:, None] * torch.cat(
        [torch.ones((B, 1), dtype=w.dtype, device=dev),
         (neg < I).to(w.dtype)], dim=1)).reshape(-1)
    return _fm_step(params, idx, vals, labels.reshape(-1), ww, mean, lr,
                    **step_kw)


class NegMF(FactorModel):
    """FactorModel plus per-positive negative sampling over (user, item)
    data; negatives carry label -1 for LOG and HINGE, else 0. The default
    loss is LOG only when neither a config nor ``loss`` is given."""

    name = "NegMF"

    def __init__(self, config: Optional[FactorModelConfig] = None,
                 device="cuda", **kw):
        if config is None and "loss" not in kw:
            kw["loss"] = "LOG"
        super().__init__(config, device=device, **kw)

    def reset(self, data, seed: int = 0) -> ModelState:
        if isinstance(data, GroupedInstances):
            raise ValueError("NegMF needs recsys Interactions data")
        state = super().reset(data, seed)
        state.padded = data.padded()
        state.aux["coo"] = (data.users, data.items)
        if self.cfg.dense_mode:
            R = torch.zeros((state.num_users, state.num_items),
                            dtype=torch.int8, device=self.device)
            R[self._tensor(data.users, torch.long),
              self._tensor(data.items, torch.long)] = 1
            state.aux["dense_R"] = R
        return state

    def _device_data(self, state: ModelState):
        """(users, items, padded rated rows (U, L) int32, lengths) on the
        device, built once per state."""
        if "device_data" not in state.aux:
            users, items = state.aux["coo"]
            pb = state.padded
            state.aux["device_data"] = (
                self._tensor(users, torch.long),
                self._tensor(items, torch.long),
                self._tensor(pb.items, torch.int32),
                self._tensor(pb.lengths, torch.int32),
            )
        return state.aux["device_data"]

    def train_one_iteration(self, state: ModelState, seed: int = 0,
                            perm=None, draws: Optional[Sequence[dict]] = None,
                            coll=None) -> ModelState:
        """One epoch, tables replaced in ``state.params``. With ``dense_R``
        resident: the user slabs in fixed order, slab j's uniforms from
        ``draws[j]["u01"]`` or the step seed. Else the instance epoch: the
        (user, item) instances in ``perm`` order (or a permutation from the
        seed of (``seed``, ``state.step``)), padded to whole batches at
        weight 0; step b draws each instance's num_neg negatives by
        ``sample_unrated`` from ``draws[b]["u"]`` (B, num_neg) or the step
        seed, then takes one ``_fm_step`` over the B * (num_neg + 1)
        instances. ``coll`` (parallel/trainer.py ShardedNegMF, the instance
        epoch): one rank's epoch, each step on its rows of the batch."""
        i_off = state.aux["instances"].group_dims[0]
        mean = state.aux["global_mean"]
        if "dense_R" in state.aux:
            R = state.aux["dense_R"]
            uid_mat, w_mat = self._dense_user_batches(state)
            for j in range(uid_mat.shape[0]):
                state.params = _negmf_dense_step(
                    state.params, R, uid_mat[j], w_mat[j], mean, self._lr,
                    cfg=self.cfg, loss=self.loss, i_off=i_off,
                    seed=step_seed(seed, state.step, j, 1),
                    **(draws[j] if draws is not None else {}))
            state.step += 1
            return state
        users, items, pad_items, lengths = self._device_data(state)
        perm = self._epoch_perm(users.shape[0], seed, state.step, perm)
        for b, sel, w in _instance_batches(users.shape[0],
                                           self.cfg.batch_size, perm):
            u = users[sel]
            state.params = _negmf_sparse_step(
                state.params, u, items[sel], w, pad_items[u], lengths[u],
                mean, self._lr, cfg=self.cfg, loss=self.loss, i_off=i_off,
                num_items=state.num_items,
                seed=step_seed(seed, state.step, b, 1),
                **({} if coll is None else {"coll": coll}),
                **(draws[b] if draws is not None else {}))
        state.step += 1
        return state

    def data_loss(self, state: ModelState, sample_size: int = 0) -> float:
        return 0.0  # as the reference (sample_size accepted, unused)

    def penalty_loss(self, state: ModelState) -> float:
        return 0.0

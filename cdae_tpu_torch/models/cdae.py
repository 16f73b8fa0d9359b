"""CDAE -- Collaborative Denoising Auto-Encoder (WSDM'16), on PyTorch.

Port of cdae_tpu/models/cdae.py: the configuration, parameter reset, dense
(full-catalog) training, the losses, the hidden encode and every way a batch
of users is scored or ranked. With ``use_pallas`` on (the default on a CUDA
device) training runs the hand-written kernels hw_uniform (the masks) and
adagrad_update (the W, b', b sweep, one launch a step), or with
``fused_step=True`` the fused step of ops/cdae_fused.py; scoring runs the
decode and fused top-k kernels.

Model math (as in cdae_tpu):
  h   = s * sum_{i in rated} W_i   (* U_u if linear_function)
  h  += b (+ W^u_u if user_factor)
  z   = sigmoid(h) | tanh(h) | h    with the reference's +-18 / +-9 clamps
  y_o = (V_o | W_o) . z + b'_o      (linear decoder)
Training corrupts the input (each rated item kept w.p. 1 - q, scaled by
1/(1 - q) if ``scaled``), draws Bernoulli negatives with expected count
num_neg*|O_u|, and applies AdaGrad per minibatch. Serving uses the
uncorrupted input with scale 1 (an empty input when corruption_ratio == 1).

Random draws. cdae_tpu's threefry and TPU hardware streams cannot be
reproduced in torch. Every train step takes a 32-bit step seed that is a
pure host function of (solver seed, ``state.step``, batch index, corruption
index) -- utils/random.py ``step_seed`` -- so a run resumed from a
checkpoint's step replays the same draws. With ``fast_rng`` (default on CUDA) the masks come from
``hw_uniform`` (a counter hash, the stream cdae_tpu's fused kernel uses off
the TPU); without it from a ``torch.Generator`` seeded with the step seed.
The step functions also take injected uniforms, so tests feed them the
very draws cdae_tpu makes.

Only dense mode (the int8 (U, I) ``dense_R``) trains here; the huge-catalog
sparse step is ROADMAP A7, a later slice.

Parameter init: U(-s, s) with s = 4 * sqrt(6 / (num_items + num_dim)),
AdaGrad accumulators at 1e-4. The draws come from a ``torch.Generator``,
so a fresh reset differs from cdae_tpu's; a checkpoint carries parameters
across (utils/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from cdae_tpu_torch.data.dataset import Interactions
from cdae_tpu_torch.models.base import (
    ModelState,
    RecsysModel,
    iter_user_batches,
    iter_user_batches_csr,
    resolve_device,
)
from cdae_tpu_torch.ops.cdae_fused import (
    cdae_dense_step_fused,
    cdae_dense_step_fused_plain,
)
from cdae_tpu_torch.ops.corruption import input_scale
from cdae_tpu_torch.ops.losses import Loss
from cdae_tpu_torch.ops.pallas_kernels import (
    decode_scores,
    fused_topk_scores,
    fused_topk_scores_csr,
    hw_uniform,
    hw_uniform_plain,
    streaming_topk_scores,
)
from cdae_tpu_torch.ops.penalties import Penalty
from cdae_tpu_torch.solver.optimizer import (
    ADAGRAD_INIT,
    dense_adagrad_step,
    dense_adagrad_steps,
    row_adagrad_delta,
)
from cdae_tpu_torch.utils.random import step_seed

_SPARSE_SLICE = (
    "CDAE training without dense_R (the huge-catalog sparse step, ROADMAP "
    "A7) is not ported to cdae_tpu_torch yet: it comes with a later slice. "
    "Dense mode trains: CDAEConfig(dense_mode=True), or the auto rule when "
    "the int8 (U, I) matrix fits"
)
_LOSS_STREAM = -1  # the seed stream of data_loss draws (not the solver's)
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class CDAEConfig:
    """Every field of cdae_tpu's CDAEConfig, so CLI flags and checkpoints
    carry over. The knobs of the sparse train step (cache_device_batches,
    neg_pool, row_update, packed_io) are kept and unused until it is
    ported (ROADMAP A7)."""

    lambda_: float = 0.01
    learn_rate: float = 0.1
    loss: str = "LOGISTIC"
    penalty: str = "L2"
    num_dim: int = 10
    using_adagrad: bool = True
    corruption_ratio: float = 0.5
    num_corruptions: int = 1
    asymmetric: bool = False
    user_factor: bool = True
    linear: bool = False
    num_neg: int = 5
    scaled: bool = True
    beta: float = 0.0
    linear_function: bool = False
    tanh: bool = False
    batch_size: int = 128
    bucket_by_length: bool = True
    use_pallas: Optional[bool] = None  # hand-written kernels; None = on CUDA
    compute_dtype: Any = None  # matmul operand dtype (sums stay f32); None =
    # dtype
    stream_batches: Optional[bool] = None  # None = auto when U*max_len > 2e8
    cache_device_batches: bool = True  # sparse training only
    fast_rng: Optional[bool] = None  # hash masks (hw_uniform) for the dense
    # step; None = on CUDA
    dense_mode: Optional[bool] = None  # int8 (U, I) dense_R; None = auto
    fused_step: Optional[bool] = None  # the fused step kernel (B4); None =
    # off, as in cdae_tpu
    neg_pool: Optional[int] = None  # sparse training only
    row_update: Optional[bool] = None  # sparse training only
    packed_io: Optional[bool] = None  # sparse training only (a TPU layout)
    dtype: Any = torch.float32


# batch_topk defers to the evaluator's (B, I) dense-scores pipeline below
# this many score cells; above it the blockwise paths take over (tests
# lower this to drive the huge-catalog modes at fixture scale)
_TOPK_DEFER_CELLS = 200_000_000


class CDAEState(ModelState):
    """CDAE parameters + data views; ``aux`` holds the CSR view and, in
    dense mode, the int8 (U, I) interaction matrix ``dense_R``."""


def _activation(h: torch.Tensor, linear: bool, tanh: bool) -> torch.Tensor:
    """Hidden activation with the reference's clamps."""
    if linear:
        return h
    if tanh:
        t = torch.tanh(h)
        return torch.where(h > 9.0, 1.0, torch.where(h < -9.0, -1.0, t))
    s = torch.sigmoid(h)
    return torch.where(h > 18.0, 1.0, torch.where(h < -18.0, 0.0, s))


class CDAE(RecsysModel):
    name = "CDAE"

    def __init__(self, config: Optional[CDAEConfig] = None,
                 device="cuda", **kw):
        self.device = resolve_device(device)
        self.cfg = config if config is not None else CDAEConfig(**kw)
        on_cuda = self.device.type == "cuda"
        if self.cfg.use_pallas is None:
            self.cfg = dataclasses.replace(self.cfg, use_pallas=on_cuda)
        if self.cfg.fast_rng is None:
            self.cfg = dataclasses.replace(self.cfg, fast_rng=on_cuda)
        self.loss = Loss.create(self.cfg.loss)
        self.penalty = Penalty.create(self.cfg.penalty)

    # ------------------------------------------------------------- reset ----
    def reset(self, data: Interactions, seed: int = 0) -> CDAEState:
        cfg = self.cfg
        U, I, D = data.num_users, data.num_items, cfg.num_dim
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        s = 4.0 * float(np.sqrt(6.0 / float(I + D)))
        dt, at = cfg.dtype, torch.float32

        def uniform(shape):
            u = torch.rand(shape, generator=gen, dtype=at, device=dev)
            return (u * (2.0 * s) - s).to(dt)

        def acc(shape):
            return torch.full(shape, ADAGRAD_INIT, dtype=at, device=dev)

        params: Dict[str, torch.Tensor] = {
            "W": uniform((I, D)),
            "W_ag": acc((I, D)),
            "b": torch.zeros((D,), dtype=dt, device=dev),
            "b_ag": acc((D,)),
            "b_prime": torch.zeros((I,), dtype=dt, device=dev),
            "b_prime_ag": acc((I,)),
        }
        if cfg.asymmetric:
            params["V"] = uniform((I, D))
            params["V_ag"] = acc((I, D))
        if cfg.user_factor:
            params["Wu"] = uniform((U, D))
            params["Wu_ag"] = acc((U, D))
        if cfg.linear_function:
            params["Uu"] = torch.ones((U, D), dtype=dt, device=dev)
            params["Uu_ag"] = acc((U, D))
        csr = data.csr()
        stream = cfg.stream_batches
        if stream is None:
            max_len = int(csr.row_lengths().max()) if len(csr.indices) else 1
            stream = U * max_len > 200_000_000  # full padding would blow RAM
        state = CDAEState(
            params=params,
            padded=None if stream else data.padded(),
            num_users=U,
            num_items=I,
        )
        state.aux["csr"] = csr
        dense = cfg.dense_mode
        if dense is None:
            # int8 dense_R (U*I bytes) and ~10 f32 (B, I) slabs per batch
            dense = (
                U * I <= 1_500_000_000
                and cfg.batch_size * I * 40 <= 4_000_000_000
            )
        if dense:
            R = torch.zeros((U, I), dtype=torch.int8, device=dev)
            R[self._tensor(data.users, torch.long),
              self._tensor(data.items, torch.long)] = 1
            state.aux["dense_R"] = R
        return state

    # ------------------------------------------------------------- train ----
    def _dense_batches(self, state: CDAEState):
        """Dense-mode batches: (k, B) uid and weight tensors on the device;
        the last batch wraps around to uid 0 with weight 0."""
        if "dense_batches" not in state.aux:
            U = state.num_users
            B = self.cfg.batch_size
            k = max(-(-U // B), 1)
            uids = np.arange(k * B, dtype=np.int64) % max(U, 1)
            weight = (np.arange(k * B) < U).astype(np.float32)
            state.aux["dense_batches"] = (
                self._tensor(uids.reshape(k, B)),
                self._tensor(weight.reshape(k, B)),
            )
        return state.aux["dense_batches"]

    def train_one_iteration(self, state: CDAEState, seed: int = 0
                            ) -> CDAEState:
        """One epoch over every user (see ``train_epochs``)."""
        return self.train_epochs(state, 1, seed)

    def train_epochs(self, state: CDAEState, num_epochs: int, seed: int = 0
                     ) -> CDAEState:
        """``num_epochs`` epochs of dense steps: every batch of users,
        ``num_corruptions`` times each, with step seeds from (``seed``,
        ``state.step``, batch, corruption). Updates ``state.params`` in
        place. Only dense mode trains (the sparse step is ROADMAP A7)."""
        if "dense_R" not in state.aux:
            raise NotImplementedError(_SPARSE_SLICE)
        R = state.aux["dense_R"]
        uid_mat, w_mat = self._dense_batches(state)
        for _ in range(num_epochs):
            for j in range(uid_mat.shape[0]):
                for c in range(self.cfg.num_corruptions):
                    _dense_train_step(
                        state.params, R, uid_mat[j], w_mat[j],
                        step_seed(seed, state.step, j, c),
                        cfg=self.cfg, loss=self.loss,
                    )
            state.step += 1
        return state

    # -------------------------------------------------------------- loss ----
    def data_loss(self, state: CDAEState, sample_size: int = 0,
                  uniforms=None) -> float:
        """Reconstruction loss over the positives under fresh corruption,
        summed over users. ``sample_size`` is accepted and ignored, as in
        cdae_tpu. ``uniforms[j][c]`` (optional) are the (B, I) corruption
        uniforms of batch j, corruption c; by default they are drawn from
        seeds of (``state.step``, batch, corruption)."""
        if "dense_R" not in state.aux:
            raise NotImplementedError(_SPARSE_SLICE)
        R = state.aux["dense_R"]
        uid_mat, w_mat = self._dense_batches(state)
        total = 0.0
        for j in range(uid_mat.shape[0]):
            total += float(_dense_data_loss(
                state.params, R, uid_mat[j], w_mat[j],
                step_seed(_LOSS_STREAM, state.step, j, 0),
                cfg=self.cfg, loss=self.loss,
                uniforms=None if uniforms is None else uniforms[j],
            ))
        return total

    def penalty_loss(self, state: CDAEState) -> float:
        """0.5*lambda*(|W| + |V| + |Wu| + |b| + |b'|) under the penalty's
        norm (Uu is exempt)."""
        p = state.params
        pen = self.penalty.evaluate
        total = pen(p["W"]) + pen(p["b"]) + pen(p["b_prime"])
        if "V" in p:
            total = total + pen(p["V"])
        if "Wu" in p:
            total = total + pen(p["Wu"])
        return float(0.5 * self.cfg.lambda_ * total)

    def _host_batches(self, state: CDAEState):
        cfg = self.cfg
        if state.padded is not None:
            return iter_user_batches(
                state.padded, cfg.batch_size,
                bucket_by_length=cfg.bucket_by_length,
            )
        return iter_user_batches_csr(
            state.aux["csr"], state.num_items, cfg.batch_size,
            bucket_by_length=cfg.bucket_by_length,
        )

    # ----------------------------------------------------------- scoring ----
    def batch_scores(self, state: CDAEState, uids, rated_items, rated_mask):
        """(B, I) full-catalog decode for the given users from their
        uncorrupted input; with ``dense_R`` resident the encode is a
        (B, I) x (I, D) matmul instead of a padded gather-sum."""
        uids = self._tensor(uids, torch.long)
        if "dense_R" in state.aux:
            return _dense_scores(state.params, state.aux["dense_R"], uids,
                                 cfg=self.cfg)
        return _batch_scores(
            state.params, uids, self._tensor(rated_items),
            self._tensor(rated_mask), cfg=self.cfg,
        )

    def batch_topk(self, state: CDAEState, uids, rated_items, rated_mask,
                   k: int = 10):
        """Top-k unrated ids (B, k) for huge catalogs, or None when
        B * num_items <= _TOPK_DEFER_CELLS (the evaluator then scores the
        full (B, I) slab). Modes: 'fused_dense' (kernel reads dense_R rows),
        'fused_csr' (kernel walks the sorted rated rows), 'streaming'
        (plain blockwise loop, when the kernels are off)."""
        B = len(uids)
        if B * state.num_items <= _TOPK_DEFER_CELLS:
            return None
        mode = ("fused_dense" if self.cfg.use_pallas and "dense_R" in state.aux
                else "fused_csr" if self.cfg.use_pallas
                else "streaming")
        return _batch_topk_impl(
            state.params,
            self._tensor(uids, torch.long),
            self._tensor(rated_items),
            self._tensor(rated_mask),
            state.aux.get("dense_R") if mode == "fused_dense" else None,
            cfg=self.cfg, mode=mode, k=k,
        )

    def user_representations(self, state: CDAEState) -> np.ndarray:
        """Hidden codes for all users, in uid order."""
        out = np.zeros((state.num_users, self.cfg.num_dim), dtype=np.float32)
        for batch in self._host_batches(state):
            z = _hidden(
                state.params,
                self._tensor(batch.uids, torch.long),
                self._tensor(batch.items),
                self._tensor(batch.mask),
                1.0,
                self.cfg,
            )
            real = batch.weight > 0
            out[batch.uids[real]] = z.cpu().numpy()[real]
        return out

    def _user_rows(self, state: CDAEState, users_np: np.ndarray):
        """(B, L) rated rows + mask for specific users (padded or CSR)."""
        if state.padded is not None:
            pb = state.padded
            return pb.items[users_np], pb.mask[users_np]
        csr = state.aux["csr"]
        lengths = np.diff(csr.indptr)[users_np].astype(np.int32)
        L = max(int(lengths.max()) if len(lengths) else 1, 1)
        items = np.full((len(users_np), L), state.num_items, np.int32)
        for row, u in enumerate(users_np):
            s, e = csr.indptr[u], csr.indptr[u + 1]
            items[row, : e - s] = csr.indices[s:e]
        mask = np.arange(L)[None, :] < lengths[:, None]
        return items, mask

    def predict(self, state: CDAEState, users, items):
        users_np = np.asarray(users)
        rated_items, rated_mask = self._user_rows(state, users_np)
        z = _hidden(
            state.params,
            self._tensor(users_np, torch.long),
            self._tensor(rated_items),
            self._tensor(rated_mask),
            1.0,
            self.cfg,
        )
        p = state.params
        dec = p["V"] if self.cfg.asymmetric else p["W"]
        items = self._tensor(items, torch.long)
        return (dec[items] * z).sum(dim=-1) + p["b_prime"][items]


# ============================================================ functions ====

def _cdt(cfg: CDAEConfig):
    return cfg.compute_dtype or cfg.dtype


def _operand(x: torch.Tensor, cfg: CDAEConfig) -> torch.Tensor:
    """``x`` rounded to the compute dtype and held in f32: a matmul of two
    such operands has compute-dtype inputs and f32 sums, as cdae_tpu's
    ``preferred_element_type=float32`` einsums do."""
    return x.to(_cdt(cfg)).to(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, cfg: CDAEConfig) -> torch.Tensor:
    """a @ b with operands in the compute dtype and f32 accumulation (a
    bf16 @ bf16 in torch would round the sums to bf16 too)."""
    return _operand(a, cfg) @ _operand(b, cfg)


def _hidden(params, uids, items, keep_mask, scale, cfg: CDAEConfig
            ) -> torch.Tensor:
    """z = act(scale * sum W_i (* Uu) + b (+ Wu)) over a padded (B, L)
    item block; ``keep_mask`` selects the live entries."""
    W = params["W"]
    rows = W[items.long().clamp(0, W.shape[0] - 1)]  # (B, L, D)
    h = torch.einsum("bld,bl->bd", _operand(rows, cfg),
                     _operand(keep_mask, cfg))
    h = h.to(W.dtype) * scale
    if cfg.linear_function:
        h = params["Uu"][uids] * h
    h = h + params["b"][None, :]
    if cfg.user_factor:
        h = h + params["Wu"][uids]
    return _activation(h, cfg.linear, cfg.tanh)


def _decode(params, z, cfg: CDAEConfig) -> torch.Tensor:
    """(B, I) scores from hidden codes: the decode kernel when the kernels
    are on, else the plain matmul in the compute dtype."""
    table = params["V"] if cfg.asymmetric else params["W"]
    if cfg.use_pallas:
        return decode_scores(z, table, params["b_prime"])
    return _mm(z, table.t(), cfg) + params["b_prime"][None, :]


def _dense_scores(params, dense_R, uids, *, cfg: CDAEConfig):
    """(B, I) decoder scores with the dense-matmul encode (uncorrupted
    input, scale 1)."""
    dt = params["W"].dtype
    rows = dense_R[uids].to(dt)
    if cfg.corruption_ratio == 1.0:
        rows = torch.zeros_like(rows)
    h = _mm(rows, params["W"], cfg).to(dt)
    if cfg.linear_function:
        h = params["Uu"][uids] * h
    h = h + params["b"][None, :]
    if cfg.user_factor:
        h = h + params["Wu"][uids]
    return _decode(params, _activation(h, cfg.linear, cfg.tanh), cfg)


def _batch_scores(params, uids, rated_items, rated_mask, *, cfg: CDAEConfig):
    """(B, I) decoder scores from the uncorrupted padded rated rows."""
    in_mask = (torch.zeros_like(rated_mask) if cfg.corruption_ratio == 1.0
               else rated_mask)
    z = _hidden(params, uids, rated_items, in_mask, 1.0, cfg)
    return _decode(params, z, cfg)


def _batch_topk_impl(params, uids, rated_items, rated_mask, dense_R, *,
                     cfg: CDAEConfig, mode: str, k: int) -> torch.Tensor:
    """Hidden encode + blockwise decode/top-k -> (B, k) ids. ``mode``:
    'fused_dense' (kernel masks from dense_R[uids] int8 rows), 'fused_csr'
    (kernel masks from the sorted padded rated rows), 'streaming' (plain
    blockwise loop)."""
    z = _hidden(
        params,
        uids,
        rated_items,
        (torch.zeros_like(rated_mask) if cfg.corruption_ratio == 1.0
         else rated_mask),
        1.0,
        cfg,
    )
    table = params["V"] if cfg.asymmetric else params["W"]
    bp = params["b_prime"]
    if mode == "streaming":
        ids, _ = streaming_topk_scores(z, table, bp, rated_items, k=k)
    elif mode == "fused_dense":
        ids, _ = fused_topk_scores(z, table, bp, dense_R[uids], k=k)
    else:
        # w=64: the batches cdae_tpu's per-block query lists cannot hold
        # (more than 64 rated items in one catalog block) are the ones it
        # answers with its streaming scan; the tail convention follows
        ids, _ = fused_topk_scores_csr(z, table, bp, rated_items.int(),
                                       k=k, w=64)
    return ids


# ============================================================ training ====

def _draw_uniforms(seed: int, shape, draws, cfg: CDAEConfig, device):
    """(B, I) f32 uniforms of one step seed, one per entry of ``draws``:
    ``hw_uniform(seed, shape, draw)`` with ``fast_rng`` (its kernel when
    ``use_pallas`` is on), else successive ``torch.rand`` draws of a
    generator seeded with ``seed``."""
    if cfg.fast_rng:
        fn = hw_uniform if cfg.use_pallas else hw_uniform_plain
        return [fn(seed, shape, d, device=device) for d in draws]
    gen = torch.Generator(device=device).manual_seed(seed & _MASK32)
    return [torch.rand(shape, generator=gen, device=device) for _ in draws]


def _z_one_minus_z(z: torch.Tensor, cfg: CDAEConfig) -> torch.Tensor:
    """Activation derivative factor in terms of the activation z."""
    if cfg.linear:
        return torch.ones_like(z)
    if cfg.tanh:
        return 1.0 - z * z
    return z - z * z


def _neg_probability(lengths: torch.Tensor, I: int, cfg: CDAEConfig
                     ) -> torch.Tensor:
    """Per-user Bernoulli probability of an unrated item becoming a
    negative: num_neg * |O_u| expected negatives over the I - |O_u|
    unrated items, clamped to [0, 1]."""
    return torch.clamp(
        cfg.num_neg * lengths / torch.clamp(I - lengths, min=1.0), 0.0, 1.0
    )


def _fused_step_supported(cfg: CDAEConfig) -> bool:
    """What cdae_dense_step_fused covers: tied decoder, no Uu gate, f32."""
    return (
        not cfg.asymmetric
        and not cfg.linear_function
        and _cdt(cfg) == torch.float32
        and cfg.dtype == torch.float32
    )


def _use_fused_step(cfg: CDAEConfig) -> bool:
    """fused_step=None stays off, as in cdae_tpu: its TPU measurement said
    so, and the port's own comparison is recorded in PERF.md; changing the
    default is a later measurement's call."""
    if cfg.fused_step is None:
        return False
    if cfg.fused_step and not _fused_step_supported(cfg):
        import warnings

        warnings.warn(
            "CDAEConfig.fused_step=True but the fused kernel does not "
            "support this config (requires asymmetric=False, "
            "linear_function=False, f32 dtype/compute_dtype) -- running the "
            "unfused dense step instead. Timings will measure that path, "
            "not the fused kernel.",
            UserWarning,
            stacklevel=3,
        )
    return bool(cfg.fused_step) and _fused_step_supported(cfg)


def _dense_train_step_fused(params, dense_R, uids, weight, seed: int, *,
                            cfg: CDAEConfig, loss: Loss):
    """The dense step through cdae_dense_step_fused (its kernels when
    ``use_pallas`` is on, else its plain version): W, W_ag, b', b'_ag in
    the fused step, then b and Wu from the returned hidden gradient, as the
    unfused step does. The masks are the hash draws of ``seed``."""
    W = params["W"]
    I = W.shape[0]
    lam, lr, beta = cfg.lambda_, cfg.learn_rate, cfg.beta
    rows_int8 = dense_R[uids]  # (B, I)
    w_user = weight.to(torch.float32)
    lengths = rows_int8.sum(dim=1, dtype=torch.int32).to(torch.float32) \
        * w_user
    p_neg = _neg_probability(lengths, I, cfg)
    h_bias = params["b"][None, :].expand(uids.shape[0], -1)
    if cfg.user_factor:
        h_bias = h_bias + params["Wu"][uids]
    act = "linear" if cfg.linear else ("tanh" if cfg.tanh else "sigmoid")
    fused = (cdae_dense_step_fused if cfg.use_pallas
             else cdae_dense_step_fused_plain)
    *_, hg = fused(
        seed, rows_int8, w_user, p_neg, h_bias.contiguous(), W,
        params["W_ag"], params["b_prime"], params["b_prime_ag"],
        q=cfg.corruption_ratio,
        scale=input_scale(cfg.corruption_ratio, cfg.scaled),
        lam=lam, lr=lr, beta=beta, use_ada=cfg.using_adagrad, act=act,
        loss_name=cfg.loss,
    )
    d_b = w_user @ hg + w_user.sum() * lam * params["b"]
    dense_adagrad_step(params["b"], params["b_ag"], d_b, lr, beta,
                       cfg.using_adagrad, use_kernel=bool(cfg.use_pallas))
    if cfg.user_factor:
        row_adagrad_delta(
            params["Wu"], params["Wu_ag"], uids,
            (hg + lam * params["Wu"][uids]) * w_user[:, None],
            w_user[:, None] > 0, lr, beta, cfg.using_adagrad,
        )
    return params


def _dense_train_step(
    params: Dict[str, torch.Tensor],
    dense_R: torch.Tensor,  # (U, I) int8 interaction matrix
    uids: torch.Tensor,  # (B,) long
    weight: torch.Tensor,  # (B,) 0/1
    seed: int,  # the step seed (step_seed)
    *,
    cfg: CDAEConfig,
    loss: Loss,
    u_corrupt: Optional[torch.Tensor] = None,  # (B, I) f32 uniforms
    u_neg: Optional[torch.Tensor] = None,  # (B, I) f32 uniforms
) -> Dict[str, torch.Tensor]:
    """One full-catalog dense minibatch step: corrupt, encode ((B, I) x
    (I, D)), activate, draw Bernoulli negatives (expected count
    num_neg*|O_u| per user), decode, loss gradient, table gradients, then
    AdaGrad. Updates ``params`` IN PLACE (W, b', b, V in one
    dense_adagrad_steps sweep -- one launch of the adagrad_update kernel
    when ``use_pallas`` is on -- and the Wu / Uu rows) and returns it.

    ``u_corrupt`` / ``u_neg`` inject the corruption and negative uniforms;
    when absent they are drawn from ``seed`` (``_draw_uniforms``). With
    ``compute_dtype`` bf16 the (B, I) slabs live in bf16, as in cdae_tpu:
    the 0/1 masks are exact, and the loss-gradient slab rounds."""
    if _use_fused_step(cfg):
        return _dense_train_step_fused(params, dense_R, uids, weight, seed,
                                       cfg=cfg, loss=loss)
    W = params["W"]
    I, D = W.shape
    dt = W.dtype
    sdt = _cdt(cfg)
    f32 = torch.float32
    lam, lr, beta = cfg.lambda_, cfg.learn_rate, cfg.beta
    use_kernel = bool(cfg.use_pallas)
    w_user = weight.to(sdt)
    rows = dense_R[uids].to(sdt) * w_user[:, None]  # (B, I) 0/1
    # counts exceed bf16's exact-integer range -- accumulate f32
    lengths = rows.sum(dim=1, dtype=f32).to(dt)
    shape = tuple(rows.shape)
    q = cfg.corruption_ratio
    need = [0] if q > 0.0 and u_corrupt is None else []  # draw 0: corruption
    if u_neg is None:
        need.append(1)  # draw 1: negatives
    drawn = dict(zip(need, _draw_uniforms(seed, shape, need, cfg, W.device)))
    u_corrupt = drawn.get(0, u_corrupt)
    u_neg = drawn.get(1, u_neg)

    kept = rows * (u_corrupt > q).to(sdt) if q > 0.0 else rows
    scale = input_scale(q, cfg.scaled)

    h = _mm(kept, W, cfg).to(dt) * scale
    if cfg.linear_function:
        h = params["Uu"][uids] * h
    h = h + params["b"][None, :]
    if cfg.user_factor:
        h = h + params["Wu"][uids]
    z = _activation(h, cfg.linear, cfg.tanh)
    dz = _z_one_minus_z(z, cfg)

    p_neg = _neg_probability(lengths, I, cfg).to(sdt)
    neg_sel = ((1.0 - rows) * (u_neg < p_neg[:, None]).to(sdt)
               * w_user[:, None])
    w_mat = rows + neg_sel  # per-(user, item) touch counts (0/1 -- exact)

    table = params["V"] if cfg.asymmetric else W
    pred = _mm(z, table.t(), cfg) + params["b_prime"].to(f32)[None, :]
    # truth IS the 0/1 row: one gradient evaluation covers positives and
    # negatives; g is stored in the slab dtype
    g = (loss.gradient(pred, rows.to(f32)) * w_mat.to(f32)).to(sdt)

    touches = w_mat.sum(dim=0, dtype=f32).to(dt)  # (I,)
    d_bp = g.sum(dim=0, dtype=f32).to(dt) + lam * touches * params["b_prime"]
    hg = _mm(g, table, cfg).to(dt) * dz

    base = (params["Uu"][uids] * hg if cfg.linear_function else hg) * scale
    if cfg.asymmetric:
        # decoder touches update V; kept inputs update W with base + lam*W
        d_V = _mm(g.t(), z, cfg).to(dt) + lam * touches[:, None] * table
        d_W = _mm(kept.t(), base, cfg).to(dt) + lam * kept.sum(
            dim=0, dtype=f32).to(dt)[:, None] * W
    else:
        # every touch contributes g*z, kept inputs add the base term, lambda
        # once per touch
        d_W = (_mm(g.t(), z, cfg).to(dt) + _mm(kept.t(), base, cfg).to(dt)
               + lam * touches[:, None] * W)
    # Uu's gradient needs the pre-update W: take it before the sweep
    sum_kept_W = _mm(kept, W, cfg).to(dt) if cfg.linear_function else None
    dense = {"W": d_W, "b_prime": d_bp}
    if cfg.asymmetric:
        dense["V"] = d_V
    dense["b"] = w_user.to(f32) @ hg + w_user.sum() * lam * params["b"]
    # every dense grad is taken: one sweep (one kernel launch) for them all
    dense_adagrad_steps(
        [(params[name], params[name + "_ag"], g) for name, g in dense.items()],
        lr, beta, cfg.using_adagrad, use_kernel)

    def row_step(name, grad_rows):
        row_adagrad_delta(params[name], params[name + "_ag"], uids,
                          grad_rows, w_user[:, None] > 0, lr, beta,
                          cfg.using_adagrad)

    if cfg.user_factor:
        row_step("Wu", (hg + lam * params["Wu"][uids]) * w_user[:, None])
    if cfg.linear_function:
        row_step("Uu", (lam * params["Uu"][uids] + hg * sum_kept_W)
                 * w_user[:, None])
    return params


def _dense_data_loss(params, dense_R, uids, weight, seed: int, *,
                     cfg: CDAEConfig, loss: Loss, uniforms=None
                     ) -> torch.Tensor:
    """Dense-mode reconstruction loss over the positives, averaged over
    ``num_corruptions`` corruptions. ``uniforms[c]`` (optional) is the
    (B, I) corruption draw of corruption c; otherwise draw c of ``seed``."""
    W = params["W"]
    dt = W.dtype
    w_user = weight.to(dt)
    rows = dense_R[uids].to(dt) * w_user[:, None]
    q = cfg.corruption_ratio
    ncorr = cfg.num_corruptions
    if uniforms is None and q > 0.0:
        uniforms = _draw_uniforms(seed, tuple(rows.shape), range(ncorr), cfg,
                                  W.device)
    scale = input_scale(q, cfg.scaled)
    table = params["V"] if cfg.asymmetric else W
    total = torch.zeros((), dtype=torch.float32, device=W.device)
    for c in range(ncorr):
        kept = rows * (uniforms[c] > q).to(dt) if q > 0.0 else rows
        h = _mm(kept, W, cfg).to(dt) * scale
        if cfg.linear_function:
            h = params["Uu"][uids] * h
        h = h + params["b"][None, :]
        if cfg.user_factor:
            h = h + params["Wu"][uids]
        z = _activation(h, cfg.linear, cfg.tanh)
        pred = _mm(z, table.t(), cfg).to(dt) + params["b_prime"][None, :]
        total = total + torch.sum(loss.evaluate(pred, 1.0) * rows)
    return total / ncorr

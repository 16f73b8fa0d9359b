"""CDAE -- Collaborative Denoising Auto-Encoder (WSDM'16), serving on
PyTorch.

Port of the serving subset of cdae_tpu/models/cdae.py: the configuration,
parameter reset, the hidden encode and every way a batch of users is scored
or ranked. Scoring runs the hand-written CUDA kernels of
``ops/pallas_kernels.py`` when the model lives on a CUDA device.

Model math (as in cdae_tpu):
  h   = s * sum_{i in rated} W_i   (* U_u if linear_function)
  h  += b (+ W^u_u if user_factor)
  z   = sigmoid(h) | tanh(h) | h    with the reference's +-18 / +-9 clamps
  y_o = (V_o | W_o) . z + b'_o      (linear decoder)
Serving uses the uncorrupted input with scale 1 (an empty input when
corruption_ratio == 1).

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
)
from cdae_tpu_torch.ops.pallas_kernels import (
    decode_scores,
    fused_topk_scores,
    fused_topk_scores_csr,
    streaming_topk_scores,
)

ADAGRAD_INIT = 1e-4

_TRAINING_SLICE = (
    "CDAE training is not ported to cdae_tpu_torch yet; it is the training "
    "slice that follows serving (ROADMAP.md: losses, corruption, AdaGrad, "
    "the dense train step and kernels B1, B2, B4)"
)


@dataclasses.dataclass(frozen=True)
class CDAEConfig:
    """Every field of cdae_tpu's CDAEConfig, so CLI flags and checkpoints
    carry over. Fields that only steer training are kept and unused."""

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
    compute_dtype: Any = None  # matmul operand dtype; None = dtype
    stream_batches: Optional[bool] = None  # None = auto when U*max_len > 2e8
    cache_device_batches: bool = True  # training only
    fast_rng: Optional[bool] = None  # training only
    dense_mode: Optional[bool] = None  # int8 (U, I) dense_R; None = auto
    fused_step: Optional[bool] = None  # training only
    neg_pool: Optional[int] = None  # training only
    row_update: Optional[bool] = None  # training only
    packed_io: Optional[bool] = None  # training only (a TPU gather layout)
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


class CDAE(RecsysModel):
    name = "CDAE"

    def __init__(self, config: Optional[CDAEConfig] = None,
                 device="cuda", **kw):
        self.device = resolve_device(device)
        self.cfg = config if config is not None else CDAEConfig(**kw)
        if self.cfg.use_pallas is None:
            self.cfg = dataclasses.replace(
                self.cfg, use_pallas=self.device.type == "cuda"
            )

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

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
    def train_one_iteration(self, state: CDAEState, rng_key=None):
        raise NotImplementedError(_TRAINING_SLICE)

    def train_epochs(self, state: CDAEState, num_epochs: int, rng_key=None):
        raise NotImplementedError(_TRAINING_SLICE)

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


def _hidden(params, uids, items, keep_mask, scale, cfg: CDAEConfig
            ) -> torch.Tensor:
    """z = act(scale * sum W_i (* Uu) + b (+ Wu)) over a padded (B, L)
    item block; ``keep_mask`` selects the live entries."""
    cdt = _cdt(cfg)
    W = params["W"]
    rows = W[items.long().clamp(0, W.shape[0] - 1)]  # (B, L, D)
    h = torch.einsum("bld,bl->bd", rows.to(cdt), keep_mask.to(cdt))
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
    cdt = _cdt(cfg)
    scores = (z.to(cdt) @ table.to(cdt).t()).to(torch.float32)
    return scores + params["b_prime"][None, :]


def _dense_scores(params, dense_R, uids, *, cfg: CDAEConfig):
    """(B, I) decoder scores with the dense-matmul encode (uncorrupted
    input, scale 1)."""
    dt = params["W"].dtype
    cdt = _cdt(cfg)
    rows = dense_R[uids].to(dt)
    if cfg.corruption_ratio == 1.0:
        rows = torch.zeros_like(rows)
    h = (rows.to(cdt) @ params["W"].to(cdt)).to(dt)
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

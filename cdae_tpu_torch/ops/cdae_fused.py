"""The fused CDAE dense train step (port of cdae_tpu/ops/cdae_fused.py).

``cdae_dense_step_fused`` runs one whole tied-decoder dense step --
corrupt, encode, activate, draw negatives, decode, loss gradient, table
gradients, AdaGrad on W and b' -- in the five launches of
csrc/cdae_fused.cu (its products on the tensor cores in 3xTF32), with
no (B, I) f32 slab in device memory: the masks are regenerated from
(seed, row, col) by the hash of ``hw_uniform`` (draw 0: corruption, draw 1:
negatives), so the unfused step with ``fast_rng`` draws the very same ones.
``cdae_dense_step_fused_plain`` is the unfused slab math on those masks.

Both update W, W_ag, b_prime and bp_ag IN PLACE and return them with the
hidden gradient; as in cdae_tpu, the caller applies the small b / Wu
updates from that hidden gradient. The wrapper launches the kernels for
CUDA tensors and runs the plain version for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cdae_tpu_torch.ops.losses import Loss, LossType
from cdae_tpu_torch.ops.pallas_kernels import (
    _cdiv,
    _num_sms,
    _on_cuda,
    _require,
    _stream,
    hw_uniform_plain,
)

_ACTS = {"sigmoid": 0, "tanh": 1, "linear": 2}
_LOSSES = {
    LossType.SQUARE: 0, LossType.LOGISTIC: 1, LossType.CROSS_ENTROPY: 2,
    LossType.LOG: 3, LossType.LOGM: 4, LossType.HINGE: 5,
    LossType.SQUARED_HINGE: 6,
}
_TILE_U = 64  # users per encode / decode tile in csrc/cdae_fused.cu
_CHUNK_I = 32  # items per chunk, and per grads block
_USPLIT = 64  # a grads user split is whole 64-user chunks
_MAX_D = 256  # accumulators per warp along D cap the width
_WAVES = 2  # blocks per SM each grid aims at

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor]


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    """The fused kernel's activation (cdae_tpu's clamps, sigmoid as
    1/(1+exp(-h)))."""
    if act == "linear":
        return h
    if act == "tanh":
        return torch.where(h > 9.0, 1.0,
                           torch.where(h < -9.0, -1.0, torch.tanh(h)))
    s = 1.0 / (1.0 + torch.exp(-h))
    return torch.where(h > 18.0, 1.0, torch.where(h < -18.0, 0.0, s))


def _act_grad(z: torch.Tensor, act: str) -> torch.Tensor:
    if act == "linear":
        return torch.ones_like(z)
    if act == "tanh":
        return 1.0 - z * z
    return z - z * z


def fused_step_grid(B: int, I: int, num_sms: int) -> Tuple[int, int, int,
                                                            int]:
    """(splits, per_split, usplits, per_usplit) of csrc/cdae_fused.cu's
    grids for a (B, I) batch on a card of ``num_sms`` SMs. The encode and
    decode grids are (user tiles of 64) x (catalog splits of whole 32-item
    chunks); the grads grid is (item tiles of 32) x (user splits of whole
    64-user chunks). Each aims at about _WAVES blocks an SM without going
    over, and every split is non-empty."""
    user_tiles = _cdiv(B, _TILE_U)
    chunks = _cdiv(I, _CHUNK_I)
    splits = max(1, min(chunks, _WAVES * num_sms // user_tiles))
    per_split = _cdiv(chunks, splits) * _CHUNK_I
    item_tiles = _cdiv(I, _CHUNK_I)
    user_chunks = _cdiv(B, _USPLIT)
    usplits = max(1, min(user_chunks, _WAVES * num_sms // item_tiles))
    per_usplit = _cdiv(user_chunks, usplits) * _USPLIT
    return _cdiv(I, per_split), per_split, _cdiv(B, per_usplit), per_usplit


def cdae_dense_step_fused_plain(
    seed: int, rows_int8, w_user, p_neg, h_bias, W, W_ag, b_prime, bp_ag, *,
    q: float, scale: float, lam: float, lr: float, beta: float,
    use_ada: bool, act: str, loss_name: str,
) -> Outputs:
    """Plain version of ``cdae_dense_step_fused``: the unfused (B, I) slab
    math on the same hash masks, updating in place. The slabs take W's
    dtype, so float64 inputs give a float64 reference of the same step."""
    loss = Loss.create(loss_name)
    B, I = rows_int8.shape
    dev, dt = W.device, W.dtype
    rows01 = rows_int8.to(dt)
    wu = w_user.to(dt)[:, None]
    kept01 = rows01
    if q > 0.0:
        u_c = hw_uniform_plain(seed, (B, I), 0, device=dev)
        kept01 = rows01 * (u_c > q).to(dt)
    kept = kept01 * wu
    z = _act((kept @ W) * scale + h_bias, act)
    pred = z @ W.t() + b_prime
    u_n = hw_uniform_plain(seed, (B, I), 1, device=dev)
    neg_sel = (1.0 - rows01) * (u_n < p_neg[:, None]).to(dt) * wu
    w_mat = rows01 * wu + neg_sel
    g = loss.gradient(pred, rows01) * w_mat
    touches = w_mat.sum(dim=0)
    hg = (g @ W) * _act_grad(z, act)
    d_w = g.t() @ z + kept.t() @ (hg * scale) + lam * touches[:, None] * W
    d_bp = g.sum(dim=0) + lam * touches * b_prime
    for p, a, d in ((W, W_ag, d_w), (b_prime, bp_ag, d_bp)):
        if use_ada:
            a += d * d
            p -= lr * d / (beta + torch.sqrt(a))
        else:
            p -= lr * d
    return W, W_ag, b_prime, bp_ag, hg


def cdae_dense_step_fused(
    seed: int,  # per-step seed (a 32-bit int)
    rows_int8: torch.Tensor,  # (B, I) int8 0/1 interaction rows
    w_user: torch.Tensor,  # (B,) 0/1 batch weights
    p_neg: torch.Tensor,  # (B,) Bernoulli negative probability per user
    h_bias: torch.Tensor,  # (B, D) b (+ Wu[uids]) hidden offsets
    W: torch.Tensor,  # (I, D) f32, updated in place
    W_ag: torch.Tensor,  # (I, D) f32, updated in place
    b_prime: torch.Tensor,  # (I,) f32, updated in place
    bp_ag: torch.Tensor,  # (I,) f32, updated in place
    *,
    q: float,
    scale: float,
    lam: float,
    lr: float,
    beta: float,
    use_ada: bool,
    act: str,  # "sigmoid" | "tanh" | "linear"
    loss_name: str,
) -> Outputs:
    """One fused CDAE dense step. Returns (W, W_ag, b_prime, bp_ag, hg):
    the first four are the inputs, updated in place; hg (B, D) is the hidden
    gradient times act'(z), before the input scale. f32 only, 1 <= D <=
    256; every reduction is an ordered sum, so a step is deterministic."""
    if not _on_cuda(W):
        return cdae_dense_step_fused_plain(
            seed, rows_int8, w_user, p_neg, h_bias, W, W_ag, b_prime, bp_ag,
            q=q, scale=scale, lam=lam, lr=lr, beta=beta, use_ada=use_ada,
            act=act, loss_name=loss_name,
        )
    from cdae_tpu_torch.ops import cuda_lib

    dev = W.device
    B, I = rows_int8.shape
    D = W.shape[1]
    if not 1 <= D <= _MAX_D:
        raise ValueError(f"D={D}: the fused step takes 1 <= D <= {_MAX_D}")
    if act not in _ACTS:
        raise ValueError(f"act={act!r}: expected one of {sorted(_ACTS)}")
    loss = _LOSSES[Loss.create(loss_name).kind]
    f32 = torch.float32
    _require(rows_int8, "rows_int8", torch.int8, (B, I), dev)
    _require(w_user, "w_user", f32, (B,), dev)
    _require(p_neg, "p_neg", f32, (B,), dev)
    _require(h_bias, "h_bias", f32, (B, D), dev)
    _require(W, "W", f32, (I, D), dev)
    _require(W_ag, "W_ag", f32, (I, D), dev)
    _require(b_prime, "b_prime", f32, (I,), dev)
    _require(bp_ag, "bp_ag", f32, (I,), dev)
    hg = torch.empty((B, D), dtype=f32, device=dev)
    if B == 0 or I == 0:
        return W, W_ag, b_prime, bp_ag, hg.zero_()
    splits, per_split, usplits, per_usplit = fused_step_grid(
        B, I, _num_sms(dev.index or 0))
    z = torch.empty((B, D), dtype=f32, device=dev)
    hs = torch.empty((B, D), dtype=f32, device=dev)
    part_h = torch.empty((splits, B, D), dtype=f32, device=dev)
    part_hg = torch.empty((splits, B, D), dtype=f32, device=dev)
    part_dbp = torch.empty((_cdiv(B, _TILE_U), I), dtype=f32, device=dev)
    part_tch = torch.empty((_cdiv(B, _TILE_U), I), dtype=f32, device=dev)
    part_dw = torch.empty((usplits, I, D), dtype=f32, device=dev)
    done = torch.empty(_cdiv(I, _CHUNK_I), dtype=torch.int32, device=dev)
    # 16-byte copies of W, z and hs rows where D and W's start allow
    vec = 4 if D % 4 == 0 and W.data_ptr() % 16 == 0 else 1
    seed32 = ((int(seed) + 2**31) & 0xFFFFFFFF) - 2**31  # as a C int
    rc = cuda_lib.lib().cdae_fused_step(
        rows_int8.data_ptr(), w_user.data_ptr(), p_neg.data_ptr(),
        h_bias.data_ptr(), W.data_ptr(), W_ag.data_ptr(), b_prime.data_ptr(),
        bp_ag.data_ptr(), hg.data_ptr(), hs.data_ptr(), z.data_ptr(),
        part_h.data_ptr(), part_hg.data_ptr(), part_dbp.data_ptr(),
        part_tch.data_ptr(), part_dw.data_ptr(), done.data_ptr(),
        B, I, D, seed32, float(q), float(scale), float(lam), float(lr),
        float(beta), int(bool(use_ada)), _ACTS[act], loss, splits, per_split,
        usplits, per_usplit, vec, _stream(dev),
    )
    cuda_lib.check(rc, "cdae_dense_step_fused")
    cdae_dense_step_fused.launches += 1
    return W, W_ag, b_prime, bp_ag, hg


cdae_dense_step_fused.launches = 0

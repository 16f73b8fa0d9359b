"""Plain PyTorch reference of CDAE training with pooled negatives, for the
benchmark's correctness check of a configuration that sets ``neg_pool``.

Written from the model's definition (Wu et al., WSDM 2016) and the pool's
stated law, not from the program's code: no kernels, no row aggregation
plans, no batching caches. It imports only torch, numpy and, from
``cdae.py`` beside it (the reference of exact negatives), the pieces that
do not depend on how negatives are drawn: the hash draws and step seeds,
the rated rows and the epoch's batches, the activation, the loss
gradients, the control's rounding, serving scores and the gradient norms.
Training and scoring run with the backend's TF32 switches off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``, restored after), so every product
is float32; the control (``tf32=True``) rounds operands as ``cdae.py``'s.

Model, corruption, AdaGrad and serving are ``cdae.py``'s. The step differs
from the paper where the pool does:

- Negatives. The paper samples each user's negatives from its unrated
  items. Here one pool of K item ids a step, drawn uniformly over the
  catalog with replacement, serves the whole batch: user u keeps pool
  entry k when its selection uniform is below
  q_u = min(1, num_neg |O_u| I / (K (I - |O_u|))) and the entry is none of
  its rated items, so an unrated item is touched num_neg |O_u| / (I -
  |O_u|) times in expectation, as exact complement sampling touches it.
  An id drawn twice into the pool is two entries; a user of weight 0
  keeps none.
- Draws (the streams the program is specified to draw with). With
  ``fast_rng``: the (B, L) corruption uniforms are the counter hash's draw
  0 of the step seed, the pool ids its integer draws of salt
  ``POOL_SALT`` over [0, I), the (B, K) selection uniforms its draw 1.
  Without: a ``torch.Generator`` on the run's device, seeded with the step
  seed's low 32 bits, draws the (B, L) corruption uniforms (when the
  corruption ratio is above 0), then the K pool ids, then the (B, K)
  selection uniforms.
- L2. The per-touch term lambda * param is added at every touch: once for
  each positive, and once for each kept (user, pool entry) pair.
- Every gradient is taken from the parameters before the step, then
  AdaGrad applies once a minibatch over the whole W, b', b tables, then
  the live users' Wu rows.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

if not __package__:
    # loaded by file path (benchmark/harness/spec.py load_path), it has no
    # package of its own to find ``cdae.py`` beside it
    __package__ = "benchmark.reference"

from .cdae import (  # noqa: E402
    ADAGRAD_INIT,
    MASK32,
    Rows,
    _act,
    _apply,
    _user_rows_step,
    grad_norms,
    hash_randint,
    hash_uniform,
    loss_gradient,
    operands,
    scores as _scores,
    sparse_batches,
    step_seed,
)

POOL_SALT = 0x5EED0002  # the integer draws of the pool's ids


def _float32_products(fn, *args, **kw):
    """``fn(*args, **kw)`` with the backend's TF32 switches off; they are
    restored after."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, dnn.allow_tf32)
    mm.allow_tf32 = dnn.allow_tf32 = False
    try:
        return fn(*args, **kw)
    finally:
        mm.allow_tf32, dnn.allow_tf32 = saved


def check_config(cfg: Dict) -> None:
    """The options this reference covers; any other raises."""
    fixed = dict(asymmetric=False, linear=False, tanh=False,
                 linear_function=False, user_factor=True, num_corruptions=1,
                 using_adagrad=True, bucket_by_length=True, penalty="L2")
    for key, want in fixed.items():
        if cfg.get(key, want) != want:
            raise ValueError(f"the reference covers {key}={want} only")
    for key in ("row_update", "fused_step", "compute_dtype", "dense_mode"):
        if cfg.get(key):
            raise ValueError(f"the reference does not cover {key}")
    if cfg.get("dense_mode") is None:
        raise ValueError("the reference covers dense_mode=False only")
    if cfg.get("fast_rng") not in (True, False):
        raise ValueError("the reference covers fast_rng True or False")
    pool = cfg.get("neg_pool")
    if isinstance(pool, bool) or not isinstance(pool, int) or pool < 1:
        raise ValueError("the reference covers a pool of K >= 1 ids only")
    if cfg.get("loss", "LOGISTIC") not in ("SQUARE", "LOGISTIC"):
        raise ValueError(f"the reference has no loss {cfg['loss']!r}")


def keep_probability(lengths: torch.Tensor, I: int, K: int,
                     num_neg: int) -> torch.Tensor:
    """q_u = min(1, num_neg |O_u| I / (K (I - |O_u|))) in float32, for
    (B,) rated counts (0 for a user of weight 0)."""
    L = lengths.to(torch.float32)
    return torch.clamp(num_neg * L * I / (K * torch.clamp(I - L, min=1.0)),
                       0.0, 1.0)


def rated_in_pool(items: torch.Tensor, pool: torch.Tensor,
                  I: int) -> torch.Tensor:
    """(B, K) whether pool id k is one of row b's rated items (``items``
    (B, L) padded with I)."""
    rated = torch.zeros((items.shape[0], I + 1), dtype=torch.bool,
                        device=items.device)
    rated.scatter_(1, items, True)
    return rated[:, pool]


def _draws(cfg: Dict, seed: int, B: int, L: int, I: int, dev):
    """(corruption uniforms (B, L) or None, pool ids (K,), selection
    uniforms (B, K)) of one step."""
    K, q = int(cfg["neg_pool"]), cfg["corruption_ratio"]
    if cfg["fast_rng"]:
        u_keep = hash_uniform(seed, B, L, 0, dev) if q > 0.0 else None
        pool = hash_randint(seed, POOL_SALT, 1, K,
                            torch.tensor([I], device=dev))[0]
        return u_keep, pool, hash_uniform(seed, B, K, 1, dev)
    gen = torch.Generator(device=dev).manual_seed(seed & MASK32)
    u_keep = (torch.rand((B, L), generator=gen, device=dev) if q > 0.0
              else None)
    pool = torch.randint(0, I, (K,), generator=gen, device=dev)
    return u_keep, pool, torch.rand((B, K), generator=gen, device=dev)


def pool_step(P, A, cfg: Dict, rows: Rows, uids: np.ndarray,
              weight: np.ndarray, width: int, seed: int,
              tf32: bool = False) -> None:
    """One sparse minibatch step with pooled negatives, in place on P
    (params) and A (AdaGrad accumulators)."""
    op = operands(tf32)
    W = P["W"]
    dev = W.device
    I, D = W.shape
    q, lam = cfg["corruption_ratio"], cfg["lambda_"]
    scale = 1.0 / (1.0 - q) if cfg["scaled"] and q < 1.0 else 1.0
    items = torch.as_tensor(rows.padded(uids, width), device=dev)
    w = torch.as_tensor(weight, device=dev)
    uid = torch.as_tensor(uids, dtype=torch.int64, device=dev)
    live_user = w > 0
    lengths = torch.as_tensor(rows.lengths[uids], device=dev) * live_user
    B, L = items.shape
    u_keep, pool, u_sel = _draws(cfg, seed, B, L, I, dev)
    pool = pool.to(torch.int64)
    mask = (torch.arange(L, device=dev)[None, :] < lengths[:, None])
    mask_f = mask.float() * w[:, None]
    keep = mask & live_user[:, None]
    if u_keep is not None:
        keep = keep & (u_keep > q)
    keep_f = keep.float()

    # encode, and the positives (truth 1)
    ic = items.clamp(max=I - 1)
    Wi, bpi = W[ic], P["b_prime"][ic]
    Wi_op = op(Wi)
    z = _act(torch.einsum("bld,bl->bd", Wi_op, keep_f) * scale + P["b"]
             + P["Wu"][uid])
    z_op = op(z)
    g_pos = loss_gradient(cfg["loss"], torch.einsum("bld,bd->bl", Wi_op, z_op)
                          + bpi, 1.0) * mask_f
    hidden = torch.einsum("bl,bld->bd", op(g_pos), Wi_op)

    # the pool's negatives (truth 0), one touch a kept (user, entry) pair
    K = pool.shape[0]
    q_u = keep_probability(lengths, I, K, cfg["num_neg"])
    sel = ((u_sel < q_u[:, None]) & ~rated_in_pool(items, pool, I)
           & live_user[:, None])
    Wp, bpp = W[pool], P["b_prime"][pool]
    Wp_op = op(Wp)
    g_neg = loss_gradient(cfg["loss"], z_op @ Wp_op.t() + bpp,
                          0.0) * sel.float()
    hidden = hidden + op(g_neg) @ Wp_op
    bi, ki = torch.nonzero(sel, as_tuple=True)
    gk = g_neg[bi, ki]
    gW = torch.zeros_like(W)
    gbp = torch.zeros_like(P["b_prime"])
    gW.index_add_(0, pool[ki], op(gk[:, None] * z[bi] + lam * Wp[ki]))
    gbp.index_add_(0, pool[ki], op(gk + lam * bpp[ki]))

    # the positives' W rows: dropped ones at the output side alone, kept
    # ones at both
    hg = hidden * (z - z * z)
    gz = g_pos[..., None] * z[:, None, :]
    dropped = mask_f * (1.0 - keep_f)
    vals = ((gz + lam * Wi) * dropped[..., None]
            + (hg[:, None, :] * scale + lam * Wi + gz) * keep_f[..., None])
    at = mask.reshape(-1)
    ids = items.reshape(-1)[at]
    gW.index_add_(0, ids, op(vals.reshape(-1, D)[at]))
    gbp.index_add_(0, ids, op(((g_pos + lam * bpi) * mask_f).reshape(-1)[at]))
    gb = w @ op(hg) + w.sum() * lam * P["b"]
    _apply(P, A, {"W": gW, "b_prime": gbp, "b": gb}, cfg)
    _user_rows_step(P, A, uid, w, hg, cfg)


def train_epoch(P: Dict[str, torch.Tensor], cfg: Dict, rows: Rows,
                dense: bool, seed: int, epoch: int = 0,
                drop_half: bool = False,
                tf32: bool = False) -> Dict[str, torch.Tensor]:
    """One epoch of pooled sparse steps from parameters P (updated in
    place), over ``cdae.sparse_batches``; returns the AdaGrad accumulators.
    ``dense`` must be False. ``drop_half``: a planted fault, the second
    half of each batch left out (its weight set to 0); ``tf32``: the
    control's precision."""
    check_config(cfg)
    if dense:
        raise ValueError("pooled negatives are a sparse step's")
    return _float32_products(_epoch, P, cfg, rows, seed, epoch, drop_half,
                             tf32)


def _epoch(P, cfg, rows, seed, epoch, drop_half, tf32):
    A = {k: torch.full_like(v, ADAGRAD_INIT) for k, v in P.items()}
    for j, (uids, weight, width) in enumerate(
            sparse_batches(rows, cfg["batch_size"])):
        if drop_half:
            weight = weight.copy()
            weight[len(weight) // 2:] = 0.0
        pool_step(P, A, cfg, rows, uids, weight, width,
                  step_seed(seed, epoch, j, 0), tf32=tf32)
    return A


def scores(P: Dict[str, torch.Tensor], rows: Rows, uids: np.ndarray,
           tf32: bool = False) -> torch.Tensor:
    """``cdae.scores``: (B, I) serving scores, rated items at -inf (the
    pool plays no part in serving), with the TF32 switches off."""
    return _float32_products(_scores, P, rows, uids, tf32=tf32)

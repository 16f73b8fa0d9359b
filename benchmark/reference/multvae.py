"""Plain PyTorch reference of Mult-VAE training and serving (Liang,
Krishnan, Hoffman, Jebara, "Variational Autoencoders for Collaborative
Filtering", WWW 2018, arXiv:1802.05814; public code
github.com/dawenl/vae_cf), for the benchmark's correctness check.

Written from the paper's equations and its public code, not from the
program's: each batch's rows dense (B, I), the gradients by autograd from
the loss, Adam written out. It imports only torch, numpy and, from
``cdae.py`` and ``cdae_pool.py`` beside it, the hashed uniforms and step
seeds, the rated rows, the control's rounding and the helper that turns
the backend's TF32 switches off (every product in float32).

Model: x~ = dropout_q(x / |x|_2), kept entries scaled by 1 / (1 - q);
h = tanh(x~ W_q1 + b_q1); [mu | logvar] = h W_q2 + b_q2;
z = mu + eps exp(logvar / 2); g = tanh(z W_p1 + b_p1);
logits = g W_p2 + b_p2. Loss: -mean_u sum_i x_ui log_softmax(logits_u)_i +
beta_t mean_u 1/2 sum_j (-logvar + exp(logvar) + mu^2 - 1), beta_t =
min(anneal_cap, t / total_anneal_steps) with t the updates before this one
(the public code's ``update_count``). Adam over the 8 tables, no L2 term
(the paper's lambda = 0). Serving: z = mu, no dropout; the logits rank.

Departures from the paper and its code:

- Draws: the counter hash of ``cdae.py`` in place of TensorFlow's
  streams. An epoch's user order is numpy's permutation
  (``default_rng``) seeded with the low 32 bits of the step seed of batch
  -1; batch j of epoch e has step seed ``step_seed(seed, e, j, 0)``. The
  dropout uniform of the batch's p-th rated pair (users in batch order,
  each user's items ascending) is its draw 0 at (0, p), kept where above
  q; eps is Box-Muller over its draw 1 of (B, 2K):
  sqrt(-2 log(1 - u[:, :K])) cos(2 pi u[:, K:]).
- Data: the benchmark's synthetic pairs, each user's split into training
  and held-out items at random (only training is used), where the paper
  holds out 40,000 whole users.
- Adam: PyTorch's form, eps added to the bias-corrected sqrt(v); TF1's
  AdamOptimizer, which the public code uses, adds it before the
  correction. Its arithmetic is float64, each table and moment stored in
  float32, so beta1, beta2 and the step are exact.
- Initial weights are the benchmark's (Glorot-uniform, biases normal with
  std 0.001, not truncated as the public code's).

The control is this reference in the precision below float32: with
``tf32=True`` the operands of every matrix product, in the forward pass
and in autograd's backward alike, are rounded to TF32 (``cdae.py
tf32_round``) and summed in float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

if not __package__:
    # loaded by file path (benchmark/harness/spec.py load_path), it has no
    # package of its own to find ``cdae.py`` beside it
    __package__ = "benchmark.reference"

from .cdae import MASK32, Rows, hash_uniform, operands, step_seed  # noqa
from .cdae_pool import _float32_products  # noqa: E402

LEAVES = ("W_q1", "b_q1", "W_q2", "b_q2", "W_p1", "b_p1", "W_p2", "b_p2")


class _Product(torch.autograd.Function):
    """a @ b with both operands through ``op`` (the control's rounding or
    nothing), in the backward pass too."""

    @staticmethod
    def forward(ctx, a, b, op):
        ctx.op = op
        ctx.save_for_backward(a, b)
        return op(a) @ op(b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        op = ctx.op
        return op(grad) @ op(b).t(), op(a).t() @ op(grad), None


def permutation(seed: int, epoch: int, num_users: int) -> np.ndarray:
    """The users of an epoch in their training order."""
    return np.random.default_rng(
        step_seed(seed, epoch, -1, 0) & MASK32).permutation(num_users)


def gaussian(seed: int, rows: int, cols: int, device) -> torch.Tensor:
    """(rows, cols) normals of a step seed by Box-Muller."""
    u = hash_uniform(seed, rows, 2 * cols, 1, device)
    return (torch.sqrt(-2.0 * torch.log1p(-u[:, :cols]))
            * torch.cos((2.0 * np.pi) * u[:, cols:]))


def kl_weight(cfg: Dict, updates: int) -> float:
    return min(cfg["anneal_cap"], updates / cfg["total_anneal_steps"])


def dropout_keep(X: torch.Tensor, seed: int, q: float) -> torch.Tensor:
    """(B, I) 0/1: the rated entries of X kept by the step's draw 0."""
    rated = X > 0
    u = hash_uniform(seed, 1, int(rated.sum()), 0, X.device)[0]
    keep = torch.zeros_like(X)
    keep[rated] = (u > q).to(X.dtype)  # row-major: the pairs' order
    return keep


def forward(P: Dict[str, torch.Tensor], X: torch.Tensor, keep, eps,
            cfg: Dict, tf32: bool = False):
    """(logits, mu, logvar) of binary rows X (B, I); ``keep`` None and
    ``eps`` None for serving (no dropout, z = mu)."""
    op = operands(tf32)

    def mm(a, b):
        return _Product.apply(a, b, op)

    q, K = cfg["dropout"], cfg["latent_dim"]
    norm = torch.rsqrt(X.sum(dim=1).clamp(min=1.0))
    if keep is None:
        x = X * norm[:, None]
    else:
        x = X * keep * (norm * (1.0 / (1.0 - q)))[:, None]
    h = torch.tanh(mm(x, P["W_q1"]) + P["b_q1"])
    enc = mm(h, P["W_q2"]) + P["b_q2"]
    mu, logvar = enc[:, :K], enc[:, K:]
    z = mu if eps is None else mu + eps * torch.exp(0.5 * logvar)
    g = torch.tanh(mm(z, P["W_p1"]) + P["b_p1"])
    return mm(g, P["W_p2"]) + P["b_p2"], mu, logvar


def loss(P, X, keep, eps, beta: float, cfg: Dict, tf32: bool = False):
    """The batch's loss: the mean multinomial NLL plus beta times the mean
    KL divergence."""
    logits, mu, logvar = forward(P, X, keep, eps, cfg, tf32)
    nll = -(torch.log_softmax(logits, dim=1) * X).sum(dim=1).mean()
    kl = (0.5 * (-logvar + torch.exp(logvar) + mu * mu - 1.0)).sum(
        dim=1).mean()
    return nll + beta * kl


def adam(P, grads, M, V, t: int, cfg: Dict) -> None:
    """Adam's update number ``t`` (from 1), in place, PyTorch's form. Its
    arithmetic is float64 on the float32 tables, moments and gradients,
    each result stored back in float32: the constants stay exact (0.999
    rounded to float32 would weigh a gradient t updates old by about
    1 + 1.3e-8 t, some 1.2e-5 too much in v over a Netflix epoch)."""
    b1, b2 = cfg["beta1"], cfg["beta2"]
    step = cfg["learn_rate"] / (1.0 - b1 ** t)
    root = (1.0 - b2 ** t) ** 0.5
    f64 = torch.float64
    for k, g in grads.items():
        g = g.to(f64)
        M[k].copy_(M[k].to(f64).mul_(b1).add_(g, alpha=1.0 - b1))
        V[k].copy_(V[k].to(f64).mul_(b2).addcmul_(g, g, value=1.0 - b2))
        denom = V[k].to(f64).sqrt_().div_(root).add_(cfg["eps"])
        P[k].copy_(P[k].to(f64).addcdiv_(M[k].to(f64), denom, value=-step))


def train_step(P, M, V, cfg: Dict, rows: Rows, uids: np.ndarray, seed: int,
               t: int, tf32: bool = False) -> None:
    """Update ``t`` (from 0) on the users ``uids``, in place on the tables
    P and Adam's moments M, V."""
    dev = P["W_q1"].device
    X = rows.dense(uids, dev)
    keep = dropout_keep(X, seed, cfg["dropout"])
    eps = gaussian(seed, X.shape[0], cfg["latent_dim"], dev)
    leaves = {k: P[k].detach().requires_grad_() for k in LEAVES}
    with torch.enable_grad():
        value = loss(leaves, X, keep, eps, kl_weight(cfg, t), cfg, tf32)
        grads = torch.autograd.grad(value, [leaves[k] for k in LEAVES])
    with torch.no_grad():
        adam(P, dict(zip(LEAVES, grads)), M, V, t + 1, cfg)


def train_epoch(P: Dict[str, torch.Tensor], cfg: Dict, rows: Rows,
                seed: int, epoch: int = 0, drop_half: bool = False,
                tf32: bool = False, steps=None) -> Dict[str, torch.Tensor]:
    """One epoch from the tables P (updated in place) and zero moments;
    returns Adam's second moments v. ``drop_half``: a planted fault, the
    second half of each batch's users left out; ``tf32``: the control's
    precision; ``steps``: only the epoch's first ``steps`` updates."""
    return _float32_products(_epoch, P, cfg, rows, seed, epoch, drop_half,
                             tf32, steps)


def _epoch(P, cfg, rows, seed, epoch, drop_half, tf32, steps):
    M = {k: torch.zeros_like(P[k]) for k in LEAVES}
    V = {k: torch.zeros_like(P[k]) for k in LEAVES}
    U, B = rows.num_users, cfg["batch_size"]
    n = -(-U // B)
    perm = permutation(seed, epoch, U)
    for j, a in enumerate(range(0, U, B)[:steps]):
        uids = perm[a:a + B]
        if drop_half:
            uids = uids[:len(uids) // 2]
        train_step(P, M, V, cfg, rows, uids, step_seed(seed, epoch, j, 0),
                   epoch * n + j, tf32=tf32)
    return V


def scores(P: Dict[str, torch.Tensor], cfg: Dict, rows: Rows,
           uids: np.ndarray, tf32: bool = False) -> torch.Tensor:
    """(B, I) serving logits of the unperturbed rows, rated items at
    -inf."""
    def serve():
        X = rows.dense(uids, P["W_q1"].device)
        with torch.no_grad():
            logits, _, _ = forward(P, X, None, None, cfg, tf32)
        return logits.masked_fill(X > 0, float("-inf"))

    return _float32_products(serve)

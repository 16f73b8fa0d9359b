"""Mult-VAE -- the variational autoencoder for collaborative filtering
(Liang, Krishnan, Hoffman, Jebara, "Variational Autoencoders for
Collaborative Filtering", WWW 2018; public code github.com/dawenl/vae_cf),
on PyTorch.

Model, for a user's binary row x over the I items of the catalog:

  x~     = dropout_q(x / |x|_2)       kept entries scaled by 1 / (1 - q)
  h      = tanh(x~ W_q1 + b_q1)                       (hidden_dim)
  [mu | logvar] = h W_q2 + b_q2                     (2 x latent_dim)
  z      = mu + eps * exp(logvar / 2), eps ~ N(0, 1)  (z = mu in serving)
  g      = tanh(z W_p1 + b_p1)                        (hidden_dim)
  logits = g W_p2 + b_p2                              (I)
  loss   = -mean_u sum_i x_ui log_softmax(logits_u)_i
           + beta_t mean_u 1/2 sum_j (-logvar + exp(logvar) + mu^2 - 1)

with beta_t = min(anneal_cap, t / total_anneal_steps), t the updates made
before this one, and Adam (PyTorch's form: eps added to the bias-corrected
sqrt(v)) on all 8 tables, no L2 term.

An epoch takes the users in a permutation seeded by the step seed of batch
-1 of the epoch (``utils/random.py step_seed``), ``batch_size`` at a time,
the last batch smaller, as the public code's shuffle. The permuted CSR of
the epoch is built on the device once an epoch (``_epoch_pairs``), so a
step reads its rated pairs as slices. A step:

- draws the dropout uniforms of its P rated pairs, (1, P) of B1
  (``hw_uniform``, draw 0 of the step seed; pair p enumerates the batch's
  users in order, each user's items ascending), and eps by Box-Muller from
  a (B, 2 latent_dim) draw 1: eps = sqrt(-2 log(1 - u_a)) cos(2 pi u_b);
- sums W_q1's rows over the kept pairs with their weights (one
  ``embedding_bag``); the other three layers are matrix products in the
  tables' float32 (TF32 is the backend's switch, left to the caller);
- takes the multinomial log-likelihood's gradient over the whole (B, I)
  slab (``ops/losses.py multinomial_gradient``) and every table's gradient
  by hand, W_q1's summed at its rated rows by B8 (``scatter_plan`` and
  ``scatter_matmul``: a fixed order, so a step is the same bits on every
  run);
- updates the 8 tables with one ``dense_adam_steps`` call
  (``solver/optimizer.py``: ``torch._fused_adam_``).

Serving scores a user from the unperturbed input (no dropout, z = mu): the
logits rank the items, since softmax is monotone.

Parameter init: Glorot-uniform weights, as the public code's; biases
normal with std 0.001, where the public code truncates that normal at two
std; Adam's moments zero.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cdae_tpu_torch.data.dataset import Interactions
from cdae_tpu_torch.models.base import ModelState, RecsysModel, resolve_device
from cdae_tpu_torch.ops.losses import multinomial_gradient, multinomial_nll
from cdae_tpu_torch.ops.pallas_kernels import (hw_uniform, scatter_matmul,
                                               scatter_plan)
from cdae_tpu_torch.solver.optimizer import dense_adam_steps
from cdae_tpu_torch.utils.profiling import count, phase, span
from cdae_tpu_torch.utils.random import step_seed

# the tables, in the order of the layers: encoder q, decoder p
LEAVES = ("W_q1", "b_q1", "W_q2", "b_q2", "W_p1", "b_p1", "W_p2", "b_p2")
_MASK32 = 0xFFFFFFFF
_PERM_BATCH = -1  # the batch coordinate of an epoch's permutation seed


@dataclasses.dataclass(frozen=True)
class MultVAEConfig:
    """Mult-VAE's widths and training settings; the defaults are the
    paper's (600-200-600, dropout 0.5, Adam at 1e-3, batch 500, the KL
    weight annealed to 0.2 over 200,000 updates)."""

    hidden_dim: int = 600
    latent_dim: int = 200
    dropout: float = 0.5  # the input's drop probability q
    learn_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    anneal_cap: float = 0.2
    total_anneal_steps: int = 200_000
    batch_size: int = 500


class _Pairs(NamedTuple):
    """An epoch's rated pairs on the device, its users in their permuted
    order: pair p of the epoch is item ``items[p]`` of the permuted user
    whose pairs are ``ptr[k]:ptr[k + 1]`` (``ptr`` on the host)."""

    items: torch.Tensor  # (N,) int64
    rows: torch.Tensor  # (N,) int64, the pair's row in its batch
    flat: torch.Tensor  # (N,) int64, rows * I + items
    coef: torch.Tensor  # (N,) f32, the user's 1 / (|x| (1 - q))
    offsets: torch.Tensor  # (U,) int64, a user's first pair in its batch
    lengths: torch.Tensor  # (U,) f32, |x|^2: the user's rated count
    ones: torch.Tensor  # (max pairs of a batch,) f32
    ptr: np.ndarray  # (U + 1,) int64


def kl_weight(cfg: MultVAEConfig, updates: int) -> float:
    """beta_t = min(anneal_cap, t / total_anneal_steps) after ``updates``
    updates."""
    return min(cfg.anneal_cap, updates / cfg.total_anneal_steps)


def permutation(seed: int, epoch: int, num_users: int) -> np.ndarray:
    """The users of epoch ``epoch`` in their training order: numpy's
    permutation from the epoch's step seed of batch -1."""
    s = step_seed(seed, epoch, _PERM_BATCH, 0) & _MASK32
    return np.random.default_rng(s).permutation(num_users)


def gaussian(seed: int, rows: int, cols: int, device) -> torch.Tensor:
    """(rows, cols) normals of a step seed by Box-Muller from B1's draw 1
    of (rows, 2 cols): sqrt(-2 log(1 - u_a)) cos(2 pi u_b)."""
    u = hw_uniform(seed, (rows, 2 * cols), 1, device=device)
    return (torch.sqrt(-2.0 * torch.log1p(-u[:, :cols]))
            * torch.cos((2.0 * math.pi) * u[:, cols:]))


class MultVAE(RecsysModel):
    name = "MultVAE"

    def __init__(self, config: Optional[MultVAEConfig] = None,
                 device="cuda", **kw):
        self.device = resolve_device(device)
        self.cfg = config if config is not None else MultVAEConfig(**kw)

    # ------------------------------------------------------------- reset ----
    @phase("multvae.reset")
    def reset(self, data: Interactions, seed: int = 0) -> ModelState:
        cfg = self.cfg
        I, H, K = data.num_items, cfg.hidden_dim, cfg.latent_dim
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)

        def glorot(fan_in, fan_out):
            s = math.sqrt(6.0 / (fan_in + fan_out))
            u = torch.rand((fan_in, fan_out), generator=gen, device=dev)
            return u.mul_(2.0 * s).sub_(s)

        def bias(n):
            return torch.randn((n,), generator=gen, device=dev).mul_(1e-3)

        params: Dict[str, torch.Tensor] = {
            "W_q1": glorot(I, H), "b_q1": bias(H),
            "W_q2": glorot(H, 2 * K), "b_q2": bias(2 * K),
            "W_p1": glorot(K, H), "b_p1": bias(H),
            "W_p2": glorot(H, I), "b_p2": bias(I),
        }
        for name in LEAVES:
            params[name + "_m"] = torch.zeros_like(params[name])
            params[name + "_v"] = torch.zeros_like(params[name])
        state = ModelState(params=params, padded=None,
                           num_users=data.num_users, num_items=I)
        state.aux["data"] = data
        data.csr_on(dev, self._tensor)  # copied to the device in set-up
        return state

    # ------------------------------------------------------------- train ----
    def steps_per_epoch(self, state: ModelState) -> int:
        return -(-state.num_users // self.cfg.batch_size)

    @phase("multvae.pairs")
    def _epoch_pairs(self, state: ModelState, perm: np.ndarray) -> _Pairs:
        """The epoch's rated pairs on the device, its users in the order
        ``perm``: one gather of the CSR and a few passes over its N pairs,
        so that each step slices its batch."""
        B, I = self.cfg.batch_size, state.num_items
        data = state.aux["data"]
        indptr, indices = data.csr_on(self.device, self._tensor)
        lengths = np.diff(data.csr().indptr)[perm]
        ptr = np.zeros(len(perm) + 1, np.int64)
        np.cumsum(lengths, out=ptr[1:])
        N = int(ptr[-1])
        d_perm = self._tensor(perm.astype(np.int64))
        d_len = indptr[d_perm + 1] - indptr[d_perm]
        d_ptr = torch.zeros(len(perm) + 1, dtype=torch.int64,
                            device=self.device)
        torch.cumsum(d_len, 0, out=d_ptr[1:])
        user = torch.repeat_interleave(
            torch.arange(len(perm), device=self.device), d_len,
            output_size=N)
        src = torch.arange(N, device=self.device) - d_ptr[user]
        src += indptr[d_perm][user]
        items = indices[src].long()
        rows = user % B
        first = torch.div(torch.arange(len(perm), device=self.device), B,
                          rounding_mode="floor") * B
        lengths_f = d_len.to(torch.float32)
        coef = torch.rsqrt(lengths_f.clamp(min=1.0)) * (
            1.0 / (1.0 - self.cfg.dropout))
        most = max((int(ptr[min(s + B, len(perm))] - ptr[s])
                    for s in range(0, len(perm), B)), default=0)
        return _Pairs(items=items, rows=rows, flat=rows * I + items,
                      coef=coef[user], offsets=d_ptr[:-1] - d_ptr[first],
                      lengths=lengths_f,
                      ones=torch.ones(most, device=self.device), ptr=ptr)

    def train_one_iteration(self, state: ModelState, seed: int = 0,
                            steps: Optional[int] = None) -> ModelState:
        """One epoch: the users in the epoch's permutation, ``batch_size``
        a step; ``state.step`` counts the epochs, so the update count t
        (the KL weight's and Adam's) is ``state.step`` times the steps of
        an epoch plus the step's index. ``steps``: only the epoch's first
        ``steps`` updates, a prefix after which ``state.step`` stays as it
        was."""
        cfg = self.cfg
        U = state.num_users
        n = self.steps_per_epoch(state)
        t0 = state.step * n
        pairs = self._epoch_pairs(state, permutation(seed, state.step, U))
        # Adam's step counts t + 1 of the epoch's updates, one view a step
        counts = torch.arange(t0 + 1, t0 + n + 1, dtype=torch.float32,
                              device=self.device)
        batches = _batch_users(U, cfg.batch_size)
        with span("multvae.epoch"):
            for j, (a, b) in enumerate(batches[:steps]):
                s, e = int(pairs.ptr[a]), int(pairs.ptr[b])
                with span("multvae.step"):
                    _train_step(
                        state.params, pairs.items[s:e], pairs.rows[s:e],
                        pairs.flat[s:e], pairs.coef[s:e],
                        pairs.offsets[a:b], pairs.lengths[a:b],
                        pairs.ones[:e - s],
                        step_seed(seed, state.step, j, 0),
                        beta=kl_weight(cfg, t0 + j), step_count=counts[j],
                        cfg=cfg)
        if steps is None:
            state.step += 1
        return state

    # -------------------------------------------------------------- loss ----
    def data_loss(self, state: ModelState, sample_size: int = 0) -> float:
        """The negative ELBO of the training rows, summed over users, at
        serving's settings (no dropout, z = mu) and the KL weight of the
        next update. ``sample_size`` is accepted and ignored."""
        beta = kl_weight(self.cfg, state.step * self.steps_per_epoch(state))
        total = 0.0
        for a, b in _batch_users(state.num_users, self.cfg.batch_size):
            uids = np.arange(a, b)
            items, mask = self._rated_rows(uids, self._tensor(uids),
                                           state.aux["data"])
            mu, logvar = _serve_encode(state.params, items, mask, self.cfg)
            nll = multinomial_nll(_decode(state.params, mu)[1], items, mask)
            kl = 0.5 * (-logvar + torch.exp(logvar) + mu * mu - 1.0)
            total += float(nll.sum() + beta * kl.sum())
        return total

    # ----------------------------------------------------------- scoring ----
    def batch_scores(self, state: ModelState, uids, rated_items, rated_mask):
        """(B, I) logits of the users' unperturbed rows (no dropout,
        z = mu)."""
        mu, _ = _serve_encode(state.params, self._tensor(rated_items),
                              self._tensor(rated_mask), self.cfg)
        return _decode(state.params, mu)[1]

    def predict(self, state: ModelState, users, items):
        users = np.asarray(users, dtype=np.int64)
        rated, mask = self._rated_rows(users, self._tensor(users),
                                       state.aux["data"])
        scores = self.batch_scores(state, users, rated, mask)
        return scores[torch.arange(len(users), device=self.device),
                      self._tensor(items, torch.long)]


# ============================================================ functions ====

def _batch_users(num_users: int, batch_size: int):
    """(first, end) of each batch's users in an epoch's order."""
    return [(a, min(a + batch_size, num_users))
            for a in range(0, num_users, batch_size)]


def _encode(params, items, offsets, weights, cfg: MultVAEConfig):
    """(h, mu, logvar) of the encoder over rated pairs: ``items`` with
    their input values ``weights`` (x~), either 1-D with the users'
    first pairs ``offsets`` or (B, L) padded rows (``offsets`` None)."""
    h = torch.tanh(F.embedding_bag(items, params["W_q1"], offsets,
                                   mode="sum", per_sample_weights=weights)
                   + params["b_q1"])
    enc = torch.addmm(params["b_q2"], h, params["W_q2"])
    K = cfg.latent_dim
    return h, enc[:, :K], enc[:, K:]


def _serve_encode(params, items, mask, cfg: MultVAEConfig):
    """(mu, logvar) of padded (B, L) rated rows at serving's settings:
    x / |x| without dropout."""
    n = mask.sum(dim=1, dtype=torch.float32)
    x = torch.rsqrt(n.clamp(min=1.0))[:, None] * mask
    _, mu, logvar = _encode(
        params, items.long().clamp(max=params["W_q1"].shape[0] - 1), None,
        x, cfg)
    return mu, logvar


def _decode(params, z):
    """(g, logits (B, I)) of latent codes ``z``."""
    g = torch.tanh(torch.addmm(params["b_p1"], z, params["W_p1"]))
    return g, torch.addmm(params["b_p2"], g, params["W_p2"])


def _step_draws(seed: int, P: int, B: int, cfg: MultVAEConfig, device):
    """A step's draws: the (P,) dropout keep mask of its rated pairs and
    the (B, latent_dim) normals eps."""
    keep = hw_uniform(seed, (1, P), 0, device=device)[0] > cfg.dropout
    return keep, gaussian(seed, B, cfg.latent_dim, device)


def _gradients(params, fwd, items, rows, flat, x, lengths, ones, eps,
               beta: float) -> Dict[str, torch.Tensor]:
    """Every table's gradient of the batch's loss from its forward pass
    ``fwd`` = (h, mu, logvar, std, z, g, logits) over the B users of
    ``lengths``: the multinomial NLL over the whole (B, I) slab and beta
    times the KL term, each a mean over the users. W_q1's rows are summed
    at the kept rated ``items`` (input values ``x``, 0 where dropped) by
    B8."""
    p = params
    h, mu, logvar, std, z, g, logits = fwd
    B, I = logits.shape
    d = multinomial_gradient(logits, lengths, flat, ones, 1.0 / B)
    grads = {"W_p2": g.t() @ d, "b_p2": d.sum(dim=0)}
    dg = (d @ p["W_p2"].t()).mul_(1.0 - g * g)
    grads["W_p1"] = z.t() @ dg
    grads["b_p1"] = dg.sum(dim=0)
    dz = dg @ p["W_p1"].t()
    # the KL term's: beta / B * (mu, (exp(logvar) - 1) / 2)
    kl = beta / B
    denc = torch.cat([
        torch.add(dz, mu, alpha=kl),
        dz * eps * std * 0.5 + (0.5 * kl) * (torch.exp(logvar) - 1.0),
    ], dim=1)
    grads["W_q2"] = h.t() @ denc
    grads["b_q2"] = denc.sum(dim=0)
    dh = (denc @ p["W_q2"].t()).mul_(1.0 - h * h)
    grads["b_q1"] = dh.sum(dim=0)
    # a fixed order of sums: the same bits on every run; a dropped pair
    # (x 0) takes the id I, past every row, so the sum never reads it
    kept = torch.where(x > 0, items, I)
    grads["W_q1"] = scatter_matmul(
        kept, dh.index_select(0, rows).mul_(x[:, None]), I,
        plan=scatter_plan(kept, I))
    return grads


def _train_step(params, items, rows, flat, coef, offsets, lengths, ones,
                seed: int, *, beta: float, step_count: torch.Tensor,
                cfg: MultVAEConfig) -> None:
    """One update from a batch of B users and their P rated pairs (the
    epoch's slices: ``items``, each pair's batch ``rows``, ``flat`` =
    rows * I + items, the user's ``coef`` 1 / (|x| (1 - q)) at each pair;
    the users' first pairs ``offsets`` and rated counts ``lengths``),
    in place on ``params``: forward, the loss's gradient over the whole
    (B, I) slab, every table's gradient from the parameters before the
    step, then one Adam call over the 8 tables. ``beta`` is the step's KL
    weight, ``step_count`` (a device scalar) Adam's t + 1."""
    p = params
    B, P = offsets.shape[0], items.shape[0]
    with span("multvae.step.encode"):
        keep, eps = _step_draws(seed, P, B, cfg, items.device)
        x = coef * keep
        h, mu, logvar = _encode(p, items, offsets, x, cfg)
        std = torch.exp(0.5 * logvar)
        z = torch.addcmul(mu, eps, std)
    with span("multvae.step.decode"):
        g, logits = _decode(p, z)
    with span("multvae.step.loss"):
        count("decode_cells", logits.numel())
        grads = _gradients(p, (h, mu, logvar, std, z, g, logits), items,
                           rows, flat, x, lengths, ones, eps, beta)
    with span("multvae.step.update"):
        # each element: the table and both moments read and written, the
        # float32 gradient read
        count("table_bytes", 28 * sum(p[k].numel() for k in LEAVES))
        dense_adam_steps(
            [(p[k], grads[k], p[k + "_m"], p[k + "_v"]) for k in LEAVES],
            step_count, lr=cfg.learn_rate, beta1=cfg.beta1,
            beta2=cfg.beta2, eps=cfg.eps)

"""Alternating least squares: ALS and WRMF (port of cdae_tpu/models/als.py;
ref als.hpp, wrmf.hpp).

One iteration solves, for every user u, the d x d normal equations over
that user's observed items

  ALS:   (lambda*I + sum_{i in R_u} y_i y_i^T)          x_u = sum r_ui y_i
  WRMF:  (lambda*I + sum_{i in R_u} (s*r_ui) y_i y_i^T)  x_u = sum (s*r_ui) y_i

then the same for every item against the updated user factors. Each side
runs in chunks of ``solve_batch`` rows: one gather of the chunk's padded
rows, the Grams and right-hand sides as batched matmuls (f32; TF32 stays
off), and one batched solve -- Cholesky for ALS, for WRMF the
adaptive-jitter Cholesky (``ridge``) or the noise-floor-truncated
eigendecomposition (``eigh``). Rows with no observations, and the pad rows
of the last chunk, keep their old factors (ref als.hpp:110-121). The padded
sides are staged on the device once, at reset; an iteration is a host loop
over the chunks with no readback.

A factorization that fails (a Gram that is not positive definite) gives
NaN rows, as ``jnp.linalg.cholesky`` does: ``cholesky_ex`` reports the
failure on the device instead of raising, so no chunk waits for the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from cdae_tpu_torch.data.dataset import Interactions, PaddedUserBatch
from cdae_tpu_torch.models.base import ModelState, RecsysModel, resolve_device
from cdae_tpu_torch.ops.losses import Loss
from cdae_tpu_torch.ops.penalties import Penalty

W_SOLVERS = ("ridge", "eigh")


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    """cdae_tpu's ALSConfig (ref als.hpp:10-16, wrmf.hpp:10-18).
    ``solve_batch``: rows per batched solve. ``w_solver``: WRMF's solve,
    "ridge" (Cholesky with the jitter 16*eps*D*max diag(A)) or "eigh"
    (directions below the Gram's f32 noise floor dropped)."""

    lambda_: float = 0.01
    scalar: float = 40.0  # WRMF confidence scale (ref wrmf.hpp:13)
    loss: str = "SQUARE"
    penalty: str = "L2"
    num_dim: int = 10
    solve_batch: int = 4096
    w_solver: str = "ridge"
    dtype: Any = torch.float32


def _cholesky_solve(A: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve; a matrix whose factorization fails gives NaN."""
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info > 0)[:, None, None], float("nan"), L)
    return torch.cholesky_solve(rhs[..., None], L)[..., 0]


def _solve_side_math(Y: torch.Tensor, idx: torch.Tensor,
                     ratings: torch.Tensor, mask: torch.Tensor, lam: float,
                     scalar: float, weighted: bool,
                     w_solver: str = "eigh") -> torch.Tensor:
    """The normal-equation solve of one chunk of one sweep side: ``idx``
    (B, L) the rows' other-side ids (pad >= len(Y)), ``ratings`` and
    ``mask`` (B, L); returns the (B, D) solutions (cdae_tpu's
    ``_solve_side_math``).

    WRMF's confidences make the data eigenvalues of A dwarf lambda by ~1e8,
    so in f32 a row with fewer than D observations has pure-rounding
    directions whose right-hand-side noise 1/lambda would amplify each
    sweep. ``ridge`` adds mu = 16*eps*D*max diag(A) to the diagonal, which
    caps that at noise/mu; ``eigh`` drops every direction whose data
    eigenvalue lies below 16*eps*w_max."""
    D = Y.shape[1]
    rows = Y[idx.clamp(0, Y.shape[0] - 1).long()]  # (B, L, D)
    m = mask.to(Y.dtype)
    c = (scalar * ratings * m) if weighted else m  # per-entry A-weights
    A = torch.bmm((rows * c[..., None]).transpose(1, 2), rows)
    eye = torch.eye(D, dtype=Y.dtype, device=Y.device)
    A = A + lam * eye
    rhs_w = (scalar * ratings * m) if weighted else (ratings * m)
    rhs = torch.bmm(rhs_w[:, None, :], rows)[:, 0]
    if not weighted:
        return _cholesky_solve(A, rhs)
    eps = torch.finfo(Y.dtype).eps
    if w_solver == "ridge":
        mu = 16.0 * eps * D * torch.diagonal(A, dim1=-2, dim2=-1).amax(-1)
        return _cholesky_solve(A + mu[:, None, None] * eye, rhs)
    w, V = torch.linalg.eigh(A)  # ascending; w >= lam in exact arithmetic
    proj = torch.bmm(rhs[:, None, :], V)[:, 0]  # V^T rhs
    noise = 16.0 * eps * w[:, -1:]
    keep = (w - lam) > noise
    inv = torch.where(keep, 1.0 / torch.clamp(w, min=lam), 0.0)
    return torch.bmm(V, (proj * inv)[..., None])[..., 0]


def _sweep(X: torch.Tensor, Y: torch.Tensor, side, lam: float,
           scalar: float, weighted: bool, w_solver: str) -> torch.Tensor:
    """Every chunk of one sweep side (cdae_tpu's ``_sweep_scan``): rows with
    no observations and pad rows past N keep their old factors."""
    idx_k, ratings_k, mask_k, lengths_k, N = side
    k, bs, _ = idx_k.shape
    Xp = torch.cat([X, X.new_zeros((k * bs - X.shape[0], X.shape[1]))])
    pos = torch.arange(bs, device=X.device)
    for j in range(k):
        solved = _solve_side_math(Y, idx_k[j], ratings_k[j], mask_k[j], lam,
                                  scalar, weighted, w_solver)
        start = j * bs
        keep = (lengths_k[j] > 0) & ((start + pos) < N)
        Xp[start:start + bs] = torch.where(keep[:, None], solved,
                                           Xp[start:start + bs])
    return Xp[: X.shape[0]]


def _als_iteration(p, q, user_side, item_side, lam, scalar, weighted,
                   w_solver="eigh"):
    """One iteration: the user sweep, then the item sweep against the
    UPDATED user factors (ref als.hpp:100-107)."""
    p = _sweep(p, q, user_side, lam, scalar, weighted, w_solver)
    q = _sweep(q, p, item_side, lam, scalar, weighted, w_solver)
    return p, q


class ALS(RecsysModel):
    """Implicit-feedback ALS (ref als.hpp)."""

    name = "ALS"
    weighted = False

    def __init__(self, config: Optional[ALSConfig] = None, device="cuda",
                 **kw):
        self.device = resolve_device(device)
        self.cfg = config if config is not None else ALSConfig(**kw)
        if self.cfg.w_solver not in W_SOLVERS:
            raise ValueError(f"unknown w_solver {self.cfg.w_solver!r}; "
                             f"expected one of {W_SOLVERS}")
        self.loss = Loss.create(self.cfg.loss)
        self.penalty = Penalty.create(self.cfg.penalty)

    def reset(self, data: Interactions, seed: int = 0) -> ModelState:
        U, I, D = data.num_users, data.num_items, self.cfg.num_dim
        gen = torch.Generator(device=self.device).manual_seed(seed)
        dt = self.cfg.dtype

        def uniform(shape):  # U(-0.001, 0.001) (ref als.hpp:47-48)
            u = torch.rand(shape, generator=gen, dtype=torch.float32,
                           device=self.device)
            return (u * 0.002 - 0.001).to(dt)

        state = ModelState(params={"p": uniform((U, D)),
                                   "q": uniform((I, D))},
                           padded=data.padded(), num_users=U, num_items=I)
        # item-side view: per-item padded user lists (ref als.hpp:52-53)
        by_item = data.by_item().padded()
        state.aux["by_item"] = by_item
        state.aux["dev_user_side"] = self._stage_side(state.padded)
        state.aux["dev_item_side"] = self._stage_side(by_item)
        return state

    def _stage_side(self, pb: PaddedUserBatch):
        """A side's padded rows on the device, chunked (k, solve_batch, L)
        with pad rows (pad id, rating 0, mask off, length 0) past N."""
        bs = self.cfg.solve_batch
        N = pb.num_users
        k = max(-(-N // bs), 1)
        pad = k * bs - N

        def padrows(a, fill=0, dtype=None):
            if pad > 0:
                shape = (pad,) + a.shape[1:]
                a = np.concatenate([a, np.full(shape, fill, a.dtype)])
            return self._tensor(a.reshape((k, bs) + a.shape[1:]), dtype)

        return (padrows(pb.items, pb.num_items, torch.int32),
                padrows(pb.ratings, 0, self.cfg.dtype),
                padrows(pb.mask, False),
                padrows(pb.lengths, 0, torch.int32),
                N)

    def train_one_iteration(self, state: ModelState, seed: int = 0
                            ) -> ModelState:
        params = state.params
        params["p"], params["q"] = _als_iteration(
            params["p"], params["q"], state.aux["dev_user_side"],
            state.aux["dev_item_side"], self.cfg.lambda_, self.cfg.scalar,
            self.weighted, w_solver=self.cfg.w_solver)
        state.step += 1
        return state

    def data_loss(self, state, sample_size: int = 0) -> float:
        return 0.0  # ref als.hpp uses base data_loss; wrmf.hpp:59-61 0

    def penalty_loss(self, state) -> float:
        p = state.params
        return float(self.cfg.lambda_ * (self.penalty.evaluate(p["p"])
                                         + self.penalty.evaluate(p["q"])))

    def batch_scores(self, state, uids, rated_items, rated_mask):
        p = state.params
        return p["p"][self._tensor(uids, torch.long)] @ p["q"].T

    def predict(self, state, users, items):
        p = state.params
        return torch.sum(p["p"][self._tensor(users, torch.long)]
                         * p["q"][self._tensor(items, torch.long)], dim=-1)


class WRMF(ALS):
    """Weighted-regularized MF: confidence s*r on observed entries
    (ref wrmf.hpp:66-100)."""

    name = "WRMF"
    weighted = True

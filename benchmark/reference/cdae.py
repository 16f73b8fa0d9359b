"""Plain PyTorch reference of CDAE training and serving (Wu et al., WSDM
2016), for the benchmark's correctness check.

Written from the model's definition, not from the program's code: no
kernels, no row aggregation plans, no batching caches. It imports only
torch and numpy, and takes from the benchmark the data, the initial
weights and the configuration; every random draw it needs it works out
again from the seed, through the counter hash and the step-seed mix
below (the streams the program is specified to draw from).

Model: h = scale * sum_{i kept} W_i + b + Wu_u, z = sigmoid(h) (1 above
18, 0 below -18), y_o = W_o . z + b'_o (tied decoder). Training corrupts
each rated item (kept where its uniform exceeds q, scaled 1/(1-q)), takes
negatives, and applies AdaGrad (acc += g^2, p -= lr g / (beta +
sqrt(acc))) once a minibatch; every gradient is taken from the
parameters before the step. The per-touch L2 term lambda * param is added
at every positive and negative touch.

- Sparse step (``sparse_step``): each user's rated items are its
  positives; the negatives are ``num_neg`` draws per padded position,
  each the r-th unrated item of the user for r uniform over the unrated
  count, live at the user's real positions.
- Dense step (``dense_step``): positives are the (B, I) 0/1 rows;
  each unrated item is a negative with probability
  min(1, num_neg |O_u| / (I - |O_u|)).

The check's control is this reference in the precision below float32:
with ``tf32=True`` the operands of every sum of products (``@``,
``einsum``, and the values that ``index_add_`` sums, a product with a
one-hot matrix) are rounded to TF32's 10-bit mantissa, to nearest with
ties to even, and summed in float32, as tensor cores in TF32 do. The
rounding is explicit, so it reaches the batched matrix-vector products
that the backend's TF32 switch does not, and reads the same on any
device.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

ADAGRAD_INIT = 1e-4
MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1
NEG_SALT = 0x5EED0001  # the integer draws of the sparse step's negatives
HASH_ROW, HASH_COL = 0x9E3779B9, 0x85EBCA77
HASH_M1, HASH_M2 = 0x85EBCA6B, 0xC2B2AE35


# -------------------------------------------------------- precision -----

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties to even."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = b + (0xFFF + ((b >> 13) & 1))
    return (b & ~0x1FFF).view(torch.float32)


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def operands(tf32: bool):
    """What a product's operands go through: ``tf32_round`` or nothing."""
    return tf32_round if tf32 else _same


# ------------------------------------------------------------ draws -----

def _mix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def step_seed(seed: int, epoch: int, batch: int, corruption: int) -> int:
    """The signed 32-bit seed of one step: splitmix64 of the run seed,
    then of each coordinate in turn, high half."""
    x = _mix64(seed & MASK64)
    for v in (epoch, batch, corruption):
        x = _mix64(x ^ (v & MASK64))
    x >>= 32
    return x - (1 << 32) if x >= (1 << 31) else x


def _times(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for 0 <= x < 2**32 held in int64: m in 16-bit
    halves, so that no product passes 2**48."""
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & MASK32


def hash_uniform(seed: int, rows: int, cols: int, draw: int,
                 device) -> torch.Tensor:
    """(rows, cols) uniforms: the low 24 bits of a murmur-style mix of
    (seed, row, col, draw) in wrapping 32-bit arithmetic, times 2**-24."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    x = (_times(r, HASH_ROW) + _times(c, HASH_COL)
         + ((seed & MASK32) + draw * HASH_M2)) & MASK32
    x = _times(x ^ (x >> 16), HASH_M1)
    x = _times(x ^ (x >> 13), HASH_M2)
    x = x ^ (x >> 16)
    return (x & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))


def hash_randint(seed: int, salt: int, rows: int, cols: int,
                 maxval: torch.Tensor) -> torch.Tensor:
    """Integers in [0, maxval) per row: floor(u * maxval) in float32,
    at most maxval - 1, from the uniforms of seed XOR salt (draw 0)."""
    s = (seed ^ salt) & MASK32
    u = hash_uniform(s, rows, cols, 0, maxval.device)
    m = maxval.reshape(-1, 1)
    return torch.minimum((u * m.to(torch.float32)).to(torch.int64), m - 1)


# ------------------------------------------------------------- data -----

class Rows:
    """Each user's rated items, ascending (CSR), from (user, item) pairs
    sorted by user."""

    def __init__(self, users: np.ndarray, items: np.ndarray, num_users: int,
                 num_items: int):
        order = np.lexsort((items, users))
        self.items = np.ascontiguousarray(items[order], dtype=np.int64)
        counts = np.bincount(users, minlength=num_users)
        self.indptr = np.concatenate([[0], np.cumsum(counts)])
        self.lengths = counts.astype(np.int64)
        self.num_users, self.num_items = num_users, num_items

    def padded(self, uids: np.ndarray, width: int) -> np.ndarray:
        """(len(uids), width) rated items, padded with num_items."""
        out = np.full((len(uids), width), self.num_items, np.int64)
        for row, u in enumerate(uids):
            s, e = self.indptr[u], self.indptr[u + 1]
            out[row, :e - s] = self.items[s:e]
        return out

    def dense(self, uids: np.ndarray, device) -> torch.Tensor:
        """(len(uids), I) float32 0/1 rows."""
        lens = self.lengths[uids]
        rows = np.repeat(np.arange(len(uids)), lens)
        cols = np.concatenate([self.items[self.indptr[u]:self.indptr[u + 1]]
                               for u in uids]) if len(uids) else []
        out = torch.zeros((len(uids), self.num_items), device=device)
        out[torch.as_tensor(rows, device=device),
            torch.as_tensor(np.asarray(cols, np.int64), device=device)] = 1.0
        return out


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def sparse_batches(rows: Rows, batch_size: int
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
    """An epoch of the sparse step: users by ascending row length (ties
    by id), ``batch_size`` at a time, the last batch filled with user 0 at
    weight 0; each batch padded to the power of two of its longest row,
    at most the longest row of all. Yields (uids, weight, width)."""
    order = np.argsort(rows.lengths, kind="stable")
    longest = max(int(rows.lengths.max()), 1)
    for start in range(0, rows.num_users, batch_size):
        uids = order[start:start + batch_size]
        weight = np.ones(batch_size, np.float32)
        if len(uids) < batch_size:
            weight[len(uids):] = 0.0
            uids = np.concatenate([uids, np.zeros(batch_size - len(uids),
                                                  uids.dtype)])
        real = rows.lengths[uids] * (weight > 0)
        yield uids, weight, min(_pow2(max(int(real.max()), 1)), longest)


def dense_batches(num_users: int, batch_size: int
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """An epoch of the dense step: users in id order, ``batch_size`` at a
    time, the last batch wrapped round to user 0 at weight 0."""
    k = -(-num_users // batch_size)
    ids = np.arange(k * batch_size)
    for j in range(k):
        sl = ids[j * batch_size:(j + 1) * batch_size]
        yield sl % num_users, (sl < num_users).astype(np.float32)


# ------------------------------------------------------------ model -----

def _act(h: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(h)
    return torch.where(h > 18.0, 1.0, torch.where(h < -18.0, 0.0, s))


def loss_gradient(loss: str, pred: torch.Tensor, truth) -> torch.Tensor:
    """d loss / d pred: SQUARE (truth - pred)^2; LOGISTIC -t log p -
    (1-t) log(1-p) with p = pred clipped to [1e-7, 1 - 1e-7]."""
    if loss == "SQUARE":
        return -2.0 * (truth - pred)
    if loss == "LOGISTIC":
        p = torch.clamp(pred, 1e-7, 1.0 - 1e-7)
        return (p - truth) / (p * (1.0 - p))
    raise ValueError(f"the reference has no loss {loss!r}")


def check_config(cfg: Dict) -> None:
    """The options this reference covers."""
    fixed = dict(asymmetric=False, linear=False, tanh=False,
                 linear_function=False, user_factor=True, num_corruptions=1,
                 using_adagrad=True, neg_pool=None)
    for key, want in fixed.items():
        if cfg.get(key, want) != want:
            raise ValueError(f"the reference covers {key}={want} only")


def _adagrad(p: torch.Tensor, a: torch.Tensor, g: torch.Tensor, lr: float,
             beta: float) -> None:
    a += g * g
    p -= lr * g / (beta + torch.sqrt(a))


def _user_rows_step(P, A, uids, weight, hg, cfg) -> None:
    """AdaGrad on the live users' Wu rows (each live user once a batch)."""
    live = weight > 0
    u = uids[live]
    g = hg[live] + cfg["lambda_"] * P["Wu"][u]
    A["Wu"][u] += g * g
    P["Wu"][u] -= cfg["learn_rate"] * g / (cfg["beta"]
                                           + torch.sqrt(A["Wu"][u]))


def _apply(P, A, grads: Dict[str, torch.Tensor], cfg) -> None:
    for name, g in grads.items():
        _adagrad(P[name], A[name], g, cfg["learn_rate"], cfg["beta"])


def _nth_unrated(items: torch.Tensor, r: torch.Tensor, I: int
                 ) -> torch.Tensor:
    """The r-th (from 0) unrated item of each row, r (B, M); ``items``
    (B, L) rated ids padded with I."""
    rated = torch.zeros((items.shape[0], I + 1), dtype=torch.bool,
                        device=items.device)
    rated.scatter_(1, items, True)
    seen = torch.cumsum((~rated[:, :I]).to(torch.int64), dim=1)
    return torch.searchsorted(seen, r + 1)


def sparse_step(P, A, cfg: Dict, rows: Rows, uids: np.ndarray,
                weight: np.ndarray, width: int, seed: int,
                tf32: bool = False) -> None:
    """One sparse minibatch step, in place on P (params) and A (AdaGrad
    accumulators)."""
    op = operands(tf32)
    W = P["W"]
    dev = W.device
    I, D = W.shape
    q, lam = cfg["corruption_ratio"], cfg["lambda_"]
    scale = 1.0 / (1.0 - q) if cfg["scaled"] and q < 1.0 else 1.0
    items = torch.as_tensor(rows.padded(uids, width), device=dev)
    w = torch.as_tensor(weight, device=dev)
    uid = torch.as_tensor(uids, dtype=torch.int64, device=dev)
    lengths = torch.as_tensor(rows.lengths[uids], device=dev) * (w > 0)
    B, L = items.shape
    mask = (torch.arange(L, device=dev)[None, :] < lengths[:, None])
    mask_f = mask.float() * w[:, None]
    keep = mask & (hash_uniform(seed, B, L, 0, dev) > q) & (w > 0)[:, None]
    keep_f = keep.float()
    ic = items.clamp(max=I - 1)
    Wi, bpi = W[ic], P["b_prime"][ic]
    Wi_op = op(Wi)
    z = _act(torch.einsum("bld,bl->bd", Wi_op, keep_f) * scale + P["b"]
             + P["Wu"][uid])
    z_op = op(z)
    g_pos = loss_gradient(cfg["loss"], torch.einsum("bld,bd->bl", Wi_op, z_op)
                          + bpi, 1.0) * mask_f
    hidden = torch.einsum("bl,bld->bd", op(g_pos), Wi_op)
    gW = torch.zeros_like(W)
    gbp = torch.zeros_like(P["b_prime"])
    nneg = cfg["num_neg"]
    if nneg > 0:
        free = torch.clamp(I - lengths, min=1)
        neg = _nth_unrated(items, hash_randint(seed, NEG_SALT, B, nneg * L,
                                               free), I)
        for k in range(nneg):
            nk = neg[:, k * L:(k + 1) * L]
            live = mask & (nk < I)
            nc = nk.clamp(max=I - 1)
            Wn, bpn = W[nc], P["b_prime"][nc]
            Wn_op = op(Wn)
            gn = loss_gradient(cfg["loss"],
                               torch.einsum("bld,bd->bl", Wn_op, z_op)
                               + bpn, 0.0) * live.float()
            hidden = hidden + torch.einsum("bl,bld->bd", op(gn), Wn_op)
            at = live.reshape(-1)
            ids = nk.reshape(-1)[at]
            gW.index_add_(0, ids, op(((gn[..., None] * z[:, None, :]
                                       + lam * Wn) * mask_f[..., None])
                                     .reshape(-1, D)[at]))
            gbp.index_add_(0, ids,
                           op(((gn + lam * bpn) * mask_f).reshape(-1)[at]))
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


def dense_step(P, A, cfg: Dict, rows: Rows, uids: np.ndarray,
               weight: np.ndarray, seed: int, tf32: bool = False) -> None:
    """One full-catalog minibatch step, in place on P and A."""
    op = operands(tf32)
    W = P["W"]
    W_op = op(W)
    dev = W.device
    I, _ = W.shape
    q, lam = cfg["corruption_ratio"], cfg["lambda_"]
    scale = 1.0 / (1.0 - q) if cfg["scaled"] and q < 1.0 else 1.0
    w = torch.as_tensor(weight, device=dev)
    uid = torch.as_tensor(uids, dtype=torch.int64, device=dev)
    R = rows.dense(uids, dev) * w[:, None]
    B = R.shape[0]
    lengths = R.sum(dim=1)
    kept = R * (hash_uniform(seed, B, I, 0, dev) > q).float()
    z = _act((kept @ W_op) * scale + P["b"] + P["Wu"][uid])
    z_op = op(z)
    p_neg = torch.clamp(cfg["num_neg"] * lengths
                        / torch.clamp(I - lengths, min=1.0), 0.0, 1.0)
    neg = (1.0 - R) * (hash_uniform(seed, B, I, 1, dev)
                       < p_neg[:, None]).float() * w[:, None]
    touched = R + neg
    g = loss_gradient(cfg["loss"], z_op @ W_op.t() + P["b_prime"],
                      R) * touched
    touches = touched.sum(dim=0)
    g_op = op(g)
    hg = (g_op @ W_op) * (z - z * z)
    grads = {
        "W": (g_op.t() @ z_op + kept.t() @ op(hg * scale)
              + lam * touches[:, None] * W),
        "b_prime": g.sum(dim=0) + lam * touches * P["b_prime"],
        "b": w @ op(hg) + w.sum() * lam * P["b"],
    }
    _apply(P, A, grads, cfg)
    _user_rows_step(P, A, uid, w, hg, cfg)


def train_epoch(P: Dict[str, torch.Tensor], cfg: Dict, rows: Rows,
                dense: bool, seed: int, epoch: int = 0,
                drop_half: bool = False,
                tf32: bool = False) -> Dict[str, torch.Tensor]:
    """One epoch from parameters P (updated in place); returns the AdaGrad
    accumulators. ``drop_half``: a planted fault, the second half of each
    batch left out (its weight set to 0); ``tf32``: the control's
    precision."""
    check_config(cfg)
    A = {k: torch.full_like(v, ADAGRAD_INIT) for k, v in P.items()}
    B = cfg["batch_size"]
    if dense:
        batches = ((u, w, None) for u, w in dense_batches(rows.num_users, B))
    else:
        batches = sparse_batches(rows, B)
    for j, (uids, weight, width) in enumerate(batches):
        if drop_half:
            weight = weight.copy()
            weight[len(weight) // 2:] = 0.0
        s = step_seed(seed, epoch, j, 0)
        if dense:
            dense_step(P, A, cfg, rows, uids, weight, s, tf32=tf32)
        else:
            sparse_step(P, A, cfg, rows, uids, weight, width, s, tf32=tf32)
    return A


def scores(P: Dict[str, torch.Tensor], rows: Rows, uids: np.ndarray,
           tf32: bool = False) -> torch.Tensor:
    """(B, I) serving scores from the uncorrupted rated rows (scale 1),
    rated items at -inf; ``tf32``: the control's precision."""
    op = operands(tf32)
    W = op(P["W"])
    dev = W.device
    I = W.shape[0]
    width = max(int(rows.lengths[uids].max()), 1)
    items = torch.as_tensor(rows.padded(uids, width), device=dev)
    mask = (items < I).float()
    uid = torch.as_tensor(uids, dtype=torch.int64, device=dev)
    z = _act(torch.einsum("bld,bl->bd", W[items.clamp(max=I - 1)], mask)
             + P["b"] + P["Wu"][uid])
    s = op(z) @ W.t() + P["b_prime"]
    ext = torch.cat([s, s.new_zeros((s.shape[0], 1))], dim=1)
    ext.scatter_(1, items, float("-inf"))
    return ext[:, :I]


def grad_norms(acc: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's gradient norm, sqrt(sum of g^2), from its AdaGrad
    accumulator after a pass from ADAGRAD_INIT."""
    return {k: float(torch.sqrt(torch.clamp(
        (v.to(torch.float64) - ADAGRAD_INIT), min=0.0).sum()))
        for k, v in acc.items()}

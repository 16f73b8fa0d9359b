"""AdaGrad-style updates (port of cdae_tpu/solver/optimizer.py).

Per-coordinate AdaGrad with accumulators initialized at 1e-4 and the step
``lr * g / (beta + sqrt(acc))``, accumulated over a synchronous user
minibatch and applied once per batch.

Unlike cdae_tpu's pure functions, every update here writes into ``param``
and ``acc`` IN PLACE and returns the same two tensors: the (I, D) tables are
the large state of a training run, and a copy per step would double its
memory traffic. Callers that need the old values ``clone()`` them first.
Row ids must lie in [0, N): cdae_tpu's scatters drop out-of-range rows,
``index_add_`` raises on them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cdae_tpu_torch.ops import pallas_kernels

ADAGRAD_INIT = 1e-4


def adagrad_update(
    param: torch.Tensor,
    acc: torch.Tensor,
    grad: torch.Tensor,
    learn_rate: float,
    beta: float = 0.0,
    use_adagrad: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense AdaGrad step in the parameter's dtype. Zero-gradient
    coordinates are untouched."""
    if use_adagrad:
        acc += grad * grad
        param -= learn_rate * grad / (beta + torch.sqrt(acc))
    else:
        param -= learn_rate * grad
    return param, acc


def adagrad_row_update(
    param: torch.Tensor,  # (N, D) or (N,)
    acc: torch.Tensor,
    rows: torch.Tensor,  # (B,) row ids -- unique within the batch
    grad_rows: torch.Tensor,  # (B, D) or (B,)
    row_weight: torch.Tensor,  # (B,) 0/1 -- padded batch rows get 0
    learn_rate: float,
    beta: float = 0.0,
    use_adagrad: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse row-wise AdaGrad step by delta-add: zero-weight (padding)
    rows add zero, so a padding row that repeats a live id cannot clobber
    its update."""
    w = row_weight.to(param.dtype)
    w = w.reshape((-1,) + (1,) * (grad_rows.dim() - 1))
    g = grad_rows * w
    if use_adagrad:
        gsq = g * g
        a_rows = acc[rows] + gsq
        acc.index_add_(0, rows, gsq)
        step = learn_rate * g / (beta + torch.sqrt(a_rows))
    else:
        step = learn_rate * g
    param.index_add_(0, rows, -step * (w > 0))
    return param, acc


def dense_adagrad_step(
    param: torch.Tensor,
    acc: torch.Tensor,
    grad: torch.Tensor,
    learn_rate: float,
    beta: float = 0.0,
    use_adagrad: bool = True,
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accumulate-then-apply AdaGrad with f32 optimizer arithmetic: the
    accumulator is f32, a bf16 param round-trips through f32. The shared
    dense update of every model.

    ``use_kernel`` (the model's ``use_pallas``) sends the AdaGrad sweep
    through the ``adagrad_update`` wrapper of ops/pallas_kernels.py: its
    CUDA kernel for a CUDA tensor, its plain version for a CPU tensor."""
    g32 = grad.to(torch.float32)
    if use_adagrad:
        sweep = (pallas_kernels.adagrad_update if use_kernel
                 else pallas_kernels.adagrad_update_plain)
        return sweep(param, acc, g32, learn_rate, beta)
    param.copy_(param.to(torch.float32) - learn_rate * g32)
    return param, acc


def row_adagrad_delta(
    param: torch.Tensor,  # (N, ...) table
    acc: torch.Tensor,
    rows: torch.Tensor,  # (B,) row ids; batch padding may DUPLICATE live ids
    grad_rows: torch.Tensor,  # (B, ...) per-row grads (already weighted)
    live,  # (B, ...) bool broadcastable to grad_rows
    learn_rate: float,
    beta: float = 0.0,
    use_adagrad: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse per-row AdaGrad by delta-add, f32 optimizer math.

    Duplicate ids get SEQUENTIAL accumulator semantics within the call:
    touch i of a row sees acc plus the g^2 of the earlier touches of that
    row, an exclusive segmented prefix computed over one stable sort, as in
    the reference's per-touch loop. The prefix is the difference of two
    exclusive cumsums -- exactly 0 at a row's first touch -- clamped at 0:
    f32 cancellation could make a later one slightly negative, which would
    swamp the 1e-4 accumulator init and NaN the sqrt. (cdae_tpu subtracts
    g^2 back out of the inclusive cumsum, which leaves rounding noise of
    the size of the whole running sum on every touch.)"""
    g32 = grad_rows.to(torch.float32)
    live = torch.as_tensor(live, device=g32.device)
    if not use_adagrad:
        delta = torch.where(live, -learn_rate * g32, 0.0).to(param.dtype)
        param.index_add_(0, rows, delta)
        return param, acc
    gsq = torch.where(live, g32 * g32, 0.0)
    n = rows.shape[0]
    order = torch.argsort(rows, stable=True)
    r_s = rows[order]
    q_s = gsq[order]
    # exclusive running g^2 in sort order: a shifted copy of the cumsum, so
    # a row's first touch gets exactly 0 (no f32 cancellation there)
    excl = torch.zeros_like(q_s)
    excl[1:] = torch.cumsum(q_s, dim=0)[:-1]
    idx = torch.arange(n, device=rows.device)
    is_start = torch.ones(n, dtype=torch.bool, device=rows.device)
    is_start[1:] = r_s[1:] != r_s[:-1]
    start_idx = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    excl_prefix = torch.clamp(excl - excl[start_idx], min=0.0)
    a_rows_s = acc[r_s] + excl_prefix + q_s
    step_s = learn_rate * g32[order] / (beta + torch.sqrt(a_rows_s))
    live_s = live[order] if live.dim() else live
    delta_s = torch.where(live_s, -step_s, 0.0).to(param.dtype)
    param.index_add_(0, r_s, delta_s)
    acc.index_add_(0, rows, gsq)
    return param, acc


def inverse_time_decay(lr0: float, reg: float, steps):
    """SGD learn-rate schedule lr0 / (1 + lr0*reg*steps) (off by
    default)."""
    return lr0 / (1.0 + lr0 * reg * steps)

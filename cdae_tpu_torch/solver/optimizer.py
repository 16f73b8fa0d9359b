"""AdaGrad-style updates (port of cdae_tpu/solver/optimizer.py), and the
Adam update of Mult-VAE's tables (``dense_adam_steps``, the port's own).

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

from typing import Optional, Sequence, Tuple

import torch

from cdae_tpu_torch.ops import pallas_kernels
from cdae_tpu_torch.ops.scatter import row_plan, runs_b8, scatter_add_rows

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


def dense_adagrad_steps(
    tables: Sequence[pallas_kernels.AdagradTable],
    learn_rate: float,
    beta: float = 0.0,
    use_adagrad: bool = True,
    use_kernel: bool = False,
) -> None:
    """Accumulate-then-apply AdaGrad over a step's dense (param, acc, grad)
    tables, in place, with f32 optimizer arithmetic: the accumulator is
    f32, a bf16 param round-trips through f32. The shared dense update of
    every model.

    ``use_kernel`` (the model's ``use_pallas``) sends the AdaGrad sweep
    through the ``adagrad_update_tables`` wrapper of ops/pallas_kernels.py:
    one launch of its CUDA kernel for CUDA tensors, its plain version for
    CPU tensors. The kernel updates the tables at once, so every grad must
    be computed (from the pre-update tables) before the call."""
    f32 = torch.float32
    tables = [(p, a, g if g.dtype == f32 else g.to(f32)) for p, a, g in tables]
    if use_adagrad:
        sweep = (pallas_kernels.adagrad_update_tables if use_kernel
                 else pallas_kernels.adagrad_update_tables_plain)
        sweep(tables, learn_rate, beta)
        return
    for param, _, g32 in tables:
        param.copy_(param.to(f32) - learn_rate * g32)


def dense_adam_steps(
    tables: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]],
    step_count: torch.Tensor,
    *,
    lr: float,
    beta1: float,
    beta2: float,
    eps: float,
) -> None:
    """One Adam update of every (param, grad, m, v) table, in place, in
    PyTorch's form: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, then
    p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps), no weight
    decay. One ``torch._fused_adam_`` call over the tables -- the
    multi-tensor kernel of ``torch.optim.Adam(fused=True)`` on a CUDA
    device -- with ``step_count`` (a float32 scalar on the tables' device
    holding t, 1 at the first update) read by every table; the caller
    advances it."""
    params, grads, ms, vs = (list(x) for x in zip(*tables))
    torch._fused_adam_(params, grads, ms, vs, [], [step_count] * len(params),
                       lr=lr, beta1=beta1, beta2=beta2, weight_decay=0.0,
                       eps=eps, amsgrad=False, maximize=False)


def dense_adagrad_step(
    param: torch.Tensor,
    acc: torch.Tensor,
    grad: torch.Tensor,
    learn_rate: float,
    beta: float = 0.0,
    use_adagrad: bool = True,
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dense_adagrad_steps`` on one table; returns (param, acc)."""
    dense_adagrad_steps(((param, acc, grad),), learn_rate, beta, use_adagrad,
                        use_kernel)
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
    mode: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse per-row AdaGrad by delta-add, f32 optimizer math.

    Duplicate ids get SEQUENTIAL accumulator semantics within the call:
    touch i of a row sees acc plus the g^2 of the earlier touches of that
    row, an exclusive segmented prefix computed over one stable sort, as in
    the reference's per-touch loop. The prefix is the difference of two
    exclusive f64 cumsums -- exactly 0 at a row's first touch, and free of
    the f32 rounding of the whole batch's running sum at later ones --
    clamped at 0. (cdae_tpu subtracts g^2 back out of an f32 inclusive
    cumsum, which leaves rounding noise of the size of the whole running
    sum on every touch.)

    ``mode`` (an ops/scatter.py mode) sums the deltas and g^2 of each row
    where ``runs_b8`` says so -- kernel B8 on a CUDA device, so the sums
    run in a fixed order and the update is the same bits on every run --
    over one plan of the touches' segment numbers; each row then takes
    one add. Without it, or for a mode that does not run B8, the touches
    are ``index_add_``-ed one by one (atomics on the card)."""
    g32 = grad_rows.to(torch.float32)
    live = torch.as_tensor(live, device=g32.device)
    b8 = mode is not None and runs_b8(mode, rows.device)
    if not use_adagrad and not b8:
        delta = torch.where(live, -learn_rate * g32, 0.0).to(param.dtype)
        param.index_add_(0, rows, delta)
        return param, acc
    n = rows.shape[0]
    order = torch.argsort(rows, stable=True)
    r_s = rows[order]
    is_start = torch.ones(n, dtype=torch.bool, device=rows.device)
    is_start[1:] = r_s[1:] != r_s[:-1]
    live_s = live[order] if live.dim() else live
    if use_adagrad:
        gsq = torch.where(live, g32 * g32, 0.0)
        q_s = gsq[order]
        # exclusive running g^2 in sort order, in f64: a shifted copy of
        # the cumsum, so a row's first touch gets exactly 0, and a later
        # touch its row's own earlier g^2 without the f32 rounding of the
        # whole batch's running sum
        excl = torch.zeros(q_s.shape, dtype=torch.float64,
                           device=q_s.device)
        excl[1:] = torch.cumsum(q_s, dim=0, dtype=torch.float64)[:-1]
        idx = torch.arange(n, device=rows.device)
        start_idx = torch.cummax(torch.where(is_start, idx, 0),
                                 dim=0).values
        excl_prefix = torch.clamp(excl - excl[start_idx], min=0.0).to(
            torch.float32)
        a_rows_s = acc[r_s] + excl_prefix + q_s
        step_s = learn_rate * g32[order] / (beta + torch.sqrt(a_rows_s))
    else:
        step_s = learn_rate * g32[order]
    delta_s = torch.where(live_s, -step_s, 0.0)
    if not b8:
        param.index_add_(0, r_s, delta_s.to(param.dtype))
        acc.index_add_(0, rows, gsq)
        return param, acc
    # segment k of the sorted touches is row head[k]; the segments past the
    # last are zero sums added to row 0 (exact no-ops)
    seg = torch.cumsum(is_start, dim=0) - 1
    head = torch.zeros_like(r_s).index_put_((seg,), r_s)
    plan = row_plan(seg, n, mode)
    updates = [(param, delta_s)] + ([(acc, q_s)] if use_adagrad else [])
    for table, vals in updates:
        sums = scatter_add_rows(
            torch.zeros(vals.shape, dtype=torch.float32, device=vals.device),
            seg, vals, mode=mode, plan=plan)
        table.index_add_(0, head, sums.to(table.dtype))
    return param, acc


def inverse_time_decay(lr0: float, reg: float, steps):
    """SGD learn-rate schedule lr0 / (1 + lr0*reg*steps) (off by
    default)."""
    return lr0 / (1.0 + lr0 * reg * steps)

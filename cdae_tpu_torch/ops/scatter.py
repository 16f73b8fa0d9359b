"""Row aggregation ``out[n] = base[n] + sum_{p : idx[p] == n} vals[p]``
(port of cdae_tpu/ops/scatter.py).

cdae_tpu offers several strategies for this sum because TPU scatters
serialize: one-hot matmuls on the MXU (``matmul``, ``factored``,
``factored_bf16``), a sort + segment sum (``sort``), the native scatter
(``scatter``) and the Pallas one-hot kernel (``pallas``, ``pallas_bf16``,
kernel B8). They all compute the same row sum. On the GPU the ``pallas``
modes are B8's hand-written segment sum (``scatter_matmul``: its kernel on
a CUDA tensor, its plain version on a CPU tensor), whose sums run in a
fixed order; every other mode is one ``index_add``, whose sums on the card
run in no fixed order. ``pallas_bf16`` and ``factored_bf16`` round the
contributions to bf16 first, as their bf16 operands do; ``pallas`` keeps
them f32, as cdae_tpu passes ``vals_dtype=vals.dtype``. A step that sums
several value sets over one id vector (or its prefixes) builds one
``row_plan`` and passes it to each call; it is None for the ``index_add``
modes, which need none.

Ids outside [0, N) contribute nothing, as in cdae_tpu (its callers use
id == N as a dead-slot sentinel); ``index_add_`` would raise on them, so
they are masked first.
"""

from __future__ import annotations

from typing import Optional

import torch

from cdae_tpu_torch.ops.pallas_kernels import (ScatterPlan, scatter_matmul,
                                                scatter_plan)

MODES = ("auto", "factored", "factored_bf16", "pallas", "pallas_bf16",
         "matmul", "sort", "scatter")
_KERNEL_MODES = ("pallas", "pallas_bf16")


def row_plan(idx: torch.Tensor, num_rows: int, mode: str
             ) -> Optional[ScatterPlan]:
    """B8's plan of ``idx`` over ``num_rows`` rows for the ``pallas``
    modes (one per id vector of a step), None for the others."""
    if mode not in MODES:
        raise ValueError(f"unknown scatter mode {mode!r}")
    if mode not in _KERNEL_MODES:
        return None
    return scatter_plan(idx.reshape(-1).long().contiguous(), num_rows)


def scatter_add_rows(base: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor, *, mode: str = "auto",
                     plan: Optional[ScatterPlan] = None) -> torch.Tensor:
    """``base`` plus the rows of ``vals`` (P, D) or (P,) summed at ``idx``
    (P,); returns a new tensor of ``base``'s dtype. ``mode`` names
    cdae_tpu's strategy: the ``pallas`` modes are kernel B8, every other
    one is one ``index_add`` here. ``plan``: ``row_plan`` of an id vector
    whose first P entries are ``idx`` (the ``pallas`` modes only)."""
    if mode not in MODES:
        raise ValueError(f"unknown scatter mode {mode!r}")
    n = base.shape[0]
    idx = idx.reshape(-1).long()
    if mode in _KERNEL_MODES:
        agg = scatter_matmul(
            idx.contiguous(), vals.to(torch.float32).contiguous(), n,
            bf16=mode == "pallas_bf16" or vals.dtype == torch.bfloat16,
            plan=plan)
        return (base + agg).to(base.dtype)
    valid = (idx >= 0) & (idx < n)
    if mode == "factored_bf16":
        vals = vals.to(torch.bfloat16).to(base.dtype)
    keep = valid.reshape((-1,) + (1,) * (vals.dim() - 1))
    vals = torch.where(keep, vals.to(base.dtype), 0.0)
    return base.index_add(0, torch.where(valid, idx, 0), vals)

"""Row aggregation ``out[n] = base[n] + sum_{p : idx[p] == n} vals[p]``
(port of cdae_tpu/ops/scatter.py).

cdae_tpu offers several strategies for this sum because TPU scatters
serialize: one-hot matmuls on the MXU (``matmul``, ``factored``,
``factored_bf16``), a sort + segment sum (``sort``), the native scatter
(``scatter``) and the Pallas one-hot kernel (``pallas``, ``pallas_bf16``,
kernel B8). They all compute the same row sum, and all but ``scatter`` sum
in a fixed order. On the GPU B8's hand-written segment sum
(``scatter_matmul``) keeps that promise, so on a CUDA tensor every mode but
``scatter`` runs B8: its sums run in a fixed order, and a step (and a
resumed run, ``--init_checkpoint``) is reproducible bit for bit on the card.
``scatter`` stays one ``index_add``, whose sums on the card run in no fixed
order, as cdae_tpu's native scatter. (cdae_tpu's FISM pins its Pallas
aggregation, B8, on a TPU, where it measured fastest; here B8 is the mode
whose order is fixed, and FISM's default ``auto`` reaches it through this
routing.) ``pallas_bf16`` and ``factored_bf16`` round the contributions to
bf16 first, as their bf16 operands do; the other modes keep them f32, as
cdae_tpu passes ``vals_dtype=vals.dtype``.

On a CPU tensor the ``pallas`` modes are B8's plain version and every other
mode is one ``index_add`` into ``base``; both sum each row in ascending p.
A step that sums several value sets over one id vector (or its prefixes)
builds one ``row_plan`` and passes it to each call; it is None where the
mode runs ``index_add``.

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
_BF16_MODES = ("pallas_bf16", "factored_bf16")


def runs_b8(mode: str, device: torch.device) -> bool:
    """Whether ``mode`` sums with kernel B8 (or, on the CPU, its plain
    version) on ``device``: the ``pallas`` modes everywhere, and on a CUDA
    device every fixed-order mode (all but ``scatter``)."""
    if mode not in MODES:
        raise ValueError(f"unknown scatter mode {mode!r}")
    if mode in _KERNEL_MODES:
        return True
    return mode != "scatter" and torch.device(device).type == "cuda"


def row_plan(idx: torch.Tensor, num_rows: int, mode: str
             ) -> Optional[ScatterPlan]:
    """B8's plan of ``idx`` over ``num_rows`` rows where ``mode`` runs B8
    on ``idx``'s device (one per id vector of a step), else None."""
    if not runs_b8(mode, idx.device):
        return None
    return scatter_plan(idx.reshape(-1).long().contiguous(), num_rows)


def scatter_add_rows(base: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor, *, mode: str = "auto",
                     plan: Optional[ScatterPlan] = None) -> torch.Tensor:
    """``base`` plus the rows of ``vals`` (P, D) or (P,) summed at ``idx``
    (P,); returns a new tensor of ``base``'s dtype. ``mode`` names
    cdae_tpu's strategy; ``runs_b8`` says which run kernel B8, the rest are
    one ``index_add``. ``plan``: ``row_plan`` of an id vector whose first P
    entries are ``idx`` (B8 only)."""
    n = base.shape[0]
    idx = idx.reshape(-1).long()
    if runs_b8(mode, vals.device):
        agg = scatter_matmul(
            idx.contiguous(), vals.to(torch.float32).contiguous(), n,
            bf16=mode in _BF16_MODES or vals.dtype == torch.bfloat16,
            plan=plan)
        return (base + agg).to(base.dtype)
    valid = (idx >= 0) & (idx < n)
    if mode == "factored_bf16":
        vals = vals.to(torch.bfloat16).to(base.dtype)
    keep = valid.reshape((-1,) + (1,) * (vals.dim() - 1))
    vals = torch.where(keep, vals.to(base.dtype), 0.0)
    return base.index_add(0, torch.where(valid, idx, 0), vals)

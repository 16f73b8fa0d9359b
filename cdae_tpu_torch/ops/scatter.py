"""Row aggregation ``out[n] = base[n] + sum_{p : idx[p] == n} vals[p]``
(port of cdae_tpu/ops/scatter.py).

cdae_tpu offers several strategies for this sum because TPU scatters
serialize: one-hot matmuls on the MXU (``matmul``, ``factored``,
``factored_bf16``), a sort + segment sum (``sort``), the native scatter
(``scatter``) and the Pallas one-hot kernel (``pallas``, ``pallas_bf16``,
kernel B8). They all compute the same row sum, so on the GPU every mode
but the Pallas ones is one ``index_add``; ``factored_bf16`` still rounds
the contributions to bf16 first, as its bf16 operands do.

Ids outside [0, N) contribute nothing, as in cdae_tpu (its callers use
id == N as a dead-slot sentinel); ``index_add_`` would raise on them, so
they are masked first. The ``pallas`` modes are kernel B8, which is not
ported yet (ROADMAP B8): they raise rather than reroute.
"""

from __future__ import annotations

import torch

MODES = ("auto", "factored", "factored_bf16", "pallas", "pallas_bf16",
         "matmul", "sort", "scatter")

_B8 = (
    "scatter_add_rows mode {mode!r} is kernel B8 (cdae_tpu "
    "scatter_matmul), which is not ported to cdae_tpu_torch yet (ROADMAP "
    "B8); every other mode computes the same sum"
)


def scatter_add_rows(base: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor, *, mode: str = "auto"
                     ) -> torch.Tensor:
    """``base`` plus the rows of ``vals`` (P, D) or (P,) summed at ``idx``
    (P,); returns a new tensor. ``mode`` names cdae_tpu's strategy (all
    but the B8 modes are one ``index_add`` here)."""
    if mode in ("pallas", "pallas_bf16"):
        raise NotImplementedError(_B8.format(mode=mode))
    if mode not in MODES:
        raise ValueError(f"unknown scatter mode {mode!r}")
    n = base.shape[0]
    idx = idx.reshape(-1).long()
    valid = (idx >= 0) & (idx < n)
    if mode == "factored_bf16":
        vals = vals.to(torch.bfloat16).to(base.dtype)
    keep = valid.reshape((-1,) + (1,) * (vals.dim() - 1))
    vals = torch.where(keep, vals.to(base.dtype), 0.0)
    return base.index_add(0, torch.where(valid, idx, 0), vals)

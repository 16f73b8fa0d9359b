"""Operations, bytes and the least times they allow on one NVIDIA H100.

Peaks are NVIDIA's published figures for the H100 SXM at its 700 W limit
(dense, no sparsity): 3.35 TB/s of HBM, 495 TFLOP/s of TF32 products on the
tensor cores (the card's highest dense rate for float32 operands, so a
share of it cannot pass 100%), 67 TFLOP/s of other float32 operations.

``train_user_flops`` and ``serve_flops`` count what a cell's inputs need,
whatever route computes them. The kernel counts take the arguments of one
call of a kernel's wrapper (as ``trace.Census`` records them) and return
its bytes, its products and its other operations: each input read once
and each output written once.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12
F32_OPS_PER_S = 67e12


def least_seconds(nbytes: float, products: float = 0.0,
                  other_ops: float = 0.0) -> float:
    """The least time for work that moves ``nbytes`` through HBM, does
    ``products`` multiply-add operations (counted as 2 each already) on
    the tensor cores and ``other_ops`` elsewhere: the larger of the
    byte time and the operation time."""
    return max(nbytes / HBM_BYTES_PER_S,
               products / TF32_FLOPS_PER_S + other_ops / F32_OPS_PER_S)


# --------------------------------------------------- model FLOPs ---------

def train_user_flops(n_rated: np.ndarray, num_dim: int, num_neg: int,
                     corruption_ratio: float) -> np.ndarray:
    """Needed FLOPs of one training step per user with ``n_rated``
    positives: the encoder over the kept positives (2 k D), the hidden
    layer (4 D: bias, activation, its derivative, the gradient's product),
    the decoder at the positives and at num_neg * n negatives with its
    two gradients (3 x 2 (n + negatives) D), and the encoder's gradient
    at the kept positives (2 k D). Expected counts: k = (1 - q) n kept,
    num_neg * n negatives, on every route."""
    n = np.asarray(n_rated, dtype=np.float64)
    kept = (1.0 - corruption_ratio) * n
    touched = n * (1 + num_neg)
    return num_dim * (4.0 * kept + 6.0 * touched + 4.0)


def serve_flops(n_rated: np.ndarray, num_items: int,
                num_dim: int) -> float:
    """Needed FLOPs of scoring users with ``n_rated`` rated items over the
    whole catalog: the encoder (2 n D), the hidden layer (2 D) and the
    decode (2 I D) of each."""
    n = np.asarray(n_rated, dtype=np.float64)
    return float(np.sum(num_dim * (2.0 * n + 2.0 + 2.0 * num_items)))


# --------------------------------------------- kernel work by wrapper ----

def _numel(shape: Iterable[int]) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def _nbytes(t) -> int:
    return _numel(t.shape) * t.element_size()


def hw_uniform(a: Dict) -> Dict:
    """B1: (rows, cols) float32 uniforms from a 32-bit hash, about 16
    integer operations an element."""
    n = _numel(a["shape"])
    return dict(bytes=4 * n, products=0.0, ops=16.0 * n)


def decode_scores(a: Dict) -> Dict:
    """B3: (B, I) = z (B, D) @ W^T + b'; 2 B I D products."""
    B, D = a["z"].shape
    I = a["W"].shape[0]
    return dict(bytes=4 * (B * D + I * D + I + B * I),
                products=2.0 * B * I * D, ops=float(B * I))


def _topk(a: Dict, rated) -> Dict:
    B, D = a["z"].shape
    I = a["W"].shape[0]
    k = int(a["k"])
    return dict(bytes=4 * (B * D + I * D + I) + _nbytes(rated) + 8 * B * k,
                products=2.0 * B * I * D, ops=float(B * I))


def fused_topk_scores(a: Dict) -> Dict:
    """B6 over int8 rated rows: decode, mask and top-k, no (B, I) out."""
    return _topk(a, a["rated_rows"])


def fused_topk_scores_csr(a: Dict) -> Dict:
    """B6 over sorted padded rated ids."""
    return _topk(a, a["rated_items"])


def adagrad_tables(a: Dict) -> Dict:
    """B2 over a list of (param, acc, grad) tables: each read, param and
    acc written; 7 operations an element."""
    nbytes, ops = 0, 0.0
    for param, acc, grad in a["tables"]:
        n = _numel(param.shape)
        nbytes += 2 * _nbytes(param) + 2 * _nbytes(acc) + _nbytes(grad)
        ops += 7.0 * n
    return dict(bytes=nbytes, products=0.0, ops=ops)


def scatter_plan(a: Dict) -> Dict:
    """B8's plan: P int64 ids in; P int32 positions and N + 1 int32
    segment starts out."""
    P = _numel(a["idx"].shape)
    N = int(a["num_rows"])
    return dict(bytes=8 * P + 4 * P + 4 * (N + 1), products=0.0,
                ops=float(P))


def scatter_matmul(a: Dict) -> Dict:
    """B8's reduce: P rows of C float32 values, their P positions and
    N + 1 segment starts in, (N, C) sums out; one add a value."""
    vals = a["vals"]
    P = vals.shape[0]
    C = 1 if vals.dim() == 1 else vals.shape[1]
    N = int(a["num_rows"])
    return dict(bytes=4 * P * C + 4 * P + 4 * (N + 1) + 4 * N * C,
                products=0.0, ops=float(P * C))


def gather_rows_mxu(a: Dict) -> Dict:
    """B9: P int64 ids in, P rows of D read and written."""
    P = _numel(a["idx"].shape)
    D = a["table"].shape[1]
    row = a["table"].element_size() * D
    return dict(bytes=8 * P + 2 * P * row, products=0.0, ops=0.0)


def cdae_dense_step_fused(a: Dict) -> Dict:
    """B4, the fused dense step, by its bytes: the int8 (B, I) rows, W and
    its accumulator and b' and its accumulator read and written, the
    (B, D) hidden bias in and hidden gradient out."""
    B, I = a["rows_int8"].shape
    D = a["W"].shape[1]
    return dict(bytes=B * I + 16 * I * D + 16 * I + 8 * B * D + 12 * B,
                products=0.0, ops=0.0)


# wrapper name -> (count function, the CUDA kernels it launches)
KERNELS = {
    "hw_uniform": (hw_uniform, ("hw_uniform_kernel",)),
    "decode_scores": (decode_scores, ("decode_scores_kernel",)),
    "fused_topk_scores": (fused_topk_scores,
                          ("fused_topk_kernel", "merge_topk_kernel")),
    "fused_topk_scores_csr": (fused_topk_scores_csr,
                              ("fused_topk_kernel", "merge_topk_kernel")),
    "_adagrad_launch": (adagrad_tables, ("adagrad_tables_kernel",)),
    "scatter_plan": (scatter_plan, ("radix_hist_kernel", "radix_pass_kernel",
                                    "segment_offsets_kernel")),
    "scatter_matmul": (scatter_matmul, ("scatter_reduce_kernel",)),
    "gather_rows_mxu": (gather_rows_mxu, ("gather_rows_kernel",)),
    "cdae_dense_step_fused": (cdae_dense_step_fused,
                              ("encode_kernel", "encode_finalize",
                               "decode_kernel", "decode_finalize",
                               "grads_kernel")),
}


def call_least_seconds(wrapper: str, args: Dict) -> Optional[float]:
    """The least time of one call of ``wrapper`` with ``args``, or None
    for a wrapper without a count."""
    entry = KERNELS.get(wrapper)
    if entry is None:
        return None
    w = entry[0](args)
    return least_seconds(w["bytes"], w["products"], w["ops"])

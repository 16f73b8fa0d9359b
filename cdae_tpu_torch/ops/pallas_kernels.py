"""The serving kernels, each beside its plain PyTorch version.

Port of the serving part of cdae_tpu/ops/pallas_kernels.py:

  decode_scores          z @ W^T + b'                    csrc/decode_scores.cu
  fused_topk_scores      decode + rated mask (int8 rows) csrc/fused_topk.cu
                         + top-k, no (B, I) scores
  fused_topk_scores_csr  the same, rated exclusion from  csrc/fused_topk.cu
                         sorted padded CSR rows
  streaming_topk_scores  plain torch loop over catalog blocks (an XLA scan in
                         cdae_tpu, not a kernel); the reference both fused
                         top-k kernels are held against

Every kernel wrapper routes by the device of the tensors it is given: on a
CUDA tensor it launches the hand-written kernel (built from
cdae_tpu_torch/csrc on first use) or raises; on a CPU tensor it runs the
plain version. There is no fallback from one to the other. Each wrapper
counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch

from cdae_tpu_torch.ops.topk import stable_topk

NEG = -3.0e38  # cdae_tpu's "excluded" score for rated and padded columns
_MAX_K = 32  # one warp holds a user's running top-k, one entry per lane


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
             device: torch.device) -> None:
    """Raise unless ``t`` is what a kernel takes: device, dtype, shape
    (None = any extent) and C-contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if any(n >= 2**31 for n in t.shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}; the kernels "
                         "take 32-bit extents")


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for {t.device}")
    return t.device.type == "cuda"


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ------------------------------------------------------------- decode ------

def decode_scores_plain(z: torch.Tensor, W: torch.Tensor,
                        b_prime: torch.Tensor) -> torch.Tensor:
    """(B, I) = z @ W^T + b' in one library GEMM (the reference)."""
    return torch.addmm(b_prime, z, W.t())


def decode_scores(z: torch.Tensor, W: torch.Tensor,
                  b_prime: torch.Tensor) -> torch.Tensor:
    """(B, I) decoder scores z @ W^T + b' for z (B, D), W (I, D), b' (I,),
    all float32."""
    if not _on_cuda(z):
        return decode_scores_plain(z, W, b_prime)
    from cdae_tpu_torch.ops import cuda_lib

    B, D = z.shape
    I = W.shape[0]
    _require(z, "z", torch.float32, (B, D), z.device)
    _require(W, "W", torch.float32, (I, D), z.device)
    _require(b_prime, "b_prime", torch.float32, (I,), z.device)
    out = torch.empty((B, I), dtype=torch.float32, device=z.device)
    if B == 0 or I == 0:
        return out
    rc = cuda_lib.lib().cdae_decode_scores(
        z.data_ptr(), W.data_ptr(), b_prime.data_ptr(), out.data_ptr(),
        B, I, D, _stream(z.device),
    )
    cuda_lib.check(rc, "decode_scores")
    decode_scores.launches += 1
    return out


decode_scores.launches = 0


# ---------------------------------------------------- blockwise top-k -------

def _blockwise_topk(
    z: torch.Tensor, W: torch.Tensor, b_prime: torch.Tensor, k: int,
    block: int, rated_in: Callable[[int, int], torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain blockwise decode + top-k: decode ``block`` catalog items at a
    time, set ``rated_in(start, stop)`` (a (B, stop-start) bool) to -inf,
    and merge into the running (B, k) top-k. Empty slots are (-inf, I)."""
    B = z.shape[0]
    I = W.shape[0]
    run_v = z.new_full((B, k), float("-inf"))
    run_i = torch.full((B, k), I, dtype=torch.int64, device=z.device)
    for start in range(0, I, block):
        stop = min(start + block, I)
        s = torch.addmm(b_prime[start:stop], z, W[start:stop].t())
        s = s.masked_fill(rated_in(start, stop), float("-inf"))
        ids = torch.arange(start, stop, device=z.device).expand(B, -1)
        # running entries first: on equal scores they hold the lower ids
        vals, idx = stable_topk(torch.cat([run_v, s], dim=1), k)
        run_v = vals
        run_i = torch.cat([run_i, ids], dim=1).gather(1, idx)
    return run_i.to(torch.int32), run_v


def streaming_topk_scores(
    z: torch.Tensor,  # (B, D) hidden codes
    W: torch.Tensor,  # (I, D) decoder table
    b_prime: torch.Tensor,  # (I,)
    rated_items: torch.Tensor,  # (B, L) rated ids, padded with >= I
    k: int = 10,
    block: int = 16384,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k unrated items without materializing (B, I) scores: a loop over
    catalog blocks of ``block`` items. Returns (ids (B, k) int32, vals
    (B, k)); slots beyond a row's unrated items are (-inf, I)."""
    B = z.shape[0]

    def rated_in(start: int, stop: int) -> torch.Tensor:
        n = stop - start
        local = rated_items.long() - start
        col = torch.where((local >= 0) & (local < n), local, n)
        hit = torch.zeros((B, n + 1), dtype=torch.bool, device=z.device)
        return hit.scatter_(1, col, True)[:, :n]

    return _blockwise_topk(z, W, b_prime, k, block, rated_in)


def _neg_tail(ids: torch.Tensor, vals: torch.Tensor, num_items: int,
              block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Turn empty (-inf, I) slots into what cdae_tpu's fused Pallas kernels
    return for a row with fewer than k unrated items: the score NEG, and the
    id that their k max-extraction rounds over a ``block``-wide catalog walk
    keep re-selecting -- the row's best unrated item that lies before the
    last catalog block, or 0 when it has none."""
    empty = ids >= num_items
    last_start = (max(num_items - 1, 0) // block) * block
    early = ~empty & (ids < last_start)
    first = early.to(torch.int32).argmax(dim=1, keepdim=True)
    tail = torch.where(early.any(dim=1, keepdim=True), ids.gather(1, first),
                       0)
    return (torch.where(empty, tail, ids),
            torch.where(empty, torch.full_like(vals, NEG), vals))


# ------------------------------------------------- fused decode + top-k -----

def _check_k(k: int) -> None:
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"k={k}: the fused top-k kernels take 1 <= k <= "
                         f"{_MAX_K}")


def _fused_topk_launch(z, W, b_prime, rated, k: int, csr: bool):
    """Launch csrc/fused_topk.cu on CUDA tensors -> (ids, vals) with empty
    slots as (-inf, I). ``rated``: (B, L) sorted int32 rows if ``csr``,
    else (B, I) int8 rows."""
    from cdae_tpu_torch.ops import cuda_lib

    dev = z.device
    B, D = z.shape
    I = W.shape[0]
    _require(z, "z", torch.float32, (B, D), dev)
    _require(W, "W", torch.float32, (I, D), dev)
    _require(b_prime, "b_prime", torch.float32, (I,), dev)
    if csr:
        _require(rated, "rated_items", torch.int32, (B, None), dev)
        entry, extra = "cdae_fused_topk_csr", (rated.shape[1],)
    else:
        _require(rated, "rated_rows", torch.int8, (B, I), dev)
        entry, extra = "cdae_fused_topk_dense", ()
    out_v = torch.full((B, k), float("-inf"), dtype=torch.float32, device=dev)
    out_i = torch.full((B, k), I, dtype=torch.int32, device=dev)
    if B == 0 or I == 0:
        return out_i, out_v
    # enough (user tile x catalog split) blocks to give every SM ~8
    tiles = _cdiv(I, 128)
    splits = max(1, min(tiles, _cdiv(8 * _num_sms(dev.index or 0),
                                     _cdiv(B, 32))))
    per_split = _cdiv(tiles, splits) * 128
    splits = _cdiv(I, per_split)
    part_v = torch.empty((B, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((B, splits, k), dtype=torch.int32, device=dev)
    rc = getattr(cuda_lib.lib(), entry)(
        z.data_ptr(), W.data_ptr(), b_prime.data_ptr(), rated.data_ptr(),
        *extra, part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), B, I, D, k, splits, per_split, _stream(dev),
    )
    cuda_lib.check(rc, entry)
    return out_i, out_v


def fused_topk_scores_plain(z, W, b_prime, rated_rows, k: int = 10,
                            block: int = 2048):
    """Plain version of ``fused_topk_scores``: the blockwise loop with the
    rated mask read from the int8 rows."""
    ids, vals = _blockwise_topk(
        z, W, b_prime, k, 16384,
        lambda start, stop: rated_rows[:, start:stop] > 0,
    )
    return _neg_tail(ids, vals, W.shape[0], block)


def fused_topk_scores(
    z: torch.Tensor,  # (B, D) hidden codes
    W: torch.Tensor,  # (I, D) decoder table
    b_prime: torch.Tensor,  # (I,)
    rated_rows: torch.Tensor,  # (B, I) int8 -- > 0 at rated (dense_R[uids])
    k: int = 10,
    block: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k unrated items per row by fused decode + top-k; returns (ids
    (B, k) int32, vals (B, k) float32). Larger score first, lower id first
    on equal scores. Slots beyond a row's unrated items hold NEG with
    cdae_tpu's tail id (``_neg_tail``); ``block`` is the catalog block of
    that convention only -- it does not shape the kernel."""
    _check_k(k)
    if not _on_cuda(z):
        return fused_topk_scores_plain(z, W, b_prime, rated_rows, k, block)
    ids, vals = _fused_topk_launch(z, W, b_prime, rated_rows, k, csr=False)
    fused_topk_scores.launches += 1
    return _neg_tail(ids, vals, W.shape[0], block)


fused_topk_scores.launches = 0


def _csr_overflow(rated_items: torch.Tensor, num_items: int, block: int,
                  w: int) -> torch.Tensor:
    """Device bool: some row holds more than ``w`` rated items inside one
    ``block``-wide catalog block. cdae_tpu's CSR kernel lists at most w
    rated items per (row, block) and answers such batches with its
    streaming scan instead."""
    nblk = _cdiv(num_items, block)
    valid = (rated_items >= 0) & (rated_items < num_items)
    blk = torch.where(valid, rated_items.long() // block, nblk)
    counts = torch.zeros((rated_items.shape[0], nblk + 1), dtype=torch.int32,
                         device=rated_items.device)
    counts.scatter_add_(1, blk, torch.ones_like(blk, dtype=torch.int32))
    return (counts[:, :nblk] > w).any()


def _csr_tail(ids, vals, rated_items, num_items: int, block: int, w: int):
    """Empty slots as cdae_tpu's CSR function returns them: (-inf, I) for a
    batch it answers with its streaming scan, its NEG tail otherwise."""
    neg_ids, neg_vals = _neg_tail(ids, vals, num_items, block)
    overflow = _csr_overflow(rated_items, num_items, block, w)
    return (torch.where(overflow, ids, neg_ids),
            torch.where(overflow, vals, neg_vals))


def fused_topk_scores_csr_plain(z, W, b_prime, rated_items, k: int = 10,
                                block: int = 4096, w: int = 8):
    """Plain version of ``fused_topk_scores_csr``: the streaming scan."""
    ids, vals = streaming_topk_scores(z, W, b_prime, rated_items, k=k)
    return _csr_tail(ids, vals, rated_items, W.shape[0], block, w)


def fused_topk_scores_csr(
    z: torch.Tensor,  # (B, D) hidden codes
    W: torch.Tensor,  # (I, D) decoder table
    b_prime: torch.Tensor,  # (I,)
    rated_items: torch.Tensor,  # (B, L) int32 sorted ascending, pad >= I
    k: int = 10,
    block: int = 4096,
    w: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_topk_scores`` with the rated exclusion read from sorted,
    padded CSR rows -- no (B, I) mask anywhere. The kernel walks each row's
    rated list as the catalog advances, so any number of rated items per
    block is exact. ``block`` and ``w`` only reproduce cdae_tpu's output
    for rows with fewer than k unrated items: a batch it would route to its
    streaming scan (``_csr_overflow``) keeps the (-inf, I) tail, any other
    gets the NEG tail."""
    _check_k(k)
    if not _on_cuda(z):
        return fused_topk_scores_csr_plain(z, W, b_prime, rated_items, k,
                                           block, w)
    ids, vals = _fused_topk_launch(z, W, b_prime, rated_items, k, csr=True)
    fused_topk_scores_csr.launches += 1
    return _csr_tail(ids, vals, rated_items, W.shape[0], block, w)


fused_topk_scores_csr.launches = 0

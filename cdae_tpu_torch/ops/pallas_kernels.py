"""The hand-written kernels, each beside its plain PyTorch version.

Port of cdae_tpu/ops/pallas_kernels.py (every Pallas kernel):

  decode_scores          z @ W^T + b'                    csrc/decode_scores.cu
  fused_topk_scores      decode + rated mask (int8 rows) csrc/fused_topk.cu
                         + top-k, no (B, I) scores
  fused_topk_scores_csr  the same, rated exclusion from  csrc/fused_topk.cu
                         sorted padded CSR rows
  streaming_topk_scores  plain torch loop over catalog blocks (an XLA scan in
                         cdae_tpu, not a kernel); the reference both fused
                         top-k kernels are held against
  hw_uniform             (rows, cols) uniforms in [0, 1) csrc/hw_uniform.cu
                         from a counter hash of (seed,
                         row, col, draw)
  adagrad_update         in-place a += g^2;              csrc/adagrad_update.cu
                         p -= lr*g/(beta+sqrt(a))
  warp_violator_select   WARP's per-row count of unrated csrc/warp_select.cu
                         items scoring above a threshold
                         + nn uniform picks among them
  scatter_plan           the ids sorted into per-row     csrc/scatter_rows.cu
                         segments (a stable radix sort),
                         shared by a step's sums
  scatter_matmul         out[n] = sum of vals[p] with    csrc/scatter_rows.cu
                         idx[p] == n over a plan's
                         segments (a fixed order, no
                         atomics)
  gather_rows_mxu        table[idx], zero rows for ids   csrc/gather_rows.cu
                         out of range

The fused dense train step (B4) has its own module, ops/cdae_fused.py.

Every kernel wrapper routes by the device of the tensors it is given: on a
CUDA tensor it launches the hand-written kernel (built from
cdae_tpu_torch/csrc on first use) or raises; on a CPU tensor it runs the
plain version. There is no fallback from one to the other. Each wrapper
counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

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
    """The raw handle of ``device``'s current stream, read as PyTorch's own
    kernel launchers read it: without building a ``torch.cuda.Stream``
    object on every launch, which costs more host time than the small
    kernels take on the card."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


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
    all float32. The kernel multiplies on the tensor cores in 3xTF32, which
    keeps f32-level accuracy (not bit-equal to the library GEMM)."""
    if not _on_cuda(z):
        return decode_scores_plain(z, W, b_prime)
    from cdae_tpu_torch.ops import cuda_lib

    B, D = z.shape
    I = W.shape[0]
    _require(z, "z", torch.float32, (B, D), z.device)
    _require(W, "W", torch.float32, (I, D), z.device)
    _require(b_prime, "b_prime", torch.float32, (I,), z.device)
    if B > 65535 * 128:
        raise ValueError(f"B={B}: the kernel takes B <= {65535 * 128}")
    out = torch.empty((B, I), dtype=torch.float32, device=z.device)
    if B == 0 or I == 0:
        return out
    # the widest copy of z and W rows (16, 8 or 4 bytes) that D and both
    # pointers allow
    zp, wp = z.data_ptr(), W.data_ptr()
    vec = next(v for v in (4, 2, 1)
               if D % v == 0 and zp % (4 * v) == 0 and wp % (4 * v) == 0)
    rc = cuda_lib.lib().cdae_decode_scores(
        zp, wp, b_prime.data_ptr(), out.data_ptr(), B, I, D, vec,
        _stream(z.device),
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


_TOPK_TILE_U = 128  # users per block of csrc/fused_topk.cu
_TOPK_TILE_I = 128  # catalog items per tile
_TOPK_WAVES = 2  # blocks per SM the grid aims at (two fit at D <= 64)


def fused_topk_grid(B: int, I: int, num_sms: int) -> Tuple[int, int]:
    """(splits, items_per_split) of csrc/fused_topk.cu's grid for B users
    and I items on a card of ``num_sms`` SMs: the catalog is cut into
    splits of whole 128-item tiles so that (user tiles of 128) x (splits)
    gives about _TOPK_WAVES blocks an SM; every split is non-empty."""
    tiles = _cdiv(I, _TOPK_TILE_I)
    user_tiles = _cdiv(B, _TOPK_TILE_U)
    splits = max(1, min(tiles, _cdiv(_TOPK_WAVES * num_sms, user_tiles)))
    per_split = _cdiv(tiles, splits) * _TOPK_TILE_I
    return _cdiv(I, per_split), per_split


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
    if B == 0 or I == 0:
        return (torch.full((B, k), I, dtype=torch.int32, device=dev),
                torch.full((B, k), float("-inf"), dtype=torch.float32,
                           device=dev))
    # the merge kernel writes every slot
    out_v = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    splits, per_split = fused_topk_grid(B, I, _num_sms(dev.index or 0))
    part_v = torch.empty((B, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((B, splits, k), dtype=torch.int32, device=dev)
    # the widest copy of z and W rows (16, 8 or 4 bytes) that D and both
    # pointers allow
    zp, wp = z.data_ptr(), W.data_ptr()
    vec = next(v for v in (4, 2, 1)
               if D % v == 0 and zp % (4 * v) == 0 and wp % (4 * v) == 0)
    rc = getattr(cuda_lib.lib(), entry)(
        zp, wp, b_prime.data_ptr(), rated.data_ptr(),
        *extra, part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), B, I, D, k, splits, per_split, vec, _stream(dev),
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


# ------------------------------------------------------------ uniforms ------

_MASK32 = 0xFFFFFFFF
# the murmur-style mixing constants of cdae_tpu/ops/cdae_fused.py
# _hash_uniform, as unsigned 32-bit values (its comment's 0x9E3779B1 is a
# typo: the constant it uses, -1640531527, is 0x9E3779B9)
_HASH_ROW = 0x9E3779B9
_HASH_COL = 0x85EBCA77
_HASH_M1 = 0x85EBCA6B
_HASH_M2 = 0xC2B2AE35


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for int64 x in [0, 2**32), without int64
    overflow: the high and low 16 bits of x are multiplied apart."""
    lo = (x & 0xFFFF) * m
    hi = ((x >> 16) * m) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def hw_uniform_plain(seed: int, shape: Tuple[int, int], draw: int = 0, *,
                     device) -> torch.Tensor:
    """Plain version of ``hw_uniform``: the same 32-bit arithmetic on int64
    tensors, masked to 32 bits (logical shifts, since every value is
    non-negative)."""
    rows, cols = shape
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    x = ((int(seed) & _MASK32) + _mul32(r, _HASH_ROW) + _mul32(c, _HASH_COL)
         + ((int(draw) * _HASH_M2) & _MASK32)) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, _HASH_M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _HASH_M2)
    x = x ^ (x >> 16)
    return (x & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))


def hw_uniform(seed: int, shape: Tuple[int, int], draw: int = 0, *,
               device) -> torch.Tensor:
    """(rows, cols) float32 uniforms in [0, 1) at 24-bit resolution, on
    ``device``. Element (r, c) is the low 24 bits of a murmur mix of
    (seed, r, c, draw), times 2**-24: a pure function of its coordinates,
    so any tiling draws the same numbers and the fused step (B4) regenerates
    exactly these masks. ``draw`` separates independent draws of one step
    (0: corruption, 1: negatives). cdae_tpu draws from the TPU's hardware
    PRNG here, whose bits cannot be reproduced; this is its tiling-invariant
    hash stream (cdae_tpu/ops/cdae_fused.py _hash_uniform), bit for bit."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for {device}")
    if device.type == "cpu":
        return hw_uniform_plain(seed, shape, draw, device=device)
    from cdae_tpu_torch.ops import cuda_lib

    rows, cols = shape
    if rows < 0 or cols < 0 or rows * cols >= 2**31:
        raise ValueError(f"hw_uniform shape {shape}: the kernel takes "
                         "0 <= rows*cols < 2**31")
    out = torch.empty((rows, cols), dtype=torch.float32, device=device)
    if rows * cols == 0:
        return out
    seed32 = ((int(seed) + 2**31) & _MASK32) - 2**31  # as a C int
    rc = cuda_lib.lib().cdae_hw_uniform(out.data_ptr(), rows, cols, seed32,
                                        int(draw), _stream(device))
    cuda_lib.check(rc, "hw_uniform")
    hw_uniform.launches += 1
    return out


hw_uniform.launches = 0


# ------------------------------------------------------------- adagrad ------

def adagrad_update_plain(param: torch.Tensor, acc: torch.Tensor,
                         grad: torch.Tensor, lr: float, beta: float = 0.0):
    """Plain version of ``adagrad_update``: a += g*g, then
    p -= lr*g / (beta + sqrt(a)) in f32, each operation rounded on its
    own (the kernel's order)."""
    acc += grad * grad
    step = lr * grad / (beta + torch.sqrt(acc))
    if param.dtype == torch.float32:
        param -= step
    else:
        param.copy_(param.to(torch.float32) - step)
    return param, acc


def adagrad_update(param: torch.Tensor, acc: torch.Tensor, grad: torch.Tensor,
                   lr: float, beta: float = 0.0):
    """One AdaGrad step IN PLACE over (N, D) or (N,): ``acc`` (f32) +=
    grad**2, then ``param`` (f32 or bf16, f32 arithmetic) -= lr * grad /
    (beta + sqrt(acc)). ``grad`` is f32. Returns (param, acc), the same
    tensors. Bit-equal to the plain version: the kernel rounds every
    operation on its own (no contracted FMA)."""
    if not _on_cuda(param):
        return adagrad_update_plain(param, acc, grad, lr, beta)
    from cdae_tpu_torch.ops import cuda_lib

    dev = param.device
    shape = tuple(param.shape)
    if param.dim() not in (1, 2):
        raise ValueError(f"param has shape {shape}; expected (N, D) or (N,)")
    if param.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"param has dtype {param.dtype}, expected float32 "
                        "or bfloat16")
    _require(param, "param", param.dtype, shape, dev)
    _require(acc, "acc", torch.float32, shape, dev)
    _require(grad, "grad", torch.float32, shape, dev)
    n = param.numel()
    if n >= 2**31:
        raise ValueError(f"param has {n} elements; the kernel takes < 2**31")
    if n == 0:
        return param, acc
    rc = cuda_lib.lib().cdae_adagrad_update(
        param.data_ptr(), acc.data_ptr(), grad.data_ptr(), n, float(lr),
        float(beta), int(param.dtype == torch.bfloat16), _stream(dev),
    )
    cuda_lib.check(rc, "adagrad_update")
    adagrad_update.launches += 1
    return param, acc


adagrad_update.launches = 0


# ----------------------------------------- WARP violator count + select ----

_MAX_NN = 32  # per-row selection slots the kernel keeps in registers
_MAX_WARP_D = 128
# csrc/warp_select.cu: its dynamic shared-memory limit (Hopper's opt-in
# 227 KB less 1 KB), its 128-column chunks and at most 63 of them a split
_WARP_SMEM_FLOATS = (232448 - 1024) // 4
_WARP_CHUNK = 128
_WARP_MAX_SPLIT = 63 * _WARP_CHUNK
# cdae_tpu's _warp_select_kernel constants as unsigned 32-bit values; C1
# multiplies the column and C2 the row (the reverse of hw_uniform's hash)
_WARP_C1 = 0x9E3779B9
_WARP_C2 = 0x85EBCA77
_WARP_K1 = 0xC2B2AE3D
_WARP_NOISE = {"mshift": 0, "hash": 1}


def _warp_noise_mode(noise) -> str:
    """cdae_tpu's noise modes: None means "mshift"; "hw" (the TPU's
    hardware PRNG) cannot be reproduced off the TPU and raises."""
    noise = "mshift" if noise is None else noise
    if noise == "hw":
        raise NotImplementedError(
            "warp_violator_select noise='hw' draws the TPU's hardware PRNG, "
            "whose bits no other device reproduces; use 'mshift' (the "
            "default) or 'hash'")
    if noise not in _WARP_NOISE:
        raise ValueError(f"unknown noise mode {noise!r}")
    return noise


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The murmur finalizer of cdae_tpu's selection noise on int64 values in
    [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, _HASH_M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _HASH_M2)
    return x ^ (x >> 16)


def _odd32(c: int) -> int:
    return (c & _MASK32) | 1


def warp_noise_plain(seed: int, rows: int, cols: int, nn: int,
                     noise: str = "mshift", *, device):
    """The (rows, cols) 24-bit selection noise of each slot k < nn, as
    int64 tensors: cdae_tpu's per-(row, col, slot) hash, bit for bit.
    "mshift": two murmur bases of (seed, row, col) shared by all slots,
    then (base * a_k + base2 * b_k) >> 8; "hash": one murmur mix of
    (seed, row, col, k) per slot, low 24 bits."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    h0 = ((int(seed) & _MASK32) + _mul32(c, _WARP_C1)
          + _mul32(r, _WARP_C2)) & _MASK32
    if noise == "hash":
        for k in range(nn):
            x = _mix32((h0 + ((k * _WARP_K1) & _MASK32)) & _MASK32)
            yield x & 0xFFFFFF
        return
    base = _mix32(h0)
    base2 = _mul32(base ^ _WARP_C1, _HASH_M2)
    base2 = base2 ^ (base2 >> 15)
    base2 = _mul32(base2, _HASH_M1)
    base2 = base2 ^ (base2 >> 17)
    for k in range(nn):
        a_k = _odd32(0x9E3779B1 * (2 * k + 1))
        b_k = _odd32(0x85EBCA77 * (2 * k + 3))
        yield ((_mul32(base, a_k) + _mul32(base2, b_k)) & _MASK32) >> 8


def warp_violator_select_plain(seed: int, uv_u, iv, ib, thr, mask_rows,
                               nn: int, noise=None):
    """Plain version of ``warp_violator_select`` on full (B, I) tensors:
    library scores, the violation mask, its row counts, and per slot the
    first column of the largest noise among the violators (argmax of
    where(viol, noise, -1)); a row with no violator selects 0."""
    noise = _warp_noise_mode(noise)
    B, I = uv_u.shape[0], iv.shape[0]
    scores = torch.addmm(ib, uv_u, iv.t())
    viol = (scores > thr[:, None]) & (mask_rows == 0)
    nviol = viol.sum(dim=1, dtype=torch.int32)
    j = torch.zeros((B, nn), dtype=torch.int32, device=uv_u.device)
    for k, x in enumerate(warp_noise_plain(seed, B, I, nn, noise,
                                           device=uv_u.device)):
        j[:, k] = torch.where(viol, x, -1).argmax(dim=1).to(torch.int32)
    return nviol, j.clamp_(0, max(I - 1, 0))


def warp_violator_select(
    seed: int,  # the step's int32 selection seed
    uv_u: torch.Tensor,  # (B, D) f32 user rows
    iv: torch.Tensor,  # (I, D) f32 item table
    ib: torch.Tensor,  # (I,) f32 item bias
    thr: torch.Tensor,  # (B,) f32 violation threshold (yui - margin)
    mask_rows: torch.Tensor,  # (B, I) int8, nonzero = rated
    nn: int,
    noise=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WARP's violator count and ``nn`` uniform violator picks per row,
    with no (B, I) array in memory. Violators of row b are the unrated
    columns with uv_u[b] . iv[c] + ib[c] > thr[b]. Returns (nviol (B,)
    int32, j (B, nn) int32): slot k picks the violator with the largest
    24-bit noise of (seed, b, c, k), the lowest column on equal noise, so
    each pick is uniform over the row's violators; a row with none picks 0.
    The noise is cdae_tpu's ("mshift" by default, or "hash") bit for bit.
    nn <= 32, D <= 128."""
    noise = _warp_noise_mode(noise)
    if not 1 <= nn <= _MAX_NN:
        raise ValueError(f"nn={nn}: warp_violator_select takes 1 <= nn <= "
                         f"{_MAX_NN}")
    if not _on_cuda(uv_u):
        return warp_violator_select_plain(seed, uv_u, iv, ib, thr, mask_rows,
                                          nn, noise)
    from cdae_tpu_torch.ops import cuda_lib

    dev = uv_u.device
    B, D = uv_u.shape
    I = iv.shape[0]
    if not 1 <= D <= _MAX_WARP_D or I == 0:
        raise ValueError(f"D={D}, I={I}: the kernel takes 1 <= D <= "
                         f"{_MAX_WARP_D} and I >= 1")
    _require(uv_u, "uv_u", torch.float32, (B, D), dev)
    _require(iv, "iv", torch.float32, (I, D), dev)
    _require(ib, "ib", torch.float32, (I,), dev)
    _require(thr, "thr", torch.float32, (B,), dev)
    _require(mask_rows, "mask_rows", torch.int8, (B, I), dev)
    nviol = torch.empty((B,), dtype=torch.int32, device=dev)
    j = torch.empty((B, nn), dtype=torch.int32, device=dev)
    if B == 0:
        return nviol, j
    # catalog splits: as few as the shared-memory limit allows (one at D = 10
    # up to 5,120 items), of equal size; only several need the partials
    rows = 64 if nn <= 8 else 32  # the kernel's rows per block
    cap = min(_WARP_MAX_SPLIT, (_WARP_SMEM_FLOATS - rows * D - 4 * D)
              // (D + 1) // _WARP_CHUNK * _WARP_CHUNK)
    splits = _cdiv(I, cap)
    per_split = _cdiv(_cdiv(I, splits), _WARP_CHUNK) * _WARP_CHUNK
    part = None
    if splits > 1:
        part = torch.empty((B * splits * (1 + 2 * nn) + _cdiv(B, rows),),
                           dtype=torch.int32, device=dev)
    seed32 = ((int(seed) + 2**31) & _MASK32) - 2**31  # as a C int
    rc = cuda_lib.lib().cdae_warp_select(
        seed32, uv_u.data_ptr(), iv.data_ptr(), ib.data_ptr(), thr.data_ptr(),
        mask_rows.data_ptr(), None if part is None else part.data_ptr(),
        nviol.data_ptr(), j.data_ptr(), B, I, D,
        nn, splits, per_split, _WARP_NOISE[noise], _stream(dev),
    )
    cuda_lib.check(rc, "warp_violator_select")
    warp_violator_select.launches += 1
    return nviol, j


warp_violator_select.launches = 0


# ------------------------------------------------------ row aggregation ----

class ScatterPlan(NamedTuple):
    """An id vector sorted into per-row segments, for ``scatter_matmul``:
    ``order`` (P,) int32 holds the positions stably sorted by id (ids
    outside [0, N) as the sentinel N, last); segment n is
    ``order[offsets[n]:offsets[n + 1]]``, ``offsets`` (N + 1,) int32."""

    offsets: torch.Tensor
    order: torch.Tensor


_PLAN_TILE = 1024  # csrc/scatter_rows.cu kTile


def _check_rows(num_rows: int) -> None:
    if not 0 <= num_rows < 2**31 - 1:
        raise ValueError(f"num_rows={num_rows}: the kernels take "
                         "0 <= num_rows < 2**31 - 1")


def scatter_plan_plain(idx: torch.Tensor, num_rows: int) -> ScatterPlan:
    """Plain version of ``scatter_plan``: the library's stable sort of the
    keys and a search for each row's first position."""
    idx = idx.reshape(-1).to(torch.int64)
    keys = torch.where((idx >= 0) & (idx < num_rows), idx, num_rows)
    sorted_keys, order = torch.sort(keys, stable=True)
    starts = torch.arange(num_rows + 1, dtype=torch.int64, device=idx.device)
    offsets = torch.searchsorted(sorted_keys, starts)
    return ScatterPlan(offsets.to(torch.int32), order.to(torch.int32))


def scatter_plan(idx: torch.Tensor, num_rows: int) -> ScatterPlan:
    """The segments of ``idx`` (P,) int64 over ``num_rows`` rows: build it
    once per id vector and pass it to every ``scatter_matmul`` over that
    vector or a prefix of it. On a CUDA tensor one call of the kernels
    (csrc/scatter_rows.cu: a stable radix sort over only the bits
    ``num_rows`` needs, then the segment starts); integer counts, so the
    same plan on every run."""
    _check_rows(num_rows)
    if not _on_cuda(idx):
        return scatter_plan_plain(idx, num_rows)
    from cdae_tpu_torch.ops import cuda_lib

    dev = idx.device
    _require(idx, "idx", torch.int64, (None,), dev)
    P = idx.shape[0]
    if P >= 2**30:
        raise ValueError(f"P={P}: the plan takes fewer than 2**30 ids")
    # one allocation: order, offsets, then the kernels' scratch (keys,
    # positions, digit counts, the tiles' look-back counts)
    buf = torch.empty((P + num_rows + 1 + 3 * P + 1056
                       + 1024 * _cdiv(P, _PLAN_TILE),),
                      dtype=torch.int32, device=dev)
    order, offsets = buf[:P], buf[P:P + num_rows + 1]
    rc = cuda_lib.lib().cdae_scatter_plan(
        idx.data_ptr(), P, num_rows, order.data_ptr(), offsets.data_ptr(),
        buf[P + num_rows + 1:].data_ptr(), _stream(dev),
    )
    cuda_lib.check(rc, "scatter_plan")
    scatter_plan.launches += 1
    return ScatterPlan(offsets, order)


scatter_plan.launches = 0


def scatter_matmul_plain(idx: torch.Tensor, vals: torch.Tensor,
                         num_rows: int, *, bf16: bool = False,
                         plan: Optional[ScatterPlan] = None) -> torch.Tensor:
    """Plain version of ``scatter_matmul``: one ``index_add_`` of the
    in-range rows into f32 zeros, in ascending p (on the card it sums
    duplicate rows with atomics, in no fixed order). With a ``plan`` the
    rows and positions come from its segments, those below len(vals)."""
    v = vals.to(torch.float32)
    if bf16:
        v = v.to(torch.bfloat16).to(torch.float32)
    out = torch.zeros((num_rows,) + tuple(v.shape[1:]), dtype=torch.float32,
                      device=v.device)
    if plan is not None:
        offsets = plan.offsets.to(torch.int64)
        rows = torch.repeat_interleave(
            torch.arange(num_rows, device=v.device), offsets.diff())
        pos = plan.order[:rows.shape[0]].to(torch.int64)
        keep = pos < v.shape[0]
        return out.index_add_(0, rows[keep], v[pos[keep]])
    idx = idx.reshape(-1).to(torch.int64)
    valid = (idx >= 0) & (idx < num_rows)
    keep = valid.reshape((-1,) + (1,) * (v.dim() - 1))
    return out.index_add_(0, torch.where(valid, idx, 0),
                          torch.where(keep, v, 0.0))


def scatter_matmul(idx: torch.Tensor, vals: torch.Tensor, num_rows: int, *,
                   bf16: bool = False, plan: Optional[ScatterPlan] = None
                   ) -> torch.Tensor:
    """Row aggregation ``out[n] = sum_{p : idx[p] == n} vals[p]`` for n in
    [0, num_rows): ``idx`` (P,) int64, ``vals`` (P, C) or (P,) float32;
    returns (num_rows, C) or (num_rows,) float32. Ids outside [0, num_rows)
    contribute nothing. ``bf16`` rounds each contribution to bf16 before
    the f32 sum (cdae_tpu's default bf16 operands).

    ``plan``: a ``scatter_plan`` of an id vector whose first P entries are
    ``idx`` (``idx`` itself is then not read); the kernel skips the plan's
    positions >= P (its ``limit``), so one plan serves a step's
    aggregations over one id vector and its prefixes. Without one, a plan
    of ``idx`` is built first. The kernel's sums run in a fixed order, so
    its result is the same bits on every run, and over a prefix the same
    with a shared plan as with the prefix's own."""
    if not _on_cuda(vals):
        return scatter_matmul_plain(idx, vals, num_rows, bf16=bf16,
                                    plan=plan)
    from cdae_tpu_torch.ops import cuda_lib

    dev = vals.device
    if vals.dim() not in (1, 2):
        raise ValueError(f"vals has shape {tuple(vals.shape)}; expected "
                         "(P, C) or (P,)")
    P = vals.shape[0]
    C = 1 if vals.dim() == 1 else vals.shape[1]
    _require(vals, "vals", torch.float32, tuple(vals.shape), dev)
    _check_rows(num_rows)
    out = torch.empty((num_rows,) + tuple(vals.shape[1:]),
                      dtype=torch.float32, device=dev)
    if num_rows == 0:
        return out
    if plan is None:
        _require(idx, "idx", torch.int64, (P,), dev)
        plan = scatter_plan(idx, num_rows)
    _require(plan.offsets, "plan.offsets", torch.int32, (num_rows + 1,), dev)
    _require(plan.order, "plan.order", torch.int32, (None,), dev)
    if plan.order.shape[0] < P:
        raise ValueError(f"the plan covers {plan.order.shape[0]} positions, "
                         f"vals has {P} rows")
    rc = cuda_lib.lib().cdae_scatter_reduce(
        plan.offsets.data_ptr(), plan.order.data_ptr(), vals.data_ptr(),
        out.data_ptr(), num_rows, C, plan.order.shape[0], P,
        int(bool(bf16)), _stream(dev),
    )
    cuda_lib.check(rc, "scatter_matmul")
    scatter_matmul.launches += 1
    return out


scatter_matmul.launches = 0


# ------------------------------------------------------------ row gather ----

def gather_rows_mxu_plain(table: torch.Tensor, idx: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version of ``gather_rows_mxu``: library row indexing, with
    the rows of out-of-range ids set to zero."""
    idx = idx.reshape(-1).to(torch.int64)
    N, C = table.shape
    valid = (idx >= 0) & (idx < N)
    if N == 0:
        return torch.zeros((idx.shape[0], C), dtype=torch.float32,
                           device=table.device)
    rows = table[torch.where(valid, idx, 0)].to(torch.float32)
    return torch.where(valid[:, None], rows, 0.0)


def _gather_fn():
    """The row gather's C entry point, bound once (ctypes attribute lookup
    and the library's lock are host time on every call otherwise)."""
    global _GATHER
    if _GATHER is None:
        from cdae_tpu_torch.ops import cuda_lib

        _GATHER = cuda_lib.lib().cdae_gather_rows
    return _GATHER


_GATHER = None


def gather_rows_mxu(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(P, C) float32 rows ``table[idx]`` of a (N, C) float32 table for
    ``idx`` (P,) int64; an id outside [0, N) gives a zero row. Exact (a
    copy). At WARP's shapes the wrapper's host work is most of the call,
    so its hot path makes one check per argument, one allocation and one
    ctypes call."""
    if not table.is_cuda:
        _on_cuda(table)  # raises for a device that is neither
        return gather_rows_mxu_plain(table, idx)
    fn = _GATHER or _gather_fn()
    if (table.dtype != torch.float32 or table.dim() != 2
            or not table.is_contiguous()):
        _require(table, "table", torch.float32, (None, None), table.device)
    index = table.get_device()
    if (idx.get_device() != index or idx.dtype != torch.int64
            or idx.dim() != 1 or not idx.is_contiguous()):
        _require(idx, "idx", torch.int64, (None,), table.device)
    N, C = table.shape
    P = idx.shape[0]
    if P * C >= 2**31 or N >= 2**31:
        raise ValueError(f"P*C = {P * C}, N = {N}: the kernel takes < 2**31 "
                         "of each")
    out = table.new_empty((P, C))  # the allocator aligns it to 16 bytes
    if P == 0 or C == 0:
        return out
    ptr = table.data_ptr()
    # 16-byte reads of whole rows where C and the table's alignment allow
    rc = fn(ptr, idx.data_ptr(), out.data_ptr(), P, N, C,
            4 if C % 4 == 0 and ptr % 16 == 0 else 1,
            torch._C._cuda_getCurrentRawStream(index))
    if rc:
        from cdae_tpu_torch.ops import cuda_lib

        cuda_lib.check(rc, "gather_rows_mxu")
    gather_rows_mxu.launches += 1
    return out


gather_rows_mxu.launches = 0

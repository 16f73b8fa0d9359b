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
                         p -= lr*g/(beta+sqrt(a)); one
  adagrad_update_tables  launch over a list of tables
                         (a step's dense tables)
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
  csr_rows               a request's padded rated rows   csrc/csr_rows.cu
                         from a device-resident CSR (no
                         Pallas kernel: cdae_tpu builds
                         them on the host)

The fused dense train step (B4) has its own module, ops/cdae_fused.py.

Every kernel wrapper routes by the device of the tensors it is given: on a
CUDA tensor it launches the hand-written kernel (built from
cdae_tpu_torch/csrc on first use) or raises; on a CPU tensor it runs the
plain version. There is no fallback from one to the other. Each wrapper
counts its kernel launches in ``<wrapper>.launches`` (the AdaGrad list
kernel's in ``adagrad_update.launches``, whichever wrapper launched it).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from cdae_tpu_torch.ops.topk import stable_topk

NEG = -3.0e38  # cdae_tpu's "excluded" score for rated and padded columns
_MAX_K = 32  # one warp holds a user's running top-k, one entry per lane
# an AdaGrad table: (param, acc, grad), updated in place
AdagradTable = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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
_TOPK_WGMMA_MAX_D = 64  # the wgmma path up to this D, mma.sync above


def fused_topk_path(D: int) -> str:
    """The path csrc/fused_topk.cu takes at width D (the rule of its
    ``launch``): "wgmma" (z's fragments held in registers, one block an
    SM) up to D = 64, "mma_sync" (z staged in chunks, two blocks an SM)
    above."""
    return "wgmma" if D <= _TOPK_WGMMA_MAX_D else "mma_sync"


def fused_topk_grid(B: int, I: int, num_sms: int,
                    waves: int = 2) -> Tuple[int, int]:
    """(splits, items_per_split) of csrc/fused_topk.cu's grid for B users
    and I items on a card of ``num_sms`` SMs: the catalog is cut into
    splits of whole 128-item tiles so that (user tiles of 128) x (splits)
    gives at most ``waves`` blocks an SM (the blocks resident together:
    1 on the wgmma path, 2 on the mma.sync path) where the catalog has the
    tiles for it; every split is non-empty."""
    tiles = _cdiv(I, _TOPK_TILE_I)
    user_tiles = _cdiv(B, _TOPK_TILE_U)
    splits = max(1, min(tiles, waves * num_sms // user_tiles))
    per_split = _cdiv(tiles, splits) * _TOPK_TILE_I
    return _cdiv(I, per_split), per_split


# per device: the (capacity,) int64 words through which a launch's catalog
# splits share each user's threshold (csrc/fused_topk.cu shared_word), zeroed
# once, and the epoch of the last launch. A word of an earlier launch loses
# to one of the current launch and is read as no threshold, so nothing is
# cleared between launches; two launches must not share an epoch (as a CUDA
# graph replaying one launch would: the port captures none)
_topk_shared: dict = {}
_topk_shared_lock = threading.Lock()


def _topk_thresholds(dev: torch.device, B: int) -> Tuple[torch.Tensor, int]:
    """The shared-threshold words for B users on ``dev`` and this launch's
    epoch (1 to 2**31 - 1; the words are zeroed again when it wraps)."""
    with _topk_shared_lock:
        words, epoch = _topk_shared.get(dev, (None, 0))
        if words is None or words.numel() < B:
            words, epoch = torch.zeros(max(B, 1024), dtype=torch.int64,
                                       device=dev), 0
        epoch += 1
        if epoch >= 2**31:
            words.zero_()
            epoch = 1
        _topk_shared[dev] = (words, epoch)
        return words, epoch


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
    waves = 1 if fused_topk_path(D) == "wgmma" else 2
    splits, per_split = fused_topk_grid(B, I, _num_sms(dev.index or 0),
                                        waves)
    part_v = torch.empty((B, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((B, splits, k), dtype=torch.int32, device=dev)
    # the mma.sync path's widest copy of z and W rows (16, 8 or 4 bytes)
    # that D and both pointers allow
    zp, wp = z.data_ptr(), W.data_ptr()
    vec = next(v for v in (4, 2, 1)
               if D % v == 0 and zp % (4 * v) == 0 and wp % (4 * v) == 0)
    words, epoch = _topk_thresholds(dev, B)
    rc = getattr(cuda_lib.lib(), entry)(
        zp, wp, b_prime.data_ptr(), rated.data_ptr(),
        *extra, part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), B, I, D, k, splits, per_split, vec,
        words.data_ptr(), epoch, _stream(dev),
    )
    cuda_lib.check(rc, entry)
    return out_i, out_v


def _count_topk(wrapper, D: int) -> None:
    """Count a launch of B5 or B6: in ``launches`` and in the count of the
    path it took (``launches_wgmma``, ``launches_mma_sync``)."""
    wrapper.launches += 1
    name = "launches_" + fused_topk_path(D)
    setattr(wrapper, name, getattr(wrapper, name) + 1)


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
    _count_topk(fused_topk_scores, z.shape[1])
    return _neg_tail(ids, vals, W.shape[0], block)


fused_topk_scores.launches = 0
fused_topk_scores.launches_wgmma = 0
fused_topk_scores.launches_mma_sync = 0


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
    _count_topk(fused_topk_scores_csr, z.shape[1])
    return _csr_tail(ids, vals, rated_items, W.shape[0], block, w)


fused_topk_scores_csr.launches = 0
fused_topk_scores_csr.launches_wgmma = 0
fused_topk_scores_csr.launches_mma_sync = 0


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
                     device, row_offset: int = 0,
                     col_offset: int = 0) -> torch.Tensor:
    """Plain version of ``hw_uniform``: the same 32-bit arithmetic on int64
    tensors, masked to 32 bits (logical shifts, since every value is
    non-negative)."""
    rows, cols = shape
    r = torch.arange(row_offset, row_offset + rows, dtype=torch.int64,
                     device=device)[:, None] & _MASK32
    c = torch.arange(col_offset, col_offset + cols, dtype=torch.int64,
                     device=device)[None, :] & _MASK32
    x = ((int(seed) & _MASK32) + _mul32(r, _HASH_ROW) + _mul32(c, _HASH_COL)
         + ((int(draw) * _HASH_M2) & _MASK32)) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, _HASH_M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _HASH_M2)
    x = x ^ (x >> 16)
    return (x & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))


def hw_uniform(seed: int, shape: Tuple[int, int], draw: int = 0, *,
               device, row_offset: int = 0, col_offset: int = 0
               ) -> torch.Tensor:
    """(rows, cols) float32 uniforms in [0, 1) at 24-bit resolution, on
    ``device``. Element (r, c) is the low 24 bits of a murmur mix of
    (seed, r, c, draw), times 2**-24: a pure function of its coordinates,
    so any tiling draws the same numbers and the fused step (B4) regenerates
    exactly these masks. ``draw`` separates independent draws of one step
    (0: corruption, 1: negatives). cdae_tpu draws from the TPU's hardware
    PRNG here, whose bits cannot be reproduced; this is its tiling-invariant
    hash stream (cdae_tpu/ops/cdae_fused.py _hash_uniform), bit for bit.
    ``row_offset`` / ``col_offset`` shift the coordinates: the result is
    the (rows, cols) block at those offsets of a larger draw, which is how
    a sharded step draws its block of the single-device draw."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for {device}")
    if device.type == "cpu":
        return hw_uniform_plain(seed, shape, draw, device=device,
                                row_offset=row_offset, col_offset=col_offset)
    from cdae_tpu_torch.ops import cuda_lib

    rows, cols = shape
    if rows < 0 or cols < 0 or rows * cols >= 2**31:
        raise ValueError(f"hw_uniform shape {shape}: the kernel takes "
                         "0 <= rows*cols < 2**31")
    out = torch.empty((rows, cols), dtype=torch.float32, device=device)
    if rows * cols == 0:
        return out
    seed32 = ((int(seed) + 2**31) & _MASK32) - 2**31  # as a C int
    if not (0 <= row_offset < 2**31 and 0 <= col_offset < 2**31):
        raise ValueError(f"offsets ({row_offset}, {col_offset}): the kernel "
                         "takes 0 <= offset < 2**31")
    rc = cuda_lib.lib().cdae_hw_uniform(out.data_ptr(), rows, cols, seed32,
                                        int(draw), int(row_offset),
                                        int(col_offset), _stream(device))
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


def adagrad_update_tables_plain(tables: Sequence[AdagradTable], lr: float,
                                beta: float = 0.0) -> None:
    """Plain version of ``adagrad_update_tables``: ``adagrad_update_plain``
    on each table in turn."""
    for param, acc, grad in tables:
        adagrad_update_plain(param, acc, grad, lr, beta)


_ADAGRAD_MAX_TABLES = 16  # csrc/adagrad_update.cu kMaxTables
_PARAM_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's host descriptors, (param, acc, grad, n, bf16) per table,
# filled under the lock for each launch
_ADAGRAD_DESC = (ctypes.c_longlong * (5 * _ADAGRAD_MAX_TABLES))()
_ADAGRAD_DESC_ADDR = ctypes.addressof(_ADAGRAD_DESC)
_ADAGRAD_LOCK = threading.Lock()
_ADAGRAD = None


def _adagrad_fn():
    """The list kernel's C entry point, bound once."""
    global _ADAGRAD
    if _ADAGRAD is None:
        from cdae_tpu_torch.ops import cuda_lib

        _ADAGRAD = cuda_lib.lib().cdae_adagrad_update_tables
    return _ADAGRAD


def _adagrad_table_error(param, acc, grad, dev: torch.device) -> None:
    """Raise for a table that the kernel does not take, naming what is
    wrong."""
    shape = tuple(param.shape)
    if param.dim() not in (1, 2):
        raise ValueError(f"param has shape {shape}; expected (N, D) or (N,)")
    if param.dtype not in _PARAM_DTYPES:
        raise TypeError(f"param has dtype {param.dtype}, expected float32 "
                        "or bfloat16")
    _require(param, "param", param.dtype, shape, dev)
    _require(acc, "acc", torch.float32, shape, dev)
    _require(grad, "grad", torch.float32, shape, dev)
    raise ValueError("param, acc and grad must lie on one CUDA device")


def _adagrad_launch(tables: Sequence[AdagradTable], lr: float,
                    beta: float) -> None:
    """Check CUDA tables and update them with the list kernel: one launch
    for up to 16 non-empty tables, each counted in
    ``adagrad_update.launches``. The checks make a few attribute reads a
    table; ``_adagrad_table_error`` names a failure."""
    fn = _ADAGRAD or _adagrad_fn()
    index = tables[0][0].get_device()
    f32 = torch.float32
    desc, spans = [], []
    for param, acc, grad in tables:
        shape = param.shape
        if (param.dtype not in _PARAM_DTYPES or acc.dtype != f32
                or grad.dtype != f32 or len(shape) not in (1, 2)
                or acc.shape != shape or grad.shape != shape
                or param.get_device() != index or acc.get_device() != index
                or grad.get_device() != index or not param.is_contiguous()
                or not acc.is_contiguous() or not grad.is_contiguous()):
            _adagrad_table_error(param, acc, grad, tables[0][0].device)
        n = shape[0] * shape[1] if len(shape) == 2 else shape[0]
        if n >= 2**31:
            raise ValueError(f"param has {n} elements; the kernel takes "
                             "< 2**31 a table")
        if n == 0:
            continue
        bf16 = param.dtype != f32
        p, a = param.data_ptr(), acc.data_ptr()
        spans += ((p, p + (2 if bf16 else 4) * n), (a, a + 4 * n))
        desc += (p, a, grad.data_ptr(), n, int(bf16))
    # one launch updates its tables in parallel: memory that two tables
    # write would be raced on (the plain version updates them in turn)
    spans.sort()
    if any(nxt[0] < cur[1] for cur, nxt in zip(spans, spans[1:])):
        raise ValueError("two tables share param or acc memory; the kernel "
                         "updates its tables at once")
    stream = torch._C._cuda_getCurrentRawStream(index)
    width = 5 * _ADAGRAD_MAX_TABLES
    for start in range(0, len(desc), width):
        chunk = desc[start:start + width]
        with _ADAGRAD_LOCK:
            _ADAGRAD_DESC[:len(chunk)] = chunk
            rc = fn(_ADAGRAD_DESC_ADDR, len(chunk) // 5, lr, beta, stream)
        if rc:
            from cdae_tpu_torch.ops import cuda_lib

            cuda_lib.check(rc, "adagrad_update")
        adagrad_update.launches += 1


def adagrad_update_tables(tables: Sequence[AdagradTable], lr: float,
                          beta: float = 0.0) -> None:
    """``adagrad_update`` IN PLACE over a list of (param, acc, grad) tables
    with one lr and beta: on CUDA tensors one kernel launch for every 16
    tables (counted in ``adagrad_update.launches``); empty tables are
    skipped. Bit-equal to ``adagrad_update_plain`` applied to each table
    in turn, so every grad must already be computed: the kernel updates
    the tables at once, and raises for two tables whose param or acc
    memory overlaps."""
    if not tables:
        return
    if not _on_cuda(tables[0][0]):
        if any(t.is_cuda for table in tables for t in table):
            raise ValueError("tables on the CPU and on a CUDA device mixed")
        adagrad_update_tables_plain(tables, lr, beta)
        return
    _adagrad_launch(tables, lr, beta)


def adagrad_update(param: torch.Tensor, acc: torch.Tensor, grad: torch.Tensor,
                   lr: float, beta: float = 0.0):
    """One AdaGrad step IN PLACE over (N, D) or (N,): ``acc`` (f32) +=
    grad**2, then ``param`` (f32 or bf16, f32 arithmetic) -= lr * grad /
    (beta + sqrt(acc)). ``grad`` is f32. Returns (param, acc), the same
    tensors. On CUDA tensors a one-table launch of the list kernel
    (``adagrad_update_tables``). Bit-equal to the plain version: the kernel
    rounds every operation on its own (no contracted FMA)."""
    if not _on_cuda(param):
        return adagrad_update_plain(param, acc, grad, lr, beta)
    _adagrad_launch(((param, acc, grad),), lr, beta)
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
                     noise: str = "mshift", *, device, row_offset: int = 0):
    """The (rows, cols) 24-bit selection noise of each slot k < nn, as
    int64 tensors: cdae_tpu's per-(row, col, slot) hash, bit for bit.
    "mshift": two murmur bases of (seed, row, col) shared by all slots,
    then (base * a_k + base2 * b_k) >> 8; "hash": one murmur mix of
    (seed, row, col, k) per slot, low 24 bits. Rows count from
    ``row_offset``."""
    r = torch.arange(row_offset, row_offset + rows, dtype=torch.int64,
                     device=device)[:, None] & _MASK32
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
                               nn: int, noise=None, row_offset: int = 0):
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
                                           device=uv_u.device,
                                           row_offset=row_offset)):
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
    row_offset: int = 0,  # the first row's index in the whole batch
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WARP's violator count and ``nn`` uniform violator picks per row,
    with no (B, I) array in memory. Violators of row b are the unrated
    columns with uv_u[b] . iv[c] + ib[c] > thr[b]. Returns (nviol (B,)
    int32, j (B, nn) int32): slot k picks the violator with the largest
    24-bit noise of (seed, b, c, k), the lowest column on equal noise, so
    each pick is uniform over the row's violators; a row with none picks 0.
    The noise is cdae_tpu's ("mshift" by default, or "hash") bit for bit.
    Row b hashes as row ``row_offset + b``: a block of a batch's rows picks
    what the whole batch's call picks there. nn <= 32, D <= 128."""
    noise = _warp_noise_mode(noise)
    if not 1 <= nn <= _MAX_NN:
        raise ValueError(f"nn={nn}: warp_violator_select takes 1 <= nn <= "
                         f"{_MAX_NN}")
    if not _on_cuda(uv_u):
        return warp_violator_select_plain(seed, uv_u, iv, ib, thr, mask_rows,
                                          nn, noise, row_offset)
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
        nn, splits, per_split, _WARP_NOISE[noise], int(row_offset),
        _stream(dev),
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


# ------------------------------------------------------ rows from a CSR ----

def csr_rows_plain(indptr: torch.Tensor, indices: torch.Tensor,
                   uids: torch.Tensor, L: int, num_items: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``csr_rows``: the row starts and lengths gathered
    from ``indptr``, an ``arange(L)`` against them, and the items gathered
    where a column lies inside its row."""
    start = indptr[uids]
    col = torch.arange(L, device=indptr.device)
    mask = col[None, :] < (indptr[uids + 1] - start)[:, None]
    if indices.numel() == 0:
        return torch.full(mask.shape, num_items, dtype=torch.int32,
                          device=indptr.device), mask
    src = torch.where(mask, start[:, None] + col[None, :], 0)
    return torch.where(mask, indices[src], num_items), mask


def csr_rows(indptr: torch.Tensor, indices: torch.Tensor,
             uids: torch.Tensor, L: int, num_items: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) int32 ``items`` and bool ``mask`` of the users ``uids`` (B,)
    int64 from a user CSR, ``indptr`` (U+1,) int64 and ``indices`` (nnz,)
    int32: each row's items in CSR order, padded with ``num_items``, and
    True on the row's own columns, as ``data.dataset.rows_from_csr`` gives
    them. Every uid lies in [0, U) and no row is longer than ``L``; the
    caller checks both on the host, where the CSR's indptr already is."""
    if not _on_cuda(indptr):
        return csr_rows_plain(indptr, indices, uids, L, num_items)
    device = indptr.device
    _require(indptr, "indptr", torch.int64, (None,), device)
    _require(indices, "indices", torch.int32, (None,), device)
    _require(uids, "uids", torch.int64, (None,), device)
    B = uids.shape[0]
    if L < 1 or B * L >= 2**31 or num_items >= 2**31:
        raise ValueError(f"B*L = {B}*{L}, num_items = {num_items}: the "
                         "kernel takes L >= 1 and < 2**31 of each")
    items = torch.empty((B, L), dtype=torch.int32, device=device)
    mask = torch.empty((B, L), dtype=torch.bool, device=device)
    if B == 0:
        return items, mask
    from cdae_tpu_torch.ops import cuda_lib

    rc = cuda_lib.lib().cdae_csr_rows(
        indptr.data_ptr(), indices.data_ptr(), uids.data_ptr(),
        items.data_ptr(), mask.data_ptr(), B, L, num_items, _stream(device))
    cuda_lib.check(rc, "csr_rows")
    csr_rows.launches += 1
    return items, mask


csr_rows.launches = 0

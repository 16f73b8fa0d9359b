"""On-device integer draws and the CSR membership test (port of
cdae_tpu/ops/sampling.py: every part the ported models use).

``hw_randint`` is cdae_tpu's uniform int in [0, maxval) built on the
uniform stream of ``hw_uniform`` (kernel B1) with a salt XORed into the
seed. cdae_tpu derives that seed from a PRNG key (``key_seed``); the port
passes its host step seeds (utils/random.py ``step_seed``) instead.

``sample_unrated`` is the exact complement sampler: given a user's rated
items R sorted ascending (padded with num_items), the u-th unrated item is
``u + k`` with k the number of rated r_j with ``r_j - j <= u``. cdae_tpu
counts k in three ways by the number of samples (a compare-sum, a chunked
scan, a sort-based searchsorted), which all give the same integer; here it
is one ``torch.searchsorted``.

``is_rated`` is the CSR membership test of the sparse CDAE step's pooled
negatives, of Popularity's candidate walk and of WARP's pool path without
the (U, I) rated mask. cdae_tpu compares every query with every rated slot
(a fused compare on the TPU); here each query is one binary search of its
row, ``torch.searchsorted``, which gives the same booleans for rows sorted
ascending.
"""

from __future__ import annotations

from typing import Optional

import torch

from cdae_tpu_torch.ops.pallas_kernels import hw_uniform, hw_uniform_plain

_MASK32 = 0xFFFFFFFF


def hw_randint(seed: int, shape, maxval, salt: int = 0, *, device,
               use_kernel: bool = True, row_offset: int = 0) -> torch.Tensor:
    """int32 uniform in [0, maxval) of ``shape``: ``floor(u * maxval)``
    capped at maxval - 1, with ``u = hw_uniform(seed ^ salt, shape)`` (its
    kernel for a CUDA device when ``use_kernel``, else its plain version).
    ``maxval`` is a number or a tensor broadcastable to ``shape``, >= 1.
    The float scaling biases a draw by less than maxval * 2**-24.
    ``row_offset``: the rows of a larger draw from that row on."""
    s = (int(seed) ^ int(salt)) & _MASK32
    s = s - (1 << 32) if s >= (1 << 31) else s
    draw = hw_uniform if use_kernel else hw_uniform_plain
    u01 = draw(s, tuple(shape), device=device, row_offset=row_offset)
    mx = torch.as_tensor(maxval, device=u01.device)
    scaled = (u01 * mx.to(torch.float32)).to(torch.int32)
    return torch.minimum(scaled, mx.to(torch.int32) - 1)


def sample_unrated(
    seed: int,  # the step seed of the draws (utils/random.py step_seed)
    sorted_items: torch.Tensor,  # (B, L) ascending, padded with num_items
    lengths: torch.Tensor,  # (B,) number of real entries per row
    num_items: int,
    num_samples: int,
    *,
    hw: bool = False,
    u: Optional[torch.Tensor] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Uniform samples from each row's UNRATED items; (B, num_samples)
    int64.

    The draws ``u`` (uniform in [0, free) per row, free = max(num_items -
    length, 1)) are injected, or come from ``hw_randint(seed, ...)`` with
    ``hw`` (B1's hash stream -- its kernel for a CUDA device when
    ``use_kernel``; the float scaling biases a draw by less than free *
    2**-24), or else from a ``torch.Generator`` seeded with ``seed``
    (float64 uniforms scaled and floored, a bias below free * 2**-53).
    int32 rows (the MF family's) are searched as int32.

    Rows whose complement is empty (length == num_items) come back as the
    sentinel id ``num_items``: callers must zero-weight slots with id >=
    num_items, since clipping it would turn a rated item into a negative."""
    B, L = sorted_items.shape
    dev = sorted_items.device
    dt = torch.int32 if sorted_items.dtype == torch.int32 else torch.int64
    lengths = lengths.to(dt)
    free = torch.clamp(num_items - lengths, min=1)[:, None]
    if u is None:
        shape = (B, num_samples)
        if hw:
            u = hw_randint(seed, shape, free, device=dev,
                           use_kernel=use_kernel)
        else:
            gen = torch.Generator(device=dev).manual_seed(int(seed) & _MASK32)
            r = torch.rand(shape, generator=gen, dtype=torch.float64,
                           device=dev)
            u = torch.minimum((r * free).to(dt), free - 1)
    u = torch.as_tensor(u, device=dev).to(dt)
    # rank transform: R[j] - j counts the unrated ids below R[j]; padded
    # slots become num_items, above every valid draw, so the row stays
    # sorted
    pos = torch.arange(L, device=dev, dtype=dt)[None, :]
    ranks = torch.where(pos < lengths[:, None], sorted_items.to(dt) - pos,
                        num_items)
    k = torch.searchsorted(ranks.contiguous(), u.contiguous(), right=True,
                           out_int32=dt == torch.int32)
    return (u + k).to(torch.int64)


def is_rated(
    sorted_items: torch.Tensor,  # (B, L) ascending, padded with num_items
    lengths: torch.Tensor,  # (B,) number of real entries per row
    queries: torch.Tensor,  # (Q,) shared or (B, Q) per-row ids
) -> torch.Tensor:
    """Membership of ``queries`` in each row's first ``lengths`` entries;
    (B, Q) bool. int32 rows are searched as int32."""
    B, L = sorted_items.shape
    dev = sorted_items.device
    dt = torch.int32 if sorted_items.dtype == torch.int32 else torch.int64
    q = torch.as_tensor(queries, device=dev).to(dt)
    q = q.expand(B, -1) if q.dim() == 1 else q
    if L == 0 or q.shape[1] == 0:
        return torch.zeros(q.shape, dtype=torch.bool, device=dev)
    pos = torch.arange(L, device=dev, dtype=dt)[None, :]
    # padding slots above every id, so the row stays sorted and never hits
    top = torch.iinfo(dt).max
    rows = torch.where(pos < lengths.to(dt)[:, None], sorted_items.to(dt),
                       top).contiguous()
    at = torch.searchsorted(rows, q.contiguous()).clamp_(max=L - 1)
    return torch.gather(rows, 1, at) == q

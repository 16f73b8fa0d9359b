"""The hand-written CUDA kernels of cdae_tpu_torch against their plain
PyTorch versions, on a GPU, at ragged shapes: the serving kernels (decode,
fused top-k at the edges of their tiles, equal scores included, unaligned
views on both of its paths, full candidate buffers, and B6 at the 1M-item
serving request), the
training kernels (hw_uniform and adagrad_update bit for bit, the latter
also as one launch over a list of tables, once a training step; the fused
step within f32 summation-order tolerance and bit-equal run to run), the WARP
violator kernel (counts and picks exact on dyadic inputs, at the edges of
its tiles and catalog splits), and the row aggregation (B8: its plan equal
to the library's stable sort; its reduce to summation-order tolerance and
the same bits on every launch and over a shared plan; every fixed-order
scatter mode routed to it) and row gather (B9, exact at every width) with
the paths that launch them, two default-route WARP runs bit for bit, and
CDAE's sparse step (its epoch with the kernels against their plain
versions, two runs bit for bit, the corruption-0 dense/sparse identity),
and the MF family's routes (IMF, PMF and BPR sparse and slab, WARP's slab,
pool and scan: a step with the kernels against one with their plain
versions, two runs bit for bit, the pool path's mask and CSR rows the same
bits, B9 on IMF, and a failing kernel launch raising instead of falling
back), ALS/WRMF and ItemCF/UserCF, and the feature-group models
(LinearModel, FactorModel, NegMF sparse and slab: an epoch on the card
against one on the CPU from the same injected draws, two runs bit for bit,
no fall-back), and the single-card leftovers (CDAE's recommend through B3
against the plain decode, a sweep point's epoch with B1 and B2 against the
plain versions, the host loader built and parsing on the card's host), and
serving's rated rows (``csr_rows`` bit for bit against its plain version
and the host rows, its refusals, the device CSR copied once).
Every test is marked ``cuda`` and skips when torch.cuda.is_available() is
False (the kernels have no CPU mode).

This file imports neither jax nor cdae_tpu, so it also runs on a machine
without them; there, skip the JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from cdae_tpu_torch.ops import cdae_fused as F
from cdae_tpu_torch.ops import pallas_kernels as P


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 reference
    return torch.device("cuda")


@pytest.fixture
def rng_np():
    return np.random.default_rng(11)


def _problem(rng, B, D, I):
    z = rng.standard_normal((B, D)).astype(np.float32)
    W = rng.standard_normal((I, D)).astype(np.float32)
    bp = rng.standard_normal(I).astype(np.float32)
    return z, W, bp


def _csr_rows(rng, B, I, L):
    rated = np.full((B, L), I, np.int32)
    for b in range(B):
        n = int(rng.integers(1, L))
        rated[b, :n] = np.sort(rng.choice(I, n, replace=False))
    return rated


def _dense_rows(rated_items, I):
    rows = np.zeros((rated_items.shape[0], I), np.int8)
    for b, r in enumerate(rated_items):
        rows[b, r[r < I]] = 1
    return rows


def _on(dev, *arrays):
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,I", [
    (48, 20, 700), (1, 7, 5), (130, 200, 999), (0, 50, 300), (257, 1, 129),
    (200, 13, 3706), (129, 50, 3706), (1024, 50, 3706), (300, 200, 2001),
])
def test_decode_scores_kernel(cuda, rng_np, B, D, I):
    """3xTF32 on the tensor cores against the f32 library GEMM, at ragged
    B and I (not multiples of the 128 x 128 tile) and D from 1 to 200:
    rtol 1e-5 and atol 1e-4 (f32-level error on N(0, 1) operands)."""
    z, W, bp = _on(cuda, *_problem(rng_np, B, D, I))
    before = P.decode_scores.launches
    got = P.decode_scores(z, W, bp)
    torch.cuda.synchronize()
    assert P.decode_scores.launches == before + (1 if B else 0)
    assert tuple(got.shape) == (B, I)
    torch.testing.assert_close(got, P.decode_scores_plain(z, W, bp),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [4, 200])
def test_decode_scores_kernel_unaligned_rows(cuda, rng_np, D):
    """D % 4 == 0 but z and W start 4 bytes past a 16-byte boundary: the
    kernel takes its 4-byte copies and agrees all the same; and its error
    against an f64 product stays below 1e-4 (one TF32 product per f32 one
    would miss it by ~1e-2 at D = 200)."""
    B, I = 70, 333
    zf, Wf, bp = _on(cuda, *_problem(rng_np, B * D + 1, 1, I * D + 1))
    bp = bp[:I].contiguous()
    z = zf.reshape(-1)[1:].reshape(B, D)
    W = Wf.reshape(-1)[1:].reshape(I, D)
    got = P.decode_scores(z, W, bp)
    want = P.decode_scores_plain(z, W, bp)
    ref64 = z.double() @ W.double().t() + bp.double()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert (got.double() - ref64).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,I,L,K", [
    (8, 16, 300, 6, 10),
    (70, 50, 5000, 300, 10),
    (33, 9, 1000, 40, 32),
    (5, 3, 7, 3, 10),  # catalog smaller than k
])
def test_fused_topk_kernels(cuda, rng_np, B, D, I, L, K):
    z, W, bp = _problem(rng_np, B, D, I)
    rated = _csr_rows(rng_np, B, I, L)
    rows = _dense_rows(rated, I)
    zt, Wt, bpt, rt, rowst = _on(cuda, z, W, bp, rated, rows)
    cases = ((P.fused_topk_scores, P.fused_topk_scores_plain, rowst),
             (P.fused_topk_scores_csr, P.fused_topk_scores_csr_plain, rt))
    for fn, plain, r in cases:
        want = plain(zt, Wt, bpt, r, k=K)
        before = fn.launches
        ids, vals = fn(zt, Wt, bpt, r, k=K)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        torch.testing.assert_close(ids, want[0])
        torch.testing.assert_close(vals, want[1], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_fused_topk_kernel_fewer_than_k(cuda, rng_np):
    B, D, I, K = 4, 8, 140, 10
    z, W, bp = _problem(rng_np, B, D, I)
    rated = np.ones((B, I), dtype=np.int8)
    rated[0, :5] = 0
    rated[1, :] = 0
    rated[2, [3, 7, 135]] = 0
    zt, Wt, bpt, rt = _on(cuda, z, W, bp, rated)
    want = P.fused_topk_scores_plain(zt, Wt, bpt, rt, k=K, block=128)
    got = P.fused_topk_scores(zt, Wt, bpt, rt, k=K, block=128)
    torch.testing.assert_close(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-4)


def _rated_sets(rng, B, I, L):
    """Sorted rated ids per row: random rows of up to L items; row 0 rates
    100 items inside the first 128-item tile (more than k in one tile), row
    1 all but 3 items (fewer than k unrated), row 2 nothing."""
    sets = [np.sort(rng.choice(I, int(rng.integers(1, min(L, I))),
                               replace=False)) for _ in range(B)]
    if B > 0:
        sets[0] = np.arange(min(100, I))
    if B > 1:
        sets[1] = np.sort(rng.choice(I, max(I - 3, 0), replace=False))
    if B > 2:
        sets[2] = np.zeros(0, np.int64)
    width = max(1, max(len(r) for r in sets))
    rated = np.full((B, width), I, np.int32)
    for b, r in enumerate(sets):
        rated[b, :len(r)] = r
    return rated


def _both_topk(dev, z, W, bp, rated, K):
    """(kernel, plain) of B5 and of B6 on the same rows."""
    rows = _dense_rows(rated, W.shape[0])
    zt, Wt, bpt, rt, rowst = _on(dev, z, W, bp, rated, rows)
    out = []
    for fn, plain, r in (
            (P.fused_topk_scores, P.fused_topk_scores_plain, rowst),
            (P.fused_topk_scores_csr, P.fused_topk_scores_csr_plain, rt)):
        before = fn.launches
        got = fn(zt, Wt, bpt, r, k=K)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        out.append((got, plain(zt, Wt, bpt, r, k=K)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("B,I,D,K", [
    (130, 1000, 3, 1), (257, 5001, 9, 32), (130, 5001, 50, 10),
    (129, 1000, 64, 32), (257, 1000, 50, 1), (300, 2000, 100, 10),
    (70, 777, 200, 32), (1, 129, 64, 32), (3, 130, 65, 10),
    (130, 1001, 50, 10), (130, 1001, 56, 32), (200, 3001, 64, 10),
    (129, 1001, 65, 10), (130, 1001, 200, 1),
])
def test_fused_topk_kernel_tile_edges(cuda, rng_np, B, I, D, K):
    """B5 and B6 at the edges of their tiles: B off the 128-row user tile,
    I off the 128-item tile (I = 1001: the last tile's copy, 41 rows of
    D = 50, is 8,200 bytes, no multiple of 16), D from 3 to 200 (the
    wgmma path up to 64, the mma.sync path's 32-wide chunks above), k = 1
    and 32; a row with 100 rated items in one tile, one with 3 unrated
    items, one with none rated. Ids equal the plain version's, scores to
    rtol 1e-5 and atol 1e-4 (f32-level error of 3xTF32 on N(0, 1)
    operands)."""
    z, W, bp = _problem(rng_np, B, D, I)
    rated = _rated_sets(rng_np, B, I, 300)
    for got, want in _both_topk(cuda, z, W, bp, rated, K):
        torch.testing.assert_close(got[0], want[0])
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("D,path", [(50, "wgmma"), (64, "wgmma"),
                                    (65, "mma_sync"), (200, "mma_sync")])
def test_fused_topk_kernel_unaligned_views(cuda, rng_np, D, path):
    """z, W and b' as views 4 bytes past a 16-byte boundary
    (``reshape(-1)[1:]``): the wgmma path's bulk copies widen to the
    boundaries around their bytes and skip the first 4, the mma.sync
    path takes 4-byte copies; ids equal the plain version's on both modes,
    and each launch is counted on the path its D takes."""
    B, I, K = 130, 2001, 10
    zf, Wf, bpf = _on(cuda, *_problem(rng_np, B * D + 1, 1, I * D + 1))
    z = zf.reshape(-1)[1:].reshape(B, D)
    W = Wf.reshape(-1)[1:].reshape(I, D)
    bp = bpf[1:I + 1]
    assert W.data_ptr() % 16 == 4 and bp.data_ptr() % 16 == 4
    rated = _rated_sets(rng_np, B, I, 300)
    rt, rowst = _on(cuda, rated, _dense_rows(rated, I))
    assert P.fused_topk_path(D) == path
    for fn, plain, r in (
            (P.fused_topk_scores, P.fused_topk_scores_plain, rowst),
            (P.fused_topk_scores_csr, P.fused_topk_scores_csr_plain, rt)):
        before = (fn.launches, getattr(fn, "launches_" + path))
        ids, vals = fn(z, W, bp, r, k=K)
        want = plain(z, W, bp, r, k=K)
        torch.cuda.synchronize()
        assert (fn.launches, getattr(fn, "launches_" + path)) == (
            before[0] + 1, before[1] + 1)
        torch.testing.assert_close(ids, want[0])
        torch.testing.assert_close(vals, want[1], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [50, 200])
def test_fused_topk_kernel_candidates_overflow(cuda, rng_np, D):
    """k = 32 where a tile after the first of its split (items 512 to
    639; splits of 5 and 3 tiles on the two paths) holds every row's best
    128 scores (its W rows positive and 100x): each row's pushes overflow
    its 32 candidate slots four times over, and the retries after each
    merge keep the exact top 32 (ids equal, scores to rtol 1e-5)."""
    B, I, K = 130, 40_000, 32
    z, W, bp = _problem(rng_np, B, D, I)
    z = np.abs(z)  # every user scores the hot tile's rows high
    W[512:640] = np.abs(W[512:640]) * 100.0
    rated = _rated_sets(rng_np, B, I, 50)
    for got, want in _both_topk(cuda, z, W, bp, rated, K):
        torch.testing.assert_close(got[0], want[0])
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_fused_topk_csr_kernel_at_the_serving_shape(cuda):
    """B6 at cdae_1m.serve_batch's request, (1,024, 1e6, 50) with rows of
    1 to 2,048 rated items, on the wgmma path with its production grid:
    64 sampled users' lists equal the plain streaming scan's on those
    users (ids equal, scores to rtol 1e-5 and atol 1e-4)."""
    B, I, D, K = 1024, 1_000_000, 50, 10
    g = torch.Generator(device=cuda).manual_seed(23)
    z = torch.rand(B, D, generator=g, device=cuda)
    W = torch.randn(I, D, generator=g, device=cuda) * 0.1
    bp = torch.randn(I, generator=g, device=cuda) * 0.1
    lengths = torch.randint(1, 2049, (B,), generator=g, device=cuda)
    ids = torch.randint(0, I, (B, 2048), generator=g, device=cuda)
    live = torch.arange(2048, device=cuda)[None, :] < lengths[:, None]
    rated = torch.where(live, ids, I).sort(dim=1).values.to(torch.int32)
    before = P.fused_topk_scores_csr.launches_wgmma
    got_ids, got_vals = P.fused_topk_scores_csr(z, W, bp, rated, k=K)
    torch.cuda.synchronize()
    assert P.fused_topk_scores_csr.launches_wgmma == before + 1
    users = torch.randperm(B, generator=g, device=cuda)[:64]
    want = P.fused_topk_scores_csr_plain(z[users], W, bp,
                                         rated[users].contiguous(), k=K)
    torch.testing.assert_close(got_ids[users], want[0])
    torch.testing.assert_close(got_vals[users], want[1], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 50, 100])
@pytest.mark.parametrize("K", [1, 10, 32])
def test_fused_topk_kernel_equal_scores_lower_id_wins(cuda, rng_np, D, K):
    """Dyadic inputs (multiples of 1/64) whose W rows repeat five rows and
    whose b' takes two values: scores are exact in every summation order,
    and a fifth of each row's items tie at its best score. The kernel keeps
    the lower ids on equal scores, exactly as the plain version."""
    B, I = 130, 3001
    base = np.round(rng_np.standard_normal((5, D)) * 16) / 64
    W = base[rng_np.integers(0, 5, I)].astype(np.float32)
    bp = (rng_np.integers(0, 2, I) / 64).astype(np.float32)
    z = (np.round(rng_np.standard_normal((B, D)) * 16) / 64).astype(
        np.float32)
    rated = _rated_sets(rng_np, B, I, 50)
    for got, want in _both_topk(cuda, z, W, bp, rated, K):
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda, rng_np):
    z, W, bp = _on(cuda, *_problem(rng_np, 4, 8, 100))
    with pytest.raises(TypeError):
        P.decode_scores(z.double(), W, bp)
    with pytest.raises(ValueError):
        P.decode_scores(z, W.t(), bp)
    with pytest.raises(TypeError):
        P.fused_topk_scores(z, W, bp, torch.zeros((4, 100), device=cuda))
    with pytest.raises(ValueError):
        P.fused_topk_scores_csr(z, W, bp, torch.zeros((4,), device=cuda,
                                                      dtype=torch.int32))


# ----------------------------------------------------- training kernels ----

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (7, 13), (130, 3706)])
@pytest.mark.parametrize("seed", [0, -7, 2**31 - 1])
def test_hw_uniform_kernel_is_bit_equal(cuda, shape, seed):
    for draw in (0, 1):
        before = P.hw_uniform.launches
        got = P.hw_uniform(seed, shape, draw, device=cuda)
        torch.cuda.synchronize()
        assert P.hw_uniform.launches == before + 1
        assert torch.equal(got, P.hw_uniform_plain(seed, shape, draw,
                                                   device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((301, 7), torch.float32), ((97,), torch.float32),
    ((3706, 50), torch.float32), ((101, 7), torch.bfloat16),
    ((1,), torch.float32),
])
def test_adagrad_update_kernel_is_bit_equal(cuda, rng_np, shape, dtype):
    p = torch.from_numpy(rng_np.standard_normal(shape).astype(np.float32))
    a = torch.from_numpy(np.abs(rng_np.standard_normal(shape))
                         .astype(np.float32) + 1e-4)
    g = torch.from_numpy(rng_np.standard_normal(shape).astype(np.float32))
    p, a, g = p.to(cuda, dtype), a.to(cuda), g.to(cuda)
    want = P.adagrad_update_plain(p.clone(), a.clone(), g, 0.1, 1.0)
    pk, ak = p.clone(), a.clone()
    before = P.adagrad_update.launches
    got = P.adagrad_update(pk, ak, g, 0.1, 1.0)
    torch.cuda.synchronize()
    assert got[0] is pk and got[1] is ak
    assert P.adagrad_update.launches == before + 1
    assert torch.equal(pk, want[0]) and torch.equal(ak, want[1])


# each training path's dense tables at their ML-1M shapes (CDAE D=50; WARP
# and FISM D=10), CDAE's asymmetric set, and odd element counts
_TABLE_SETS = {
    "cdae": [(3706, 50), (3706,), (50,)],
    "cdae_asymmetric": [(301, 7), (301,), (301, 7), (7,)],
    "warp": [(6040, 10), (3706, 10)],
    "fism": [(6040,), (3706, 10), (3706,), (3706, 10)],
    "odd_counts": [(1,), (3,), (5,), (97,), (301, 7), (4099,)],
}


def _adagrad_tables(dev, rng, shapes, bf16=()):
    """(param, acc, grad) per shape on ``dev``; params at the indices in
    ``bf16`` are bfloat16."""
    out = []
    for k, shape in enumerate(shapes):
        p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        a = torch.from_numpy(np.abs(rng.standard_normal(shape))
                             .astype(np.float32) + 1e-4)
        g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        out.append((p.to(dev, torch.bfloat16 if k in bf16 else torch.float32),
                    a.to(dev), g.to(dev)))
    return out


def _check_tables_launch(tables, lr, beta, launches=1):
    """The list kernel on ``tables`` bit for bit against the plain version
    on clones, in ``launches`` launches."""
    want = [(p.clone(), a.clone(), g) for p, a, g in tables]
    P.adagrad_update_tables_plain(want, lr, beta)
    before = P.adagrad_update.launches
    P.adagrad_update_tables(tables, lr, beta)
    torch.cuda.synchronize()
    assert P.adagrad_update.launches == before + launches
    for (p, a, _), (wp, wa, _) in zip(tables, want):
        assert p.dtype == wp.dtype
        assert torch.equal(p, wp) and torch.equal(a, wa)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_TABLE_SETS))
@pytest.mark.parametrize("mixed", [False, True])
def test_adagrad_update_tables_kernel_is_bit_equal(cuda, rng_np, case,
                                                   mixed):
    """One launch over a path's tables, bit-equal to the plain version
    table by table; ``mixed``: every other param in bf16."""
    shapes = _TABLE_SETS[case]
    bf16 = range(0, len(shapes), 2) if mixed else ()
    _check_tables_launch(_adagrad_tables(cuda, rng_np, shapes, bf16), 0.1,
                         0.0 if case in ("warp", "fism") else 1.0)


@pytest.mark.cuda
def test_adagrad_update_tables_misaligned_and_empty(cuda, rng_np):
    """Views 4 bytes (f32) and 2 bytes (bf16) off the 16-byte alignment take
    the scalar path inside the same launch as aligned tables; an empty
    table is skipped."""
    def view(t, dtype=torch.float32):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)
        buf[1:].copy_(t.reshape(-1))
        return buf[1:].view(t.shape)

    tables = _adagrad_tables(cuda, rng_np, [(301, 7), (97,), (50, 10),
                                            (1030,)], bf16=(3,))
    p, a, g = tables[0]
    tables[0] = (view(p), view(a), view(g))  # all three misaligned
    p, a, g = tables[3]
    tables[3] = (view(p, torch.bfloat16), a, g)  # a bf16 param 2 bytes off
    assert tables[0][0].data_ptr() % 16 and tables[3][0].data_ptr() % 8
    empty = tuple(torch.zeros((0, 5), device=cuda) for _ in range(3))
    _check_tables_launch(tables[:2] + [empty] + tables[2:], 0.05, 1.0)
    before = P.adagrad_update.launches
    P.adagrad_update_tables([empty], 0.1)  # nothing to launch
    assert P.adagrad_update.launches == before


@pytest.mark.cuda
def test_adagrad_update_tables_splits_long_lists(cuda, rng_np):
    """Up to 16 tables a launch: 20 tables take two, bit-equal."""
    shapes = [(7 + 13 * k, 3) if k % 2 else (5 + 11 * k,)
              for k in range(20)]
    _check_tables_launch(_adagrad_tables(cuda, rng_np, shapes, bf16=(3,)),
                         0.1, 1.0, launches=2)


@pytest.mark.cuda
def test_adagrad_update_tables_from_threads(cuda, rng_np):
    """The wrapper fills one descriptor buffer under a lock: 8 threads that
    launch at once, a switch interval of 1 us, each update their own
    tables 20 times, bit-equal to the plain version."""
    import sys
    import threading

    sets = [_adagrad_tables(cuda, rng_np, [(97 + 13 * k, 5), (301,)])
            for k in range(8)]
    wants = []
    for tabs in sets:
        want = [(p.clone(), a.clone(), g) for p, a, g in tabs]
        for _ in range(20):
            P.adagrad_update_tables_plain(want, 0.1, 1.0)
        wants.append(want)
    errors = []

    def run(tabs):
        try:
            for _ in range(20):
                P.adagrad_update_tables(tabs, 0.1, 1.0)
        except Exception as e:  # reported by the assert below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in sets]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    torch.cuda.synchronize()
    for tabs, want in zip(sets, wants):
        for (p, a, _), (wp, wa, _) in zip(tabs, want):
            assert torch.equal(p, wp) and torch.equal(a, wa)


@pytest.mark.cuda
def test_adagrad_update_tables_rejects_shared_memory(cuda):
    """A list whose tables would race in one launch raises before it
    launches: a param twice, an acc twice, overlapping views."""
    p, q = torch.zeros((10, 4), device=cuda), torch.zeros((10, 4), device=cuda)
    g = torch.ones((10, 4), device=cuda)

    def acc():
        return torch.full((10, 4), 1e-4, device=cuda)

    buf = torch.zeros(60, device=cuda)
    before = P.adagrad_update.launches
    for tables in ([(p, acc(), g), (p, acc(), g)],
                   [(p, acc(), g), (q, acc(), g), (p, acc(), g)],
                   [(p, buf[:40].view(10, 4), g),
                    (q, buf[20:60].view(10, 4), g)],
                   [(buf[:40].view(10, 4), acc(), g),
                    (buf[20:60].view(10, 4), acc(), g)],
                   [(p, p, g)]):
        with pytest.raises(ValueError):
            P.adagrad_update_tables(tables, 0.1)
    with pytest.raises(ValueError):  # a CPU table in a CUDA list
        P.adagrad_update_tables([(p, acc(), g), (q.cpu(), acc().cpu(),
                                                 g.cpu())], 0.1)
    assert P.adagrad_update.launches == before
    assert not p.any()  # nothing was updated


def _fused_inputs(dev, rng, B, I, D):
    rows = (rng.random((B, I)) < 0.1).astype(np.int8)
    w_user = (rng.random(B) < 0.9).astype(np.float32)
    lengths = rows.sum(1).astype(np.float32) * w_user
    p_neg = np.clip(5 * lengths / np.maximum(I - lengths, 1.0), 0, 1)
    s = 4 * np.sqrt(6 / (I + D))
    arrays = (rows, w_user, p_neg.astype(np.float32),
              (rng.standard_normal((B, D)) * 0.3).astype(np.float32),
              rng.uniform(-s, s, (I, D)).astype(np.float32),
              np.full((I, D), 1e-4, np.float32),
              (rng.standard_normal(I) * 0.1).astype(np.float32),
              np.full(I, 1e-4, np.float32))
    return _on(dev, *arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("B,I,D,act,loss", [
    (1, 5, 7, "tanh", "CE"),
    (37, 999, 7, "linear", "SQUARE"),
    (70, 300, 200, "sigmoid", "LOG"),
    (33, 1000, 50, "sigmoid", "HINGE"),
])
def test_fused_step_kernel_matches_plain(cuda, rng_np, B, I, D, act, loss):
    ins = _fused_inputs(cuda, rng_np, B, I, D)
    kw = dict(q=0.5, scale=2.0, lam=0.01, lr=0.1, beta=0.0, use_ada=True,
              act=act, loss_name=loss)
    want = F.cdae_dense_step_fused_plain(77, *ins[:4],
                                         *(t.clone() for t in ins[4:]), **kw)
    before = F.cdae_dense_step_fused.launches
    got = F.cdae_dense_step_fused(77, *ins[:4],
                                  *(t.clone() for t in ins[4:]), **kw)
    torch.cuda.synchronize()
    assert F.cdae_dense_step_fused.launches == before + 1
    for name, g, w in zip(("W", "W_ag", "b_prime", "bp_ag", "hg"), got,
                          want):
        # 1e-5 of the output's scale: f32 sums in another order, carried
        # through AdaGrad's first step (lr / sqrt(1e-4) = 10x)
        atol = 1e-5 * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w, rtol=3e-4, atol=10 * atol, msg=name)


def _fused_kw(act, loss, use_ada=True, beta=0.0):
    return dict(q=0.5, scale=2.0, lam=0.01, lr=0.1, beta=beta,
                use_ada=use_ada, act=act, loss_name=loss)


def _check_fused_step(dev, ins, kw):
    """The kernel against the plain version (1e-5 of each output's scale:
    f32 sums in another order, carried through AdaGrad's first step, lr /
    sqrt(1e-4) = 10x), and a second launch on the same inputs bit-equal."""
    want = F.cdae_dense_step_fused_plain(77, *ins[:4],
                                         *(t.clone() for t in ins[4:]), **kw)
    before = F.cdae_dense_step_fused.launches
    got = F.cdae_dense_step_fused(77, *ins[:4],
                                  *(t.clone() for t in ins[4:]), **kw)
    again = F.cdae_dense_step_fused(77, *ins[:4],
                                    *(t.clone() for t in ins[4:]), **kw)
    torch.cuda.synchronize()
    assert F.cdae_dense_step_fused.launches == before + 2
    for name, g, a, w in zip(("W", "W_ag", "b_prime", "bp_ag", "hg"), got,
                             again, want):
        assert torch.equal(g, a), name
        atol = 1e-5 * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w, rtol=3e-4, atol=10 * atol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [7, 50, 200, 256])
@pytest.mark.parametrize("B,I", [(70, 333), (129, 1001)])
def test_fused_step_kernel_tile_edges(cuda, rng_np, B, I, D):
    """B4 at D from 7 to its limit of 256 (one to four d n-tiles a warp),
    B off the 64-user tile and the 32-user chunk, I off the 32-item chunk,
    w_user zero on about a tenth of the rows and on the last nine (a
    wrapped last batch): within tolerance of the plain version and the
    same bits on a second launch. beta = 1, as chip_smoke.py's B4 check:
    with beta = 0 AdaGrad's first step divides by sqrt(1e-4) and turns the
    f32 rounding of a near-zero gradient (both versions') into 1e-4."""
    ins = _fused_inputs(cuda, rng_np, B, I, D)
    ins[1][-9:] = 0.0  # a wrapped last batch
    _check_fused_step(cuda, ins, _fused_kw("sigmoid", "SQUARE", beta=1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["sigmoid", "tanh", "linear"])
@pytest.mark.parametrize("loss", ["SQUARE", "LOGISTIC", "CROSS_ENTROPY",
                                  "LOG", "LOGM", "HINGE", "SQUARED_HINGE"])
def test_fused_step_kernel_every_activation_and_loss(cuda, rng_np, act,
                                                     loss):
    """B4 with each activation and each loss (AdaGrad; SGD on the
    linear activation), within tolerance of the plain version and the same
    bits on a second launch."""
    ins = _fused_inputs(cuda, rng_np, 45, 500, 50)
    _check_fused_step(cuda, ins, _fused_kw(act, loss, act != "linear"))


@pytest.mark.cuda
def test_training_kernels_reject_bad_inputs(cuda, rng_np):
    p = torch.zeros((4, 3), device=cuda)
    with pytest.raises(TypeError):
        P.adagrad_update(p.double(), p.double(), p, 0.1)
    with pytest.raises(ValueError):
        P.adagrad_update(p, torch.zeros((3, 4), device=cuda), p, 0.1)
    with pytest.raises(ValueError):
        P.adagrad_update(p, p.clone(), torch.zeros((4, 3)), 0.1)  # CPU grad
    ins = _fused_inputs(cuda, rng_np, 4, 10, 3)
    kw = dict(q=0.5, scale=2.0, lam=0.01, lr=0.1, beta=0.0, use_ada=True,
              act="sigmoid", loss_name="SQUARE")
    with pytest.raises(TypeError):
        F.cdae_dense_step_fused(1, ins[0].float(), *ins[1:], **kw)
    with pytest.raises(ValueError):
        wide = torch.zeros((10, 300), device=cuda)
        F.cdae_dense_step_fused(1, *ins[:4], wide, wide.clone(), *ins[6:],
                                **kw)
    with pytest.raises(ValueError):
        F.cdae_dense_step_fused(1, *ins, **{**kw, "act": "relu"})


# ------------------------------------------------- WARP violator kernel ----

def _warp_inputs(rng, B, I, D, rated=0.04):
    """Dyadic inputs (multiples of 1/64, small): every score is exact in
    f32 whatever the order of the sums, so the kernel and the library
    GEMM of the plain version agree on every comparison with thr. thr is
    one rated item's score minus 1, as WARP's step passes it."""
    uv = np.round(rng.standard_normal((B, D)) * 32) / 64
    iv = np.round(rng.standard_normal((I, D)) * 32) / 64
    ib = np.round(rng.standard_normal(I) * 32) / 64
    mask = (rng.random((B, I)) < rated).astype(np.int8)
    pos = rng.integers(0, I, B)
    mask[np.arange(B), pos] = 1
    thr = (uv * iv[pos]).sum(1) + ib[pos] - 1.0
    f32 = np.float32
    return uv.astype(f32), iv.astype(f32), ib.astype(f32), thr.astype(f32), \
        mask


@pytest.mark.cuda
@pytest.mark.parametrize("B,I,D,nn,noise", [
    (21, 333, 7, 4, "mshift"),
    (1, 5, 3, 1, "hash"),
    (130, 3706, 10, 5, "mshift"),
    (33, 999, 50, 9, "hash"),
    (70, 2000, 128, 32, "mshift"),
])
def test_warp_violator_select_kernel_is_exact(cuda, rng_np, B, I, D, nn,
                                              noise):
    ins = _on(cuda, *_warp_inputs(rng_np, B, I, D))
    for seed in (42, -7):
        want = P.warp_violator_select_plain(seed, *ins, nn, noise=noise)
        before = P.warp_violator_select.launches
        got = P.warp_violator_select(seed, *ins, nn, noise=noise)
        torch.cuda.synchronize()
        assert P.warp_violator_select.launches == before + 1
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_warp_violator_select_kernel_rows_without_violators(cuda, rng_np):
    uv, iv, ib, thr, mask = _on(cuda, *_warp_inputs(rng_np, 40, 300, 10))
    thr[:10] = float("inf")  # no violator: count 0, every pick 0
    mask[10:20] = 1  # everything rated
    nviol, j = P.warp_violator_select(3, uv, iv, ib, thr, mask, 5)
    want = P.warp_violator_select_plain(3, uv, iv, ib, thr, mask, 5)
    assert torch.equal(nviol, want[0]) and torch.equal(j, want[1])
    assert not nviol[:20].any() and not j[:20].any()


@pytest.mark.cuda
@pytest.mark.parametrize("I", [1000, 12000])
@pytest.mark.parametrize("D", [1, 10, 128])
@pytest.mark.parametrize("nn", [1, 5, 8, 9, 32])
def test_warp_violator_select_kernel_tile_edges(cuda, rng_np, I, D, nn):
    """B = 45 and I off the kernel's tiles (32 or 16 rows a block,
    128-column chunks; one catalog split at D = 1 and 10 with I = 1000,
    several at D = 128 and at I = 12000, merged in the launch), D from 1 to
    128, nn on both sides of the 8-slot variant; a fully rated row and a
    row with no violator; both noises: counts and picks exactly the plain
    version's."""
    uv, iv, ib, thr, mask = _on(cuda, *_warp_inputs(rng_np, 45, I, D))
    mask[3] = 1  # fully rated
    thr[7] = float("inf")  # no violator
    for noise in ("mshift", "hash"):
        want = P.warp_violator_select_plain(99, uv, iv, ib, thr, mask, nn,
                                            noise=noise)
        before = P.warp_violator_select.launches
        got = P.warp_violator_select(99, uv, iv, ib, thr, mask, nn,
                                     noise=noise)
        torch.cuda.synchronize()
        assert P.warp_violator_select.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[0][3] == 0 and got[0][7] == 0
        assert not got[1][3].any() and not got[1][7].any()
        assert (got[0] > 0).sum() >= 40


@pytest.mark.cuda
def test_warp_violator_select_kernel_uniformity(cuda):
    """tests/test_pallas.py's chi-square of the mshift picks (every item a
    violator), on the kernel: pooled over 8 seeds, bound 330 at dof 255."""
    B, I, D, nn = 64, 256, 4, 4
    ones = torch.ones
    counts = torch.zeros(I, dtype=torch.float64, device=cuda)
    for s in range(8):
        _, j = P.warp_violator_select(
            1000 + s * 7919, ones((B, D), device=cuda),
            ones((I, D), device=cuda), torch.zeros(I, device=cuda),
            torch.full((B,), -1e9, device=cuda),
            torch.zeros((B, I), dtype=torch.int8, device=cuda), nn)
        counts += torch.bincount(j.reshape(-1).long(), minlength=I)
    E = counts.sum() / I
    assert float(((counts - E) ** 2 / E).sum()) < 330.0


@pytest.mark.cuda
def test_warp_violator_select_rejects_bad_inputs(cuda, rng_np):
    uv, iv, ib, thr, mask = _on(cuda, *_warp_inputs(rng_np, 4, 50, 6))
    with pytest.raises(ValueError):
        P.warp_violator_select(1, uv, iv, ib, thr, mask, 33)
    with pytest.raises(NotImplementedError):
        P.warp_violator_select(1, uv, iv, ib, thr, mask, 5, noise="hw")
    with pytest.raises(TypeError):
        P.warp_violator_select(1, uv, iv, ib, thr, mask.float(), 5)
    with pytest.raises(ValueError):
        wide = torch.zeros((50, 129), device=cuda)
        P.warp_violator_select(1, torch.zeros((4, 129), device=cuda), wide,
                               ib, thr, mask, 5)


# ------------------------------------------- row aggregation and gather ----

def _agg_inputs(rng, Pn, N, C):
    shape = (Pn,) if C is None else (Pn, C)
    vals = rng.standard_normal(shape).astype(np.float32)
    idx = rng.integers(0, N, Pn).astype(np.int64)
    idx[: Pn // 10] = N  # the sentinel
    idx[Pn // 10: Pn // 8] = -3
    return rng.permutation(idx), vals


@pytest.mark.cuda
@pytest.mark.parametrize("Pn,N,C", [
    (0, 7, 5), (1, 1, 1), (333, 17, None), (5000, 301, 11),
    (49152, 3706, 11), (8192, 6040, 10), (20000, 100, 70),
])
@pytest.mark.parametrize("bf16", [False, True])
def test_scatter_matmul_kernel_matches_plain(cuda, rng_np, Pn, N, C, bf16):
    """B8 against its plain version: f32 sums in another order, so rtol
    1e-5 and atol 1e-6 of the largest row sum; two launches on one input
    give the same bits (no atomics)."""
    idx, vals = _on(cuda, *_agg_inputs(rng_np, Pn, N, C))
    want = P.scatter_matmul_plain(idx, vals, N, bf16=bf16)
    before = P.scatter_matmul.launches
    got = P.scatter_matmul(idx, vals, N, bf16=bf16)
    again = P.scatter_matmul(idx, vals, N, bf16=bf16)
    torch.cuda.synchronize()
    assert P.scatter_matmul.launches == before + 2
    assert torch.equal(got, again)
    scale = max(float(want.abs().max()) if want.numel() else 0.0, 1.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)
    dead = torch.zeros(N, dtype=torch.bool, device=cuda)
    live = (idx >= 0) & (idx < N)
    dead[idx[live]] = True
    assert not got[~dead].any()  # rows no live id reaches stay zero


@pytest.mark.cuda
@pytest.mark.parametrize("Pn,N", [(0, 7), (1, 1), (5000, 37), (49152, 3706),
                                  (300000, 3706), (8192, 70000),
                                  (100000, 2**20)])
def test_scatter_plan_kernel_equals_torch_sort(cuda, rng_np, Pn, N):
    """B8's radix-sort plan (1 to 3 passes of 8 bits) against the plain
    plan, the library's stable sort: the same order (stability) and the
    same segment starts, on every launch."""
    idx, _ = _agg_inputs(rng_np, Pn, N, 1)
    idx = torch.from_numpy(idx).to(cuda)
    want = P.scatter_plan_plain(idx, N)
    before = P.scatter_plan.launches
    got = P.scatter_plan(idx, N)
    again = P.scatter_plan(idx, N)
    torch.cuda.synchronize()
    assert P.scatter_plan.launches == before + 2
    for a, b, c in zip(got, again, want):
        assert a.dtype == torch.int32 and torch.equal(a, c)
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 10, 11, 32, 33, 64])
@pytest.mark.parametrize("Pn,N", [(600, 3706), (49152, 3706),
                                  (300000, 3706), (8192, 6040)])
@pytest.mark.parametrize("bf16", [False, True])
def test_scatter_reduce_lane_groups(cuda, rng_np, C, Pn, N, bf16):
    """The reduce's lane groups (C rounded up to a power of two, groups a
    row from the mean segment length) within the plain version's
    tolerance, the same bits on a second launch, and over a prefix of the
    ids the same bits with the longer vector's plan (limit) as with the
    prefix's own."""
    idx, vals = _on(cuda, *_agg_inputs(rng_np, Pn, N, C))
    want = P.scatter_matmul_plain(idx, vals, N, bf16=bf16)
    plan = P.scatter_plan(idx, N)
    got = P.scatter_matmul(idx, vals, N, bf16=bf16, plan=plan)
    again = P.scatter_matmul(idx, vals, N, bf16=bf16, plan=plan)
    head = Pn // 3
    own = P.scatter_matmul(idx[:head], vals[:head], N, bf16=bf16)
    shared = P.scatter_matmul(idx[:head], vals[:head], N, bf16=bf16,
                              plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(own, shared)
    scale = max(float(want.abs().max()), 1.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [None, 1, 11, 33])
def test_scatter_matmul_kernel_all_ids_out_of_range(cuda, rng_np, C):
    Pn, N = 5000, 300
    idx, vals = _on(cuda, *_agg_inputs(rng_np, Pn, N, C))
    idx = torch.where(idx % 2 == 0, N + idx.abs(), -1 - idx.abs())
    plan = P.scatter_plan(idx, N)
    got = P.scatter_matmul(idx, vals, N, plan=plan)
    torch.cuda.synchronize()
    assert not plan.offsets.any() and not got.any()
    assert tuple(got.shape) == (N,) + tuple(vals.shape[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("Pn,N,C", [(0, 5, 3), (301, 777, 13), (400, 50, 11),
                                   (49152, 3706, 11), (8192, 6040, 10),
                                   (100, 9, 4), (65, 20, 128)])
def test_gather_rows_kernel_is_exact(cuda, rng_np, Pn, N, C):
    table = torch.from_numpy(rng_np.standard_normal((N, C))
                             .astype(np.float32)).to(cuda)
    idx, _ = _agg_inputs(rng_np, Pn, N, 1)
    idx = torch.from_numpy(idx).to(cuda)
    before = P.gather_rows_mxu.launches
    got = P.gather_rows_mxu(table, idx)
    torch.cuda.synchronize()
    assert P.gather_rows_mxu.launches == before + (1 if Pn > 0 else 0)
    assert torch.equal(got, P.gather_rows_mxu_plain(table, idx))
    out = (idx < 0) | (idx >= N)
    assert not got[out].any()
    # an offset view whose rows are not 16-byte aligned takes narrower
    # vectors and stays exact
    if C % 4 == 0 and N > 1:
        view = table.reshape(-1)[1: 1 + (N - 1) * C].reshape(N - 1, C)
        ids = idx.clamp(-1, N - 1)
        assert torch.equal(P.gather_rows_mxu(view, ids),
                           P.gather_rows_mxu_plain(view, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2, 3, 4, 11, 64])
@pytest.mark.parametrize("Pn", [0, 1, 63, 65, 1000])
def test_gather_rows_kernel_widths(cuda, rng_np, C, Pn):
    """B9 at widths whose 16-byte output quads span rows (C = 1, 2, 3,
    11) or lie in one (C = 4, 64), P off the 64-row block, ids out of
    range: exact, zero rows where out of range."""
    N = 300
    table = torch.from_numpy(rng_np.standard_normal((N, C))
                             .astype(np.float32)).to(cuda)
    idx, _ = _agg_inputs(rng_np, Pn, N, 1)
    idx = torch.from_numpy(idx).to(cuda)
    before = P.gather_rows_mxu.launches
    got = P.gather_rows_mxu(table, idx)
    torch.cuda.synchronize()
    assert P.gather_rows_mxu.launches == before + (1 if Pn > 0 else 0)
    assert tuple(got.shape) == (Pn, C)
    assert torch.equal(got, P.gather_rows_mxu_plain(table, idx))
    assert not got[(idx < 0) | (idx >= N)].any()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["auto", "matmul", "factored",
                                  "factored_bf16", "sort", "pallas",
                                  "pallas_bf16", "scatter"])
def test_scatter_add_rows_modes_on_the_card(cuda, rng_np, mode):
    """On CUDA tensors every fixed-order mode runs B8 (one plan, one
    reduce, the same bits on a second call) within its plain version's
    tolerance; "scatter" stays one index_add and launches no B8."""
    from cdae_tpu_torch.ops.scatter import row_plan, scatter_add_rows

    idx, vals = _on(cuda, *_agg_inputs(rng_np, 5000, 301, 11))
    base = torch.from_numpy(rng_np.standard_normal((301, 11))
                            .astype(np.float32)).to(cuda)
    counts = (P.scatter_plan.launches, P.scatter_matmul.launches)
    plan = row_plan(idx, 301, mode)
    got = scatter_add_rows(base, idx, vals, mode=mode, plan=plan)
    again = scatter_add_rows(base, idx, vals, mode=mode, plan=plan)
    torch.cuda.synchronize()
    b8 = mode != "scatter"
    assert (plan is not None) == b8
    assert P.scatter_plan.launches == counts[0] + b8
    assert P.scatter_matmul.launches == counts[1] + 2 * b8
    want = base + P.scatter_matmul_plain(idx, vals, 301,
                                         bf16=mode.endswith("bf16"))
    scale = max(float(want.abs().max()), 1.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)
    if b8:
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_warp_default_route_is_bit_reproducible(cuda):
    """Two 2-epoch WARP runs on the default route (B7, and scatter_mode
    "auto", which runs B8) from one seed give the same bits: the card
    sums every row in a fixed order, so a resumed run replays the
    unbroken one."""
    from cdae_tpu_torch.data.synthetic import lowrank_interactions
    from cdae_tpu_torch.models.mf import WARP, MFConfig

    data = lowrank_interactions(300, 500, 30, seed=3)

    def run():
        model = WARP(MFConfig(num_dim=8, batch_size=512, loss="HINGE",
                              beta=0.0, lambda_=0.1), device="cuda")
        assert model.cfg.scatter_mode == "auto" and model.cfg.use_pallas
        state = model.reset(data, seed=1)
        before = P.scatter_matmul.launches
        for _ in range(2):
            model.train_one_iteration(state, 5)
        torch.cuda.synchronize()
        return state.params, P.scatter_matmul.launches - before

    (a, na), (b, nb) = run(), run()
    assert na == nb == 2 * 2 * -(-len(data) // 512)  # items, users
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_row_kernels_reject_bad_inputs(cuda):
    v = torch.ones((4, 3), device=cuda)
    with pytest.raises(TypeError):
        P.scatter_matmul(torch.zeros(4, dtype=torch.int32, device=cuda), v, 5)
    with pytest.raises(ValueError):
        P.scatter_matmul(torch.zeros(3, dtype=torch.long, device=cuda), v, 5)
    with pytest.raises(TypeError):
        P.gather_rows_mxu(v.double(), torch.zeros(2, dtype=torch.long,
                                                  device=cuda))
    with pytest.raises(ValueError):
        P.gather_rows_mxu(v, torch.zeros(2, dtype=torch.long))  # CPU ids


@pytest.mark.cuda
def test_cuda_paths_launch_the_row_kernels(cuda, rng_np):
    """scatter_add_rows(mode="pallas"), a FISM sparse step (auto runs B8
    on CUDA) and a WARP step with gather_mode="mxu" on CUDA tensors raise
    the kernels' counters: the CUDA path never takes a plain version."""
    from cdae_tpu_torch.data.synthetic import lowrank_interactions
    from cdae_tpu_torch.models.fism import FISM, FISMConfig
    from cdae_tpu_torch.models.mf import WARP, MFConfig
    from cdae_tpu_torch.ops.scatter import scatter_add_rows

    before = P.scatter_matmul.launches
    out = scatter_add_rows(torch.zeros((5, 2), device=cuda),
                           torch.tensor([0, 4, 4, 5], device=cuda),
                           torch.ones((4, 2), device=cuda), mode="pallas")
    assert P.scatter_matmul.launches == before + 1
    assert out.tolist() == [[1, 1], [0, 0], [0, 0], [0, 0], [2, 2]]

    data = lowrank_interactions(60, 80, 10, seed=3)
    model = FISM(FISMConfig(num_dim=6, num_neg=2, batch_size=16,
                            dense_mode=False), device="cuda")
    assert model.cfg.scatter_mode == "auto"
    state = model.reset(data, seed=1)
    counts = (P.scatter_matmul.launches, P.adagrad_update.launches,
              P.scatter_plan.launches)
    model.train_one_iteration(state, 5)
    steps = len(state.aux["sparse_batches"])
    assert P.scatter_matmul.launches == counts[0] + 2 * steps  # Q+bi, P
    assert P.adagrad_update.launches == counts[1] + steps  # bu, Q, bi, P
    assert P.scatter_plan.launches == counts[2] + steps  # one shared plan

    warp = WARP(MFConfig(num_dim=6, batch_size=64, gather_mode="mxu",
                         scatter_mode="pallas", loss="HINGE", beta=0.0,
                         lambda_=0.1), device="cuda")
    ws = warp.reset(data, seed=1)
    counts = (P.gather_rows_mxu.launches, P.scatter_matmul.launches,
              P.warp_violator_select.launches, P.scatter_plan.launches,
              P.adagrad_update.launches)
    warp.train_one_iteration(ws, 5)
    n = -(-len(data) // 64)
    assert P.gather_rows_mxu.launches == counts[0] + 2 * n
    assert P.scatter_matmul.launches == counts[1] + 2 * n
    assert P.warp_violator_select.launches == counts[2] + n
    assert P.scatter_plan.launches == counts[3] + 2 * n  # items, users
    assert P.adagrad_update.launches == counts[4] + n  # uv, iv


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["cdae", "cdae_asymmetric", "cdae_fused",
                                  "fism_slab"])
def test_training_paths_launch_adagrad_once_a_step(cuda, path):
    """A step's dense tables take one launch of B2: CDAE's W, b' and b (and
    V when asymmetric) unfused, its b after the fused step, FISM's bu, Q,
    bi and P on the slab route (the sparse route and WARP's uv and iv:
    above)."""
    from cdae_tpu_torch.data.synthetic import lowrank_interactions
    from cdae_tpu_torch.models.cdae import CDAE, CDAEConfig
    from cdae_tpu_torch.models.fism import FISM, FISMConfig

    data = lowrank_interactions(60, 80, 10, seed=3)
    if path == "fism_slab":
        model = FISM(FISMConfig(num_dim=6, num_neg=2, batch_size=16),
                     device="cuda")
    else:
        model = CDAE(CDAEConfig(num_dim=6, corruption_ratio=0.5, num_neg=2,
                                batch_size=16,
                                asymmetric=path == "cdae_asymmetric",
                                fused_step=path == "cdae_fused"),
                     device="cuda")
    state = model.reset(data, seed=1)
    assert "dense_R" in state.aux
    before = P.adagrad_update.launches
    model.train_one_iteration(state, 5)
    steps = state.aux["dense_batches"][0].shape[0]
    assert steps > 1
    assert P.adagrad_update.launches == before + steps


# ------------------------------------------------- CDAE's sparse step ----

def _sparse_cdae(device, **kw):
    """A CDAE on low-rank data (dense_mode False unless ``kw`` says), and
    its reset state."""
    from cdae_tpu_torch.data.synthetic import lowrank_interactions
    from cdae_tpu_torch.models.cdae import CDAE, CDAEConfig

    data = lowrank_interactions(300, 500, 30, seed=3)
    cfg = dict(num_dim=16, corruption_ratio=0.5, num_neg=3, batch_size=64,
               loss="SQUARE", dense_mode=False)
    model = CDAE(CDAEConfig(**{**cfg, **kw}), device=device)
    return model, model.reset(data, seed=1)


_SPARSE_CASES = {"exact": {}, "pool": dict(neg_pool=256),
                 "asymmetric": dict(asymmetric=True),
                 "unpacked": dict(packed_io=False),
                 "row_update": dict(row_update=True),
                 "row_update_pool": dict(row_update=True, neg_pool=256)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_SPARSE_CASES))
def test_cdae_sparse_epoch_kernels_match_plain(cuda, case):
    """One sparse epoch with the kernels (B1's hash draws, B8's sums, B2)
    against one with their plain versions (use_pallas off: the same hash
    draws, index_add_ sums, the plain AdaGrad) from the same reset: every
    table within 1e-4 relative (the sums run in another order); the
    kernel run launches B2 once a step and B8 and B1 every step, the plain
    run none of them."""
    kw = dict(_SPARSE_CASES[case], fast_rng=True)
    params = {}
    for use_pallas in (True, False):
        model, state = _sparse_cdae("cuda", use_pallas=use_pallas, **kw)
        assert "dense_R" not in state.aux
        counts = (P.adagrad_update.launches, P.scatter_plan.launches,
                  P.scatter_matmul.launches, P.hw_uniform.launches)
        model.train_one_iteration(state, 7)
        steps = len(state.aux["device_batches"])
        now = (P.adagrad_update.launches, P.scatter_plan.launches,
               P.scatter_matmul.launches, P.hw_uniform.launches)
        if use_pallas:
            assert now[0] == counts[0] + steps
            assert now[1] > counts[1] + steps and now[2] > counts[2] + steps
            assert now[3] >= counts[3] + steps
        else:
            assert now == counts
        params[use_pallas] = state.params
    for k, want in params[False].items():
        got = params[True][k]
        rel = ((got.double() - want.double()).norm()
               / want.double().norm().clamp_min(1e-30)).item()
        assert rel <= 1e-4, (k, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["exact", "pool", "row_update",
                                  "row_update_pool"])
def test_cdae_sparse_runs_are_bit_equal(cuda, case):
    """Two 2-epoch sparse runs from one reset give the same bits: every
    row aggregation, row_update's delta-adds included, sums in B8's fixed
    order."""
    runs = []
    for _ in range(2):
        model, state = _sparse_cdae("cuda", **_SPARSE_CASES[case])
        model.train_epochs(state, 2, 11)
        runs.append(state.params)
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


@pytest.mark.cuda
def test_cdae_sparse_step_equals_dense_step_without_draws(cuda):
    """With corruption 0 and no negatives the sparse and dense steps are
    the same math (tests/test_dense_mode.py's identity): one step of each
    from one reset on the same users agrees to rtol 2e-5 / atol 1e-6."""
    from cdae_tpu_torch.models.base import iter_user_batches
    from cdae_tpu_torch.models.cdae import _dense_train_step, _train_step

    kw = dict(corruption_ratio=0.0, num_neg=0, bucket_by_length=False)
    model, state = _sparse_cdae("cuda", **kw)
    dense, dstate = _sparse_cdae("cuda", dense_mode=True, **kw)
    assert "dense_R" in dstate.aux and "dense_R" not in state.aux
    b = next(iter_user_batches(state.padded, model.cfg.batch_size))
    uids, items, mask, lengths, weight = (
        torch.as_tensor(x, device="cuda")
        for x in (b.uids, b.items, b.mask, b.lengths, b.weight))
    _train_step(state.params, uids.long(), items.long(), mask,
                lengths.long(), weight, 3, cfg=model.cfg, loss=model.loss,
                coll=state.aux["coll"])
    _dense_train_step(dstate.params, dstate.aux["dense_R"], uids.long(),
                      weight, 3, cfg=dense.cfg, loss=dense.loss,
                      coll=dstate.aux["coll"])
    for k in state.params:
        torch.testing.assert_close(state.params[k], dstate.params[k],
                                   rtol=2e-5, atol=1e-6)


# ------------------------------------ the MF family's other routes ----

_MF_ROUTES = {
    # name: (model, config, rated data)
    "imf_slab": ("IMF", dict(fast_rng=True), False),
    "imf_sparse": ("IMF", dict(dense_mode=False, fast_rng=True), False),
    "imf_sparse_row_update": ("IMF", dict(dense_mode=False, row_update=True),
                              False),
    "pmf_slab": ("PMF", {}, True),
    "pmf_sparse": ("PMF", dict(dense_mode=False), True),
    "bpr_sparse": ("BPR", dict(fast_rng=True), False),
    "bpr_slab": ("BPR", dict(dense_mode=True, num_shared_neg=4,
                             fast_rng=True), False),
    "warp_slab": ("WARP", dict(dense_mode=True, warp_pool=128,
                               fast_rng=True), False),
    "warp_pool_mask": ("WARP", dict(warp_pool=128, fast_rng=True), False),
    "warp_pool_csr": ("WARP", dict(warp_pool=128, dense_mode=False,
                                   fast_rng=True), False),
    "warp_scan": ("WARP", dict(dense_mode=False, num_tries=16,
                               fast_rng=True), False),
}


def _mf(route, device, **kw):
    """The route's model on low-rank data of 60 users x 80 items (rated
    for PMF), batch 1024: one step (or one slab) an epoch. Returns the
    model and its reset state."""
    from cdae_tpu_torch.data.synthetic import (lowrank_interactions,
                                               lowrank_rated)
    from cdae_tpu_torch.models import mf

    name, cfg, rated = _MF_ROUTES[route]
    data = (lowrank_rated if rated else lowrank_interactions)(60, 80, 10,
                                                              seed=3)
    base = dict(num_dim=8, num_neg=3, batch_size=1024,
                loss={"BPR": "LOG", "WARP": "HINGE"}.get(name, "SQUARE"))
    if name == "WARP":
        base.update(beta=0.0, lambda_=0.1)
    model = getattr(mf, name)(mf.MFConfig(**{**base, **cfg, **kw}),
                              device=device)
    return model, model.reset(data, seed=1)


def _rel(a, b):
    return ((a.double() - b.double()).norm()
            / b.double().norm().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(_MF_ROUTES))
def test_mf_route_step_kernels_match_plain(cuda, route):
    """One step of each new MF route with the kernels (B1's hash draws, B8's
    sums, B2) against one with their plain versions (use_pallas off: the
    same hash draws from the plain hash, index_add_ sums, the plain
    AdaGrad) from the same reset: every table within 1e-4 relative. The
    kernel step launches B2 once (none with row_update, whose touched rows
    sum through B8), B8 at least once, and B1 where it draws with
    fast_rng; the plain step none of them."""
    params = {}
    for use_pallas in (True, False):
        kw = dict(use_pallas=use_pallas)
        if not use_pallas:
            kw["scatter_mode"] = "scatter"
        model, state = _mf(route, "cuda", **kw)
        counts = (P.adagrad_update.launches, P.scatter_matmul.launches,
                  P.scatter_plan.launches, P.hw_uniform.launches)
        model.train_one_iteration(state, 7)
        torch.cuda.synchronize()
        now = (P.adagrad_update.launches, P.scatter_matmul.launches,
               P.scatter_plan.launches, P.hw_uniform.launches)
        if use_pallas:
            assert now[0] == counts[0] + (0 if model.cfg.row_update else 1)
            assert now[1] > counts[1] and now[2] > counts[2]
            assert (now[3] > counts[3]) == model.cfg.fast_rng
        else:
            assert now == counts
        params[use_pallas] = state.params
    for k, want in params[False].items():
        assert _rel(params[True][k], want) <= 1e-4, (route, k)


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(_MF_ROUTES))
def test_mf_default_routes_are_bit_reproducible(cuda, route):
    """Two 2-epoch runs of each route on its defaults (scatter_mode auto,
    which runs B8 on the card) give the same bits."""
    runs = []
    for _ in range(2):
        model, state = _mf(route, "cuda", batch_size=128)
        assert model.cfg.scatter_mode == "auto" and model.cfg.use_pallas
        for _ in range(2):
            model.train_one_iteration(state, 5)
        torch.cuda.synchronize()
        runs.append(state.params)
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), (route, k)


@pytest.mark.cuda
def test_mf_pool_path_mask_equals_csr_on_the_card(cuda):
    """WARP's pool path with the (U, I) rated mask and with the CSR rows
    gives the same bits over 2 epochs (the same draws and truth table)."""
    out = []
    for route in ("warp_pool_mask", "warp_pool_csr"):
        model, state = _mf(route, "cuda", batch_size=128)
        assert bool(model._epoch_extras(state)) == (route == "warp_pool_mask")
        for _ in range(2):
            model.train_one_iteration(state, 5)
        out.append(state.params)
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


@pytest.mark.cuda
def test_imf_mxu_gather_launches_b9_and_changes_no_bit(cuda):
    """IMF's sparse step with gather_mode="mxu" gathers its rows with B9
    (two launches a step: users, items) and gives the native gather's
    bits."""
    out = []
    for mode in ("mxu", "native"):
        model, state = _mf("imf_sparse", "cuda", gather_mode=mode,
                           batch_size=128)
        before = P.gather_rows_mxu.launches
        model.train_one_iteration(state, 5)
        steps = -(-len(state.aux["coo"][0]) // 128)
        assert P.gather_rows_mxu.launches - before == (
            2 * steps if mode == "mxu" else 0)
        out.append(state.params)
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


class _FailingLib:
    """The kernel library with one entry point reporting a launch error."""

    def __init__(self, real, name):
        self._real, self._name = real, name

    def __getattr__(self, attr):
        if attr == self._name:
            return lambda *args: 1  # cudaErrorInvalidValue
        return getattr(self._real, attr)


@pytest.mark.cuda
@pytest.mark.parametrize("route,entry", [
    ("imf_slab", "cdae_scatter_reduce"),
    ("imf_slab", "cdae_hw_uniform"),
    ("bpr_sparse", "cdae_scatter_reduce"),
    ("warp_scan", "cdae_hw_uniform"),
])
def test_mf_routes_do_not_fall_back(cuda, monkeypatch, route, entry):
    """A kernel of a new path that fails to launch raises: the step does
    not fall back to a plain version."""
    from cdae_tpu_torch.ops import cuda_lib

    model, state = _mf(route, "cuda")
    monkeypatch.setattr(cuda_lib, "_lib", _FailingLib(cuda_lib.lib(), entry))
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        model.train_one_iteration(state, 5)


# ------------------------------------------- ALS/WRMF and ItemCF/UserCF ----

def _cf_data():
    from cdae_tpu_torch.data.synthetic import lowrank_interactions

    return lowrank_interactions(400, 300, 15, seed=4).split_by_user(0.2,
                                                                    seed=4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ItemCF", "UserCF"])
@pytest.mark.parametrize("sim_type", ["JACCARD", "COSINE"])
def test_cf_scoring_on_b8_matches_plain_and_repeats(cuda, name, sim_type):
    """The neighbour lists on the card equal the CPU's; the CF scores
    through B8 (one plan and one reduce a batch) match B8's plain version
    on the same device tensors to B8's tolerance and are the same bits on
    a second call, as are the TOPN top-10 lists."""
    from cdae_tpu_torch.evaluation import Evaluation
    from cdae_tpu_torch.models import similarity as S
    from cdae_tpu_torch.ops import scatter

    train, test = _cf_data()
    cfg = S.SimilarityConfig(sim_type=sim_type, topk=30, block_size=128)
    gm, cm = getattr(S, name)(cfg, device="cuda"), getattr(S, name)(
        cfg, device="cpu")
    gs, cs = gm.reset(train), cm.reset(train)
    assert torch.equal(gs.params["nbr_ids"].cpu(), cs.params["nbr_ids"])
    torch.testing.assert_close(gs.params["nbr_sims"].cpu(),
                               cs.params["nbr_sims"], rtol=1e-6, atol=0)
    pb = gs.padded
    uids = np.arange(0, train.num_users, 2)
    launches = P.scatter_matmul.launches
    a = gm.batch_scores(gs, uids, pb.items[uids], pb.mask[uids])
    b = gm.batch_scores(gs, uids, pb.items[uids], pb.mask[uids])
    assert P.scatter_matmul.launches == launches + 2
    assert torch.equal(a, b)
    real = scatter.scatter_add_rows

    def plain(base, idx, vals, mode="auto", plan=None):
        return base + P.scatter_matmul_plain(idx, vals, base.shape[0])

    S.scatter_add_rows = plain
    try:
        want = gm.batch_scores(gs, uids, pb.items[uids], pb.mask[uids])
    finally:
        S.scatter_add_rows = real
    err = (a - want).abs()
    assert (err <= 1e-5 * want.abs() + 1e-6 * want.abs().max()).all()
    ev = [Evaluation.create("TOPN").evaluate(gm, gs, test, train)
          for _ in range(2)]
    assert ev[0]["R@10"] == ev[1]["R@10"] and ev[0]["R@10"] > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name,w_solver", [("ALS", "ridge"),
                                           ("WRMF", "ridge"),
                                           ("WRMF", "eigh")])
def test_als_iteration_on_the_card_matches_cpu(cuda, name, w_solver):
    """The two sweeps of one iteration on the card and on the CPU, each from
    the same inputs (N(0, 0.3) factors; the item sweep from the CPU's new
    user factors): 1e-4 relative per table on the rows with at least 2*D
    observations, whose Grams have full rank (a thinner row's Gram is
    singular up to lambda or WRMF's jitter, and f32 rounding sets its
    null-space part on either device); a whole iteration on the card is
    the same bits on a second run."""
    from cdae_tpu_torch.models import als

    train, _ = _cf_data()
    D = 8
    cfg = als.ALSConfig(num_dim=D, lambda_=0.01, scalar=40.0,
                        solve_batch=128, w_solver=w_solver)
    cls = getattr(als, name)
    rng = np.random.default_rng(2)
    p0 = torch.from_numpy((rng.standard_normal((train.num_users, D))
                           * 0.3).astype(np.float32))
    q0 = torch.from_numpy((rng.standard_normal((train.num_items, D))
                           * 0.3).astype(np.float32))
    aux = {dev: cls(cfg, device=dev).reset(train, seed=2).aux
           for dev in ("cuda", "cpu")}
    args = (cfg.lambda_, cfg.scalar, cls.weighted, w_solver)
    p = {dev: als._sweep(p0.to(dev), q0.to(dev), aux[dev]["dev_user_side"],
                         *args).cpu() for dev in aux}
    q = {dev: als._sweep(q0.to(dev), p["cpu"].to(dev),
                         aux[dev]["dev_item_side"], *args).cpu()
         for dev in aux}
    full_u = torch.from_numpy(np.bincount(train.users,
                                          minlength=train.num_users) >= 2 * D)
    full_i = torch.from_numpy(np.bincount(train.items,
                                          minlength=train.num_items) >= 2 * D)
    assert full_u.sum() > 50 and full_i.sum() > 50
    assert _rel(p["cuda"][full_u], p["cpu"][full_u]) <= 1e-4
    assert _rel(q["cuda"][full_i], q["cpu"][full_i]) <= 1e-4
    runs = []
    for _ in range(2):
        model = cls(cfg, device="cuda")
        state = model.reset(train, seed=2)
        state.params = {"p": p0.to("cuda"), "q": q0.to("cuda")}
        model.train_one_iteration(state)
        runs.append(state.params)
    for k in ("p", "q"):
        assert torch.equal(runs[0][k], runs[1][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ItemCF", "UserCF"])
def test_cf_scoring_does_not_fall_back(cuda, monkeypatch, name):
    """A B8 launch that fails makes the CF scoring raise: it does not fall
    back to index_add_."""
    from cdae_tpu_torch.models import similarity as S
    from cdae_tpu_torch.ops import cuda_lib

    train, _ = _cf_data()
    model = getattr(S, name)(S.SimilarityConfig(topk=10), device="cuda")
    state = model.reset(train)
    pb = state.padded
    uids = np.arange(8)
    for entry in ("cdae_scatter_reduce", "cdae_scatter_plan"):
        monkeypatch.setattr(cuda_lib, "_lib",
                            _FailingLib(cuda_lib.lib(), entry))
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            model.batch_scores(state, uids, pb.items[uids], pb.mask[uids])


# ---------------------------------- LinearModel, FactorModel and NegMF ----

def _feature_model(name, device, **kw):
    """The model on low-rank data of 60 users x 80 items (rated for
    LinearModel and FactorModel), D = 8, its reset state on ``device``
    with the CPU reset's tables."""
    from cdae_tpu_torch.data.synthetic import (lowrank_interactions,
                                               lowrank_rated)
    from cdae_tpu_torch.models import linear as L

    if name == "LinearModel":
        cfg = L.LinearModelConfig(**{"batch_size": 128, **kw})
    else:
        cfg = L.FactorModelConfig(**{"num_dim": 8, "num_neg": 3,
                                     "batch_size": 128, "loss": "LOG"
                                     if name == "NegMF" else "SQUARE", **kw})
    data = (lowrank_interactions if name == "NegMF" else lowrank_rated)(
        60, 80, 10, seed=3)
    model = getattr(L, name)(cfg, device=device)
    state = model.reset(data, seed=1)
    cpu = getattr(L, name)(cfg, device="cpu").reset(data, seed=1)
    state.params = {k: v.to(device) for k, v in cpu.params.items()}
    return model, state


def _feature_draws(model, state, rng):
    """numpy-made draws of one epoch, the same on every device: the
    permutation, and NegMF's complement uniforms (sparse) or (B, I)
    uniforms (slab)."""
    gi = state.aux["instances"]
    bs = model.cfg.batch_size
    if "dense_R" in state.aux:
        k = state.aux["dense_R"].shape[0]
        slabs = -(-k // min(bs, k))
        return dict(draws=[{"u01": torch.from_numpy(rng.random(
            (min(bs, k), state.num_items)).astype(np.float32))}
            for _ in range(slabs)])
    perm = rng.permutation(len(gi))
    if model.name != "NegMF":
        return dict(perm=perm)
    users = state.aux["coo"][0]
    lengths = state.padded.lengths
    sel = np.concatenate([perm, np.zeros(-len(perm) % bs, perm.dtype)])
    free = np.maximum(state.num_items - lengths[users[sel]], 1)
    u = (rng.random((len(sel), model.cfg.num_neg)) * free[:, None]).astype(
        np.int32)
    return dict(perm=perm, draws=[{"u": torch.from_numpy(u[s:s + bs])}
                                  for s in range(0, len(sel), bs)])


_FEATURE_ROUTES = {
    "negmf_sparse": ("NegMF", {}),
    "negmf_slab": ("NegMF", dict(dense_mode=True, batch_size=32)),
    "linear": ("LinearModel", {}),
    "fm": ("FactorModel", {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(_FEATURE_ROUTES))
def test_feature_models_on_the_card_match_cpu(cuda, route):
    """One epoch on the card (B8's sums) against one on the CPU (index_add)
    from the same tables and the same injected draws: every table within
    1e-5 relative. Each step launches one B8 plan and one B8 reduce."""
    name, kw = _FEATURE_ROUTES[route]
    out = {}
    for dev in ("cuda", "cpu"):
        model, state = _feature_model(name, dev, **kw)
        draws = _feature_draws(model, state, np.random.default_rng(5))
        counts = (P.scatter_plan.launches, P.scatter_matmul.launches)
        model.train_one_iteration(state, 7, **draws)
        now = (P.scatter_plan.launches, P.scatter_matmul.launches)
        steps = len(draws.get("draws", [])) or -(
            -len(state.aux["instances"]) // model.cfg.batch_size)
        assert (now[0] - counts[0], now[1] - counts[1]) == (
            (steps, steps) if dev == "cuda" else (0, 0))
        out[dev] = state.params
    for k, want in out["cpu"].items():
        assert _rel(out["cuda"][k].cpu(), want) <= 1e-5, (route, k)


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(_FEATURE_ROUTES))
def test_feature_models_are_bit_reproducible(cuda, route):
    """Two 2-epoch runs of each route with its own draws (the step seeds)
    give the same bits on the card."""
    name, kw = _FEATURE_ROUTES[route]
    runs = []
    for _ in range(2):
        model, state = _feature_model(name, "cuda", **kw)
        for _ in range(2):
            model.train_one_iteration(state, 5)
        torch.cuda.synchronize()
        runs.append(state.params)
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), (route, k)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["negmf_sparse", "negmf_slab", "fm"])
def test_feature_models_do_not_fall_back(cuda, monkeypatch, route):
    """A B8 launch that fails makes the step raise: it does not fall back to
    index_add_."""
    from cdae_tpu_torch.ops import cuda_lib

    name, kw = _FEATURE_ROUTES[route]
    model, state = _feature_model(name, "cuda", **kw)
    monkeypatch.setattr(cuda_lib, "_lib",
                        _FailingLib(cuda_lib.lib(), "cdae_scatter_reduce"))
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        model.train_one_iteration(state, 5)


# -- the single-card leftovers: recommend, the sweep's step, the host loader


def _lowrank_split(users=2000, items=800, degree=40):
    from cdae_tpu_torch.data.synthetic import lowrank_interactions

    data = lowrank_interactions(users, items, degree, seed=20141119)
    return data.split_by_user(0.2, seed=20141119)


@pytest.mark.cuda
def test_cdae_recommend_with_b3_matches_plain(cuda):
    """recommend on the card through B3 (decode_scores) against the plain
    decode from the same parameters: the same ids wherever the plain gap
    between the 10th and 11th score exceeds 1e-4, no rated id anywhere."""
    from cdae_tpu_torch.models.cdae import CDAE, CDAEConfig
    from cdae_tpu_torch.ops.topk import topk_unrated

    train, _ = _lowrank_split()
    cfg = dict(num_dim=50, corruption_ratio=0.5, loss="CE", batch_size=64)
    model = CDAE(CDAEConfig(**cfg), device=cuda)
    state = model.reset(train, seed=3)
    model.train_epochs(state, 2, 3)
    plain = CDAE(CDAEConfig(**cfg, use_pallas=False), device=cuda)
    uids = np.arange(train.num_users, dtype=np.int32)
    before = P.decode_scores.launches
    ids = model.recommend(state, uids, train, k=10)
    assert P.decode_scores.launches > before
    from cdae_tpu_torch.data.dataset import rows_from_csr

    rated, _, mask, _ = rows_from_csr(train.csr(), uids, train.num_items)
    rated_t = torch.from_numpy(rated).to(cuda)
    scores = plain.batch_scores(state, uids, rated_t,
                                torch.from_numpy(mask).to(cuda))
    plain_ids, plain_vals = topk_unrated(scores, rated_t, 11)
    sure = (plain_vals[:, 9] - plain_vals[:, 10]) > 1e-4
    same = (torch.sort(ids, 1).values
            == torch.sort(plain_ids[:, :10], 1).values).all(1)
    assert int(sure.sum()) > 0.9 * len(uids)
    assert bool(same[sure].all())
    assert not bool((ids.long()[:, :, None] == rated_t[:, None, :]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("grid_index", [1, 66, 151])
def test_sweep_point_epoch_kernels_match_plain(cuda, grid_index):
    """One epoch of a grid point's dense step with the kernels (B1 masks,
    one B2 launch a step) against the plain versions from the same reset
    and hash masks: 1e-4 relative per table."""
    from cdae_tpu_torch.models.cdae import CDAE
    from cdae_tpu_torch.sweep import paper_grid, point_config

    train, _ = _lowrank_split()
    cfg = point_config(list(paper_grid())[grid_index], 64)
    tables = {}
    for use_pallas in (True, False):
        model = CDAE(dataclasses.replace(cfg, use_pallas=use_pallas),
                     device=cuda)
        state = model.reset(train, seed=20141119)
        assert "dense_R" in state.aux
        b2 = P.adagrad_update.launches
        model.train_epochs(state, 1, 20141119)
        if use_pallas:
            assert P.adagrad_update.launches > b2
        tables[use_pallas] = state.params
    for name in tables[True]:
        assert _rel(tables[True][name], tables[False][name]) <= 1e-4, name


@pytest.mark.cuda
def test_native_loader_builds_and_parses_on_this_host(cuda, tmp_path):
    from cdae_tpu_torch import _native
    from cdae_tpu_torch.data.dataset import (Interactions,
                                             movielens_line_parser)

    assert _native.available()
    rng = np.random.default_rng(2)
    path = tmp_path / "ratings.txt"
    path.write_text("".join(
        f"{u}::{i}::{r}::0\n" for u, i, r in zip(
            rng.integers(0, 900, 150_000).tolist(),
            rng.integers(0, 700, 150_000).tolist(),
            rng.integers(1, 6, 150_000).tolist())))
    fast = Interactions.from_text(str(path), movielens_line_parser)
    slow = Interactions.from_text(str(path), movielens_line_parser,
                                  use_native=False)
    for f in ("users", "items", "ratings"):
        np.testing.assert_array_equal(getattr(fast, f), getattr(slow, f))
    assert fast.user_vocab.to_list() == slow.user_vocab.to_list()
    assert fast.item_vocab.to_list() == slow.item_vocab.to_list()


# ------------------------------------------- sharded steps' kernel offsets ----

@pytest.mark.cuda
@pytest.mark.parametrize("r0,c0,shape", [(0, 0, (64, 100)),
                                         (512, 1853, (512, 1853)),
                                         (7, 3, (33, 65))])
def test_hw_uniform_offsets_cut_the_whole_launch(cuda, r0, c0, shape):
    """A block launched at (row_offset, col_offset) -- a sharded step's
    block of the mask draw -- equals that block of the whole launch, bit
    for bit, and its plain version's."""
    rows, cols = shape
    whole = P.hw_uniform(-3, (r0 + rows, c0 + cols), 1, device=cuda)
    before = P.hw_uniform.launches
    blk = P.hw_uniform(-3, shape, 1, device=cuda, row_offset=r0,
                       col_offset=c0)
    torch.cuda.synchronize()
    assert P.hw_uniform.launches == before + 1
    assert torch.equal(blk, whole[r0:, c0:])
    assert torch.equal(blk, P.hw_uniform_plain(-3, shape, 1, device=cuda,
                                               row_offset=r0, col_offset=c0))


@pytest.mark.cuda
@pytest.mark.parametrize("B,I,D,nn,noise", [(256, 3706, 10, 5, "mshift"),
                                            (70, 999, 50, 9, "hash")])
def test_warp_violator_select_row_offset_cuts_the_whole_batch(
        cuda, rng_np, B, I, D, nn, noise):
    """A data rank's rows launched with its row offset pick exactly what
    the whole batch's launch picks in those rows."""
    uv, iv, ib, thr, mask = _on(cuda, *_warp_inputs(rng_np, B, I, D))
    nv, j = P.warp_violator_select(9, uv, iv, ib, thr, mask, nn, noise=noise)
    for lo, hi in ((0, B // 2), (B // 2, B), (5, B - 3)):
        nv2, j2 = P.warp_violator_select(
            9, uv[lo:hi].contiguous(), iv, ib, thr[lo:hi].contiguous(),
            mask[lo:hi].contiguous(), nn, noise=noise, row_offset=lo)
        torch.cuda.synchronize()
        assert torch.equal(nv2, nv[lo:hi]) and torch.equal(j2, j[lo:hi])


@pytest.mark.cuda
def test_recommend_spans_and_h2d_bytes_on_the_card(cuda, tmp_path):
    """Under a profiler, a recommend on the card tallies its spans, builds
    its rows on the card (one launch of csr_rows), and counts as
    ``h2d_bytes`` the host arrays it copies (the uids only); ``trace``
    synchronises before it stops, so its file holds the request's last
    kernel, launched inside ``serve.topk``."""
    import json

    from cdae_tpu_torch.models.cdae import CDAE, CDAEConfig
    from cdae_tpu_torch.utils import profiling

    train, _ = _lowrank_split()
    model = CDAE(CDAEConfig(num_dim=50, batch_size=64), device=cuda)
    state = model.reset(train, seed=3)
    uids = np.arange(256, dtype=np.int32)
    model.recommend(state, uids, train, k=10)  # warm
    torch.cuda.synchronize()
    profiling.reset_tallies()
    rows_launches = P.csr_rows.launches
    with profiling.trace(str(tmp_path)):
        model.recommend(state, uids, train, k=10)
    tallies = profiling.tallies()
    # the uids alone, int64, one copy for csr_rows and batch_scores; the
    # rows are built on the card from the CSR the warm request copied there
    assert tallies.counters["h2d_bytes"] == 8 * len(uids)
    assert P.csr_rows.launches - rows_launches == 1
    assert {n: c for n, (c, _) in tallies.spans.items()} == {
        "serve.request": 1, "serve.rows": 1, "serve.scores": 1,
        "serve.topk": 1}
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    topk = next(e for e in events if e.get("name") == "serve.topk"
                and not str(e.get("cat")).startswith("gpu_"))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels
    last = max(kernels, key=lambda e: e["ts"] + e["dur"])
    launch = next(e for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and e["args"].get("correlation")
                  == last["args"]["correlation"])
    assert topk["ts"] <= launch["ts"] <= topk["ts"] + topk["dur"]
    profiling.reset_tallies()


def _ml20m_like_csr(U, I, longest, seed):
    """A user CSR with rows drawn like the ML-20M cells' (20 + a geometric
    tail of mean ~125, items by a power law without replacement), a few
    empty rows, and one row of ``longest`` items."""
    from cdae_tpu_torch.data.dataset import Interactions

    rng = np.random.default_rng(seed)
    lengths = np.minimum(20 + rng.geometric(1 / 125, U), longest)
    lengths[rng.choice(U, 8, replace=False)] = 0
    lengths[U // 2] = longest
    p = 1.0 / np.arange(1, I + 1) ** 0.9
    p /= p.sum()
    items = np.concatenate([rng.choice(I, n, replace=False, p=p)
                            for n in lengths])
    return Interactions.from_arrays(np.repeat(np.arange(U), lengths), items,
                                    num_users=U, num_items=I)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1024, 32])
def test_csr_rows_equals_plain_and_host_rows(cuda, B):
    """``csr_rows`` against its plain version on the card and the host's
    ``rows_from_csr``, bit for bit, at a request of 1,024 users with the
    longest row of 1,268 and of 32 users, repeated uids included."""
    from cdae_tpu_torch.data.dataset import rows_from_csr

    data = _ml20m_like_csr(4096, 26744, 1268, seed=B)
    rng = np.random.default_rng(B + 1)
    uids = rng.choice(4096, B).astype(np.int32)
    uids[B // 3] = 4096 // 2  # the longest row
    uids[-1] = uids[0]
    items, _, mask, _ = rows_from_csr(data.csr(), uids, data.num_items)
    assert items.shape == (B, 1268)
    indptr, indices = data.csr_on(cuda, lambda a: torch.as_tensor(a,
                                                                 device=cuda))
    d_uids = torch.as_tensor(uids.astype(np.int64), device=cuda)
    before = P.csr_rows.launches
    got_items, got_mask = P.csr_rows(indptr, indices, d_uids, 1268,
                                     data.num_items)
    torch.cuda.synchronize()
    assert P.csr_rows.launches == before + 1
    plain_items, plain_mask = P.csr_rows_plain(indptr, indices, d_uids, 1268,
                                               data.num_items)
    assert got_items.dtype == torch.int32 and got_mask.dtype == torch.bool
    assert torch.equal(got_items, plain_items)
    assert torch.equal(got_mask, plain_mask)
    np.testing.assert_array_equal(got_items.cpu().numpy(), items)
    np.testing.assert_array_equal(got_mask.cpu().numpy(), mask)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["uids_strided", "uids_int32",
                                 "indices_int64", "indptr_int32",
                                 "indptr_strided"])
def test_csr_rows_raises_on_what_the_kernel_does_not_take(cuda, bad):
    indptr = torch.tensor([0, 2, 2, 5], dtype=torch.int64, device=cuda)
    indices = torch.tensor([1, 3, 0, 2, 4], dtype=torch.int32, device=cuda)
    uids = torch.tensor([2, 0, 1, 2], dtype=torch.int64, device=cuda)
    if bad == "uids_strided":
        uids = uids[::2]
    elif bad == "uids_int32":
        uids = uids.int()
    elif bad == "indices_int64":
        indices = indices.long()
    elif bad == "indptr_int32":
        indptr = indptr.int()
    else:
        indptr = torch.stack([indptr, indptr], 1)[:, 0]
    before = P.csr_rows.launches
    with pytest.raises((TypeError, ValueError)):
        P.csr_rows(indptr, indices, uids, 3, 5)
    assert P.csr_rows.launches == before


@pytest.mark.cuda
def test_the_device_csr_is_uploaded_once(cuda):
    """The first recommend on an ``Interactions`` copies its CSR (indptr
    int64, indices int32) to the card; a second copies the uids alone."""
    from cdae_tpu_torch.models.cdae import CDAE, CDAEConfig
    from cdae_tpu_torch.utils import profiling

    train, _ = _lowrank_split()
    model = CDAE(CDAEConfig(num_dim=50, batch_size=64), device=cuda)
    state = model.reset(train, seed=3)
    uids = np.arange(64, dtype=np.int32)
    # warm on a copy: the model's own first-call work, not this CSR's
    model.recommend(state, uids, train.with_dims(train.num_users,
                                                 train.num_items), k=10)
    torch.cuda.synchronize()
    csr = train.csr()
    reads, rows = [], []
    for _ in range(2):
        profiling.reset_tallies()
        rows_launches = P.csr_rows.launches
        with torch.profiler.profile():
            model.recommend(state, uids, train, k=10)
        reads.append(profiling.tallies().counters)
        rows.append(P.csr_rows.launches - rows_launches)
    profiling.reset_tallies()
    per_request = 8 * len(uids)  # the int64 uids
    assert reads[0]["h2d_bytes"] == (per_request + 8 * len(csr.indptr)
                                     + 4 * len(csr.indices))
    assert reads[1]["h2d_bytes"] == per_request
    assert rows == [1, 1]  # each request's rows built on the card


@pytest.mark.cuda
def test_the_device_csr_is_kept_once_for_cuda_and_its_index(cuda):
    """``cuda`` and ``cuda:<current>`` name one card, so they share one
    device copy of the CSR."""
    train, _ = _lowrank_split()
    copies = []

    def upload(a):
        copies.append(a.dtype)
        return torch.as_tensor(a, device=cuda)

    here = torch.device("cuda", torch.cuda.current_device())
    first = train.csr_on("cuda", upload)
    again = train.csr_on(here, upload)
    assert copies == [np.int64, np.int32]
    assert first[0] is again[0] and first[1] is again[1]

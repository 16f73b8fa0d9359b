"""The hand-written CUDA kernels of cdae_tpu_torch against their plain
PyTorch versions, on a GPU, at ragged shapes: the serving kernels (decode,
fused top-k at the edges of their tiles, equal scores included), the
training kernels (hw_uniform and adagrad_update bit for bit, the fused
step within f32 summation-order tolerance and bit-equal run to run), the WARP
violator kernel (counts and picks exact on dyadic inputs, at the edges of
its tiles and catalog splits), and the row aggregation (B8: its plan equal
to the library's stable sort; its reduce to summation-order tolerance and
the same bits on every launch and over a shared plan; every fixed-order
scatter mode routed to it) and row gather (B9, exact at every width) with
the paths that launch them, and two default-route WARP runs bit for bit.
Every test is marked ``cuda`` and skips when torch.cuda.is_available() is
False (the kernels have no CPU mode).

This file imports neither jax nor cdae_tpu, so it also runs on a machine
without them; there, skip the JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

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
])
def test_fused_topk_kernel_tile_edges(cuda, rng_np, B, I, D, K):
    """B5 and B6 at the edges of their tiles: B off the 128-row user tile,
    I off the 128-item tile, D from 3 to 200 (all of D staged once up to
    64, 32-wide chunks above), k = 1 and 32; a row with 100 rated items in
    one tile, one with 3 unrated items, one with none rated. Ids equal the
    plain version's, scores to rtol 1e-5 and atol 1e-4 (f32-level error of
    3xTF32 on N(0, 1) operands)."""
    z, W, bp = _problem(rng_np, B, D, I)
    rated = _rated_sets(rng_np, B, I, 300)
    for got, want in _both_topk(cuda, z, W, bp, rated, K):
        torch.testing.assert_close(got[0], want[0])
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-4)


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
    assert P.adagrad_update.launches == counts[1] + 4 * steps
    assert P.scatter_plan.launches == counts[2] + steps  # one shared plan

    warp = WARP(MFConfig(num_dim=6, batch_size=64, gather_mode="mxu",
                         scatter_mode="pallas", loss="HINGE", beta=0.0,
                         lambda_=0.1), device="cuda")
    ws = warp.reset(data, seed=1)
    counts = (P.gather_rows_mxu.launches, P.scatter_matmul.launches,
              P.warp_violator_select.launches, P.scatter_plan.launches)
    warp.train_one_iteration(ws, 5)
    n = -(-len(data) // 64)
    assert P.gather_rows_mxu.launches == counts[0] + 2 * n
    assert P.scatter_matmul.launches == counts[1] + 2 * n
    assert P.warp_violator_select.launches == counts[2] + n
    assert P.scatter_plan.launches == counts[3] + 2 * n  # items, users

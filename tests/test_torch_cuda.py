"""The hand-written CUDA kernels of cdae_tpu_torch against their plain
PyTorch versions, on a GPU, at ragged shapes: the serving kernels (decode,
fused top-k) and the training kernels (hw_uniform and adagrad_update bit
for bit, the fused step within f32 summation-order tolerance). Every test
is marked ``cuda`` and skips when torch.cuda.is_available() is False (the
kernels have no CPU mode).

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
@pytest.mark.parametrize("B,D,I", [(48, 20, 700), (1, 7, 5), (130, 200, 999)])
def test_decode_scores_kernel(cuda, rng_np, B, D, I):
    z, W, bp = _on(cuda, *_problem(rng_np, B, D, I))
    before = P.decode_scores.launches
    got = P.decode_scores(z, W, bp)
    torch.cuda.synchronize()
    assert P.decode_scores.launches == before + 1
    torch.testing.assert_close(got, P.decode_scores_plain(z, W, bp),
                               rtol=1e-5, atol=1e-4)


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

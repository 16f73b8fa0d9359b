"""The hand-written CUDA kernels of cdae_tpu_torch against their plain
PyTorch versions, on a GPU. Every test is marked ``cuda`` and skips when
torch.cuda.is_available() is False (the kernels have no CPU mode).

This file imports neither jax nor cdae_tpu, so it also runs on a machine
without them; there, skip the JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

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

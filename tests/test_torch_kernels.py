"""cdae_tpu_torch serving kernels vs cdae_tpu's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; cdae_tpu's
kernels run in interpret mode, as tests/test_pallas.py runs them, at that
file's shapes (unaligned catalogs, fewer-than-k rows, CSR overflow).
Scores match to rtol/atol 1e-5 (f32 sums in another order); ids match
exactly. tests/test_torch_cuda.py holds the kernels themselves against
these plain versions on a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdae_tpu.ops import pallas_kernels as J
from cdae_tpu.ops.topk import topk_unrated as jtopk_unrated
from cdae_tpu_torch.ops import pallas_kernels as P
from cdae_tpu_torch.ops.topk import topk_unrated

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def rng_np():
    return np.random.default_rng(11)


def _problem(rng, B, D, I):
    z = rng.standard_normal((B, D)).astype(np.float32)
    W = rng.standard_normal((I, D)).astype(np.float32)
    bp = rng.standard_normal(I).astype(np.float32)
    return z, W, bp


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


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


def _assert_topk(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)


@pytest.mark.parametrize("B,D,I", [(48, 20, 700), (1, 7, 5), (64, 50, 512)])
def test_decode_scores_plain_matches_pallas(rng_np, B, D, I):
    z, W, bp = _problem(rng_np, B, D, I)
    want = J.decode_scores(z, W, bp, tile_b=16, tile_i=256)
    got = P.decode_scores(*_t(z, W, bp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_scores_cpu_never_launches(rng_np):
    before = P.decode_scores.launches
    P.decode_scores(*_t(*_problem(rng_np, 4, 3, 9)))
    assert P.decode_scores.launches == before


def test_streaming_topk_matches(rng_np):
    B, D, I, L, K = 12, 16, 1000, 8, 10
    z, W, bp = _problem(rng_np, B, D, I)
    rated = np.sort(rng_np.choice(I, size=(B, L), replace=False),
                    axis=1).astype(np.int32)
    want = J.streaming_topk_scores(z, W, bp, jnp.asarray(rated), k=K,
                                   block=256)
    got = P.streaming_topk_scores(*_t(z, W, bp, rated), k=K, block=256)
    _assert_topk(got, want)
    # any block size gives the same answer
    _assert_topk(P.streaming_topk_scores(*_t(z, W, bp, rated), k=K,
                                         block=37), want)


@pytest.mark.parametrize("B,D,I,L,K,block", [
    (8, 16, 300, 6, 10, 64),      # test_pallas: fused_topk_matches_dense
    (8, 16, 1100, 9, 10, 128),    # small block, unaligned catalog
    (5, 9, 1000, 40, 3, 256),
    (16, 32, 517, 2, 7, 256),
])
def test_fused_topk_plain_matches_pallas(rng_np, B, D, I, L, K, block):
    z, W, bp = _problem(rng_np, B, D, I)
    rl = np.sort(rng_np.choice(I, size=(B, L), replace=False), axis=1)
    rows = _dense_rows(rl, I)
    want = J.fused_topk_scores(z, W, bp, jnp.asarray(rows), k=K, block=block)
    got = P.fused_topk_scores(*_t(z, W, bp, rows), k=K, block=block)
    _assert_topk(got, want)
    ref = jtopk_unrated(jnp.asarray(z @ W.T + bp[None, :]),
                        jnp.asarray(rl.astype(np.int32)), K)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))


@pytest.mark.parametrize("case", ["few_unrated", "last_block_only"])
def test_fused_topk_fewer_than_k_matches_pallas(rng_np, case):
    """Rows with fewer than k unrated items: NEG values and cdae_tpu's
    tail ids, in every position."""
    B, D, I, K = 4, 8, 140, 10
    z, W, bp = _problem(rng_np, B, D, I)
    rated = np.ones((B, I), dtype=np.int8)
    if case == "few_unrated":
        rated[0, :5] = 0   # 5 unrated < k
        rated[1, :] = 0    # everything unrated
        # rows 2-3: nothing unrated at all
    else:
        rated[0, 130:133] = 0  # unrated only in the last block
        rated[1, [3, 7, 135]] = 0
        rated[2, [3, 7]] = 0
    for block in (128, 2048):
        want = J.fused_topk_scores(z, W, bp, jnp.asarray(rated), k=K,
                                   block=block)
        got = P.fused_topk_scores(*_t(z, W, bp, rated), k=K, block=block)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("w", [8, 32])
def test_fused_topk_csr_plain_matches_pallas(rng_np, w):
    B, D, I, K = 12, 16, 333, 10
    z, W, bp = _problem(rng_np, B, D, I)
    rated = _csr_rows(rng_np, B, I, 24)
    want = J.fused_topk_scores_csr(z, W, bp, jnp.asarray(rated), k=K,
                                   block=128, w=w)
    got = P.fused_topk_scores_csr(*_t(z, W, bp, rated), k=K, block=128, w=w)
    _assert_topk(got, want)


def test_fused_topk_csr_overflow_matches_pallas(rng_np):
    """A row whose rated ids cluster past w in one block: cdae_tpu answers
    the batch with its streaming scan; the port's walk is exact anyway."""
    B, D, I, K = 6, 8, 400, 10
    z, W, bp = _problem(rng_np, B, D, I)
    rated = np.full((B, 32), I, np.int32)
    rated[0, :30] = np.arange(50, 80)
    for b in range(1, B):
        rated[b, :4] = np.sort(rng_np.choice(I, 4, replace=False))
    want = J.fused_topk_scores_csr(z, W, bp, jnp.asarray(rated), k=K,
                                   block=128, w=8)
    got = P.fused_topk_scores_csr(*_t(z, W, bp, rated), k=K, block=128, w=8)
    _assert_topk(got, want)
    assert bool(P._csr_overflow(torch.from_numpy(rated), I, 128, 8))
    assert not bool(P._csr_overflow(torch.from_numpy(rated), I, 128, 30))


@pytest.mark.parametrize("w", [8, 64, 200])
def test_fused_topk_csr_fewer_than_k_matches_pallas(rng_np, w):
    B, D, I, K = 4, 8, 140, 10
    z, W, bp = _problem(rng_np, B, D, I)
    unrated = {0: [130, 131, 132], 1: [3, 7, 135], 2: [3, 7], 3: []}
    rated = np.full((B, I), I, np.int32)
    for b, keep in unrated.items():
        r = np.setdiff1d(np.arange(I), keep)
        rated[b, :len(r)] = r
    want = J.fused_topk_scores_csr(z, W, bp, jnp.asarray(rated), k=K,
                                   block=128, w=w)
    got = P.fused_topk_scores_csr(*_t(z, W, bp, rated), k=K, block=128, w=w)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_fused_topk_csr_large_batch_matches(rng_np):
    """300 rows (cdae_tpu chunks these into 256-row kernel calls)."""
    B, D, I, K = 300, 8, 400, 10
    z, W, bp = _problem(rng_np, B, D, I)
    rated = _csr_rows(rng_np, B, I, 16)
    want = jtopk_unrated(jnp.asarray(z @ W.T + bp[None, :]),
                         jnp.asarray(rated), K)
    got = P.fused_topk_scores_csr(*_t(z, W, bp, rated), k=K)
    _assert_topk(got, want)


def test_topk_unrated_matches(rng_np):
    B, I, L = 6, 7, 5
    scores = rng_np.standard_normal((B, I)).astype(np.float32)
    scores[0, :] = 1.0  # ties: lower ids first
    rated = np.full((B, L), I, np.int32)
    rated[1, :3] = [0, 2, 4]
    rated[2, :5] = [0, 1, 2, 3, 4]  # fewer than k unrated
    for k in (3, 10):  # 10 > I: sentinel ids
        want = jtopk_unrated(jnp.asarray(scores), jnp.asarray(rated), k)
        got = topk_unrated(*_t(scores, rated), k)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_fused_topk_rejects_k_over_32(rng_np):
    z, W, bp = _problem(rng_np, 2, 3, 50)
    rows = np.zeros((2, 50), np.int8)
    with pytest.raises(ValueError, match="k=33"):
        P.fused_topk_scores(*_t(z, W, bp, rows), k=33)


def test_wrappers_route_only_cpu_to_plain(rng_np):
    z, W, bp = _t(*_problem(rng_np, 2, 3, 50))
    rows = torch.zeros((2, 50), dtype=torch.int8)
    with pytest.raises(ValueError, match="meta"):
        P.decode_scores(z.to("meta"), W, bp)
    with pytest.raises(ValueError, match="meta"):
        P.fused_topk_scores(z.to("meta"), W, bp, rows)


@pytest.mark.parametrize("B,I,sms", [
    (1024, 1_000_000, 132), (256, 1_000_000, 132), (1, 1, 132),
    (1024, 3706, 132), (20000, 1_000_000, 132), (129, 200, 8),
    (70, 5000, 1), (5, 7, 132),
])
def test_fused_topk_grid(B, I, sms):
    """The B5/B6 grid (user tiles of 128 x catalog splits of whole 128-item
    tiles): every split non-empty, the splits cover the catalog, and about
    two blocks an SM where the catalog has the tiles for it."""
    splits, per_split = P.fused_topk_grid(B, I, sms)
    assert per_split % 128 == 0 and per_split > 0
    assert (splits - 1) * per_split < I <= splits * per_split
    user_tiles = -(-B // 128)
    tiles = -(-I // 128)
    assert splits <= min(tiles, -(-2 * sms // user_tiles)) or splits == 1
    if tiles >= 2 * sms:
        assert user_tiles * splits >= 2 * sms - user_tiles
    if (B, I, sms) == (1024, 1_000_000, 132):
        assert (splits, per_split) == (33, 237 * 128)

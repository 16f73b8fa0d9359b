"""The modules of cdae_tpu_torch's WARP step that stand beside its kernel,
against cdae_tpu on the same numpy inputs: the plain version of the WARP
violator kernel (B7, ``warp_violator_select_plain``) against cdae_tpu's
Pallas kernel run in interpret mode, ``scatter_add_rows`` in every mode,
and ``hw_randint``. The kernel itself is held against the plain version on
a GPU in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdae_tpu.ops import pallas_kernels as JP
from cdae_tpu.ops import scatter as jscatter
from cdae_tpu_torch.ops import pallas_kernels as TP
from cdae_tpu_torch.ops import sampling as tsampling
from cdae_tpu_torch.ops import scatter as tscatter

torch.set_num_threads(2)


@pytest.fixture
def rng_np():
    return np.random.default_rng(11)


def _warp_problem(rng, B, I, D):
    uv = rng.standard_normal((B, D)).astype(np.float32)
    iv = rng.standard_normal((I, D)).astype(np.float32)
    ib = rng.standard_normal(I).astype(np.float32)
    mask = rng.integers(0, 2, size=(B, I)).astype(np.int8)
    thr = (rng.standard_normal(B) * 2).astype(np.float32)
    return uv, iv, ib, thr, mask


@pytest.mark.parametrize("noise", ["mshift", "hash"])
@pytest.mark.parametrize("B,I,D,nn", [(21, 333, 7, 4), (9, 200, 5, 3),
                                      (40, 1030, 10, 5), (3, 17, 2, 9)])
def test_warp_select_plain_equals_cdae_tpu(rng_np, noise, B, I, D, nn):
    """nviol and j exact (tolerance 0): the same violators from scores in
    f32 (random thresholds keep every score far from its row's threshold
    next to the summation-order rounding), and cdae_tpu's noise bit for
    bit, with its tie rule (lowest column)."""
    arrays = _warp_problem(rng_np, B, I, D)
    for seed in (42, -7, 2**31 - 1):
        want_n, want_j = JP.warp_violator_select(
            jnp.int32(seed), *map(jnp.asarray, arrays), nn, block_b=8,
            block_i=128, noise=noise)
        before = TP.warp_violator_select.launches
        got_n, got_j = TP.warp_violator_select(
            seed, *map(torch.from_numpy, arrays), nn, noise=noise)
        assert TP.warp_violator_select.launches == before  # CPU: plain
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
        np.testing.assert_array_equal(got_j.numpy(), np.asarray(want_j))
        assert got_n.dtype == got_j.dtype == torch.int32


def test_warp_select_default_noise_is_mshift(rng_np):
    arrays = tuple(map(torch.from_numpy, _warp_problem(rng_np, 8, 90, 4)))
    a = TP.warp_violator_select_plain(5, *arrays, 3)
    b = TP.warp_violator_select_plain(5, *arrays, 3, noise="mshift")
    c = TP.warp_violator_select_plain(5, *arrays, 3, noise="hash")
    assert torch.equal(a[1], b[1]) and not torch.equal(a[1], c[1])


@pytest.mark.parametrize("noise", ["mshift", "hash"])
def test_warp_select_uniformity(noise):
    """tests/test_pallas.py's chi-square on the port's picks: every item a
    violator, 8 seeds pooled, bound 330 at dof 255 (cdae_tpu measured
    ~282 for mshift, ~259 for hash; the broken single-base variant
    350-411), and per slot 32 coarse bins under 65 at dof 31."""
    B, I, D, nn = 64, 256, 4, 4
    counts = np.zeros(I)
    per_slot = np.zeros((nn, I))
    for s in range(8):
        _, j = TP.warp_violator_select_plain(
            1000 + s * 7919, torch.ones((B, D)), torch.ones((I, D)),
            torch.zeros(I), torch.full((B,), -1e9),
            torch.zeros((B, I), dtype=torch.int8), nn, noise=noise)
        jn = j.numpy()
        counts += np.bincount(jn.ravel(), minlength=I)
        per_slot += np.stack([np.bincount(jn[:, k], minlength=I)
                              for k in range(nn)])
    E = counts.sum() / I
    assert ((counts - E) ** 2 / E).sum() < 330.0
    for k in range(nn):
        c = per_slot[k].reshape(32, -1).sum(1)
        Ek = c.sum() / 32
        assert ((c - Ek) ** 2 / Ek).sum() < 65.0, k


def test_warp_select_rows_without_violators_pick_zero(rng_np):
    uv, iv, ib, thr, mask = map(torch.from_numpy,
                                _warp_problem(rng_np, 6, 50, 3))
    thr[:2] = float("inf")
    mask[2:4] = 1
    nviol, j = TP.warp_violator_select(1, uv, iv, ib, thr, mask, 4)
    assert not nviol[:4].any() and not j[:4].any()
    assert (j[4:] < 50).all() and (nviol[4:] > 0).all()


def test_warp_select_rejects_what_it_does_not_take(rng_np):
    arrays = tuple(map(torch.from_numpy, _warp_problem(rng_np, 4, 30, 3)))
    with pytest.raises(NotImplementedError, match="hardware PRNG"):
        TP.warp_violator_select(1, *arrays, 3, noise="hw")
    with pytest.raises(ValueError, match="noise"):
        TP.warp_violator_select(1, *arrays, 3, noise="philox")
    with pytest.raises(ValueError, match="nn=33"):
        TP.warp_violator_select(1, *arrays, 33)


# ------------------------------------------------------ scatter_add_rows ----

@pytest.mark.parametrize("mode", ["auto", "matmul", "factored", "sort",
                                  "scatter", "factored_bf16"])
@pytest.mark.parametrize("width", [None, 6])
def test_scatter_add_rows_matches_cdae_tpu(rng_np, mode, width):
    """Every mode is the same row sum (index_add here); ids >= N and, but
    for the native "scatter" mode (whose negative ids wrap in jax), ids < 0
    contribute nothing. Tolerance 1e-5: f32 sums in another order (bf16
    mode: the same bf16-rounded contributions, summed in f32)."""
    N, Pn = 37, 200
    shape = (Pn,) if width is None else (Pn, width)
    vals = rng_np.standard_normal(shape).astype(np.float32)
    base = rng_np.standard_normal((N,) + shape[1:]).astype(np.float32)
    idx = rng_np.integers(0, N, Pn).astype(np.int32)
    idx[:5] = N  # the dead-slot sentinel
    idx[5:8] = N + 4
    if mode != "scatter":
        idx[8:10] = -1
    want = jscatter.scatter_add_rows(jnp.asarray(base), jnp.asarray(idx),
                                     jnp.asarray(vals), mode=mode)
    got = tscatter.scatter_add_rows(torch.from_numpy(base),
                                    torch.from_numpy(idx),
                                    torch.from_numpy(vals), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    dropped = tscatter.scatter_add_rows(
        torch.zeros((N,) + shape[1:]), torch.full((Pn,), N),
        torch.from_numpy(vals), mode=mode)
    assert not dropped.any()


def test_scatter_add_rows_pallas_modes_raise_naming_b8():
    """The pallas modes are kernel B8 (its plain version on the CPU): they
    no longer raise, and sum as index_add does; an unknown mode raises."""
    base = torch.arange(4.0)
    idx = torch.tensor([0, 3, 3, 4, -1])
    vals = torch.tensor([1.0, 2.0, 0.5, 7.0, 9.0])
    want = torch.tensor([1.0, 1.0, 2.0, 5.5])
    for mode in ("pallas", "pallas_bf16", "scatter"):
        assert torch.equal(tscatter.scatter_add_rows(base, idx, vals,
                                                     mode=mode), want)
    with pytest.raises(ValueError, match="unknown"):
        tscatter.scatter_add_rows(base, idx, vals, mode="onehot")


# ------------------------------------------------------------ hw_randint ----

def test_hw_randint_is_floor_of_the_hash_uniform():
    maxval = torch.tensor([[1], [7], [3706], [2**20]], dtype=torch.int32)
    v = tsampling.hw_randint(12345, (4, 64), maxval, salt=0x5D1F,
                             device="cpu")
    u = TP.hw_uniform_plain(12345 ^ 0x5D1F, (4, 64), device="cpu")
    want = torch.minimum((u * maxval.float()).to(torch.int32), maxval - 1)
    assert v.dtype == torch.int32 and torch.equal(v, want)
    assert ((v >= 0) & (v < maxval)).all() and not v[0].any()
    # the salt is XORed into the seed; a negative seed wraps as int32
    assert torch.equal(tsampling.hw_randint(-3, (2, 9), 50, salt=7,
                                            device="cpu"),
                       tsampling.hw_randint(-3 ^ 7, (2, 9), 50,
                                            device="cpu"))
    assert not torch.equal(v, tsampling.hw_randint(12345, (4, 64), maxval,
                                                   device="cpu"))

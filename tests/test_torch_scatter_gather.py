"""The port's row aggregation (B8 ``scatter_matmul``), row gather (B9
``gather_rows_mxu``) and exact complement sampler (``sample_unrated``)
against cdae_tpu's on the same numpy inputs, on the CPU: cdae_tpu's Pallas
kernels run in interpret mode, the port's wrappers take their plain
versions (a CPU tensor). Then WARP's step with ``gather_mode="mxu"`` and
``scatter_mode="pallas"`` against the native step and cdae_tpu's.

Tolerances: B8 to 1e-6 (f32 sums in another order; the bf16 modes round
the same contributions to bf16 on both sides), B9 and the sampler exactly,
the WARP step to 1e-5 of each table's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cdae_tpu.models.mf as jmf
import cdae_tpu_torch.models.mf as tmf
from cdae_tpu.data.dataset import Interactions as JInteractions
from cdae_tpu.data.dataset import movielens_line_parser as jparser
from cdae_tpu.ops import pallas_kernels as JP
from cdae_tpu.ops import sampling as jsampling
from cdae_tpu.ops import scatter as jscatter
from cdae_tpu_torch.data.dataset import Interactions as TInteractions
from cdae_tpu_torch.data.dataset import movielens_line_parser as tparser
from cdae_tpu_torch.ops import pallas_kernels as TP
from cdae_tpu_torch.ops import sampling as tsampling
from cdae_tpu_torch.ops import scatter as tscatter
from cdae_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)


@pytest.fixture
def rng_np():
    return np.random.default_rng(17)


def _ids(rng, P, N):
    """Ids in [0, N) with the sentinel N, ids past it and negative ones."""
    idx = rng.integers(0, N, P).astype(np.int32)
    idx[: P // 10] = N
    idx[P // 10: P // 8] = N + 5
    idx[P // 8: P // 6] = -1
    return rng.permutation(idx)


# ------------------------------------------------------------------- B8 ----

@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("P,N,width", [(700, 37, 11), (300, 50, None),
                                       (1500, 300, 10), (5, 3, 1)])
def test_scatter_matmul_plain_matches_cdae_tpu(rng_np, bf16, P, N, width):
    """cdae_tpu's interpret-mode kernel with vals_dtype f32, or its bf16
    default, against the port's plain version, 1-D values too."""
    shape = (P,) if width is None else (P, width)
    vals = rng_np.standard_normal(shape).astype(np.float32)
    idx = _ids(rng_np, P, N)
    want = JP.scatter_matmul(
        jnp.asarray(idx), jnp.asarray(vals), N,
        vals_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    before = TP.scatter_matmul.launches
    got = TP.scatter_matmul(torch.from_numpy(idx).long(),
                            torch.from_numpy(vals), N, bf16=bf16)
    assert TP.scatter_matmul.launches == before  # CPU: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_scatter_matmul_bf16_rounds_each_contribution(rng_np):
    """bf16 rounds the values, never the sum: the result equals the f32
    sum of the bf16-rounded values."""
    vals = torch.from_numpy(rng_np.standard_normal((400, 6))
                            .astype(np.float32))
    idx = torch.from_numpy(_ids(rng_np, 400, 20)).long()
    rounded = vals.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(TP.scatter_matmul(idx, vals, 20, bf16=True),
                       TP.scatter_matmul(idx, rounded, 20))
    assert not torch.equal(TP.scatter_matmul(idx, vals, 20, bf16=True),
                           TP.scatter_matmul(idx, vals, 20))


def test_scatter_matmul_edge_shapes():
    empty = TP.scatter_matmul(torch.zeros(0, dtype=torch.long),
                              torch.zeros((0, 4)), 6)
    assert tuple(empty.shape) == (6, 4) and not empty.any()
    dropped = TP.scatter_matmul(torch.tensor([6, -1, 99]),
                                torch.ones(3), 6)
    assert tuple(dropped.shape) == (6,) and not dropped.any()
    assert tuple(TP.scatter_matmul(torch.tensor([0]), torch.ones((1, 3)),
                                   0).shape) == (0, 3)


@pytest.mark.parametrize("mode", ["pallas", "pallas_bf16"])
@pytest.mark.parametrize("width", [None, 11])
def test_scatter_add_rows_pallas_modes_match_cdae_tpu(rng_np, mode, width):
    N, Pn = 41, 900
    shape = (Pn,) if width is None else (Pn, width)
    vals = rng_np.standard_normal(shape).astype(np.float32)
    base = rng_np.standard_normal((N,) + shape[1:]).astype(np.float32)
    idx = _ids(rng_np, Pn, N)
    want = jscatter.scatter_add_rows(jnp.asarray(base), jnp.asarray(idx),
                                     jnp.asarray(vals), mode=mode)
    got = tscatter.scatter_add_rows(torch.from_numpy(base),
                                    torch.from_numpy(idx),
                                    torch.from_numpy(vals), mode=mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------------ B8's plan ----

@pytest.mark.parametrize("P,N", [(0, 5), (1, 1), (300, 1), (700, 37),
                                 (5000, 3706)])
def test_scatter_plan_plain_is_a_stable_sort(rng_np, P, N):
    """order: the positions stably sorted by key (an id in [0, N), else the
    sentinel N, last); offsets[n]: segment n's start, offsets[N] the count
    of ids in range."""
    idx = _ids(rng_np, P, N)
    before = TP.scatter_plan.launches
    plan = TP.scatter_plan(torch.from_numpy(idx).long(), N)
    assert TP.scatter_plan.launches == before  # CPU: the plain version
    assert plan.offsets.dtype == plan.order.dtype == torch.int32
    keys = np.where((idx >= 0) & (idx < N), idx, N)
    np.testing.assert_array_equal(plan.order.numpy(),
                                  np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(
        plan.offsets.numpy(), np.searchsorted(np.sort(keys), np.arange(N + 1)))
    assert plan.offsets[-1] == ((idx >= 0) & (idx < N)).sum()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("C", [1, 10, 11, 33])
@pytest.mark.parametrize("P", [0, 900])
def test_scatter_matmul_with_plan_and_limit_matches_cdae_tpu(rng_np, bf16, C,
                                                             P):
    """A plan of a longer id vector whose first P ids are ``idx`` (the
    limit P = len(vals)): equal to cdae_tpu's interpret-mode kernel on
    ``idx`` alone, and bit for bit to the port with ``idx``'s own plan and
    with none."""
    N = 41
    full = _ids(rng_np, P + 500, N)
    idx = full[:P]
    vals = rng_np.standard_normal((P, C)).astype(np.float32)
    want = np.asarray(JP.scatter_matmul(
        jnp.asarray(idx), jnp.asarray(vals), N,
        vals_dtype=jnp.bfloat16 if bf16 else jnp.float32))
    t_idx, t_vals = torch.from_numpy(idx).long(), torch.from_numpy(vals)
    shared = TP.scatter_plan(torch.from_numpy(full).long(), N)
    got = TP.scatter_matmul(t_idx, t_vals, N, bf16=bf16, plan=shared)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    own = TP.scatter_matmul(t_idx, t_vals, N, bf16=bf16,
                            plan=TP.scatter_plan(t_idx, N))
    assert torch.equal(got, own)
    assert torch.equal(got, TP.scatter_matmul(t_idx, t_vals, N, bf16=bf16))


def test_scatter_matmul_plan_drops_every_id_out_of_range(rng_np):
    """Sentinel, past-the-end and negative ids only: every segment is
    empty and the sum is zero, 1-D values too."""
    idx = torch.tensor([7, 7, 9, -1, -5, 7])
    plan = TP.scatter_plan(idx, 7)
    assert not plan.offsets.any()
    for shape in ((6, 3), (6,)):
        vals = torch.from_numpy(rng_np.standard_normal(shape)
                                .astype(np.float32))
        got = TP.scatter_matmul(idx, vals, 7, plan=plan)
        assert tuple(got.shape) == (7,) + shape[1:] and not got.any()


@pytest.mark.parametrize("mode", ["pallas", "pallas_bf16", "scatter", "auto",
                                  "matmul", "factored", "factored_bf16",
                                  "sort"])
def test_row_plan_only_for_the_kernel_modes(mode):
    """The modes that run B8 get a plan: the pallas modes on every device,
    and on a CUDA device every fixed-order mode (all but "scatter", the
    native scatter, which stays one index_add). On the CPU the others stay
    index_add and get none; a plan gives the same sums as none."""
    assert tscatter.runs_b8(mode, torch.device("cuda")) == (mode != "scatter")
    kernel_mode = mode in ("pallas", "pallas_bf16")
    assert tscatter.runs_b8(mode, torch.device("cpu")) == kernel_mode
    idx = torch.tensor([3, 0, 3, 5])
    plan = tscatter.row_plan(idx, 4, mode)
    assert (plan is None) == (not kernel_mode)
    base = torch.ones((4, 2))
    vals = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    assert torch.equal(
        tscatter.scatter_add_rows(base, idx, vals, mode=mode, plan=plan),
        tscatter.scatter_add_rows(base, idx, vals, mode=mode))


def _scatter_add_rows_before_card_routing(base, idx, vals, mode):
    """What scatter_add_rows computed on the CPU before the fixed-order
    modes were routed to B8 on the card: the pallas modes B8's plain
    version added to base, every other mode one index_add into base."""
    n = base.shape[0]
    idx = idx.reshape(-1).long()
    if mode in ("pallas", "pallas_bf16"):
        agg = TP.scatter_matmul_plain(idx, vals.to(torch.float32), n,
                                      bf16=mode == "pallas_bf16")
        return (base + agg).to(base.dtype)
    valid = (idx >= 0) & (idx < n)
    if mode == "factored_bf16":
        vals = vals.to(torch.bfloat16).to(base.dtype)
    keep = valid.reshape((-1,) + (1,) * (vals.dim() - 1))
    vals = torch.where(keep, vals.to(base.dtype), 0.0)
    return base.index_add(0, torch.where(valid, idx, 0), vals)


@pytest.mark.parametrize("mode", tscatter.MODES)
@pytest.mark.parametrize("width", [None, 11])
def test_scatter_add_rows_on_the_cpu_is_unchanged_and_matches_cdae_tpu(
        rng_np, mode, width):
    """On the CPU every mode computes what it computed before the card
    routing, bit for bit, and agrees with cdae_tpu's same mode to 1e-5
    (f32 sums in another order; the bf16 modes round the same
    contributions). Ids past N count for nothing; negative ids are left out
    of "scatter", whose negative ids wrap in jax."""
    N, Pn = 41, 900
    shape = (Pn,) if width is None else (Pn, width)
    vals = rng_np.standard_normal(shape).astype(np.float32)
    base = rng_np.standard_normal((N,) + shape[1:]).astype(np.float32)
    idx = _ids(rng_np, Pn, N)
    if mode == "scatter":
        idx = np.where(idx < 0, N, idx).astype(np.int32)
    args = (torch.from_numpy(base), torch.from_numpy(idx),
            torch.from_numpy(vals))
    got = tscatter.scatter_add_rows(*args, mode=mode)
    assert torch.equal(got, _scatter_add_rows_before_card_routing(*args,
                                                                  mode))
    want = jscatter.scatter_add_rows(jnp.asarray(base), jnp.asarray(idx),
                                     jnp.asarray(vals), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------------- B9 ----

@pytest.mark.parametrize("N,C,P", [(777, 13, 301), (50, 11, 400),
                                   (9, 4, 20), (3706, 10, 64)])
def test_gather_rows_mxu_plain_matches_cdae_tpu(rng_np, N, C, P):
    """Exact, with the rows of ids out of range (past N, negative) zero
    (tests/test_pallas.py's check, on more shapes)."""
    table = rng_np.standard_normal((N, C)).astype(np.float32)
    idx = _ids(rng_np, P, N)
    want = np.asarray(JP.gather_rows_mxu(jnp.asarray(table), jnp.asarray(idx),
                                         block_p=128, block_q=128))
    before = TP.gather_rows_mxu.launches
    got = TP.gather_rows_mxu(torch.from_numpy(table),
                             torch.from_numpy(idx).long()).numpy()
    assert TP.gather_rows_mxu.launches == before
    np.testing.assert_array_equal(got, want)
    out = (idx < 0) | (idx >= N)
    assert out.any() and not got[out].any()
    np.testing.assert_array_equal(got[~out], table[idx[~out]])


def test_gather_rows_mxu_empty_table_gives_zero_rows():
    got = TP.gather_rows_mxu(torch.zeros((0, 5)), torch.tensor([0, 3]))
    assert tuple(got.shape) == (2, 5) and not got.any()


# -------------------------------------------------------- sample_unrated ----

def _rated_rows(rng, B, I, max_len, full_rows=()):
    L = max_len
    items = np.full((B, L), I, np.int32)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        n = I if b in full_rows else int(rng.integers(0, min(L, I - 1) + 1))
        items[b, :n] = np.sort(rng.choice(I, n, replace=False))
        lengths[b] = n
    return items, lengths


@pytest.mark.parametrize("S", [5, 32, 100, 512, 700])
def test_sample_unrated_matches_cdae_tpu(rng_np, S):
    """The three branches of cdae_tpu's count (S <= 32, <= 512, above) with
    the draws u = jax.random.randint(key, ...) it makes: equal ids, full
    rows at the sentinel I."""
    B, I = 9, 60
    items, lengths = _rated_rows(rng_np, B, I, I, full_rows=(3,))
    key = jax.random.PRNGKey(S)
    free = jnp.maximum(I - jnp.asarray(lengths), 1)
    u = jax.random.randint(key, (B, S), minval=0, maxval=free[:, None],
                           dtype=jnp.int32)
    want = np.asarray(jsampling.sample_unrated(
        key, jnp.asarray(items), jnp.asarray(lengths), I, S))
    got = tsampling.sample_unrated(
        0, torch.from_numpy(items), torch.from_numpy(lengths), I, S,
        u=torch.from_numpy(np.array(u))).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[3] == I).all()
    for b in range(B):
        if b != 3:
            assert not np.isin(got[b], items[b, :lengths[b]]).any()
            assert ((got[b] >= 0) & (got[b] < I)).all()


@pytest.mark.parametrize("hw", [False, True])
def test_sample_unrated_own_draws(rng_np, hw):
    """The port's draws (a generator seeded by the step seed, or B1's hash
    stream): unrated ids only, uniform over each row's complement,
    reproducible from the seed."""
    B, I, S = 6, 40, 4000
    items, lengths = _rated_rows(rng_np, B, I, 30)
    args = (torch.from_numpy(items), torch.from_numpy(lengths), I, S)
    got = tsampling.sample_unrated(123, *args, hw=hw)
    assert got.dtype == torch.int64
    assert torch.equal(got, tsampling.sample_unrated(123, *args, hw=hw))
    assert not torch.equal(got, tsampling.sample_unrated(124, *args, hw=hw))
    for b in range(B):
        rated = set(items[b, :lengths[b]].tolist())
        counts = np.bincount(got[b].numpy(), minlength=I)
        assert not any(counts[r] for r in rated)
        free = I - lengths[b]
        expected = S / free
        chi2 = sum((counts[i] - expected) ** 2 / expected
                   for i in range(I) if i not in rated)
        assert chi2 < free + 6 * np.sqrt(2 * free)  # dof free - 1


# --------------------------------------------------- WARP with B8 and B9 ----

SEED = 20141119
B, NN = 32, 3
WARP_KW = dict(num_dim=8, batch_size=B, num_neg=NN, num_tries=16,
               loss="HINGE", beta=0.0, lambda_=0.1, learn_rate=0.05)


@pytest.fixture(scope="module")
def warp_pair(movielens_path):
    j = JInteractions.from_text(movielens_path, jparser)
    t = TInteractions.from_text(movielens_path, tparser)
    return j.split_by_user(0.2, seed=SEED)[0], t.split_by_user(0.2,
                                                               seed=SEED)[0]


def _warp(warp_pair, **kw):
    jtrain, ttrain = warp_pair
    cfg = {**WARP_KW, **kw}
    jm = jmf.WARP(jmf.MFConfig(**cfg))
    tm = tmf.WARP(tmf.MFConfig(**cfg), device="cpu")
    js, ts = jm.reset(jtrain, seed=0), tm.reset(ttrain, seed=0)
    rng = np.random.default_rng(3)
    p = {k: np.array(v) for k, v in js.params.items()}
    for k in ("uv", "iv", "ub", "ib"):
        p[k] = (rng.standard_normal(p[k].shape) * 0.3).astype(np.float32)
        p[k + "_ag"] = rng.uniform(0.5, 1.5, p[k].shape).astype(np.float32)
    js.params = {k: jnp.asarray(v) for k, v in p.items()}
    ts.params = tckpt.params_from_numpy(p, "cpu")
    return jm, js, tm, ts


@pytest.mark.parametrize("scatter_mode", ["pallas", "pallas_bf16"])
def test_warp_step_with_b8_b9_matches_native_and_cdae_tpu(warp_pair,
                                                          scatter_mode):
    """One kernel-route WARP step with gather_mode="mxu" and the B8
    scatter: equal to cdae_tpu's step with the same modes and draws, and
    for "pallas" to the port's native step (B9 is exact, B8's plain sum
    runs in index_add's order; "pallas_bf16" rounds the contributions)."""
    modes = dict(gather_mode="mxu", scatter_mode=scatter_mode)
    jm, js, tm, ts = _warp(warp_pair, use_pallas=True, **modes)
    _, _, nm, ns = _warp(warp_pair, use_pallas=True)
    rng = np.random.default_rng(5)
    users, items, _ = js.aux["coo"]
    sel = rng.integers(0, len(users), B)
    w = np.ones(B, np.float32)
    w[-3:] = 0.0
    u, i = users[sel], items[sel]
    mask = np.asarray(jm._epoch_extras(js)[0])[u]
    lengths = js.padded.lengths[u]
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)
    draws = dict(sel_seed=int(jsampling.key_seed(k2)),
                 u1=torch.from_numpy(np.array(jax.random.uniform(
                     k1, (B, NN), minval=1e-7, maxval=1.0))))
    want = jmf.WARP._dense_path(
        js.params, *map(jnp.asarray, (u, i, w, lengths)), key,
        jnp.asarray(mask), cfg=jm.cfg, loss=jm.loss)
    targs = (torch.from_numpy(u).long(), torch.from_numpy(i).long(),
             torch.from_numpy(w), torch.from_numpy(lengths), (0, 0))
    b9 = TP.gather_rows_mxu.launches
    got = tmf.WARP._dense_path(ts.params, *targs,
                               tm._epoch_extras(ts)[0][targs[0]],
                               cfg=tm.cfg, loss=tm.loss, **draws)
    native = tmf.WARP._dense_path(ns.params, *targs,
                                  nm._epoch_extras(ns)[0][targs[0]],
                                  cfg=nm.cfg, loss=nm.loss, **draws)
    assert TP.gather_rows_mxu.launches == b9  # CPU: plain versions
    for k in want:
        want_k = np.asarray(want[k])
        atol = 1e-5 * max(1.0, float(np.abs(want_k).max()))
        np.testing.assert_allclose(got[k].numpy(), want_k, rtol=1e-5,
                                   atol=atol, err_msg=k)
        if scatter_mode == "pallas":
            np.testing.assert_allclose(got[k].numpy(), native[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("route", ["cpu", "as_on_cuda"])
def test_warp_step_auto_equals_pallas(warp_pair, monkeypatch, route):
    """A WARP step with the default scatter_mode="auto" equals one with
    "pallas" on the same draws, bit for bit: on the CPU both sum in
    ascending p; routed as on a CUDA device ("as_on_cuda": runs_b8 sees a
    card), auto builds B8's two plans and runs B8 (its plain version
    here), as "pallas" does."""
    asked = []
    if route == "as_on_cuda":
        monkeypatch.setattr(tscatter, "runs_b8",
                            lambda mode, device: mode != "scatter")
        real_plan = tscatter.scatter_plan
        monkeypatch.setattr(tscatter, "scatter_plan",
                            lambda *a: asked.append(a) or real_plan(*a))
    rng = np.random.default_rng(5)
    _, js, _, _ = _warp(warp_pair, use_pallas=True)
    users, items, _ = js.aux["coo"]
    sel = rng.integers(0, len(users), B)
    w = np.ones(B, np.float32)
    w[-3:] = 0.0
    u = torch.from_numpy(users[sel]).long()
    targs = (u, torch.from_numpy(items[sel]).long(), torch.from_numpy(w),
             torch.from_numpy(js.padded.lengths[users[sel]]), (0, 0))
    draws = dict(sel_seed=4321, u1=torch.from_numpy(
        rng.uniform(1e-7, 1.0, (B, NN)).astype(np.float32)))
    out = {}
    for mode in ("auto", "pallas"):
        _, _, tm, ts = _warp(warp_pair, use_pallas=True, scatter_mode=mode)
        out[mode] = tmf.WARP._dense_path(
            ts.params, *targs, tm._epoch_extras(ts)[0][u], cfg=tm.cfg,
            loss=tm.loss, **draws)
    assert len(asked) == (4 if route == "as_on_cuda" else 0)
    for k in out["pallas"]:
        assert torch.equal(out["auto"][k], out["pallas"][k]), k


def test_params_from_numpy_owns_its_memory():
    """The models update their tables in place, so the tensors must not
    share memory with the caller's arrays: the WARP and FISM tests hand the
    same arrays to cdae_tpu, whose jnp.asarray may alias them (zero-copy)
    and read them later (asynchronous dispatch)."""
    p = {"uv": np.ones((4, 3), np.float32), "ib": np.zeros(4, np.float32),
         "T": np.asfortranarray(np.ones((2, 5), np.float32))}
    t = tckpt.params_from_numpy(p, "cpu")
    for name in t:
        t[name] += 1.0
        assert t[name].dtype == torch.float32 and t[name].is_contiguous()
    assert (p["uv"] == 1.0).all() and not p["ib"].any()
    assert (p["T"] == 1.0).all()


# ------------------------------------------ a step's plans against none ----

def _no_plans(monkeypatch, module):
    """Make ``module``'s steps build no plan (each B8 call sorts on its
    own); returns the list of the plans they asked for."""
    asked = []
    monkeypatch.setattr(module, "row_plan",
                        lambda *args: asked.append(args) or None)
    return asked


@pytest.mark.parametrize("cls", ["FISM", "FISMPair"])
@pytest.mark.parametrize("scatter_mode", ["pallas", "pallas_bf16"])
def test_fism_steps_with_a_shared_plan_equal_steps_without(
        movielens_path, monkeypatch, cls, scatter_mode):
    """One sparse epoch with one plan per step (FISM's Q + b_i and P sums,
    FISMPair's b_i, Q and P sums) against the same epoch with none: the
    same bits (each row sums its contributions in ascending p either
    way)."""
    import cdae_tpu_torch.models.fism as tfism

    train = TInteractions.from_text(movielens_path, tparser).split_by_user(
        0.2, seed=SEED)[0]
    model = getattr(tfism, cls)(tfism.FISMConfig(
        num_dim=6, num_neg=3, batch_size=16, dense_mode=False,
        scatter_mode=scatter_mode), device="cpu")

    def epoch():
        state = model.reset(train, seed=0)
        model.train_one_iteration(state, SEED)
        return state.params

    with_plan = epoch()
    asked = _no_plans(monkeypatch, tfism)
    without = epoch()
    assert asked  # one plan per step was asked for
    for k in with_plan:
        assert torch.equal(with_plan[k], without[k]), k


@pytest.mark.parametrize("scatter_mode", ["pallas", "pallas_bf16"])
def test_warp_step_with_plans_equals_step_without(warp_pair, monkeypatch,
                                                  scatter_mode):
    """WARP's item and user sums, each over its own plan, against the same
    step with none: the same bits."""
    modes = dict(gather_mode="mxu", scatter_mode=scatter_mode)
    _, js, tm, ts = _warp(warp_pair, use_pallas=True, **modes)
    _, _, _, ts2 = _warp(warp_pair, use_pallas=True, **modes)
    rng = np.random.default_rng(5)
    users, items, _ = js.aux["coo"]
    sel = rng.integers(0, len(users), B)
    w = np.ones(B, np.float32)
    w[-3:] = 0.0
    u = torch.from_numpy(users[sel]).long()
    targs = (u, torch.from_numpy(items[sel]).long(), torch.from_numpy(w),
             torch.from_numpy(js.padded.lengths[users[sel]]), (0, 0))
    draws = dict(sel_seed=1234, u1=torch.from_numpy(
        rng.uniform(1e-7, 1.0, (B, NN)).astype(np.float32)))
    got = tmf.WARP._dense_path(ts.params, *targs, tm._epoch_extras(ts)[0][u],
                               cfg=tm.cfg, loss=tm.loss, **draws)
    asked = _no_plans(monkeypatch, tmf)
    plain = tmf.WARP._dense_path(ts2.params, *targs,
                                 tm._epoch_extras(ts2)[0][u], cfg=tm.cfg,
                                 loss=tm.loss, **draws)
    assert len(asked) == 2  # the item sums' and the user sums'
    for k in got:
        assert torch.equal(got[k], plain[k]), k

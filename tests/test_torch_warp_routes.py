"""cdae_tpu_torch's WARP routes past the dense path against cdae_tpu's on
the same inputs: the pool path (with the (U, I) rated mask, and with the
CSR rows), the scan path and the per-user slab, each step and a whole
epoch with the very draws cdae_tpu makes injected; then end to end (Solver
and the CLI).

Draws: the pool path splits its step key in three -- the pool
(randint(k_pool, (P,), 0, I)), the count uniforms (uniform(k_cnt, (B, nn),
1e-7, 1)) and the selection noise (uniform(k_sel, (B, nn, P))); the scan
path draws nn * num_tries complement candidates by sample_unrated(key);
the slab splits its key in two and draws its pool from the first. The
tests hand the port exactly these. Parameters and tolerance as in
tests/test_torch_mf.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cdae_tpu.models.mf as jmf
import cdae_tpu_torch.models.mf as tmf
from cdae_tpu.data import io as jio
from cdae_tpu.data.dataset import Interactions as JInteractions
from cdae_tpu.data.dataset import movielens_line_parser as jparser
from cdae_tpu.ops import sampling as jsampling
from cdae_tpu_torch import cli as tcli
from cdae_tpu_torch.data.dataset import Interactions as TInteractions
from cdae_tpu_torch.data.dataset import movielens_line_parser as tparser
from cdae_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

SEED = 20141119
B, NN, T, P = 32, 3, 16, 24
WARP_KW = dict(num_dim=8, batch_size=B, num_neg=NN, num_tries=T,
               loss="HINGE", beta=0.0, lambda_=0.1, learn_rate=0.05)


def _close(got, want, msg=""):
    want = np.asarray(want)
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol,
                               err_msg=msg)


def _all_close(got, want):
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)


@pytest.fixture(scope="module")
def splits(movielens_path):
    j = JInteractions.from_text(movielens_path, jparser)
    t = TInteractions.from_text(movielens_path, tparser)
    return j.split_by_user(0.2, seed=SEED), t.split_by_user(0.2, seed=SEED)


def _pair(splits, **kw):
    """cdae_tpu's WARP + state and the port's, holding the same N(0, 0.3)
    params and [0.5, 1.5) accumulators."""
    (jtrain, _), (ttrain, _) = splits
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


def _batch(js, seed=5):
    rng = np.random.default_rng(seed)
    users, items, _ = js.aux["coo"]
    sel = rng.integers(0, len(users), B)
    w = np.ones(B, np.float32)
    w[-3:] = 0.0
    u = users[sel]
    return u, items[sel], w, js.padded.items[u], js.padded.lengths[u]


def _pool_draws(key, I):
    k_pool, k_cnt, k_sel = jax.random.split(key, 3)
    return dict(
        pool=torch.from_numpy(np.array(jax.random.randint(
            k_pool, (P,), 0, I, dtype=jnp.int32))).long(),
        u1=torch.from_numpy(np.array(jax.random.uniform(
            k_cnt, (B, NN), minval=1e-7, maxval=1.0))),
        noise=torch.from_numpy(np.array(jax.random.uniform(
            k_sel, (B, NN, P)))))


def _scan_draws(key, rated, lengths, I):
    return dict(cand=torch.from_numpy(np.array(jsampling.sample_unrated(
        key, jnp.asarray(rated), jnp.asarray(lengths), I, NN * T))).long())


def _t(*arrays):
    out = []
    for a in arrays:
        t = torch.from_numpy(np.array(a))
        out.append(t.long() if t.dtype == torch.int64 else t)
    return out


# ------------------------------------------------------------ the steps ----

@pytest.mark.parametrize("scatter_mode", ["auto", "pallas"])
@pytest.mark.parametrize("row_update", [False, True])
def test_pool_path_step_matches_with_mask_and_csr(splits, row_update,
                                                  scatter_mode):
    """One pool-path step with cdae_tpu's draws, membership from the rated
    mask and from the CSR rows: both match cdae_tpu, and the two give the
    same bits (the same truth table)."""
    out = {}
    for membership in ("mask", "csr"):
        jm, js, tm, ts = _pair(splits, warp_pool=P, row_update=row_update,
                               scatter_mode=scatter_mode)
        u, i, w, rated, lengths = _batch(js)
        key = jax.random.PRNGKey(7)
        mask = None
        if membership == "mask":
            mask = np.asarray(jm._epoch_extras(js)[0])[u]
        want = jmf.WARP._pool_path(
            js.params, *map(jnp.asarray, (u, i, w, lengths)), key,
            None if mask is None else jnp.asarray(mask), cfg=jm.cfg,
            loss=jm.loss, rated=jnp.asarray(rated))
        tu, ti, tw, trated, tlen = _t(u, i, w, rated, lengths)
        got = tmf.WARP._pool_path(
            ts.params, tu, ti, tw, tlen, (0, 0, 0),
            None if mask is None else torch.from_numpy(mask), cfg=tm.cfg,
            loss=tm.loss, rated=trated, **_pool_draws(key, js.num_items))
        _all_close(got, want)
        out[membership] = got
    for k in out["mask"]:
        assert torch.equal(out["mask"][k], out["csr"][k]), k


@pytest.mark.parametrize("row_update", [False, True])
def test_scan_path_step_matches(splits, row_update):
    jm, js, tm, ts = _pair(splits, dense_mode=False, row_update=row_update)
    assert jm._epoch_extras(js) == () and tm._epoch_extras(ts) == ()
    u, i, w, rated, lengths = _batch(js)
    key = jax.random.PRNGKey(8)
    want = jmf.WARP._scan_path(js.params, *map(jnp.asarray,
                                               (u, i, w, rated, lengths)),
                               key, cfg=jm.cfg, loss=jm.loss)
    got = tmf.WARP._scan_path(ts.params, *_t(u, i, w, rated, lengths),
                              (0, 0, 0), cfg=tm.cfg, loss=tm.loss,
                              **_scan_draws(key, rated, lengths,
                                            js.num_items))
    _all_close(got, want)


def _slab(js, Bs=B):
    U = js.num_users
    return ((np.arange(Bs) % U).astype(np.int32),
            (np.arange(Bs) < U).astype(np.float32))


def _slab_pool(key, I, pool_size):
    k_pool, _ = jax.random.split(key)
    return torch.from_numpy(np.array(jax.random.randint(
        k_pool, (pool_size,), 0, I, dtype=jnp.int32))).long()


@pytest.mark.parametrize("loss", ["HINGE", "LOG"])
@pytest.mark.parametrize("scatter_mode", ["auto", "pallas"])
def test_slab_step_matches(splits, scatter_mode, loss):
    """One slab of 32 users (7 padding rows) with cdae_tpu's pool: the
    violation cube, the Rao-Blackwellized picks and rank weights."""
    jm, js, tm, ts = _pair(splits, dense_mode=True, warp_pool=P,
                           scatter_mode=scatter_mode, loss=loss)
    assert "dense_R" in js.aux and "dense_R" in ts.aux
    uids, w = _slab(js)
    key = jax.random.PRNGKey(4)
    jR = js.aux["dense_R"]
    want = jmf.WARP._dense_step(js.params, jR, jR, jnp.asarray(uids),
                                jnp.asarray(w), key, cfg=jm.cfg,
                                loss=jm.loss)
    tR = ts.aux["dense_R"]
    got = tmf.WARP._dense_step(ts.params, tR, tR, *_t(uids, w), (0, 0),
                               cfg=tm.cfg, loss=tm.loss,
                               pool=_slab_pool(key, js.num_items, P))
    _all_close(got, want)


def test_slab_chunks_change_no_number(splits, monkeypatch):
    """The (B, I, P) and (B, I, T) cubes in chunks of one user against one
    chunk; the default pool (1024) when warp_pool is None."""
    out = []
    for cube in (tmf._CUBE_ELEMS, 1):
        monkeypatch.setattr(tmf, "_CUBE_ELEMS", cube)
        _, js, tm, ts = _pair(splits, dense_mode=True)
        tm.train_one_iteration(ts, 3)
        out.append(ts.params)
    for k in out[0]:
        _close(out[1][k], out[0][k].numpy(), k)


# ----------------------------------------------------------- the epochs ----

_ROUTES = {"pool_mask": dict(warp_pool=P),
           "pool_csr": dict(warp_pool=P, dense_mode=False),
           "scan": dict(dense_mode=False)}


@pytest.mark.parametrize("route", list(_ROUTES))
def test_epoch_matches_with_injected_draws(splits, route):
    """cdae_tpu's fused instance epoch (its permutation, one key per step)
    against the port's epoch fed that permutation and those keys'
    draws."""
    jm, js, tm, ts = _pair(splits, **_ROUTES[route])
    key = jax.random.PRNGKey(5)
    js = jm.train_one_iteration(js, key)
    users = js.aux["coo"][0]
    n = len(users)
    nb = -(-n // B)
    kperm, kstep = jax.random.split(key)
    perm = np.array(jax.random.permutation(kperm, n))
    subs = jax.random.split(kstep, nb)
    sel = np.concatenate([perm, np.zeros(nb * B - n, perm.dtype)])
    draws = []
    for b in range(nb):
        u = users[sel[b * B:(b + 1) * B]]
        if route == "scan":
            draws.append(_scan_draws(subs[b], js.padded.items[u],
                                     js.padded.lengths[u], js.num_items))
        else:
            draws.append(_pool_draws(subs[b], js.num_items))
    tm.train_one_iteration(ts, 0, perm=perm, draws=draws)
    assert ts.step == js.step == 1
    _all_close(ts.params, js.params)


def test_slab_epoch_matches_with_injected_draws(splits):
    jm, js, tm, ts = _pair(splits, dense_mode=True, warp_pool=P,
                           batch_size=16)
    key = jax.random.PRNGKey(6)
    js = jm.train_one_iteration(js, key)
    k = -(-js.num_users // 16)
    subs = jax.random.split(key, k)
    tm.train_one_iteration(ts, 0, draws=[
        {"pool": _slab_pool(subs[j], js.num_items, P)} for j in range(k)])
    _all_close(ts.params, js.params)


def test_routes_draw_from_their_step_seeds(splits):
    """Without injected draws every route draws from its step seeds: the
    same seed gives the same bits, another seed another update; fast_rng
    (B1's hash stream) too. The pool path gives the same bits with the
    mask as with the CSR rows."""
    for fast_rng in (False, True):
        by_route = {}
        for route, kw in list(_ROUTES.items()) + [
                ("slab", dict(dense_mode=True, warp_pool=P))]:
            out = []
            for seed in (5, 5, 6):
                _, _, tm, ts = _pair(splits, fast_rng=fast_rng, **kw)
                tm.train_one_iteration(ts, seed)
                out.append(ts.params)
            assert torch.equal(out[0]["iv"], out[1]["iv"]), route
            assert not torch.equal(out[0]["iv"], out[2]["iv"]), route
            by_route[route] = out[0]
        for k in by_route["pool_mask"]:
            assert torch.equal(by_route["pool_mask"][k],
                               by_route["pool_csr"][k]), k


# ----------------------------------------------------------- end to end ----

@pytest.fixture(scope="module")
def lowrank():
    """Low-rank data of 300 users x 300 items (both packages' generator,
    the same interactions), split 0.2: the fixture's 38 items saturate
    R@10 near 0.84 and its 25 users move it in steps of 0.02-0.04."""
    from cdae_tpu.data.synthetic import lowrank_interactions as jlow
    from cdae_tpu_torch.data.synthetic import lowrank_interactions as tlow

    return (jlow(300, 300, 20, seed=3).split_by_user(0.2, seed=1),
            tlow(300, 300, 20, seed=3).split_by_user(0.2, seed=1))


@pytest.mark.parametrize("route", list(_ROUTES) + ["slab"])
def test_solver_lands_near_cdae_tpu(lowrank, route):
    """Solver, 10 epochs from three seeds: R@10 rises on every run, and
    the port's 3-seed mean lands within 0.03 of cdae_tpu's (the parity
    protocol's mean: the same sampling distributions from other random
    streams). The slab at 3x lr (scripts/parity_zoo.py's WARP_DENSE) with
    a 256-id pool (the cube's work grows with the pool, and both packages
    run the same one)."""
    from cdae_tpu.solver.solver import Solver as JSolver
    from cdae_tpu_torch.solver.solver import Solver, _params_finite

    (jtrain, jtest), (ttrain, ttest) = lowrank
    kw = dict(_ROUTES.get(route, {}), learn_rate=0.1)
    if route == "slab":
        kw = dict(dense_mode=True, warp_pool=256, learn_rate=0.3)
    cfg = {**WARP_KW, **kw}
    jm = jmf.WARP(jmf.MFConfig(**cfg))
    tm = tmf.WARP(tmf.MFConfig(**cfg), device="cpu")
    got, want = [], []
    for seed in (3, 4, 5):
        jsol = JSolver(jm, max_iteration=10, eval_iterations=10, seed=seed,
                       verbose=False)
        jsol.train(jtrain, jtest, ["TOPN"])
        tsol = Solver(tm, max_iteration=10, eval_iterations=10, seed=seed,
                      verbose=False)
        tsol.train(ttrain, ttest, ["TOPN"])
        assert _params_finite(tsol.state.params)
        assert tsol.history[-1]["R@10"] > tsol.history[0]["R@10"]
        got.append(tsol.history[-1]["R@10"])
        want.append(jsol.history[-1]["R@10"])
    assert abs(np.mean(got) - np.mean(want)) < 0.03, (route, got, want)


@pytest.mark.parametrize("extra", [
    ["--dense_mode", "true", "--warp_pool", "16"],
    ["--dense_mode", "false"],
    ["--warp_pool", "16"],
    ["--dense_mode", "false", "--warp_pool", "16", "--fast_rng", "true"],
])
def test_cli_trains_each_route(movielens_path, tmp_path, extra):
    cache = str(tmp_path / "all.bin")
    jio.save_interactions(JInteractions.from_text(movielens_path, jparser),
                          cache)
    argv = ["--task", "train", "--method", "WARP", "--device", "cpu",
            "--skip_popularity", "--cache_file", cache, "--num_dim", "8",
            "--num_neg", "3", "--loss_type", "HINGE", "--beta", "0",
            "--lambda", "0.1", "--batch_size", "32", "--max_iters", "3",
            "--eval_iters", "3"] + extra
    solver = tcli.train(tcli.build_arg_parser().parse_args(argv))
    hist = solver.history
    assert hist[-1]["iter"] == 3.0 and np.isfinite(hist[-1]["R@10"])
    assert ("dense_R" in solver.state.aux) == (extra[1] == "true")

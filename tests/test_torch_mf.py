"""cdae_tpu_torch's WARP against cdae_tpu's on the same inputs: the pair
update math, the dense path's step and a whole epoch with the very draws
cdae_tpu makes injected, scoring and losses on carried parameters, and
WARP end to end (Solver, resume, the guard, TOPN, the CLI). Also: the
models not ported yet raise, and WARP's other routes, the B8/B9 routes and
FISM run.

Draws: cdae_tpu's step splits its key into (k1, k2); the count uniforms
are jax.random.uniform(k1), the kernel route's seed is key_seed(k2) and the
cumsum route's ranks jax.random.randint(k2, maxval=max(nviol, 1)). The
tests hand the port exactly these. Parameters are N(0, 0.3) with AdaGrad
accumulators at a trained scale (0.5-1.5): at the 1e-4 init, cdae_tpu's
row_adagrad_delta prefix (the inclusive cumsum minus g^2, which keeps
rounding noise of the batch's running sum) moves a first touch's step by
percents, where the port's exclusive cumsums are exact (PERF.md).
Tolerance: 1e-5 of each table's scale -- f32 sums in another order.
"""

import dataclasses

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
from cdae_tpu.evaluation import Evaluation as JEvaluation
from cdae_tpu.ops import sampling as jsampling
from cdae_tpu.solver.solver import Solver as JSolver
from cdae_tpu_torch import cli as tcli
from cdae_tpu_torch import models as tmodels
from cdae_tpu_torch.data.dataset import Interactions as TInteractions
from cdae_tpu_torch.data.dataset import movielens_line_parser as tparser
from cdae_tpu_torch.evaluation import Evaluation as TEvaluation
from cdae_tpu_torch.ops.losses import Loss as TLoss
from cdae_tpu_torch.solver.solver import Solver, _params_finite
from cdae_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

SEED = 20141119
B, NN, T = 32, 3, 16
WARP_KW = dict(num_dim=8, batch_size=B, num_neg=NN, num_tries=T,
               loss="HINGE", beta=0.0, lambda_=0.1, learn_rate=0.05)


def _close(got, want, msg=""):
    want = np.asarray(want)
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol,
                               err_msg=msg)


@pytest.fixture(scope="module")
def splits(movielens_path):
    j = JInteractions.from_text(movielens_path, jparser)
    t = TInteractions.from_text(movielens_path, tparser)
    return j.split_by_user(0.2, seed=SEED), t.split_by_user(0.2, seed=SEED)


def _random_params(js, seed=3):
    """cdae_tpu's reset, with N(0, 0.3) factors and biases and trained-scale
    accumulators; numpy arrays."""
    rng = np.random.default_rng(seed)
    p = {k: np.array(v) for k, v in js.params.items()}
    for k in ("uv", "iv", "ub", "ib"):
        p[k] = (rng.standard_normal(p[k].shape) * 0.3).astype(np.float32)
        p[k + "_ag"] = rng.uniform(0.5, 1.5, p[k].shape).astype(np.float32)
    return p


def _pair(splits, **kw):
    """cdae_tpu's WARP + state and the port's, holding the same params."""
    (jtrain, _), (ttrain, _) = splits
    cfg = {**WARP_KW, **kw}
    jm = jmf.WARP(jmf.MFConfig(**cfg))
    tm = tmf.WARP(tmf.MFConfig(**cfg), device="cpu")
    js, ts = jm.reset(jtrain, seed=0), tm.reset(ttrain, seed=0)
    p = _random_params(js)
    js.params = {k: jnp.asarray(v) for k, v in p.items()}
    ts.params = tckpt.params_from_numpy(p, "cpu")
    return jm, js, tm, ts


# ----------------------------------------------------------- pair math ----

def _pair_inputs(rng, Bn=12, nn=4, D=6):
    f = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)  # noqa
    w = (rng.random((Bn, nn)) < 0.8).astype(np.float32)
    return (f(Bn, D), f(Bn, D), f(Bn, nn, D), f(Bn), f(Bn, nn), w,
            rng.uniform(1.0, 4.0, (Bn, nn)).astype(np.float32))


@pytest.mark.parametrize("loss,rank,update_bias,bias", [
    ("HINGE", True, False, True),
    ("LOG", False, True, True),
    ("SQUARED_HINGE", True, True, False),
])
def test_pair_contribs_match(loss, rank, update_bias, bias):
    rng = np.random.default_rng(1)
    *arrays, rw = _pair_inputs(rng)
    cfg = dict(lambda_=0.1, using_bias_term=bias)
    want = jmf._pair_contribs(
        *map(jnp.asarray, arrays), jmf.MFConfig(**cfg),
        jmf.Loss.create(loss), rank_weight=jnp.asarray(rw) if rank else None,
        update_bias=update_bias)
    got = tmf._pair_contribs(
        *map(torch.from_numpy, arrays), tmf.MFConfig(**cfg),
        TLoss.create(loss), rank_weight=torch.from_numpy(rw) if rank
        else None, update_bias=update_bias)
    assert got[3] == want[3] == (update_bias and bias)
    for g, w in zip(got[:3], want[:3]):
        _close(g, w)


def _pair_ids(rng, U, I, Bn=16, nn=3):
    u = rng.integers(0, U, Bn)
    i = rng.integers(0, I, Bn)
    j = rng.integers(0, I, (Bn, nn))
    w = (rng.random((Bn, nn)) < 0.8).astype(np.float32)
    w[-2:] = 0.0  # batch padding
    rw = rng.uniform(1.0, 4.0, (Bn, nn)).astype(np.float32)
    return u, i, j, w, rw


@pytest.mark.parametrize("update_bias", [False, True])
def test_pairwise_grads_match(splits, update_bias):
    jm, js, tm, ts = _pair(splits)
    u, i, j, w, rw = _pair_ids(np.random.default_rng(2), js.num_users,
                               js.num_items)
    want = jmf._pairwise_grads(js.params, *map(jnp.asarray, (u, i, j, w)),
                               jm.cfg, jm.loss, rank_weight=jnp.asarray(rw),
                               update_bias=update_bias)
    got = tmf._pairwise_grads(ts.params, *(torch.from_numpy(x) for x in
                                           (u, i, j, w)),
                              tm.cfg, tm.loss, rank_weight=torch.from_numpy(rw),
                              update_bias=update_bias)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)


@pytest.mark.parametrize("row_update", [False, True])
def test_pairwise_apply_matches_both_branches(splits, row_update):
    jm, js, tm, ts = _pair(splits, row_update=row_update)
    u, i, j, w, rw = _pair_ids(np.random.default_rng(4), js.num_users,
                               js.num_items)
    want = jmf._pairwise_apply(js.params, *map(jnp.asarray, (u, i, j, w)),
                               jm.cfg, jm.loss, rank_weight=jnp.asarray(rw),
                               update_bias=True)
    got = tmf._pairwise_apply(ts.params, *(torch.from_numpy(x) for x in
                                           (u, i, j, w)),
                              tm.cfg, tm.loss, rank_weight=torch.from_numpy(rw),
                              update_bias=True)
    assert got is ts.params  # in place
    for k in want:
        _close(got[k], want[k], k)


# ------------------------------------------------------- the dense path ----

def _jax_nviol(params, u, i, mask_rows):
    """cdae_tpu's cumsum-route violator count (the ops of its _dense_path),
    for the ranks jax.random.randint draws from it."""
    uv_u = params["uv"][u]
    scores = uv_u @ params["iv"].T + params["ib"][None, :]
    yui = jnp.take_along_axis(scores, i[:, None], axis=1)[:, 0]
    viol = (scores > (yui[:, None] - 1.0)) & (mask_rows == 0)
    return jnp.sum(viol.astype(jnp.int32), axis=1)


def _torch_nviol(params, u, i, mask_rows):
    scores = params["uv"][u] @ params["iv"].t() + params["ib"][None, :]
    yui = scores.gather(1, i[:, None])[:, 0]
    viol = (scores > yui[:, None] - 1.0) & (mask_rows == 0)
    return viol.sum(1).numpy().astype(np.int32)


def _draws(key, nviol=None):
    """What cdae_tpu's _dense_path draws from ``key`` (B, NN shapes)."""
    k1, k2 = jax.random.split(key)
    d = dict(sel_seed=int(jsampling.key_seed(k2)),
             u1=torch.from_numpy(np.array(jax.random.uniform(
                 k1, (B, NN), minval=1e-7, maxval=1.0))))
    if nviol is not None:
        d["v"] = torch.from_numpy(np.array(jax.random.randint(
            k2, (B, NN), 0, jnp.maximum(jnp.asarray(nviol), 1)[:, None])))
    return d


@pytest.mark.parametrize("row_update", [False, True])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_dense_path_step_matches(splits, use_pallas, row_update):
    """One step of each route (the kernel route runs cdae_tpu's Pallas
    kernel in interpret mode and the port's plain version) and each
    _pairwise_apply branch."""
    jm, js, tm, ts = _pair(splits, use_pallas=use_pallas,
                           row_update=row_update)
    rng = np.random.default_rng(5)
    users, items, _ = js.aux["coo"]
    sel = rng.integers(0, len(users), B)
    w = np.ones(B, np.float32)
    w[-3:] = 0.0
    u, i = users[sel], items[sel]
    mask = np.asarray(jm._epoch_extras(js)[0])[u]
    lengths = js.padded.lengths[u]
    key = jax.random.PRNGKey(9)
    want = jmf.WARP._dense_path(
        js.params, *map(jnp.asarray, (u, i, w, lengths)), key,
        jnp.asarray(mask), cfg=jm.cfg, loss=jm.loss)
    nviol = None if use_pallas else _jax_nviol(
        js.params, jnp.asarray(u), jnp.asarray(i), jnp.asarray(mask))
    tmask = tm._epoch_extras(ts)[0][torch.from_numpy(u).long()]
    assert np.array_equal(tmask.numpy(), mask)
    got = tmf.WARP._dense_path(
        ts.params, torch.from_numpy(u).long(), torch.from_numpy(i).long(),
        torch.from_numpy(w), torch.from_numpy(lengths), (0, 0), tmask,
        cfg=tm.cfg, loss=tm.loss, **_draws(key, nviol))
    for k in want:
        _close(got[k], want[k], k)


@pytest.mark.parametrize("row_update", [False, True])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_epoch_matches_with_injected_draws(splits, use_pallas, row_update):
    """cdae_tpu's fused epoch (its permutation, then one key per step)
    against the port's epoch fed that permutation and those draws; the
    cumsum route's ranks are drawn from the violator counts of the port's
    own parameters before each step, as cdae_tpu draws them from its."""
    jm, js, tm, ts = _pair(splits, use_pallas=use_pallas,
                           row_update=row_update)
    key = jax.random.PRNGKey(5)
    js = jm.train_one_iteration(js, key)
    n = len(js.aux["coo"][0])
    nb = -(-n // B)
    kperm, kstep = jax.random.split(key)
    perm = np.array(jax.random.permutation(kperm, n))
    subs = jax.random.split(kstep, nb)
    sel = np.concatenate([perm, np.zeros(nb * B - n, perm.dtype)])
    users, items, *_ = tm._device_data(ts)
    R = tm._epoch_extras(ts)[0]

    class Draws:
        def __getitem__(self, b):
            if use_pallas:
                return _draws(subs[b])
            s = torch.from_numpy(sel[b * B:(b + 1) * B]).long()
            return _draws(subs[b], _torch_nviol(ts.params, users[s],
                                                items[s], R[users[s]]))

    assert tm.train_one_iteration(ts, 0, perm=perm, draws=Draws()) is ts
    assert ts.step == js.step == 1
    for k in js.params:
        _close(ts.params[k], js.params[k], k)


def test_dense_path_draws_from_its_step_seeds(splits):
    """Without injected draws a step draws from its step seeds: the same
    seeds give the same update, other seeds another one; fast_rng (hash
    uniforms) too."""
    for fast_rng in (False, True):
        for use_pallas in (True, False):
            out = []
            for seed in (5, 5, 6):
                _, _, tm, ts = _pair(splits, fast_rng=fast_rng,
                                     use_pallas=use_pallas)
                tm.train_one_iteration(ts, seed)
                out.append(ts.params["iv"])
            assert torch.equal(out[0], out[1])
            assert not torch.equal(out[0], out[2])


# --------------------------------------------------- scoring and losses ----

def test_scores_predict_and_losses_on_carried_params(splits):
    jm, js, tm, ts = _pair(splits)
    uids = np.arange(0, js.num_users, 2)
    _close(tm.batch_scores(ts, uids, None, None),
           jm.batch_scores(js, uids, None, None))
    users, items, _ = js.aux["coo"]
    _close(tm.predict(ts, users, items), jm.predict(js, users, items))
    assert tm.data_loss(ts) == pytest.approx(jm.data_loss(js), rel=1e-5)
    assert tm.penalty_loss(ts) == pytest.approx(jm.penalty_loss(js),
                                                rel=1e-5)
    assert tm.current_loss(ts, 7) == pytest.approx(
        tm.data_loss(ts) + tm.penalty_loss(ts), rel=1e-6)
    # TOPN over the full batch_scores: the same metrics
    (jtrain, jtest), (ttrain, ttest) = splits
    want = JEvaluation.create("TOPN").evaluate(jm, js, jtest, jtrain)
    got = TEvaluation.create("TOPN").evaluate(tm, ts, ttest, ttrain)
    for c in ("P@1", "P@10", "R@10", "MAP@10"):
        assert got[c] == pytest.approx(want[c], abs=1e-6), c


def test_reset_and_config(splits):
    (_, _), (ttrain, _) = splits
    m = tmf.WARP(device="cpu")
    assert (m.cfg.loss, m.cfg.beta, m.cfg.lambda_) == ("HINGE", 0.0, 0.1)
    assert m.cfg.use_pallas is False and m.cfg.fast_rng is False
    assert len(dataclasses.fields(tmf.MFConfig)) == 21
    st = m.reset(ttrain, seed=3)
    p = st.params
    assert set(p) == {"uv", "iv", "ub", "ib", "uv_ag", "iv_ag", "ub_ag",
                      "ib_ag"}
    assert p["uv"].shape == (st.num_users, 10)
    assert float(p["iv"].abs().max()) < 0.01 and not p["ib"].any()
    assert torch.equal(p["uv_ag"], torch.full_like(p["uv_ag"], 1e-4))
    assert torch.equal(m.reset(ttrain, seed=3).params["iv"], p["iv"])
    R = m._epoch_extras(st)[0]
    assert R.dtype == torch.int8 and int(R.sum()) == len(ttrain)


# ----------------------------------------------------------- end to end ----

def test_warp_trains_near_cdae_tpu(splits):
    """The port's Solver on the fixture, both routes: R@10 rises and lands
    within 0.12 of cdae_tpu's (tests/test_pallas.py's bound: the same
    sampling distribution, other random streams)."""
    (jtrain, jtest), (ttrain, ttest) = splits
    cfg = dict(num_dim=8, batch_size=128, num_neg=3, num_tries=32)
    jsol = JSolver(jmf.WARP(jmf.MFConfig(**cfg, use_pallas=False)),
                   max_iteration=8, eval_iterations=8, seed=3, verbose=False)
    jsol.train(jtrain, jtest, ["TOPN"])
    want = jsol.history[-1]["R@10"]
    for use_pallas in (True, False):
        solver = Solver(tmf.WARP(tmf.MFConfig(**cfg, use_pallas=use_pallas),
                                 device="cpu"),
                        max_iteration=8, eval_iterations=8, seed=3,
                        verbose=False)
        solver.train(ttrain, ttest, ["TOPN"])
        got = solver.history[-1]["R@10"]
        assert got > solver.history[0]["R@10"]
        assert abs(got - want) < 0.12, (use_pallas, got, want)
        assert np.isfinite(solver.history[-1]["train_loss"])


def test_epoch_chunk_changes_nothing(splits):
    (_, _), (ttrain, _) = splits
    out = []
    for chunk in (None, 2):
        m = tmf.WARP(tmf.MFConfig(**WARP_KW, epoch_chunk=chunk), device="cpu")
        st = m.reset(ttrain, seed=1)
        m.train_one_iteration(st, 4)
        out.append(st.params["uv"])
    assert torch.equal(*out)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_resume_is_bitwise_exact(splits, tmp_path, use_pallas):
    (_, _), (ttrain, _) = splits

    def run(iters, **kw):
        solver = Solver(tmf.WARP(tmf.MFConfig(**WARP_KW,
                                              use_pallas=use_pallas),
                                 device="cpu"),
                        max_iteration=iters, seed=7, verbose=False)
        return solver.train(ttrain, None, (), **kw)

    unbroken = run(4)
    path = str(tmp_path / "half.ckpt")
    run(2, checkpoint_path=path)
    assert set(tckpt.checkpoint_manifest(path)["param_names"]) == set(
        unbroken.params)
    resumed = run(4, resume_from=path)
    assert resumed.step == 4
    for k, v in unbroken.params.items():
        assert torch.equal(resumed.params[k], v), k


def test_fingerprint_covers_the_mf_config(splits):
    (_, _), (ttrain, _) = splits

    def fp(**kw):
        m = tmf.WARP(tmf.MFConfig(**{**WARP_KW, **kw}), device="cpu")
        return tckpt.config_fingerprint(m, m.reset(ttrain))

    assert fp() == fp()
    assert fp() != fp(dtype=torch.bfloat16)
    assert fp() != fp(num_tries=8)


def test_guard_restores_then_raises(splits, tmp_path, monkeypatch):
    (_, _), (ttrain, _) = splits
    model = tmf.WARP(tmf.MFConfig(**WARP_KW), device="cpu")
    real = model.train_one_iteration
    calls = []

    def poisoned(state, seed=0):
        state = real(state, seed)
        calls.append(state.step)
        if state.step == 2:
            state.params["iv"][0, 0] = float("nan")
        return state

    monkeypatch.setattr(model, "train_one_iteration", poisoned)
    solver = Solver(model, max_iteration=3, seed=7, verbose=False,
                    guard=True, guard_max_restores=1)
    with pytest.raises(RuntimeError, match="non-finite"):
        solver.train(ttrain, None, (), checkpoint_path=str(tmp_path / "g"),
                     checkpoint_every=1)
    assert calls == [1, 2, 2]
    assert not _params_finite(solver.state.params)


def test_cli_trains_warp(movielens_path, tmp_path):
    """CLI --method WARP --device cpu; cdae_tpu's WARP of the same flags
    reads the checkpoint."""
    from cdae_tpu import cli as jcli
    from cdae_tpu.utils.checkpoint import load_checkpoint as jload

    cache = str(tmp_path / "all.bin")
    jio.save_interactions(JInteractions.from_text(movielens_path, jparser),
                          cache)
    ckpt = str(tmp_path / "warp.ckpt")
    argv = ["--task", "train", "--method", "WARP", "--device", "cpu",
            "--skip_popularity", "--cache_file", cache, "--num_dim", "8",
            "--num_neg", "3", "--loss_type", "HINGE", "--beta", "0",
            "--lambda", "0.1", "--batch_size", "64", "--max_iters", "4",
            "--eval_iters", "2", "--checkpoint", ckpt]
    row = tcli.run(argv)
    assert row["iter"] == 4.0 and np.isfinite(row["R@10"])
    args = tcli.build_arg_parser().parse_args(argv)
    model = tcli.build_model(args)
    assert isinstance(model, tmf.WARP) and model.cfg.batch_size == 64
    jtrain, _ = jio.load_interactions(cache).split_by_user(0.2, seed=SEED)
    js = jload(ckpt, jcli.build_model(args).reset(jtrain, seed=0))
    assert js.step == 4 and set(js.params) == set(model.reset(
        TInteractions.from_text(movielens_path, tparser)).params)


# ------------------------------------------------------ not ported yet ----

def test_unported_routes_raise(splits):
    """Nothing is left to raise naming a later slice: --sharded dispatches
    as cdae_tpu's (tests/test_torch_parallel.py), and refuses what cdae_tpu
    refuses with its words (ITEMCF below). The registry holds cdae_tpu's 15
    names and the port's MULTVAE: WARP's slab, pool and scan
    routes and the rest of the MF family train (their own tests:
    test_torch_warp_routes.py, test_torch_mf_zoo.py), as do B9
    (gather_mode="mxu") and B8 (the pallas scatter modes) on WARP; ALS,
    WRMF, ItemCF, UserCF, NegMF, LINEAR and FM build (test_torch_als.py,
    test_torch_similarity.py, test_torch_linear.py)."""
    from cdae_tpu.models import MODEL_REGISTRY as JREGISTRY
    from cdae_tpu_torch.models import linear as tlin

    (_, _), (ttrain, _) = splits

    def train(**kw):
        m = tmf.WARP(tmf.MFConfig(**{**WARP_KW, **kw}), device="cpu")
        m.train_one_iteration(m.reset(ttrain))

    train(dense_mode=True, warp_pool=64)
    train(warp_pool=64)
    train(dense_mode=False)
    train(gather_mode="mxu")
    train(scatter_mode="pallas")
    train(gather_mode="mxu", scatter_mode="pallas_bf16")
    for name, cls in (("NegMF", tlin.NegMF), ("LINEAR", tlin.LinearModel),
                      ("fm", tlin.FactorModel)):
        assert type(tmodels.create_model(name, device="cpu")) is cls
    assert not hasattr(tmodels, "LATER_MODELS")
    # every cdae_tpu model, and the port's own Mult-VAE as the one extra
    assert set(JREGISTRY) <= set(tmodels.MODEL_REGISTRY)
    assert set(tmodels.MODEL_REGISTRY) - set(JREGISTRY) == {"MULTVAE"}
    assert len(JREGISTRY) == 15 and len(tmodels.MODEL_REGISTRY) == 16
    for name in ("ALS", "wrmf", "ItemCF", "USERCF"):
        assert type(tmodels.create_model(name, device="cpu")).__name__ == {
            "ALS": "ALS", "WRMF": "WRMF", "ITEMCF": "ItemCF",
            "USERCF": "UserCF"}[name.upper()]
    for name, cls in (("BPR", tmf.BPR), ("pmf", tmf.PMF), ("IMF", tmf.IMF)):
        assert isinstance(tmodels.create_model(name, device="cpu"), cls)
    from cdae_tpu_torch.models.fism import FISM, FISMPair
    assert isinstance(tmodels.create_model("FISM", device="cpu"), FISM)
    assert isinstance(tmodels.create_model("fismpair", device="cpu"),
                      FISMPair)
    with pytest.raises(ValueError, match="unknown"):
        tmodels.create_model("NOPE", device="cpu")
    assert isinstance(tmodels.create_model("warp", device="cpu"), tmf.WARP)
    assert type(tcli.build_model(tcli.build_arg_parser().parse_args(
        ["--method", "NEGMF", "--device", "cpu"]))) is tlin.NegMF
    with pytest.raises(SystemExit, match="unknown --method"):
        tcli.run(["--task", "test", "--method", "NEGMFX", "--device", "cpu"])
    with pytest.raises(SystemExit,
                       match="--sharded not supported for --method ITEMCF"):
        tcli.run(["--task", "test", "--method", "ITEMCF", "--sharded",
                  "true", "--device", "cpu"])
    assert not hasattr(tcli, "_LATER")

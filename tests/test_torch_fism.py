"""cdae_tpu_torch's FISM and FISMPair against cdae_tpu's on the same inputs:
the sparse step (scatter modes "pallas", cdae_tpu's Pallas kernel B8 in
interpret mode against the port's plain B8, and "matmul") over its variant
flags, the slab step, the pair step and a whole epoch with the very draws
cdae_tpu makes injected; the x cache, scoring and predict on carried
parameters; and FISM end to end (SGDSolver, resume, the CLI, a cdae_tpu
checkpoint).

Draws: cdae_tpu's sparse and pair steps draw their negatives with
``sample_unrated(key, ...)`` and its slab step its uniforms with
``jax.random.uniform(key, (B, I))``; the tests hand the port exactly these.
Parameters are N(0, 0.3) with AdaGrad accumulators at a trained scale
(0.5-1.5). Tolerance: rtol 1e-5 and atol 1e-6 of each table's scale -- f32
sums in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cdae_tpu.models.fism as jfism
import cdae_tpu_torch.models.fism as tfism
from cdae_tpu.data.dataset import Interactions as JInteractions
from cdae_tpu.data.dataset import movielens_line_parser as jparser
from cdae_tpu.evaluation import Evaluation as JEvaluation
from cdae_tpu.models.base import iter_user_batches as j_iter_user_batches
from cdae_tpu.ops import sampling as jsampling
from cdae_tpu.solver.solver import SGDSolver as JSGDSolver
from cdae_tpu.utils import checkpoint as jckpt
from cdae_tpu_torch import cli as tcli
from cdae_tpu_torch import models as tmodels
from cdae_tpu_torch.data.dataset import Interactions as TInteractions
from cdae_tpu_torch.data.dataset import movielens_line_parser as tparser
from cdae_tpu_torch.evaluation import Evaluation as TEvaluation
from cdae_tpu_torch.solver.solver import SGDSolver, _params_finite
from cdae_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

SEED = 20141119
B = 16
LR = 0.05
FISM_KW = dict(num_dim=6, num_neg=3, batch_size=B, learn_rate=LR)


def _close(got, want, msg=""):
    want = np.asarray(want)
    atol = 1e-6 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=atol,
                               err_msg=msg)


def _close_params(tp, jp):
    assert set(tp) == set(jp)
    for k in jp:
        _close(tp[k].numpy(), jp[k], k)


@pytest.fixture(scope="module")
def splits(movielens_path):
    j = JInteractions.from_text(movielens_path, jparser)
    t = TInteractions.from_text(movielens_path, tparser)
    return j.split_by_user(0.2, seed=SEED), t.split_by_user(0.2, seed=SEED)


def _random_params(js, seed=3):
    """cdae_tpu's reset with N(0, 0.3) P, Q and biases, trained-scale
    accumulators and the x cache of that P; numpy arrays."""
    rng = np.random.default_rng(seed)
    p = {k: np.array(v) for k, v in js.params.items()}
    for k in ("P", "Q", "bu", "bi"):
        p[k] = (rng.standard_normal(p[k].shape) * 0.3).astype(np.float32)
        p[k + "_ag"] = rng.uniform(0.5, 1.5, p[k].shape).astype(np.float32)
    pb = js.padded
    rows = p["P"][np.clip(pb.items, 0, p["P"].shape[0] - 1)]
    p["x"] = np.einsum("uld,ul->ud", rows,
                       pb.mask.astype(np.float32)).astype(np.float32)
    return p


def _pair(splits, cls="FISM", **kw):
    """cdae_tpu's model + state and the port's, holding the same
    params."""
    (jtrain, _), (ttrain, _) = splits
    cfg = {**FISM_KW, **kw}
    jm = getattr(jfism, cls)(jfism.FISMConfig(**cfg))
    tm = getattr(tfism, cls)(tfism.FISMConfig(**cfg), device="cpu")
    js, ts = jm.reset(jtrain, seed=0), tm.reset(ttrain, seed=0)
    p = _random_params(js)
    js.params = {k: jnp.asarray(v) for k, v in p.items()}
    ts.params = tckpt.params_from_numpy(p, "cpu")
    return jm, js, tm, ts


def _batches(js, cfg):
    return list(j_iter_user_batches(js.padded, cfg.batch_size,
                                    bucket_by_length=cfg.bucket_by_length))


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


# ------------------------------------------------------- the sparse step ----

STEP_VARIANTS = [
    dict(scatter_mode="pallas"),
    dict(scatter_mode="matmul"),
    dict(scatter_mode="pallas", using_bias_term=False),
    dict(scatter_mode="pallas", using_factor_term=False),
    dict(scatter_mode="matmul", using_factor_term=False,
         using_bias_term=False),
    dict(scatter_mode="pallas", num_neg=0),
    dict(scatter_mode="pallas", alpha=2),
    dict(scatter_mode="pallas", loss="LOG"),
    dict(scatter_mode="pallas", using_adagrad=False),
]


@pytest.mark.parametrize("variant", STEP_VARIANTS,
                         ids=lambda v: "-".join(f"{k}={x}"
                                                for k, x in v.items()))
def test_fism_step_matches(splits, variant):
    """Every batch of one epoch in turn (the last one padded with uid 0 at
    weight 0), negatives from cdae_tpu's sampler on the step's key."""
    jm, js, tm, ts = _pair(splits, dense_mode=False, **variant)
    cfg = jm.cfg
    I = js.num_items
    key = jax.random.PRNGKey(11)
    jp = dict(js.params)
    for mb in _batches(js, cfg):
        key, sub = jax.random.split(key)
        L = mb.items.shape[1]
        neg = jsampling.sample_unrated(
            sub, jnp.asarray(mb.items), jnp.asarray(mb.lengths), I,
            max(cfg.num_neg * L, 1))
        jp = jfism._fism_step(
            jp, *map(jnp.asarray, (mb.uids, mb.items, mb.mask, mb.lengths,
                                   mb.weight)),
            jnp.asarray(LR, jnp.float32), sub, cfg=cfg, loss=jm.loss)
        uids, items, lengths = _t(mb.uids, mb.items, mb.lengths)
        got = tfism._fism_step(
            ts.params, uids.long(), items.long(), torch.from_numpy(mb.mask),
            lengths.long(), torch.from_numpy(mb.weight), LR, 0, cfg=tm.cfg,
            loss=tm.loss, neg=torch.from_numpy(np.array(neg)))
        assert got is ts.params  # in place
        _close_params(ts.params, jp)


def test_fism_step_full_rows_get_the_sentinel(splits):
    """A user who rated every item draws only the sentinel id I: those
    slots contribute nothing (never a clipped live row)."""
    jm, js, tm, ts = _pair(splits, dense_mode=False, scatter_mode="pallas")
    I = js.num_items
    items = np.arange(I, dtype=np.int32)[None, :].repeat(2, 0)
    lengths = np.array([I, I], np.int32)
    mask = np.ones((2, I), bool)
    neg = tfism.sample_unrated(5, torch.from_numpy(items).long(),
                               torch.from_numpy(lengths), I, 3 * I)
    assert (neg == I).all()
    args = (np.array([0, 1]), items, mask, lengths, np.ones(2, np.float32))
    key = jax.random.PRNGKey(4)
    jp = jfism._fism_step(dict(js.params), *map(jnp.asarray, args),
                          jnp.asarray(LR, jnp.float32), key, cfg=jm.cfg,
                          loss=jm.loss)
    u, it, m, ln, w = _t(*args)
    tfism._fism_step(ts.params, u.long(), it.long(), m, ln.long(), w, LR, 0,
                     cfg=tm.cfg, loss=tm.loss, neg=neg)
    _close_params(ts.params, jp)


# --------------------------------------------------------- the slab step ----

@pytest.mark.parametrize("variant", [
    dict(), dict(using_bias_term=False), dict(using_factor_term=False),
    dict(loss="LOG", alpha=2),
], ids=lambda v: "-".join(f"{k}={x}" for k, x in v.items()) or "default")
def test_fism_dense_step_matches(splits, variant):
    jm, js, tm, ts = _pair(splits, **variant)
    assert "dense_R" in js.aux and "dense_R" in ts.aux
    assert np.array_equal(ts.aux["dense_R"].numpy(),
                          np.asarray(js.aux["dense_R"]))
    uid_mat, w_mat = jm._dense_user_batches(js)
    t_uid, t_w = tm._dense_user_batches(ts)
    assert np.array_equal(t_uid.numpy(), np.asarray(uid_mat))
    assert np.array_equal(t_w.numpy(), np.asarray(w_mat))
    key = jax.random.PRNGKey(7)
    jp = dict(js.params)
    R = js.aux["dense_R"]
    for j in range(uid_mat.shape[0]):
        key, sub = jax.random.split(key)
        u01 = np.array(jax.random.uniform(sub, (uid_mat.shape[1],
                                                js.num_items)))
        jp = jfism._fism_dense_step(jp, R, uid_mat[j], w_mat[j],
                                    jnp.asarray(LR, jnp.float32), sub,
                                    cfg=jm.cfg, loss=jm.loss)
        tfism._fism_dense_step(ts.params, ts.aux["dense_R"], t_uid[j],
                               t_w[j], LR, 0, cfg=tm.cfg, loss=tm.loss,
                               u01=torch.from_numpy(u01))
        _close_params(ts.params, jp)


# ---------------------------------------------------------- the pair step ----

@pytest.mark.parametrize("variant", [
    dict(), dict(using_bias_term=False), dict(loss="SQUARE", num_neg=1),
], ids=lambda v: "-".join(f"{k}={x}" for k, x in v.items()) or "default")
def test_fism_pair_step_matches(splits, variant):
    jm, js, tm, ts = _pair(splits, cls="FISMPair", **variant)
    assert "dense_R" not in ts.aux  # FISMPair never takes the slab
    cfg = jm.cfg
    I = js.num_items
    key = jax.random.PRNGKey(3)
    jp = dict(js.params)
    for mb in _batches(js, cfg):
        key, sub = jax.random.split(key)
        L = mb.items.shape[1]
        neg = jsampling.sample_unrated(
            sub, jnp.asarray(mb.items), jnp.asarray(mb.lengths), I,
            max(cfg.num_neg, 1) * L)
        jp = jfism._fism_pair_step(
            jp, *map(jnp.asarray, (mb.uids, mb.items, mb.mask, mb.lengths,
                                   mb.weight)),
            jnp.asarray(LR, jnp.float32), sub, cfg=cfg, loss=jm.loss)
        uids, items, lengths = _t(mb.uids, mb.items, mb.lengths)
        tfism._fism_pair_step(
            ts.params, uids.long(), items.long(), torch.from_numpy(mb.mask),
            lengths.long(), torch.from_numpy(mb.weight), LR, 0, cfg=tm.cfg,
            loss=tm.loss, neg=torch.from_numpy(np.array(neg)))
        _close_params(ts.params, jp)


# --------------------------------------------------------- a whole epoch ----

@pytest.mark.parametrize("cls,dense", [("FISM", False), ("FISM", True),
                                       ("FISMPair", False)])
def test_epoch_matches_with_injected_draws(splits, cls, dense):
    """cdae_tpu's train_one_iteration (one key split per batch, then the
    exact x rebuild) against the port's epoch fed those draws."""
    jm, js, tm, ts = _pair(splits, cls=cls, dense_mode=dense,
                           scatter_mode="pallas")
    jm.set_learn_rate(LR)
    tm.set_learn_rate(LR)
    key = jax.random.PRNGKey(21)
    draws, k = [], key
    I = js.num_items
    if dense:
        uid_mat, _ = jm._dense_user_batches(js)
        for _ in range(uid_mat.shape[0]):
            k, sub = jax.random.split(k)
            draws.append(dict(u01=torch.from_numpy(np.array(
                jax.random.uniform(sub, (uid_mat.shape[1], I))))))
    else:
        nn = max(jm.cfg.num_neg, 1 if jm.pairwise else 0)
        for mb in _batches(js, jm.cfg):
            k, sub = jax.random.split(k)
            L = mb.items.shape[1]
            draws.append(dict(neg=torch.from_numpy(np.array(
                jsampling.sample_unrated(
                    sub, jnp.asarray(mb.items), jnp.asarray(mb.lengths), I,
                    max(nn * L, 1))))))
    js = jm.train_one_iteration(js, key)
    assert tm.train_one_iteration(ts, 0, draws=draws) is ts
    assert ts.step == js.step == 1
    _close_params(ts.params, js.params)


# ------------------------------------------------------ cache and scoring ----

def test_reset_x_cache_and_carried_params(splits):
    (jtrain, _), (ttrain, _) = splits
    jm, js, tm, ts = _pair(splits)
    # the port's rebuild on carried P equals cdae_tpu's
    items, mask, _ = tm._padded_rows(ts)
    _close(tfism._rebuild_x(ts.params["P"], items, mask).numpy(),
           jfism._rebuild_x(js.params["P"], jnp.asarray(js.padded.items),
                            jnp.asarray(js.padded.mask, jnp.float32)))
    # the port's own reset: x_u is the sum of the user's P rows, P and Q
    # uniform in +-0.001, accumulators at 1e-4
    fresh = tm.reset(ttrain, seed=5)
    P = fresh.params["P"].numpy()
    csr = jtrain.csr()  # the same rows as the port's
    for u in range(ttrain.num_users):
        np.testing.assert_allclose(fresh.params["x"][u].numpy(),
                                   P[csr.row(u)].sum(0), rtol=1e-5,
                                   atol=1e-7)
    for k in ("P", "Q"):
        assert np.abs(fresh.params[k].numpy()).max() <= 0.001
    assert (fresh.params["P_ag"] == 1e-4).all()
    assert set(fresh.params) == set(js.params)


def test_batch_scores_and_predict_match(splits):
    (jtrain, _), _ = splits
    jm, js, tm, ts = _pair(splits, alpha=2)
    uids = np.arange(js.num_users)
    _close(tm.batch_scores(ts, uids, None, None).numpy(),
           jm.batch_scores(js, uids, None, None))
    # every user against a rated and an unrated item
    csr = jtrain.csr()
    users, items = [], []
    for u in range(js.num_users):
        row = csr.row(u)
        if len(row) == 0:
            continue
        users += [u, u]
        items += [int(row[0]), int(np.setdiff1d(np.arange(js.num_items),
                                               row)[0])]
    got = tm.predict(ts, np.array(users), np.array(items)).numpy()
    want = jm.predict(js, jnp.asarray(users), jnp.asarray(items))
    _close(got, want)
    # rated and unrated items take different scales
    p = ts.params
    u, i = users[0], items[0]
    n = len(csr.row(u))
    x = p["x"][u]
    assert got[0] == pytest.approx(
        float(p["bu"][u] + p["bi"][i]
              + torch.dot(x - p["P"][i], p["Q"][i]) / max(n - 1, 1) ** 2),
        rel=1e-5)


# ------------------------------------------------------------ end to end ----

@pytest.mark.parametrize("dense", [True, False])
def test_fism_sgd_solver_matches_cdae_tpu_quality(splits, dense):
    """SGDSolver, 10 epochs on the fixture: R@10 rises, and lands within
    0.15 of cdae_tpu's on the same split (other random streams, so a
    metric gate: the repo's dense-vs-sparse gate)."""
    (jtrain, jtest), (ttrain, ttest) = splits
    cfg = dict(num_dim=8, num_neg=3, learn_rate=0.05, batch_size=32,
               dense_mode=dense)
    js = JSGDSolver(jfism.FISM(jfism.FISMConfig(**cfg)), max_iteration=10,
                    eval_iterations=10, learn_rate=0.05, seed=0,
                    verbose=False)
    js.train(jtrain, jtest, ["TOPN"])
    model = tfism.FISM(tfism.FISMConfig(**cfg), device="cpu")
    ts = SGDSolver(model, max_iteration=10, eval_iterations=10,
                   learn_rate=0.05, seed=0, verbose=False)
    ts.train(ttrain, ttest, ["TOPN"])
    assert ("dense_R" in ts.state.aux) == dense
    assert _params_finite(ts.state.params)
    r_t, r_j = ts.history[-1]["R@10"], js.history[-1]["R@10"]
    assert r_t > ts.history[0]["R@10"]
    assert abs(r_t - r_j) < 0.15, (r_t, r_j)


def test_fism_resume_replays_the_unbroken_run(splits, tmp_path):
    _, (ttrain, ttest) = splits
    cfg = tfism.FISMConfig(num_dim=6, num_neg=2, batch_size=8,
                           dense_mode=False, scatter_mode="pallas")
    ck = str(tmp_path / "fism.ckpt")
    full = SGDSolver(tfism.FISM(cfg, device="cpu"), max_iteration=3,
                     learn_rate=0.05, seed=SEED, verbose=False)
    full.train(ttrain)
    part = SGDSolver(tfism.FISM(cfg, device="cpu"), max_iteration=2,
                     learn_rate=0.05, seed=SEED, verbose=False)
    part.train(ttrain, checkpoint_path=ck)
    resumed = SGDSolver(tfism.FISM(cfg, device="cpu"), max_iteration=3,
                        learn_rate=0.05, seed=SEED, verbose=False)
    resumed.train(ttrain, resume_from=ck)
    for k, v in full.state.params.items():
        assert torch.equal(v, resumed.state.params[k]), k


def test_cdae_tpu_checkpoint_gives_the_same_scores(splits, tmp_path):
    (jtrain, _), (ttrain, ttest) = splits
    jm = jfism.FISM(jfism.FISMConfig(**FISM_KW))
    js = jm.train_one_iteration(jm.reset(jtrain, seed=1),
                                jax.random.PRNGKey(2))
    path = str(tmp_path / "j.ckpt")
    jckpt.save_checkpoint(path, js)
    tm = tmodels.create_model("FISM", device="cpu", **FISM_KW)
    ts = tckpt.load_checkpoint(path, tm.reset(ttrain, seed=9))
    assert ts.step == 1
    uids = np.arange(js.num_users)
    _close(tm.batch_scores(ts, uids, None, None).numpy(),
           jm.batch_scores(js, uids, None, None))
    jres = JEvaluation.create("TOPN").evaluate(jm, js, splits[0][1], jtrain)
    tres = TEvaluation.create("TOPN").evaluate(tm, ts, ttest, ttrain)
    for c in ("P@10", "R@10", "MAP@10"):
        assert tres[c] == pytest.approx(jres[c], abs=1e-6)


@pytest.mark.parametrize("method", ["FISM", "FISMPAIR"])
def test_cli_trains_and_serves(movielens_path, tmp_path, method):
    cache = str(tmp_path / "ml.bin")
    tcli.run(["--task", "prepare", "--parser", "movielens", "--input_file",
              movielens_path, "--cache_file", cache])
    common = ["--method", method, "--num_dim", "6", "--num_neg", "2",
              "--learn_rate", "0.05", "--batch_size", "64", "--device",
              "cpu", "--seed", str(SEED)]
    ck = str(tmp_path / "f.ckpt")
    solver = tcli.train(tcli.build_arg_parser().parse_args(
        ["--task", "train", "--cache_file", cache, "--max_iters", "4",
         "--eval_iters", "4", "--skip_popularity", "--checkpoint", ck]
        + common))
    model = solver.model
    assert isinstance(solver, SGDSolver) and solver.learn_rate0 == 0.05
    assert isinstance(model, tfism.FISMPair if method == "FISMPAIR"
                      else tfism.FISM)
    assert model.cfg.batch_size == 8  # an eighth of --batch_size
    assert model.cfg.scatter_mode == "auto"  # CPU: no pin
    assert ("dense_R" in solver.state.aux) == (method == "FISM")
    hist = solver.history
    assert hist[-1]["R@10"] > hist[0]["R@10"]
    tcli.run(["--task", "split", "--cache_file", cache,
              "--train_cache_file", str(tmp_path / "tr.bin"),
              "--test_cache_file", str(tmp_path / "te.bin")])
    res = tcli.run(["--task", "test", "--init_checkpoint", ck,
                    "--train_cache_file", str(tmp_path / "tr.bin"),
                    "--test_cache_file", str(tmp_path / "te.bin")] + common)
    assert res["R@10"] == pytest.approx(hist[-1]["R@10"], abs=1e-6)


def test_fism_defaults_and_routing():
    m = tmodels.create_model("fism", device="cpu")
    assert isinstance(m, tfism.FISM) and m.cfg.scatter_mode == "auto"
    pair = tmodels.create_model("FISMPAIR", device="cpu")
    assert isinstance(pair, tfism.FISMPair) and pair.loss.name == "LOG"
    assert len(dataclasses.fields(tfism.FISMConfig)) == len(
        dataclasses.fields(jfism.FISMConfig)) == 17
    assert [f.name for f in dataclasses.fields(tfism.FISMConfig)] == [
        f.name for f in dataclasses.fields(jfism.FISMConfig)]

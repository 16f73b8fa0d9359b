"""cdae_tpu_torch's PMF, IMF and BPR against cdae_tpu's on the same inputs:
each step (the sparse steps and the user slabs) and a whole epoch with the
very draws cdae_tpu makes injected, then end to end (Solver and the CLI).

Draws: cdae_tpu's sparse steps draw their negatives by
sampling.sample_unrated(key, ...) and the tests hand the port those ids;
the IMF slab draws jax.random.uniform(key, (B, I)); the BPR slab splits
its key into (k_draw, k_rescue) for its M catalog draws and its rescue
rank. Parameters are N(0, 0.3) with AdaGrad accumulators at a trained
scale (0.5-1.5), as in tests/test_torch_mf.py, and the tolerance is its
1e-5 of each table's scale (f32 sums in another order).
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
from cdae_tpu.evaluation import Evaluation as JEvaluation
from cdae_tpu.ops import sampling as jsampling
from cdae_tpu.solver.solver import Solver as JSolver
from cdae_tpu_torch import cli as tcli
from cdae_tpu_torch import models as tmodels
from cdae_tpu_torch.data.dataset import Interactions as TInteractions
from cdae_tpu_torch.data.dataset import movielens_line_parser as tparser
from cdae_tpu_torch.evaluation import Evaluation as TEvaluation
from cdae_tpu_torch.solver.solver import Solver, _params_finite
from cdae_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

SEED = 20141119
B, NN = 32, 3
LOSS = {"PMF": "SQUARE", "IMF": "SQUARE", "BPR": "LOG"}


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


def _random_params(js, seed=3):
    """N(0, 0.3) factors and biases, accumulators in [0.5, 1.5); numpy."""
    rng = np.random.default_rng(seed)
    p = {k: np.array(v) for k, v in js.params.items()}
    for k in ("uv", "iv", "ub", "ib"):
        p[k] = (rng.standard_normal(p[k].shape) * 0.3).astype(np.float32)
        p[k + "_ag"] = rng.uniform(0.5, 1.5, p[k].shape).astype(np.float32)
    return p


def _pair(name, splits, **kw):
    """cdae_tpu's model + state and the port's, holding the same params."""
    (jtrain, _), (ttrain, _) = splits
    cfg = dict(num_dim=8, batch_size=B, num_neg=NN, learn_rate=0.05,
               loss=LOSS[name])
    cfg.update(kw)
    jm = getattr(jmf, name)(jmf.MFConfig(**cfg))
    tm = getattr(tmf, name)(tmf.MFConfig(**cfg), device="cpu")
    js, ts = jm.reset(jtrain, seed=0), tm.reset(ttrain, seed=0)
    p = _random_params(js)
    js.params = {k: jnp.asarray(v) for k, v in p.items()}
    ts.params = tckpt.params_from_numpy(p, "cpu")
    return jm, js, tm, ts


def _batch(js, seed=5):
    """A step's instances (B of them, the last 3 padding) and the users'
    padded rated rows."""
    rng = np.random.default_rng(seed)
    users, items, ratings = js.aux["coo"]
    sel = rng.integers(0, len(users), B)
    w = np.ones(B, np.float32)
    w[-3:] = 0.0
    u = users[sel]
    return (u, items[sel], ratings[sel], w, js.padded.items[u],
            js.padded.lengths[u])


def _t(*arrays):
    out = []
    for a in arrays:
        t = torch.from_numpy(np.array(a))
        out.append(t.long() if t.dtype == torch.int64 else t)
    return out


def _slab(js, Bs=B):
    """cdae_tpu's slab users (uid 0 repeated at weight 0 past U)."""
    U = js.num_users
    uids = (np.arange(Bs) % U).astype(np.int32)
    w = (np.arange(Bs) < U).astype(np.float32)
    return uids, w


# ------------------------------------------------------------ the steps ----

@pytest.mark.parametrize("scatter_mode", ["auto", "scatter", "pallas"])
@pytest.mark.parametrize("row_update", [False, True])
@pytest.mark.parametrize("name", ["IMF", "PMF", "BPR"])
def test_sparse_step_matches(splits, name, row_update, scatter_mode):
    """One sparse step of each model with cdae_tpu's negatives injected,
    both update branches and three aggregation modes (index_add, and B8's
    plain version for "pallas")."""
    jm, js, tm, ts = _pair(name, splits, dense_mode=False,
                           row_update=row_update, scatter_mode=scatter_mode)
    u, i, r, w, rated, lengths = _batch(js)
    key = jax.random.PRNGKey(9)
    want = type(jm)._step(js.params, *map(jnp.asarray, (u, i, r, w, rated,
                                                        lengths)),
                          key, cfg=jm.cfg, loss=jm.loss)
    draws = {}
    if name != "PMF":
        nn = max(NN, 1)
        draws["neg"] = torch.from_numpy(np.array(jsampling.sample_unrated(
            key, jnp.asarray(rated), jnp.asarray(lengths), js.num_items, nn))
        ).long()
    tu, ti, tr, tw, trated, tlen = _t(u, i, r, w, rated, lengths)
    got = type(tm)._step(ts.params, tu, ti, tr, tw, trated, tlen, (0, 0, 0),
                         cfg=tm.cfg, loss=tm.loss, **draws)
    assert got is ts.params  # in place
    _all_close(got, want)


def test_imf_step_without_negatives_and_sentinel(splits):
    """num_neg 0 trains the positives alone; a row whose user rated every
    item gets the sentinel id I for its negatives, weighted 0."""
    jm, js, tm, ts = _pair("IMF", splits, dense_mode=False, num_neg=0)
    u, i, r, w, rated, lengths = _batch(js)
    want = jmf.IMF._step(js.params, *map(jnp.asarray, (u, i, r, w, rated,
                                                       lengths)),
                         jax.random.PRNGKey(1), cfg=jm.cfg, loss=jm.loss)
    got = tmf.IMF._step(ts.params, *_t(u, i, r, w, rated, lengths),
                        (0, 0, 0), cfg=tm.cfg, loss=tm.loss)
    _all_close(got, want)
    jm, js, tm, ts = _pair("IMF", splits, dense_mode=False)
    I = js.num_items
    neg = np.full((B, NN), I, np.int64)  # every draw a sentinel
    before = {k: v.clone() for k, v in ts.params.items()}
    tmf.IMF._step(ts.params, *_t(u, i, r, np.zeros(B, np.float32), rated,
                                 lengths), (0, 0, 0), cfg=tm.cfg,
                  loss=tm.loss, neg=torch.from_numpy(neg))
    for k in ("iv", "uv", "ib", "ub"):
        assert torch.equal(ts.params[k], before[k]), k


def _imf_uniforms(key, js, Bs):
    return torch.from_numpy(np.array(jax.random.uniform(
        key, (Bs, js.num_items))))


@pytest.mark.parametrize("scatter_mode", ["auto", "pallas"])
@pytest.mark.parametrize("name", ["IMF", "PMF"])
def test_pointwise_slab_step_matches(splits, name, scatter_mode):
    """One slab of 32 users (the fixture's 25, then 7 padding rows of uid
    0 at weight 0): IMF with cdae_tpu's uniforms injected, PMF on the
    rating matrix (first occurrence of a pair wins)."""
    jm, js, tm, ts = _pair(name, splits, scatter_mode=scatter_mode)
    assert "dense_R" in js.aux and "dense_R" in ts.aux
    assert np.array_equal(ts.aux["dense_R"].numpy(),
                          np.asarray(js.aux["dense_R"]))
    if name == "PMF":
        np.testing.assert_array_equal(ts.aux["dense_ratings"].numpy(),
                                      np.asarray(js.aux["dense_ratings"]))
    uids, w = _slab(js)
    key = jax.random.PRNGKey(4)
    jR = js.aux["dense_R"]
    want = type(jm)._dense_step(js.params, jR, js.aux.get("dense_ratings", jR),
                                jnp.asarray(uids), jnp.asarray(w), key,
                                cfg=jm.cfg, loss=jm.loss)
    draws = {"u01": _imf_uniforms(key, js, B)} if name == "IMF" else {}
    tR = ts.aux["dense_R"]
    got = type(tm)._dense_step(ts.params, tR, ts.aux.get("dense_ratings", tR),
                               *_t(uids, w), (0, 0), cfg=tm.cfg, loss=tm.loss,
                               **draws)
    _all_close(got, want)


def _bpr_slab_draws(js, key, uids, M):
    """cdae_tpu's BPR slab draws from ``key``: (j, u_rank, need)."""
    I = js.num_items
    k_draw, k_rescue = jax.random.split(key)
    j = np.array(jax.random.randint(k_draw, (len(uids), M), 0, I))
    rows01 = np.asarray(js.aux["dense_R"])[uids].astype(np.float32)
    free = np.maximum(I - (rows01 > 0).sum(1), 1).astype(np.int32)
    u_rank = np.array(jax.random.randint(k_rescue, (len(uids), 1), 0,
                                         jnp.asarray(free)[:, None],
                                         dtype=jnp.int32))
    live = 1.0 - np.take_along_axis(rows01, j, axis=1)
    return j, u_rank, live.sum(1) <= 0


@pytest.mark.parametrize("rescue", [False, True])
@pytest.mark.parametrize("row_update", [False, True])
def test_bpr_slab_step_matches(splits, rescue, row_update):
    """One BPR slab with cdae_tpu's draws injected: with 32 shared draws no
    row draws only rated items; with one draw some rows do, and their
    exact rescue draw replaces slot 0 (row_update does not touch the slab:
    it keeps its matmuls)."""
    M = 1 if rescue else 32
    jm, js, tm, ts = _pair("BPR", splits, dense_mode=True,
                           num_shared_neg=M, row_update=row_update)
    uids, w = _slab(js)
    key = jax.random.PRNGKey(2 if rescue else 3)
    j, u_rank, need = _bpr_slab_draws(js, key, uids, M)
    assert need[w > 0].any() == rescue
    jR = js.aux["dense_R"]
    want = jmf.BPR._dense_step(js.params, jR, jR, jnp.asarray(uids),
                               jnp.asarray(w), key, cfg=jm.cfg, loss=jm.loss)
    tR = ts.aux["dense_R"]
    got = tmf.BPR._dense_step(ts.params, tR, tR, *_t(uids, w), (0, 0),
                              cfg=tm.cfg, loss=tm.loss,
                              j=torch.from_numpy(j).long(),
                              u_rank=torch.from_numpy(u_rank))
    _all_close(got, want)


def test_bpr_slab_chunks_change_no_number(splits, monkeypatch):
    """The (B, I, M) cube in user chunks of one user against one chunk."""
    out = []
    for cube in (tmf._CUBE_ELEMS, 1):
        monkeypatch.setattr(tmf, "_CUBE_ELEMS", cube)
        _, js, tm, ts = _pair("BPR", splits, dense_mode=True,
                              num_shared_neg=8)
        assert len(tmf._user_chunks(B, js.num_items * 8)) == (
            1 if cube > 1 else B)
        tm.train_one_iteration(ts, 3)
        out.append(ts.params)
    for k in out[0]:
        _close(out[1][k], out[0][k].numpy(), k)


# ----------------------------------------------------------- the epochs ----

def _epoch_draws(name, js, key, nb):
    """What cdae_tpu's fused instance epoch draws: its permutation and
    each step's negatives."""
    n = len(js.aux["coo"][0])
    kperm, kstep = jax.random.split(key)
    perm = np.array(jax.random.permutation(kperm, n))
    if name == "PMF":
        return perm, None
    subs = jax.random.split(kstep, nb)
    sel = np.concatenate([perm, np.zeros(nb * B - n, perm.dtype)])
    users = js.aux["coo"][0]
    pb = js.padded
    draws = []
    for b in range(nb):
        u = users[sel[b * B:(b + 1) * B]]
        draws.append({"neg": torch.from_numpy(np.array(
            jsampling.sample_unrated(subs[b], jnp.asarray(pb.items[u]),
                                     jnp.asarray(pb.lengths[u]),
                                     js.num_items, NN))).long()})
    return perm, draws


@pytest.mark.parametrize("row_update", [False, True])
@pytest.mark.parametrize("name", ["IMF", "PMF", "BPR"])
def test_sparse_epoch_matches_with_injected_draws(splits, name, row_update):
    jm, js, tm, ts = _pair(name, splits, dense_mode=False,
                           row_update=row_update)
    key = jax.random.PRNGKey(5)
    js = jm.train_one_iteration(js, key)
    nb = -(-len(js.aux["coo"][0]) // B)
    perm, draws = _epoch_draws(name, js, key, nb)
    assert tm.train_one_iteration(ts, 0, perm=perm, draws=draws) is ts
    assert ts.step == js.step == 1 and "dense_R" not in ts.aux
    _all_close(ts.params, js.params)


@pytest.mark.parametrize("name", ["IMF", "PMF", "BPR"])
def test_slab_epoch_matches_with_injected_draws(splits, name):
    """cdae_tpu's fused slab epoch (one key per slab) against the port's
    slab epoch fed those keys' draws; 16 users a slab, so two slabs, the
    second padded."""
    kw = dict(batch_size=16)
    if name == "BPR":
        kw.update(dense_mode=True, num_shared_neg=4)
    jm, js, tm, ts = _pair(name, splits, **kw)
    key = jax.random.PRNGKey(6)
    js = jm.train_one_iteration(js, key)
    uid_mat, w_mat = (np.asarray(x) for x in jm._dense_user_batches(js))
    subs = jax.random.split(key, uid_mat.shape[0])
    draws = []
    for j in range(uid_mat.shape[0]):
        if name == "IMF":
            draws.append({"u01": _imf_uniforms(subs[j], js, 16)})
        elif name == "BPR":
            jd, u_rank, _ = _bpr_slab_draws(js, subs[j], uid_mat[j], 4)
            draws.append({"j": torch.from_numpy(jd).long(),
                          "u_rank": torch.from_numpy(u_rank)})
        else:
            draws.append({})
    tm.train_one_iteration(ts, 0, draws=draws)
    assert np.array_equal(tm._dense_user_batches(ts)[0].numpy(), uid_mat)
    assert ts.step == js.step == 1
    _all_close(ts.params, js.params)


def test_steps_draw_from_their_step_seeds(splits):
    """Without injected draws each route draws from its step seeds: the
    same seed gives the same bits, another seed another update; fast_rng
    (B1's hash stream) too."""
    routes = (("IMF", dict(dense_mode=False)), ("IMF", {}),
              ("BPR", {}), ("BPR", dict(dense_mode=True, num_shared_neg=2)))
    for fast_rng in (False, True):
        for name, kw in routes:
            out = []
            for seed in (5, 5, 6):
                _, _, tm, ts = _pair(name, splits, fast_rng=fast_rng, **kw)
                tm.train_one_iteration(ts, seed)
                out.append(ts.params["iv"])
            assert torch.equal(out[0], out[1]), (name, kw)
            assert not torch.equal(out[0], out[2]), (name, kw)


# ----------------------------------------------------------- end to end ----

_E2E = {
    "IMF": ({"dense_mode": False}, "R@10", "TOPN"),
    "IMF_SLAB": ({}, "R@10", "TOPN"),
    "PMF": ({"dense_mode": False}, "RMSE", "RMSE"),
    "PMF_SLAB": ({"learn_rate": 0.2}, "RMSE", "RMSE"),
    "BPR": ({}, "R@10", "TOPN"),
    "BPR_SLAB": ({"dense_mode": True, "learn_rate": 0.2}, "R@10", "TOPN"),
}


@pytest.fixture(scope="module")
def lowrank():
    """Low-rank data of 300 users x 300 items (both packages' generators,
    the same interactions; rated for PMF), split 0.2: the fixture's 38
    items saturate R@10 near 0.84 and its 25 users move it in steps of
    0.02-0.04."""
    from cdae_tpu.data import synthetic as jsyn
    from cdae_tpu_torch.data import synthetic as tsyn

    return {rated: tuple(
        getattr(mod, "lowrank_rated" if rated else "lowrank_interactions")(
            300, 300, 20, seed=3).split_by_user(0.2, seed=1)
        for mod in (jsyn, tsyn)) for rated in (False, True)}


@pytest.mark.parametrize("cell", list(_E2E))
def test_solver_lands_near_cdae_tpu(lowrank, cell):
    """Solver, 10 epochs from three seeds: R@10 rises (RMSE falls, PMF) on
    every run, and the port's 3-seed mean lands within 0.03 of cdae_tpu's
    (the parity protocol's mean: the same sampling distributions from
    other random streams). The slabs at 2x lr (scripts/parity_zoo.py)."""
    kw, col, ev = _E2E[cell]
    name = cell.split("_")[0]
    (jtrain, jtest), (ttrain, ttest) = lowrank[name == "PMF"]
    cfg = dict(num_dim=8, batch_size=B, num_neg=NN, loss=LOSS[name],
               **{"learn_rate": 0.1, **kw})
    jm = getattr(jmf, name)(jmf.MFConfig(**cfg))
    tm = getattr(tmf, name)(tmf.MFConfig(**cfg), device="cpu")
    got, want = [], []
    for seed in (3, 4, 5):
        jsol = JSolver(jm, max_iteration=10, eval_iterations=10, seed=seed,
                       verbose=False)
        jsol.train(jtrain, jtest, [ev])
        tsol = Solver(tm, max_iteration=10, eval_iterations=10, seed=seed,
                      verbose=False)
        tsol.train(ttrain, ttest, [ev])
        assert ("dense_R" in tsol.state.aux) == ("dense_R" in jsol.state.aux)
        assert _params_finite(tsol.state.params)
        last, first = tsol.history[-1][col], tsol.history[0][col]
        assert (last < first) if col == "RMSE" else (last > first)
        got.append(last)
        want.append(jsol.history[-1][col])
    assert abs(np.mean(got) - np.mean(want)) < 0.03, (cell, got, want)


def test_registry_and_defaults():
    for name, cls in (("pmf", tmf.PMF), ("IMF", tmf.IMF), ("bpr", tmf.BPR)):
        assert isinstance(tmodels.create_model(name, device="cpu"), cls)
    assert tmf.BPR(device="cpu").cfg.loss == "LOG"
    assert tmf.IMF(device="cpu").cfg.loss == "SQUARE"
    assert tmf.BPR.dense_auto is False and tmf.IMF.dense_auto is True
    assert tmf.PMF.uses_ratings and not tmf.IMF.uses_ratings


@pytest.mark.parametrize("method,extra", [
    ("MF", ["--fast_rng", "true"]),
    ("IMF", ["--dense_mode", "false"]),
    ("PMF", ["--eval", "RMSE,MAE"]),
    ("PMF", ["--eval", "RMSE,MAE,TOPN", "--dense_mode", "false"]),
    ("BPR", ["--loss_type", "LOG"]),
    ("BPR", ["--dense_mode", "true", "--num_shared_neg", "4"]),
])
def test_cli_trains(movielens_path, tmp_path, method, extra):
    """--method MF (IMF), IMF, PMF and BPR through the CLI on the CPU, with
    --eval RMSE,MAE; cdae_tpu's model of the same flags reads the
    checkpoint."""
    from cdae_tpu import cli as jcli
    from cdae_tpu.utils.checkpoint import load_checkpoint as jload

    cache = str(tmp_path / "all.bin")
    jio.save_interactions(JInteractions.from_text(movielens_path, jparser),
                          cache)
    ckpt = str(tmp_path / "mf.ckpt")
    argv = ["--task", "train", "--method", method, "--device", "cpu",
            "--skip_popularity", "--cache_file", cache, "--num_dim", "8",
            "--num_neg", "3", "--batch_size", "32", "--max_iters", "3",
            "--eval_iters", "3", "--checkpoint", ckpt] + extra
    row = tcli.run(argv)
    assert row["iter"] == 3.0
    args = tcli.build_arg_parser().parse_args(argv)
    model = tcli.build_model(args)
    assert type(model).__name__ == ("IMF" if method == "MF" else method)
    for col in args.eval.split(","):
        key = "R@10" if col == "TOPN" else col
        assert np.isfinite(row[key]), col
    jtrain, _ = jio.load_interactions(cache).split_by_user(0.2, seed=SEED)
    js = jload(ckpt, jcli.build_model(args).reset(jtrain, seed=0))
    assert js.step == 3


def test_scores_and_predict_on_carried_params(splits):
    jm, js, tm, ts = _pair("PMF", splits)
    uids = np.arange(0, js.num_users, 2)
    _close(tm.batch_scores(ts, uids, None, None),
           jm.batch_scores(js, uids, None, None))
    (_, jtest), (_, ttest) = splits
    for kind in ("RMSE", "MAE"):
        want = JEvaluation.create(kind).evaluate(jm, js, jtest)
        got = TEvaluation.create(kind).evaluate(tm, ts, ttest)
        assert got[kind] == pytest.approx(want[kind], rel=1e-5)
    assert tm.data_loss(ts) == pytest.approx(jm.data_loss(js), rel=1e-5)

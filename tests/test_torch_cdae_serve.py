"""cdae_tpu_torch serving vs cdae_tpu from the same cdae_tpu checkpoint.

cdae_tpu trains CDAE for 3 iterations on the MovieLens fixture and saves a
checkpoint; the port loads it with its own ``load_checkpoint`` and must
score, rank and evaluate like cdae_tpu: scores to 1e-5, top-10 ids
exactly in every batch_topk mode, TOPN/RANKING columns to 1e-6 (the port
sums the metric rows in float64, cdae_tpu in float32). Every serving
variant flag is covered. On the CPU the port's kernel wrappers run their
plain versions; cdae_tpu's Pallas kernels run in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cdae_tpu.models.cdae as jcdae
import cdae_tpu_torch.models.cdae as tcdae
from cdae_tpu.data import io as jio
from cdae_tpu.data.dataset import Interactions as JInteractions
from cdae_tpu.data.dataset import movielens_line_parser
from cdae_tpu.evaluation import Evaluation as JEvaluation
from cdae_tpu.ops.topk import topk_unrated as jtopk_unrated
from cdae_tpu.utils.checkpoint import save_checkpoint as jsave
from cdae_tpu_torch import cli as tcli
from cdae_tpu_torch.data import io as tio
from cdae_tpu_torch.evaluation import RecListEvaluation as TRecList
from cdae_tpu_torch.utils.checkpoint import load_checkpoint as tload

torch.set_num_threads(2)

SEED = 20141119
BASE = dict(num_dim=8, loss="SQUARE", corruption_ratio=0.5, batch_size=32,
            learn_rate=0.5)
VARIANTS = {
    "default": {},
    "asymmetric": dict(asymmetric=True),
    "tanh": dict(tanh=True),
    "linear": dict(linear=True),
    "no_user_factor": dict(user_factor=False),
    "linear_function": dict(linear_function=True),
    "cratio_1": dict(corruption_ratio=1.0),
}


@pytest.fixture(scope="module")
def splits(movielens_path, tmp_path_factory):
    """cdae_tpu's split, written as caches and read back by the port."""
    data = JInteractions.from_text(movielens_path, movielens_line_parser)
    jtrain, jtest = data.split_by_user(0.2, seed=SEED)
    d = tmp_path_factory.mktemp("caches")
    paths = (str(d / "train.bin"), str(d / "test.bin"))
    jio.save_interactions(jtrain, paths[0])
    jio.save_interactions(jtest, paths[1])
    ttrain, ttest = (tio.load_interactions(p) for p in paths)
    return jtrain, jtest, ttrain, ttest, paths


@pytest.fixture(scope="module")
def trained(splits, tmp_path_factory):
    """One cdae_tpu checkpoint per variant, after 3 training iterations."""
    jtrain = splits[0]
    d = tmp_path_factory.mktemp("ckpt")
    out = {}
    for name, kw in VARIANTS.items():
        cfg = jcdae.CDAEConfig(**{**BASE, **kw}, use_pallas=False)
        model = jcdae.CDAE(cfg)
        state = model.reset(jtrain, seed=0)
        for it in range(3):
            state = model.train_one_iteration(state, jax.random.PRNGKey(it))
        path = str(d / f"{name}.ckpt")
        jsave(path, state)
        out[name] = path
    return out


def _pair(splits, ckpt, kw, **extra):
    """(jax model, jax state, port model, port state) from one checkpoint."""
    from cdae_tpu.utils.checkpoint import load_checkpoint as jload

    jtrain, _, ttrain, _, _ = splits
    jm = jcdae.CDAE(jcdae.CDAEConfig(**{**BASE, **kw, **extra}))
    js = jload(ckpt, jm.reset(jtrain, seed=0))
    tm = tcdae.CDAE(tcdae.CDAEConfig(**{**BASE, **kw, **extra}),
                    device="cpu")
    ts = tload(ckpt, tm.reset(ttrain, seed=0))
    return jm, js, tm, ts


def _rows(state, n=16):
    uids = np.arange(n)
    return uids, state.padded.items[uids], state.padded.mask[uids]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dense", [True, False])
def test_batch_scores_match(splits, trained, variant, dense):
    kw = VARIANTS[variant]
    for use_pallas in (False, True):
        jm, js, tm, ts = _pair(splits, trained[variant], kw,
                               dense_mode=dense, use_pallas=use_pallas)
        assert ("dense_R" in js.aux) == ("dense_R" in ts.aux) == dense
        uids, ri, rm = _rows(ts)
        want = np.asarray(jm.batch_scores(js, uids, ri, rm))
        got = tm.batch_scores(ts, uids, ri, rm).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mode", ["streaming", "fused_dense", "fused_csr"])
def test_batch_topk_modes_match(splits, trained, variant, mode, monkeypatch):
    monkeypatch.setattr(jcdae, "_TOPK_DEFER_CELLS", 0)
    monkeypatch.setattr(tcdae, "_TOPK_DEFER_CELLS", 0)
    extra = {
        "streaming": dict(use_pallas=False, dense_mode=False),
        "fused_dense": dict(use_pallas=True, dense_mode=True),
        "fused_csr": dict(use_pallas=True, dense_mode=False),
    }[mode]
    jm, js, tm, ts = _pair(splits, trained[variant], VARIANTS[variant],
                           **extra)
    pb = js.padded
    uids = np.arange(pb.num_users)
    ri, rm = pb.items[uids], pb.mask[uids]
    want = np.asarray(jm.batch_topk(js, uids, jnp.asarray(ri),
                                    jnp.asarray(rm), 10))
    got = tm.batch_topk(ts, uids, torch.from_numpy(ri),
                        torch.from_numpy(rm), 10).numpy()
    np.testing.assert_array_equal(got, want)
    # and the ids are the masked top-10 of the port's own full scores
    scores = jm.batch_scores(js, uids, ri, rm)
    ids_ref, _ = jtopk_unrated(scores, jnp.asarray(ri), 10)
    np.testing.assert_array_equal(got, np.asarray(ids_ref))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("kind", ["TOPN", "RANKING"])
def test_evaluation_matches(splits, trained, variant, kind):
    jtrain, jtest, ttrain, ttest, _ = splits
    jm, js, tm, ts = _pair(splits, trained[variant], VARIANTS[variant])
    want = JEvaluation.create(kind).evaluate(jm, js, jtest, jtrain)
    got = TRecList(kind).evaluate(tm, ts, ttest, ttrain)
    assert set(got) == set(want)
    for col in want:
        if col != "TestTime":
            assert got[col] == pytest.approx(want[col], abs=1e-6), col


def test_evaluation_topk_path_matches(splits, trained, monkeypatch):
    """The evaluator's batch_topk route (huge-catalog modes) gives the
    same columns as cdae_tpu's."""
    monkeypatch.setattr(jcdae, "_TOPK_DEFER_CELLS", 0)
    monkeypatch.setattr(tcdae, "_TOPK_DEFER_CELLS", 0)
    jtrain, jtest, ttrain, ttest, _ = splits
    jm, js, tm, ts = _pair(splits, trained["default"], {},
                           use_pallas=True, dense_mode=False)
    want = JEvaluation.create("TOPN").evaluate(jm, js, jtest, jtrain)
    got = TRecList("TOPN").evaluate(tm, ts, ttest, ttrain)
    for col in want:
        if col != "TestTime":
            assert got[col] == pytest.approx(want[col], abs=1e-6), col


def test_cli_test_task_matches(splits, trained):
    """`--task test --device cpu` from cdae_tpu's caches and checkpoint
    reports cdae_tpu's TOPN and RANKING columns."""
    jtrain, jtest, _, _, (train_path, test_path) = splits
    res = tcli.run([
        "--task", "test", "--method", "CDAE", "--device", "cpu",
        "--num_dim", "8", "--cratio", "0.5", "--scaled", "true",
        "--loss_type", "SQUARE", "--batch_size", "32",
        "--eval", "TOPN,RANKING",
        "--init_checkpoint", trained["default"],
        "--train_cache_file", train_path, "--test_cache_file", test_path,
    ])
    jm, js, _, _ = _pair(splits, trained["default"], {})
    want = {}
    for kind in ("TOPN", "RANKING"):
        want.update(JEvaluation.create(kind).evaluate(jm, js, jtest, jtrain))
    for col, v in want.items():
        if col != "TestTime":
            assert res[col] == pytest.approx(v, abs=1e-6), col


def test_predict_and_user_representations_match(splits, trained):
    jm, js, tm, ts = _pair(splits, trained["asymmetric"],
                           VARIANTS["asymmetric"])
    users = np.array([0, 3, 7, 7], np.int32)
    items = np.array([1, 5, 0, 30], np.int32)
    np.testing.assert_allclose(tm.predict(ts, users, items).numpy(),
                               np.asarray(jm.predict(js, users, items)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.user_representations(ts),
                               jm.user_representations(js),
                               rtol=1e-5, atol=1e-5)


def test_training_raises_not_implemented(splits):
    """Training without dense_R (the huge-catalog sparse step, once a later
    slice that raised here) now runs: one epoch advances the step and keeps
    the serving path's scores finite."""
    tm = tcdae.CDAE(tcdae.CDAEConfig(**BASE, dense_mode=False), device="cpu")
    ts = tm.reset(splits[2], seed=0)
    tm.train_one_iteration(ts)
    assert ts.step == 1 and "dense_R" not in ts.aux
    uids = np.arange(4)
    rated, mask = tm._user_rows(ts, uids)
    assert torch.isfinite(tm.batch_scores(ts, uids, rated, mask)).all()

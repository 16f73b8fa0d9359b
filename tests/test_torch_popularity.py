"""cdae_tpu_torch's Popularity baseline and ``is_rated`` against cdae_tpu's,
exactly, and ``--task train`` training Popularity before the method (as
cdae_tpu's CLI does) -- through the sparse CDAE step when the dense-mode
auto rule says no."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cdae_tpu_torch.models.base as tbase
from cdae_tpu.data.dataset import Interactions as JInteractions
from cdae_tpu.evaluation import Evaluation as JEvaluation
from cdae_tpu.models.popularity import Popularity as JPopularity
from cdae_tpu.ops import sampling as jsampling
from cdae_tpu_torch import cli
from cdae_tpu_torch.data.dataset import Interactions as TInteractions
from cdae_tpu_torch.data.dataset import rows_from_csr
from cdae_tpu_torch.evaluation import Evaluation as TEvaluation
from cdae_tpu_torch.models import Popularity, create_model
from cdae_tpu_torch.ops import sampling as tsampling

U, I = 50, 40


def _data(seed=0, density=0.2):
    rng = np.random.default_rng(seed)
    R = rng.random((U, I)) < density * rng.random(I)[None, :] * 2
    R[3] = True  # a user who rated everything
    users, items = np.nonzero(R)
    return users.astype(np.int32), items.astype(np.int32)


def _rows(users, items, uids):
    csr = TInteractions.from_arrays(users, items, num_users=U,
                                    num_items=I).csr()
    rated, _, mask, _ = rows_from_csr(csr, uids, I)
    return rated, mask


@pytest.mark.parametrize("per_row", [False, True])
def test_is_rated_matches_cdae_tpu(per_row):
    users, items = _data()
    uids = np.arange(U, dtype=np.int32)
    rated, mask = _rows(users, items, uids)
    lengths = mask.sum(1).astype(np.int32)
    rng = np.random.default_rng(1)
    q = (rng.integers(0, I, (U, 70)) if per_row
         else rng.integers(0, I, 70)).astype(np.int32)
    want = np.asarray(jsampling.is_rated(jnp.asarray(rated),
                                         jnp.asarray(lengths),
                                         jnp.asarray(q)))
    got = tsampling.is_rated(torch.as_tensor(rated), torch.as_tensor(lengths),
                             torch.as_tensor(q))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def _pair(users, items):
    jm, tm = JPopularity(), Popularity(device="cpu")
    js = jm.reset(JInteractions.from_arrays(users, items, num_users=U,
                                            num_items=I))
    ts = tm.reset(TInteractions.from_arrays(users, items, num_users=U,
                                            num_items=I))
    return jm, js, tm, ts


@pytest.mark.parametrize("k", [1, 10, 45])
def test_popularity_scores_and_topk_match_cdae_tpu(k):
    users, items = _data()
    jm, js, tm, ts = _pair(users, items)
    uids = np.arange(U, dtype=np.int32)
    rated, mask = _rows(users, items, uids)
    np.testing.assert_array_equal(
        tm.batch_scores(ts, uids, rated, mask).numpy(),
        np.asarray(jm.batch_scores(js, uids, rated, mask)))
    # k = 45 > I: every row exhausts the candidates (the full masked top-k)
    want = np.asarray(jm.batch_topk(js, uids, jnp.asarray(rated),
                                    jnp.asarray(mask), k))
    got = tm.batch_topk(ts, uids, rated, mask, k)
    np.testing.assert_array_equal(got.numpy(), want)
    pairs = np.array([0, 5, 39, 12])
    np.testing.assert_array_equal(
        tm.predict(ts, pairs, pairs).numpy(),
        np.asarray(jm.predict(js, pairs, pairs)))


def test_popularity_topn_matches_cdae_tpu():
    users, items = _data(seed=2)
    jm, js, tm, ts = _pair(users, items)
    data_j = JInteractions.from_arrays(users, items, num_users=U, num_items=I)
    data_t = TInteractions.from_arrays(users, items, num_users=U, num_items=I)
    tr_j, te_j = data_j.split_by_user(0.3, seed=4)
    tr_t, te_t = data_t.split_by_user(0.3, seed=4)
    js, ts = jm.reset(tr_j), tm.reset(tr_t)
    want = JEvaluation.create("TOPN").evaluate(jm, js, te_j, tr_j)
    got = TEvaluation.create("TOPN").evaluate(tm, ts, te_t, tr_t)
    for c in want:
        if c != "TestTime":
            assert got[c] == pytest.approx(want[c], abs=1e-6), c
    assert isinstance(create_model("POP", device="cpu"), Popularity)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture
def cache(movielens_path, tmp_path):
    path = str(tmp_path / "ml.bin")
    cli.run(["--task", "prepare", "--parser", "movielens", "--input_file",
             movielens_path, "--cache_file", path])
    return path


def _train_logged(argv):
    lines = _Lines()
    log = logging.getLogger("cdae_tpu_torch")
    log.addHandler(lines)
    try:
        solver = cli.train(cli.build_arg_parser().parse_args(argv))
    finally:
        log.removeHandler(lines)
    return solver, lines.lines


def _rows_logged(lines):
    """The eval rows of the logged tables (``iter|time|loss|metrics``)."""
    return [ln for ln in lines if "|" in ln and "R@10=" in ln]


def test_train_task_trains_popularity_first(cache, monkeypatch):
    """--task train logs Popularity's TOPN rows (iterations 0 and 1: one
    training iteration, as cdae_tpu's) before the method's table, and
    with the auto rule's thresholds lowered CDAE trains through the sparse
    step; --skip_popularity leaves Popularity out and --method NONE stops
    after it."""
    monkeypatch.setattr(tbase, "_DENSE_MAX_CELLS", 0)
    argv = ["--method", "CDAE", "--cache_file", cache, "--num_dim", "8",
            "--cratio", "0.2", "--max_iters", "2", "--eval_iters", "2",
            "--batch_size", "16", "--device", "cpu"]
    solver, lines = _train_logged(argv)
    rows = _rows_logged(lines)
    assert len(rows) == 2 + len(solver.history)  # Popularity's, then CDAE's
    pop = cli.run(["--task", "train", "--method", "NONE", "--cache_file",
                   cache, "--device", "cpu"])
    for it, row in enumerate(rows[:2]):
        assert row.startswith(f"    {it}|")
        assert f"R@10={pop['R@10']:.5f}" in row
    assert "dense_R" not in solver.state.aux  # the sparse step trained
    assert solver.state.step == 2
    assert all(np.isfinite(r["train_loss"]) for r in solver.history)
    _, lines = _train_logged(argv + ["--skip_popularity"])
    assert len(_rows_logged(lines)) == len(solver.history)
    assert cli.run(["--task", "train", "--method", "NONE",
                    "--skip_popularity", "--cache_file", cache,
                    "--device", "cpu"]) == {}


@pytest.mark.parametrize("method", ["POP", "POPULARITY", "Popularity",
                                    "popularity"])
def test_popularity_method_names(method, cache):
    """--method takes POP and POPULARITY in any case, as cdae_tpu's CLI
    does (the port once refused every name but POP), and trains it."""
    args = cli.build_arg_parser().parse_args(
        ["--method", method, "--device", "cpu", "--cache_file", cache,
         "--skip_popularity", "--max_iters", "1"])
    assert isinstance(cli.build_model(args), Popularity)
    solver = cli.train(args)
    assert isinstance(solver.model, Popularity)
    assert 0.0 < solver.history[-1]["R@10"] <= 1.0


def test_unknown_method_exits_as_cdae_tpu():
    """A method cdae_tpu does not know exits with its message, not the
    "not ported yet" one."""
    from cdae_tpu import cli as jcli

    for mod in (jcli, cli):
        argv = ["--method", "NOPE"] + (["--device", "cpu"] if mod is cli
                                       else [])
        with pytest.raises(SystemExit, match="unknown --method NOPE"):
            mod.build_model(mod.build_arg_parser().parse_args(argv))

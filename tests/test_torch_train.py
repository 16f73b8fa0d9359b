"""cdae_tpu_torch trains CDAE end to end: Solver.train, exact resume, the
finite-params guard, the CLI train task, and checkpoints both packages
read.

Training quality is gated as tests/test_cdae_fused.py:87-88 gates two
different random streams: on the MovieLens fixture, 15 iterations reach
R@10 > 0.3 and land within 0.25 of cdae_tpu's own run.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import cdae_tpu.models.cdae as jcdae
import cdae_tpu_torch.models.cdae as tcdae
from cdae_tpu.data import io as jio
from cdae_tpu.data.dataset import Interactions as JInteractions
from cdae_tpu.data.dataset import movielens_line_parser as jparser
from cdae_tpu.evaluation import Evaluation as JEvaluation
from cdae_tpu_torch import cli as tcli
from cdae_tpu_torch.data.dataset import Interactions as TInteractions
from cdae_tpu_torch.data.dataset import movielens_line_parser as tparser
from cdae_tpu_torch.solver.solver import SGDSolver, Solver, _params_finite
from cdae_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

SEED = 20141119
CFG = dict(num_dim=10, loss="SQUARE", corruption_ratio=0.5, scaled=True,
           num_neg=5, batch_size=16, dense_mode=True)


@pytest.fixture(scope="module")
def tsplit(movielens_path):
    data = TInteractions.from_text(movielens_path, tparser)
    return data.split_by_user(0.2, seed=SEED)


def _model(**kw):
    return tcdae.CDAE(tcdae.CDAEConfig(**{**CFG, **kw}), device="cpu")


@pytest.mark.parametrize("fast_rng", [False, True])
def test_solver_train_quality_near_cdae_tpu(movielens_path, tsplit,
                                            fast_rng):
    train, test = tsplit
    solver = Solver(_model(fast_rng=fast_rng), max_iteration=15,
                    eval_iterations=15, seed=1, verbose=False)
    solver.train(train, test, ["TOPN"])
    assert [r["iter"] for r in solver.history] == [0.0, 15.0]
    got = solver.history[-1]["R@10"]
    assert got > solver.history[0]["R@10"]
    assert np.isfinite(solver.history[-1]["train_loss"])

    jtrain, jtest = JInteractions.from_text(movielens_path, jparser) \
        .split_by_user(0.2, seed=SEED)
    jm = jcdae.CDAE(jcdae.CDAEConfig(**CFG, use_pallas=False))
    js = jm.reset(jtrain, seed=1)
    key = jax.random.PRNGKey(1)
    for _ in range(15):
        key, sub = jax.random.split(key)
        js = jm.train_one_iteration(js, sub)
    want = JEvaluation.create("TOPN").evaluate(jm, js, jtest, jtrain)["R@10"]
    assert got > 0.3, (got, want)
    assert abs(got - want) < 0.25, (got, want)


def test_fused_step_trains(tsplit):
    """fused_step=True (the fused step's plain version on the CPU) trains
    to the unfused path's recall: with fast_rng both draw the same hash
    masks, so only f32 summation order separates them."""
    train, test = tsplit
    res = {}
    for fused in (True, False):
        solver = Solver(_model(fast_rng=True, fused_step=fused),
                        max_iteration=10, eval_iterations=10, seed=4,
                        verbose=False)
        solver.train(train, test, ["TOPN"])
        res[fused] = solver.history[-1]["R@10"]
    assert res[True] > 0.3
    assert abs(res[True] - res[False]) <= 0.02, res


def _run(train, tmp_path, iters, resume=None, ckpt=None, every=0, **kw):
    solver = Solver(_model(**kw), max_iteration=iters, eval_iterations=1,
                    seed=7, verbose=False)
    state = solver.train(train, None, (), resume_from=resume,
                         checkpoint_path=ckpt, checkpoint_every=every)
    return solver, state


@pytest.mark.parametrize("fast_rng", [False, True])
def test_resume_is_bitwise_exact(tsplit, tmp_path, fast_rng):
    train, _ = tsplit
    _, unbroken = _run(train, tmp_path, 4, fast_rng=fast_rng)
    path = str(tmp_path / "half.ckpt")
    _, half = _run(train, tmp_path, 2, ckpt=path, fast_rng=fast_rng)
    assert tckpt.checkpoint_manifest(path)["step"] == 2
    solver, resumed = _run(train, tmp_path, 4, resume=path,
                           fast_rng=fast_rng)
    assert [r["iter"] for r in solver.history] == [2.0, 3.0, 4.0]
    assert resumed.step == unbroken.step == 4
    for k, v in unbroken.params.items():
        assert torch.equal(resumed.params[k], v), k


def test_resume_refuses_another_config(tsplit, tmp_path):
    train, _ = tsplit
    path = str(tmp_path / "a.ckpt")
    _run(train, tmp_path, 1, ckpt=path)
    with pytest.raises(ValueError, match="fingerprint"):
        _run(train, tmp_path, 2, resume=path, num_neg=3)


def test_config_fingerprint_names_dtypes(tsplit):
    train, _ = tsplit
    m = _model()
    st = m.reset(train, seed=0)
    fp = tckpt.config_fingerprint(m, st)
    assert fp == tckpt.config_fingerprint(_model(), st)
    assert fp != tckpt.config_fingerprint(
        _model(compute_dtype=torch.bfloat16), st)
    assert tckpt._by_name(torch.bfloat16) == "bfloat16"


def test_guard_restores_then_raises(tsplit, tmp_path, monkeypatch):
    """A non-finite state restores the last checkpoint once, then a second
    one raises."""
    train, _ = tsplit
    path = str(tmp_path / "g.ckpt")
    model = _model()
    real = model.train_one_iteration
    calls = []

    def poisoned(state, seed=0):
        state = real(state, seed)
        calls.append(state.step)
        if state.step == 2:
            state.params["W"][0, 0] = float("nan")
        return state

    monkeypatch.setattr(model, "train_one_iteration", poisoned)
    solver = Solver(model, max_iteration=3, seed=7, verbose=False,
                    guard=True, guard_max_restores=1)
    with pytest.raises(RuntimeError, match="non-finite"):
        solver.train(train, None, (), checkpoint_path=path,
                     checkpoint_every=1)
    assert calls == [1, 2, 2]  # restored to step 1, diverged again
    assert not _params_finite(solver.state.params)


def test_sgd_solver_schedule(tsplit):
    train, _ = tsplit

    class Model:
        name = "M"
        rates = []

        def reset(self, data, seed=0):
            return tcdae.CDAEState({"w": torch.zeros(1)}, None, 1, 1)

        def train_one_iteration(self, state, seed=0):
            state.step += 1
            return state

        def current_loss(self, state, sample_size=0):
            return 0.0

        def set_learn_rate(self, lr):
            self.rates.append(lr)

    m = Model()
    s = SGDSolver(m, max_iteration=2, learn_rate=0.1, lambda_=0.01,
                  adaptive=True, verbose=False)
    s.train(train)
    n = len(train)
    assert m.rates == pytest.approx([0.1, 0.1 / (1 + 0.001 * n),
                                     0.1 / (1 + 0.001 * 2 * n)])


def test_trace_dir_writes_a_chrome_trace(tsplit, tmp_path):
    train, _ = tsplit
    solver = Solver(_model(), max_iteration=1, verbose=False,
                    trace_dir=str(tmp_path / "tr"))
    solver.train(train)
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    # the program's spans are in it (host events), each step inside its
    # epoch
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]

    def ranges(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("name") == name and e.get("ph") == "X"
                and not str(e.get("cat")).startswith("gpu_")]

    epochs, steps = ranges("cdae.epoch"), ranges("cdae.step")
    assert len(epochs) == 1
    assert len(steps) == -(-train.num_users // CFG["batch_size"])
    assert all(epochs[0][0] <= s and e <= epochs[0][1] for s, e in steps)


def test_cli_train_writes_a_checkpoint_cdae_tpu_reads(movielens_path,
                                                      tmp_path):
    from cdae_tpu.utils.checkpoint import load_checkpoint as jload

    cache = str(tmp_path / "all.bin")
    jio.save_interactions(JInteractions.from_text(movielens_path, jparser),
                          cache)
    ckpt = str(tmp_path / "cli.ckpt")
    argv = ["--task", "train", "--method", "CDAE", "--device", "cpu",
            "--skip_popularity", "--cache_file", cache, "--num_dim", "10",
            "--cratio", "0.5", "--scaled", "true", "--num_neg", "5",
            "--loss_type", "SQUARE", "--batch_size", "16", "--max_iters",
            "4", "--eval_iters", "2", "--checkpoint", ckpt,
            "--checkpoint_every", "2", "--guard_nan", "true"]
    row = tcli.run(argv)
    assert row["iter"] == 4.0 and np.isfinite(row["R@10"])
    # cdae_tpu's model of the same flags reads the port's checkpoint
    args = tcli.build_arg_parser().parse_args(argv)
    from cdae_tpu import cli as jcli

    jm = jcli.build_model(args)
    jtrain, _ = jio.load_interactions(cache).split_by_user(0.2, seed=SEED)
    js = jload(ckpt, jm.reset(jtrain, seed=0))
    assert js.step == 4
    solver = tcli.train(args)  # the same run again: deterministic
    got = solver.state.params
    for k, v in js.params.items():
        np.testing.assert_array_equal(np.asarray(v), got[k].numpy())
    # and resuming from it at step 4 trains nothing more
    row2 = tcli.run(argv[:-6] + ["--max_iters", "4", "--init_checkpoint",
                                 ckpt])
    assert row2["R@10"] == row["R@10"]


def test_port_loads_a_cdae_tpu_training_checkpoint(movielens_path, tsplit,
                                                   tmp_path):
    from cdae_tpu.utils.checkpoint import save_checkpoint as jsave

    jtrain, _ = JInteractions.from_text(movielens_path, jparser) \
        .split_by_user(0.2, seed=SEED)
    jm = jcdae.CDAE(jcdae.CDAEConfig(**CFG, use_pallas=False))
    js = jm.train_one_iteration(jm.reset(jtrain, seed=0),
                                jax.random.PRNGKey(0))
    path = str(tmp_path / "j.ckpt")
    jsave(path, js, fingerprint="0123456789abcdef")
    tm = _model()
    ts = tckpt.load_checkpoint(path, tm.reset(tsplit[0], seed=0))
    assert ts.step == 1
    tm.train_one_iteration(ts, seed=0)  # trains on from it
    assert ts.step == 2 and _params_finite(ts.params)
    with pytest.raises(ValueError, match="fingerprint"):
        tckpt.load_checkpoint(path, tm.reset(tsplit[0]),
                              expect_fingerprint="fedcba9876543210")


def test_sparse_training_raises_naming_a7(tsplit):
    """The sparse step (ROADMAP A7, once refused here) now trains: without
    dense_R, train_one_iteration, train_epochs and data_loss run, advance
    the step and move the tables, and the loss stays finite."""
    m = _model(dense_mode=False)
    st = m.reset(tsplit[0], seed=0)
    assert "dense_R" not in st.aux
    W0 = st.params["W"].clone()
    m.train_one_iteration(st)
    m.train_epochs(st, 2)
    assert st.step == 3
    assert not torch.equal(st.params["W"], W0)
    assert np.isfinite(m.data_loss(st))
    assert dataclasses.replace(m.cfg).dense_mode is False

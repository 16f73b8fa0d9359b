"""cdae_tpu_torch.sweep and ``--task sweep`` against cdae_tpu's: the same
192-point grid in the same order, each point's CDAEConfig field by field,
offset/limit slicing and the JSON lines (keys, order, 5-digit rounding)
with the training stubbed out in both packages, the CLI task on a small
cache, and the first four points trained in both packages on 300 x 300
low-rank data (10 iterations, 3 seeds): each point's 3-seed mean R@10
within 0.03 of cdae_tpu's."""

import dataclasses
import io
import json

import numpy as np
import pytest
import torch

import cdae_tpu.evaluation as jeval
import cdae_tpu.models.cdae as jcdae
import cdae_tpu.sweep as jsweep
import cdae_tpu_torch.evaluation as teval
import cdae_tpu_torch.models.cdae as tcdae
import cdae_tpu_torch.sweep as tsweep
from cdae_tpu.data.dataset import Interactions as JInteractions
from cdae_tpu_torch.data.synthetic import lowrank_interactions

torch.set_num_threads(2)
PARITY_TOL = 0.03  # a point's 3-seed mean R@10, port against cdae_tpu
PARITY_SEEDS = (20141119, 7, 11)


def test_paper_grid_equals_cdae_tpu():
    grid = list(tsweep.paper_grid())
    assert grid == list(jsweep.paper_grid())
    assert len(grid) == 192 and tsweep.PAPER_SEED == jsweep.PAPER_SEED
    assert len({json.dumps(g, sort_keys=True) for g in grid}) == 192


def _stub(monkeypatch, cdae_mod, eval_mod, captured):
    """Replace each package's CDAE (capturing its config) and the TOPN
    evaluator (a fixed R@10 / MAP@10), so run_sweep runs no training."""

    class FakeCDAE:
        def __init__(self, cfg, **kw):
            captured.append(cfg)

        def reset(self, train, seed=0):
            return seed

        def train_epochs(self, state, iters, key):
            return state

    class FakeEval:
        def evaluate(self, model, state, test, train):
            n = len(captured)
            return {"R@10": 0.1234567 + n, "MAP@10": 1 / 3 + n}

    monkeypatch.setattr(cdae_mod, "CDAE", FakeCDAE)
    monkeypatch.setattr(eval_mod.Evaluation, "create",
                        staticmethod(lambda kind: FakeEval()))


def _by_name(v):
    """dtypes by name: jnp.float32 and torch.float32 are both float32."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return str(np.dtype(v)) if not isinstance(v, torch.dtype) else (
        str(v).replace("torch.", ""))


@pytest.mark.parametrize("offset,limit", [(0, 0), (5, 3), (190, 5),
                                          (0, 1)])
def test_configs_lines_and_slicing_equal_cdae_tpu(monkeypatch, offset,
                                                  limit):
    jcfgs, tcfgs = [], []
    _stub(monkeypatch, jcdae, jeval, jcfgs)
    _stub(monkeypatch, tcdae, teval, tcfgs)
    jout, tout = io.StringIO(), io.StringIO()
    jres = jsweep.run_sweep(None, None, iters=3, batch_size=48, seed=5,
                            limit=limit, offset=offset, out=jout)
    tres = tsweep.run_sweep(None, None, iters=3, batch_size=48, seed=5,
                            limit=limit, offset=offset, out=tout,
                            device="cpu")
    assert tout.getvalue() == jout.getvalue()  # keys, order, rounding
    assert tres == jres
    want = list(range(offset, min(offset + limit, 192) if limit else 192))
    assert [r["grid_index"] for r in tres] == want
    lines = [json.loads(x) for x in tout.getvalue().splitlines()]
    assert lines == tres
    assert lines[0]["R@10"] == round(0.1234567 + 1, 5)
    assert list(lines[0]) == ["scaled", "user_factor", "cratio", "linear",
                              "asym", "loss", "grid_index", "R@10",
                              "MAP@10"]
    assert len(tcfgs) == len(jcfgs) == len(want)
    for tc, jc in zip(tcfgs, jcfgs):
        tf = {f.name: _by_name(getattr(tc, f.name))
              for f in dataclasses.fields(tc)}
        jf = {f.name: _by_name(getattr(jc, f.name))
              for f in dataclasses.fields(jc)}
        assert tf == jf


def test_cli_sweep_task(movielens_path, tmp_path, capsys, monkeypatch):
    from cdae_tpu_torch import cli

    cache = str(tmp_path / "ml.bin")
    cli.run(["--task", "prepare", "--parser", "movielens",
             "--input_file", movielens_path, "--cache_file", cache])
    capsys.readouterr()
    argv = ["--task", "sweep", "--cache_file", cache, "--sweep_limit", "2",
            "--max_iters", "2", "--batch_size", "16"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    grid = list(tsweep.paper_grid())
    assert [r["grid_index"] for r in lines] == [0, 1]
    for r in lines:
        assert {k: r[k] for k in grid[0]} == grid[r["grid_index"]]
        assert 0.0 <= r["R@10"] <= 1.0 and 0.0 <= r["MAP@10"] <= 1.0
    # the card by default: without one it raises before loading anything
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.run(argv)


def test_first_points_match_cdae_tpu_on_three_seeds():
    """Points 0-3 (cratio 0, sigmoid, user factor; asym and loss vary),
    10 iterations: the port's 3-seed mean R@10 within 0.03 of cdae_tpu's
    run_sweep on the same splits."""
    port, ref = [], []
    for seed in PARITY_SEEDS:
        data = lowrank_interactions(300, 300, 20, seed=seed)
        train, test = data.split_by_user(0.2, seed=seed)
        jtrain, jtest = (JInteractions(d.users, d.items, d.ratings,
                                       d.num_users, d.num_items)
                         for d in (train, test))
        port.append([r["R@10"] for r in tsweep.run_sweep(
            train, test, iters=10, batch_size=64, seed=seed, limit=4,
            out=io.StringIO(), device="cpu")])
        ref.append([r["R@10"] for r in jsweep.run_sweep(
            jtrain, jtest, iters=10, batch_size=64, seed=seed, limit=4,
            out=io.StringIO())])
    delta = np.mean(port, axis=0) - np.mean(ref, axis=0)
    assert np.all(np.mean(port, axis=0) > 0.1)
    assert np.all(np.abs(delta) <= PARITY_TOL), (port, ref, delta)

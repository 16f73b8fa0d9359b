"""cdae_tpu_torch's pointwise evaluation and the data pieces the rating
models need, against cdae_tpu's: RMSE and MAE on carried parameters (the
last batch padded with weight-0 rows), ``Interactions.dense_matrix``
(binary, and the first occurrence of a pair winning), and the synthetic
rated data and the C++ oracle's text writers at the same seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cdae_tpu.models.mf as jmf
import cdae_tpu_torch.models.mf as tmf
from cdae_tpu.data import synthetic as jsyn
from cdae_tpu.data.dataset import Interactions as JInteractions
from cdae_tpu.data.dataset import movielens_line_parser as jparser
from cdae_tpu.evaluation import EvalType as JEvalType
from cdae_tpu.evaluation import Evaluation as JEvaluation
from cdae_tpu.evaluation import PointwiseEvaluation as JPointwise
from cdae_tpu_torch.data import synthetic as tsyn
from cdae_tpu_torch.data.dataset import Interactions as TInteractions
from cdae_tpu_torch.data.dataset import movielens_line_parser as tparser
from cdae_tpu_torch.evaluation import EvalType
from cdae_tpu_torch.evaluation import Evaluation as TEvaluation
from cdae_tpu_torch.evaluation import PointwiseEvaluation as TPointwise
from cdae_tpu_torch.utils import checkpoint as tckpt

SEED = 20141119


@pytest.fixture(scope="module")
def carried(movielens_path):
    """cdae_tpu's PMF and the port's on the fixture's split, holding the
    same N(0, 1) parameters (ratings 1-5 against scores near 0..3)."""
    jtrain, jtest = JInteractions.from_text(
        movielens_path, jparser).split_by_user(0.2, seed=SEED)
    ttrain, ttest = TInteractions.from_text(
        movielens_path, tparser).split_by_user(0.2, seed=SEED)
    jm = jmf.PMF(jmf.MFConfig(num_dim=8))
    tm = tmf.PMF(tmf.MFConfig(num_dim=8), device="cpu")
    js, ts = jm.reset(jtrain, seed=0), tm.reset(ttrain, seed=0)
    rng = np.random.default_rng(1)
    p = {k: np.array(v) for k, v in js.params.items()}
    for k in ("uv", "iv", "ub", "ib"):
        p[k] = (rng.standard_normal(p[k].shape) + 0.5).astype(np.float32)
    js.params = {k: jnp.asarray(v) for k, v in p.items()}
    ts.params = tckpt.params_from_numpy(p, "cpu")
    return (jm, js, jtest), (tm, ts, ttest)


@pytest.mark.parametrize("batch_size", [1, 7, 16, 40, 4096])
@pytest.mark.parametrize("kind", ["RMSE", "MAE"])
def test_pointwise_matches_cdae_tpu(carried, kind, batch_size):
    """Batches of 7 and 16 pad the last one (40 validation triples); 4096
    is one padded batch."""
    (jm, js, jtest), (tm, ts, ttest) = carried
    want = JPointwise(JEvalType(kind), batch_size).evaluate(jm, js, jtest)
    got = TPointwise(kind, batch_size).evaluate(tm, ts, ttest)
    assert set(got) == {kind, "TestTime"}
    assert got[kind] == pytest.approx(want[kind], rel=1e-6)
    # the plain definition on the port's own predictions
    err = (tm.predict(ts, ttest.users, ttest.items).double()
           - torch.from_numpy(ttest.ratings).double())
    plain = (err.pow(2).mean().sqrt() if kind == "RMSE"
             else err.abs().mean()).item()
    assert got[kind] == pytest.approx(plain, rel=1e-6)


def test_create_and_empty_validation(carried):
    (_, _, _), (tm, ts, ttest) = carried
    for kind in ("RMSE", "mae", EvalType.RMSE):
        ev = TEvaluation.create(kind)
        assert isinstance(ev, TPointwise) and ev.batch_size == 1024
        assert ev.columns == (EvalType.parse(kind).value,)
    empty = TInteractions.from_arrays(np.zeros(0, np.int32),
                                      np.zeros(0, np.int32), num_users=3,
                                      num_items=4)
    assert TEvaluation.create("RMSE").evaluate(tm, ts, empty)["RMSE"] == 0.0
    assert (JEvaluation.create("MAE").evaluate(None, None, empty)["MAE"]
            == TEvaluation.create("MAE").evaluate(tm, ts, empty)["MAE"])
    with pytest.raises(ValueError):
        TEvaluation.create("NOPE")


def _with_duplicates(cls):
    """Pairs rated twice with different ratings: (0, 1) 5 then 2, (2, 0) 1
    then 4 then 3."""
    users = np.array([0, 2, 1, 0, 2, 2, 1], np.int32)
    items = np.array([1, 0, 3, 1, 0, 0, 2], np.int32)
    ratings = np.array([5, 1, 4, 2, 4, 3, 1], np.float32)
    return cls.from_arrays(users, items, ratings, num_users=4, num_items=5)


@pytest.mark.parametrize("binary", [False, True])
def test_dense_matrix_matches(movielens_path, binary):
    j = JInteractions.from_text(movielens_path, jparser)
    t = TInteractions.from_text(movielens_path, tparser)
    got = t.dense_matrix(binary=binary)
    assert got.dtype == np.float32 and got.shape == (t.num_users,
                                                     t.num_items)
    np.testing.assert_array_equal(got, j.dense_matrix(binary=binary))
    dj, dt = _with_duplicates(JInteractions), _with_duplicates(TInteractions)
    got = dt.dense_matrix(binary=binary)
    np.testing.assert_array_equal(got, dj.dense_matrix(binary=binary))
    if binary:
        assert got.sum() == 4.0
    else:  # the first occurrence wins
        assert got[0, 1] == 5.0 and got[2, 0] == 1.0 and got[1, 2] == 1.0


@pytest.mark.parametrize("args", [(50, 40, 8), (120, 300, 20, 4, 7)])
def test_lowrank_rated_matches(args):
    a, b = jsyn.lowrank_rated(*args), tsyn.lowrank_rated(*args)
    for f in ("users", "items", "ratings"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.num_users, a.num_items) == (b.num_users, b.num_items)
    assert set(np.unique(b.ratings)) <= {1.0, 2.0, 3.0, 4.0, 5.0}


def test_text_writers_match(tmp_path):
    data = (jsyn.lowrank_rated(40, 30, 6), tsyn.lowrank_rated(40, 30, 6))
    for writer in ("write_pairs", "write_triples"):
        paths = []
        for mod, d, tag in ((jsyn, data[0], "j"), (tsyn, data[1], "t")):
            path = tmp_path / f"{writer}_{tag}.txt"
            getattr(mod, writer)(str(path), d)
            paths.append(path.read_text())
        assert paths[0] == paths[1]
        assert len(paths[1].splitlines()) == len(data[1])
    first = (tmp_path / "write_triples_t.txt").read_text().splitlines()[0]
    u, i, r = first.split()
    assert (int(u), int(i), float(r)) == (int(data[1].users[0]),
                                          int(data[1].items[0]),
                                          float(data[1].ratings[0]))

"""cdae_tpu_torch's remaining shared-layer functions against cdae_tpu's on the
same inputs: the Interactions and CSR methods (the same arrays, strings
and first-wins dict), padded(max_len) truncation, the host random facade's
draws for a seed, topn_mean / rmse / mae (to f32 rounding), the line
search, checkpoint_extra on a checkpoint from each package, and the
top-level names."""

import numpy as np
import pytest
import torch

import cdae_tpu
import cdae_tpu_torch
from cdae_tpu.data.dataset import Interactions as JInteractions
from cdae_tpu.data.dataset import movielens_line_parser as jml
from cdae_tpu_torch.data.dataset import Interactions as TInteractions
from cdae_tpu_torch.data.dataset import movielens_line_parser as tml

SEED = 20141119


@pytest.fixture(scope="module")
def pair(movielens_path):
    """The MovieLens fixture through each package's loader (with vocabs)."""
    return (JInteractions.from_text(movielens_path, jml),
            TInteractions.from_text(movielens_path, tml))


def _dup_pair():
    """Repeated (user, item) pairs with other ratings, no vocab."""
    rng = np.random.default_rng(4)
    users = rng.integers(0, 9, 120).astype(np.int32)
    items = rng.integers(0, 7, 120).astype(np.int32)
    ratings = rng.integers(1, 6, 120).astype(np.float32)
    return (JInteractions(users, items, ratings, 10, 7),
            TInteractions(users, items, ratings, 10, 7))


def _same_arrays(j, t):
    for f in ("users", "items", "ratings"):
        np.testing.assert_array_equal(getattr(j, f), getattr(t, f))
    assert (j.num_users, j.num_items) == (t.num_users, t.num_items)


@pytest.mark.parametrize("which", ["vocab", "duplicates"])
def test_size_describe_with_dims_user_item_dict(pair, which):
    j, t = pair if which == "vocab" else _dup_pair()
    assert t.size == j.size == len(t)
    assert t.describe() == j.describe()
    assert t.describe(head=2) == j.describe(head=2)
    jw, tw = j.with_dims(40, 50), t.with_dims(40, 50)
    _same_arrays(jw, tw)
    assert tw.user_vocab is t.user_vocab
    assert t.user_item_dict() == j.user_item_dict()


def test_describe_of_an_empty_dataset():
    e = np.zeros(0, np.int32)
    assert (TInteractions(e, e, e, 3, 4).describe()
            == JInteractions(e, e, e, 3, 4).describe())


@pytest.mark.parametrize("seed", [0, 7])
def test_shuffled_and_random_split(pair, seed):
    j, t = pair
    _same_arrays(j.shuffled(np.random.default_rng(seed)),
                 t.shuffled(np.random.default_rng(seed)))
    for ratio in (0.2, 0.5):
        for js, ts in zip(j.random_split(ratio, seed=seed),
                          t.random_split(ratio, seed=seed)):
            _same_arrays(js, ts)
    tr, te = t.random_split(0.2, seed=seed)
    assert len(tr) == int(0.8 * len(t)) and len(tr) + len(te) == len(t)


def test_csr_row_and_row_values(pair):
    j, t = pair
    for jc, tc in ((j.csr(), t.csr()), (j.csr_by_item(), t.csr_by_item())):
        for k in range(len(tc.indptr) - 1):
            np.testing.assert_array_equal(tc.row(k), jc.row(k))
            np.testing.assert_array_equal(tc.row_values(k), jc.row_values(k))
    assert list(t.csr().row(0)) == sorted(t.csr().row(0))


@pytest.mark.parametrize("max_len", [None, 0, 1, 3, 9, 40])
def test_padded_max_len(pair, max_len):
    j, t = pair
    jp, tp = j.padded(max_len=max_len), t.padded(max_len=max_len)
    for f in ("uids", "items", "ratings", "mask", "lengths"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), f)
    assert tp.num_items == jp.num_items
    full = t.padded()
    if max_len:  # truncation keeps each row's lowest max_len items
        L = min(max_len, full.max_len)
        np.testing.assert_array_equal(tp.items[:, :L], full.items[:, :L])
        assert tp.max_len == max_len
        assert (tp.lengths == np.minimum(full.lengths, max_len)).all()


def test_random_facade_draws_equal_cdae_tpu():
    from cdae_tpu.utils import random as jr
    from cdae_tpu_torch.utils import random as tr

    for mod in (jr, tr):
        mod.seed(123)
    np.testing.assert_array_equal(tr.uniform(size=5), jr.uniform(size=5))
    np.testing.assert_array_equal(tr.uniform(-2.0, 3.0, 4),
                                  jr.uniform(-2.0, 3.0, 4))
    np.testing.assert_array_equal(tr.uniform_int(3, 17, size=6),
                                  jr.uniform_int(3, 17, size=6))
    np.testing.assert_array_equal(tr.normal(1.0, 2.0, 5),
                                  jr.normal(1.0, 2.0, 5))
    a, b = np.arange(20), np.arange(20)
    tr.shuffle(a)
    jr.shuffle(b)
    np.testing.assert_array_equal(a, b)
    w = [0.1, 0.0, 2.0, 0.5]
    np.testing.assert_array_equal(tr.discrete(w, 50), jr.discrete(w, 50))
    assert tr.generator().random() == jr.generator().random()
    tr.seed(123)
    first = tr.uniform()
    tr.seed(123)
    assert tr.uniform() == first
    tr.timed_seed()
    assert 0.0 <= tr.uniform() < 1.0


def test_metrics_topn_mean_rmse_mae():
    import jax.numpy as jnp

    from cdae_tpu.ops import metrics as jm
    from cdae_tpu_torch.ops import metrics as tm

    rng = np.random.default_rng(8)
    rows = rng.random((37, 8)).astype(np.float32)
    mask = rng.random((37, 6)) < 0.3
    mask[:5] = False  # users without validation items
    got = tm.topn_mean(torch.from_numpy(rows), torch.from_numpy(mask))
    want = jm.topn_mean(jnp.asarray(rows), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6)
    none = np.zeros((4, 6), bool)  # no validation user: divide by 1
    np.testing.assert_allclose(
        tm.topn_mean(torch.from_numpy(rows[:4]), torch.from_numpy(none)),
        rows[:4].sum(0), rtol=1e-6)
    preds = rng.standard_normal(1001).astype(np.float32) * 2
    labels = rng.integers(1, 6, 1001).astype(np.float32)
    for name in ("rmse", "mae"):
        got = getattr(tm, name)(torch.from_numpy(preds),
                                torch.from_numpy(labels))
        want = getattr(jm, name)(jnp.asarray(preds), jnp.asarray(labels))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=2e-6)


def test_line_search_quadratic():
    from cdae_tpu.solver.line_search import line_search as jls
    from cdae_tpu_torch.solver.line_search import line_search as tls

    f = lambda x: float(np.sum((x - 3.0) ** 2))
    x = np.zeros(2)
    grad = 2 * (x - 3.0)
    step, f_new = tls(f, x, -grad, grad, step0=1.0)
    assert f_new < f(x)
    assert 0 < step <= 1.0
    assert (step, f_new) == jls(f, x, -grad, grad, step0=1.0)
    # an ascent direction finds no decrease: the smallest step tried
    step, f_new = tls(f, x, grad, grad, max_iters=5)
    assert step == 0.5 ** 5 and (step, f_new) == jls(f, x, grad, grad,
                                                    max_iters=5)


def test_checkpoint_extra_from_either_package(pair, tmp_path):
    from cdae_tpu.models.base import ModelState as JState
    from cdae_tpu.utils import checkpoint as jck
    from cdae_tpu_torch.models.base import ModelState as TState
    from cdae_tpu_torch.utils import checkpoint as tck

    extra = {"method": "CDAE", "iters": 3, "note": [1, 2]}
    arrays = {"W": np.arange(6, dtype=np.float32).reshape(3, 2)}
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jck.save_checkpoint(jpath, JState(params=dict(arrays), padded=None,
                                      num_users=4, num_items=3, step=2),
                        extra=extra)
    tck.save_checkpoint(tpath, TState(params=tck.params_from_numpy(arrays,
                                                                   "cpu"),
                                      padded=None, num_users=4, num_items=3,
                                      step=2), extra=extra)
    for path in (jpath, tpath):
        assert tck.checkpoint_extra(path) == extra
        assert jck.checkpoint_extra(path) == extra
    # and each loads in the other
    ts = TState(params={"W": torch.zeros(3, 2)}, padded=None, num_users=4,
                num_items=3)
    tck.load_checkpoint(jpath, ts)
    np.testing.assert_array_equal(ts.params["W"].numpy(), arrays["W"])
    js = JState(params={"W": np.zeros((3, 2), np.float32)}, padded=None,
                num_users=4, num_items=3)
    jck.load_checkpoint(tpath, js)
    np.testing.assert_array_equal(np.asarray(js.params["W"]), arrays["W"])
    assert ts.step == js.step == 2


def test_top_level_names_are_the_port_modules():
    from cdae_tpu_torch import evaluation, models
    from cdae_tpu_torch.ops import losses, penalties
    from cdae_tpu_torch.solver import solver

    expect = {
        "Interactions": TInteractions, "Loss": losses.Loss,
        "LossType": losses.LossType, "Penalty": penalties.Penalty,
        "PenaltyType": penalties.PenaltyType, "CDAE": models.CDAE,
        "CDAEConfig": models.CDAEConfig, "create_model": models.create_model,
        "MODEL_REGISTRY": models.MODEL_REGISTRY, "Solver": solver.Solver,
        "SGDSolver": solver.SGDSolver, "Evaluation": evaluation.Evaluation,
        "EvalType": evaluation.EvalType,
        "__version__": cdae_tpu_torch.__version__,
    }
    assert set(expect) == set(cdae_tpu_torch.__all__) == set(cdae_tpu.__all__)
    for name, obj in expect.items():
        assert getattr(cdae_tpu_torch, name) is obj, name
    with pytest.raises(AttributeError, match="no attribute 'CDAEX'"):
        cdae_tpu_torch.CDAEX

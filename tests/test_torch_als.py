"""cdae_tpu_torch's ALS and WRMF against cdae_tpu's on the same inputs: the
batched normal-equation solve of one chunk, one whole iteration from the
same factors (a user and an item with no observations, pad rows in the
last chunk), then end to end (the Solver and the CLI, with a checkpoint
that cdae_tpu reads back and the port's --task test restores).

Tolerance: rtol 1e-5 and atol 1e-5 times the table's scale (the repo's f32
summation-order tolerance; the two packages' BLAS sum the Grams in other
orders). It holds for ALS and both WRMF solvers where every non-empty row
has at least 2*D observations, so each Gram has full rank. Where a row has
fewer than D observations its Gram is singular up to lambda (ALS) or the
ridge's mu = 16*eps*D*max diag(A) (WRMF), and f32 rounding sets the
solution's null-space component: ALS still holds 1e-5 there (1/lambda
amplifies rounding by 100 at lambda 0.01), while WRMF's two solvers differ
by up to ~1/(16*D) of a thin row's solution between any two BLAS; measured
on that data 3.0e-4 (ridge) and 7.4e-4 (eigh) of the scale, so the thin
WRMF case asks for 2e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cdae_tpu.models.als as jals
import cdae_tpu_torch.models.als as tals
from cdae_tpu.data import io as jio
from cdae_tpu.data.dataset import Interactions as JInteractions
from cdae_tpu.data.dataset import movielens_line_parser as jparser
from cdae_tpu_torch import cli as tcli
from cdae_tpu_torch import models as tmodels
from cdae_tpu_torch.data.dataset import Interactions as TInteractions
from cdae_tpu_torch.data.dataset import movielens_line_parser as tparser
from cdae_tpu_torch.solver.solver import Solver, _params_finite
from cdae_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

SEED = 20141119
D = 8
U, I = 300, 300
# (model, w_solver)
SOLVES = [("ALS", "ridge"), ("WRMF", "ridge"), ("WRMF", "eigh")]


def _close(got, want, tol=1e-5, msg=""):
    want = np.asarray(want)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=atol,
                               err_msg=msg)


def _coo(thin: bool, seed=5):
    """300 x 300 rated (1-5) interactions. Every user but the last rates
    2*D to 39 items (2 to 39 with ``thin``) of all but the last item, so
    one user and one item have no observations."""
    rng = np.random.default_rng(seed)
    us, its = [], []
    for u in range(U - 1):
        n = int(rng.integers(2 if thin else 2 * D, 40))
        its.append(rng.choice(I - 1, n, replace=False))
        us.append(np.full(n, u))
    u, i = np.concatenate(us), np.concatenate(its)
    r = rng.integers(1, 6, len(u)).astype(np.float32)
    return u, i, r


@pytest.fixture(scope="module", params=[False, True], ids=["full", "thin"])
def data(request):
    u, i, r = _coo(request.param)
    return request.param, JInteractions(u, i, r, U, I), TInteractions(
        u, i, r, U, I)


def _factors(seed=1):
    rng = np.random.default_rng(seed)
    return {"p": (rng.standard_normal((U, D)) * 0.3).astype(np.float32),
            "q": (rng.standard_normal((I, D)) * 0.3).astype(np.float32)}


def _pair(name, w_solver, jdata, tdata, **kw):
    """cdae_tpu's model + state and the port's, holding the same factors."""
    cfg = dict(num_dim=D, lambda_=0.01, scalar=40.0, solve_batch=64,
               w_solver=w_solver)
    cfg.update(kw)
    jm = getattr(jals, name)(jals.ALSConfig(**cfg))
    tm = getattr(tals, name)(tals.ALSConfig(**cfg), device="cpu")
    js, ts = jm.reset(jdata, seed=0), tm.reset(tdata, seed=0)
    p = _factors()
    js.params = {k: jnp.asarray(v.copy()) for k, v in p.items()}
    ts.params = tckpt.params_from_numpy(p, "cpu")
    return jm, js, tm, ts


def _tol(name, thin):
    return 2e-3 if thin and name == "WRMF" else 1e-5


def test_item_side_view_and_csr_by_item(data):
    """csr_by_item and the item-side padded view ALS stages equal
    cdae_tpu's; the port's staged sides hold the same rows, chunked."""
    _, jdata, tdata = data
    jc, tc = jdata.csr_by_item(), tdata.csr_by_item()
    for f in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    assert tdata.csr_by_item() is tc  # cached
    jp = JInteractions(jdata.items, jdata.users, jdata.ratings, I,
                       U).padded()
    tp = tdata.by_item().padded()
    for f in ("items", "ratings", "mask", "lengths", "uids"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    jm, js, tm, ts = _pair("ALS", "ridge", jdata, tdata)
    for side in ("dev_user_side", "dev_item_side"):
        for j, t in zip(js.aux[side][:4], ts.aux[side][:4]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert ts.aux[side][4] == int(js.aux[side][4])


@pytest.mark.parametrize("name,w_solver", SOLVES)
def test_solve_side_one_chunk_matches(data, name, w_solver):
    """_solve_side_math on one chunk of the user side, against the same
    item factors."""
    thin, jdata, tdata = data
    jm, js, tm, ts = _pair(name, w_solver, jdata, tdata)
    idx, r, m, _, _ = js.aux["dev_user_side"]
    q = _factors()["q"]
    weighted = name == "WRMF"
    want = jals._solve_side_math(jnp.asarray(q), idx[1], r[1], m[1],
                                 jnp.float32(0.01), jnp.float32(40.0),
                                 weighted, w_solver)
    got = tals._solve_side_math(*(torch.tensor(np.asarray(a))
                                  for a in (q, idx[1], r[1], m[1])),
                                0.01, 40.0, weighted, w_solver)
    _close(got, want, _tol(name, thin))


@pytest.mark.parametrize("name,w_solver", SOLVES)
def test_iteration_matches(data, name, w_solver):
    """One iteration (user sweep, then the item sweep against the new user
    factors) from the same factors; the user and the item with no
    observations, and every pad row, keep their factors."""
    thin, jdata, tdata = data
    jm, js, tm, ts = _pair(name, w_solver, jdata, tdata)
    js = jm.train_one_iteration(js, None)
    ts = tm.train_one_iteration(ts, 0)
    assert ts.step == 1 and ts.params["p"].shape == (U, D)
    for k in ("p", "q"):
        _close(ts.params[k], js.params[k], _tol(name, thin), k)
    p0 = _factors()
    np.testing.assert_array_equal(ts.params["p"][U - 1].numpy(),
                                  p0["p"][U - 1])
    np.testing.assert_array_equal(ts.params["q"][I - 1].numpy(),
                                  p0["q"][I - 1])


@pytest.mark.parametrize("name,w_solver", SOLVES)
def test_solution_solves_normal_equations(data, name, w_solver):
    """After the user sweep each p_u solves (lambda*I + sum c y y^T) p_u =
    sum w y (c = w = s*r for WRMF; c = 1, w = r for ALS), to the solver's
    own accuracy (tests/test_models_zoo.py's check)."""
    thin, _, tdata = data
    m = getattr(tals, name)(tals.ALSConfig(num_dim=D, lambda_=0.05,
                                           scalar=5.0, solve_batch=64,
                                           w_solver=w_solver), device="cpu")
    state = m.reset(tdata, seed=0)
    q = state.params["q"].numpy().astype(np.float64)
    user_side = state.aux["dev_user_side"]
    p = tals._sweep(state.params["p"], state.params["q"], user_side, 0.05,
                    5.0, m.weighted, w_solver).numpy()
    csr = tdata.csr()
    for u in (0, 3, 7, 150):
        items = csr.indices[csr.indptr[u]:csr.indptr[u + 1]]
        r = csr.values[csr.indptr[u]:csr.indptr[u + 1]].astype(np.float64)
        Y = q[items]
        c = 5.0 * r if m.weighted else np.ones_like(r)
        A = 0.05 * np.eye(D) + (Y * c[:, None]).T @ Y
        rhs = Y.T @ (c if m.weighted else r)
        np.testing.assert_allclose(A @ p[u], rhs, rtol=1e-3,
                                   atol=1e-3 * np.abs(rhs).max())


@pytest.mark.parametrize("name,w_solver", SOLVES)
def test_solve_batch_changes_no_number(data, name, w_solver):
    """Chunks of 64, of 100 and of every row give the same bits."""
    _, jdata, tdata = data
    out = []
    for bs in (64, 100, 4096):
        _, _, tm, ts = _pair(name, w_solver, jdata, tdata, solve_batch=bs)
        tm.train_one_iteration(ts, 0)
        out.append(ts.params)
    for other in out[1:]:
        for k in ("p", "q"):
            assert torch.equal(other[k], out[0][k]), k


def test_cholesky_failure_gives_nan_rows():
    """A Gram that is not positive definite gives a NaN row (as
    jnp.linalg.cholesky), not an exception; the other rows solve."""
    A = torch.eye(3).repeat(2, 1, 1)
    A[1, 0, 0] = -1.0
    x = tals._cholesky_solve(A, torch.ones(2, 3))
    assert torch.isnan(x[1]).all()
    assert torch.equal(x[0], torch.ones(3))


@pytest.fixture(scope="module")
def splits(movielens_path):
    j = JInteractions.from_text(movielens_path, jparser)
    t = TInteractions.from_text(movielens_path, tparser)
    return j.split_by_user(0.2, seed=SEED), t.split_by_user(0.2, seed=SEED)


@pytest.mark.parametrize("name,w_solver", SOLVES)
def test_solver_learns_and_scores_match(splits, name, w_solver):
    """A Solver run learns (R@10 rises from iteration 0); batch_scores,
    predict and the penalty loss on carried factors equal cdae_tpu's."""
    (jtrain, _), (ttrain, ttest) = splits
    model = getattr(tals, name)(tals.ALSConfig(
        num_dim=D, lambda_=0.1, scalar=5.0, solve_batch=16,
        w_solver=w_solver), device="cpu")
    solver = Solver(model, max_iteration=3, eval_iterations=3, seed=0,
                    verbose=False)
    solver.train(ttrain, ttest, ["TOPN"])
    assert solver.history[-1]["R@10"] > solver.history[0]["R@10"]
    assert _params_finite(solver.state.params)
    jm = getattr(jals, name)(jals.ALSConfig(num_dim=D, lambda_=0.1))
    js = jm.reset(jtrain, seed=0)
    p = {k: v.numpy() for k, v in solver.state.params.items()}
    js.params = {k: jnp.asarray(v.copy()) for k, v in p.items()}
    uids = np.arange(0, ttrain.num_users, 2)
    _close(model.batch_scores(solver.state, uids, None, None),
           jm.batch_scores(js, uids, None, None))
    users, items = ttrain.users[:20], ttrain.items[:20]
    _close(model.predict(solver.state, users, items),
           jm.predict(js, users, items))
    assert model.penalty_loss(solver.state) == pytest.approx(
        jm.penalty_loss(js), rel=1e-5)
    assert model.data_loss(solver.state) == 0.0


def test_registry_and_config():
    for name, cls in (("als", tals.ALS), ("WRMF", tals.WRMF)):
        assert isinstance(tmodels.create_model(name, device="cpu"), cls)
    assert tals.ALSConfig().w_solver == "ridge"
    assert ([f.name for f in dataclasses.fields(tals.ALSConfig)]
            == [f.name for f in dataclasses.fields(jals.ALSConfig)])
    with pytest.raises(ValueError, match="w_solver"):
        tals.WRMF(tals.ALSConfig(w_solver="lu"), device="cpu")


@pytest.mark.parametrize("method", ["ALS", "WRMF"])
def test_cli_trains_and_test_task_restores(movielens_path, tmp_path,
                                           method):
    """--method ALS / WRMF through the CLI on the CPU (Popularity first);
    cdae_tpu's model of the same flags reads the checkpoint; the port's
    --task test restores it and scores what cdae_tpu scores."""
    from cdae_tpu import cli as jcli
    from cdae_tpu.utils.checkpoint import load_checkpoint as jload

    data = JInteractions.from_text(movielens_path, jparser)
    cache = str(tmp_path / "all.bin")
    jio.save_interactions(data, cache)
    ckpt = str(tmp_path / "als.ckpt")
    argv = ["--task", "train", "--method", method, "--device", "cpu",
            "--cache_file", cache, "--num_dim", "8", "--lambda", "0.1",
            "--scalar", "5", "--max_iters", "3", "--eval_iters", "3",
            "--checkpoint", ckpt]
    solver = tcli.train(tcli.build_arg_parser().parse_args(argv))
    assert type(solver.model).__name__ == method
    assert solver.model.cfg.scalar == 5.0 and solver.model.cfg.lambda_ == 0.1
    assert solver.history[-1]["iter"] == 3.0
    assert solver.history[-1]["R@10"] > solver.history[0]["R@10"]
    jtrain, jtest = data.split_by_user(0.2, seed=SEED)
    args = tcli.build_arg_parser().parse_args(argv)
    js = jload(ckpt, jcli.build_model(args).reset(jtrain, seed=0))
    assert js.step == 3
    tr, te = str(tmp_path / "tr.bin"), str(tmp_path / "te.bin")
    jio.save_interactions(jtrain, tr)
    jio.save_interactions(jtest, te)
    got = tcli.run(["--task", "test", "--method", method, "--device", "cpu",
                    "--num_dim", "8", "--train_cache_file", tr,
                    "--test_cache_file", te, "--init_checkpoint", ckpt])
    from cdae_tpu.evaluation import Evaluation as JEvaluation

    want = JEvaluation.create("TOPN").evaluate(
        jcli.build_model(args), js, jtest, jtrain)
    assert got["R@10"] == pytest.approx(want["R@10"], abs=1e-6)
    assert got["R@10"] == pytest.approx(solver.history[-1]["R@10"],
                                        abs=1e-6)

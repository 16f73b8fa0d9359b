"""cdae_tpu_torch's sparse CDAE training (no dense_R) against cdae_tpu's.

Both packages start from one cdae_tpu reset (``params_from_numpy``). The
port is fed the draws cdae_tpu makes inside ``_train_step`` -- ``kc, kn =
split(key)``; the keep mask ``corrupt_mask(kc, ...)``; the exact negatives
``sample_unrated(kn, ...)``, or ``kp, ks = split(kn)`` for the pool ids
``randint(kp, ...)`` and their selection uniforms ``uniform(ks, ...)`` --
so one step agrees to f32 rounding (rtol 1e-5 / atol 1e-6 per table) in
every variant, and whole epochs, each in its own batch order, to 1e-4.
Every batch holds a user who rated the whole catalog, whose exact draws are
the sentinel id. The AdaGrad accumulators start at a trained scale
(U(0.5, 1.5)), as in tests/test_torch_mf.py: at the 1e-4 init a step is
lr * g / |g|, which turns f32 rounding of a small gradient (tanh's
1 - z^2 near saturation, where torch's and XLA's tanh differ by an ulp)
into percents of the step. With ``row_update`` the W / V / b' rows take
row_adagrad_delta, whose cdae_tpu form subtracts g^2 back out of the
batch's inclusive running sum; with a pool's large gradients that leaves
noise past 1e-5 in a row's prefix, where the port's exclusive cumsums are
exact (tests/test_torch_train_ops.py holds both against the per-touch
loop). Those variants run cdae_tpu's step with the prefix taken as the
port takes it (``_exact_prefix_row_adagrad_delta``), all else unchanged.
Also here: data_loss / current_loss, the token-budget
batching, and a sparse run that learns.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cdae_tpu.models.cdae as jcdae
import cdae_tpu_torch.models.cdae as tcdae
from cdae_tpu.data.dataset import Interactions as JInteractions
from cdae_tpu.models import base as jbase
from cdae_tpu.ops import corruption, sampling
from cdae_tpu.solver import optimizer as jopt
from cdae_tpu_torch.data.dataset import Interactions as TInteractions
from cdae_tpu_torch.models import base as tbase
from cdae_tpu_torch.utils.checkpoint import params_from_numpy

torch.set_num_threads(2)

U, I, D, B, K = 40, 60, 8, 16, 32
BASE = dict(num_dim=D, loss="SQUARE", learn_rate=0.1, lambda_=0.01,
            batch_size=B, dense_mode=False, corruption_ratio=0.5)


def _data():
    rng = np.random.default_rng(0)
    R = rng.random((U, I)) < 0.15
    R[7] = True  # a user with an empty complement: the sentinel draws
    users, items = np.nonzero(R)
    return users.astype(np.int32), items.astype(np.int32)


def _pair(kw):
    """cdae_tpu model + state, and the port's (CPU) model + state holding
    the same parameters."""
    users, items = _data()
    kw = {**BASE, **kw}
    jkw = {k: v for k, v in kw.items() if k != "use_pallas"}
    jm = jcdae.CDAE(jcdae.CDAEConfig(**jkw, fast_rng=False, use_pallas=False))
    js = jm.reset(JInteractions.from_arrays(users, items, num_users=U,
                                            num_items=I), seed=0)
    tm = tcdae.CDAE(tcdae.CDAEConfig(**{"use_pallas": True, **kw},
                                     fast_rng=False), device="cpu")
    ts = tm.reset(TInteractions.from_arrays(users, items, num_users=U,
                                            num_items=I), seed=0)
    assert "dense_R" not in js.aux and "dense_R" not in ts.aux
    rng = np.random.default_rng(1)
    arrays = {k: (rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                  if k.endswith("_ag") else np.asarray(v))
              for k, v in js.params.items()}
    js.params = {k: jnp.asarray(v.copy()) for k, v in arrays.items()}
    ts.params = params_from_numpy(arrays, torch.device("cpu"))
    return jm, js, tm, ts


def _draws(cfg, key, items, mask, lengths):
    """The draws cdae_tpu's _train_step makes from ``key``, as the port's
    ``_train_step`` keywords."""
    kc, kn = jax.random.split(key)
    B_, L = items.shape
    out = {"keep": corruption.corrupt_mask(kc, mask, cfg.corruption_ratio)}
    if cfg.neg_pool:
        kp, ks = jax.random.split(kn)
        out["pool"] = jax.random.randint(kp, (cfg.neg_pool,), 0, I,
                                         dtype=jnp.int32)
        out["u_sel"] = jax.random.uniform(ks, (B_, cfg.neg_pool))
    else:
        out["neg"] = sampling.sample_unrated(kn, items, lengths, I,
                                             max(cfg.num_neg * L, 1))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@functools.partial(jax.jit, static_argnames=("learn_rate", "beta",
                                             "use_adagrad"))
def _exact_prefix_row_adagrad_delta(param, acc, rows, grad_rows, live,
                                    learn_rate, beta=0.0, use_adagrad=True):
    """cdae_tpu's row_adagrad_delta with each touch's prefix summed over
    its own row's earlier touches only (a segmented scan, exactly 0 at a
    row's first touch)."""
    if not use_adagrad:
        return jopt.row_adagrad_delta(param, acc, rows, grad_rows, live,
                                      learn_rate, beta, use_adagrad)
    g32 = grad_rows.astype(jnp.float32)
    gsq = jnp.where(live, g32 * g32, 0.0)
    order = jnp.argsort(rows, stable=True)
    r_s, q_s = rows[order], gsq[order]
    is_start = jnp.concatenate([jnp.ones((1,), bool), r_s[1:] != r_s[:-1]])
    flag = is_start.reshape((-1,) + (1,) * (q_s.ndim - 1))

    def seg_add(a, b):  # (flag, sum) pairs: a sum restarts at a flag
        return a[0] | b[0], jnp.where(b[0], b[1], a[1] + b[1])

    _, incl = jax.lax.associative_scan(
        seg_add, (jnp.broadcast_to(flag, q_s.shape), q_s))
    a_s = acc[r_s] + (incl - q_s) * ~flag + q_s
    step = learn_rate * g32[order] / (beta + jnp.sqrt(a_s))
    live_s = live[order] if getattr(live, "ndim", 0) else live
    delta = jnp.where(live_s, -step, 0.0).astype(param.dtype)
    return (param.at[r_s].add(delta, mode="drop"),
            acc.at[rows].add(gsq, mode="drop"))


def _check(got, want, rtol, atol=1e-6):
    """Each table within rtol, and atol times its scale (max(1, max |w|)):
    an accumulator of ~1e3 sums squares of gradients whose own sums cancel
    at that scale."""
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k].numpy(), w, rtol=rtol,
                                   atol=atol * scale, err_msg=k)


def _batches(jm, js, tm, ts):
    jb = jm._device_batches(js)
    tb = tm._device_batches(ts)
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    return jb, tb


STEP_VARIANTS = {
    f"{'asym' if asym else 'tied'}-{'pool' if pool else 'exact'}"
    f"-packed_{packed}-row_{row}": dict(asymmetric=asym, neg_pool=pool,
                                        packed_io=packed, row_update=row)
    for asym in (False, True) for pool in (None, K)
    for packed in (None, False) for row in (None, True)
}
STEP_VARIANTS.update({
    "no_user_factor": dict(user_factor=False),
    "linear_function": dict(linear_function=True),
    "tanh": dict(tanh=True),
    "index_add": dict(use_pallas=False),  # scatter_mode "scatter"
    "row_update_index_add": dict(use_pallas=False, row_update=True),
})


@pytest.mark.parametrize("variant", sorted(STEP_VARIANTS))
def test_sparse_step_matches_cdae_tpu(variant, monkeypatch):
    if STEP_VARIANTS[variant].get("row_update"):
        monkeypatch.setattr(jcdae, "row_adagrad_delta",
                            _exact_prefix_row_adagrad_delta)
    jm, js, tm, ts = _pair(STEP_VARIANTS[variant])
    jb, tb = _batches(jm, js, tm, ts)
    # the longest batch holds the full user (uid 7); the first one too
    jp = dict(js.params)
    for j in (0, len(jb) - 1):
        key = jax.random.PRNGKey(j)
        draws = _draws(jm.cfg, key, *jb[j][1:4])
        if not jm.cfg.neg_pool and j:
            assert (draws["neg"] == I).any()  # the sentinel is exercised
        jp = jcdae._train_step(jp, *jb[j], key, cfg=jm.cfg, loss=jm.loss)
        out = tcdae._train_step(ts.params, *tb[j], 0, cfg=tm.cfg,
                                loss=tm.loss, coll=ts.aux["coll"], **draws)
        assert out is ts.params  # updated in place
    _check(ts.params, jp, rtol=1e-5)


@pytest.mark.parametrize("route", ["train_one_iteration", "train_epochs"])
def test_sparse_epoch_matches_cdae_tpu(route):
    """One epoch, num_corruptions 2, pooled negatives: the port visits the
    batches in cdae_tpu's order for each entry point (host order; shape-
    sorted groups) and takes cdae_tpu's draws in that order."""
    kw = dict(neg_pool=K, num_corruptions=2)
    if route == "train_epochs":
        # streamed, unbucketed batches: shapes out of order, so the two
        # orders differ
        kw.update(stream_batches=True, bucket_by_length=False)
    jm, js, tm, ts = _pair(kw)
    jb, _ = _batches(jm, js, tm, ts)
    if route == "train_one_iteration":
        order = list(jb)
    else:
        order = [tuple(x[i] for x in stack)
                 for stack in jm._bucket_stacks(js)
                 for i in range(stack[0].shape[0])]
        assert [b[1].shape for b in order] != [b[1].shape for b in jb]
    key = jax.random.PRNGKey(3)
    draws = []
    for batch in order:
        for _ in range(2):
            key, sub = jax.random.split(key)
            draws.append(_draws(jm.cfg, sub, *batch[1:4]))
    if route == "train_one_iteration":
        js = jm.train_one_iteration(js, jax.random.PRNGKey(3))
        tm.train_one_iteration(ts, 0, draws=iter(draws))
    else:
        js = jm.train_epochs(js, 1, jax.random.PRNGKey(3))
        tm.train_epochs(ts, 1, 0, draws=iter(draws))
    assert ts.step == js.step == 1
    _check(ts.params, js.params, rtol=1e-4)


def test_sparse_data_loss_matches_cdae_tpu():
    jm, js, tm, ts = _pair(dict(num_corruptions=2))
    jb, _ = _batches(jm, js, tm, ts)
    key = jax.random.PRNGKey(js.step)
    uniforms = []
    for batch in jb:
        key, sub = jax.random.split(key)
        per = []
        for _ in range(2):
            sub, s2 = jax.random.split(sub)
            per.append(torch.from_numpy(np.array(
                jax.random.uniform(s2, batch[2].shape))))
        uniforms.append(per)
    want = jm.data_loss(js)
    got = tm.data_loss(ts, uniforms=uniforms)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(
        got + tm.penalty_loss(ts), jm.current_loss(js), rtol=1e-5)
    # without injected draws the loss is finite and repeats
    a, b = tm.current_loss(ts), tm.current_loss(ts)
    assert np.isfinite(a) and a == b


@pytest.mark.parametrize("slots", [None, 64, 96, 256])
def test_token_budget_batches_match_cdae_tpu(slots):
    users, items = _data()
    csr_j = JInteractions.from_arrays(users, items, num_users=U,
                                      num_items=I).csr()
    csr_t = TInteractions.from_arrays(users, items, num_users=U,
                                      num_items=I).csr()
    want = list(jbase.iter_user_batches_csr(csr_j, I, B,
                                            slots_per_batch=slots))
    got = list(tbase.iter_user_batches_csr(csr_t, I, B,
                                           slots_per_batch=slots))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("uids", "items", "ratings", "mask", "lengths", "weight"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    n = tbase.count_user_batches_csr(csr_t, B, slots_per_batch=slots)
    assert n == len(got) == jbase.count_user_batches_csr(
        csr_j, B, slots_per_batch=slots)
    if slots:  # the budget sets the batch size of the long buckets
        assert {b.items.shape[0] for b in got} != {B}


def test_sparse_step_draws_from_its_seed():
    """Without injected draws the step draws from its seed (generator and
    hash streams): the same seed gives the same update, another seed
    another one."""
    for fast_rng in (False, True):
        for pool in (None, K):
            def step(seed):
                _, _, tm, ts = _pair(dict(neg_pool=pool))
                tm.cfg = tcdae.dataclasses.replace(tm.cfg, fast_rng=fast_rng)
                tcdae._train_step(ts.params, *tm._device_batches(ts)[-1],
                                  seed, cfg=tm.cfg, loss=tm.loss,
                                  coll=ts.aux["coll"])
                return ts.params["W"]

            a, b, c = step(5), step(5), step(6)
            assert torch.equal(a, b)
            assert not torch.equal(a, c)


def test_sparse_training_learns_on_cpu():
    """The sparse step through Solver.train (auto rule lowered): R@10 rises
    over 8 epochs on low-rank data, params finite; train_epochs gives
    another batch order but also learns."""
    from cdae_tpu_torch.data.synthetic import lowrank_interactions
    from cdae_tpu_torch.solver.solver import Solver, _params_finite

    data = lowrank_interactions(300, 200, 20, seed=5)
    train, test = data.split_by_user(0.2, seed=5)
    model = tcdae.CDAE(tcdae.CDAEConfig(
        num_dim=16, loss="SQUARE", corruption_ratio=0.2, num_neg=3,
        batch_size=64, neg_pool=64, use_pallas=True, dense_mode=False),
        device="cpu")
    solver = Solver(model, max_iteration=8, eval_iterations=8, seed=1,
                    verbose=False)
    solver.train(train, test, ["TOPN"])
    assert "dense_R" not in solver.state.aux
    hist = solver.history
    assert hist[-1]["R@10"] > hist[0]["R@10"] + 0.05, hist
    assert _params_finite(solver.state.params)


def test_sparse_step_equals_dense_step_without_draws():
    """With corruption 0 and no negatives the port's sparse and dense steps
    are the same math (tests/test_dense_mode.py's identity for cdae_tpu):
    one step of each from one reset agrees to rtol 2e-5 / atol 1e-6."""
    from cdae_tpu_torch.data.synthetic import lowrank_interactions

    data = lowrank_interactions(120, 90, 12, seed=2)
    cfg = dict(num_dim=8, loss="SQUARE", corruption_ratio=0.0, num_neg=0,
               batch_size=32, bucket_by_length=False, use_pallas=True)
    out = {}
    for dense in (False, True):
        m = tcdae.CDAE(tcdae.CDAEConfig(dense_mode=dense, **cfg),
                       device="cpu")
        st = m.reset(data, seed=0)
        assert ("dense_R" in st.aux) == dense
        b = next(tbase.iter_user_batches(st.padded, 32))
        uids, items, mask, lengths, weight = (
            torch.as_tensor(x) for x in (b.uids, b.items, b.mask, b.lengths,
                                         b.weight))
        if dense:
            tcdae._dense_train_step(st.params, st.aux["dense_R"],
                                    uids.long(), weight, 3, cfg=m.cfg,
                                    loss=m.loss, coll=st.aux["coll"])
        else:
            tcdae._train_step(st.params, uids.long(), items.long(), mask,
                              lengths.long(), weight, 3, cfg=m.cfg,
                              loss=m.loss, coll=st.aux["coll"])
        out[dense] = st.params
    for k in out[True]:
        torch.testing.assert_close(out[False][k], out[True][k], rtol=2e-5,
                                   atol=1e-6)

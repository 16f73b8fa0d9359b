"""cdae_tpu_torch's dense CDAE train step against cdae_tpu's, step by step.

Both packages start from one cdae_tpu reset; the port is fed the very
uniforms cdae_tpu draws inside ``_dense_train_step`` (``kc, kn =
jax.random.split(key)``, then ``jax.random.uniform`` of each), so the two
must agree to f32 rounding over a chained epoch of 3 steps, for every variant
flag and loss. The batches are the model's own (unique uids per batch, the
last one wrapping with weight 0). lr 0.01 keeps AdaGrad's first step
(lr / sqrt(1e-4) = 1 times the gradient) from magnifying summation-order
noise past the 1e-5 check. Also here: the bf16 operand rule of the scoring
path, and data_loss / current_loss with injected uniforms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cdae_tpu.models.cdae as jcdae
import cdae_tpu_torch.models.cdae as tcdae
from cdae_tpu.data.dataset import Interactions as JInteractions
from cdae_tpu_torch.data.dataset import Interactions as TInteractions

torch.set_num_threads(2)

U, I, D, B = 40, 70, 12, 16
BASE = dict(num_dim=D, loss="SQUARE", learn_rate=0.01, lambda_=0.01,
            batch_size=B, dense_mode=True)
VARIANTS = {
    "default": {},
    "asymmetric": dict(asymmetric=True),
    "tanh": dict(tanh=True),
    "linear": dict(linear=True),
    "no_user_factor": dict(user_factor=False),
    "linear_function": dict(linear_function=True),
    "cratio_0": dict(corruption_ratio=0.0),
    "cratio_1": dict(corruption_ratio=1.0),
    "unscaled": dict(scaled=False),
    "beta_1": dict(beta=1.0),
    "no_adagrad": dict(using_adagrad=False),
    "CE": dict(loss="CE"),
    "LOGISTIC": dict(loss="LOGISTIC"),
    "LOG": dict(loss="LOG"),
    "HINGE": dict(loss="HINGE"),
    "kernel_wrappers": dict(use_pallas=True),  # the wrappers' CPU route
}


def _data():
    rng = np.random.default_rng(0)
    users, items = np.nonzero(rng.random((U, I)) < 0.15)
    return users.astype(np.int32), items.astype(np.int32)


def _pair(kw, bf16=False):
    """cdae_tpu model + state, and the port's model + state holding the
    same parameters (cdae_tpu's reset)."""
    users, items = _data()
    jkw, tkw = {**BASE, **kw}, {**BASE, **kw}
    if bf16:
        jkw["compute_dtype"] = jnp.bfloat16
        tkw["compute_dtype"] = torch.bfloat16
    for k in ("use_pallas", "fast_rng"):  # the port's own routing knobs
        jkw.pop(k, None)
    jm = jcdae.CDAE(jcdae.CDAEConfig(**jkw, fast_rng=False, fused_step=False,
                                     use_pallas=False))
    js = jm.reset(JInteractions.from_arrays(users, items, num_users=U,
                                            num_items=I), seed=0)
    tm = tcdae.CDAE(tcdae.CDAEConfig(**{"fast_rng": False, **tkw}),
                    device="cpu")
    ts = tm.reset(TInteractions.from_arrays(users, items, num_users=U,
                                            num_items=I), seed=0)
    ts.params = {k: torch.from_numpy(np.array(v)) for k, v in
                 js.params.items()}
    return jm, js, tm, ts


def _jax_uniforms(key, shape):
    kc, kn = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.uniform(kc, shape))),
            torch.from_numpy(np.array(jax.random.uniform(kn, shape))))


def _run_epoch(kw, bf16=False):
    jm, js, tm, ts = _pair(kw, bf16)
    jp = dict(js.params)
    uid_mat, w_mat = jm._dense_batches(js)
    t_uids, t_w = tm._dense_batches(ts)
    np.testing.assert_array_equal(t_uids.numpy(), np.asarray(uid_mat))
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(w_mat))
    for j in range(uid_mat.shape[0]):
        key = jax.random.PRNGKey(j)
        jp = jcdae._dense_train_step(jp, js.aux["dense_R"], uid_mat[j],
                                     w_mat[j], key, cfg=jm.cfg, loss=jm.loss)
        u_c, u_n = _jax_uniforms(key, (B, I))
        out = tcdae._dense_train_step(
            ts.params, ts.aux["dense_R"], t_uids[j], t_w[j], 0, cfg=tm.cfg,
            loss=tm.loss, u_corrupt=u_c, u_neg=u_n)
        assert out is ts.params  # updated in place
    return jp, ts.params


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dense_step_matches_cdae_tpu(variant):
    want, got = _run_epoch(VARIANTS[variant])
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        # accumulators grow to ~1e3: hold them to 1e-5 of their scale
        atol = 1e-5 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5, atol=atol,
                                   err_msg=k)


def test_dense_step_bf16_compute_matches_cdae_tpu():
    """compute_dtype=bf16: bf16 matmul operands, f32 sums, bf16 slabs.
    Tolerance 2e-3: where the two frameworks round a product differently,
    a bf16 operand or stored gradient moves by one bf16 ulp (2**-8)."""
    want, got = _run_epoch({}, bf16=True)
    for k in want:
        w = np.asarray(want[k])
        atol = 2e-3 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k].numpy(), w, rtol=2e-3, atol=atol,
                                   err_msg=k)


def test_dense_step_draws_from_its_seed():
    """Without injected uniforms the step draws from its seed: the same
    seed gives the same update, another seed another one."""
    def step(seed, fast_rng):
        _, js, tm, ts = _pair({"fast_rng": fast_rng})
        uids, w = tm._dense_batches(ts)
        tcdae._dense_train_step(ts.params, ts.aux["dense_R"], uids[0], w[0],
                                seed, cfg=tm.cfg, loss=tm.loss)
        return ts.params["W"]

    for fast_rng in (False, True):
        a, b, c = step(5, fast_rng), step(5, fast_rng), step(6, fast_rng)
        assert torch.equal(a, b)
        assert not torch.equal(a, c)


def test_step_seed_is_a_pure_function():
    s = tcdae.step_seed(20141119, 3, 2, 0)
    assert s == tcdae.step_seed(20141119, 3, 2, 0)
    assert -2**31 <= s < 2**31
    others = {tcdae.step_seed(20141119, *k)
              for k in ((3, 2, 1), (3, 1, 0), (2, 2, 0))}
    others.add(tcdae.step_seed(1, 3, 2, 0))
    assert s not in others and len(others) == 4


@pytest.mark.parametrize("variant", ["default", "asymmetric",
                                     "linear_function"])
def test_data_loss_and_current_loss_match(variant):
    kw = {**VARIANTS[variant], "num_corruptions": 2}
    jm, js, tm, ts = _pair(kw)
    # cdae_tpu's data_loss draws: key splits per batch, then per corruption
    key = jax.random.PRNGKey(7)
    uniforms = []
    for _ in range(jm._dense_batches(js)[0].shape[0]):
        key, sub = jax.random.split(key)
        per_c = []
        for _ in range(2):
            sub, c = jax.random.split(sub)
            per_c.append(torch.from_numpy(np.array(
                jax.random.uniform(c, (B, I)))))
        uniforms.append(per_c)
    want = jm.data_loss(js, rng_key=jax.random.PRNGKey(7))
    got = tm.data_loss(ts, uniforms=uniforms)
    assert got == pytest.approx(want, rel=1e-5)
    assert tm.penalty_loss(ts) == pytest.approx(jm.penalty_loss(js),
                                                rel=1e-6)
    # current_loss = data_loss + penalty_loss; its draws come from the seed
    cur = tm.current_loss(ts)
    assert cur == pytest.approx(tm.data_loss(ts) + tm.penalty_loss(ts),
                                rel=1e-6)


def test_bf16_scores_match_cdae_tpu():
    """The bf16 operand rule: compute_dtype=bf16 rounds the matmul operands
    to bf16 and sums in f32, as cdae_tpu does -- scores to 1e-5 (rounding
    the sums to bf16 as well was 7.1e-3 off)."""
    uids = np.arange(16)
    for dense in (True, False):
        kw = dict(dense_mode=dense, use_pallas=False)
        jm2 = jcdae.CDAE(jcdae.CDAEConfig(**{**BASE, **kw},
                                          compute_dtype=jnp.bfloat16))
        tm2 = tcdae.CDAE(tcdae.CDAEConfig(**{**BASE, **kw},
                                          compute_dtype=torch.bfloat16),
                         device="cpu")
        js2 = jm2.reset(JInteractions.from_arrays(*_data(), num_users=U,
                                                  num_items=I), seed=0)
        ts2 = tm2.reset(TInteractions.from_arrays(*_data(), num_users=U,
                                                  num_items=I), seed=0)
        ts2.params = {k: torch.from_numpy(np.array(v)) for k, v in
                      js2.params.items()}
        pb = js2.padded
        ri, rm = pb.items[uids], pb.mask[uids]
        want = np.asarray(jm2.batch_scores(js2, uids, ri, rm))
        got = tm2.batch_scores(ts2, uids, ri, rm).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

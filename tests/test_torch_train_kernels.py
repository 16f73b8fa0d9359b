"""The plain versions of the training kernels against cdae_tpu.

  B1 hw_uniform       bit for bit against cdae_tpu's tiling-invariant hash
                      (cdae_tpu/ops/cdae_fused.py _hash_uniform)
  B2 adagrad_update   against cdae_tpu's Pallas kernel in interpret mode, at
                      tests/test_pallas.py's shapes, and over each training
                      path's list of tables (adagrad_update_tables, one
                      launch on the card) table by table
  B4 the fused step   against cdae_tpu's Pallas kernel in interpret mode with
                      hash noise, corruption and negatives ON: both draw the
                      same masks by construction; and the port's unfused
                      dense step with fast_rng gives the same update

The kernels themselves are held against these plain versions on a GPU
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import dataclasses
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cdae_tpu_torch.models.cdae as tcdae
from cdae_tpu.ops.cdae_fused import _hash_uniform
from cdae_tpu.ops.cdae_fused import cdae_dense_step_fused as jfused
from cdae_tpu.ops.pallas_kernels import adagrad_update as jadagrad
from cdae_tpu.solver import optimizer as jopt
from cdae_tpu_torch.data.dataset import Interactions as TInteractions
from cdae_tpu_torch.ops import cdae_fused as tfused
from cdae_tpu_torch.ops import pallas_kernels as P

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [0, 12345, -7, 2**31 - 1, -2**31])
@pytest.mark.parametrize("draw", [0, 1])
def test_hw_uniform_plain_is_cdae_tpu_hash(seed, draw):
    R, C = 300, 700
    rows = jnp.broadcast_to(jnp.arange(R, dtype=jnp.int32)[:, None], (R, C))
    cols = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32)[None, :], (R, C))
    want = np.asarray(_hash_uniform(jnp.int32(seed), rows, cols, draw))
    for fn in (P.hw_uniform, P.hw_uniform_plain):
        got = fn(seed, (R, C), draw, device="cpu").numpy()
        np.testing.assert_array_equal(got, want)
    assert 0.0 <= want.min() and want.max() < 1.0


def test_hw_uniform_is_tiling_invariant():
    """A sub-block of a draw is the draw of the sub-block's coordinates:
    what lets the fused step regenerate the masks tile by tile."""
    full = P.hw_uniform(9, (40, 50), 1, device="cpu")
    assert full[:7, :11].equal(P.hw_uniform(9, (7, 11), 1, device="cpu"))
    assert P.hw_uniform(9, (0, 5), device="cpu").shape == (0, 5)


@pytest.fixture(scope="module")
def rng_np():
    return np.random.default_rng(11)


def test_adagrad_update_plain_matches_pallas(rng_np):
    N, D = 300, 17
    p = rng_np.standard_normal((N, D)).astype(np.float32)
    a = np.abs(rng_np.standard_normal((N, D))).astype(np.float32) + 1e-4
    g = rng_np.standard_normal((N, D)).astype(np.float32)
    # cdae_tpu's kernel donates param and acc, and jnp.asarray may alias a
    # numpy array's memory: the port's inputs are taken first, and the
    # donated buffers are copies that nothing else reads
    tp, ta = torch.from_numpy(p.copy()), torch.from_numpy(a.copy())
    want = jadagrad(jnp.array(p, copy=True), jnp.array(a, copy=True),
                    jnp.asarray(g), 0.1, 1.0, tile=128)
    got = P.adagrad_update(tp, ta, torch.from_numpy(g), 0.1, 1.0)
    assert got[0] is tp and got[1] is ta  # in place
    np.testing.assert_allclose(ta.numpy(), np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-6)


def test_adagrad_update_plain_1d_matches_pallas(rng_np):
    N = 97
    p = rng_np.standard_normal(N).astype(np.float32)
    a = np.full(N, 1e-4, np.float32)
    g = rng_np.standard_normal(N).astype(np.float32)
    tp = torch.from_numpy(p.copy())
    want = jadagrad(jnp.array(p, copy=True), jnp.array(a, copy=True),
                    jnp.asarray(g), 0.05, 0.0)
    P.adagrad_update_plain(tp, torch.from_numpy(a.copy()),
                           torch.from_numpy(g), 0.05, 0.0)
    assert tp.shape == (N,)
    np.testing.assert_allclose(tp.numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-6)


# B2 over the tables of one training step, at small widths: the tables of
# each path's dense sweep, a bf16 param among f32 ones, beta = 0, and an
# empty table between two others
_TABLE_SETS = {
    "cdae": ([(30, 5), (30,), (5,)], 1.0, ()),
    "cdae_asymmetric": ([(30, 5), (30,), (30, 5), (5,)], 1.0, ()),
    "warp": ([(20, 5), (30, 5), (30,)], 0.0, ()),
    "fism": ([(20,), (30, 5), (30,), (30, 5)], 0.0, ()),
    "bf16_param": ([(30, 5), (30,), (5,)], 1.0, (0, 2)),
    "empty_table": ([(30, 5), (0, 5), (30,)], 0.5, ()),
}


def _table_arrays(rng, shapes):
    return [(rng.standard_normal(s).astype(np.float32),
             np.abs(rng.standard_normal(s)).astype(np.float32) + 1e-4,
             rng.standard_normal(s).astype(np.float32)) for s in shapes]


@pytest.mark.parametrize("case", list(_TABLE_SETS))
def test_adagrad_update_tables_plain_matches_pallas(rng_np, case):
    """The list wrapper (its CPU route) and its plain version against
    cdae_tpu's Pallas kernel applied table by table (a bf16 param against
    cdae_tpu's dense_adagrad_step, the bf16 update the kernel stands for),
    with the tolerance of test_adagrad_update_plain_matches_pallas; empty
    tables are untouched."""
    shapes, beta, bf16 = _TABLE_SETS[case]
    arrays = _table_arrays(rng_np, shapes)
    want = []
    for k, (p, a, g) in enumerate(arrays):
        if not p.size:
            want.append(None)
            continue
        ja = jnp.array(a, copy=True)
        if k in bf16:  # the Pallas kernel takes f32 params only
            want.append(jopt.dense_adagrad_step(
                jnp.asarray(p).astype(jnp.bfloat16), ja, jnp.asarray(g), 0.1,
                beta))
        else:
            want.append(jadagrad(jnp.array(p, copy=True), ja, jnp.asarray(g),
                                 0.1, beta, tile=128))
    before = P.adagrad_update.launches
    for fn in (P.adagrad_update_tables, P.adagrad_update_tables_plain):
        tables = []
        for k, (p, a, g) in enumerate(arrays):
            tp = torch.from_numpy(p.copy())
            if k in bf16:
                tp = tp.to(torch.bfloat16)
            tables.append((tp, torch.from_numpy(a.copy()),
                           torch.from_numpy(g)))
        assert fn(tables, 0.1, beta) is None  # in place
        for k, ((tp, ta, _), w) in enumerate(zip(tables, want)):
            if w is None:
                assert tp.shape == (0, 5) and ta.shape == (0, 5)
                continue
            assert (tp.dtype == torch.bfloat16) == (k in bf16)
            np.testing.assert_allclose(ta.numpy(), np.asarray(w[1]),
                                       rtol=1e-6)
            np.testing.assert_allclose(
                tp.float().numpy(), np.asarray(w[0]).astype(np.float32),
                rtol=1e-5, atol=1e-6)
    assert P.adagrad_update.launches == before  # no kernel on the CPU
    assert P.adagrad_update_tables([], 0.1) is None


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("use_adagrad", [True, False])
def test_dense_adagrad_steps_equals_step_by_step(rng_np, use_kernel,
                                                 use_adagrad):
    """One dense_adagrad_steps call gives the bits of dense_adagrad_step on
    each table in turn: f32 and bf16 params, a bf16 grad, an empty
    table."""
    from cdae_tpu_torch.solver import optimizer as topt

    arrays = _table_arrays(rng_np, [(30, 5), (30,), (0, 5), (20, 5)])

    def tables():
        out = []
        for k, (p, a, g) in enumerate(arrays):
            tp, tg = torch.from_numpy(p.copy()), torch.from_numpy(g)
            out.append((tp.to(torch.bfloat16) if k == 1 else tp,
                        torch.from_numpy(a.copy()),
                        tg.to(torch.bfloat16) if k == 3 else tg))
        return out

    one, many = tables(), tables()
    for p, a, g in one:
        topt.dense_adagrad_step(p, a, g, 0.1, 0.5, use_adagrad, use_kernel)
    assert topt.dense_adagrad_steps(many, 0.1, 0.5, use_adagrad,
                                    use_kernel) is None
    for (p1, a1, _), (p2, a2, _) in zip(one, many):
        assert p1.dtype == p2.dtype
        assert torch.equal(p1, p2) and torch.equal(a1, a2)


@pytest.mark.parametrize("path,tables", [
    ("cdae", 3), ("cdae_asymmetric", 4), ("cdae_fused", 1), ("warp", 2),
    ("fism_slab", 4), ("fism_sparse", 4)])
def test_training_paths_sweep_their_tables_once_a_step(monkeypatch, path,
                                                       tables):
    """Each training step hands all its dense tables to ONE sweep call
    (one B2 launch on the card): CDAE's W, b' and b (and V), b alone
    after the fused step, WARP's uv and iv (its step leaves the biases,
    as warp.hpp does), FISM's bu, Q, bi and P on both routes."""
    from cdae_tpu_torch.data.synthetic import lowrank_interactions
    from cdae_tpu_torch.models.cdae import CDAE, CDAEConfig
    from cdae_tpu_torch.models.fism import FISM, FISMConfig
    from cdae_tpu_torch.models.mf import WARP, MFConfig

    from cdae_tpu_torch.solver import optimizer as topt

    calls = []

    def counted(fn):
        def call(tabs, *args):
            calls.append(len(tabs))
            return fn(tabs, *args)
        return call

    # the sweeps the optimizer calls, each call counted with its tables
    monkeypatch.setattr(topt, "pallas_kernels", types.SimpleNamespace(
        adagrad_update_tables=counted(P.adagrad_update_tables),
        adagrad_update_tables_plain=counted(P.adagrad_update_tables_plain)))
    data = lowrank_interactions(60, 80, 10, seed=3)
    if path.startswith("cdae"):
        model = CDAE(CDAEConfig(num_dim=6, corruption_ratio=0.5, num_neg=2,
                                batch_size=16,
                                asymmetric=path == "cdae_asymmetric",
                                fused_step=path == "cdae_fused"),
                     device="cpu")
    elif path == "warp":
        model = WARP(MFConfig(num_dim=6, batch_size=64, loss="HINGE",
                              beta=0.0, lambda_=0.1), device="cpu")
    else:
        model = FISM(FISMConfig(num_dim=6, num_neg=2, batch_size=16,
                                dense_mode=path == "fism_slab"),
                     device="cpu")
    state = model.reset(data, seed=1)
    model.train_one_iteration(state, 5)
    if path == "warp":
        steps = -(-len(data) // 64)
    elif path == "fism_sparse":
        steps = len(state.aux["sparse_batches"])
    else:
        steps = state.aux["dense_batches"][0].shape[0]
    assert steps > 1
    assert calls == [tables] * steps


def _fused_problem(act="sigmoid", D=12):
    rng = np.random.default_rng(0)
    B, I = 16, 70
    rows = (rng.random((B, I)) < 0.2).astype(np.int8)
    w_user = (rng.random(B) < 0.9).astype(np.float32)
    lengths = rows.sum(1).astype(np.float32) * w_user
    p_neg = np.clip(5 * lengths / np.maximum(I - lengths, 1.0), 0, 1)
    h_bias = (rng.standard_normal((B, D)) * 0.3).astype(np.float32)
    s = 4 * np.sqrt(6 / (I + D))
    W = rng.uniform(-s, s, (I, D)).astype(np.float32)
    W_ag = np.full((I, D), 1e-4, np.float32)
    bp = (rng.standard_normal(I) * 0.1).astype(np.float32)
    bp_ag = np.full(I, 1e-4, np.float32)
    return (rows, w_user, p_neg.astype(np.float32), h_bias, W, W_ag, bp,
            bp_ag)


def _atol(want) -> float:
    """1e-5 of the output's scale: the hidden gradient reaches ~50 here,
    and tanh's 1 - z*z cancels near |z| = 1, where the two frameworks'
    tanh differ by an ulp."""
    return 1e-5 * max(1.0, float(np.abs(np.asarray(want)).max()))


FUSED_CASES = [("SQUARE", "sigmoid"), ("CE", "sigmoid"), ("SQUARE", "tanh"),
               ("SQUARE", "linear")]


@pytest.mark.parametrize("loss,act", FUSED_CASES)
def test_fused_step_plain_matches_cdae_tpu(loss, act):
    arrays = _fused_problem(act)
    kw = dict(q=0.5, scale=2.0, lam=0.01, lr=0.1, beta=0.0, use_ada=True,
              act=act, loss_name=loss)
    want = jfused(jnp.int32(1234), *map(jnp.asarray, arrays), noise="hash",
                  **kw)
    ins = [torch.from_numpy(a.copy()) for a in arrays]
    got = tfused.cdae_dense_step_fused(1234, *ins, **kw)
    assert all(g is i for g, i in zip(got[:4], ins[4:]))  # in place
    names = ("W", "W_ag", "b_prime", "bp_ag", "hidden_grad")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=3e-4,
                                   atol=_atol(w), err_msg=name)


def _dense_model(**kw):
    rng = np.random.default_rng(3)
    U, I = 40, 70
    users, items = np.nonzero(rng.random((U, I)) < 0.15)
    cfg = tcdae.CDAEConfig(**{
        **dict(num_dim=12, loss="SQUARE", learn_rate=0.1, batch_size=16,
               dense_mode=True, num_neg=5, corruption_ratio=0.5), **kw})
    model = tcdae.CDAE(cfg, device="cpu")
    state = model.reset(TInteractions.from_arrays(
        users.astype(np.int32), items.astype(np.int32), num_users=U,
        num_items=I), seed=0)
    return model, state


@pytest.mark.parametrize("loss,act", FUSED_CASES)
def test_unfused_fast_rng_step_equals_fused_step(loss, act):
    """The unfused dense step with fast_rng draws hw_uniform's masks --
    the ones the fused step regenerates -- so both give one update."""
    kw = dict(loss=loss, tanh=act == "tanh", linear=act == "linear")
    model, state = _dense_model(**kw)
    uids, w = model._dense_batches(state)
    params = {k: v.clone() for k, v in state.params.items()}
    for fused in (False, True):
        cfg = dataclasses.replace(model.cfg, fused_step=fused, fast_rng=True)
        p = {k: v.clone() for k, v in params.items()}
        tcdae._dense_train_step(p, state.aux["dense_R"], uids[0], w[0], 77,
                                cfg=cfg, loss=model.loss,
                                coll=state.aux["coll"])
        if not fused:
            unfused = p
    for k in unfused:
        torch.testing.assert_close(p[k], unfused[k], rtol=3e-4,
                                   atol=_atol(unfused[k]), msg=k)


def test_fused_step_supported_surface_and_warning():
    base = dict(num_dim=8, loss="SQUARE")
    C = tcdae.CDAEConfig
    assert tcdae._fused_step_supported(C(**base))
    for kw in (dict(asymmetric=True), dict(linear_function=True),
               dict(compute_dtype=torch.bfloat16)):
        assert not tcdae._fused_step_supported(C(**base, **kw))
    assert not tcdae._use_fused_step(C(**base))  # None stays off
    assert not tcdae._use_fused_step(C(fused_step=False, **base))
    with pytest.warns(UserWarning, match="fused"):
        assert not tcdae._use_fused_step(C(fused_step=True, asymmetric=True,
                                           **base))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tcdae._use_fused_step(C(fused_step=True, **base))


def test_fused_model_epoch_routes_through_the_wrapper(monkeypatch):
    """fused_step=True with use_pallas on trains through the
    cdae_dense_step_fused wrapper (the plain version on the CPU); an
    unsupported config warns and runs the unfused step."""
    calls = []
    real = tfused.cdae_dense_step_fused

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tcdae, "cdae_dense_step_fused", spy)
    model, state = _dense_model(fused_step=True, use_pallas=True)
    model.train_one_iteration(state, seed=3)
    assert len(calls) == 3 and state.step == 1
    model, state = _dense_model(fused_step=True, use_pallas=True,
                                asymmetric=True)
    with pytest.warns(UserWarning, match="fused"):
        model.train_one_iteration(state, seed=3)
    assert len(calls) == 3


@pytest.mark.parametrize("B,I,sms", [
    (1024, 3706, 132), (1024, 20000, 132), (1, 5, 132), (37, 999, 132),
    (8192, 3706, 132), (1024, 3706, 8), (70, 300, 1),
])
def test_fused_step_grid(B, I, sms):
    """B4's grids: (user tiles of 64) x (catalog splits of whole 32-item
    chunks) for encode and decode, (item tiles of 32) x (user splits of
    whole 64-user chunks) for the grads; every split non-empty, the splits
    cover the batch and the catalog, at most two blocks an SM where a
    split can be cut, and at ML-1M's shape the grads fill a wave on 132
    SMs (more than its 116 item tiles)."""
    from cdae_tpu_torch.ops.cdae_fused import fused_step_grid

    splits, per_split, usplits, per_usplit = fused_step_grid(B, I, sms)
    assert per_split % 32 == 0 and per_usplit % 64 == 0
    assert (splits - 1) * per_split < I <= splits * per_split
    assert (usplits - 1) * per_usplit < B <= usplits * per_usplit
    user_tiles, item_tiles = -(-B // 64), -(-I // 32)
    assert splits == 1 or user_tiles * splits <= 2 * sms
    assert usplits == 1 or item_tiles * usplits <= 2 * sms
    if (B, I, sms) == (1024, 3706, 132):
        assert item_tiles * usplits >= 132 and user_tiles * splits >= 132

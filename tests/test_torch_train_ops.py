"""cdae_tpu_torch's losses, penalties, corruption and optimizer against
cdae_tpu's, on the same numpy inputs. The loss grid crosses every clamp:
the +-18 saturation, the +-80 exp caps, the logistic 1e-4 log floor and the
1e-7 clip."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdae_tpu.ops import corruption as jcorr
from cdae_tpu.ops import losses as jlosses
from cdae_tpu.ops import penalties as jpen
from cdae_tpu.solver import optimizer as jopt
from cdae_tpu_torch.ops import corruption as tcorr
from cdae_tpu_torch.ops import losses as tlosses
from cdae_tpu_torch.ops import penalties as tpen
from cdae_tpu_torch.solver import optimizer as topt

torch.set_num_threads(2)

LOSSES = [t.value for t in jlosses.LossType]
GRID = np.concatenate([
    np.linspace(-100.0, 100.0, 81), [-80.5, -80.0, -79.5, -18.001, -18.0,
                                     -17.999, 0.0, 1e-8, 1e-5, 5e-5, 1e-4,
                                     0.5, 0.9999, 1.0, 1.0001, 17.999, 18.0,
                                     18.001, 79.5, 80.0, 80.5],
]).astype(np.float32)


def _close(got: torch.Tensor, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("truth", [1.0, 0.0, -1.0])
def test_loss_matches_cdae_tpu(name, truth):
    jl, tl = jlosses.Loss.create(name), tlosses.Loss.create(name)
    assert (tl.name, tl.positive_label, tl.negative_label) == (
        jl.name, jl.positive_label, jl.negative_label)
    pred = torch.from_numpy(GRID)
    for f in ("evaluate", "gradient"):
        want = getattr(jl, f)(jnp.asarray(GRID), truth)
        got = getattr(tl, f)(pred, truth)
        _close(got, want)
        # a tensor truth gives the same as a scalar one
        _close(getattr(tl, f)(pred, torch.full_like(pred, truth)), want)
    _close(tl.predict(pred), jl.predict(jnp.asarray(GRID)))


def test_loss_aliases_and_parse():
    assert tlosses.Loss.create("ce") is tlosses.Loss.create("CROSS_ENTROPY")
    assert tlosses.Loss.create("SQ_HINGE").kind is (
        tlosses.LossType.SQUARED_HINGE)
    with pytest.raises(ValueError):
        tlosses.LossType.parse("NOPE")


@pytest.mark.parametrize("name", ["L1", "L2", "l2"])
def test_penalty_matches_cdae_tpu(name, rng):
    x = rng.standard_normal((17, 5)).astype(np.float32)
    want = float(jpen.Penalty.create(name).evaluate(jnp.asarray(x)))
    pen = tpen.Penalty.create(name)
    assert float(pen.evaluate(torch.from_numpy(x))) == pytest.approx(
        want, rel=1e-6)
    assert pen.is_smooth == (name.upper() == "L2")


def test_corruption_matches_cdae_tpu(rng):
    mask = rng.random((6, 9)) < 0.7
    u = rng.random((6, 9)).astype(np.float32)
    for ratio in (0.0, 0.3, 1.0):
        got = tcorr.corrupt_mask(torch.from_numpy(u), torch.from_numpy(mask),
                                 ratio)
        want = mask if ratio <= 0 else mask & (u > np.float32(ratio))
        np.testing.assert_array_equal(got.numpy(), want)
        for scaled in (True, False):
            assert tcorr.input_scale(ratio, scaled) == jcorr.input_scale(
                ratio, scaled)


def _tensors(*arrays):
    return tuple(torch.from_numpy(a.copy()) for a in arrays)


@pytest.mark.parametrize("use_adagrad", [True, False])
def test_dense_updates_match_cdae_tpu(rng, use_adagrad):
    p = rng.standard_normal((30, 7)).astype(np.float32)
    a = np.abs(rng.standard_normal((30, 7))).astype(np.float32) + 1e-4
    g = rng.standard_normal((30, 7)).astype(np.float32)
    for fn in ("adagrad_update", "dense_adagrad_step"):
        want = getattr(jopt, fn)(jnp.asarray(p), jnp.asarray(a),
                                 jnp.asarray(g), 0.1, 0.5, use_adagrad)
        tp, ta, tg = _tensors(p, a, g)
        got = getattr(topt, fn)(tp, ta, tg, 0.1, 0.5, use_adagrad)
        assert got[0] is tp and got[1] is ta  # in place
        _close(got[0], want[0], rtol=1e-6)
        _close(got[1], want[1], rtol=1e-6)


def test_dense_adagrad_step_bf16_param(rng):
    p = rng.standard_normal(50).astype(np.float32)
    a = np.full(50, 1e-4, np.float32)
    g = rng.standard_normal(50).astype(np.float32)
    want = jopt.dense_adagrad_step(jnp.asarray(p).astype(jnp.bfloat16),
                                   jnp.asarray(a), jnp.asarray(g), 0.05, 0.0)
    tp = torch.from_numpy(p).to(torch.bfloat16)
    for use_kernel in (False, True):  # the kernel wrapper's CPU route too
        got = topt.dense_adagrad_step(tp.clone(), torch.from_numpy(a.copy()),
                                      torch.from_numpy(g), 0.05, 0.0,
                                      use_kernel=use_kernel)
        assert got[0].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got[0].float().numpy(), np.asarray(want[0]).astype(np.float32))
        _close(got[1], want[1])


def test_adagrad_row_update_matches_cdae_tpu(rng):
    p = rng.standard_normal((12, 4)).astype(np.float32)
    a = np.full((12, 4), 1e-4, np.float32)
    rows = np.array([3, 0, 7, 11, 3], np.int32)  # the last is padding
    g = rng.standard_normal((5, 4)).astype(np.float32)
    w = np.array([1, 1, 1, 1, 0], np.float32)
    for ada in (True, False):
        want = jopt.adagrad_row_update(jnp.asarray(p), jnp.asarray(a),
                                       jnp.asarray(rows), jnp.asarray(g),
                                       jnp.asarray(w), 0.1, 0.0, ada)
        tp, ta, tg, tw = _tensors(p, a, g, w)
        got = topt.adagrad_row_update(tp, ta, torch.from_numpy(rows).long(),
                                      tg, tw, 0.1, 0.0, ada)
        _close(got[0], want[0])
        _close(got[1], want[1])


@pytest.mark.parametrize("use_adagrad", [True, False])
def test_row_adagrad_delta_sequential_duplicates(use_adagrad):
    """Duplicate row ids see SEQUENTIAL accumulator semantics: each touch
    includes the earlier touches' g^2 (tests/test_ops.py:527), against the
    per-touch loop and against cdae_tpu."""
    rng = np.random.default_rng(0)
    N, D = 7, 3
    rows = np.array([2, 5, 2, 2, 6, 5, 1, 0], np.int32)
    grads = rng.standard_normal((len(rows), D)).astype(np.float32)
    live = np.ones((len(rows), D), bool)
    live[7] = False  # a dead contribution moves nothing
    p0 = rng.standard_normal((N, D)).astype(np.float32)
    a0 = np.full((N, D), topt.ADAGRAD_INIT, np.float32)
    lr, beta = 0.1, 0.5

    tp, ta, tg = _tensors(p0, a0, grads)
    topt.row_adagrad_delta(tp, ta, torch.from_numpy(rows).long(), tg,
                           torch.from_numpy(live), lr, beta, use_adagrad)
    pe, ae = p0.copy(), a0.copy()
    for i, r in enumerate(rows):
        if not live[i].any():
            continue
        g = grads[i]
        if use_adagrad:
            ae[r] += g * g
            pe[r] -= lr * g / (beta + np.sqrt(ae[r]))
        else:
            pe[r] -= lr * g
    _close(ta, ae, rtol=1e-6)
    _close(tp, pe, rtol=1e-5)
    want = jopt.row_adagrad_delta(jnp.asarray(p0), jnp.asarray(a0),
                                  jnp.asarray(rows), jnp.asarray(grads),
                                  jnp.asarray(live), lr, beta, use_adagrad)
    _close(tp, want[0], rtol=1e-5)
    _close(ta, want[1], rtol=1e-6)


def test_row_adagrad_delta_first_touch_is_exact():
    """A row's first touch sees exactly acc + g^2, however large the g^2
    of the rows sorted before it (the prefix is a difference of exclusive
    cumsums, with no cancellation at a segment start)."""
    rows = torch.tensor([0, 1, 2, 3])
    g = torch.tensor([[3e3], [1e-3], [2e3], [1e-3]])
    p = torch.zeros((4, 1))
    a = torch.full((4, 1), topt.ADAGRAD_INIT)
    topt.row_adagrad_delta(p, a, rows, g, torch.ones((4, 1), dtype=bool),
                           1.0, 0.0)
    want = -g / torch.sqrt(topt.ADAGRAD_INIT + g * g)
    torch.testing.assert_close(p, want, rtol=1e-6, atol=0.0)


def test_inverse_time_decay_matches_cdae_tpu():
    for steps in (0, 10, 1e6):
        assert topt.inverse_time_decay(0.1, 0.01, steps) == pytest.approx(
            float(jopt.inverse_time_decay(0.1, 0.01, steps)), rel=1e-6)

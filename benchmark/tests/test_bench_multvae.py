"""The ``multvae_netflix.train`` cell: its model module and reference on
the CPU at a small size (a sound run comes out correct, the faults do
not, the control departs from the reference), and on the card at the
cell's own size (marked ``cuda``)."""

import time

import pytest
import torch

from benchmark.calibrate import readings
from benchmark.harness import compare, runner, spec
from cdae_tpu_torch.models import multvae as mv

CELL = "multvae_netflix.train"
CPU = torch.device("cpu")
# the cell cut to the CPU: 200 users x 300 items, 60-20-60, batches of 32
# (seven steps an epoch, the last of 8 users); every law and setting kept
SMALL = {"data": {"num_users": 200, "num_items": 300, "num_ratings": 4000},
         "multvae": {"hidden_dim": 60, "latent_dim": 20, "batch_size": 32}}


def _run(trace=False, seed=2**31 + 3):
    return runner.run_cell(CELL, seed, 0.3, trace, time.perf_counter(),
                           device="cpu", overrides=SMALL,
                           log=lambda msg: None)


def _setup(seed=2**31 + 99):
    cell = spec.load_cell(CELL, overrides=SMALL)
    ctx, driver = runner.prepare(cell, seed, CPU, lambda msg: None)
    driver.setup()
    return ctx, driver


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace):
    r = _run(trace)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0
    # on the CPU only the host's readings have anything to read
    names = set(r["metrics"])
    assert names == ({"train_step_mfu"} if trace
                     else {"train_users_per_s", "setup_s"})
    assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.parametrize("steps", [3, None])
def test_program_matches_the_reference_and_the_control_departs(
        steps, monkeypatch):
    """The compared stretch shorter than the epoch (3 of its 7 updates)
    and as long as it (the cell's 20 cut to the epoch's 7)."""
    if steps is not None:
        monkeypatch.setattr(spec.load_module("models", "multvae"),
                            "COMPARED_STEPS", steps)
    ctx, driver = _setup()
    want = driver.reference(CPU)
    sound = compare.training_gaps(driver.program, want)
    assert max(sound.values()) < 1e-6, sound
    assert compare.training_gaps(driver.reference(CPU), want) == {
        "grad_gap": 0.0, "change_gap": 0.0}
    low = compare.training_gaps(driver.reference(CPU, tf32=True), want)
    assert min(low.values()) > 1e-5, low
    half = compare.training_gaps(driver.reference(CPU, drop_half=True), want)
    assert half["grad_gap"] > 0.1, half


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    monkeypatch.setattr(mv.MultVAE, "train_one_iteration",
                        lambda self, state, seed=0, steps=None: state)
    r = _run()
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_each_batch_left_out_fails(monkeypatch):
    whole = mv._batch_users
    monkeypatch.setattr(mv, "_batch_users", lambda U, B: [
        (a, a + (b - a) // 2) for a, b in whole(U, B)])
    r = _run()
    assert not r["correct"]
    assert r["checks"]["grad_gap"]["value"] > 0.1


def test_unit_flops_by_hand():
    ctx, _ = _setup()
    # 200 users x (6 (60 * 40 + 20 * 60 + 60 * 300) + 4 * 300), plus
    # 4 * 60 for each of half the training pairs
    want = (200 * (6 * (2400 + 1200 + 18000) + 1200)
            + 4 * 60 * 0.5 * len(ctx.items))
    assert ctx.adapter.unit_flops(ctx) == pytest.approx(want)
    assert ctx.adapter.steps_per_unit(ctx) == 7


@pytest.mark.cuda
def test_fault_fails_the_limits_and_the_control_departs(cuda):
    """At the cell's size, through the harness's own readings: the sound
    program passes the limits, and the TF32 control and half of each
    batch left out each fail one of them at least."""
    limits = spec.load_cell(CELL).limits
    rows = {r["who"]: r for r in readings(CELL, 2**31 + 321, control=True,
                                          device="cuda")}

    def fails(row):
        return any(row[k] > limit for k, limit in limits.items())

    assert not fails(rows["program"]), rows["program"]
    assert fails(rows["control_tf32"]), rows["control_tf32"]
    assert fails(rows["fault_half_batch"]), rows["fault_half_batch"]

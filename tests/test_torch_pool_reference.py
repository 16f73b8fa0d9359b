"""The port's pooled sparse step (``CDAEConfig.neg_pool``) against the
benchmark's plain reference of it (benchmark/reference/cdae_pool.py) on
the CPU: one epoch from the same seeded weights, compared by leaf, with
two planted faults of the pool's law that must fail; the options the
reference refuses; and whole runs of the ``cdae_1m`` cells at a small
size."""

import time

import numpy as np
import pytest
import torch

from benchmark.harness import compare, runner, spec

torch.set_num_threads(2)

CPU = torch.device("cpu")
SEED = 2**31 + 77
# cdae_1m cut to the CPU: 257 users over 3,000 items (mean 51 picks a user
# as published, so the longest rows reach ~8% of the catalog and q_u's
# I / (I - |O_u|) factor is up to ~1.09), D 16, a pool of 512, every law
# and option of the configuration kept
SMALL = {"data": {"num_users": 257, "num_items": 3000,
                  "num_ratings": 257 * 51},
         "cdae": {"num_dim": 16, "batch_size": 64, "neg_pool": 512}}
# Both sides are float32 on the CPU and draw the same ids and uniforms;
# only the order of the sums differs (the port's (K, B) x (B, D) product
# and one aggregation per id vector against the reference's per-touch
# index_add_), which moves a leaf's norm by at most 4.3e-8 relative in one
# epoch here (the four cases). 1e-6 leaves that over a decade and sits
# under the cdae_1m cells' own limits (3e-6 on gradient norms), so a fault
# the cells would catch is caught here too; the two planted faults read
# 1.8e-2 and 3.1e-2.
TOL = 1e-6


def _cell(name, **cdae):
    return spec.load_cell(name, overrides={**SMALL,
                                           "cdae": {**SMALL["cdae"], **cdae}})


def _program(**cdae):
    """The port after its first epoch, built by the benchmark's adapter
    from the seeded data and weights; (context, its readings)."""
    ctx, _ = runner.prepare(_cell("cdae_1m.train", **cdae), SEED, CPU,
                            lambda msg: None)
    assert "dense_R" not in ctx.program.state.aux
    before = ctx.adapter.snapshot(ctx)
    ctx.adapter.train_unit(ctx)
    return ctx, ctx.adapter.program_readings(ctx, before)


def _worst(got, want):
    gaps = compare.leaf_gaps(got, want)
    return max(max(g.values()) for g in gaps.values())


@pytest.fixture(scope="module")
def square_hashed():
    return _program(loss="SQUARE", fast_rng=True)


@pytest.mark.parametrize("loss", ["SQUARE", "LOGISTIC"])
@pytest.mark.parametrize("fast_rng", [True, False])
def test_first_epoch_matches_the_reference_by_leaf(loss, fast_rng,
                                                   square_hashed):
    ctx, got = (square_hashed if (loss, fast_rng) == ("SQUARE", True)
                else _program(loss=loss, fast_rng=fast_rng))
    want = ctx.adapter.reference_readings(ctx, CPU)
    gaps = compare.leaf_gaps(got, want)
    for kind in ("grad", "change"):
        for leaf, gap in gaps[kind].items():
            assert gap < TOL, (kind, leaf, gap)
            assert want[0 if kind == "grad" else 1][leaf] > 0, leaf


def _keep_without_catalog_factor(lengths, I, K, num_neg):
    return torch.clamp(num_neg * lengths.to(torch.float32) / K, 0.0, 1.0)


def _rated_kept(items, pool, I):
    return torch.zeros((items.shape[0], pool.shape[0]), dtype=torch.bool,
                       device=items.device)


@pytest.mark.parametrize("name,fault", [
    ("keep_probability", _keep_without_catalog_factor),
    ("rated_in_pool", _rated_kept)])
def test_a_planted_fault_of_the_pool_fails(square_hashed, monkeypatch,
                                           name, fault):
    """q_u without its I / (I - |O_u|) factor, or rated pool ids kept as
    negatives: the reference so broken departs from the port by far more
    than the tolerance."""
    ctx, got = square_hashed
    ref = ctx.adapter.reference(ctx)
    monkeypatch.setattr(ref, name, fault)
    assert _worst(got, ctx.adapter.reference_readings(ctx, CPU)) > 10 * TOL


@pytest.mark.parametrize("option,value", [
    ("row_update", True), ("dense_mode", True), ("dense_mode", None),
    ("asymmetric", True), ("num_corruptions", 2), ("fast_rng", None),
    ("neg_pool", None), ("neg_pool", 0), ("loss", "HINGE"),
    ("bucket_by_length", False), ("fused_step", True)])
def test_check_config_refuses_what_the_reference_does_not_cover(option,
                                                                value):
    cell = _cell("cdae_1m.train")
    ref = spec.load_path(cell.config["reference"])
    ref.check_config(cell.config["cdae"])
    with pytest.raises(ValueError):
        ref.check_config({**cell.config["cdae"], option: value})


def test_the_reference_runs_with_tf32_off_and_restores_it(monkeypatch):
    cell = _cell("cdae_1m.train")
    ref = spec.load_path(cell.config["reference"])
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    seen = []
    monkeypatch.setattr(ref, "pool_step", lambda *a, **k: seen.append(
        (mm.allow_tf32, dnn.allow_tf32)))
    monkeypatch.setattr(mm, "allow_tf32", True)
    monkeypatch.setattr(dnn, "allow_tf32", True)
    rows = ref.Rows(np.array([0, 1]), np.array([3, 4]), 2, 8)
    P = {"W": torch.zeros(8, 2)}
    ref.train_epoch(P, cell.config["cdae"], rows, False, 1)
    assert seen and set(seen) == {(False, False)}
    assert (mm.allow_tf32, dnn.allow_tf32) == (True, True)


def _run(cell, trace=False):
    return runner.run_cell(cell, SEED, 0.3, trace, time.perf_counter(),
                           device="cpu", overrides=SMALL,
                           log=lambda msg: None)


@pytest.mark.parametrize("cell", ["cdae_1m.train", "cdae_1m.serve_batch"])
def test_a_cdae_1m_cell_runs_correct_and_traced(cell):
    r = _run(cell, trace=True)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0
    # on the CPU no device metric, nor a program reading, has anything to
    # read; the host ones have
    assert set(r["metrics"]) <= {"train_step_mfu", "serve_mfu",
                                 "request_p95_ms.batch"}


def test_half_of_each_batch_left_out_fails_the_train_cell(monkeypatch):
    from cdae_tpu_torch.models import cdae as cdae_mod

    step = cdae_mod._train_step

    def half(params, uids, items, mask, lengths, weight, seed, **kw):
        w = weight.clone()
        w[w.shape[0] // 2:] = 0
        return step(params, uids, items, mask & (w > 0)[:, None],
                    lengths * (w > 0), w, seed, **kw)

    monkeypatch.setattr(cdae_mod, "_train_step", half)
    r = _run("cdae_1m.train")
    assert not r["correct"]
    assert r["checks"]["grad_gap"]["value"] > 0.1


def test_an_altered_answer_fails_the_serve_cell(monkeypatch):
    from cdae_tpu_torch.models import cdae as cdae_mod

    served = cdae_mod.CDAE.recommend

    def altered(self, state, uids, train_data, k=10):
        ids = served(self, state, uids, train_data, k=k).clone()
        ids[0, 0] = (ids[0, 0] + 1) % state.num_items
        return ids

    monkeypatch.setattr(cdae_mod.CDAE, "recommend", altered)
    assert not _run("cdae_1m.serve_batch")["correct"]

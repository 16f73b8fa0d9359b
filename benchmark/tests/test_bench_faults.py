"""A whole run of each cell on the CPU at a small size (the harness's look
for a card skipped): sound, it comes out correct; with the timed path
broken underneath, not."""

import time

import pytest

from benchmark.harness import runner
from benchmark.tests.conftest import SMALL
from cdae_tpu_torch.models import cdae as cdae_mod

CELLS = ("cdae_ml20m.train", "cdae_ml10m.train", "cdae_ml20m.serve_batch",
         "cdae_ml20m.serve_online")
TRAIN = CELLS[:2]


def _run(cell, trace=False, seed=2**31 + 3):
    return runner.run_cell(cell, seed, 0.3, trace, time.perf_counter(),
                           device="cpu", overrides=SMALL,
                           log=lambda msg: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_fails(cell, monkeypatch):
    monkeypatch.setattr(cdae_mod.CDAE, "train_one_iteration",
                        lambda self, state, seed=0, draws=None: state)
    r = _run(cell)
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_each_batch_left_out_fails(cell, monkeypatch):
    sparse, dense = cdae_mod._train_step, cdae_mod._dense_train_step

    def half(w):
        w = w.clone()
        w[w.shape[0] // 2:] = 0
        return w

    def sparse_half(params, uids, items, mask, lengths, weight, seed, **kw):
        w = half(weight)
        return sparse(params, uids, items, mask & (w > 0)[:, None],
                      lengths * (w > 0), w, seed, **kw)

    def dense_half(params, dense_R, uids, weight, seed, **kw):
        return dense(params, dense_R, uids, half(weight), seed, **kw)

    monkeypatch.setattr(cdae_mod, "_train_step", sparse_half)
    monkeypatch.setattr(cdae_mod, "_dense_train_step", dense_half)
    r = _run(cell)
    assert not r["correct"]
    assert r["checks"]["grad_gap"]["value"] > 0.1


@pytest.mark.parametrize("cell", CELLS[2:])
def test_an_altered_answer_fails(cell, monkeypatch):
    served = cdae_mod.CDAE.recommend

    def altered(self, state, uids, train_data, k=10):
        ids = served(self, state, uids, train_data, k=k).clone()
        ids[0, 0] = (ids[0, 0] + 1) % state.num_items
        return ids

    monkeypatch.setattr(cdae_mod.CDAE, "recommend", altered)
    r = _run(cell)
    assert not r["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_metrics_and_breakdown(cell):
    r = _run(cell, trace=True)
    assert r["correct"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0
    # on the CPU no device metric has anything to read; the host ones have
    names = set(r["metrics"])
    assert names <= {"train_step_mfu", "serve_mfu", "request_p95_ms.batch",
                     "request_p95_ms.online"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert "setup_s" not in names


"""The port's spans, phases and counters (cdae_tpu_torch/utils/profiling.py):
the check that decides whether a profiler runs, the one range a span
opens, the shared no-op context and untouched tallies without one, the
spans of a training epoch (sparse, dense and fused routes; the pool's
span of a pooled step) and of a ``recommend``, nested as the program
calls them, the ``table_bytes`` counter of a step's update, a request's
rows built on its device, the set-up phases, the ``h2d_bytes`` counter,
and the benchmark's readers of the tallies (benchmark/metrics/)."""

import types

import numpy as np
import pytest
import torch

import cdae_tpu_torch.models.base as tbase
import cdae_tpu_torch.models.cdae as tcdae
from cdae_tpu_torch.data.dataset import Interactions
from cdae_tpu_torch.data.dataset import movielens_line_parser as tparser
from cdae_tpu_torch.models.base import RecsysModel
from cdae_tpu_torch.utils import profiling as prof

torch.set_num_threads(2)

CFG = dict(num_dim=8, loss="SQUARE", corruption_ratio=0.5, num_neg=2,
           batch_size=8)
STEP_CHILDREN = ("cdae.step.draws", "cdae.step.forward",
                 "cdae.step.scatter", "cdae.step.update")
SERVE_CHILDREN = ("serve.rows", "serve.scores", "serve.topk")


@pytest.fixture(scope="module")
def data(movielens_path):
    return Interactions.from_text(movielens_path, tparser)


@pytest.fixture(autouse=True)
def clean_tallies():
    prof.reset_tallies()
    yield
    prof.reset_tallies()


def _model(route):
    kw = {"sparse": dict(dense_mode=False),
          "dense": dict(dense_mode=True),
          "fused": dict(dense_mode=True, fast_rng=True, fused_step=True),
          "pool": dict(dense_mode=False, neg_pool=16),
          "pool_rows": dict(dense_mode=False, neg_pool=16, row_update=True),
          "rows": dict(dense_mode=False, row_update=True),
          }[route]
    return tcdae.CDAE(tcdae.CDAEConfig(**CFG, **kw), device="cpu")


def _steps(model, state):
    """Train steps of one epoch."""
    n = (len(state.aux["device_batches"]) if "dense_R" not in state.aux
         else state.aux["dense_batches"][0].shape[0])
    return n * model.cfg.num_corruptions


def _ranges(p):
    """name -> [(start, end)] of the profiler's host events."""
    out = {}
    for e in p.events():
        out.setdefault(e.name, []).append((e.time_range.start,
                                           e.time_range.end))
    return out


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_the_profiler_check_is_torchs_flag():
    assert prof.profiler_active() is False
    with torch.profiler.profile() as p:
        assert prof.profiler_active() is True
        assert torch.autograd.profiler._is_profiler_enabled is True
    assert prof.profiler_active() is False
    del p


def test_a_span_opens_torchs_fast_range():
    """The one range of spans and phases: torch's C++ RecordFunctionFast,
    a host event of the trace like a torch op."""
    assert prof._range is torch._C._profiler._RecordFunctionFast
    with torch.profiler.profile() as p:
        with prof.span("outer"):
            with prof.phase("inner"):
                torch.zeros(1)
    r = _ranges(p)
    (outer,), (inner,) = r["outer"], r["inner"]
    assert _inside(inner, outer)
    assert {n: c for n, (c, _) in prof.tallies().spans.items()} == {
        "outer": 1, "inner": 1}


def test_without_a_profiler_spans_are_one_shared_noop(data, monkeypatch):
    assert prof.span("a") is prof.span("b") is prof.span("cdae.step")
    model = _model("sparse")
    state = model.reset(data, seed=0)
    model.train_one_iteration(state, seed=1)  # builds the cached batches
    prof.reset_tallies()

    def forbidden(*a, **k):
        raise AssertionError("a span site read the clock or opened a range")

    monkeypatch.setattr(prof, "time", types.SimpleNamespace(
        perf_counter=forbidden))
    monkeypatch.setattr(prof, "_range", forbidden)
    model.train_one_iteration(state, seed=2)
    model.recommend(state, np.arange(8), data, k=5)
    prof.count("h2d_bytes", 1 << 20)
    assert prof.tallies() == prof.Tallies({}, {})


@pytest.mark.parametrize("route", ["sparse", "dense", "fused"])
def test_an_epoch_traces_one_step_span_per_step(data, route):
    model = _model(route)
    state = model.reset(data, seed=0)
    model.train_one_iteration(state, seed=1)
    prof.reset_tallies()
    with torch.profiler.profile() as p:
        model.train_one_iteration(state, seed=2)
    steps = _steps(model, state)
    r = _ranges(p)
    spans = prof.tallies().spans
    assert len(r["cdae.epoch"]) == 1 and spans["cdae.epoch"][0] == 1
    assert len(r["cdae.step"]) == spans["cdae.step"][0] == steps > 1
    assert all(_inside(s, r["cdae.epoch"][0]) for s in r["cdae.step"])
    want = {"sparse": STEP_CHILDREN, "dense": STEP_CHILDREN[:2]
            + STEP_CHILDREN[3:], "fused": ()}[route]
    for name in STEP_CHILDREN:
        got = r.get(name, [])
        if name not in want:
            assert not got, name
            continue
        # each child sits inside a step; the sparse step sums each of its
        # num_neg negative chunks and then the positives
        per_step = 1 + CFG["num_neg"] if name == "cdae.step.scatter" else 1
        assert len(got) == spans[name][0] == per_step * steps, name
        assert all(any(_inside(c, s) for s in r["cdae.step"]) for c in got)
    assert all(c > 0 and s >= 0 for c, s in spans.values())


@pytest.mark.parametrize("route", ["pool", "pool_rows", "sparse", "dense",
                                   "fused"])
def test_the_pool_span_nests_in_forward_once_a_pooled_step(data, route):
    """``cdae.step.pool``: once a pooled step, inside its forward span, the
    pool's aggregation inside it (none with row_update, which aggregates
    nothing there); on the exact, dense and fused routes never."""
    model = _model(route)
    state = model.reset(data, seed=0)
    model.train_one_iteration(state, seed=1)
    prof.reset_tallies()
    with torch.profiler.profile() as p:
        model.train_one_iteration(state, seed=2)
    r = _ranges(p)
    pools = r.get("cdae.step.pool", [])
    if not route.startswith("pool"):
        assert not pools and "cdae.step.pool" not in prof.tallies().spans
        return
    steps = _steps(model, state)
    assert len(pools) == prof.tallies().spans["cdae.step.pool"][0] == steps
    assert all(any(_inside(c, f) for f in r["cdae.step.forward"])
               for c in pools)
    scatters = r.get("cdae.step.scatter", [])
    inner = [c for c in scatters if any(_inside(c, s) for s in pools)]
    assert len(inner) == (steps if route == "pool" else 0)


def _table_bytes_by_hand(model, state):
    """An epoch's item-table bytes of the AdaGrad apply, from the batches'
    shapes: every element of W and b' (f32 param, accumulator and
    gradient: 4 + 4 + 4 + 4 + 4 bytes) each step; with row_update, the
    rows the step passes instead: the positives' output rows, the
    negatives' rows, b' at both, the positives' input rows."""
    I, D = state.num_items, model.cfg.num_dim
    total = 0
    for _, items, *_ in state.aux["device_batches"]:
        if not model.cfg.row_update:
            total += 20 * I * (D + 1)
            continue
        BL = items.numel()
        negs = (model.cfg.neg_pool if model.cfg.neg_pool
                else model.cfg.num_neg * BL)
        total += 20 * ((2 * BL + negs) * D + BL + negs)
    return total


@pytest.mark.parametrize("route", ["pool", "pool_rows", "sparse", "rows"])
def test_table_bytes_is_reckoned_from_the_tables_shapes(data, route):
    model = _model(route)
    state = model.reset(data, seed=0)
    model.train_one_iteration(state, seed=1)
    assert "table_bytes" not in prof.tallies().counters
    with torch.profiler.profile():
        model.train_one_iteration(state, seed=2)
    assert prof.tallies().counters["table_bytes"] == _table_bytes_by_hand(
        model, state)


@pytest.mark.parametrize("route", ["pool", "pool_rows"])
def test_without_a_profiler_a_pooled_epoch_tallies_nothing(data, route,
                                                           monkeypatch):
    model = _model(route)
    state = model.reset(data, seed=0)
    model.train_one_iteration(state, seed=1)  # builds the cached batches
    prof.reset_tallies()

    def forbidden(*a, **k):
        raise AssertionError("a span site read the clock or opened a range")

    monkeypatch.setattr(prof, "time", types.SimpleNamespace(
        perf_counter=forbidden))
    monkeypatch.setattr(prof, "_range", forbidden)
    model.train_one_iteration(state, seed=2)
    assert prof.tallies() == prof.Tallies({}, {})


def test_a_request_traces_its_rows_scores_and_topk(data):
    model = _model("sparse")
    state = model.reset(data, seed=0)
    prof.reset_tallies()
    with torch.profiler.profile() as p:
        model.recommend(state, np.arange(8), data, k=5)
    r = _ranges(p)
    assert len(r["serve.request"]) == 1
    request = r["serve.request"][0]
    ends = []
    for name in SERVE_CHILDREN:
        (child,) = r[name]
        assert _inside(child, request), name
        ends.append(child)
    assert ends == sorted(ends)  # rows, then scores, then top-k
    assert set(prof.tallies().spans) == {"serve.request", *SERVE_CHILDREN}


def test_rows_device_counts_one_per_request(data, monkeypatch):
    """Every request builds its rated rows on the model's device: one
    ``csr_rows`` call on the model's device a ``recommend``, as many as
    ``serve.request`` counts under a profiler, and one without it."""
    model = _model("sparse")
    state = model.reset(data, seed=0)
    calls, real = [], tbase.csr_rows

    def csr_rows(indptr, indices, uids, *a, **kw):
        calls.append(uids.device)
        return real(indptr, indices, uids, *a, **kw)

    monkeypatch.setattr(tbase, "csr_rows", csr_rows)
    model.recommend(state, np.arange(8), data, k=5)
    assert calls == [model.device]
    with torch.profiler.profile():
        for n in (8, 1, 24):
            model.recommend(state, np.arange(n)[::-1], data, k=5)
    t = prof.tallies()
    assert len(calls) - 1 == t.spans["serve.request"][0] == 3
    assert set(calls) == {model.device}


def test_set_up_phases_tally_once_per_build(data):
    fresh = Interactions(data.users, data.items, data.ratings,
                         data.num_users, data.num_items)
    model = _model("dense")
    state = model.reset(fresh, seed=0)
    spans = prof.tallies().spans
    for name in ("cdae.reset", "data.csr", "data.padded", "cdae.dense_R"):
        assert spans[name][0] == 1 and spans[name][1] > 0, name
    # read after a reset, the tallies are the set-up's breakdown: the
    # children's seconds lie within their parent's
    children = ("data.csr", "data.padded", "cdae.dense_R")
    assert spans["cdae.reset"][1] >= sum(spans[n][1] for n in children)
    fresh.csr()  # cached: no build, no tally
    model.train_one_iteration(state, seed=1)
    model.train_one_iteration(state, seed=2)
    model.reset(fresh, seed=0)
    spans = prof.tallies().spans
    assert spans["cdae.reset"][0] == 2
    assert spans["data.csr"][0] == 1
    assert spans["cdae.batches"][0] == 1  # built in the first epoch only
    assert "cdae.step" not in spans  # no profiler ran


def test_h2d_bytes_counts_host_arrays_bound_for_a_cuda_device(monkeypatch):
    model = RecsysModel()
    model.device = torch.device("cuda")
    monkeypatch.setattr(torch, "as_tensor",
                        lambda x, dtype=None, device=None: x)
    ids = np.zeros((4, 5), np.int32)
    mask = np.ones((4, 5), bool)
    model._tensor(ids)
    assert prof.tallies().counters == {}
    with torch.profiler.profile():
        model._tensor(ids)
        model._tensor(mask)
        model._tensor(torch.zeros(3))  # a tensor already: not counted
    assert prof.tallies().counters == {"h2d_bytes": 80 + 20}
    model.device = torch.device("cpu")
    with torch.profiler.profile():
        model._tensor(ids)
    assert prof.tallies().counters == {"h2d_bytes": 100}


# ------------------------------------------------ the benchmark's readers --

READINGS = [
    # (metric, kind, spans, counters, expected)
    ("train_step_host_ms", "train", {"cdae.step": (4, 0.02)}, {}, 5.0),
    ("serve_rows_host_ms", "serve",
     {"serve.rows": (8, 0.004), "serve.request": (8, 0.01)}, {}, 0.5),
    ("serve_h2d_bytes_per_request", "serve", {"serve.request": (8, 0.01)},
     {"h2d_bytes": 4096}, 512.0),
    ("setup_data_s", "train", {"cdae.reset": (1, 2.5),
                               "cdae.batches": (1, 0.5)}, {}, 3.0),
    ("setup_data_s", "serve", {"cdae.reset": (1, 2.5)}, {}, 2.5),
    ("train_pool_host_ms", "train", {"cdae.step": (4, 0.02),
                                     "cdae.step.pool": (4, 0.008)}, {}, 2.0),
    ("train_table_bytes_per_step", "train", {"cdae.step": (4, 0.02)},
     {"table_bytes": 4096}, 1024.0),
]


def _reader(name):
    from benchmark.harness import spec

    return spec.metric_reader(name)


def _context(kind, busy_s=0.5):
    from benchmark.harness.runner import TraceContext

    return TraceContext(kind=kind, trace=types.SimpleNamespace(busy_s=busy_s),
                        units=1, roofline=None, window_s=1.0,
                        window_flops=0.0, window_metrics={})


@pytest.mark.parametrize("name,kind,spans,counters,want", READINGS)
def test_readers_read_the_tallies(monkeypatch, name, kind, spans, counters,
                                  want):
    monkeypatch.setattr(prof, "tallies",
                        lambda: prof.Tallies(spans, counters))
    assert _reader(name)(_context(kind)) == pytest.approx(want)
    # no work on the device, nothing tallied, the other kind of cell, or a
    # program without tallies
    assert _reader(name)(_context(kind, busy_s=0.0)) is None
    monkeypatch.setattr(prof, "tallies", lambda: prof.Tallies({}, {}))
    assert _reader(name)(_context(kind)) is None
    other = "serve" if kind == "train" else "train"
    if name != "setup_data_s":
        monkeypatch.setattr(prof, "tallies",
                            lambda: prof.Tallies(spans, counters))
        assert _reader(name)(_context(other)) is None
    monkeypatch.delattr(prof, "tallies")
    assert _reader(name)(_context(kind)) is None

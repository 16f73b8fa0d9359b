import numpy as np
import pytest
import torch

from benchmark.harness import counts, trace
from benchmark.harness.spec import load_cell
from benchmark.tests.conftest import SMALL


def test_least_seconds_takes_the_larger_bound():
    # 3.35 GB at 3.35 TB/s: 1 ms; 495 GFLOP of products: 1 ms
    assert counts.least_seconds(3.35e9) == pytest.approx(1e-3)
    assert counts.least_seconds(1.0, products=495e9) == pytest.approx(1e-3)
    assert counts.least_seconds(1.0, products=495e9, other_ops=67e9) == \
        pytest.approx(2e-3)
    assert counts.least_seconds(3.35e9, other_ops=67e6) == pytest.approx(1e-3)


def test_train_user_flops_by_hand():
    # n = 10 positives, q = 0.5: 5 kept, 5 * 10 = 50 negatives, D = 4:
    # 4 * (4 * 5 + 6 * 60 + 4) = 1536
    assert counts.train_user_flops(np.array([10]), 4, 5, 0.5)[0] == 1536.0


def test_serve_flops_by_hand():
    # two users, 3 and 5 rated, I = 7, D = 2: 2 * (2*n + 2 + 14) per user
    assert counts.serve_flops(np.array([3, 5]), 7, 2) == 2 * (22 + 26)


def test_dense_and_sparse_steps_count_the_same_needed_work():
    """The needed FLOPs depend on the cell's rows, not on the route: the
    same data trained by the dense and by the sparse step count alike."""
    from benchmark.harness import runner

    got = []
    for dense in (True, False):
        cell = load_cell("cdae_ml20m.train", overrides={
            **SMALL, "cdae": {**SMALL["cdae"], "dense_mode": dense}})
        ctx, driver = runner.prepare(cell, 5, torch.device("cpu"),
                                     lambda msg: None)
        driver.setup()
        assert ("dense_R" in ctx.program.state.aux) == dense
        got.append(driver.unit_flops)
    assert got[0] == got[1] > 0


def _t(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype)


def test_kernel_counts_by_hand():
    assert counts.hw_uniform({"shape": (4, 8)}) == dict(
        bytes=128, products=0.0, ops=512.0)
    d = counts.decode_scores({"z": _t(2, 3), "W": _t(5, 3), "b_prime": _t(5)})
    assert d["bytes"] == 4 * (6 + 15 + 5 + 10) and d["products"] == 60.0
    a = counts.adagrad_tables({"tables": [(_t(3, 2), _t(3, 2), _t(3, 2)),
                                          (_t(4), _t(4), _t(4))]})
    assert a["bytes"] == 20 * 6 + 20 * 4 and a["ops"] == 70.0
    p = counts.scatter_plan({"idx": _t(10, dtype=torch.int64),
                             "num_rows": 6})
    assert p["bytes"] == 80 + 40 + 28
    r = counts.scatter_matmul({"vals": _t(10, 3), "num_rows": 6})
    assert r["bytes"] == 120 + 40 + 28 + 72 and r["ops"] == 30.0
    g = counts.gather_rows_mxu({"table": _t(9, 4),
                                "idx": _t(5, dtype=torch.int64)})
    assert g["bytes"] == 40 + 2 * 5 * 16
    f = counts.fused_topk_scores({"z": _t(2, 3), "W": _t(5, 3), "k": 2,
                                  "rated_rows": _t(2, 5, dtype=torch.int8)})
    assert f["bytes"] == 4 * (6 + 15 + 5) + 10 + 32


def test_every_counted_wrapper_exists_in_the_program():
    from cdae_tpu_torch.ops import cdae_fused, pallas_kernels

    for name in counts.KERNELS:
        assert (hasattr(pallas_kernels, name)
                or hasattr(cdae_fused, name)), name


def test_kernel_base_name():
    assert trace.kernel_base_name(
        "void (anonymous namespace)::decode_scores_kernel<4, 16, 2>("
        "float const*, float const*)") == "decode_scores_kernel"
    assert trace.kernel_base_name("hw_uniform_kernel(float*, int)") == \
        "hw_uniform_kernel"
    assert trace.kernel_base_name(
        "void at::native::reduce_kernel<512, 1>(int)") == "reduce_kernel"


def test_chrome_events_and_reduce_busy_idle_roofline():
    X = dict(ph="X", pid=1)
    events = [
        dict(X, cat="user_annotation", name="bench.traced", tid=7, ts=0,
             dur=1000),
        dict(X, cat="cpu_op", name="aten::mul", tid=7, ts=100, dur=200),
        dict(X, cat="cpu_op", name="other thread", tid=8, ts=0, dur=1000),
        dict(X, cat="kernel", tid=0, ts=0, dur=200,
             name="void (anonymous namespace)::hw_uniform_kernel(float*)"),
        dict(X, cat="kernel", name="elementwise_kernel", tid=0, ts=150,
             dur=100),  # overlaps: busy 0-250
        dict(X, cat="gpu_memcpy", name="Memcpy HtoD", tid=0, ts=600,
             dur=100),
        dict(X, cat="gpu_user_annotation", name="bench.epoch", tid=0, ts=0,
             dur=1000),
        dict(ph="M", name="thread_name", tid=7, ts=0),
    ]
    dev, host, window = trace.chrome_events(events)
    assert window == (0.0, 1000.0)
    assert {h[2] for h in host} == {"bench.traced", "aten::mul"}
    t = trace.reduce_events(dev, host, window, 1e-3)
    assert t.busy_s == pytest.approx(350e-6)
    assert t.kernels == 2
    # gaps 250-600 and 700-1000 us: the host was in no op but the span
    assert t.idle_by_host == pytest.approx({"bench.traced": 650e-6})
    # B1 ran 200 us; one call of (1000, 1000) uniforms needs 4 MB: 1.194 us
    least = counts.call_least_seconds("hw_uniform", {"shape": (1000, 1000)})
    share = trace.kernel_roofline({"hw_uniform": least}, 2.0, t)
    assert share == pytest.approx(100 * 2 * least / 200e-6)
    assert trace.kernel_roofline({}, 1.0, t) is None


def test_innermost_host_event_by_sweep():
    host = [(0, 100, "outer"), (10, 20, "a"), (12, 15, "a.inner"),
            (30, 60, "b"), (70, 80, "c")]
    got = trace.innermost_at(host, [13, 17, 25, 40, 75, 99, 150, 5])
    assert got == ["a.inner", "a", "outer", "b", "c", "outer", None,
                   "outer"]

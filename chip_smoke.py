#!/usr/bin/env python3
"""Drive cdae_tpu_torch once on one CUDA GPU and check what comes out.

Phases, each printed as one JSON line:
  build   -- compile the CUDA kernels from cdae_tpu_torch/csrc (nvcc, one
             process per source, in parallel)
  kernel  -- each kernel against its plain PyTorch version on the card, at
             the shapes its path gives it; error, median spans and device
             time (device_ms; beside the library call's where one exists),
             for every kernel here and in the phases below; the fused step
             (B4) also the same bits on a second launch, and B4, B5 and B6
             one call under torch.profiler (each launch's span)
  serving path (counts from 0 before slice, read after dense_1m):
    slice   -- ML-1M-scale CDAE serving at D=50 through the CLI --task test
               (dense_R encode + decode kernel + TOPN), checked against the
               plain path on the same checkpoint
    csr_1m  -- 20,000 users x 1,000,000 items through the TOPN evaluator:
               no dense_R, so the fused CSR top-k kernel serves
    dense_1m-- 1,000 users x 1,000,000 items, batch_size 64 so the 1 GB
               int8 dense_R stays resident: the fused dense top-k kernel
  verify  -- one batch of each 1M-item run: kernel ids against the plain
             streaming scan
  training path (counts from 0 before, read after):
    train_ml1m -- ML-1M-scale low-rank data, D=50, 10 epochs through the CLI
               --task train (hw_uniform masks, adagrad_update sweeps); R@10
               must rise; then one epoch with the kernels against one with
               the plain versions from the same reset
  fused training path (counts from 0 before, read after):
    train_ml1m_fused -- the same 10 epochs with fused_step=True through
               Solver.train: R@10 within 0.02 of the unfused run
  train_speed -- warm training users/s, unfused and fused: ML-1M (D=50)
             and config-4 (50,000 x 20,000, D=200, 1 GB dense_R)
  kernel_warp -- the WARP violator kernel (B7) against its plain version at
             (B, I, D, nn) = (8192, 3706, 10, 5) and (8192, 20000, 10, 5),
             both noises, its span and device time (and its device time
             with no violator), and the chi-square of its picks
  WARP training path (counts from 0 before, read after; B7, B8 and B2):
    train_warp -- ML-1M-scale low-rank data, D=10, batch 8192, 10 epochs
             through the CLI --task train --method WARP; R@10 must rise
  train_warp_xla -- the same 10 epochs with use_pallas=False (the cumsum
             route): R@10 within 0.03 of the kernel run
  train_speed_warp -- warm WARP training users/s: the kernel route (its
             default scatter_mode "auto" runs B8), the same with
             index_add_ (scatter_mode "scatter"), and the cumsum route
  kernel_scatter -- the row aggregation (B8: its plan, then its reduce)
             against its plain version at a FISM sparse step's shapes (the
             largest batch of the run's data, sentinel ids included, 2-D
             and 1-D values) and WARP's, f32 and bf16 contributions; the
             plan equal to its plain version, two launches the same bits,
             and P's sums over the shared Q + b_i plan the same bits as over
             their own; the plan and the reduce timed apart, beside
             torch.sort of the int64 ids and index_add_
  kernel_gather -- the row gather (B9) exactly equal to its plain version
             at WARP's shapes; out-of-range ids give zero rows; its span,
             device time and host time beside index_select's
  FISM training path (counts from 0 before train_fism, read after
  train_fism_sparse; B8, B2):
    train_fism -- the same low-rank data, D=10, 10 epochs through the CLI
             --task train --method FISM: the dense-slab route (B2)
    train_fism_sparse -- the same 10 epochs with dense_mode=False through
             SGDSolver.train: the sparse route, whose sums are B8's; R@10
             within 0.15 of train_fism's
  fism_sparse_checks -- one sparse epoch with B8 against one with its
             plain version (index_add) from the same reset and draws, and
             two 2-epoch runs bit for bit
  train_speed_fism -- warm FISM training users/s, both routes, with
             launches, B8 plans and B8 reduces a step
  WARP with B8 and B9 (counts from 0 before, read after; B9, B8, B7, B2):
    train_warp_mxu -- 2 epochs of train_warp's configuration with
             gather_mode="mxu" and scatter_mode="pallas"
  warp_mxu_vs_native -- the same 2 epochs with the native gather and
             B8 (bit for bit); the default route (scatter_mode "auto",
             which runs B8) twice, bit for bit equal to itself and to the
             mxu route; and with the native gather and index_add (one step
             within 1e-4; the 2-epoch distance and that route's own
             run-to-run spread printed, not gated)
Then the whole run's wall time, the kernel table (each kernel's launches
from the path that owns it; B8's plan has a row of its own; a kernel timed
at several shapes lists them all under ``shapes``; bound_ms is the least
time for the kernel's work at the card's published peaks: HBM bytes at
3.35 TB/s against 32-bit operations at 67 T/s, or, for B3, B4, B5 and B6,
which multiply on the tensor cores in 3xTF32, three TF32 products per f32
one at 495 T/s, with the f32 figure beside it as bound_f32_ms), the
card's name and power limit, and, last, the ok line.
Any failed phase makes the exit code 1 and leaves out the ok line. Without
a CUDA GPU, or without the repository beside it, the script exits 2 and
prints no result.

Run from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

SEED = 20141119
TOL = 1e-4  # f32 sums in another order than the library GEMM
# the fused step against its plain version: rtol 3e-4 and atol 1e-5 times
# the output's scale (max(1, max |plain|)) -- cdae_tpu's own fused-step
# tolerance, with atol raised in proportion for the AdaGrad accumulators,
# sums of squared gradients that reach ~1e5 in one step
FUSED_RTOL, FUSED_ATOL = 3e-4, 1e-5
FUSED_OUTPUTS = ("W", "W_ag", "b_prime", "bp_ag", "hg")
WARP_R10_GATE = 0.03  # the kernel and cumsum routes' R@10 (BASELINE.md)
# the dense and sparse FISM routes' R@10 (tests/test_models_generic.py's
# dense-vs-sparse gate)
FISM_R10_GATE = 0.15
# B8 against its plain version: rtol, and atol times the largest row sum
# (the two sum in different orders)
ROWS_RTOL, ROWS_ATOL = 1e-5, 1e-6
ROUTE_REL_TOL = 1e-4  # two routes' params: ||a - b|| / ||b|| per table
WARP_CHI2_BOUND = 330.0  # tests/test_pallas.py's pooled bound, dof 255
# the published peaks of an H100 SXM at 700 W: HBM bytes, and 32-bit
# operations outside the tensor cores (67 TFLOP/s f32, an FMA counted as
# two; integer operations are counted against the same rate, which makes
# the bound lower than Hopper's 64 INT32 lanes per SM allow)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12  # dense TF32 on the tensor cores

# name -> (module of the wrapper, source, TPU kernel it replaces, paths
# that must launch it; the first owns the table's launch count)
KERNELS = {
    "decode_scores": ("pallas_kernels", "cdae_tpu_torch/csrc/decode_scores.cu",
                      "cdae_tpu/ops/pallas_kernels.py:53", ("serving",)),
    "fused_topk_scores": ("pallas_kernels",
                          "cdae_tpu_torch/csrc/fused_topk.cu",
                          "cdae_tpu/ops/pallas_kernels.py:557",
                          ("serving",)),
    "fused_topk_scores_csr": ("pallas_kernels",
                              "cdae_tpu_torch/csrc/fused_topk.cu",
                              "cdae_tpu/ops/pallas_kernels.py:641",
                              ("serving",)),
    "hw_uniform": ("pallas_kernels", "cdae_tpu_torch/csrc/hw_uniform.cu",
                   "cdae_tpu/ops/pallas_kernels.py:178", ("training",)),
    "adagrad_update": ("pallas_kernels",
                       "cdae_tpu_torch/csrc/adagrad_update.cu",
                       "cdae_tpu/ops/pallas_kernels.py:108",
                       ("training", "warp_training", "fism_training",
                        "warp_mxu")),
    "cdae_dense_step_fused": ("cdae_fused", "cdae_tpu_torch/csrc/cdae_fused.cu",
                              "cdae_tpu/ops/cdae_fused.py:249",
                              ("fused_training",)),
    "warp_violator_select": ("pallas_kernels",
                             "cdae_tpu_torch/csrc/warp_select.cu",
                             "cdae_tpu/ops/pallas_kernels.py:1028",
                             ("warp_training", "warp_mxu")),
    # WARP's default route sums through B8 too (scatter_mode "auto")
    "scatter_matmul": ("pallas_kernels", "cdae_tpu_torch/csrc/scatter_rows.cu",
                       "cdae_tpu/ops/pallas_kernels.py:1147",
                       ("fism_training", "warp_training", "warp_mxu")),
    # B8's id sort (the TPU kernel contracts one-hot tiles and sorts
    # nothing): a wrapper and a count of its own
    "scatter_plan": ("pallas_kernels", "cdae_tpu_torch/csrc/scatter_rows.cu",
                     "cdae_tpu/ops/pallas_kernels.py:1147",
                     ("fism_training", "warp_training", "warp_mxu")),
    "gather_rows_mxu": ("pallas_kernels", "cdae_tpu_torch/csrc/gather_rows.cu",
                        "cdae_tpu/ops/pallas_kernels.py:856", ("warp_mxu",)),
}


def wrapper(name):
    """The wrapper function of a kernel (it carries ``.launches``)."""
    import importlib

    module = importlib.import_module(f"cdae_tpu_torch.ops.{KERNELS[name][0]}")
    return getattr(module, name)


def reset_counts(path: str) -> None:
    for name, spec in KERNELS.items():
        if path in spec[3]:
            wrapper(name).launches = 0


def read_counts(path: str, launches: dict, failed: list) -> None:
    """Record the launch counts of ``path``'s kernels in
    ``launches[name][path]``; a kernel of the path that never launched
    fails the run."""
    for name, spec in KERNELS.items():
        if path not in spec[3]:
            continue
        n = launches.setdefault(name, {})[path] = wrapper(name).launches
        if n == 0:
            emit(dict(phase="launches", path=path, kernel=name, ok=False,
                      error="the main path never launched this kernel"))
            failed.append(f"launches:{name}")


# a row's shape keys and measurements, as the kernel table repeats them
SHAPE_KEYS = ("B", "I", "D", "k", "nn", "shape", "case", "P", "N", "C")
MEASURE_KEYS = ("max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "bound_f32_ms")


def record(results, name, row) -> None:
    """Keep a kernel's row: the first shape's is the kernel's own in the
    table, and every shape's row is listed under it (``shapes``)."""
    results.setdefault(name, row)
    results.setdefault("_shapes", {}).setdefault(name, []).append(row)


def shape_summary(row) -> dict:
    out = {k: row[k] for k in SHAPE_KEYS + MEASURE_KEYS if k in row}
    if isinstance(out.get("device_ms"), dict):  # B8's: its span's
        out["device_ms"] = out["device_ms"].get("span")
    return out


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, ops: float, ops_per_s: float = OPS_PER_S) -> dict:
    """The least time the card could take for work that must move
    ``nbytes`` through HBM and do ``ops`` operations at ``ops_per_s``
    (default: 32-bit operations outside the tensor cores): the larger of
    the two times at the published peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return dict(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def median_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), after
    one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: ``reps`` calls queued behind a
    busy-wait kernel of some 10 ms, so that the host has queued them all
    before the card starts them, timed by CUDA events around the calls.
    Where the host takes longer to launch than the card to run, median_ms
    measures the host; this measures the card, the gaps between dependent
    launches included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # cycles: ~10 ms at the H100's clock
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def topk_agreement(ids, vals, plain_ids, plain_vals, k):
    """Compare a kernel's top-k with its plain version computed for k+1:
    the id sets must agree on every row whose plain gap between the k-th
    and (k+1)-th score exceeds TOL; values must agree to TOL everywhere.
    Returns (max_abs_err, rows_checked, rows_with_other_ids)."""
    import torch

    gap = plain_vals[:, k - 1] - plain_vals[:, k]
    sure = gap > TOL
    same = (torch.sort(ids, dim=1).values
            == torch.sort(plain_ids[:, :k], dim=1).values).all(dim=1)
    err = (vals - plain_vals[:, :k]).abs().max().item()
    return err, int(sure.sum()), int((sure & ~same).sum())


def phase_kernels(torch, P, results):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    # B3 decode_scores at the ML-1M (D=50) and config-4-width (D=200) shapes
    for B, I, D in ((1024, 3706, 50), (1024, 20000, 200)):
        z = torch.rand(B, D, generator=g, device=dev)
        W, bp = normal(I, D, scale=0.1), normal(I, scale=0.1)
        out = P.decode_scores(z, W, bp)
        ref = P.decode_scores_plain(z, W, bp)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        row = dict(phase="kernel", kernel="decode_scores", B=B, I=I, D=D,
                   max_abs_err=err, tol=TOL,
                   ms=median_ms(lambda: P.decode_scores(z, W, bp)),
                   plain_ms=median_ms(lambda: P.decode_scores_plain(z, W, bp)),
                   library_ms=median_ms(lambda: torch.addmm(bp, z, W.t())),
                   device_ms=device_ms(lambda: P.decode_scores(z, W, bp)),
                   library_device_ms=device_ms(
                       lambda: torch.addmm(bp, z, W.t())),
                   **tf32_bound(4.0 * (B * D + I * D + I + B * I),
                                2.0 * B * I * D))
        emit(row)
        if err > TOL:
            raise AssertionError(f"decode_scores error {err} > {TOL}")
        record(results, "decode_scores", row)

    k = 10
    D = 50
    # B5 fused_topk_scores: random int8 rated rows (1% rated)
    B, I = 256, 1_000_000
    z = torch.rand(B, D, generator=g, device=dev)
    W, bp = normal(I, D, scale=0.1), normal(I, scale=0.1)
    rows = (torch.rand(B, I, generator=g, device=dev) < 0.01).to(torch.int8)
    _check_topk(torch, results, "fused_topk_scores", B, I, D, k,
                lambda kk: P.fused_topk_scores(z, W, bp, rows, k=kk),
                lambda kk: P.fused_topk_scores_plain(z, W, bp, rows, k=kk),
                tf32_bound(4.0 * (B * D + I * D + I) + B * I + 8.0 * B * k,
                           2.0 * B * I * D))
    del rows

    # B6 fused_topk_scores_csr: sorted rated rows of 1 to 2048 items
    B = 1024
    z = torch.rand(B, D, generator=g, device=dev)
    lengths = torch.randint(1, 2049, (B,), generator=g, device=dev)
    rand_ids = torch.randint(0, I, (B, 2048), generator=g, device=dev)
    live = torch.arange(2048, device=dev)[None, :] < lengths[:, None]
    rated = torch.where(live, rand_ids, I).sort(dim=1).values
    rated = rated.to(torch.int32).contiguous()
    _check_topk(torch, results, "fused_topk_scores_csr", B, I, D, k,
                lambda kk: P.fused_topk_scores_csr(z, W, bp, rated, k=kk),
                lambda kk: P.fused_topk_scores_csr_plain(z, W, bp, rated,
                                                         k=kk),
                tf32_bound(4.0 * (B * D + I * D + I + B * 2048)
                           + 8.0 * B * k, 2.0 * B * I * D))


def tf32_bound(nbytes: float, flops: float, other_ops: float = 0.0,
               tf32_ops: float | None = None) -> dict:
    """The bound of a kernel that multiplies in 3xTF32 on the tensor cores
    (``tf32_ops`` at 495 T/s: by default three TF32 products per f32 one),
    with the f32 figure (``flops`` and ``other_ops`` at 67 T/s) beside it,
    as the bound of an f32 FMA kernel for the same work."""
    if tf32_ops is None:
        tf32_ops = 3 * flops
    return dict(**bound(nbytes, tf32_ops, TF32_OPS_PER_S),
                bound_f32_ms=bound(nbytes, flops + other_ops)["bound_ms"])


def _check_topk(torch, results, name, B, I, D, k, kernel, plain, work):
    """Decode + top-k has no single library call (library_ms null)."""
    ids, vals = kernel(k)
    plain_ids, plain_vals = plain(k + 1)
    torch.cuda.synchronize()
    err, checked, other = topk_agreement(ids, vals, plain_ids, plain_vals, k)
    row = dict(phase="kernel", kernel=name, B=B, I=I, D=D, k=k,
               max_abs_err=err, tol=TOL, rows_checked=checked,
               rows_with_other_ids=other,
               ms=median_ms(lambda: kernel(k), reps=3),
               device_ms=device_ms(lambda: kernel(k), reps=5),
               # one call under torch.profiler: the tile kernel and merge
               profile=_profile(torch, lambda: kernel(k)),
               plain_ms=median_ms(lambda: plain(k), reps=3),
               library_ms=None, **work)
    emit(row)
    if err > TOL or other:
        raise AssertionError(f"{name}: max_abs_err {err}, {other} rows with "
                             "other ids")
    record(results, name, row)


def phase_train_kernels(torch, results):
    """B1, B2 and B4 against their plain versions at the training path's
    shapes: ML-1M (I=3706, D=50) and config-4 (I=20000, D=200), B=1024."""
    import cdae_tpu_torch.ops.pallas_kernels as P
    from cdae_tpu_torch.ops import cdae_fused as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    bad = []

    # B1 hw_uniform: bit-equal to the plain int64 version
    for shape in ((1024, 3706), (1024, 20000)):
        out = P.hw_uniform(SEED, shape, 1, device=dev)
        ref = P.hw_uniform_plain(SEED, shape, 1, device=dev)
        torch.cuda.synchronize()
        equal = bool(torch.equal(out, ref))
        row = dict(phase="kernel", kernel="hw_uniform", shape=list(shape),
                   bit_equal=equal,
                   max_abs_err=(out - ref).abs().max().item(),
                   mean=out.mean().item(), var=out.var().item(),
                   ms=median_ms(lambda: P.hw_uniform(SEED, shape, 1,
                                                     device=dev)),
                   device_ms=device_ms(lambda: P.hw_uniform(
                       SEED, shape, 1, device=dev)),
                   plain_ms=median_ms(lambda: P.hw_uniform_plain(
                       SEED, shape, 1, device=dev)),
                   # no library call draws this hash stream (torch.rand is
                   # another function); ~12 integer operations an element
                   library_ms=None,
                   **bound(4.0 * shape[0] * shape[1],
                           12.0 * shape[0] * shape[1]))
        emit(row)
        record(results, "hw_uniform", row)
        if not equal:
            bad.append(f"hw_uniform {shape}")

    # B2 adagrad_update: in place, f32 or bf16 param; _rn intrinsics make
    # it bit-equal (max relative error 0)
    for shape in ((3706, 50), (20000, 200), (3706,)):
        p = torch.randn(shape, generator=g, device=dev) * 0.1
        a = torch.rand(shape, generator=g, device=dev) + 1e-4
        gr = torch.randn(shape, generator=g, device=dev)
        pk, ak = P.adagrad_update(p.clone(), a.clone(), gr, 0.1, 1.0)
        pp, ap = P.adagrad_update_plain(p.clone(), a.clone(), gr, 0.1, 1.0)
        torch.cuda.synchronize()
        rel = max(((pk - pp).abs() / pp.abs().clamp_min(1e-30)).max().item(),
                  ((ak - ap).abs() / ap.abs()).max().item())
        pw, aw = p.clone(), a.clone()
        n = p.numel()
        # the library's AdaGrad: sum += g^2; p -= lr*g/(sqrt(sum) + eps),
        # with eps = beta it is this update
        pl = p.clone().requires_grad_(True)
        pl.grad = gr
        opt = torch.optim.Adagrad([pl], lr=0.1, eps=1.0)
        opt.state[pl]["sum"] = a.clone()
        row = dict(phase="kernel", kernel="adagrad_update", shape=list(shape),
                   max_rel_err=rel, tol=1e-6,
                   max_abs_err=max((pk - pp).abs().max().item(),
                                   (ak - ap).abs().max().item()),
                   ms=median_ms(lambda: P.adagrad_update(pw, aw, gr, 0.1,
                                                         1.0)),
                   plain_ms=median_ms(lambda: P.adagrad_update_plain(
                       pw, aw, gr, 0.1, 1.0)),
                   library_ms=median_ms(opt.step),
                   device_ms=device_ms(lambda: P.adagrad_update(
                       pw, aw, gr, 0.1, 1.0)),
                   library_device_ms=device_ms(opt.step),
                   **bound(20.0 * n, 7.0 * n))
        emit(row)
        record(results, "adagrad_update", row)
        if rel > 1e-6:
            bad.append(f"adagrad_update {shape}")

    # B4 cdae_dense_step_fused, corruption 0.5 and num_neg 5 on
    for B, I, D in ((1024, 3706, 50), (1024, 20000, 200)):
        rows = (torch.rand(B, I, generator=g, device=dev) < 0.04).to(
            torch.int8)
        w_user = torch.ones(B, device=dev)
        w_user[-24:] = 0.0  # a wrapped last batch
        lengths = rows.sum(1).float() * w_user
        p_neg = torch.clamp(5 * lengths / torch.clamp(I - lengths, min=1.0),
                            0.0, 1.0)
        s = 4.0 * (6.0 / (I + D)) ** 0.5
        h_bias = torch.randn(B, D, generator=g, device=dev) * 0.1
        W = (torch.rand(I, D, generator=g, device=dev) * 2 - 1) * s
        W_ag = torch.full((I, D), 1e-4, device=dev)
        bp = torch.zeros(I, device=dev)
        bp_ag = torch.full((I,), 1e-4, device=dev)
        kw = dict(q=0.5, scale=2.0, lam=0.01, lr=0.1, beta=1.0, use_ada=True,
                  act="sigmoid", loss_name="SQUARE")

        def run(fn, dtype=torch.float32):
            return fn(SEED, rows, w_user.to(dtype), p_neg.to(dtype),
                      h_bias.to(dtype), W.to(dtype, copy=True),
                      W_ag.to(dtype, copy=True), bp.to(dtype, copy=True),
                      bp_ag.to(dtype, copy=True), **kw)

        got = run(F.cdae_dense_step_fused)
        again = run(F.cdae_dense_step_fused)  # the same bits: no atomics
        want = run(F.cdae_dense_step_fused_plain)
        ref64 = run(F.cdae_dense_step_fused_plain, torch.float64)
        torch.cuda.synchronize()
        per = {}
        ok = True
        for name, k, p, r in zip(FUSED_OUTPUTS, got, want, ref64):
            atol = FUSED_ATOL * max(1.0, p.abs().max().item())
            excess = ((k - p).abs() - atol - FUSED_RTOL * p.abs()).max()
            per[name] = dict(max_abs_err=(k - p).abs().max().item(),
                             atol=atol,
                             kernel_vs_f64=(k.double() - r).abs().max()
                             .item(),
                             plain_vs_f64=(p.double() - r).abs().max()
                             .item())
            ok = ok and excess.item() <= 0.0
        bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = ok and bit_equal
        args = [t.clone() for t in (W, W_ag, bp, bp_ag)]
        nbytes = B * I + 4.0 * (2 * B + 2 * B * D) + 16.0 * (I * D + I)
        row = dict(phase="kernel", kernel="cdae_dense_step_fused", B=B, I=I,
                   D=D, rtol=FUSED_RTOL, outputs=per,
                   bit_equal_relaunch=bit_equal,
                   max_abs_err=per["W"]["max_abs_err"], ok=ok,
                   ms=median_ms(lambda: F.cdae_dense_step_fused(
                       SEED, rows, w_user, p_neg, h_bias, *args, **kw)),
                   device_ms=device_ms(lambda: F.cdae_dense_step_fused(
                       SEED, rows, w_user, p_neg, h_bias, *args, **kw),
                       reps=10),
                   # one step under torch.profiler: each launch's span
                   profile=_profile(torch, lambda: F.cdae_dense_step_fused(
                       SEED, rows, w_user, p_neg, h_bias, *args, **kw)),
                   plain_ms=median_ms(lambda: F.cdae_dense_step_fused_plain(
                       SEED, rows, w_user, p_neg, h_bias, *args, **kw)),
                   # no library call does a whole CDAE step; the work is
                   # five dense (B, I, D) products (encode, decode, the
                   # hidden gradient, d_W's two), on the tensor cores in
                   # 3xTF32, and two hash draws. Three take three TF32
                   # products each; encode and d_W's kept^T hs take two,
                   # as their kept operand is exact in TF32: 13 TF32
                   # products of 2*B*I*D. The kernel's grads launch
                   # recomputes the decode, a sixth product that the step
                   # does not need: not counted
                   library_ms=None,
                   # (the f32 figure also counts the hash draws, ~24
                   # operations a cell, as an f32 FMA kernel's bound)
                   **tf32_bound(nbytes, 10.0 * B * I * D, 24.0 * B * I,
                                tf32_ops=26.0 * B * I * D))
        emit(row)
        record(results, "cdae_dense_step_fused", row)
        if not ok:
            bad.append(f"cdae_dense_step_fused {(B, I, D)}")
        del rows, got, again, want, ref64
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")


def phase_slice(torch, tmp, n_users_out):
    """CLI --task test at ML-1M scale, D=50, and the plain path on the same
    checkpoint as the reference."""
    from cdae_tpu_torch import cli
    from cdae_tpu_torch.data import io as data_io
    from cdae_tpu_torch.data.synthetic import synthetic_interactions
    from cdae_tpu_torch.evaluation import RecListEvaluation
    from cdae_tpu_torch.models.cdae import CDAE, CDAEConfig
    from cdae_tpu_torch.ops import metrics
    from cdae_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint)

    data = synthetic_interactions(6040, 3706, 160, seed=SEED)
    train, test = data.split_by_user(0.2, seed=SEED)
    paths = {n: os.path.join(tmp, f"ml1m.{n}.bin") for n in ("train", "test")}
    data_io.save_interactions(train, paths["train"])
    data_io.save_interactions(test, paths["test"])
    cfg = dict(num_dim=50, corruption_ratio=0.5, scaled=True, num_neg=5,
               loss="SQUARE", batch_size=1024)
    model = CDAE(CDAEConfig(**cfg), device="cuda")
    ckpt = os.path.join(tmp, "ml1m.ckpt")
    save_checkpoint(ckpt, model.reset(train, seed=SEED))
    argv = ["--task", "test", "--method", "CDAE", "--num_dim", "50",
            "--cratio", "0.5", "--scaled", "true", "--num_neg", "5",
            "--loss_type", "SQUARE", "--batch_size", "1024",
            "--init_checkpoint", ckpt,
            "--train_cache_file", paths["train"],
            "--test_cache_file", paths["test"]]
    t0 = time.perf_counter()
    res = cli.run(argv)
    cli_s = time.perf_counter() - t0
    n_val = int((test.csr().row_lengths() > 0).sum())
    n_users_out["slice"] = n_val
    plain = CDAE(CDAEConfig(**cfg, use_pallas=False), device="cuda")
    ps = load_checkpoint(ckpt, plain.reset(train, seed=SEED))
    ref = RecListEvaluation("TOPN").evaluate(plain, ps, test, train)
    diff = max(abs(res[c] - ref[c]) for c in metrics.TOPN_COLUMNS)
    return dict(phase="slice", users=6040, items=3706, D=50,
                val_users=n_val, cli_seconds=cli_s,
                test_time_s=res["TestTime"],
                users_per_s=n_val / res["TestTime"],
                topn={c: res[c] for c in metrics.TOPN_COLUMNS},
                max_diff_vs_plain_path=diff,
                ok=all(map(_finite, (res[c] for c in metrics.TOPN_COLUMNS)))
                and diff <= 1e-3)


def _finite(x) -> bool:
    return x == x and abs(x) != float("inf")


def phase_1m(torch, name, U, batch_size, expect_dense, held):
    """TOPN over a 1M-item catalog through RecListEvaluation(batch 1024);
    the first call builds and caches the eval batches, the second is warm."""
    from cdae_tpu_torch.data.synthetic import synthetic_interactions
    from cdae_tpu_torch.evaluation import RecListEvaluation
    from cdae_tpu_torch.models.cdae import CDAE, CDAEConfig
    from cdae_tpu_torch.ops import metrics

    I = 1_000_000
    t0 = time.perf_counter()
    data = synthetic_interactions(U, I, 100, seed=SEED)
    train, test = data.split_by_user(0.2, seed=SEED)
    model = CDAE(CDAEConfig(num_dim=50, corruption_ratio=0.5,
                            batch_size=batch_size), device="cuda")
    state = model.reset(train, seed=SEED)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if ("dense_R" in state.aux) != expect_dense:
        raise AssertionError(f"{name}: dense_R resident is "
                             f"{'dense_R' in state.aux}, expected "
                             f"{expect_dense}")
    ev = RecListEvaluation("TOPN", batch_size=1024)
    first = ev.evaluate(model, state, test, train)
    warm = ev.evaluate(model, state, test, train)
    n_val = ev._cache[0]
    held[name] = (model, state, ev)
    cols = [warm[c] for c in metrics.TOPN_COLUMNS]
    return dict(phase=name, users=U, items=I, D=50, val_users=n_val,
                dense_R=expect_dense, setup_s=setup_s,
                first_test_time_s=first["TestTime"],
                test_time_s=warm["TestTime"],
                users_per_s=n_val / warm["TestTime"],
                topn=dict(zip(metrics.TOPN_COLUMNS, cols)),
                ok=all(map(_finite, cols)))


def phase_verify(torch, held):
    """First eval batch of each 1M-item run: the kernel's ids against the
    plain streaming scan from the same hidden codes."""
    import cdae_tpu_torch.ops.pallas_kernels as P
    from cdae_tpu_torch.models.cdae import _hidden

    out = {}
    for name, (model, state, ev) in held.items():
        uids, rated_items, rated_mask = ev._cache[1][0][:3]
        uids_t = torch.as_tensor(uids, dtype=torch.long, device="cuda")
        z = _hidden(state.params, uids_t, rated_items, rated_mask, 1.0,
                    model.cfg)
        W, bp = state.params["W"], state.params["b_prime"]
        if "dense_R" in state.aux:
            ids, vals = P.fused_topk_scores(z, W, bp,
                                            state.aux["dense_R"][uids_t])
        else:
            ids, vals = P.fused_topk_scores_csr(z, W, bp, rated_items,
                                                w=64)
        plain_ids, plain_vals = P.streaming_topk_scores(z, W, bp,
                                                        rated_items, k=11)
        torch.cuda.synchronize()
        err, checked, other = topk_agreement(ids, vals, plain_ids,
                                             plain_vals, 10)
        out[name] = dict(max_abs_err=err, rows_checked=checked,
                         rows_with_other_ids=other)
    ok = all(v["max_abs_err"] <= TOL and not v["rows_with_other_ids"]
             for v in out.values())
    return dict(phase="verify", **out, ok=ok)


ML1M_TRAIN = ["--task", "train", "--method", "CDAE", "--num_dim", "50",
              "--cratio", "0.5", "--scaled", "true", "--num_neg", "5",
              "--loss_type", "SQUARE", "--batch_size", "1024",
              "--max_iters", "10", "--eval_iters", "5", "--skip_popularity",
              "--seed", str(SEED), "--test_ratio", "0.2"]


def phase_train_ml1m(torch, tmp, held):
    """CLI --task train at ML-1M scale (low-rank data, so there is
    something to learn), D=50, 10 epochs, TOPN at 0, 5 and 10."""
    from cdae_tpu_torch import cli
    from cdae_tpu_torch.data import io as data_io
    from cdae_tpu_torch.data.synthetic import lowrank_interactions
    from cdae_tpu_torch.solver.solver import _params_finite

    t0 = time.perf_counter()
    data = lowrank_interactions(6040, 3706, 160, seed=SEED)
    cache = os.path.join(tmp, "ml1m_lowrank.bin")
    data_io.save_interactions(data, cache)
    data_s = time.perf_counter() - t0
    argv = ML1M_TRAIN + ["--cache_file", cache,
                         "--checkpoint", os.path.join(tmp, "train.ckpt")]
    t0 = time.perf_counter()
    solver = cli.train(cli.build_arg_parser().parse_args(argv))
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    hist = solver.history
    finite = _params_finite(solver.state.params)
    held["ml1m"] = (solver, data.split_by_user(0.2, seed=SEED))
    held["ml1m_data"] = data
    return dict(phase="train_ml1m", users=6040, items=3706, D=50,
                interactions=len(data), epochs=10, data_s=data_s,
                cli_seconds=cli_s,
                recall_at_10={int(r["iter"]): r["R@10"] for r in hist},
                map_at_10={int(r["iter"]): r["MAP@10"] for r in hist},
                train_loss={int(r["iter"]): r["train_loss"] for r in hist},
                params_finite=finite,
                ok=finite and hist[-1]["R@10"] > hist[0]["R@10"])


def phase_train_vs_plain(torch, held):
    """One epoch from the same reset with the kernels and with their plain
    versions (use_pallas off; the same hash masks): W must agree to 1e-4
    -- B1 and B2 are bit-equal, so it should be exact."""
    import dataclasses

    from cdae_tpu_torch.models.cdae import CDAE

    solver, (train, _) = held["ml1m"]
    W = {}
    for use_pallas in (True, False):
        model = CDAE(dataclasses.replace(solver.model.cfg,
                                         use_pallas=use_pallas),
                     device="cuda")
        state = model.reset(train, seed=SEED)
        model.train_one_iteration(state, SEED)
        W[use_pallas] = state.params["W"]
    diff = (W[True] - W[False]).abs().max().item()
    return dict(phase="train_vs_plain", epochs=1, max_abs_diff_W=diff,
                tol=1e-4, ok=diff <= 1e-4)


def phase_train_ml1m_fused(torch, held):
    """The same 10 epochs with fused_step=True through Solver.train (the
    same step seeds, so the same hash masks): R@10 within 0.02 of the
    unfused CLI run, ROADMAP's parity gate."""
    import dataclasses

    from cdae_tpu_torch.models.cdae import CDAE
    from cdae_tpu_torch.solver.solver import Solver, _params_finite

    solver, (train, test) = held["ml1m"]
    model = CDAE(dataclasses.replace(solver.model.cfg, fused_step=True),
                 device="cuda")
    fused = Solver(model, max_iteration=10, eval_iterations=10, seed=SEED,
                   verbose=False)
    t0 = time.perf_counter()
    fused.train(train, test, ["TOPN"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r_f, r_u = fused.history[-1]["R@10"], solver.history[-1]["R@10"]
    finite = _params_finite(fused.state.params)
    return dict(phase="train_ml1m_fused", epochs=10, seconds=wall,
                recall_at_10_fused=r_f, recall_at_10_unfused=r_u,
                recall_at_0=fused.history[0]["R@10"],
                diff=abs(r_f - r_u), tol=0.02, params_finite=finite,
                ok=finite and abs(r_f - r_u) <= 0.02)


def phase_train_speed(torch, held):
    """Warm training throughput, unfused and fused: one warm-up epoch, then
    2 timed epochs (train_epochs), host clock between synchronizes.
    users/s = users * epochs / wall. ML-1M (D=50) and config-4 (50,000 x
    20,000, D=200, dense_R 1 GB int8), batch 1024."""
    import dataclasses

    from cdae_tpu_torch.data.synthetic import synthetic_interactions
    from cdae_tpu_torch.models.cdae import CDAE, CDAEConfig
    from cdae_tpu_torch.solver.solver import _params_finite

    cells = {"ml1m": (held["ml1m"][1][0], 50)}
    t0 = time.perf_counter()
    cells["config4"] = (synthetic_interactions(50000, 20000, 100, seed=SEED)
                        .split_by_user(0.2, seed=SEED)[0], 200)
    data_s = time.perf_counter() - t0
    out = dict(phase="train_speed", config4_data_s=data_s)
    ok = True
    for name, (train, D) in cells.items():
        cfg = CDAEConfig(num_dim=D, corruption_ratio=0.5, scaled=True,
                         num_neg=5, loss="SQUARE", batch_size=1024, beta=1.0)
        t0 = time.perf_counter()
        state = CDAE(cfg, device="cuda").reset(train, seed=SEED)
        torch.cuda.synchronize()
        cell = dict(users=train.num_users, items=train.num_items, D=D,
                    interactions=len(train), dense_R="dense_R" in state.aux,
                    reset_s=time.perf_counter() - t0)
        for fused in (False, True):
            model = CDAE(dataclasses.replace(cfg, fused_step=fused),
                         device="cuda")
            model.train_epochs(state, 1, SEED)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model.train_epochs(state, 2, SEED)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            key = "fused" if fused else "unfused"
            cell[key] = dict(
                seconds_2_epochs=wall,
                users_per_s=train.num_users * 2 / wall,
                ms_per_step=wall * 1e3 / (2 * state.aux["dense_batches"][0]
                                          .shape[0]),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        cell["params_finite"] = _params_finite(state.params)
        ok = ok and cell["dense_R"] and cell["params_finite"]
        out[name] = cell
        del state
    out["ok"] = ok
    return out


# ----------------------------------------------------------------- WARP ----

def _warp_problem(torch, g, B, I, D):
    """B7's inputs at the WARP step's shapes: ~4% rated int8 rows, and
    thr = one rated item's score - 1, as the step passes it. The values
    are dyadic (multiples of 1/64, small), so every score is exact in f32
    whatever the order of the sums: the kernel and the library GEMM of the
    plain version then agree on every comparison with thr."""
    dev = torch.device("cuda")

    def dyadic(*shape):
        return torch.round(torch.randn(*shape, generator=g, device=dev)
                           * 32) / 64

    uv, iv, ib = dyadic(B, D), dyadic(I, D), dyadic(I)
    mask = (torch.rand(B, I, generator=g, device=dev) < 0.04).to(torch.int8)
    pos = torch.randint(0, I, (B,), generator=g, device=dev)
    mask[torch.arange(B, device=dev), pos] = 1
    thr = (uv * iv[pos]).sum(1) + ib[pos] - 1.0
    return uv, iv, ib, thr, mask


def phase_kernel_warp(torch, results):
    """B7 against its plain version at the WARP path's shapes: nviol and j
    equal on every row (the dyadic inputs make every score exact in both,
    so no row is excused); then the chi-square of the card's picks (every
    item a violator, 8 seeds pooled, tests/test_pallas.py's bound)."""
    import cdae_tpu_torch.ops.pallas_kernels as P

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    nn = 5
    bad = []
    for B, I, D in ((8192, 3706, 10), (8192, 20000, 10)):
        args = (*_warp_problem(torch, g, B, I, D), nn)
        nviol, j = P.warp_violator_select(SEED, *args)
        p_nviol, p_j = P.warp_violator_select_plain(SEED, *args)
        # cdae_tpu's other reproducible noise, "hash", on the same rows
        h_equal = all(map(torch.equal,
                          P.warp_violator_select(SEED, *args, noise="hash"),
                          P.warp_violator_select_plain(SEED, *args,
                                                       noise="hash")))
        torch.cuda.synchronize()
        nviol_equal = bool(torch.equal(nviol, p_nviol))
        j_rows_differ = int((j != p_j).any(dim=1).sum())
        viol_total = int(p_nviol.sum())
        err = max((nviol - p_nviol).abs().max().item(),
                  (j - p_j).abs().max().item())
        quiet = (*args[:3], torch.full_like(args[3], float("inf")), *args[4:])
        row = dict(phase="kernel_warp", kernel="warp_violator_select", B=B,
                   I=I, D=D, nn=nn, nviol_equal=nviol_equal,
                   hash_noise_equal=h_equal, rows_checked=B,
                   j_rows_differ=j_rows_differ,
                   mean_nviol=viol_total / B, max_abs_err=err,
                   ms=median_ms(lambda: P.warp_violator_select(SEED, *args)),
                   device_ms=device_ms(
                       lambda: P.warp_violator_select(SEED, *args)),
                   # the same rows with no violator (thr = inf): scores,
                   # mask and staging without the violators' noise
                   device_ms_no_violators=device_ms(
                       lambda: P.warp_violator_select(SEED, *quiet)),
                   plain_ms=median_ms(
                       lambda: P.warp_violator_select_plain(SEED, *args),
                       reps=3),
                   # no library call counts and picks violators
                   library_ms=None,
                   # the int8 rows once, the tables, the outputs; f32 FMAs
                   # for the scores, ~3 integer operations a cell and, where
                   # a cell violates, 16 for the noise bases + 6 a slot
                   **bound(B * I + 4.0 * (B * D + I * D + I + B)
                           + 4.0 * (B + B * nn),
                           2.0 * B * I * D + 3.0 * B * I
                           + viol_total * (16.0 + 6.0 * nn)))
        emit(row)
        record(results, "warp_violator_select", row)
        if not nviol_equal or j_rows_differ or not h_equal:
            bad.append(f"warp_violator_select {(B, I, D, nn)}")
        del args

    B, I, D, nn = 64, 256, 4, 4
    counts = torch.zeros(I, dtype=torch.float64, device=dev)
    for s in range(8):
        _, j = P.warp_violator_select(
            1000 + s * 7919, torch.ones((B, D), device=dev),
            torch.ones((I, D), device=dev), torch.zeros(I, device=dev),
            torch.full((B,), -1e9, device=dev),
            torch.zeros((B, I), dtype=torch.int8, device=dev), nn)
        counts += torch.bincount(j.reshape(-1).long(), minlength=I)
    E = counts.sum() / I
    chi2 = float(((counts - E) ** 2 / E).sum())
    emit(dict(phase="kernel_warp_uniformity", B=B, I=I, nn=nn, seeds=8,
              chi2=chi2, dof=I - 1, bound=WARP_CHI2_BOUND,
              ok=chi2 <= WARP_CHI2_BOUND))
    if chi2 > WARP_CHI2_BOUND:
        bad.append(f"warp_violator_select chi2 {chi2}")
    if bad:
        raise AssertionError(f"B7 disagrees with its plain version or is "
                             f"not uniform: {bad}")


WARP_TRAIN = ["--task", "train", "--method", "WARP", "--num_dim", "10",
              "--num_neg", "5", "--loss_type", "HINGE", "--beta", "0",
              "--lambda", "0.1", "--learn_rate", "0.1", "--batch_size",
              "8192", "--max_iters", "10", "--eval_iters", "5",
              "--skip_popularity", "--seed", str(SEED), "--test_ratio",
              "0.2"]


def phase_train_warp(torch, tmp, held):
    """CLI --task train --method WARP on the ML-1M-scale low-rank data
    (the repo's WARP configuration: D=10, batch 8192, num_neg 5, num_tries
    64, HINGE, beta 0, lambda 0.1), 10 epochs, TOPN at 0, 5 and 10."""
    from cdae_tpu_torch import cli
    from cdae_tpu_torch.data import io as data_io
    from cdae_tpu_torch.solver.solver import _params_finite

    data = held["ml1m_data"]
    cache = os.path.join(tmp, "ml1m_lowrank.bin")
    data_io.save_interactions(data, cache)
    t0 = time.perf_counter()
    solver = cli.train(cli.build_arg_parser().parse_args(
        WARP_TRAIN + ["--cache_file", cache]))
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    hist = solver.history
    finite = _params_finite(solver.state.params)
    held["warp"] = solver
    n = len(held["ml1m"][1][0])
    return dict(phase="train_warp", users=6040, items=3706, D=10,
                batch=8192, train_instances=n, steps_per_epoch=-(-n // 8192),
                epochs=10, cli_seconds=cli_s,
                use_pallas=solver.model.cfg.use_pallas,
                recall_at_10={int(r["iter"]): r["R@10"] for r in hist},
                map_at_10={int(r["iter"]): r["MAP@10"] for r in hist},
                train_loss={int(r["iter"]): r["train_loss"] for r in hist},
                params_finite=finite,
                ok=finite and hist[-1]["R@10"] > hist[0]["R@10"])


def phase_train_warp_xla(torch, held):
    """The same 10 epochs with use_pallas=False (count from the full score
    rows, picks by cumsum + searchsorted, op-by-op AdaGrad) through
    Solver.train: the same sampling distribution from other random
    streams, so R@10 within 0.03 of the kernel run."""
    import dataclasses

    from cdae_tpu_torch.models.mf import WARP
    from cdae_tpu_torch.solver.solver import Solver, _params_finite

    solver = held["warp"]
    train, test = held["ml1m"][1]
    model = WARP(dataclasses.replace(solver.model.cfg, use_pallas=False),
                 device="cuda")
    xla = Solver(model, max_iteration=10, eval_iterations=10, seed=SEED,
                 verbose=False)
    t0 = time.perf_counter()
    xla.train(train, test, ["TOPN"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r_x, r_k = xla.history[-1]["R@10"], solver.history[-1]["R@10"]
    finite = _params_finite(xla.state.params)
    return dict(phase="train_warp_xla", epochs=10, seconds=wall,
                recall_at_10_xla=r_x, recall_at_10_kernel=r_k,
                recall_at_0=xla.history[0]["R@10"], diff=abs(r_x - r_k),
                tol=WARP_R10_GATE, params_finite=finite,
                ok=finite and abs(r_x - r_k) <= WARP_R10_GATE
                and r_x > xla.history[0]["R@10"])


def _profile(torch, fn) -> dict:
    """One call of ``fn`` under torch.profiler: host wall, device busy time
    (the sum of the CUDA kernels' spans on the one stream), idle share and
    the largest kernels. Without device events the device numbers are
    None (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, kernels = {}, 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            kernels += 1
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
    busy = sum(by_name.values()) if by_name else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=None if busy is None else 1.0 - busy / wall_ms,
                device_kernels=kernels,
                top_kernels_ms=[[n[:80], ms] for n, ms in top])


def phase_train_speed_warp(torch, held):
    """Warm WARP training throughput, kernel and cumsum routes: one
    warm-up epoch, then 2 timed epochs (host clock between synchronizes);
    users/s = users * epochs / wall; then one more epoch under
    torch.profiler for the device busy time and idle share."""
    import dataclasses

    from cdae_tpu_torch.models.mf import WARP
    from cdae_tpu_torch.solver.solver import _params_finite

    cfg = held["warp"].model.cfg
    train = held["ml1m"][1][0]
    n = len(train)
    steps = -(-n // cfg.batch_size)
    out = dict(phase="train_speed_warp", users=train.num_users,
               items=train.num_items, instances=n, batch=cfg.batch_size,
               steps_per_epoch=steps)
    ok = True
    # the kernel route (B7, and B8 for the default scatter_mode "auto"),
    # the same with index_add_'s sums (the price of a fixed order), and
    # the cumsum route
    routes = (("kernel", dict(use_pallas=True)),
              ("kernel_index_add", dict(use_pallas=True,
                                        scatter_mode="scatter")),
              ("xla", dict(use_pallas=False)))
    for route, kw in routes:
        model = WARP(dataclasses.replace(cfg, **kw), device="cuda")
        state = model.reset(train, seed=SEED)
        model.train_one_iteration(state, SEED)  # warm-up, builds the mask
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(2):
            model.train_one_iteration(state, SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = _profile(torch, lambda: model.train_one_iteration(state, SEED))
        prof["launches_per_step"] = prof.pop("device_kernels") / steps
        finite = _params_finite(state.params)
        out[route] = dict(
            seconds_2_epochs=wall, users_per_s=train.num_users * 2 / wall,
            instances_per_s=n * 2 / wall,
            ms_per_step=wall * 1e3 / (2 * steps),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            params_finite=finite, profiled_epoch=prof)
        ok = ok and finite
        del state
    out["ok"] = ok
    return out


# ---------------------------------------------------- B8, B9 and FISM ----

def _rows_ok(torch, out, plain):
    """B8 against its plain version: |out - plain| <= ROWS_RTOL * |plain| +
    ROWS_ATOL * max |plain| everywhere; returns (ok, max_abs_err)."""
    scale = max(plain.abs().max().item() if plain.numel() else 0.0, 1.0)
    err = (out - plain).abs()
    excess = err - ROWS_ATOL * scale - ROWS_RTOL * plain.abs()
    return (not plain.numel() or excess.max().item() <= 0.0,
            err.max().item() if plain.numel() else 0.0)


def _fism_batch_ids(torch, train, nn=5, batch=128):
    """The item ids of the sparse FISM step's largest user batch (the
    longest rows, bucketed L), positives then nn * L complement draws, as
    the step aggregates them (padding slots carry the sentinel I)."""
    from cdae_tpu_torch.models.base import iter_user_batches
    from cdae_tpu_torch.ops.sampling import sample_unrated

    dev = torch.device("cuda")
    mb = list(iter_user_batches(train.padded(), batch,
                                bucket_by_length=True))[-1]
    items = torch.as_tensor(mb.items, device=dev).long()
    lengths = torch.as_tensor(mb.lengths, device=dev).long()
    neg = sample_unrated(SEED, items, lengths, train.num_items,
                         nn * items.shape[1])
    return items.reshape(-1), torch.cat([items.reshape(-1), neg.reshape(-1)])


def _host_us(torch, fn, reps: int = 50) -> float:
    """Host microseconds of one call of ``fn`` (the wrapper's own work and
    its launches, the device left to run behind): the median over
    ``reps`` calls, each after a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def phase_kernel_scatter(torch, held, results):
    """B8 against its plain version at the FISM sparse step's shapes (the
    Q + bi aggregation, (P, 11) and its 1-D bias column, and the P
    aggregation, (P, 10), of the largest batch of the run's data) and at
    WARP's (49,152 item rows x 11, 8,192 user rows x 10), with f32 and bf16
    contributions. The plan must equal its plain version (the library's
    stable sort), two launches on one input must give the same bits, and
    FISM's P sums over the Q + bi plan (limit = the P ids' count) the same
    bits as over their own plan. Times: the wrapper's whole span (plan +
    reduce, ``ms``), the plan and the reduce apart, torch.sort of the int64
    ids (the plan's yardstick) and, as library_ms, one index_add_ on the
    same values, sentinel ids sent to a spare row (index_add_ takes no id
    out of range); host_us: the wrappers' host time per call."""
    import cdae_tpu_torch.ops.pallas_kernels as P

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    train = held["ml1m"][1][0]
    I, U = train.num_items, train.num_users
    p_ids, qb_ids = _fism_batch_ids(torch, train)
    qb_plan = P.scatter_plan(qb_ids, I)
    cases = (("fism_q_bi", qb_ids, I, 11), ("fism_bi_1d", qb_ids, I, None),
             ("fism_p", p_ids, I, 10),
             ("warp_item", torch.randint(0, I, (49152,), generator=g,
                                         device=dev), I, 11),
             ("warp_user", torch.randint(0, U, (8192,), generator=g,
                                         device=dev), U, 10))
    bad = []
    for name, idx, N, C in cases:
        Pn = idx.shape[0]
        shape = (Pn,) if C is None else (Pn, C)
        vals = torch.randn(shape, generator=g, device=dev)
        valid = (idx >= 0) & (idx < N)
        plan = P.scatter_plan(idx, N)
        plain_plan = P.scatter_plan_plain(idx, N)
        torch.cuda.synchronize()
        plan_equal = all(map(torch.equal, plan, plain_plan))
        row = dict(phase="kernel_scatter", kernel="scatter_matmul", case=name,
                   P=Pn, N=N, C=C or 1, sentinel_ids=int((~valid).sum()),
                   rtol=ROWS_RTOL, atol_scale=ROWS_ATOL,
                   plan_equal_plain=plan_equal)
        if not plan_equal:
            bad.append(f"scatter_plan {name}")
        for bf16 in (False, True):
            out = P.scatter_matmul(idx, vals, N, bf16=bf16)
            again = P.scatter_matmul(idx, vals, N, bf16=bf16)
            plain = P.scatter_matmul_plain(idx, vals, N, bf16=bf16)
            torch.cuda.synchronize()
            ok, err = _rows_ok(torch, out, plain)
            same = bool(torch.equal(out, again))
            key = "bf16" if bf16 else "f32"
            row[key] = dict(max_abs_err=err, ok=ok, bit_equal_relaunch=same)
            if name == "fism_p":  # the step's P sums over the Q + bi plan
                shared = P.scatter_matmul(idx, vals, N, bf16=bf16,
                                          plan=qb_plan)
                row[key]["shared_plan_bit_equal"] = bool(torch.equal(shared,
                                                                     out))
                same = same and row[key]["shared_plan_bit_equal"]
            if not (ok and same):
                bad.append(f"scatter_matmul {name} {key}")
        lib_idx = torch.where(valid, idx, N)
        spare = (N + 1,) + tuple(shape[1:])
        row.update(
            max_abs_err=max(row["f32"]["max_abs_err"],
                            row["bf16"]["max_abs_err"]),
            ms=median_ms(lambda: P.scatter_matmul(idx, vals, N)),
            plan_ms=median_ms(lambda: P.scatter_plan(idx, N)),
            reduce_ms=median_ms(lambda: P.scatter_matmul(idx, vals, N,
                                                         plan=plan)),
            torch_sort_ms=median_ms(lambda: torch.sort(idx, stable=True)),
            plain_ms=median_ms(lambda: P.scatter_matmul_plain(idx, vals, N)),
            library_ms=median_ms(lambda: torch.zeros(
                spare, device=dev).index_add_(0, lib_idx, vals)),
            device_ms=dict(
                span=device_ms(lambda: P.scatter_matmul(idx, vals, N)),
                plan=device_ms(lambda: P.scatter_plan(idx, N)),
                reduce=device_ms(lambda: P.scatter_matmul(idx, vals, N,
                                                          plan=plan)),
                torch_sort=device_ms(lambda: torch.sort(idx, stable=True)),
                index_add=device_ms(lambda: torch.zeros(
                    spare, device=dev).index_add_(0, lib_idx, vals))),
            host_us=dict(
                plan=_host_us(torch, lambda: P.scatter_plan(idx, N)),
                reduce=_host_us(torch, lambda: P.scatter_matmul(
                    idx, vals, N, plan=plan)),
                index_add=_host_us(torch, lambda: torch.zeros(
                    spare, device=dev).index_add_(0, lib_idx, vals))),
            # values, ids and the output once each; one add per value
            **bound(4.0 * vals.numel() + 8.0 * Pn + 4.0 * N * (C or 1),
                    float(vals.numel())))
        emit(row)
        record(results, "scatter_matmul", row)
        if name == "fism_q_bi":
            # the plan's own row: the int64 ids read, order and offsets
            # written; its plain version and yardstick are library sorts
            results["scatter_plan"] = dict(
                max_abs_err=0.0 if plan_equal else None, ms=row["plan_ms"],
                device_ms=row["device_ms"]["plan"],
                plain_ms=median_ms(lambda: P.scatter_plan_plain(idx, N)),
                library_ms=row["torch_sort_ms"],
                **bound(8.0 * Pn + 4.0 * Pn + 4.0 * (N + 1), 0.0))
    if bad:
        raise AssertionError(f"B8 disagrees with its plain version or "
                             f"changes between launches or plans: {bad}")


def phase_kernel_gather(torch, results):
    """B9 exactly equal to its plain version at WARP's shapes (the (3706,
    11) item table with its bias column, 49,152 rows; the (6040, 10) user
    table, 8,192 rows), then with ids out of range, whose rows must be
    zero. library_ms: torch.index_select on the same (in-range) ids."""
    import cdae_tpu_torch.ops.pallas_kernels as P

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    bad = []
    for name, N, C, Pn in (("warp_item", 3706, 11, 49152),
                           ("warp_user", 6040, 10, 8192)):
        table = torch.randn((N, C), generator=g, device=dev)
        idx = torch.randint(0, N, (Pn,), generator=g, device=dev)
        out = P.gather_rows_mxu(table, idx)
        exact = bool(torch.equal(out, P.gather_rows_mxu_plain(table, idx)))
        oor = idx.clone()
        oor[:97] = N
        oor[97:200] = -1
        out2 = P.gather_rows_mxu(table, oor)
        torch.cuda.synchronize()
        exact_oor = bool(torch.equal(out2,
                                     P.gather_rows_mxu_plain(table, oor)))
        zero_rows = not out2[:200].any().item()
        row = dict(phase="kernel_gather", kernel="gather_rows_mxu", case=name,
                   N=N, C=C, P=Pn, exact=exact, exact_out_of_range=exact_oor,
                   out_of_range_rows_zero=zero_rows,
                   max_abs_err=(out - table[idx]).abs().max().item(),
                   ms=median_ms(lambda: P.gather_rows_mxu(table, idx)),
                   plain_ms=median_ms(lambda: P.gather_rows_mxu_plain(
                       table, idx)),
                   library_ms=median_ms(lambda: torch.index_select(
                       table, 0, idx)),
                   device_ms=device_ms(lambda: P.gather_rows_mxu(table,
                                                                 idx)),
                   library_device_ms=device_ms(lambda: torch.index_select(
                       table, 0, idx)),
                   host_us=_host_us(torch, lambda: P.gather_rows_mxu(table,
                                                                     idx)),
                   library_host_us=_host_us(torch, lambda: torch.index_select(
                       table, 0, idx)),
                   # the ids and the table read once, the rows written once
                   **bound(8.0 * Pn + 4.0 * N * C + 4.0 * Pn * C, 0.0))
        emit(row)
        record(results, "gather_rows_mxu", row)
        if not (exact and exact_oor and zero_rows):
            bad.append(f"gather_rows_mxu {name}")
    if bad:
        raise AssertionError(f"B9 is not exact: {bad}")


FISM_TRAIN = ["--task", "train", "--method", "FISM", "--num_dim", "10",
              "--num_neg", "5", "--loss_type", "SQUARE", "--learn_rate",
              "0.1", "--batch_size", "1024", "--max_iters", "10",
              "--eval_iters", "5", "--skip_popularity", "--seed", str(SEED),
              "--test_ratio", "0.2"]


def phase_train_fism(torch, tmp, held):
    """CLI --task train --method FISM on the ML-1M-scale low-rank data
    (the repo's FISM configuration: D=10, num_neg 5, batch 1024 // 8 =
    128 users; SQUARE loss and lr 0.1, scripts/parity_zoo.py's), 10 epochs,
    TOPN at 0, 5 and 10. The dense-slab route: dense_R resident, B2."""
    from cdae_tpu_torch import cli
    from cdae_tpu_torch.data import io as data_io
    from cdae_tpu_torch.solver.solver import _params_finite

    cache = os.path.join(tmp, "ml1m_lowrank.bin")
    data_io.save_interactions(held["ml1m_data"], cache)
    t0 = time.perf_counter()
    solver = cli.train(cli.build_arg_parser().parse_args(
        FISM_TRAIN + ["--cache_file", cache]))
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    hist = solver.history
    finite = _params_finite(solver.state.params)
    dense = "dense_R" in solver.state.aux
    held["fism"] = solver
    return dict(phase="train_fism", users=6040, items=3706, D=10,
                batch=solver.model.cfg.batch_size, epochs=10,
                cli_seconds=cli_s, dense_R=dense,
                recall_at_10={int(r["iter"]): r["R@10"] for r in hist},
                map_at_10={int(r["iter"]): r["MAP@10"] for r in hist},
                params_finite=finite,
                ok=finite and dense and hist[-1]["R@10"] > hist[0]["R@10"])


def phase_train_fism_sparse(torch, held):
    """The same 10 epochs with dense_mode=False through SGDSolver.train:
    the sparse step, its Q + bi and P sums in B8 (scatter_mode "auto" runs
    B8 on CUDA). R@10 rises and lands within 0.15 of train_fism's."""
    import dataclasses

    import cdae_tpu_torch.ops.pallas_kernels as P
    from cdae_tpu_torch.models.fism import FISM
    from cdae_tpu_torch.solver.solver import SGDSolver, _params_finite

    dense = held["fism"]
    train, test = held["ml1m"][1]
    model = FISM(dataclasses.replace(dense.model.cfg, dense_mode=False),
                 device="cuda")
    solver = SGDSolver(model, max_iteration=10, eval_iterations=5,
                       learn_rate=dense.learn_rate0, seed=SEED,
                       verbose=False)
    before = (P.scatter_matmul.launches, P.scatter_plan.launches)
    t0 = time.perf_counter()
    solver.train(train, test, ["TOPN"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b8 = P.scatter_matmul.launches - before[0]
    plans = P.scatter_plan.launches - before[1]
    hist = solver.history
    r_s, r_d = hist[-1]["R@10"], dense.history[-1]["R@10"]
    finite = _params_finite(solver.state.params)
    held["fism_sparse"] = solver
    return dict(phase="train_fism_sparse", epochs=10, seconds=wall,
                scatter_mode=model.cfg.scatter_mode,
                steps_per_epoch=len(solver.state.aux["sparse_batches"]),
                b8_launches=b8, b8_plans=plans,
                recall_at_10={int(r["iter"]): r["R@10"] for r in hist},
                map_at_10={int(r["iter"]): r["MAP@10"] for r in hist},
                recall_at_10_dense=r_d, diff=abs(r_s - r_d),
                tol=FISM_R10_GATE, params_finite=finite,
                ok=finite and b8 > 0 and "dense_R" not in solver.state.aux
                and r_s > hist[0]["R@10"] and abs(r_s - r_d) <= FISM_R10_GATE)


def _rel_diff(torch, a, b) -> float:
    """max over tables of ||a - b|| / ||b|| (Frobenius)."""
    return max(((a[k].double() - b[k].double()).norm()
                / b[k].double().norm().clamp_min(1e-30)).item() for k in b)


def phase_fism_sparse_checks(torch, held):
    """From the same reset and seed (so the same complement draws): one
    sparse epoch with B8 against one with its plain version (index_add_,
    scatter_mode "scatter"), params within 1e-4 relative; then two runs of
    two epochs with B8, bit for bit equal (and, for the record, the same
    for index_add_)."""
    import dataclasses

    from cdae_tpu_torch.models.fism import FISM

    cfg = held["fism_sparse"].model.cfg
    lr = held["fism_sparse"].learn_rate0
    train = held["ml1m"][1][0]

    def run(mode, epochs):
        model = FISM(dataclasses.replace(cfg, scatter_mode=mode),
                     device="cuda")
        model.set_learn_rate(lr)
        state = model.reset(train, seed=SEED)
        for _ in range(epochs):
            model.train_one_iteration(state, SEED)
        torch.cuda.synchronize()
        return state.params

    rel = _rel_diff(torch, run("pallas", 1), run("scatter", 1))
    a, b = run("pallas", 2), run("pallas", 2)
    bit_equal = all(torch.equal(a[k], b[k]) for k in a)
    c, d = run("scatter", 2), run("scatter", 2)
    return dict(phase="fism_sparse_checks", rel_diff_vs_plain=rel,
                tol=ROUTE_REL_TOL, b8_runs_bit_equal=bit_equal,
                index_add_runs_bit_equal=all(torch.equal(c[k], d[k])
                                             for k in c),
                ok=rel <= ROUTE_REL_TOL and bit_equal)


def phase_train_speed_fism(torch, held):
    """Warm FISM training throughput, dense-slab and sparse (B8) routes:
    one warm-up epoch, 2 timed epochs (host clock between synchronizes),
    users/s = users * epochs / wall; then one epoch under torch.profiler
    (device kernels a step), counting B8's plans and reduces a step."""
    import dataclasses

    import cdae_tpu_torch.ops.pallas_kernels as P

    from cdae_tpu_torch.models.fism import FISM
    from cdae_tpu_torch.solver.solver import _params_finite

    cfg = held["fism"].model.cfg
    train = held["ml1m"][1][0]
    U = train.num_users
    out = dict(phase="train_speed_fism", users=U, items=train.num_items,
               batch=cfg.batch_size)
    ok = True
    for route, dense in (("dense", True), ("sparse", False)):
        model = FISM(dataclasses.replace(cfg, dense_mode=dense),
                     device="cuda")
        state = model.reset(train, seed=SEED)
        model.train_one_iteration(state, SEED)  # warm-up, builds batches
        steps = (state.aux["dense_batches"][0].shape[0] if dense
                 else len(state.aux["sparse_batches"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(2):
            model.train_one_iteration(state, SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b8 = (P.scatter_plan.launches, P.scatter_matmul.launches)
        prof = _profile(torch, lambda: model.train_one_iteration(state, SEED))
        prof["launches_per_step"] = prof.pop("device_kernels") / steps
        prof["b8_plans_per_step"] = (P.scatter_plan.launches - b8[0]) / steps
        prof["b8_reduces_per_step"] = (P.scatter_matmul.launches
                                       - b8[1]) / steps
        finite = _params_finite(state.params)
        out[route] = dict(seconds_2_epochs=wall, users_per_s=U * 2 / wall,
                          steps_per_epoch=steps,
                          ms_per_step=wall * 1e3 / (2 * steps),
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                          params_finite=finite, profiled_epoch=prof)
        ok = ok and finite
        del state
    out["ok"] = ok
    return out


def _warp_epochs(torch, held, epochs=2, data=None, **kw):
    """``epochs`` epochs of train_warp's configuration (with ``kw``) from a
    reset with the run's seed, on ``data`` (default the training split)."""
    import dataclasses

    from cdae_tpu_torch.models.mf import WARP

    model = WARP(dataclasses.replace(held["warp"].model.cfg, **kw),
                 device="cuda")
    state = model.reset(held["ml1m"][1][0] if data is None else data,
                        seed=SEED)
    for _ in range(epochs):
        model.train_one_iteration(state, SEED)
    torch.cuda.synchronize()
    return model, state


MXU = dict(gather_mode="mxu", scatter_mode="pallas")
# the native gather and index_add_ (scatter_mode "scatter": on the card
# every other mode, the default "auto" included, runs B8)
INDEX_ADD = dict(gather_mode="auto", scatter_mode="scatter")


def phase_train_warp_mxu(torch, held):
    """train_warp's configuration with gather_mode="mxu" (B9) and
    scatter_mode="pallas" (B8), 2 epochs from a reset: B7 and B2 run as
    on the default route."""
    from cdae_tpu_torch.solver.solver import _params_finite

    t0 = time.perf_counter()
    model, state = _warp_epochs(torch, held, **MXU)
    wall = time.perf_counter() - t0
    held["warp_mxu"] = state.params
    finite = _params_finite(state.params)
    return dict(phase="train_warp_mxu", epochs=2, seconds=wall,
                gather_mode=model.cfg.gather_mode,
                scatter_mode=model.cfg.scatter_mode,
                use_pallas=model.cfg.use_pallas, params_finite=finite,
                ok=finite)


def phase_warp_mxu_vs_native(torch, held):
    """The mxu route against the native gather from the same reset and
    draws. B9 is exact, so with the same B8 scatter the native gather must
    give the same bits over 2 epochs. The default route (modes "auto": the
    native gather and B8) must give the same bits on two runs, and the
    mxu route's. B8 differs from index_add_ (scatter_mode "scatter") only
    in the order of its sums: one step (an epoch of 8,000 instances)
    within 1e-4 relative. Over 2 epochs WARP's violator test and try
    counts turn rounding differences into other picks, so the index_add_
    route differs from itself between runs (its atomics): its 2-epoch
    distance to the mxu route and its run-to-run spread are printed for the
    record and gate nothing."""
    from cdae_tpu_torch.data.dataset import Interactions

    mxu = held["warp_mxu"]
    _, same = _warp_epochs(torch, held, gather_mode="auto",
                           scatter_mode="pallas")
    bit_equal = all(torch.equal(mxu[k], same.params[k]) for k in mxu)
    dmodel, default = _warp_epochs(torch, held)
    _, default2 = _warp_epochs(torch, held)
    default_repeats = all(torch.equal(default.params[k], default2.params[k])
                          for k in mxu)
    default_is_mxu = all(torch.equal(mxu[k], default.params[k]) for k in mxu)
    _, native = _warp_epochs(torch, held, **INDEX_ADD)
    _, native2 = _warp_epochs(torch, held, **INDEX_ADD)
    rel = _rel_diff(torch, mxu, native.params)
    spread = _rel_diff(torch, native2.params, native.params)
    train = held["ml1m"][1][0]
    n = 8000
    one_step = Interactions.from_arrays(
        train.users[:n], train.items[:n], train.ratings[:n],
        num_users=train.num_users, num_items=train.num_items)
    rel1 = _rel_diff(torch,
                     _warp_epochs(torch, held, 1, one_step, **MXU)[1].params,
                     _warp_epochs(torch, held, 1, one_step,
                                  **INDEX_ADD)[1].params)
    return dict(phase="warp_mxu_vs_native", epochs=2,
                default_scatter_mode=dmodel.cfg.scatter_mode,
                bit_equal_same_scatter=bit_equal,
                default_route_bit_equal_run_to_run=default_repeats,
                default_route_bit_equal_mxu=default_is_mxu,
                rel_diff_one_step=rel1, rel_diff_index_add=rel,
                index_add_run_to_run=spread, tol=ROUTE_REL_TOL,
                ok=bit_equal and default_repeats and default_is_mxu
                and rel1 <= ROUTE_REL_TOL)


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        import cdae_tpu_torch.ops.pallas_kernels as P
        from cdae_tpu_torch.ops import cuda_lib
    except ImportError as e:
        print(f"chip_smoke: cdae_tpu_torch not found beside the script "
              f"({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 references
    torch.backends.cudnn.allow_tf32 = False
    failed = []

    def run(name, fn):
        try:
            row = fn()
        except Exception as e:  # report every phase, then fail the run
            traceback.print_exc()
            emit(dict(phase=name, ok=False, error=f"{type(e).__name__}: {e}"))
            failed.append(name)
            return None
        if row is not None:
            emit(row)
            if row.get("ok") is False:
                failed.append(name)
        return row

    def build():
        t0 = time.perf_counter()
        log = cuda_lib.build()
        cuda_lib.lib()
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        return dict(phase="build", seconds=time.perf_counter() - t0,
                    library=os.path.relpath(cuda_lib.library_path(), repo),
                    ptxas=usage)

    results = {}
    run("build", build)
    run("kernel", lambda: phase_kernels(torch, P, results))
    run("kernel_train", lambda: phase_train_kernels(torch, results))

    launches = {}
    held, n_users = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        # each path: its counts start at 0 here and are read after it
        reset_counts("serving")
        run("slice", lambda: phase_slice(torch, tmp, n_users))
        run("csr_1m", lambda: phase_1m(torch, "csr_1m", 20_000, 1024, False,
                                       held))
        run("dense_1m", lambda: phase_1m(torch, "dense_1m", 1_000, 64, True,
                                         held))
        read_counts("serving", launches, failed)
        run("verify", lambda: phase_verify(torch, held))
        held.clear()

        reset_counts("training")
        run("train_ml1m", lambda: phase_train_ml1m(torch, tmp, held))
        read_counts("training", launches, failed)
    if "ml1m" in held:
        run("train_vs_plain", lambda: phase_train_vs_plain(torch, held))
        reset_counts("fused_training")
        run("train_ml1m_fused", lambda: phase_train_ml1m_fused(torch, held))
        read_counts("fused_training", launches, failed)
        run("train_speed", lambda: phase_train_speed(torch, held))
    else:
        failed.append("training phases (no ML-1M run to build on)")

    run("kernel_warp", lambda: phase_kernel_warp(torch, results))
    if "ml1m_data" in held:
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts("warp_training")
            run("train_warp", lambda: phase_train_warp(torch, tmp, held))
            read_counts("warp_training", launches, failed)
    if "warp" in held:
        run("train_warp_xla", lambda: phase_train_warp_xla(torch, held))
        run("train_speed_warp", lambda: phase_train_speed_warp(torch, held))
    else:
        failed.append("WARP training phases (no WARP run to build on)")

    if "ml1m_data" in held:
        run("kernel_scatter", lambda: phase_kernel_scatter(torch, held,
                                                           results))
        run("kernel_gather", lambda: phase_kernel_gather(torch, results))
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts("fism_training")
            run("train_fism", lambda: phase_train_fism(torch, tmp, held))
            if "fism" in held:
                run("train_fism_sparse",
                    lambda: phase_train_fism_sparse(torch, held))
            read_counts("fism_training", launches, failed)
    if "fism_sparse" in held:
        run("fism_sparse_checks", lambda: phase_fism_sparse_checks(torch,
                                                                   held))
        run("train_speed_fism", lambda: phase_train_speed_fism(torch, held))
    else:
        failed.append("FISM phases (no FISM runs to build on)")
    if "warp" in held:
        reset_counts("warp_mxu")
        run("train_warp_mxu", lambda: phase_train_warp_mxu(torch, held))
        read_counts("warp_mxu", launches, failed)
    if "warp_mxu" in held:
        run("warp_mxu_vs_native", lambda: phase_warp_mxu_vs_native(torch,
                                                                   held))
    else:
        failed.append("WARP mxu phases (no WARP run to build on)")
    emit(dict(phase="wall", seconds=time.perf_counter() - t_start))

    table = []
    for name, (_, source, replaces, paths) in KERNELS.items():
        r = results.get(name, {})
        by_path = launches.get(name, {})
        dev_ms = r.get("device_ms")  # B8's is a dict: its span's
        table.append(dict(name=name, route="cuda", source=source,
                          replaces=replaces,
                          launches=by_path.get(paths[0], 0),
                          launches_by_path=by_path,
                          max_abs_err=r.get("max_abs_err"), ms=r.get("ms"),
                          device_ms=dev_ms.get("span")
                          if isinstance(dev_ms, dict) else dev_ms,
                          plain_ms=r.get("plain_ms"),
                          bound_ms=r.get("bound_ms"),
                          bound_by=r.get("bound_by"),
                          library_ms=r.get("library_ms")))
        shapes = results.get("_shapes", {}).get(name, [])
        if len(shapes) > 1:
            table[-1]["shapes"] = [shape_summary(row) for row in shapes]
    emit({"kernels": table})
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi failed: {e}"
        failed.append("nvidia-smi")
    print(smi, flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

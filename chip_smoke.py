#!/usr/bin/env python3
"""Drive cdae_tpu_torch once on one CUDA GPU and check what comes out.

Phases, each printed as one JSON line:
  build   -- compile the CUDA kernels from cdae_tpu_torch/csrc (nvcc, one
             process per source, in parallel)
  kernel  -- each kernel against its plain PyTorch version on the card, at
             the shapes its path gives it (B1 and B7 also at a sharded
             step's offsets, bit for bit the slice of the whole launch);
             error, median spans and device
             time (device_ms; beside the library call's where one exists),
             for every kernel here and in the phases below; the fused step
             (B4) also the same bits on a second launch, and B4, B5 and B6
             one call under torch.profiler (each launch's span); B2 also
             over each training path's dense tables in one launch, beside
             the same tables as one-table calls, the library's AdaGrad over
             the list and the launch floor (an empty kernel's device time)
  kernel_csr_rows -- recommend's rated rows (csr_rows) against its plain
             version on the card and the host's rows_from_csr, bit for bit,
             at a serve_batch request (1,024 users, L = 1,268) and a
             serve_online one (32 users, L = 316), repeated uids included,
             from a CSR of ML-20M's 138,493 x 26,744 with rows drawn like
             its cells'; span, device time, the plain version's, the host
             rows and their two copies it replaced (host_rows_ms), and the
             bytes bound
  serve_recommend_1m -- recommend(k=10) for 1,024 users over 1,000,000
             items at D=50 (cdae_1m.serve_batch's request) on both routes:
             the fused decode + top-k (B6, recommend's route above
             _TOPK_DEFER_CELLS) and the (B, I) slab (B3 and the sort):
             each one's wall a request, device ms, peak memory, B6 and B3
             launches, and its lists' widest gap below the plain float32
             top-10 (under 1e-6); the rows whose ids agree
  serving path (counts from 0 before slice, read after dense_1m; B3, the
  fused top-k kernels, csr_rows):
    slice   -- ML-1M-scale CDAE serving at D=50 through the CLI --task test
               (dense_R encode + decode kernel + TOPN), checked against the
               plain path on the same checkpoint
    csr_1m  -- 20,000 users x 1,000,000 items through the TOPN evaluator:
               no dense_R, so the fused CSR top-k kernel serves
    dense_1m-- 1,000 users x 1,000,000 items, batch_size 64 so the 1 GB
               int8 dense_R stays resident: the fused dense top-k kernel
               (each 1M-item run also: recommend(k=10) for 256 users, its
               rows built by csr_rows, the same ids as the rows built on
               the host by rows_from_csr and copied over)
  verify  -- one batch of each 1M-item run: kernel ids against the plain
             streaming scan
  training path (counts from 0 before, read after):
    train_ml1m -- ML-1M-scale low-rank data, D=50, 10 epochs through the CLI
               --task train (hw_uniform masks, one adagrad_update sweep a
               step); R@10 must rise; then one epoch with the kernels
               against one with the plain versions from the same reset
  fused training path (counts from 0 before, read after; B4, B2):
    train_ml1m_fused -- the same 10 epochs with fused_step=True through
               Solver.train: R@10 within 0.02 of the unfused run
  train_speed -- warm training users/s, unfused and fused: ML-1M (D=50)
             and config-4 (50,000 x 20,000, D=200, 1 GB dense_R); B2 once
             a step (as in train_speed_warp and train_speed_fism)
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
  CDAE's sparse step (counts from 0 before train_sparse_ml1m, read after
  train_sparse_1m; B1, B8's plan and reduce, B2):
    train_sparse_ml1m -- the ML-1M-scale low-rank data, D=50, --dense_mode
             false, 10 epochs through the CLI --task train, Popularity
             first: R@10 rises and ends above 0.10 (its distance to
             train_ml1m's printed)
    train_sparse_ml20m -- config 3's shape (ML-20M's 138,493 x 26,744,
             synthetic), D=200, exact negatives, picked by the auto rule:
             30 length-stratified token-budget batches (262,144 slots),
             timed after a warm pass, then profiled (launches, B8 plans
             and reduces a step, idle share, peak memory); TOPN on 2,048
             held-out users (B3)
    train_sparse_1m -- config 5's catalog (1,000,000 items, 200,000 users),
             D=50: the same protocol with neg_pool 8192, then exact
  sparse_ml1m_checks -- two 2-epoch sparse runs bit for bit; one epoch
             with the kernels against their plain versions; the corruption-0
             dense/sparse identity (16 users elementwise, 1024 per table)
  the rest of the MF family (counts from 0 before train_imf, read after
  train_imf_mxu; B1, B2, B8's plan and reduce, B9), D=10, batch 8192, on the
  same ML-1M-scale data:
    train_imf -- CLI --method MF (IMF) --fast_rng, 10 epochs: the user slab
             by the auto rule (B1's uniforms, B2, B8 in the user rows'
             delta AdaGrad); R@10 rises
    train_imf_sparse -- the same with --dense_mode false: sample_unrated,
             B8, B2; R@10 rises (its distance to train_imf printed)
    train_pmf -- lowrank_rated data of the same dimensions, --method PMF
             --eval RMSE,MAE, the slab and --dense_mode false: RMSE falls
             from epoch 0 to 10 on both
    train_bpr -- --method BPR (LOG; the sparse step), then --dense_mode true
             at 2x lr: R@10 rises on both
    train_warp_routes -- 2 epochs of train_warp's configuration on the slab
             (pool 1024, 3x lr, 64 users a slab), the pool path with the
             rated mask and with the CSR rows (the same bits) and the scan
             path: R@10 rises on each
    train_imf_mxu -- one epoch of train_imf_sparse with gather_mode="mxu"
             (B9): the native gather's bits
  mf_checks -- IMF sparse, BPR sparse, PMF slab and the WARP slab: one epoch
             with the kernels against one with their plain versions, 1e-4
             relative per table; two 2-epoch runs of each default route bit
             for bit
  train_speed_mf -- warm users/s, ms and launches a step, B1/B2/B8 launches
             a step, device ms (B8's apart), idle share and peak memory for
             IMF (slab, sparse), PMF sparse, BPR (sparse, slab), WARP slab
  ALS/WRMF and ItemCF/UserCF on the same ML-1M-scale split (counts from 0
  before serve_itemcf, read after serve_usercf: the cf_serving path, B8's
  plan and reduce):
    train_als -- CLI --method ALS, D=10, lambda 0.01, 10 iterations,
             Popularity first: R@10 rises from iteration 0
    train_wrmf -- CLI --method WRMF --scalar 40 (the ridge solve), then the
             eigh solve through Solver.train: R@10 rises in both
    serve_itemcf / serve_usercf -- CLI --method ITEMCF / USERCF, Jaccard,
             top-50 (the neighbour build, then TOPN, whose scores B8
             sums): UserCF's R@10 above Popularity's on the same split
             (ItemCF's printed beside it); a warm neighbour build and a
             warm TOPN pass timed
  cf_checks -- two scorings of one batch and two TOPN passes of each CF
             model the same bits, R@10 equal to the CPU build's (1e-6),
             the neighbour ids equal the CPU's; B8 at the ItemCF scoring
             shape against its plain version (its kernel-table row,
             beside index_add_); the two sweeps of one ALS and one
             WRMF-ridge iteration on the card against the CPU's from the
             same inputs, 1e-4 relative per table on the full-rank rows;
             a whole iteration from the trained factors against the CPU's
             beside the CPU's own one-ulp spread (printed)
  zoo_speed -- ALS, WRMF ridge and WRMF eigh: ms an iteration (warm,
             synchronised), device ms and idle share under torch.profiler,
             peak memory
  the feature-group models (counts from 0 before train_negmf, read after
  train_fm: the linear_training path, B8's plan and reduce), trained by
  SGDSolver through the CLI:
    train_negmf -- --method NEGMF on the ML-1M-scale low-rank split, D=10,
             batch 4096, num_neg 5, LOG, 10 epochs: R@10 rises
    train_negmf_dense -- the same with --dense_mode true at 2x lr (2
             slabs of (4096, 3706) an epoch): R@10 rises
    train_linear / train_fm -- --method LINEAR / FM (D=10) --eval RMSE on
             lowrank_rated data of the same dimensions, batch 1024, 10
             epochs: the training objective falls; FM's test RMSE falls,
             LINEAR's stays within 0.02 of the global mean's (the data
             hold no bias signal)
  linear_checks -- each of those routes: one epoch on the card against
             one on the CPU from the same tables and draws, 1e-5 relative
             per table; two 2-epoch runs the same bits; B8 at the NegMF
             step's shape (49,152 ids x 11 columns into 9,746 rows)
             against its plain version, beside index_add_ (its kernel-table
             row)
  linear_speed -- warm users/s (instances/s for LINEAR and FM), ms and
             launches a step, B8 plans and reduces a step, device ms, idle
             share and peak memory of each route
  the single-card leftovers (counts from 0 before native_loader, read after
  sweep: the leftovers path, B1, B2 and B3):
    native_loader -- the host loader (g++ builds it here; it must be
             available): the ML-1M-scale data as ``user item rating`` and
             ``u::i::r::ts`` lines, each parsed natively and by the Python
             loop (arrays and vocabularies equal, both walls); the ML-20M
             shape (~20M lines) through the CLI --task prepare (the native
             parse's wall and the task's; the cache equal to the parse),
             then the Python loop over it (its wall, cut to a prefix, and
             the cut printed, when the phase would pass 120 s)
    recommend -- recommend(k=10) for all 6,040 users in batches of 1,024 on
             train_ml1m's trained CDAE (B3 decodes) and on
             train_imf_sparse's IMF: no rated id in any list; CDAE's ids
             against the plain path's (use_pallas=False) and against the
             lists TOPN ranks for the same users, IMF's against the CPU's
             from the same params (equal where the reference's scores are
             TOL apart); users/s
    sweep -- --task sweep --sweep_limit 12 --max_iters 50 --batch_size 64
             through the CLI on lowrank_interactions(2000, 800, 40), the
             data of SWEEP_CDAE_r2.jsonl (B1 and one B2 launch a step, B3
             in each point's TOPN): 12 lines, grid indices 0-11, configs
             paper_grid()'s, R@10 and MAP@10 finite; each point's R@10
             beside the record's, |mean delta| <= 0.03; seconds a point
  the sharded path (counts from 0 before sharded_nccl, read after it: B1,
  B2, B3, B5, B6, B7, B8):
    sharded_nccl -- one rank over NCCL in this process: --task train
             --sharded true --method CDAE through the CLI at ML-1M width
             (D=50, batch 1024), 2 epochs, --dense_mode true (B1, B2; TOPN
             through B5) and false (B8, B2; TOPN through B6), each beside
             the same command without --sharded: the tables bit for bit,
             the TOPN lists equal to the single card's lists of the same
             kernel and, where the 10th and 11th scores are TOL apart, to
             its evaluator's (B3 + topk_unrated); the sharded scores (B3)
             equal to the single card's; a ShardedPairwise WARP epoch (B7,
             B8) bit for bit; warm users/s of a third epoch beside the
             single card's
    sharded_gloo -- two ranks on the one card over gloo (NCCL refuses two
             ranks on one device), spawned (``--sharded-rank``):
             ShardedCDAE 1 x 2 dense and sparse (its lists through B6) and
             2 x 1 dense, ShardedMFTP IMF and BPR (its lists), ShardedPairwise
             WARP (B7 at each rank's row offset: one step held to the
             tables' limit, the epoch to R@10's 0.005), ShardedNegMF,
             ShardedIMF, ShardedFISM, ShardedALS / WRMF, 1-2 epochs each
             against the single card (||a - b|| / ||b|| <= 1e-4 per
             table; the lists by the TOL rule), a sharded checkpoint saved
             after epoch 1 and resumed bit for bit; warm users/s of the
             dense 1 x 2 CDAE -- host-staged collectives on one card, not
             scaling; each rank's launches
Then the whole run's wall time, the kernel table (each kernel's launches
summed over the main paths that run it, beside them by path; B8's plan has
a row of its own; a kernel timed at several shapes lists them all under
``shapes``, B8's with its plan, reduce and index_add_ device times apart,
and a shape of one main path with its launches on that path; bound_ms is the least
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

# name -> (module of the wrapper, source, TPU kernel it replaces, the main
# paths that must launch it; the table's launch count sums them)
KERNELS = {
    # recommend and the sweep's TOPN decode through B3 too
    "decode_scores": ("pallas_kernels", "cdae_tpu_torch/csrc/decode_scores.cu",
                      "cdae_tpu/ops/pallas_kernels.py:53",
                      ("serving", "leftovers", "sharded")),
    "fused_topk_scores": ("pallas_kernels",
                          "cdae_tpu_torch/csrc/fused_topk.cu",
                          "cdae_tpu/ops/pallas_kernels.py:557",
                          ("serving", "sharded")),
    "fused_topk_scores_csr": ("pallas_kernels",
                              "cdae_tpu_torch/csrc/fused_topk.cu",
                              "cdae_tpu/ops/pallas_kernels.py:641",
                              ("serving", "sharded")),
    "hw_uniform": ("pallas_kernels", "cdae_tpu_torch/csrc/hw_uniform.cu",
                   "cdae_tpu/ops/pallas_kernels.py:178",
                   ("training", "sparse_training", "mf_training",
                    "leftovers", "sharded")),
    "adagrad_update": ("pallas_kernels",
                       "cdae_tpu_torch/csrc/adagrad_update.cu",
                       "cdae_tpu/ops/pallas_kernels.py:108",
                       ("training", "fused_training", "warp_training",
                        "fism_training", "warp_mxu", "sparse_training",
                        "mf_training", "leftovers", "sharded")),
    "cdae_dense_step_fused": ("cdae_fused", "cdae_tpu_torch/csrc/cdae_fused.cu",
                              "cdae_tpu/ops/cdae_fused.py:249",
                              ("fused_training",)),
    "warp_violator_select": ("pallas_kernels",
                             "cdae_tpu_torch/csrc/warp_select.cu",
                             "cdae_tpu/ops/pallas_kernels.py:1028",
                             ("warp_training", "warp_mxu", "sharded")),
    # WARP's default route, CDAE's sparse step, the ItemCF/UserCF scoring
    # and the feature-group models' steps sum through B8 too
    "scatter_matmul": ("pallas_kernels", "cdae_tpu_torch/csrc/scatter_rows.cu",
                       "cdae_tpu/ops/pallas_kernels.py:1147",
                       ("fism_training", "warp_training", "warp_mxu",
                        "sparse_training", "mf_training", "cf_serving",
                        "linear_training", "sharded")),
    # B8's id sort (the TPU kernel contracts one-hot tiles and sorts
    # nothing): a wrapper and a count of its own
    "scatter_plan": ("pallas_kernels", "cdae_tpu_torch/csrc/scatter_rows.cu",
                     "cdae_tpu/ops/pallas_kernels.py:1147",
                     ("fism_training", "warp_training", "warp_mxu",
                      "sparse_training", "mf_training", "cf_serving",
                      "linear_training", "sharded")),
    "gather_rows_mxu": ("pallas_kernels", "cdae_tpu_torch/csrc/gather_rows.cu",
                        "cdae_tpu/ops/pallas_kernels.py:856",
                        ("warp_mxu", "mf_training")),
    # recommend's rated rows: the serving path's recommend and the
    # leftovers' recommend phase
    "csr_rows": ("pallas_kernels", "cdae_tpu_torch/csrc/csr_rows.cu",
                 "no TPU kernel (cdae_tpu/data/dataset.py:397 rows_from_csr "
                 "is host numpy)", ("serving", "leftovers")),
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


def read_counts(path: str, launches: dict, failed: list,
                counts=None) -> None:
    """Record the launch counts of ``path``'s kernels in
    ``launches[name][path]`` (the wrappers' counts, or ``counts``: name ->
    launches, where the path's own runs were counted apart); a kernel of
    the path that never launched fails the run."""
    for name, spec in KERNELS.items():
        if path not in spec[3]:
            continue
        n = (wrapper(name).launches if counts is None
             else counts.get(name, 0))
        launches.setdefault(name, {})[path] = n
        if n == 0:
            emit(dict(phase="launches", path=path, kernel=name, ok=False,
                      error="the main path never launched this kernel"))
            failed.append(f"launches:{name}")


# a row's shape keys and measurements, as the kernel table repeats them
SHAPE_KEYS = ("B", "I", "D", "k", "nn", "shape", "case", "tables", "P", "N",
              "C", "path")
MEASURE_KEYS = ("max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
                "host_rows_ms",
                "library", "library_device_ms", "launch_floor_ms",
                "one_table_calls_ms", "one_table_calls_device_ms",
                "bound_ms", "bound_by", "bound_f32_ms")


def record(results, name, row) -> None:
    """Keep a kernel's row: the first shape's is the kernel's own in the
    table, and every shape's row is listed under it (``shapes``)."""
    results.setdefault(name, row)
    results.setdefault("_shapes", {}).setdefault(name, []).append(row)


def shape_summary(row, by_path) -> dict:
    """A shape's row in the kernel table; B8's device times split into its
    span, plan, reduce and index_add_'s; a row of a main path
    (``path``) carries the kernel's launches on that path."""
    out = {k: row[k] for k in SHAPE_KEYS + MEASURE_KEYS if k in row}
    if isinstance(out.get("device_ms"), dict):
        dev = out["device_ms"]
        out.update(device_ms=dev.get("span"), device_plan_ms=dev.get("plan"),
                   device_reduce_ms=dev.get("reduce"),
                   library_device_ms=dev.get("index_add"))
    if "path" in row:
        out["launches"] = by_path.get(row["path"])
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

    # B3 decode_scores at the ML-1M (D=50; recommend's too) and
    # config-4-width (D=200) shapes, and the sweep's TOPN batch
    for B, I, D in ((1024, 3706, 50), (1024, 20000, 200), (1024, 800, 50)):
        z = torch.rand(B, D, generator=g, device=dev)
        W, bp = normal(I, D, scale=0.1), normal(I, scale=0.1)
        out = P.decode_scores(z, W, bp)
        ref = P.decode_scores_plain(z, W, bp)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        row = dict(phase="kernel", kernel="decode_scores", B=B, I=I, D=D,
                   max_abs_err=err, tol=TOL,
                   **(dict(path="leftovers") if I == 800 else {}),
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


# each training path's dense tables, as one step hands them to B2: CDAE's W,
# b' and b at ML-1M (D=50) and config-4 (D=200), beta 1; WARP's uv and iv
# (its step leaves the biases, as warp.hpp does) and FISM's bu, Q, bi and
# P at ML-1M, D=10, beta 0
ADAGRAD_SETS = (
    ("cdae_ml1m", ((3706, 50), (3706,), (50,)), 1.0),
    ("cdae_config4", ((20000, 200), (20000,), (200,)), 1.0),
    ("warp_ml1m", ((6040, 10), (3706, 10)), 0.0),
    ("fism_ml1m", ((6040,), (3706, 10), (3706,), (3706, 10)), 0.0),
    # PMF's and IMF's sparse steps: uv, ub, iv, ib
    ("mf_ml1m", ((6040, 10), (6040,), (3706, 10), (3706,)), 1.0),
    # an asymmetric sweep point's dense step (800 items, D=50): W, b', V, b
    ("cdae_sweep", ((800, 50), (800,), (800, 50), (50,)), 1.0),
)


def _library_adagrad(torch, tables, beta):
    """torch.optim.Adagrad over the tables' params (sum += g^2; p -= lr * g
    / (sqrt(sum) + eps), with eps = beta this update): fused where this
    PyTorch takes CUDA tensors for it, else foreach. Returns (step, name);
    it updates copies of the params."""
    for kw in (dict(fused=True), dict(foreach=True)):
        params = [p.clone().requires_grad_(True) for p, _, _ in tables]
        for x, (_, _, gr) in zip(params, tables):
            x.grad = gr
        try:
            opt = torch.optim.Adagrad(params, lr=0.1, eps=beta,
                                      initial_accumulator_value=1e-4, **kw)
            opt.step()
            torch.cuda.synchronize()
        except (RuntimeError, ValueError):
            continue
        return opt.step, "Adagrad(%s=True)" % next(iter(kw))
    raise RuntimeError("torch.optim.Adagrad takes neither fused nor foreach")


def phase_adagrad_tables(torch, P, g, results) -> bool:
    """B2 over each path's table set (ADAGRAD_SETS) in one launch: bit-equal
    to the plain version table by table with f32 params and with every
    other param in bf16; the launch counted once. Times: the call's span,
    its device time, the same tables as a sequence of one-table calls,
    the plain version, the library's AdaGrad over the same list, and the
    launch floor (the device time of an empty kernel, torch.cuda._sleep(0),
    in the same queue). Returns whether every set was bit-equal."""
    dev = torch.device("cuda")
    ok = True

    def make(shapes, bf16):
        out = []
        for k, shape in enumerate(shapes):
            p = torch.randn(shape, generator=g, device=dev) * 0.1
            out.append((p.to(torch.bfloat16) if k % 2 and bf16 else p,
                        torch.rand(shape, generator=g, device=dev) + 1e-4,
                        torch.randn(shape, generator=g, device=dev)))
        return out

    floor = device_ms(lambda: torch.cuda._sleep(0))
    for name, shapes, beta in ADAGRAD_SETS:
        equal = {}
        for bf16 in (False, True):
            tabs = make(shapes, bf16)
            want = [(p.clone(), a.clone(), gr) for p, a, gr in tabs]
            P.adagrad_update_tables_plain(want, 0.1, beta)
            before = P.adagrad_update.launches
            P.adagrad_update_tables(tabs, 0.1, beta)
            torch.cuda.synchronize()
            one = P.adagrad_update.launches == before + 1
            errs = [max((p.float() - wp.float()).abs().max().item(),
                        (a - wa).abs().max().item())
                    for (p, a, _), (wp, wa, _) in zip(tabs, want)]
            equal["bf16" if bf16 else "f32"] = dict(
                bit_equal=one and all(torch.equal(p, wp) and torch.equal(a, wa)
                                      for (p, a, _), (wp, wa, _)
                                      in zip(tabs, want)),
                one_launch=one, max_abs_err=max(errs))
        tabs = make(shapes, False)
        step, library = _library_adagrad(torch, tabs, beta)
        n = sum(p.numel() for p, _, _ in tabs)

        def call():
            P.adagrad_update_tables(tabs, 0.1, beta)

        def one_table_calls():
            for p, a, gr in tabs:
                P.adagrad_update(p, a, gr, 0.1, beta)

        row = dict(phase="kernel", kernel="adagrad_update", case=name,
                   tables=[list(s) for s in shapes], elements=n,
                   **(dict(path="leftovers") if name == "cdae_sweep"
                      else {}),
                   beta=beta, gates=equal,
                   max_abs_err=max(v["max_abs_err"] for v in equal.values()),
                   # spans over 21 calls: the host's share of a small
                   # set's span varies from call to call
                   ms=median_ms(call, reps=21), device_ms=device_ms(call),
                   host_us=_host_us(torch, call),
                   one_table_calls_ms=median_ms(one_table_calls, reps=21),
                   one_table_calls_device_ms=device_ms(one_table_calls),
                   plain_ms=median_ms(lambda: P.adagrad_update_tables_plain(
                       tabs, 0.1, beta)),
                   library=library, library_ms=median_ms(step),
                   library_device_ms=device_ms(step),
                   launch_floor_ms=floor,
                   # f32 params: 3 reads and 2 writes of 4 bytes an
                   # element; 7 operations
                   **bound(20.0 * n, 7.0 * n))
        emit(row)
        record(results, "adagrad_update", row)
        ok = ok and all(v["bit_equal"] for v in equal.values())
    return ok


def phase_train_kernels(torch, results):
    """B1, B2 and B4 against their plain versions at the training path's
    shapes: ML-1M (I=3706, D=50) and config-4 (I=20000, D=200), B=1024;
    B1 also at the IMF slab's (6040, 3706)."""
    import cdae_tpu_torch.ops.pallas_kernels as P
    from cdae_tpu_torch.ops import cdae_fused as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    bad = []

    # B1 hw_uniform: bit-equal to the plain int64 version; the last shape
    # is a sweep step's (batch 64, 800 items)
    for shape in ((1024, 3706), (1024, 20000), (6040, 3706), (64, 800)):
        out = P.hw_uniform(SEED, shape, 1, device=dev)
        ref = P.hw_uniform_plain(SEED, shape, 1, device=dev)
        torch.cuda.synchronize()
        equal = bool(torch.equal(out, ref))
        row = dict(phase="kernel", kernel="hw_uniform", shape=list(shape),
                   bit_equal=equal,
                   **(dict(path="leftovers") if shape == (64, 800) else {}),
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

    # B1 at a sharded step's offsets: the (1024, 1853) column block of a
    # 1 x 2 mesh and the (512, 3706) row block of a 2 x 1 mesh, bit for bit
    # the slice of the whole (1024, 3706) draw and the plain version's
    whole = P.hw_uniform(SEED, (1024, 3706), 0, device=dev)
    for shape, r0, c0 in (((1024, 1853), 0, 1853), ((512, 3706), 512, 0)):
        blk = P.hw_uniform(SEED, shape, 0, device=dev, row_offset=r0,
                           col_offset=c0)
        plain = P.hw_uniform_plain(SEED, shape, 0, device=dev,
                                   row_offset=r0, col_offset=c0)
        torch.cuda.synchronize()
        equal = bool(torch.equal(blk, whole[r0:r0 + shape[0],
                                            c0:c0 + shape[1]])
                     and torch.equal(blk, plain))
        emit(dict(phase="kernel", kernel="hw_uniform", case="offsets",
                  shape=list(shape), row_offset=r0, col_offset=c0,
                  bit_equal=equal))
        if not equal:
            bad.append(f"hw_uniform offsets {(r0, c0)}")

    # B2 over each training path's dense tables in one launch (the first
    # row, CDAE's at ML-1M, is the kernel's own in the table)
    if not phase_adagrad_tables(torch, P, g, results):
        bad.append("adagrad_update_tables")

    # B2 adagrad_update on one table: in place, f32 or bf16 param; _rn
    # intrinsics make it bit-equal (max relative error 0)
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
    same = _recommend_vs_host_rows(torch, model, state, train)
    return dict(phase=name, users=U, items=I, D=50, val_users=n_val,
                dense_R=expect_dense, setup_s=setup_s,
                first_test_time_s=first["TestTime"],
                test_time_s=warm["TestTime"],
                users_per_s=n_val / warm["TestTime"],
                topn=dict(zip(metrics.TOPN_COLUMNS, cols)),
                recommend_equal_host_rows=same,
                ok=all(map(_finite, cols)) and same)


def _recommend_vs_host_rows(torch, model, state, train, B=256):
    """recommend(k=10) for the first ``B`` users (rows by csr_rows) against
    the same scores and top-k over rows built on the host by
    rows_from_csr and copied over: the same ids, bit for bit."""
    import numpy as np

    from cdae_tpu_torch.data.dataset import rows_from_csr
    from cdae_tpu_torch.ops.topk import topk_unrated

    uids = np.arange(min(B, train.num_users), dtype=np.int32)
    ids = model.recommend(state, uids, train, k=10)
    rated, _, mask, _ = rows_from_csr(train.csr(), uids, train.num_items)
    rated = torch.as_tensor(rated, device="cuda")
    scores = model.batch_scores(state, uids, rated,
                                torch.as_tensor(mask, device="cuda"))
    want, _ = topk_unrated(scores, rated, 10)
    return bool(torch.equal(ids, want))


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
    20,000, D=200, dense_R 1 GB int8), batch 1024. B2 must launch once a
    step on both."""
    import dataclasses

    import cdae_tpu_torch.ops.pallas_kernels as P
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
            b2 = P.adagrad_update.launches
            t0 = time.perf_counter()
            model.train_epochs(state, 2, SEED)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps = 2 * state.aux["dense_batches"][0].shape[0]
            key = "fused" if fused else "unfused"
            cell[key] = dict(
                seconds_2_epochs=wall,
                users_per_s=train.num_users * 2 / wall,
                ms_per_step=wall * 1e3 / steps,
                # W, b' and b unfused, b after the fused step: one launch
                b2_launches_per_step=(P.adagrad_update.launches - b2) / steps,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            ok = ok and cell[key]["b2_launches_per_step"] == 1.0
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
        # a data rank's half of the batch at its row offset (sharded WARP
        # on a 2 x 1 mesh): the whole launch's counts and picks there
        half = B // 2
        sub = [a[half:].contiguous() if a.dim() and a.shape[0] == B else a
               for a in args[:5]]
        o_nviol, o_j = P.warp_violator_select(SEED, *sub, nn,
                                              row_offset=half)
        torch.cuda.synchronize()
        o_equal = bool(torch.equal(o_nviol, nviol[half:])
                       and torch.equal(o_j, j[half:]))
        emit(dict(phase="kernel_warp", kernel="warp_violator_select",
                  case="offsets", B=B - half, row_offset=half, I=I, D=D,
                  nn=nn, equal=o_equal))
        if not o_equal:
            bad.append(f"warp_violator_select row_offset {(B, I)}")
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


def _profile(torch, fn, groups=None, host=False) -> dict:
    """One call of ``fn`` under torch.profiler: host wall, device busy time
    (the sum of the CUDA kernels' spans on the one stream), idle share and
    the largest kernels; with ``groups`` (label -> kernel-name parts) also
    the device ms of each group's kernels; with ``host`` the host ops of
    the largest self CPU time. Without device events the device numbers
    are None (not measured)."""
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
    out = dict(wall_ms=wall_ms, device_busy_ms=busy,
               idle_share=None if busy is None else 1.0 - busy / wall_ms,
               device_kernels=kernels,
               top_kernels_ms=[[n[:80], ms] for n, ms in top])
    if host:
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        out["top_host_ops_ms"] = [[e.key[:60], e.self_cpu_time_total / 1e3,
                                   e.count] for e in ops[:8]]
    if groups:
        out["group_device_ms"] = {
            label: (sum(ms for n, ms in by_name.items()
                        if any(part in n for part in parts))
                    if by_name else None)
            for label, parts in groups.items()}
    return out


def phase_train_speed_warp(torch, held):
    """Warm WARP training throughput, kernel and cumsum routes: one
    warm-up epoch, then 2 timed epochs (host clock between synchronizes);
    users/s = users * epochs / wall; then one more epoch under
    torch.profiler for the device busy time and idle share. B2 must
    launch once a step on the kernel routes."""
    import dataclasses

    import cdae_tpu_torch.ops.pallas_kernels as P
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
        b2 = P.adagrad_update.launches
        t0 = time.perf_counter()
        for _ in range(2):
            model.train_one_iteration(state, SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b2 = (P.adagrad_update.launches - b2) / (2 * steps)
        prof = _profile(torch, lambda: model.train_one_iteration(state, SEED))
        prof["launches_per_step"] = prof.pop("device_kernels") / steps
        finite = _params_finite(state.params)
        out[route] = dict(
            seconds_2_epochs=wall, users_per_s=train.num_users * 2 / wall,
            instances_per_s=n * 2 / wall,
            ms_per_step=wall * 1e3 / (2 * steps),
            # uv and iv in one launch (none on the cumsum route)
            b2_launches_per_step=b2,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            params_finite=finite, profiled_epoch=prof)
        ok = ok and finite and b2 == (1.0 if kw["use_pallas"] else 0.0)
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
    aggregation, (P, 10), of the largest batch of the run's data), at
    WARP's (49,152 item rows x 11, 8,192 user rows x 10) and at CDAE's
    sparse step's (an ML-20M batch's 262,144 ids x 201 columns, a
    1M-item pool's 8,192 x 51) and the MF family's (IMF's 49,152 user rows
    x 11, the BPR slab's 193,280 negative rows x 11, the WARP slab's 1,024
    pool rows x 10), with f32 and bf16 contributions. The plan must equal
    its plain version (the library's
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
                                         device=dev), U, 10),
             # CDAE's sparse step: an ML-20M token-budget batch's positives
             # or negatives ([W | b'] of D=200, padding ids as the
             # sentinel) and a 1M-item pool's [W | b'] sums (D=50)
             ("cdae_ml20m_items", torch.randint(0, 29_000, (262_144,),
                                                generator=g, device=dev),
              26_744, 201),
             ("cdae_1m_pool", torch.randint(0, 1_000_000, (8192,),
                                            generator=g, device=dev),
              1_000_000, 51),
             # the MF family at batch 8192: IMF's and PMF's user sums
             # ([uv | ub] of 8,192 x 6 instances), the BPR slab's 6,040 x 32
             # negative rows, the WARP slab's 1,024 pool rows
             ("imf_user", torch.randint(0, U, (49152,), generator=g,
                                        device=dev), U, 11),
             ("bpr_slab_neg", torch.randint(0, I, (6040 * 32,), generator=g,
                                            device=dev), I, 11),
             ("warp_slab_pool", torch.randint(0, I, (1024,), generator=g,
                                              device=dev), I, 10))
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
    table, 8,192 rows) and IMF's (the (6040, 11) user table with its bias
    column, 49,152 rows), then with ids out of range, whose rows must be
    zero. library_ms: torch.index_select on the same (in-range) ids."""
    import cdae_tpu_torch.ops.pallas_kernels as P

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    bad = []
    for name, N, C, Pn in (("warp_item", 3706, 11, 49152),
                           ("warp_user", 6040, 10, 8192),
                           ("imf_user", 6040, 11, 49152)):
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


def phase_kernel_csr_rows(torch, results):
    """csr_rows at a serve_batch request (1,024 users, L = 1,268) and a
    serve_online one (32 users, L = 316) from a CSR of ML-20M's shape with
    rows drawn like its cells' (20 + a geometric tail of mean 125, capped
    at 1,268): bit for bit its plain version on the card and the host's
    rows_from_csr, repeated uids included; span, device time, the plain
    version's, and the host rows and their two copies it replaced."""
    import numpy as np

    import cdae_tpu_torch.ops.pallas_kernels as P
    from cdae_tpu_torch.data.dataset import Interactions, rows_from_csr

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    U, I = 138_493, 26_744
    lengths = np.minimum(20 + rng.geometric(1 / 125, U), 1268)
    lengths[U // 2], lengths[U // 3] = 1268, 316
    items = rng.integers(0, I, int(lengths.sum()), dtype=np.int32)
    data = Interactions.from_arrays(np.repeat(np.arange(U), lengths), items,
                                    num_users=U, num_items=I)
    csr = data.csr()
    indptr, indices = data.csr_on(dev, lambda a: torch.as_tensor(a,
                                                                 device=dev))
    row_len = np.diff(csr.indptr)
    bad = []
    for case, B, longest, top in (("serve_batch", 1024, U // 2, 1268),
                                  ("serve_online", 32, U // 3, 316)):
        short = np.flatnonzero(row_len <= top)
        uids = rng.choice(short, B).astype(np.int32)
        uids[B // 3] = longest
        uids[-1] = uids[0]
        L = int(row_len[uids].max())
        want_items, _, want_mask, _ = rows_from_csr(csr, uids, I)
        d_uids = torch.as_tensor(uids.astype(np.int64), device=dev)
        got_items, got_mask = P.csr_rows(indptr, indices, d_uids, L, I)
        plain_items, plain_mask = P.csr_rows_plain(indptr, indices, d_uids,
                                                   L, I)
        torch.cuda.synchronize()
        exact_plain = bool(torch.equal(got_items, plain_items)
                           and torch.equal(got_mask, plain_mask))
        exact_host = bool(np.array_equal(got_items.cpu().numpy(), want_items)
                          and np.array_equal(got_mask.cpu().numpy(),
                                             want_mask))

        def host_rows():
            a, _, m, _ = rows_from_csr(csr, uids, I)
            torch.as_tensor(a, device=dev)
            torch.as_tensor(m, device=dev)

        host = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host_rows()
            torch.cuda.synchronize()
            host.append(time.perf_counter() - t0)
        row = dict(phase="kernel_csr_rows", kernel="csr_rows", case=case,
                   shape=[B, L], exact_plain=exact_plain,
                   exact_host=exact_host,
                   ms=median_ms(lambda: P.csr_rows(indptr, indices, d_uids,
                                                   L, I)),
                   device_ms=device_ms(lambda: P.csr_rows(
                       indptr, indices, d_uids, L, I)),
                   plain_ms=median_ms(lambda: P.csr_rows_plain(
                       indptr, indices, d_uids, L, I)),
                   host_rows_ms=1e3 * statistics.median(host),
                   # the items and mask written (5 B a slot), the rows'
                   # CSR entries read once, each uid and its two indptr
                   # entries read once
                   **bound(5.0 * B * L + 4.0 * int(row_len[uids].sum())
                           + 24.0 * B, 0.0))
        emit(row)
        record(results, "csr_rows", row)
        if L != top or not (exact_plain and exact_host):
            bad.append(f"csr_rows {case} (L {L})")
    if bad:
        raise AssertionError(f"csr_rows is not exact: {bad}")


def phase_serve_recommend_1m(torch):
    """recommend(k=10) for 1,024 users over 1,000,000 items at D=50, the
    request of the cdae_1m.serve_batch cell (20,000 users, rows 1 + a
    geometric draw of mean 50, at most 587; weights U(-s, s) as the
    benchmark's), on both routes: the fused decode + top-k (B6, which
    recommend takes above _TOPK_DEFER_CELLS) and the (B, I) slab (B3, then
    topk_unrated's sort; the threshold raised). Per route: the wall of a
    request with its ids read back, device ms (requests queued behind a
    busy-wait), the peak memory a request adds, B6 and B3 launches a
    request, and the widest gap of a served id's plain float32 score below
    the plain top-10's at its rank (the cell's topk_gap, limit 1e-6)."""
    import math

    import numpy as np

    import cdae_tpu_torch.models.cdae as C
    import cdae_tpu_torch.ops.pallas_kernels as P
    from cdae_tpu_torch.data.dataset import Interactions

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    U, I, D, B, k = 20_000, 1_000_000, 50, 1024, 10
    lengths = np.minimum(1 + rng.geometric(1 / 50, U), 587)
    items = rng.integers(0, I, int(lengths.sum()), dtype=np.int32)
    data = Interactions.from_arrays(np.repeat(np.arange(U), lengths), items,
                                    num_users=U, num_items=I)
    model = C.CDAE(C.CDAEConfig(num_dim=D, dense_mode=False), device=dev)
    state = model.reset(data, seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s = 4.0 * math.sqrt(6.0 / (I + D))
    with torch.no_grad():
        for name in ("W", "Wu"):
            t = state.params[name]
            t.copy_(torch.rand(t.shape, generator=gen, device=dev)
                    .mul_(2 * s).sub_(s))
    uids = rng.permutation(U)[:B].astype(np.int32)

    def request():
        return model.recommend(state, uids, data, k=k)

    # the plain float32 reference: the same encode, the decode as one
    # matmul with TF32 off, rated items at -inf
    plain = C.CDAE(C.CDAEConfig(num_dim=D, dense_mode=False,
                                use_pallas=False), device=dev)
    pb_items, pb_mask = (torch.as_tensor(a, device=dev) for a in
                         plain._user_rows(state, uids))
    ref = plain.batch_scores(state, uids, pb_items, pb_mask)
    ref = torch.cat([ref, ref.new_zeros((B, 1))], dim=1)
    ref = ref.scatter_(1, pb_items.long(), float("-inf"))[:, :I]
    best = torch.topk(ref, k, dim=1).values
    rows = {}
    saved = C._TOPK_DEFER_CELLS
    try:
        for route, cells in (("fused", saved), ("slab", 10 ** 18)):
            C._TOPK_DEFER_CELLS = cells
            ids = request()  # warm
            torch.cuda.synchronize()
            walls = []
            for _ in range(10):
                t0 = time.perf_counter()
                request().cpu()
                walls.append(1e3 * (time.perf_counter() - t0))
            b6, b3 = (P.fused_topk_scores_csr.launches,
                      P.decode_scores.launches)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ids = request()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            b6, b3 = (P.fused_topk_scores_csr.launches - b6,
                      P.decode_scores.launches - b3)
            got = torch.gather(ref, 1, ids.long().clamp(0, I - 1))
            got = torch.where(ids < I, got, float("-inf"))
            rows[route] = dict(
                ids=ids,
                wall_ms=statistics.median(walls),
                device_ms=device_ms(request, reps=10),
                peak_bytes=int(peak), b6_launches=b6, b3_launches=b3,
                topk_gap=float((best - got).clamp(min=0.0).max()))
    finally:
        C._TOPK_DEFER_CELLS = saved
    fused, slab = rows["fused"], rows["slab"]
    same = int((fused.pop("ids") == slab.pop("ids")).all(dim=1).sum())
    ok = (fused["b6_launches"] == 1 and fused["b3_launches"] == 0
          and slab["b6_launches"] == 0 and slab["b3_launches"] == 1
          and max(fused["topk_gap"], slab["topk_gap"]) < 1e-6)
    return dict(phase="serve_recommend_1m", users=B, items=I, dim=D, k=k,
                fused=fused, slab=slab, rows_same_ids=same,
                speedup=slab["device_ms"] / fused["device_ms"], ok=ok)


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
    (device kernels a step), counting B8's plans and reduces a step and
    B2's launches, which must be one a step."""
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
        b8 = (P.scatter_plan.launches, P.scatter_matmul.launches,
              P.adagrad_update.launches)
        prof = _profile(torch, lambda: model.train_one_iteration(state, SEED))
        prof["launches_per_step"] = prof.pop("device_kernels") / steps
        prof["b8_plans_per_step"] = (P.scatter_plan.launches - b8[0]) / steps
        prof["b8_reduces_per_step"] = (P.scatter_matmul.launches
                                       - b8[1]) / steps
        # bu, Q, bi and P in one launch
        prof["b2_launches_per_step"] = (P.adagrad_update.launches
                                        - b8[2]) / steps
        finite = _params_finite(state.params)
        out[route] = dict(seconds_2_epochs=wall, users_per_s=U * 2 / wall,
                          steps_per_epoch=steps,
                          ms_per_step=wall * 1e3 / (2 * steps),
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                          params_finite=finite, profiled_epoch=prof)
        ok = ok and finite and prof["b2_launches_per_step"] == 1.0
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


# ---------------------------------------------- the rest of the MF family ----

MF_TRAIN = ["--task", "train", "--num_dim", "10", "--num_neg", "5",
            "--learn_rate", "0.1", "--batch_size", "8192", "--max_iters",
            "10", "--eval_iters", "5", "--skip_popularity", "--seed",
            str(SEED), "--test_ratio", "0.2"]
# the kernels of the new MF paths, as torch.profiler names them
B8_KERNELS = ("radix_hist_kernel", "radix_pass_kernel",
              "segment_offsets_kernel", "scatter_reduce_kernel")
MF_GROUPS = {"b8": B8_KERNELS, "b1": ("hw_uniform_kernel",),
             "b2": ("adagrad_tables_kernel",)}


def _mf_cli(torch, tmp, data, name, argv):
    """cli.train of MF_TRAIN + ``argv`` on ``data`` (cached once as
    ``name``); returns the Solver and the task's seconds."""
    from cdae_tpu_torch import cli
    from cdae_tpu_torch.data import io as data_io

    cache = os.path.join(tmp, name + ".bin")
    if not os.path.exists(cache):
        data_io.save_interactions(data, cache)
    t0 = time.perf_counter()
    solver = cli.train(cli.build_arg_parser().parse_args(
        MF_TRAIN + ["--cache_file", cache] + argv))
    torch.cuda.synchronize()
    return solver, time.perf_counter() - t0


def _mf_row(torch, phase, solver, seconds, col="R@10"):
    """A training phase's row: the route, the metric at each eval, and
    whether it rose (fell, for RMSE) and the params stayed finite."""
    from cdae_tpu_torch.solver.solver import _params_finite

    hist = solver.history
    finite = _params_finite(solver.state.params)
    first, last = hist[0][col], hist[-1][col]
    moved = last < first if col == "RMSE" else last > first
    cfg = solver.model.cfg
    return dict(phase=phase, method=solver.model.name,
                route="slab" if "dense_R" in solver.state.aux else "sparse",
                batch=cfg.batch_size, fast_rng=cfg.fast_rng,
                learn_rate=cfg.learn_rate, loss=cfg.loss, cli_seconds=seconds,
                metric=col,
                by_epoch={int(r["iter"]): r[col] for r in hist},
                params_finite=finite, ok=finite and moved)


def phase_train_imf(torch, tmp, held):
    """CLI --method MF (IMF) --fast_rng on the ML-1M-scale low-rank data,
    D=10, batch 8192, 10 epochs: the user slab by the auto rule (B1's
    uniforms for the Bernoulli negatives, one B2 launch for iv and ib, B8
    in the user rows' delta AdaGrad). R@10 rises."""
    solver, s = _mf_cli(torch, tmp, held["ml1m_data"], "ml1m_lowrank",
                        ["--method", "MF", "--fast_rng", "true"])
    held["imf"] = solver
    row = _mf_row(torch, "train_imf", solver, s)
    row["ok"] = row["ok"] and row["route"] == "slab"
    return row


def phase_train_imf_sparse(torch, tmp, held):
    """The same with --dense_mode false: the sparse step (sample_unrated
    over B1's draws, the [uv | ub] and [iv | ib] sums in B8, one B2 launch
    a step). R@10 rises; its distance to train_imf's is printed."""
    solver, s = _mf_cli(torch, tmp, held["ml1m_data"], "ml1m_lowrank",
                        ["--method", "MF", "--fast_rng", "true",
                         "--dense_mode", "false"])
    held["imf_sparse"] = solver
    row = _mf_row(torch, "train_imf_sparse", solver, s)
    if "imf" in held:
        row["distance_to_slab"] = (solver.history[-1]["R@10"]
                                   - held["imf"].history[-1]["R@10"])
    row["ok"] = row["ok"] and row["route"] == "sparse"
    return row


def phase_train_pmf(torch, tmp, held):
    """--method PMF --eval RMSE,MAE on lowrank_rated data of the same
    dimensions (1-5 ratings), the slab (auto) and --dense_mode false, 10
    epochs each: RMSE falls from epoch 0 to epoch 10 on both."""
    from cdae_tpu_torch.data.synthetic import lowrank_rated

    t0 = time.perf_counter()
    data = lowrank_rated(6040, 3706, 160, seed=SEED)
    data_s = time.perf_counter() - t0
    held["pmf_data"] = data.split_by_user(0.2, seed=SEED)
    held["rated_data"] = data
    out = dict(phase="train_pmf", users=6040, items=3706, D=10,
               ratings=len(data), data_s=data_s)
    ok = True
    for route, extra in (("slab", []), ("sparse", ["--dense_mode", "false"])):
        solver, s = _mf_cli(torch, tmp, data, "ml1m_rated",
                            ["--method", "PMF", "--eval", "RMSE,MAE"] + extra)
        row = _mf_row(torch, "train_pmf", solver, s, col="RMSE")
        row["mae_by_epoch"] = {int(r["iter"]): r["MAE"]
                               for r in solver.history}
        held["pmf_" + route] = solver
        out[route] = row
        ok = ok and row["ok"] and row["route"] == route
    out["ok"] = ok
    return out


def phase_train_bpr(torch, tmp, held):
    """--method BPR --loss_type LOG, the sparse step (the default), then
    --dense_mode true at 2x lr (the slab's equal-epoch protocol,
    scripts/parity_zoo.py): R@10 rises on both."""
    out = dict(phase="train_bpr", users=6040, items=3706, D=10)
    ok = True
    for route, extra in (("sparse", []),
                         ("slab", ["--dense_mode", "true", "--learn_rate",
                                   "0.2"])):
        solver, s = _mf_cli(torch, tmp, held["ml1m_data"], "ml1m_lowrank",
                            ["--method", "BPR", "--loss_type", "LOG"]
                            + extra)
        row = _mf_row(torch, "train_bpr", solver, s)
        held["bpr_" + route] = solver
        out[route] = row
        ok = ok and row["ok"] and row["route"] == route
    out["ok"] = ok
    return out


def _warp_cfg(**kw):
    """train_warp's configuration (WARP_TRAIN) as an MFConfig."""
    from cdae_tpu_torch.models.mf import MFConfig

    return MFConfig(**{**dict(num_dim=10, num_neg=5, loss="HINGE", beta=0.0,
                              lambda_=0.1, learn_rate=0.1, batch_size=8192),
                       **kw})


# the slab's batch counts users: 64 of them (scripts/parity_zoo.py's
# WARP_DENSE; 95 slabs an epoch), some 8,192 instances' worth as in
# train_warp. From the 0.01-scale init the slab's first AdaGrad steps (beta
# 0) move every coordinate by about lr, and R@10 dips before it rises,
# cdae_tpu's slab and the port's alike (at 1,200 x 600, 64- and 256-user
# slabs dip in epoch 1 and pass 0.15 in epoch 2); with 1,024 users a slab
# ML-1M's R@10 was still below its start after 2 epochs
WARP_ROUTES = (("slab", dict(dense_mode=True, warp_pool=1024,
                             learn_rate=0.3, batch_size=64)),
               ("pool_mask", dict(warp_pool=1024)),
               ("pool_csr", dict(warp_pool=1024, dense_mode=False)),
               ("scan", dict(dense_mode=False)))


def phase_train_warp_routes(torch, held):
    """2 epochs of train_warp's configuration on each of WARP's other
    routes through Solver.train (TOPN at 0 and 2): the slab (pool 1024 at
    3x lr and 64 users a slab, scripts/parity_zoo.py's WARP_DENSE), the
    pool path with the
    rated mask and with the CSR rows, and the scan path. R@10 rises on
    each; the pool path gives the same bits with the mask as with the CSR
    rows (the same draws and truth table); peak memory per route."""
    from cdae_tpu_torch.models.mf import WARP
    from cdae_tpu_torch.solver.solver import Solver, _params_finite

    train, test = held["ml1m"][1]
    out = dict(phase="train_warp_routes", epochs=2, batch=8192)
    ok = True
    params = {}
    for route, kw in WARP_ROUTES:
        model = WARP(_warp_cfg(**kw), device="cuda")
        solver = Solver(model, max_iteration=2, eval_iterations=2, seed=SEED,
                        verbose=False)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        solver.train(train, test, ["TOPN"])
        torch.cuda.synchronize()
        hist = solver.history
        finite = _params_finite(solver.state.params)
        extras = model._epoch_extras(solver.state)
        out[route] = dict(
            seconds=time.perf_counter() - t0,
            slab="dense_R" in solver.state.aux, rated_mask=bool(extras),
            recall_at_10={int(r["iter"]): r["R@10"] for r in hist},
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            params_finite=finite)
        ok = ok and finite and hist[-1]["R@10"] > hist[0]["R@10"]
        params[route] = solver.state.params
        held["warp_" + route] = solver
    mask, csr = params["pool_mask"], params["pool_csr"]
    out["pool_mask_csr_bit_equal"] = all(torch.equal(mask[k], csr[k])
                                         for k in mask)
    out["ok"] = ok and out["pool_mask_csr_bit_equal"]
    return out


def phase_train_imf_mxu(torch, held):
    """One epoch of train_imf_sparse's configuration with gather_mode="mxu"
    (B9 gathers [uv | ub] and [iv | ib] rows) against the native gather
    from the same reset and seed: the same bits (B9 copies rows)."""
    import dataclasses

    import cdae_tpu_torch.ops.pallas_kernels as P
    from cdae_tpu_torch.models.mf import IMF

    cfg = held["imf_sparse"].model.cfg
    train = held["ml1m"][1][0]
    params = {}
    b9 = 0
    for mode in ("mxu", "native"):
        model = IMF(dataclasses.replace(cfg, gather_mode=mode),
                    device="cuda")
        state = model.reset(train, seed=SEED)
        before = P.gather_rows_mxu.launches
        model.train_one_iteration(state, SEED)
        torch.cuda.synchronize()
        if mode == "mxu":
            b9 = P.gather_rows_mxu.launches - before
        params[mode] = state.params
    equal = all(torch.equal(params["mxu"][k], params["native"][k])
                for k in params["mxu"])
    steps = -(-len(train) // cfg.batch_size)
    return dict(phase="train_imf_mxu", epochs=1, steps=steps,
                b9_launches=b9, bit_equal_native=equal,
                ok=equal and b9 == 2 * steps)


MF_CHECKS = ("imf_sparse", "bpr_sparse", "pmf_slab", "warp_slab")


def _mf_epochs(torch, held, key, epochs, **kw):
    """``epochs`` epochs of the configuration of ``held[key]`` (with
    ``kw``) from a reset with the run's seed, on its training split."""
    import dataclasses

    solver = held[key]
    model = type(solver.model)(dataclasses.replace(solver.model.cfg, **kw),
                               device="cuda")
    data = (held["pmf_data"] if key.startswith("pmf")
            else held["ml1m"][1])[0]
    state = model.reset(data, seed=SEED)
    for _ in range(epochs):
        model.train_one_iteration(state, SEED)
    torch.cuda.synchronize()
    return model, state


def phase_mf_checks(torch, held):
    """IMF sparse, BPR sparse, PMF slab and the WARP slab: one epoch with
    the kernels (B1, B2, B8: use_pallas on, scatter_mode auto) against one
    with their plain versions (use_pallas off, scatter_mode "scatter":
    the plain hash, the plain AdaGrad, index_add_) from the same reset and
    seed, every table within 1e-4 relative; and two 2-epoch runs of each
    default route, the same bits."""
    out = dict(phase="mf_checks", tol=ROUTE_REL_TOL)
    ok = True
    for key in MF_CHECKS:
        _, kern = _mf_epochs(torch, held, key, 1)
        _, plain = _mf_epochs(torch, held, key, 1, use_pallas=False,
                              scatter_mode="scatter")
        rel = _rel_diff(torch, kern.params, plain.params)
        _, a = _mf_epochs(torch, held, key, 2)
        _, b = _mf_epochs(torch, held, key, 2)
        equal = all(torch.equal(a.params[k], b.params[k]) for k in a.params)
        out[key] = dict(rel_diff_vs_plain=rel, runs_bit_equal=equal)
        ok = ok and rel <= ROUTE_REL_TOL and equal
    out["ok"] = ok
    return out


SPEED_MF = (("imf_slab", "imf"), ("imf_sparse", "imf_sparse"),
            ("pmf_sparse", "pmf_sparse"), ("bpr_sparse", "bpr_sparse"),
            ("bpr_slab", "bpr_slab"), ("warp_slab", "warp_slab"))


def phase_train_speed_mf(torch, held):
    """Warm training throughput of the new MF paths (the train_speed_fism
    protocol): one warm-up epoch, 2 timed epochs (host clock between
    synchronizes), users/s = users * epochs / wall; then whole epochs of
    at least 16 steps under torch.profiler: launches a step, device ms,
    idle share, and the device ms of B8 (plans and reduces), B1 and B2 (all
    over ``epochs`` epochs); B1/B2/B8 wrapper launches a step; peak memory.
    B2 launches once a step."""
    import cdae_tpu_torch.ops.pallas_kernels as P
    from cdae_tpu_torch.solver.solver import _params_finite

    out = dict(phase="train_speed_mf")
    ok = True
    for route, key in SPEED_MF:
        model, state = _mf_epochs(torch, held, key, 1)  # warm-up
        data = (held["pmf_data"] if key.startswith("pmf")
                else held["ml1m"][1])[0]
        steps = (state.aux["dense_batches"][0].shape[0]
                 if "dense_R" in state.aux
                 else -(-len(data) // model.cfg.batch_size))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(2):
            model.train_one_iteration(state, SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (P.hw_uniform.launches, P.adagrad_update.launches,
                  P.scatter_plan.launches, P.scatter_matmul.launches)
        # at least 16 steps under the profiler (a slab epoch is one step)
        reps = -(-16 // steps)

        def epochs():
            for _ in range(reps):
                model.train_one_iteration(state, SEED)

        prof = _profile(torch, epochs, groups=MF_GROUPS)
        now = (P.hw_uniform.launches, P.adagrad_update.launches,
               P.scatter_plan.launches, P.scatter_matmul.launches)
        per = [(b - a) / (steps * reps) for a, b in zip(counts, now)]
        prof["epochs"] = reps
        prof["launches_per_step"] = prof.pop("device_kernels") / (steps
                                                                  * reps)
        finite = _params_finite(state.params)
        out[route] = dict(
            users=data.num_users, instances=len(data),
            batch=model.cfg.batch_size, steps_per_epoch=steps,
            seconds_2_epochs=wall, users_per_s=data.num_users * 2 / wall,
            ms_per_step=wall * 1e3 / (2 * steps),
            b1_launches_per_step=per[0], b2_launches_per_step=per[1],
            b8_plans_per_step=per[2], b8_reduces_per_step=per[3],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            params_finite=finite, profiled_epoch=prof)
        if route == "bpr_slab":
            # the rescue draw BPR's slab computes every step (no host sync
            # to test whether a row needs it), at the slab's shapes
            from cdae_tpu_torch.models.mf import _rescue_draw

            uids = state.aux["dense_batches"][0][0]
            rows01 = state.aux["dense_R"][uids].to(torch.float32)
            out[route]["rescue_device_ms"] = device_ms(
                lambda: _rescue_draw(rows01, SEED, model.cfg))
        ok = ok and finite and per[1] == 1.0
        del state
    out["ok"] = ok
    return out


# ------------------------------------------------- CDAE's sparse step ----

SPARSE_R10_FLOOR = 0.10  # train_sparse_ml1m's R@10 after 10 epochs
DENSE_R10 = 0.2248  # train_ml1m's R@10 at epoch 10 (PERF.md section 5)
SPARSE_SLOTS = 262_144  # the token budget of the stratified protocol
SPARSE_TIMED = 30  # length-stratified batches timed a cell


def phase_train_sparse_ml1m(torch, tmp, held):
    """CLI --task train on the ML-1M-scale low-rank data with --dense_mode
    false: Popularity first, then CDAE D=50 through the sparse step (B1's
    keep masks and negative draws, B8's sums, one B2 launch a step), 10
    epochs, TOPN at 0, 5 and 10. R@10 must rise and end above
    SPARSE_R10_FLOOR; its distance to the dense run's is printed."""
    from cdae_tpu_torch import cli
    from cdae_tpu_torch.data import io as data_io
    from cdae_tpu_torch.solver.solver import _params_finite

    cache = os.path.join(tmp, "ml1m_lowrank.bin")
    data_io.save_interactions(held["ml1m_data"], cache)
    argv = [a for a in ML1M_TRAIN if a != "--skip_popularity"]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    solver = cli.train(cli.build_arg_parser().parse_args(
        argv + ["--cache_file", cache, "--dense_mode", "false"]))
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    hist = solver.history
    finite = _params_finite(solver.state.params)
    sparse = "dense_R" not in solver.state.aux
    held["sparse_ml1m"] = solver
    dense_r10 = (held["ml1m"][0].history[-1]["R@10"] if "ml1m" in held
                 else DENSE_R10)
    r10 = hist[-1]["R@10"]
    return dict(phase="train_sparse_ml1m", users=6040, items=3706, D=50,
                epochs=10, cli_seconds=cli_s, sparse_step=sparse,
                steps_per_epoch=len(solver.state.aux["device_batches"]),
                recall_at_10={int(r["iter"]): r["R@10"] for r in hist},
                map_at_10={int(r["iter"]): r["MAP@10"] for r in hist},
                recall_at_10_dense=dense_r10,
                distance_to_dense=r10 - dense_r10,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                params_finite=finite, floor=SPARSE_R10_FLOOR,
                ok=finite and sparse and r10 > hist[0]["R@10"]
                and r10 > SPARSE_R10_FLOOR)


def _stratified_batches(torch, csr, num_items, batch_size):
    """scripts/scale_smoke.py's protocol: SPARSE_TIMED batches spread
    evenly over the length-sorted, token-budget epoch (so the long tail
    is in the mix), moved to the card; and the epoch's batch count."""
    import numpy as np

    from cdae_tpu_torch.models.base import (count_user_batches_csr,
                                            iter_user_batches_csr)

    total = count_user_batches_csr(csr, batch_size,
                                   slots_per_batch=SPARSE_SLOTS)
    n = min(SPARSE_TIMED, total)
    keep = set(np.linspace(0, total - 1, n).round().astype(int).tolist())
    dev = torch.device("cuda")
    out = []
    for i, b in enumerate(iter_user_batches_csr(
            csr, num_items, batch_size, slots_per_batch=SPARSE_SLOTS)):
        if i in keep:
            out.append(tuple(torch.as_tensor(x, device=dev) for x in (
                b.uids.astype(np.int64), b.items.astype(np.int64), b.mask,
                b.lengths.astype(np.int64), b.weight)))
    return out, total


def _sparse_cell(torch, model, state, batches):
    """A warm pass over ``batches`` (sparse steps), a timed pass (host
    clock between synchronizes), then a profiled pass: users/s, ms a step,
    launches a step (device kernels under torch.profiler, and B1, B2, B8's
    plans and reduces by their counts), idle share, peak memory."""
    import cdae_tpu_torch.ops.pallas_kernels as P
    from cdae_tpu_torch.models.cdae import _train_step
    from cdae_tpu_torch.solver.solver import _params_finite

    def run_pass(offset):
        for j, batch in enumerate(batches):
            _train_step(state.params, *batch, SEED + offset + j,
                        cfg=model.cfg, loss=model.loss,
                        coll=state.aux["coll"])

    run_pass(0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    users = float(sum(b[4].sum().item() for b in batches))
    t0 = time.perf_counter()
    run_pass(1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    wrappers = (P.hw_uniform, P.adagrad_update, P.scatter_plan,
                P.scatter_matmul)
    before = [w.launches for w in wrappers]
    prof = _profile(torch, lambda: run_pass(2000))
    n = len(batches)
    per = [(w.launches - b) / n for w, b in zip(wrappers, before)]
    prof["launches_per_step"] = prof.pop("device_kernels") / n
    for key, v in zip(("b1", "b2", "b8_plans", "b8_reduces"), per):
        prof[f"{key}_per_step"] = v
    finite = _params_finite(state.params)
    return dict(steps=n, timed_users=users, seconds=wall,
                users_per_s=users / wall,
                ms_per_step=wall * 1e3 / n, peak_mem_gb=peak,
                shapes=sorted({tuple(b[1].shape) for b in batches}),
                params_finite=finite, profiled_pass=prof,
                ok=finite and per[1] == 1.0 and per[2] > 0 and per[3] > 0)


def phase_train_sparse_ml20m(torch, held):
    """config 3's shape: ML-20M's dimensions (138,493 users x 26,744 items,
    mean degree 144; synthetic, ML-20M is not in the repo), D=200, exact
    negatives (num_neg 5), batch 1024 with the 262,144-slot budget. The
    auto rule must pick the sparse step. Then TOPN on 2,048 held-out
    users (the (B, I) decode, B3)."""
    import numpy as np

    from cdae_tpu_torch.data.dataset import Interactions
    from cdae_tpu_torch.data.synthetic import synthetic_interactions
    from cdae_tpu_torch.evaluation import RecListEvaluation
    from cdae_tpu_torch.models.cdae import CDAE, CDAEConfig
    from cdae_tpu_torch.ops import metrics

    t0 = time.perf_counter()
    setup = {}

    def lap(name):
        setup[name] = time.perf_counter() - t0 - sum(setup.values())

    data = synthetic_interactions(138_493, 26_744, 144, seed=SEED)
    lap("data")
    train, test = data.split_by_user(0.2, seed=SEED)
    lap("split")
    # stream_batches: the step's batches come from the CSR, so the reset
    # builds no (U, max_len) padded matrix (the protocol never reads it)
    model = CDAE(CDAEConfig(num_dim=200, corruption_ratio=0.5, scaled=True,
                            num_neg=5, loss="SQUARE", batch_size=1024,
                            beta=1.0, stream_batches=True), device="cuda")
    state = model.reset(train, seed=SEED)
    torch.cuda.synchronize()
    lap("reset")
    batches, total = _stratified_batches(torch, state.aux["csr"],
                                         train.num_items, 1024)
    torch.cuda.synchronize()
    lap("batches")
    out = dict(phase="train_sparse_ml20m", users=train.num_users,
               items=train.num_items, interactions=len(train), D=200,
               num_neg=5, batch=1024, slots=SPARSE_SLOTS,
               epoch_batches=total, setup_s=setup,
               sparse_step="dense_R" not in state.aux)
    cell = _sparse_cell(torch, model, state, batches)
    del batches
    keep = test.users < np.sort(np.unique(test.users))[2047] + 1
    held_out = Interactions.from_arrays(
        test.users[keep], test.items[keep], test.ratings[keep],
        num_users=test.num_users, num_items=test.num_items)
    ev = RecListEvaluation("TOPN", batch_size=1024)
    ev.evaluate(model, state, held_out, train)  # builds the eval batches
    res = ev.evaluate(model, state, held_out, train)
    cols = [res[c] for c in metrics.TOPN_COLUMNS]
    out.update(cell, val_users=ev._cache[0], test_time_s=res["TestTime"],
               topn=dict(zip(metrics.TOPN_COLUMNS, cols)),
               seconds=time.perf_counter() - t0)
    out["ok"] = (cell["ok"] and out["sparse_step"] and ev._cache[0] == 2048
                 and all(map(_finite, cols)))
    return out


def phase_train_sparse_1m(torch):
    """config 5's catalog: 1,000,000 items, D=50 (200,000 users of mean
    degree 50; config 5's 10M users cut to what the smoke's time allows),
    the stratified protocol with pooled negatives (neg_pool 8192), then
    with exact ones."""
    from cdae_tpu_torch.data.synthetic import synthetic_interactions
    from cdae_tpu_torch.models.cdae import CDAE, CDAEConfig

    t0 = time.perf_counter()
    data = synthetic_interactions(200_000, 1_000_000, 50, seed=SEED)
    out = dict(phase="train_sparse_1m", users=data.num_users,
               items=data.num_items, interactions=len(data), D=50,
               batch=1024, slots=SPARSE_SLOTS)
    batches, out["epoch_batches"] = _stratified_batches(
        torch, data.csr(), data.num_items, 1024)
    ok = True
    for name, pool in (("pool_8192", 8192), ("exact", None)):
        model = CDAE(CDAEConfig(num_dim=50, corruption_ratio=0.5,
                                scaled=True, num_neg=5, loss="SQUARE",
                                batch_size=1024, beta=1.0, neg_pool=pool,
                                stream_batches=True), device="cuda")
        state = model.reset(data, seed=SEED)
        cell = _sparse_cell(torch, model, state, batches)
        cell["sparse_step"] = "dense_R" not in state.aux
        ok = ok and cell["ok"] and cell["sparse_step"]
        out[name] = cell
        del state
    out["seconds"] = time.perf_counter() - t0
    out["ok"] = ok
    return out


def phase_sparse_ml1m_checks(torch, held):
    """From train_sparse_ml1m's configuration and one reset: two runs of 2
    epochs bit for bit (B8 sums in a fixed order); one epoch with the
    kernels against one with their plain versions (use_pallas off: the
    same hash draws, index_add_ sums, the plain AdaGrad), within
    ROUTE_REL_TOL per table; and, with corruption 0 and no negatives, one
    sparse step against one dense step on the same users: at cdae_tpu's
    identity test's batch of 16 users (tests/test_dense_mode.py) every
    entry within rtol 2e-5 / atol 1e-6, at the run's batch of 1024 users
    each table within ROUTE_REL_TOL (a gradient then sums ~10^3 terms that
    cancel, in another order than the dense step's GEMM)."""
    import dataclasses

    from cdae_tpu_torch.models.base import iter_user_batches
    from cdae_tpu_torch.models.cdae import (CDAE, _dense_train_step,
                                            _train_step)

    cfg = held["sparse_ml1m"].model.cfg
    train = held["ml1m"][1][0] if "ml1m" in held else \
        held["ml1m_data"].split_by_user(0.2, seed=SEED)[0]

    def epochs(n, **kw):
        model = CDAE(dataclasses.replace(cfg, **kw), device="cuda")
        state = model.reset(train, seed=SEED)
        model.train_epochs(state, n, SEED)
        torch.cuda.synchronize()
        return state.params

    a, b = epochs(2), epochs(2)
    bit_equal = all(torch.equal(a[k], b[k]) for k in a)
    rel = _rel_diff(torch, epochs(1), epochs(1, use_pallas=False))

    def one_step(batch_size):
        out = {}
        for dense in (False, True):
            model = CDAE(dataclasses.replace(
                cfg, dense_mode=dense, corruption_ratio=0.0, num_neg=0,
                bucket_by_length=False, batch_size=batch_size),
                device="cuda")
            state = model.reset(train, seed=SEED)
            mb = next(iter_user_batches(state.padded, batch_size))
            uids, items, mask, lengths, weight = (
                torch.as_tensor(x, device="cuda") for x in (
                    mb.uids, mb.items, mb.mask, mb.lengths, mb.weight))
            if dense:
                _dense_train_step(state.params, state.aux["dense_R"],
                                  uids.long(), weight, SEED, cfg=model.cfg,
                                  loss=model.loss, coll=state.aux["coll"])
            else:
                _train_step(state.params, uids.long(), items.long(), mask,
                            lengths.long(), weight, SEED, cfg=model.cfg,
                            loss=model.loss, coll=state.aux["coll"])
            out[dense] = state.params
        return out[False], out[True]

    sparse16, dense16 = one_step(16)
    excess = max(((sparse16[k] - dense16[k]).abs() - 1e-6
                  - 2e-5 * dense16[k].abs()).max().item() for k in dense16)
    rel1024 = _rel_diff(torch, *one_step(1024))
    return dict(phase="sparse_ml1m_checks", runs_bit_equal=bit_equal,
                rel_diff_vs_plain=rel, tol=ROUTE_REL_TOL,
                dense_identity_16_max_abs_diff=max(
                    (sparse16[k] - dense16[k]).abs().max().item()
                    for k in dense16),
                dense_identity_16_ok=excess <= 0.0,
                dense_identity_1024_rel_diff=rel1024,
                ok=bit_equal and rel <= ROUTE_REL_TOL and excess <= 0.0
                and rel1024 <= ROUTE_REL_TOL)


# ------------------------------------------ ALS/WRMF and ItemCF/UserCF ----

ZOO_TRAIN = ["--task", "train", "--num_dim", "10", "--lambda", "0.01",
             "--max_iters", "10", "--eval_iters", "5", "--seed", str(SEED),
             "--test_ratio", "0.2"]
CF_TRAIN = ["--task", "train", "--sim_type", "JACCARD", "--sim_topk", "50",
            "--max_iters", "1", "--skip_popularity", "--seed", str(SEED),
            "--test_ratio", "0.2"]
ALS_ITER_TOL = 1e-4  # a sweep on the card against the CPU's, per table
# the same on every row, thin ones too: a row with fewer than D observations
# has a singular Gram up to lambda, or WRMF's jitter, and f32 rounding sets
# its null-space part on either device (tests/test_torch_als.py's limit)
ALS_THIN_TOL = 2e-3
# an iteration from the trained factors: the card's distance from the same
# iteration in f64 (ALS), or from the CPU's (WRMF ridge, whose jitter scales
# with the dtype's eps, so f64 solves another system), at most this many
# times the CPU's own f32 distance from f64 (ALS) or the larger of the two
# devices' one-ulp spreads (WRMF)
ALS_ROUNDING_MULT = 2.0
CF_R10_TOL = 1e-6  # a CF model's R@10 on the card against the CPU build's


def _zoo_cli(torch, tmp, held, argv):
    """cli.train of ``argv`` + the cached ML-1M-scale low-rank data;
    returns the Solver and the task's seconds."""
    from cdae_tpu_torch import cli
    from cdae_tpu_torch.data import io as data_io

    cache = os.path.join(tmp, "ml1m_lowrank.bin")
    if not os.path.exists(cache):
        data_io.save_interactions(held["ml1m_data"], cache)
    t0 = time.perf_counter()
    solver = cli.train(cli.build_arg_parser().parse_args(
        argv + ["--cache_file", cache]))
    torch.cuda.synchronize()
    return solver, time.perf_counter() - t0


def _popularity_r10(torch, held) -> float:
    """Popularity's R@10 on the ML-1M-scale split (the CF gates' floor)."""
    if "pop_r10" not in held:
        from cdae_tpu_torch.evaluation import Evaluation
        from cdae_tpu_torch.models import Popularity

        train, test = held["ml1m"][1]
        model = Popularity(device="cuda")
        held["pop_r10"] = Evaluation.create("TOPN").evaluate(
            model, model.reset(train), test, train)["R@10"]
    return held["pop_r10"]


def _zoo_row(phase, solver, seconds, **extra):
    """A training phase's row: R@10 at each eval; ok when it rose from
    iteration 0 and the factors stayed finite."""
    from cdae_tpu_torch.solver.solver import _params_finite

    hist = solver.history
    finite = _params_finite(solver.state.params)
    return dict(phase=phase, method=solver.model.name,
                cfg={k: getattr(solver.model.cfg, k) for k in
                     ("num_dim", "lambda_", "scalar", "w_solver",
                      "solve_batch")},
                cli_seconds=seconds,
                recall_at_10={int(r["iter"]): r["R@10"] for r in hist},
                params_finite=finite,
                ok=finite and hist[-1]["R@10"] > hist[0]["R@10"], **extra)


def phase_train_als(torch, tmp, held):
    """CLI --task train --method ALS on the ML-1M-scale low-rank data, D=10,
    lambda 0.01, 10 iterations, Popularity first: R@10 rises from
    iteration 0."""
    solver, s = _zoo_cli(torch, tmp, held, ZOO_TRAIN + ["--method", "ALS"])
    held["als"] = solver
    return _zoo_row("train_als", solver, s)


def phase_train_wrmf(torch, tmp, held):
    """CLI --method WRMF --scalar 40 (the ridge solve), then the eigh solve
    through the library (--w_solver is no cdae_tpu flag) under Solver.train
    with the same flags: R@10 rises in both."""
    import dataclasses

    from cdae_tpu_torch.models import WRMF
    from cdae_tpu_torch.solver.solver import Solver

    solver, s = _zoo_cli(torch, tmp, held,
                         ZOO_TRAIN + ["--method", "WRMF", "--scalar", "40",
                                      "--skip_popularity"])
    held["wrmf"] = solver
    row = _zoo_row("train_wrmf", solver, s)
    train, test = held["ml1m"][1]
    eigh = Solver(WRMF(dataclasses.replace(solver.model.cfg,
                                           w_solver="eigh"), device="cuda"),
                  max_iteration=10, eval_iterations=5, seed=SEED,
                  verbose=False)
    t0 = time.perf_counter()
    eigh.train(train, test, ["TOPN"])
    torch.cuda.synchronize()
    held["wrmf_eigh"] = eigh
    erow = _zoo_row("train_wrmf", eigh, time.perf_counter() - t0)
    row["eigh"] = {k: erow[k] for k in ("cli_seconds", "recall_at_10",
                                        "params_finite", "ok")}
    row["ok"] = row["ok"] and erow["ok"]
    return row


def _serve_cf(torch, tmp, held, method):
    """CLI --method ITEMCF / USERCF (Jaccard, top-50; the neighbour build
    at reset, TOPN at iterations 0 and 1), then a warm neighbour build and
    a warm TOPN pass timed: the warm pass repeats the CLI's R@10, and
    UserCF's R@10 is above Popularity's on the same split. ItemCF's is
    printed beside Popularity's and not gated on it: on this low-rank,
    popularity-skewed data Jaccard ItemCF ranks below Popularity in the
    reference semantics too (the CPU build, whose lists equal cdae_tpu's
    bit for bit, gives the same R@10; cf_checks holds the card to it)."""
    import numpy as np

    from cdae_tpu_torch.evaluation import Evaluation

    solver, s = _zoo_cli(torch, tmp, held, CF_TRAIN + ["--method", method])
    held[method.lower()] = solver
    model, state = solver.model, solver.state
    train, test = held["ml1m"][1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.reset(train)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ev = Evaluation.create("TOPN")
    ev.evaluate(model, state, test, train)  # warm: batches staged
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ev.evaluate(model, state, test, train)
    wall = time.perf_counter() - t0
    n_val = int((np.diff(test.csr().indptr) > 0).sum())
    pop = _popularity_r10(torch, held)
    ids = state.params["nbr_ids"]
    above = res["R@10"] > pop
    return dict(phase=f"serve_{method.lower()}", method=model.name,
                sim_type=model.cfg.sim_type, topk=model.cfg.topk,
                neighbours=list(ids.shape), cli_seconds=s,
                build_seconds=build_s, recall_at_10=res["R@10"],
                map_at_10=res["MAP@10"], popularity_recall_at_10=pop,
                above_popularity=above, val_users=n_val, topn_seconds=wall,
                topn_users_per_s=n_val / wall,
                ok=(above or method == "ITEMCF")
                and res["R@10"] == solver.history[-1]["R@10"])


def phase_serve_itemcf(torch, tmp, held):
    return _serve_cf(torch, tmp, held, "ITEMCF")


def phase_serve_usercf(torch, tmp, held):
    return _serve_cf(torch, tmp, held, "USERCF")


def _cf_batch(torch, held):
    """The last (longest-row) TOPN batch of the ML-1M-scale split: uids
    and the rated rows on the card."""
    from cdae_tpu_torch.evaluation import Evaluation

    train, test = held["ml1m"][1]
    _, batches = Evaluation.create("TOPN")._batches(test, train,
                                                    torch.device("cuda"))
    uids, rated_items, rated_mask = batches[-1][:3]
    return uids, rated_items, rated_mask


def _cf_kernel_row(torch, held, results):
    """B8 at the ItemCF scoring shape (the last TOPN batch's terms, P =
    B * L * K, into B * I rows of one column): against its plain version,
    its span and device time beside index_add_'s, and the byte bound."""
    import cdae_tpu_torch.ops.pallas_kernels as P
    from cdae_tpu_torch.models.similarity import _itemcf_terms

    solver = held["itemcf"]
    state = solver.state
    uids, rated_items, rated_mask = _cf_batch(torch, held)
    keys, vals = _itemcf_terms(state.params["nbr_ids"],
                               state.params["nbr_sims"], rated_items,
                               rated_mask, state.num_items)
    B, I = rated_items.shape[0], state.num_items
    N, Pn = B * I, keys.shape[0]
    out = P.scatter_matmul(keys, vals, N)
    plain = P.scatter_matmul_plain(keys, vals, N)
    torch.cuda.synchronize()
    ok, err = _rows_ok(torch, out, plain)
    valid = keys < N
    lib_idx = torch.where(valid, keys, N)
    plan = P.scatter_plan(keys, N)
    row = dict(phase="kernel_cf", kernel="scatter_matmul",
               case="itemcf_scores", B=B, I=I, P=Pn, N=N, C=1,
               valid_terms=int(valid.sum()), rtol=ROWS_RTOL,
               atol_scale=ROWS_ATOL, max_abs_err=err, ok=ok,
               ms=median_ms(lambda: P.scatter_matmul(keys, vals, N)),
               plain_ms=median_ms(lambda: P.scatter_matmul_plain(keys, vals,
                                                                 N)),
               library="index_add_",
               library_ms=median_ms(lambda: torch.zeros(
                   N + 1, device=keys.device).index_add_(0, lib_idx, vals)),
               device_ms=dict(
                   span=device_ms(lambda: P.scatter_matmul(keys, vals, N)),
                   plan=device_ms(lambda: P.scatter_plan(keys, N)),
                   reduce=device_ms(lambda: P.scatter_matmul(
                       keys, vals, N, plan=plan)),
                   index_add=device_ms(lambda: torch.zeros(
                       N + 1, device=keys.device).index_add_(0, lib_idx,
                                                             vals))),
               # ids and values read once, the rows written once; one add
               # per valid term
               **bound(12.0 * Pn + 4.0 * N, float(valid.sum())))
    record(results, "scatter_matmul", row)
    return row


def _als_iteration_on(torch, cls, cfg, train, dev, params):
    """One iteration of ``cls(cfg)`` on ``dev`` from ``params`` (in
    ``cfg.dtype``); the result on the CPU."""
    model = cls(cfg, device=dev)
    state = model.reset(train, seed=SEED)
    state.params = {k: v.to(dev, cfg.dtype) for k, v in params.items()}
    model.train_one_iteration(state, SEED)
    return {k: v.cpu() for k, v in state.params.items()}


def _als_sweeps_vs_cpu(torch, cls, cfg, train):
    """The two sweeps of one iteration on the card and on the CPU, each
    from the same inputs: the user sweep from N(0, 0.3) factors, the item
    sweep from the CPU's new user factors. Gated (ALS_ITER_TOL, relative
    per table) on the rows with at least 2 * D observations, whose Grams
    have full rank, and (ALS_THIN_TOL) on every row."""
    import numpy as np

    from cdae_tpu_torch.models.als import _sweep

    rng = np.random.default_rng(SEED)
    D = cfg.num_dim
    p0 = torch.from_numpy((rng.standard_normal((train.num_users, D))
                           * 0.3).astype(np.float32))
    q0 = torch.from_numpy((rng.standard_normal((train.num_items, D))
                           * 0.3).astype(np.float32))
    sides = {dev: cls(cfg, device=dev).reset(train, seed=SEED).aux
             for dev in ("cuda", "cpu")}
    args = (cfg.lambda_, cfg.scalar, cls.weighted, cfg.w_solver)
    p = {dev: _sweep(p0.to(dev), q0.to(dev), sides[dev]["dev_user_side"],
                     *args).cpu() for dev in sides}
    q = {dev: _sweep(q0.to(dev), p["cpu"].to(dev),
                     sides[dev]["dev_item_side"], *args).cpu()
         for dev in sides}
    full_u = torch.from_numpy(np.bincount(train.users,
                                          minlength=train.num_users)
                              >= 2 * D)
    full_i = torch.from_numpy(np.bincount(train.items,
                                          minlength=train.num_items)
                              >= 2 * D)
    out = dict(full_rank_users=int(full_u.sum()),
               full_rank_items=int(full_i.sum()),
               user_sweep_rel_diff=_rel_diff(torch, {"p": p["cuda"][full_u]},
                                             {"p": p["cpu"][full_u]}),
               item_sweep_rel_diff=_rel_diff(torch, {"q": q["cuda"][full_i]},
                                             {"q": q["cpu"][full_i]}),
               user_sweep_rel_diff_all_rows=_rel_diff(
                   torch, {"p": p["cuda"]}, {"p": p["cpu"]}),
               item_sweep_rel_diff_all_rows=_rel_diff(
                   torch, {"q": q["cuda"]}, {"q": q["cpu"]}))
    out["ok"] = (max(out["user_sweep_rel_diff"],
                     out["item_sweep_rel_diff"]) <= ALS_ITER_TOL
                 and max(out["user_sweep_rel_diff_all_rows"],
                         out["item_sweep_rel_diff_all_rows"])
                 <= ALS_THIN_TOL)
    return out


def _als_trained_vs_cpu(torch, cls, cfg, train, params):
    """One iteration from the trained factors ``params`` on the card, on
    the CPU, on the CPU in f64, and on each device from the factors moved
    by one ulp. The trained low-rank factors make the Grams
    ill-conditioned, so any two f32 solves of the same system differ far
    more than the sweeps from N(0, 0.3) factors do: the card passes when
    its distance is at most ALS_ROUNDING_MULT times the f32 rounding
    measured on the CPU (ALS: the card's and the CPU's distances from f64;
    WRMF ridge, whose jitter scales with the dtype's eps: the card's
    distance from the CPU against the larger one-ulp spread)."""
    import dataclasses

    start = {k: v.cpu() for k, v in params.items()}
    g = torch.Generator().manual_seed(SEED)
    ulp = {k: v * (1.0 + torch.finfo(torch.float32).eps * torch.sign(
        torch.randn(v.shape, generator=g))) for k, v in start.items()}
    runs = [("cuda", "cuda", cfg, start), ("cpu", "cpu", cfg, start),
            ("cuda_ulp", "cuda", cfg, ulp), ("cpu_ulp", "cpu", cfg, ulp)]
    if not cls.weighted:
        runs.append(("cpu_f64", "cpu",
                     dataclasses.replace(cfg, dtype=torch.float64), start))
    res = {name: _als_iteration_on(torch, cls, c, train, dev, f)
           for name, dev, c, f in runs}
    out = dict(rel_diff_vs_cpu=_rel_diff(torch, res["cuda"], res["cpu"]),
               cpu_ulp_spread=_rel_diff(torch, res["cpu_ulp"], res["cpu"]),
               card_ulp_spread=_rel_diff(torch, res["cuda_ulp"],
                                         res["cuda"]),
               mult=ALS_ROUNDING_MULT)
    if cls.weighted:
        out["ok"] = out["rel_diff_vs_cpu"] <= ALS_ROUNDING_MULT * max(
            out["cpu_ulp_spread"], out["card_ulp_spread"])
    else:
        out.update(card_rel_diff_vs_f64=_rel_diff(torch, res["cuda"],
                                                  res["cpu_f64"]),
                   cpu_rel_diff_vs_f64=_rel_diff(torch, res["cpu"],
                                                 res["cpu_f64"]))
        out["ok"] = (out["card_rel_diff_vs_f64"]
                     <= ALS_ROUNDING_MULT * out["cpu_rel_diff_vs_f64"])
    return out


def phase_cf_checks(torch, held, results):
    """Two ItemCF and two UserCF scorings of one batch, and two TOPN passes,
    the same bits, and R@10 within 1e-6 of the CPU build's; B8's CF sums
    against their plain version (B8's tolerance) and its kernel row at the
    ItemCF scoring shape; the neighbour ids built on the card equal the
    CPU's; the two sweeps of one
    ALS and one WRMF-ridge iteration on the card against the CPU's from
    the same inputs, 1e-4 relative per table on the full-rank rows and
    2e-3 on all (_als_sweeps_vs_cpu); and a whole iteration from the
    trained factors, within twice the f32 rounding the CPU shows
    (_als_trained_vs_cpu)."""
    from cdae_tpu_torch.evaluation import Evaluation
    from cdae_tpu_torch.models import ALS, WRMF
    from cdae_tpu_torch.ops.topk import topk_unrated

    out = dict(phase="cf_checks", tol=ALS_ITER_TOL, thin_tol=ALS_THIN_TOL)
    ok = True
    train, test = held["ml1m"][1]
    for key in ("itemcf", "usercf"):
        solver = held[key]
        model, state = solver.model, solver.state
        uids, rated_items, rated_mask = _cf_batch(torch, held)
        a = model.batch_scores(state, uids, rated_items, rated_mask)
        b = model.batch_scores(state, uids, rated_items, rated_mask)
        top_a, _ = topk_unrated(a, rated_items, 10)
        top_b, _ = topk_unrated(b, rated_items, 10)
        runs = [Evaluation.create("TOPN").evaluate(model, state, test, train)
                for _ in range(2)]
        cpu_model = type(model)(model.cfg, device="cpu")
        cpu = cpu_model.reset(train)
        cpu_r10 = Evaluation.create("TOPN").evaluate(cpu_model, cpu, test,
                                                     train)["R@10"]
        ids_equal = torch.equal(state.params["nbr_ids"].cpu(),
                                cpu.params["nbr_ids"])
        sims_err = (state.params["nbr_sims"].cpu()
                    - cpu.params["nbr_sims"]).abs().max().item()
        same = bool(torch.equal(a, b) and torch.equal(top_a, top_b))
        topn_equal = all(runs[0][c] == runs[1][c]
                         for c in ("P@10", "R@10", "MAP@10"))
        r10_close = abs(runs[0]["R@10"] - cpu_r10) <= CF_R10_TOL
        out[key] = dict(batch_users=len(uids), scores_bit_equal=same,
                        topn_equal=topn_equal, nbr_ids_equal_cpu=ids_equal,
                        nbr_sims_max_abs_err_cpu=sims_err,
                        recall_at_10=runs[0]["R@10"], cpu_recall_at_10=cpu_r10)
        ok = ok and same and topn_equal and ids_equal and r10_close
    row = _cf_kernel_row(torch, held, results)
    emit(row)
    out["b8_itemcf"] = dict(max_abs_err=row["max_abs_err"], ok=row["ok"])
    ok = ok and row["ok"]
    for key, cls in (("als", ALS), ("wrmf", WRMF)):
        cfg = held[key].model.cfg
        out[key] = sweeps = _als_sweeps_vs_cpu(torch, cls, cfg, train)
        sweeps["trained_iteration"] = trained = _als_trained_vs_cpu(
            torch, cls, cfg, train, held[key].state.params)
        ok = ok and sweeps["ok"] and trained["ok"]
    out["ok"] = ok
    return out


def phase_zoo_speed(torch, held):
    """ALS, WRMF ridge and WRMF eigh on the ML-1M-scale split: one warm-up
    iteration, 3 timed (host clock between synchronizes), then one under
    torch.profiler (device ms, idle share, the largest kernels); peak
    memory over the timed ones (the item side's (solve_batch, L, D) rows
    are the largest)."""
    import dataclasses

    from cdae_tpu_torch.models import ALS, WRMF
    from cdae_tpu_torch.solver.solver import _params_finite

    train = held["ml1m"][1][0]
    by_item = train.by_item().padded()
    out = dict(phase="zoo_speed", users=train.num_users,
               items=train.num_items, interactions=len(train),
               user_side_L=int(train.padded().max_len),
               item_side_L=int(by_item.max_len))
    ok = True
    for route, key, cls, kw in (("als", "als", ALS, {}),
                                ("wrmf_ridge", "wrmf", WRMF, {}),
                                ("wrmf_eigh", "wrmf", WRMF,
                                 dict(w_solver="eigh"))):
        cfg = dataclasses.replace(held[key].model.cfg, **kw)
        model = cls(cfg, device="cuda")
        state = model.reset(train, seed=SEED)
        model.train_one_iteration(state, SEED)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            model.train_one_iteration(state, SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof = _profile(torch, lambda: model.train_one_iteration(state, SEED))
        finite = _params_finite(state.params)
        out[route] = dict(w_solver=cfg.w_solver,
                          solve_batch=cfg.solve_batch,
                          ms_per_iteration=wall * 1e3 / 3,
                          peak_mem_gb=peak, params_finite=finite,
                          profiled_iteration=prof)
        ok = ok and finite
        del state
    out["ok"] = ok
    return out


# ------------------------------ LinearModel, FactorModel and NegMF ----

FEATURE_TRAIN = ["--task", "train", "--num_dim", "10", "--max_iters", "10",
                 "--eval_iters", "5", "--skip_popularity", "--seed",
                 str(SEED), "--test_ratio", "0.2"]
NEGMF_TRAIN = ["--method", "NEGMF", "--batch_size", "4096", "--num_neg", "5",
               "--loss_type", "LOG"]
# an epoch on the card against one on the CPU from the same tables and
# draws (B8's fixed-order sums against index_add), per table
FEATURE_REL_TOL = 1e-5
FEATURE_KEYS = ("negmf", "negmf_dense", "linear", "fm")


def _feature_cli(torch, tmp, data, name, argv):
    """cli.train of FEATURE_TRAIN + ``argv`` on ``data`` (cached once as
    ``name``); returns the Solver and the task's seconds."""
    from cdae_tpu_torch import cli
    from cdae_tpu_torch.data import io as data_io

    cache = os.path.join(tmp, name + ".bin")
    if not os.path.exists(cache):
        data_io.save_interactions(data, cache)
    t0 = time.perf_counter()
    solver = cli.train(cli.build_arg_parser().parse_args(
        FEATURE_TRAIN + ["--cache_file", cache] + argv))
    torch.cuda.synchronize()
    return solver, time.perf_counter() - t0


def _feature_row(phase, solver, seconds, col, loss0=None):
    """A training phase's row: the metric and the training objective
    (data + penalty loss; ``loss0`` at epoch 0) at each eval; ok when the
    metric rose (fell, for RMSE) from epoch 0, the params stayed finite
    and SGDSolver trained the model."""
    from cdae_tpu_torch.solver.solver import SGDSolver, _params_finite

    hist = solver.history
    finite = _params_finite(solver.state.params)
    first, last = hist[0][col], hist[-1][col]
    moved = last < first if col == "RMSE" else last > first
    cfg = solver.model.cfg
    row = dict(phase=phase, method=solver.model.name,
                route="slab" if "dense_R" in solver.state.aux else "sparse",
                solver=type(solver).__name__, batch=cfg.batch_size,
                learn_rate=solver.model._lr, loss=cfg.loss,
                D=getattr(cfg, "num_dim", None),
                instances=len(solver.state.aux["instances"]),
                feature_rows=solver.state.aux["instances"].total_dim,
                cli_seconds=seconds, metric=col,
                by_epoch={int(r["iter"]): r[col] for r in hist},
                params_finite=finite,
                ok=finite and moved and isinstance(solver, SGDSolver))
    if loss0 is not None:  # NegMF reports no loss (as the reference)
        row["train_loss"] = {int(r["iter"]): r["train_loss"] for r in hist}
        row["train_loss"][0] = loss0
    return row


def phase_train_negmf(torch, tmp, held):
    """CLI --method NEGMF on the ML-1M-scale low-rank data: D=10, batch
    4096, num_neg 5, LOG, 10 epochs (189 steps an epoch; B8 sums each
    step's 49,152 ids into the 9,746 feature rows). R@10 rises."""
    solver, s = _feature_cli(torch, tmp, held["ml1m_data"], "ml1m_lowrank",
                             NEGMF_TRAIN)
    held["negmf"] = solver
    row = _feature_row("train_negmf", solver, s, "R@10")
    row["ok"] = row["ok"] and row["route"] == "sparse"
    return row


def phase_train_negmf_dense(torch, tmp, held):
    """The same with --dense_mode true at 2x lr (the slab's equal-epoch
    protocol, scripts/parity_zoo.py): 2 slabs of (4096, 3706) an epoch.
    R@10 rises."""
    solver, s = _feature_cli(torch, tmp, held["ml1m_data"], "ml1m_lowrank",
                             NEGMF_TRAIN + ["--dense_mode", "true",
                                            "--learn_rate", "0.2"])
    held["negmf_dense"] = solver
    row = _feature_row("train_negmf_dense", solver, s, "R@10")
    row["ok"] = row["ok"] and row["route"] == "slab"
    return row


def _rated_data(held):
    if "rated_data" not in held:
        from cdae_tpu_torch.data.synthetic import lowrank_rated

        held["rated_data"] = lowrank_rated(6040, 3706, 160, seed=SEED)
        held["pmf_data"] = held["rated_data"].split_by_user(0.2, seed=SEED)
    return held["rated_data"]


# LINEAR's test RMSE at epoch 10 against epoch 0's (the global mean's)
LINEAR_RMSE_SPREAD = 0.02


def phase_train_linear(torch, tmp, held, method):
    """CLI --method LINEAR or FM (D=10) --eval RMSE on lowrank_rated data
    of ML-1M's dimensions, the CLI's batch 1024, 10 epochs: the training
    objective falls from epoch 0 (a fresh reset with the run's seed) to
    10, and FM's test RMSE falls. LinearModel's cannot: lowrank_rated
    standardizes each user's ratings and draws them independently of
    which items a user rated, so no user or item bias predicts a held-out
    rating better than the global mean (cdae_tpu's LinearModel on the same
    data and settings moves its RMSE the same way); its test RMSE stays
    within LINEAR_RMSE_SPREAD of epoch 0's."""
    solver, s = _feature_cli(torch, tmp, _rated_data(held), "ml1m_rated",
                             ["--method", method, "--eval", "RMSE"])
    held[method.lower()] = solver
    fresh = type(solver.model)(solver.model.cfg, device="cuda")
    loss0 = fresh.current_loss(fresh.reset(held["pmf_data"][0], seed=SEED))
    row = _feature_row(f"train_{method.lower()}", solver, s, "RMSE",
                       loss0=loss0)
    fell = row["train_loss"][10] < loss0
    if method == "LINEAR":
        rmse = row["by_epoch"]
        row["rmse_spread"] = LINEAR_RMSE_SPREAD
        row["ok"] = (row["params_finite"] and fell
                     and abs(rmse[10] - rmse[0]) <= LINEAR_RMSE_SPREAD)
    else:
        row["ok"] = row["ok"] and fell
    return row


def _feature_split(held, key):
    return (held["pmf_data"] if key in ("linear", "fm")
            else held["ml1m"][1])[0]


def _feature_model(torch, held, key, device, params=None):
    """A fresh model of ``held[key]``'s configuration on ``device``, reset
    on its training split; with ``params``, those tables (moved to
    ``device``)."""
    model = held[key].model
    m = type(model)(model.cfg, device=device)
    state = m.reset(_feature_split(held, key), seed=SEED)
    if params is not None:
        state.params = {k: v.to(device) for k, v in params.items()}
    return m, state


def _feature_draws(torch, model, state, rng):
    """numpy-made draws of one epoch, the same on every device: the
    permutation, and NegMF's complement uniforms (sparse) or (B, I)
    uniforms (slab)."""
    import numpy as np

    bs = model.cfg.batch_size
    if "dense_R" in state.aux:
        U = state.num_users
        B = min(bs, U)
        return dict(draws=[{"u01": torch.from_numpy(rng.random(
            (B, state.num_items), dtype=np.float32))}
            for _ in range(-(-U // B))])
    perm = rng.permutation(len(state.aux["instances"]))
    if model.name != "NegMF":
        return dict(perm=perm)
    users = state.aux["coo"][0]
    sel = np.concatenate([perm, np.zeros(-len(perm) % bs, perm.dtype)])
    free = np.maximum(state.num_items - state.padded.lengths[users[sel]], 1)
    u = (rng.random((len(sel), model.cfg.num_neg)) * free[:, None]).astype(
        np.int32)
    return dict(perm=perm, draws=[{"u": torch.from_numpy(u[s:s + bs])}
                                  for s in range(0, len(sel), bs)])


def _negmf_kernel_row(torch, held, results):
    """B8 at a NegMF sparse step's shape: the first step's B * (num_neg +
    1) * 2 ids (positives and complement negatives, users and items at
    offset U) into U + I rows, (P, 1 + D) values. Against its plain
    version, two launches the same bits, its span and device time (plan
    and reduce apart) beside index_add_'s, and the byte bound."""
    import cdae_tpu_torch.ops.pallas_kernels as P
    from cdae_tpu_torch.ops.sampling import sample_unrated

    model, state = _feature_model(torch, held, "negmf", "cuda")
    users, items, pad_items, lengths = model._device_data(state)
    bs, nn, U = model.cfg.batch_size, model.cfg.num_neg, state.num_users
    gen = torch.Generator().manual_seed(SEED)
    sel = torch.randperm(users.shape[0], generator=gen)[:bs].cuda()
    u = users[sel]
    neg = sample_unrated(SEED, pad_items[u], lengths[u], state.num_items, nn)
    all_i = torch.cat([items[sel][:, None],
                       neg.clamp(max=state.num_items - 1)], dim=1)
    idx = torch.stack([u[:, None].expand(bs, nn + 1).reshape(-1),
                       all_i.reshape(-1) + U], dim=1).reshape(-1).contiguous()
    N = state.params["w"].shape[0]
    C = 1 + model.cfg.num_dim
    g = torch.Generator(device="cuda").manual_seed(SEED)
    vals = torch.randn((idx.shape[0], C), generator=g, device="cuda")
    out = P.scatter_matmul(idx, vals, N)
    again = P.scatter_matmul(idx, vals, N)
    plain = P.scatter_matmul_plain(idx, vals, N)
    torch.cuda.synchronize()
    ok, err = _rows_ok(torch, out, plain)
    plan = P.scatter_plan(idx, N)
    row = dict(phase="kernel_negmf", kernel="scatter_matmul",
               case="negmf_step", path="linear_training", P=idx.shape[0],
               N=N, C=C,
               rtol=ROWS_RTOL, atol_scale=ROWS_ATOL, max_abs_err=err,
               bit_equal_relaunch=bool(torch.equal(out, again)),
               ms=median_ms(lambda: P.scatter_matmul(idx, vals, N)),
               plan_ms=median_ms(lambda: P.scatter_plan(idx, N)),
               reduce_ms=median_ms(lambda: P.scatter_matmul(idx, vals, N,
                                                            plan=plan)),
               plain_ms=median_ms(lambda: P.scatter_matmul_plain(idx, vals,
                                                                 N)),
               library="index_add_",
               library_ms=median_ms(lambda: torch.zeros(
                   (N, C), device="cuda").index_add_(0, idx, vals)),
               device_ms=dict(
                   span=device_ms(lambda: P.scatter_matmul(idx, vals, N)),
                   plan=device_ms(lambda: P.scatter_plan(idx, N)),
                   reduce=device_ms(lambda: P.scatter_matmul(
                       idx, vals, N, plan=plan)),
                   index_add=device_ms(lambda: torch.zeros(
                       (N, C), device="cuda").index_add_(0, idx, vals))),
               # values, ids and the output once each; one add per value
               **bound(4.0 * vals.numel() + 8.0 * idx.shape[0]
                       + 4.0 * N * C, float(vals.numel())))
    row["ok"] = ok and row["bit_equal_relaunch"]
    record(results, "scatter_matmul", row)
    return row


def phase_linear_checks(torch, held, results):
    """Each feature-group route (NegMF sparse and slab, LinearModel,
    FactorModel): one epoch on the card against one on the CPU from the
    same tables and numpy-made draws, every table within 1e-5 relative;
    two 2-epoch runs on the card with the model's own draws, the same
    bits. Then B8's kernel row at the NegMF step's shape."""
    import numpy as np

    out = dict(phase="linear_checks", tol=FEATURE_REL_TOL)
    ok = True
    for key in FEATURE_KEYS:
        model, state = _feature_model(torch, held, key, "cuda")
        start = {k: v.cpu() for k, v in state.params.items()}
        cpu_model, cpu_state = _feature_model(torch, held, key, "cpu",
                                              params=start)
        epoch = {}
        for dev, m, st in (("cuda", model, state),
                           ("cpu", cpu_model, cpu_state)):
            draws = _feature_draws(torch, m, st, np.random.default_rng(SEED))
            t0 = time.perf_counter()
            m.train_one_iteration(st, SEED, **draws)
            if dev == "cuda":
                torch.cuda.synchronize()
            epoch[dev] = time.perf_counter() - t0
        rel = _rel_diff(torch, {k: v.cpu() for k, v in state.params.items()},
                        cpu_state.params)
        runs = []
        for _ in range(2):
            m, st = _feature_model(torch, held, key, "cuda")
            for _ in range(2):
                m.train_one_iteration(st, SEED)
            torch.cuda.synchronize()
            runs.append(st.params)
        equal = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
        out[key] = dict(rel_diff_vs_cpu=rel, runs_bit_equal=equal,
                        epoch_seconds=epoch)
        ok = ok and rel <= FEATURE_REL_TOL and equal
    row = _negmf_kernel_row(torch, held, results)
    emit(row)
    out["b8_negmf"] = dict(max_abs_err=row["max_abs_err"], ok=row["ok"])
    out["ok"] = ok and row["ok"]
    return out


def phase_linear_speed(torch, held):
    """Warm training throughput of each feature-group route (the
    train_speed_mf protocol): one warm-up epoch, 2 timed epochs (host clock
    between synchronizes): users/s for NegMF, instances/s for LinearModel
    and FactorModel, ms a step; then whole epochs of at least 16 steps
    under torch.profiler: launches a step, device ms (B8's apart), idle
    share; B8 plans and reduces a step (wrapper counts); peak memory."""
    import cdae_tpu_torch.ops.pallas_kernels as P
    from cdae_tpu_torch.solver.solver import _params_finite

    out = dict(phase="linear_speed")
    ok = True
    for key in FEATURE_KEYS:
        model, state = _feature_model(torch, held, key, "cuda")
        model.train_one_iteration(state, SEED)  # warm-up
        data = _feature_split(held, key)
        steps = (state.aux["dense_batches"][0].shape[0]
                 if "dense_R" in state.aux
                 else -(-len(state.aux["instances"]) // model.cfg.batch_size))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(2):
            model.train_one_iteration(state, SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (P.scatter_plan.launches, P.scatter_matmul.launches)
        reps = -(-16 // steps)

        def epochs():
            for _ in range(reps):
                model.train_one_iteration(state, SEED)

        prof = _profile(torch, epochs, groups={"b8": B8_KERNELS})
        now = (P.scatter_plan.launches, P.scatter_matmul.launches)
        per = [(b - a) / (steps * reps) for a, b in zip(counts, now)]
        prof["epochs"] = reps
        prof["launches_per_step"] = prof.pop("device_kernels") / (steps
                                                                  * reps)
        if prof["device_busy_ms"] is not None:
            prof["device_ms_per_step"] = prof["device_busy_ms"] / (steps
                                                                   * reps)
        finite = _params_finite(state.params)
        n = len(state.aux["instances"])
        row = dict(users=data.num_users, instances=n,
                   batch=model.cfg.batch_size, steps_per_epoch=steps,
                   seconds_2_epochs=wall,
                   ms_per_step=wall * 1e3 / (2 * steps),
                   b8_plans_per_step=per[0], b8_reduces_per_step=per[1],
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   params_finite=finite, profiled_epoch=prof)
        if key.startswith("negmf"):
            row["users_per_s"] = data.num_users * 2 / wall
        else:
            row["instances_per_s"] = n * 2 / wall
        out[key] = row
        ok = ok and finite and per == [1.0, 1.0]
        del state
    out["ok"] = ok
    return out


LOADER_BUDGET_S = 120.0  # native_loader's wall; the Python parse of the
# ML-20M file is cut to a prefix that keeps the phase inside it
ML20M = (138_493, 26_744, 144)  # synthetic_interactions' ML-20M shape


def _write_lines(path, data, fmt) -> int:
    """``data`` as text lines: "triples" (``user item rating``) or
    "movielens" (``u::i::r::0``); returns the file's bytes."""
    chunk = 1 << 20
    with open(path, "w") as f:
        for s in range(0, len(data), chunk):
            rows = zip(data.users[s:s + chunk].tolist(),
                       data.items[s:s + chunk].tolist(),
                       data.ratings[s:s + chunk].tolist())
            if fmt == "movielens":
                f.write("".join([f"{u}::{i}::{r:g}::0\n" for u, i, r in rows]))
            else:
                f.write("".join([f"{u} {i} {r:g}\n" for u, i, r in rows]))
    return os.path.getsize(path)


def _same_parse(a, b, n=None) -> bool:
    """Two parses hold the same arrays and vocabularies (the first ``n``
    rows of ``a`` against all of ``b`` when ``n`` is given; ids in
    first-seen order, so a prefix's vocabularies are prefixes)."""
    import numpy as np

    n = len(a) if n is None else n
    return (len(b) == n
            and all(np.array_equal(getattr(a, f)[:n], getattr(b, f))
                    for f in ("users", "items", "ratings"))
            and a.user_vocab.to_list()[:b.num_users] == b.user_vocab.to_list()
            and a.item_vocab.to_list()[:b.num_items] == b.item_vocab.to_list())


def phase_native_loader(torch, tmp, held):
    """The host loader (cdae_tpu_torch/_native, g++ on this host): the
    ML-1M-scale low-rank data as ``user item rating`` and ``u::i::r::ts``
    lines, each parsed natively and by the Python loop (the same arrays
    and vocabularies); then the ML-20M shape through --task prepare (the
    native parse's wall and the task's), and the Python loop over the same
    file (its wall; cut to a prefix when the phase would pass
    LOADER_BUDGET_S, the cut printed; the prefix's arrays equal)."""
    from cdae_tpu_torch import _native, cli
    from cdae_tpu_torch.data import io as data_io
    from cdae_tpu_torch.data.dataset import (Interactions,
                                             default_line_parser,
                                             movielens_line_parser)
    from cdae_tpu_torch.data.synthetic import synthetic_interactions

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    native_ok = _native.available()
    build_s = time.perf_counter() - t0
    parsers = {"triples": default_line_parser,
               "movielens": movielens_line_parser}
    ml1m = {}
    for fmt, parser in parsers.items():
        path = os.path.join(tmp, f"ml1m.{fmt}.txt")
        nbytes = _write_lines(path, held["ml1m_data"], fmt)
        walls, parsed = {}, {}
        for native in (True, False):
            t0 = time.perf_counter()
            parsed[native] = Interactions.from_text(path, parser,
                                                    use_native=native)
            walls["native_s" if native else "python_s"] = (
                time.perf_counter() - t0)
        ml1m[fmt] = dict(lines=len(parsed[True]), bytes=nbytes, **walls,
                         speedup=walls["python_s"] / walls["native_s"],
                         equal=_same_parse(parsed[True], parsed[False]))
    t0 = time.perf_counter()
    data = synthetic_interactions(*ML20M, seed=SEED)
    path = os.path.join(tmp, "ml20m.movielens.txt")
    nbytes = _write_lines(path, data, "movielens")
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = Interactions.from_text(path, movielens_line_parser,
                                    use_native=True)
    native_s = time.perf_counter() - t0
    cache = os.path.join(tmp, "ml20m.bin")
    t0 = time.perf_counter()
    cli.run(["--task", "prepare", "--parser", "movielens", "--input_file",
             path, "--cache_file", cache])
    prepare_s = time.perf_counter() - t0
    cached = data_io.load_interactions(cache)
    # the Python loop at the ML-1M movielens rate: cut to the lines that
    # keep the phase inside its budget
    rate = ml1m["movielens"]["lines"] / ml1m["movielens"]["python_s"]
    left = LOADER_BUDGET_S - (time.perf_counter() - t_phase) - 5.0
    n_py = len(native) if left * rate >= len(native) else max(
        int(left * rate), 100_000)
    py_path = path
    if n_py < len(native):
        py_path = os.path.join(tmp, "ml20m.prefix.txt")
        with open(path) as src, open(py_path, "w") as dst:
            for _ in range(n_py):
                dst.write(src.readline())
    t0 = time.perf_counter()
    python = Interactions.from_text(py_path, movielens_line_parser,
                                    use_native=False)
    python_s = time.perf_counter() - t0
    ml20m = dict(users=data.num_users, items=data.num_items,
                 lines=len(native), bytes=nbytes, write_s=write_s,
                 native_parse_s=native_s, prepare_task_s=prepare_s,
                 python_lines=n_py, python_cut=n_py < len(native),
                 python_s=python_s,
                 python_lines_per_s=n_py / python_s,
                 native_lines_per_s=len(native) / native_s,
                 cache_equal=_same_parse(native, cached),
                 python_prefix_equal=_same_parse(native, python, n_py))
    wall = time.perf_counter() - t_phase
    return dict(phase="native_loader", native_available=native_ok,
                library_build_s=build_s,
                threads=os.cpu_count(), ml1m=ml1m, ml20m=ml20m,
                seconds=wall, budget_s=LOADER_BUDGET_S,
                ok=native_ok and all(v["equal"] for v in ml1m.values())
                and ml20m["cache_equal"] and ml20m["python_prefix_equal"]
                and len(native) == len(data))


REC_BATCH = 1024  # users a recommend call


def _recommend_all(torch, model, state, train, k=10):
    """recommend(k) for every user in batches of REC_BATCH: (U, k) ids and
    the warm pass's wall (after a first pass)."""
    import numpy as np

    U = train.num_users
    out = None
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = torch.cat([model.recommend(state, np.arange(
            s, min(s + REC_BATCH, U), dtype=np.int32), train, k=k)
            for s in range(0, U, REC_BATCH)])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, walls


def _rated_rows(torch, train, device):
    from cdae_tpu_torch.data.dataset import rows_from_csr
    import numpy as np

    uids = np.arange(train.num_users, dtype=np.int32)
    rated, _, mask, _ = rows_from_csr(train.csr(), uids, train.num_items)
    return (uids, torch.as_tensor(rated, device=device),
            torch.as_tensor(mask, device=device))


def _plain_top(torch, model, state, uids, rated, mask, k=10):
    """(ids, vals) of the top k+1 from ``model``'s scores, batch by batch
    (the plain reference of a recommend run)."""
    from cdae_tpu_torch.ops.topk import topk_unrated

    ids, vals = [], []
    for s in range(0, len(uids), REC_BATCH):
        sc = model.batch_scores(state, uids[s:s + REC_BATCH],
                                rated[s:s + REC_BATCH], mask[s:s + REC_BATCH])
        i, v = topk_unrated(sc, rated[s:s + REC_BATCH], k + 1)
        ids.append(i)
        vals.append(v)
    return torch.cat(ids), torch.cat(vals)


def _list_checks(torch, ids, rated, plain_ids, plain_vals, k=10):
    """No rated id in any list; the id sets equal the plain ones on every
    row whose plain gap between the k-th and (k+1)-th score exceeds TOL;
    the ordered lists equal on every row whose top k+1 are TOL apart."""
    ids = ids.to(plain_ids.device).long()
    rated = rated.to(plain_ids.device).long()
    no_rated = not bool((ids[:, :, None] == rated[:, None, :]).any())
    gap = plain_vals[:, k - 1] - plain_vals[:, k]
    sure = gap > TOL
    same_set = (torch.sort(ids, 1).values
                == torch.sort(plain_ids[:, :k].long(), 1).values).all(1)
    apart = ((plain_vals[:, :k] - plain_vals[:, 1:k + 1]) > TOL).all(1)
    same_list = (ids == plain_ids[:, :k].long()).all(1)
    return dict(no_rated_ids=no_rated, rows=len(ids),
                rows_checked=int(sure.sum()),
                rows_with_other_ids=int((sure & ~same_set).sum()),
                rows_ordered_checked=int(apart.sum()),
                rows_other_order=int((apart & ~same_list).sum()),
                rows_exactly_equal=int(same_list.sum()))


def phase_recommend(torch, held):
    """recommend(k=10) for all 6,040 users in batches of 1,024 on
    train_ml1m's trained CDAE (D=50; B3 decodes) and on train_imf_sparse's
    IMF: no rated item in any list; CDAE's ids against the plain path
    (use_pallas=False) on the same state and against the lists TOPN ranks
    for the same users; IMF's against the CPU's from the same params;
    users/s of the warm pass."""
    import dataclasses

    import numpy as np

    from cdae_tpu_torch.evaluation import RecListEvaluation
    from cdae_tpu_torch.models.cdae import CDAE
    from cdae_tpu_torch.models.mf import IMF
    from cdae_tpu_torch.ops.topk import topk_unrated

    out = {}
    solver, (train, test) = held["ml1m"]
    model, state = solver.model, solver.state
    uids, rated, mask = _rated_rows(torch, train, "cuda")
    ids, walls = _recommend_all(torch, model, state, train)
    plain = CDAE(dataclasses.replace(model.cfg, use_pallas=False),
                 device="cuda")
    plain_ids, plain_vals = _plain_top(torch, plain, state, uids, rated,
                                       mask)
    cdae = _list_checks(torch, ids, rated, plain_ids, plain_vals)
    # the lists TOPN ranks: the evaluator's batch_scores, top-10 unrated
    topn = {}
    orig = model.batch_scores

    def spy(st, u, ri, rm):
        sc = orig(st, u, ri, rm)
        top, _ = topk_unrated(sc, ri, 10)
        for uid, row in zip(np.asarray(u).tolist(), top):
            topn.setdefault(uid, row)
        return sc

    model.batch_scores = spy
    try:
        RecListEvaluation("TOPN").evaluate(model, state, test, train)
    finally:
        del model.batch_scores
    users = torch.as_tensor(sorted(topn), device="cuda", dtype=torch.long)
    topn_ids = torch.stack([topn[u] for u in sorted(topn)])
    vs_topn = _list_checks(torch, topn_ids, rated[users], ids[users],
                           plain_vals[users])
    cdae.update(topn_users=len(users), vs_topn=vs_topn,
                cold_s=walls[0], warm_s=walls[1],
                users_per_s=len(uids) / walls[1])
    out["cdae"] = cdae

    solver = held["imf_sparse"]
    train_imf = held["ml1m"][1][0]
    model, state = solver.model, solver.state
    ids, walls = _recommend_all(torch, model, state, train_imf)
    cpu = IMF(model.cfg, device="cpu")
    cpu_state = cpu.reset(train_imf, seed=SEED)
    cpu_state.params = {k: v.cpu() for k, v in state.params.items()}
    cu, crated, cmask = _rated_rows(torch, train_imf, "cpu")
    cpu_rec = cpu.recommend(cpu_state, cu, train_imf, k=10)
    cpu_ids, cpu_vals = _plain_top(torch, cpu, cpu_state, cu, crated, cmask)
    imf = _list_checks(torch, ids, crated, cpu_ids, cpu_vals)
    imf.update(equal_to_cpu_recommend=int(
        (ids.cpu() == cpu_rec).all(1).sum()), cold_s=walls[0],
        warm_s=walls[1], users_per_s=len(cu) / walls[1])
    out["imf"] = imf
    ok = all(v["no_rated_ids"] and not v["rows_with_other_ids"]
             and not v["rows_other_order"] for v in (cdae, imf, vs_topn))
    ok = ok and cdae["rows_checked"] > 0.9 * len(uids)
    return dict(phase="recommend", users=len(uids), k=10, batch=REC_BATCH,
                **out, ok=ok)


SWEEP_POINTS = 12
SWEEP_GATE = 0.03  # |mean R@10 delta| over the points against the record
SWEEP_DATA = (2000, 800, 40)  # the record's lowrank_interactions


def phase_sweep(torch, tmp, repo):
    """--task sweep --sweep_limit 12 --max_iters 50 --batch_size 64 through
    the CLI on lowrank_interactions(2000, 800, 40), the data of
    SWEEP_CDAE_r2.jsonl: 12 JSON lines, grid indices 0-11, each point's
    configuration paper_grid()'s, R@10 and MAP@10 finite; each point's
    R@10 beside the record's and |mean delta| <= SWEEP_GATE (single points
    not gated); seconds a point."""
    import contextlib
    import io

    from cdae_tpu_torch import cli
    from cdae_tpu_torch.data import io as data_io
    from cdae_tpu_torch.data.synthetic import lowrank_interactions
    from cdae_tpu_torch.sweep import paper_grid

    cache = os.path.join(tmp, "sweep.bin")
    data_io.save_interactions(
        lowrank_interactions(*SWEEP_DATA, seed=SEED), cache)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.run(["--task", "sweep", "--cache_file", cache, "--sweep_limit",
                 str(SWEEP_POINTS), "--max_iters", "50", "--batch_size",
                 "64", "--seed", str(SEED), "--test_ratio", "0.2"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = [json.loads(x) for x in buf.getvalue().splitlines()
             if x.startswith("{")]
    with open(os.path.join(repo, "SWEEP_CDAE_r2.jsonl")) as f:
        record = {r["grid_index"]: r for r in map(json.loads, f)}
    grid = list(paper_grid())
    points, deltas = [], []
    for r in lines:
        ref = record[r["grid_index"]]["R@10"]
        deltas.append(r["R@10"] - ref)
        points.append(dict(grid_index=r["grid_index"], r10=r["R@10"],
                           map10=r["MAP@10"], record_r10=ref,
                           delta=r["R@10"] - ref))
    mean_delta = sum(deltas) / len(deltas) if deltas else float("nan")
    ok = (len(lines) == SWEEP_POINTS
          and [r["grid_index"] for r in lines] == list(range(SWEEP_POINTS))
          and all({k: r[k] for k in grid[0]} == grid[r["grid_index"]]
                  for r in lines)
          and all(_finite(r["R@10"]) and _finite(r["MAP@10"])
                  for r in lines)
          and abs(mean_delta) <= SWEEP_GATE)
    return dict(phase="sweep", points=points, mean_delta=mean_delta,
                gate=SWEEP_GATE, seconds=wall,
                seconds_per_point=wall / max(len(lines), 1), ok=ok)


# ------------------------------------------------------ the sharded path ----
# counts from 0 before sharded_nccl; the path's counts are the launches of
# its sharded runs alone (``launches_sharded_runs``: the single-card twins
# and the references they are held against are not counted): every kernel
# of the sharded trainers launched by one rank over NCCL in this process
# (B1, B2, B3, B5, B6, B7, B8). sharded_gloo's ranks count their sharded
# runs apart the same way, and each must launch GLOO_KERNELS

SHARDED_EPOCHS = 2
# a sharded run against the single-device run: the CPU tests' limits, per
# table -- ||a - b|| / ||b|| <= ROUTE_REL_TOL (1e-4), as the smoke holds two
# routes whose sums run in other orders. The elementwise ratio to the CPU
# tests' rtol 1e-4 / atol 1e-5 is printed too: at these widths a gradient
# that is a small difference of large sums (AdaGrad accumulators square
# it) moves by more than that where only the order of the sums changed
SHARDED_RTOL, SHARDED_ATOL = 1e-4, 1e-5
# the kernels every gloo rank's sharded runs launch: B1, B2, B6 (the
# sparse 1 x 2 TOPN), B7 and B8
GLOO_KERNELS = ("hw_uniform", "adagrad_update", "fused_topk_scores_csr",
                "warp_violator_select", "scatter_matmul", "scatter_plan")
# the rounding witness: the dense CDAE cases' single-device run repeated on
# the CPU (the same program, its sums in the CPU library's order) and held
# against the card's by the same measures as the sharded runs
WITNESS_CASES = ("cdae_dense_1x2", "cdae_dense_2x1")


def _within(torch, got: dict, want: dict) -> dict:
    """Over the tables of ``want``: the largest relative distance ||a - b||
    / ||b|| (gated at ROUTE_REL_TOL), the largest |a - b| and the largest
    |a - b| / (atol + rtol |b|) (printed)."""
    worst, err, rel = 0.0, 0.0, 0.0
    for k, b in want.items():
        a, b = got[k].double(), b.double()
        d = (a - b).abs()
        err = max(err, d.max().item())
        worst = max(worst, (d / (SHARDED_ATOL + SHARDED_RTOL
                                 * b.abs())).max().item())
        rel = max(rel, (d.norm() / b.norm().clamp_min(1e-30)).item())
    return dict(max_rel_diff=rel, max_abs_err=err,
                elementwise_worst_ratio=worst, within=rel <= ROUTE_REL_TOL)


def _eval_batches(torch, train, test, dev):
    from cdae_tpu_torch.evaluation import RecListEvaluation

    return RecListEvaluation("TOPN")._batches(test, train, dev)[1]


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _lists_vs_topn(torch, lists, batches, ref_scores):
    """A sharded model's top-10 lists (one a batch of ``batches``) against
    the single-device TOPN's (``ref_scores``(uids, rated, mask) -> (B, I),
    then topk_unrated): equal on every row whose 10th and 11th reference
    scores are TOL apart."""
    from cdae_tpu_torch.ops.topk import topk_unrated

    checked = differ = 0
    for got, (uids, rated, mask, *_) in zip(lists, batches):
        ids, vals = topk_unrated(ref_scores(uids, rated, mask), rated, 11)
        sure = (vals[:, 9] - vals[:, 10]) > TOL
        same = (got.to(ids.device).long() == ids[:, :10].long()).all(dim=1)
        checked += int(sure.sum())
        differ += int((sure & ~same).sum())
    return dict(rows_checked=checked, rows_differ=differ)


def phase_sharded_nccl(torch, tmp, held, device="cuda"):
    """One rank over NCCL, in this process: ``--task train --sharded true
    --method CDAE`` through the CLI at ML-1M width (6040 x 3706, D=50,
    batch 1024), 2 epochs, dense (B1, B2, B5) and sparse (B8, B2, B6),
    each beside the same command without --sharded: the tables bit for bit,
    the TOPN lists equal to the single-device lists of the same kernel and
    (TOL rule) to its evaluator's; the sharded scores (B3) against the
    single-device decode; then one ShardedPairwise WARP epoch (B7, B8, B2)
    bit for bit; warm users/s of a third epoch beside the single device's,
    and one more epoch of each under torch.profiler (dense). At one rank
    every collective of the steps is the identity (parallel/mesh.py), so
    an explicit all_reduce checks the NCCL group itself. Only the sharded
    runs are counted (``launches_sharded_runs``).
    (``device="cpu"`` runs it over gloo on the CPU: a dry run of the
    phase's code at a small size.)"""
    import torch.distributed as dist

    from cdae_tpu_torch import cli
    from cdae_tpu_torch.data import io as data_io
    from cdae_tpu_torch.models.cdae import _serve_hidden, _topk_from_hidden
    from cdae_tpu_torch.models.mf import WARP
    from cdae_tpu_torch.parallel.distributed import initialize, shutdown
    from cdae_tpu_torch.parallel.trainer import ShardedPairwise

    data = held["ml1m_data"]
    cache = os.path.join(tmp, "sharded_ml1m.bin")
    data_io.save_interactions(data, cache)
    train, test = data.split_by_user(0.2, seed=SEED)
    dev = torch.device(device)
    batches = _eval_batches(torch, train, test, dev)
    if not initialize(f"file://{os.path.join(tmp, 'nccl_rdv')}", 1, 0,
                      device=device):
        raise RuntimeError("the one-rank process group did not start")
    U = data.num_users
    out = dict(phase="sharded_nccl", backend=dist.get_backend(), world=1,
               users=U, items=data.num_items, D=50, epochs=SHARDED_EPOCHS)
    one = torch.ones(4, device=dev)
    dist.all_reduce(one)
    out["all_reduce_ok"] = ok = bool((one == 1).all())
    # the launches of the sharded runs alone (the path's counts also hold
    # their single-card twins)
    tally = dict.fromkeys(KERNELS, 0)

    def sharded(fn):
        before = {n: wrapper(n).launches for n in KERNELS}
        result = fn()
        for n in KERNELS:
            tally[n] += wrapper(n).launches - before[n]
        return result

    try:
        argv = [a for a in ML1M_TRAIN]
        argv[argv.index("--max_iters") + 1] = str(SHARDED_EPOCHS)
        argv[argv.index("--eval_iters") + 1] = str(SHARDED_EPOCHS)
        for dense in ("true", "false"):
            args = argv + ["--cache_file", cache, "--dense_mode", dense,
                           "--device", device]
            runs = {}
            for flag in ("false", "true"):
                argv_f = cli.build_arg_parser().parse_args(
                    args + ["--sharded", flag])
                t0 = time.perf_counter()
                runs[flag] = (sharded if flag == "true" else
                              lambda f: f())(lambda: cli.train(argv_f))
                _sync(torch, dev)
                runs[flag].seconds = time.perf_counter() - t0
            single, sh = runs["false"], runs["true"]
            model, st = sh.model, sh.state
            whole = model.gathered(st).params
            bitwise = all(torch.equal(whole[k], v)
                          for k, v in single.state.params.items())
            mode = "fused_dense" if dense == "true" else "fused_csr"
            R = single.state.aux.get("dense_R")
            same_kernel, got = True, []
            for uids, rated, mask, *_ in batches:
                got.append(sharded(lambda: model.batch_topk(
                    st, uids, rated, mask, 10)))
                u = torch.as_tensor(uids, dtype=torch.long, device=dev)
                cfg = single.model.cfg
                z = _serve_hidden(single.state.params, u, rated, mask,
                                  cfg=cfg,
                                  coll=single.state.aux["coll"])
                ref = _topk_from_hidden(z, single.state.params, u, rated, R,
                                        cfg=cfg, mode=mode, k=10)
                same_kernel &= bool(torch.equal(got[-1], ref))
            lists = _lists_vs_topn(
                torch, got, batches,
                lambda u, r, m: single.model.batch_scores(single.state, u,
                                                          r, m))
            uids, rated, mask, *_ = batches[-1]
            s_sh = sharded(lambda: model.batch_scores(st, uids, rated,
                                                      mask))
            s_1 = single.model.batch_scores(single.state, uids, rated, mask)
            scores_err = (s_sh - s_1).abs().max().item()
            hist = {k: [r["R@10"] for r in runs[k].history] for k in runs}
            speed = {}
            for name, m, s in (("single", single.model, single.state),
                               ("sharded", model, st)):
                _sync(torch, dev)
                t0 = time.perf_counter()
                (sharded if name == "sharded" else lambda f: f())(
                    lambda: m.train_one_iteration(s, SEED))
                _sync(torch, dev)
                speed[name] = U / (time.perf_counter() - t0)
            prof = {}
            if dense == "true" and dev.type == "cuda":
                prof["single"] = _profile(torch, lambda: (
                    single.model.train_one_iteration(single.state, SEED)),
                    host=True)
                prof["sharded"] = sharded(lambda: _profile(
                    torch, lambda: model.train_one_iteration(st, SEED),
                    host=True))
            row_ok = (bitwise and same_kernel and lists["rows_differ"] == 0
                      and scores_err <= TOL and hist["true"] == hist["false"])
            ok &= row_ok
            out["dense" if dense == "true" else "sparse"] = dict(
                model=type(model).__name__, tables_bitwise=bitwise,
                lists_equal_same_kernel=same_kernel, lists_vs_topn=lists,
                scores_max_abs_err_b3=scores_err, recall_at_10=hist,
                cli_seconds={k: runs[k].seconds for k in runs},
                warm_users_per_s=speed, profile_epoch=prof, ok=row_ok)
        # B7 on the sharded path: a data-parallel WARP epoch at world 1
        train_w = held["ml1m"][1][0]
        cfg = _warp_cfg(use_pallas=True)  # B7 (its plain version on a CPU)
        single = WARP(cfg, device=dev)
        ss = single.reset(train_w, seed=SEED)
        sh = ShardedPairwise(WARP(cfg, device=dev))
        st = sh.reset(train_w, seed=SEED)
        single.train_one_iteration(ss, SEED)
        sharded(lambda: sh.train_one_iteration(st, SEED))
        whole = sh.gathered(st).params
        warp_bitwise = all(torch.equal(whole[k], v)
                           for k, v in ss.params.items())
        ok &= warp_bitwise
        out["warp"] = dict(model=sh.name, epochs=1,
                           tables_bitwise=warp_bitwise)
    finally:
        shutdown()
    out["launches_sharded_runs"] = tally
    out["ok"] = bool(ok)
    return out


def phase_sharded_gloo(torch, tmp, held, repo, device="cuda"):
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    device), spawned here: each runs ``sharded_rank`` and rank 0 writes the
    results. Every rank's sharded runs must launch each of GLOO_KERNELS.
    The users/s here are host-staged collectives on one card, not
    scaling."""
    from cdae_tpu_torch.data import io as data_io

    cache = os.path.join(tmp, "sharded_gloo.bin")
    data_io.save_interactions(held["ml1m_data"], cache)
    rdv = os.path.join(tmp, "gloo_rdv")
    res_path = os.path.join(tmp, "gloo_ranks.json")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(repo, "chip_smoke.py"),
         "--sharded-rank", str(r), "2", rdv, cache, res_path, device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=400)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0])
    wall = time.perf_counter() - t0
    codes = [p.returncode for p in procs]
    if any(codes) or not os.path.exists(res_path):
        raise RuntimeError(f"gloo ranks exited {codes}:\n" + "\n".join(
            f"--- rank {r}\n{log[-4000:]}" for r, log in enumerate(logs)))
    with open(res_path) as f:
        res = json.load(f)
    by_rank = []
    for r in range(2):
        with open(f"{res_path}.{r}") as f:
            by_rank.append(json.load(f))
    never = [[r, n] for r, counts in enumerate(by_rank)
             for n in GLOO_KERNELS if not counts.get(n)
             and device == "cuda"]  # a CPU dry run launches no kernel
    res["ok"] = res["ok"] and not never
    return dict(phase="sharded_gloo", backend="gloo", world=2,
                seconds=wall, launches_by_rank=by_rank,
                never_launched=never, **res)


def sharded_rank(rank: int, world: int, rdv: str, cache: str,
                 out: str, device: str = "cuda") -> int:
    """One gloo rank of sharded_gloo on the card: each sharded trainer at
    the smoke's widths, 1-2 epochs, against the single-device model (rank
    0 trains it after each case), the sharded top-k lists against the
    single-device lists, a sharded checkpoint resumed bit for bit, warm
    users/s; the dense CDAE cases' device memory beside the single
    device's, and their single-device run repeated on the CPU (the
    rounding witness, WITNESS_CASES); rank 0 writes the results to
    ``out``. Each rank writes the launches of its sharded runs alone
    (rank 0's references and witness are not counted)."""
    import dataclasses

    import torch

    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    import cdae_tpu_torch.ops.pallas_kernels as P
    from cdae_tpu_torch.data import io as data_io
    from cdae_tpu_torch.evaluation import RecListEvaluation
    from cdae_tpu_torch.models import (BPR, IMF, WARP, ALSConfig, CDAEConfig,
                                       FactorModelConfig, FISMConfig,
                                       MFConfig, NegMF)
    from cdae_tpu_torch.parallel import trainer as T
    from cdae_tpu_torch.parallel.distributed import initialize, shutdown
    from cdae_tpu_torch.parallel.mesh import make_mesh
    from cdae_tpu_torch.parallel.tp_pairwise import ShardedMFTP
    from cdae_tpu_torch.utils import checkpoint as ckpt

    initialize(f"file://{rdv}", world, rank, device=device, backend="gloo")
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    meshes = {"1x2": make_mesh(n_model=2, device=dev),
              "2x1": make_mesh(n_model=1, device=dev)}
    data = data_io.load_interactions(cache)
    train, test = data.split_by_user(0.2, seed=SEED)
    U = data.num_users
    batches = _eval_batches(torch, train, test, dev)
    cdae = CDAEConfig(num_dim=50, corruption_ratio=0.5, scaled=True,
                      num_neg=5, loss="SQUARE", batch_size=1024)
    mf = MFConfig(num_dim=10, num_neg=5, learn_rate=0.1, batch_size=8192)
    cases = [
        ("cdae_dense_1x2", "1x2", lambda m: T.ShardedCDAE(
            dataclasses.replace(cdae, dense_mode=True), m), 2),
        ("cdae_sparse_1x2", "1x2", lambda m: T.ShardedCDAE(
            dataclasses.replace(cdae, dense_mode=False), m), 2),
        ("cdae_dense_2x1", "2x1", lambda m: T.ShardedCDAE(
            dataclasses.replace(cdae, dense_mode=True), m), 2),
        ("mftp_imf_1x2", "1x2", lambda m: ShardedMFTP(
            IMF(mf, device=dev), m), 1),
        ("mftp_bpr_1x2", "1x2", lambda m: ShardedMFTP(
            BPR(dataclasses.replace(mf, loss="LOG"), device=dev), m), 1),
        # WARP's picks flip where a score sits on its threshold, so an
        # epoch drifts from any other order of sums: one step (a one-batch
        # epoch) is held to the tables' limit, the epoch to R@10's
        ("pairwise_warp_step_2x1", "2x1", lambda m: T.ShardedPairwise(
            WARP(_warp_cfg(use_pallas=True), device=dev), m), 1),
        ("pairwise_warp_2x1", "2x1", lambda m: T.ShardedPairwise(
            WARP(_warp_cfg(use_pallas=True), device=dev), m), 1),
        ("negmf_2x1", "2x1", lambda m: T.ShardedNegMF(NegMF(
            FactorModelConfig(num_dim=10, num_neg=5, loss="LOG",
                              batch_size=4096), device=dev), m), 1),
        ("imf_slab_1x2", "1x2", lambda m: T.ShardedIMF(
            dataclasses.replace(mf, fast_rng=True), m), 1),
        ("fism_1x2", "1x2", lambda m: T.ShardedFISM(FISMConfig(
            num_dim=10, num_neg=5, loss="SQUARE", learn_rate=0.1,
            batch_size=128), m), 1),
        ("als_2x1", "2x1", lambda m: T.ShardedALS(
            ALSConfig(num_dim=10, lambda_=0.01), m), 1),
        ("wrmf_2x1", "2x1", lambda m: T.ShardedWRMF(
            ALSConfig(num_dim=10, lambda_=0.01, scalar=40.0), m), 1),
    ]
    res, ok = {}, True
    for name in P.__dict__:
        fn = getattr(P, name)
        if hasattr(fn, "launches"):
            fn.launches = 0
    counted = [n for n in KERNELS if hasattr(getattr(P, n, None), "launches")]
    not_sharded = dict.fromkeys(counted, 0)  # launches of the references

    def mem():  # (bytes allocated now, peak since the last reset)
        if dev.type != "cuda":
            return 0, 0
        return torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()

    def reset_peak():
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
    # the first 8,192 training interactions: one WARP batch, one step
    one_batch = type(train).from_arrays(
        train.users[:8192], train.items[:8192], train.ratings[:8192],
        train.num_users, train.num_items)
    for name, mesh, make, epochs in cases:
        model = make(meshes[mesh])
        data_c = one_batch if name == "pairwise_warp_step_2x1" else train
        reset_peak()
        base = mem()[0]
        st = model.reset(data_c, seed=SEED)
        for _ in range(epochs):
            model.train_one_iteration(st, SEED)
        _sync(torch, dev)
        peak = mem()[1] - base
        whole = model.gathered(st).params
        row = dict(mesh=mesh, model=type(model).__name__, epochs=epochs)
        if name in WITNESS_CASES:
            blk = st.aux["dense_R_block"]
            row.update(dense_R_block_shape=list(blk.shape),
                       dense_R_whole_on_rank="dense_R" in st.aux,
                       peak_bytes_this_rank=peak)
        if name == "cdae_dense_1x2":  # warm users/s of a third epoch
            t0 = time.perf_counter()
            model.train_one_iteration(st, SEED)
            _sync(torch, dev)
            row["warm_users_per_s_host_staged"] = U / (
                time.perf_counter() - t0)
            whole = model.gathered(st).params
            epochs += 1
        lists = None
        if name in ("cdae_sparse_1x2", "mftp_bpr_1x2"):
            lists = [model.batch_topk(st, u, r, m, 10)
                     for u, r, m, *_ in batches]
        r10 = None
        if name == "pairwise_warp_2x1":
            r10 = RecListEvaluation("TOPN").evaluate(model, st, test,
                                                     train)["R@10"]
        before = {n: getattr(P, n).launches for n in counted}
        if rank == 0:
            reset_peak()
            base = mem()[0]
            single = type(model.inner)(model.inner.cfg, device=dev)
            ss = single.reset(data_c, seed=SEED)
            init = {k: v.to("cpu", copy=True) for k, v in ss.params.items()}
            for _ in range(epochs):
                single.train_one_iteration(ss, SEED)
            _sync(torch, dev)
            if name in WITNESS_CASES:
                row["peak_bytes_single"] = mem()[1] - base
                # the card's config (B1's hash draws) and initial tables
                cpu = type(model.inner)(model.inner.cfg, device="cpu")
                cs = cpu.reset(data_c, seed=SEED)
                cs.params = init
                for _ in range(epochs):
                    cpu.train_one_iteration(cs, SEED)
                row["witness_cpu_vs_card"] = _within(
                    torch, {k: v.to(dev) for k, v in cs.params.items()},
                    ss.params)
            row.update(_within(torch, whole, ss.params))
            if r10 is not None:  # the epoch: R@10 within 0.005
                r10_1 = RecListEvaluation("TOPN").evaluate(
                    single, ss, test, train)["R@10"]
                row.update(recall_at_10=r10, recall_at_10_single=r10_1,
                           within=abs(r10 - r10_1) <= 0.005)
            if lists is not None:
                row["lists"] = _lists_vs_topn(
                    torch, lists, batches,
                    lambda u, r, m: single.batch_scores(ss, u, r, m))
                row["within"] = (row["within"]
                                 and row["lists"]["rows_differ"] == 0)
            ok &= row["within"]
        for n in counted:
            not_sharded[n] += getattr(P, n).launches - before[n]
        res[name] = row
    # a sharded checkpoint after epoch 1 resumes bit for bit
    model = T.ShardedCDAE(dataclasses.replace(cdae, dense_mode=True),
                          meshes["1x2"])
    st = model.reset(train, seed=SEED)
    fp = ckpt.config_fingerprint(model, st)
    path = os.path.join(os.path.dirname(rdv), "sharded.ckpt")
    model.train_one_iteration(st, SEED)
    ckpt.save_sharded(path, st, fingerprint=fp)
    model.train_one_iteration(st, SEED)
    a = model.gathered(st).params
    fresh = model.reset(train, seed=SEED + 1)
    ckpt.load_sharded(path, fresh, expect_fingerprint=fp)
    model.train_one_iteration(fresh, SEED)
    b = model.gathered(fresh).params
    resumed = all(torch.equal(a[k], b[k]) for k in a)
    res["checkpoint"] = dict(mesh="1x2", resumed_bitwise=resumed,
                             manifest=sorted(ckpt.sharded_manifest(path)))
    ok &= resumed
    with open(f"{out}.{rank}", "w") as f:  # its sharded runs' launches
        json.dump({n: getattr(P, n).launches - not_sharded[n]
                   for n in counted}, f)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(dict(cases=res, ok=bool(ok)), f)
    meshes["1x2"].barrier()
    shutdown()
    return 0


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
    run("kernel_csr_rows", lambda: phase_kernel_csr_rows(torch, results))
    run("serve_recommend_1m", lambda: phase_serve_recommend_1m(torch))

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
    if "ml1m_data" in held:
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts("sparse_training")
            run("train_sparse_ml1m",
                lambda: phase_train_sparse_ml1m(torch, tmp, held))
            run("train_sparse_ml20m",
                lambda: phase_train_sparse_ml20m(torch, held))
            run("train_sparse_1m", lambda: phase_train_sparse_1m(torch))
            read_counts("sparse_training", launches, failed)
    if "sparse_ml1m" in held:
        run("sparse_ml1m_checks",
            lambda: phase_sparse_ml1m_checks(torch, held))
    else:
        failed.append("sparse CDAE phases (no sparse run to build on)")
    if "ml1m" in held:
        t_mf = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts("mf_training")
            run("train_imf", lambda: phase_train_imf(torch, tmp, held))
            run("train_imf_sparse",
                lambda: phase_train_imf_sparse(torch, tmp, held))
            run("train_pmf", lambda: phase_train_pmf(torch, tmp, held))
            run("train_bpr", lambda: phase_train_bpr(torch, tmp, held))
            run("train_warp_routes",
                lambda: phase_train_warp_routes(torch, held))
            if "imf_sparse" in held:
                run("train_imf_mxu", lambda: phase_train_imf_mxu(torch, held))
            read_counts("mf_training", launches, failed)
        if all(key in held for _, key in SPEED_MF) and all(
                key in held for key in MF_CHECKS):
            run("mf_checks", lambda: phase_mf_checks(torch, held))
            run("train_speed_mf", lambda: phase_train_speed_mf(torch, held))
        else:
            failed.append("MF checks (a training run to build on failed)")
        emit(dict(phase="mf_wall", seconds=time.perf_counter() - t_mf))
    else:
        failed.append("MF phases (no ML-1M run to build on)")
    if "ml1m" in held:
        t_zoo = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            run("train_als", lambda: phase_train_als(torch, tmp, held))
            run("train_wrmf", lambda: phase_train_wrmf(torch, tmp, held))
            reset_counts("cf_serving")
            run("serve_itemcf", lambda: phase_serve_itemcf(torch, tmp, held))
            run("serve_usercf", lambda: phase_serve_usercf(torch, tmp, held))
            read_counts("cf_serving", launches, failed)
        if all(key in held for key in ("als", "wrmf", "itemcf", "usercf")):
            run("cf_checks", lambda: phase_cf_checks(torch, held, results))
            run("zoo_speed", lambda: phase_zoo_speed(torch, held))
        else:
            failed.append("zoo checks (a run to build on failed)")
        emit(dict(phase="zoo_wall", seconds=time.perf_counter() - t_zoo))
    else:
        failed.append("zoo phases (no ML-1M run to build on)")
    if "ml1m" in held:
        t_lin = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts("linear_training")
            run("train_negmf", lambda: phase_train_negmf(torch, tmp, held))
            run("train_negmf_dense",
                lambda: phase_train_negmf_dense(torch, tmp, held))
            run("train_linear",
                lambda: phase_train_linear(torch, tmp, held, "LINEAR"))
            run("train_fm", lambda: phase_train_linear(torch, tmp, held,
                                                       "FM"))
            read_counts("linear_training", launches, failed)
        if all(key in held for key in FEATURE_KEYS):
            run("linear_checks",
                lambda: phase_linear_checks(torch, held, results))
            run("linear_speed", lambda: phase_linear_speed(torch, held))
        else:
            failed.append("feature-group checks (a run to build on failed)")
        emit(dict(phase="linear_wall", seconds=time.perf_counter() - t_lin))
    else:
        failed.append("feature-group phases (no ML-1M run to build on)")
    if "ml1m" in held and "imf_sparse" in held:
        t_left = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts("leftovers")
            run("native_loader",
                lambda: phase_native_loader(torch, tmp, held))
            run("recommend", lambda: phase_recommend(torch, held))
            run("sweep", lambda: phase_sweep(torch, tmp, repo))
            read_counts("leftovers", launches, failed)
        emit(dict(phase="leftovers_wall",
                  seconds=time.perf_counter() - t_left))
    else:
        failed.append("leftover phases (no ML-1M CDAE or IMF run to build "
                      "on)")
    if "ml1m" in held:
        t_sh = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts("sharded")
            row = run("sharded_nccl",
                      lambda: phase_sharded_nccl(torch, tmp, held))
            # the sharded runs' own launches, not their single-card twins'
            read_counts("sharded", launches, failed,
                        (row or {}).get("launches_sharded_runs", {}))
            run("sharded_gloo",
                lambda: phase_sharded_gloo(torch, tmp, held, repo))
        emit(dict(phase="sharded_wall", seconds=time.perf_counter() - t_sh))
    else:
        failed.append("sharded phases (no ML-1M run to build on)")
    emit(dict(phase="wall", seconds=time.perf_counter() - t_start))

    table = []
    for name, (_, source, replaces, paths) in KERNELS.items():
        r = results.get(name, {})
        by_path = launches.get(name, {})
        dev_ms = r.get("device_ms")  # B8's is a dict: its span's
        table.append(dict(name=name, route="cuda", source=source,
                          replaces=replaces,
                          launches=sum(by_path.get(p, 0) for p in paths),
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
            table[-1]["shapes"] = [shape_summary(row, by_path)
                                   for row in shapes]
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
    if sys.argv[1:2] == ["--sharded-rank"]:  # a rank of sharded_gloo
        sys.exit(sharded_rank(int(sys.argv[2]), int(sys.argv[3]),
                              *sys.argv[4:8]))
    sys.exit(main())

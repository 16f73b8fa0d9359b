#!/usr/bin/env python3
"""Drive cdae_tpu_torch once on one CUDA GPU and check what comes out.

Phases, each printed as one JSON line:
  build   -- compile the CUDA kernels from cdae_tpu_torch/csrc (nvcc, one
             process per source, in parallel)
  kernel  -- each kernel against its plain PyTorch version on the card, at
             the shapes its path gives it; error and median times
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
Then the kernel table (each kernel's launches from the path that owns it),
the card's name and power limit, and, last, the ok line. Any failed phase
makes the exit code 1 and leaves out the ok line. Without a CUDA GPU, or
without the repository beside it, the script exits 2 and prints no result.

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

# name -> (module of the wrapper, source, TPU kernel it replaces, path)
KERNELS = {
    "decode_scores": ("pallas_kernels", "cdae_tpu_torch/csrc/decode_scores.cu",
                      "cdae_tpu/ops/pallas_kernels.py:53", "serving"),
    "fused_topk_scores": ("pallas_kernels",
                          "cdae_tpu_torch/csrc/fused_topk.cu",
                          "cdae_tpu/ops/pallas_kernels.py:557", "serving"),
    "fused_topk_scores_csr": ("pallas_kernels",
                              "cdae_tpu_torch/csrc/fused_topk.cu",
                              "cdae_tpu/ops/pallas_kernels.py:641",
                              "serving"),
    "hw_uniform": ("pallas_kernels", "cdae_tpu_torch/csrc/hw_uniform.cu",
                   "cdae_tpu/ops/pallas_kernels.py:178", "training"),
    "adagrad_update": ("pallas_kernels",
                       "cdae_tpu_torch/csrc/adagrad_update.cu",
                       "cdae_tpu/ops/pallas_kernels.py:108", "training"),
    "cdae_dense_step_fused": ("cdae_fused", "cdae_tpu_torch/csrc/cdae_fused.cu",
                              "cdae_tpu/ops/cdae_fused.py:249",
                              "fused_training"),
}


def wrapper(name):
    """The wrapper function of a kernel (it carries ``.launches``)."""
    import importlib

    module = importlib.import_module(f"cdae_tpu_torch.ops.{KERNELS[name][0]}")
    return getattr(module, name)


def reset_counts(path: str) -> None:
    for name, spec in KERNELS.items():
        if spec[3] == path:
            wrapper(name).launches = 0


def read_counts(path: str, launches: dict, failed: list) -> None:
    """Record the launch counts of ``path``'s kernels; a kernel of the path
    that never launched fails the run."""
    for name, spec in KERNELS.items():
        if spec[3] != path:
            continue
        launches[name] = wrapper(name).launches
        if launches[name] == 0:
            emit(dict(phase="launches", path=path, kernel=name, ok=False,
                      error="the main path never launched this kernel"))
            failed.append(f"launches:{name}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
                   plain_ms=median_ms(lambda: P.decode_scores_plain(z, W, bp)))
        emit(row)
        if err > TOL:
            raise AssertionError(f"decode_scores error {err} > {TOL}")
        results.setdefault("decode_scores", row)

    k = 10
    D = 50
    # B5 fused_topk_scores: random int8 rated rows (1% rated)
    B, I = 256, 1_000_000
    z = torch.rand(B, D, generator=g, device=dev)
    W, bp = normal(I, D, scale=0.1), normal(I, scale=0.1)
    rows = (torch.rand(B, I, generator=g, device=dev) < 0.01).to(torch.int8)
    _check_topk(torch, results, "fused_topk_scores", B, I, D, k,
                lambda kk: P.fused_topk_scores(z, W, bp, rows, k=kk),
                lambda kk: P.fused_topk_scores_plain(z, W, bp, rows, k=kk))
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
                                                         k=kk))


def _check_topk(torch, results, name, B, I, D, k, kernel, plain):
    ids, vals = kernel(k)
    plain_ids, plain_vals = plain(k + 1)
    torch.cuda.synchronize()
    err, checked, other = topk_agreement(ids, vals, plain_ids, plain_vals, k)
    row = dict(phase="kernel", kernel=name, B=B, I=I, D=D, k=k,
               max_abs_err=err, tol=TOL, rows_checked=checked,
               rows_with_other_ids=other,
               ms=median_ms(lambda: kernel(k), reps=3),
               plain_ms=median_ms(lambda: plain(k), reps=3))
    emit(row)
    if err > TOL or other:
        raise AssertionError(f"{name}: max_abs_err {err}, {other} rows with "
                             "other ids")
    results[name] = row


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
                   plain_ms=median_ms(lambda: P.hw_uniform_plain(
                       SEED, shape, 1, device=dev)))
        emit(row)
        results.setdefault("hw_uniform", row)
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
        row = dict(phase="kernel", kernel="adagrad_update", shape=list(shape),
                   max_rel_err=rel, tol=1e-6,
                   max_abs_err=max((pk - pp).abs().max().item(),
                                   (ak - ap).abs().max().item()),
                   ms=median_ms(lambda: P.adagrad_update(pw, aw, gr, 0.1,
                                                         1.0)),
                   plain_ms=median_ms(lambda: P.adagrad_update_plain(
                       pw, aw, gr, 0.1, 1.0)))
        emit(row)
        results.setdefault("adagrad_update", row)
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
        args = [t.clone() for t in (W, W_ag, bp, bp_ag)]
        row = dict(phase="kernel", kernel="cdae_dense_step_fused", B=B, I=I,
                   D=D, rtol=FUSED_RTOL, outputs=per,
                   max_abs_err=per["W"]["max_abs_err"], ok=ok,
                   ms=median_ms(lambda: F.cdae_dense_step_fused(
                       SEED, rows, w_user, p_neg, h_bias, *args, **kw)),
                   plain_ms=median_ms(lambda: F.cdae_dense_step_fused_plain(
                       SEED, rows, w_user, p_neg, h_bias, *args, **kw)))
        emit(row)
        results.setdefault("cdae_dense_step_fused", row)
        if not ok:
            bad.append(f"cdae_dense_step_fused {(B, I, D)}")
        del rows, got, want, ref64
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


def main() -> int:
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

    table = []
    for name, (_, source, replaces, _) in KERNELS.items():
        r = results.get(name, {})
        table.append(dict(name=name, route="cuda", source=source,
                          replaces=replaces, launches=launches.get(name, 0),
                          max_abs_err=r.get("max_abs_err"), ms=r.get("ms"),
                          plain_ms=r.get("plain_ms")))
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
    # the script drives one card, whatever the host has
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

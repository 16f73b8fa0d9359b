#!/usr/bin/env python3
"""Drive cdae_tpu_torch once on one CUDA GPU and check what comes out.

Phases, each printed as one JSON line:
  build   -- compile the CUDA kernels from cdae_tpu_torch/csrc (nvcc)
  kernel  -- each kernel against its plain PyTorch version on the card, at
             the shapes the serving path gives it; error and median times
  slice   -- ML-1M-scale CDAE serving at D=50 through the CLI --task test
             (dense_R encode + decode kernel + TOPN), checked against the
             plain path on the same checkpoint
  csr_1m  -- 20,000 users x 1,000,000 items through the TOPN evaluator:
             no dense_R, so the fused CSR top-k kernel serves
  dense_1m-- 1,000 users x 1,000,000 items, batch_size 64 so the 1 GB int8
             dense_R stays resident: the fused dense top-k kernel serves
  verify  -- one batch of each 1M-item run: kernel ids against the plain
             streaming scan
Then the kernel table (launch counts from the slice/csr_1m/dense_1m run),
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

KERNELS = {
    "decode_scores": ("cdae_tpu_torch/csrc/decode_scores.cu",
                      "cdae_tpu/ops/pallas_kernels.py:53"),
    "fused_topk_scores": ("cdae_tpu_torch/csrc/fused_topk.cu",
                          "cdae_tpu/ops/pallas_kernels.py:557"),
    "fused_topk_scores_csr": ("cdae_tpu_torch/csrc/fused_topk.cu",
                              "cdae_tpu/ops/pallas_kernels.py:641"),
}


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

    # the main path: every count starts at 0 here and is read after it
    for name in KERNELS:
        getattr(P, name).launches = 0
    held, n_users = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        run("slice", lambda: phase_slice(torch, tmp, n_users))
    run("csr_1m", lambda: phase_1m(torch, "csr_1m", 20_000, 1024, False,
                                   held))
    run("dense_1m", lambda: phase_1m(torch, "dense_1m", 1_000, 64, True,
                                     held))
    launches = {name: getattr(P, name).launches for name in KERNELS}
    for name, n in launches.items():
        if n == 0:
            emit(dict(phase="launches", kernel=name, ok=False,
                      error="the main path never launched this kernel"))
            failed.append(f"launches:{name}")
    run("verify", lambda: phase_verify(torch, held))

    table = []
    for name, (source, replaces) in KERNELS.items():
        r = results.get(name, {})
        table.append(dict(name=name, route="cuda", source=source,
                          replaces=replaces, launches=launches[name],
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
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

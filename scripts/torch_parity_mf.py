#!/usr/bin/env python3
"""Metric parity of cdae_tpu_torch's MF family against the C++ oracle
(csrc/baseline_cdae.cpp: ``parity_mf`` for IMF/BPR/WARP, ``parity_pmf``
for PMF), on scripts/parity_zoo.py's protocol, from several seeds.

Per seed: low-rank data (1200 users x 600 items, degree 30; rated 1-5 for
PMF), the per-user 0.2 split, both sides trained the same number of epochs
(20, D=10, num_neg 5, lr 0.1, batch 64) from that seed, then test recall@10
(TOPN) or RMSE (PMF). Cells, as in parity_zoo.py:

  MF          IMF, SQUARE, beta 1, lambda 0.01 (the reference's MF)
  PMF         PMF on ratings, the instance epoch (dense_mode False)
  PMF_DENSE   PMF's user slab at 2x lr (the slab's equal-epoch protocol)
  BPR         BPR, LOG, the sparse step
  BPR_DENSE   BPR's user slab at 2x lr
  WARP        WARP, HINGE, beta 0, lambda 0.1, its dense path
  WARP_DENSE  WARP's user slab, 3x lr, a 1024-id violator pool

Gate, per cell on the mean over the seeds: recall@10 no more than
``--tolerance`` (0.03) below the oracle's, RMSE no more than 0.03 above it.
Every seed's numbers are printed too. The script imports nothing of
cdae_tpu; ``--device`` is cuda (the kernels) or cpu (their plain versions).
It prints one JSON object (with the device's name) and exits 0 when every
cell passes, 1 otherwise.

    python3 scripts/torch_parity_mf.py --device cuda --seeds 20141119 7 11
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CELLS = ("MF", "PMF", "PMF_DENSE", "BPR", "BPR_DENSE", "WARP", "WARP_DENSE")


def build_oracle(workdir: str) -> str:
    exe = os.path.join(workdir, "baseline_cdae")
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-o", exe,
                    os.path.join(REPO, "csrc", "baseline_cdae.cpp")],
                   check=True)
    return exe


def oracle(exe: str, args: list) -> dict:
    out = subprocess.run([exe] + [str(a) for a in args], check=True,
                         capture_output=True, text=True).stdout
    return json.loads(out)


def port_model(cell: str, args):
    """The port's model with the hyperparameters the oracle hardcodes for
    the cell (parity_zoo.py's ``build`` and ``pmf_cell``)."""
    from cdae_tpu_torch.models.mf import BPR, IMF, PMF, WARP, MFConfig

    kw = dict(learn_rate=args.lr, num_dim=args.dim, num_neg=args.num_neg,
              batch_size=args.batch, fast_rng=args.fast_rng or None)
    if cell == "MF":
        return IMF(MFConfig(loss="SQUARE", beta=1.0, lambda_=0.01, **kw),
                   device=args.device)
    if cell.startswith("PMF"):
        dense = cell == "PMF_DENSE"
        kw["learn_rate"] = args.lr * (2 if dense else 1)
        return PMF(MFConfig(loss="SQUARE", beta=1.0, lambda_=0.01,
                            dense_mode=dense, **kw), device=args.device)
    if cell.startswith("BPR"):
        dense = cell == "BPR_DENSE"
        kw["learn_rate"] = args.lr * (2 if dense else 1)
        return BPR(MFConfig(loss="LOG", beta=1.0, lambda_=0.01,
                            dense_mode=dense or None, **kw),
                   device=args.device)
    dense = cell == "WARP_DENSE"
    if dense:
        kw["learn_rate"] = args.lr * args.warp_dense_mult
    return WARP(MFConfig(loss="HINGE", beta=0.0, lambda_=0.1,
                         dense_mode=dense or None,
                         warp_pool=args.warp_pool_size if dense else None,
                         **kw), device=args.device)


def run_seed(exe: str, workdir: str, seed: int, cells, args) -> dict:
    from cdae_tpu_torch.data.synthetic import (lowrank_interactions,
                                               lowrank_rated, write_pairs,
                                               write_triples)
    from cdae_tpu_torch.evaluation import Evaluation

    data = {}
    for rated in (False, True):
        make = lowrank_rated if rated else lowrank_interactions
        train, test = make(args.users, args.items, args.degree,
                           seed=seed).split_by_user(0.2, seed=seed)
        write = write_triples if rated else write_pairs
        paths = []
        for part, d in (("train", train), ("test", test)):
            path = os.path.join(workdir, f"{part}_{int(rated)}_{seed}.txt")
            write(path, d)
            paths.append(path)
        data[rated] = (train, test, paths)
    out = {}
    for cell in cells:
        rated = cell.startswith("PMF")
        train, test, (tr_path, te_path) = data[rated]
        if rated:
            cpp = oracle(exe, ["parity_pmf", tr_path, te_path, args.iters,
                               args.dim, args.lr])
            want, col = cpp["rmse"], "RMSE"
        else:
            method = cell.split("_")[0]
            cpp = oracle(exe, ["parity_mf", method, tr_path, te_path,
                               args.iters, args.dim, args.num_neg, args.lr])
            want, col = cpp["recall_at_10"], "R@10"
        model = port_model(cell, args)
        state = model.reset(train, seed=seed)
        for _ in range(args.iters):
            model.train_one_iteration(state, seed)
        got = Evaluation.create("RMSE" if rated else "TOPN").evaluate(
            model, state, test, train)[col]
        out[cell] = dict(metric=col, oracle=want, port=got,
                         delta=got - want,
                         slab="dense_R" in state.aux)
        print(f"# seed {seed} {cell}: port {col}={got:.5f} oracle "
              f"{want:.5f}", file=sys.stderr, flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[20141119, 7, 11])
    ap.add_argument("--cells", nargs="+", default=list(CELLS))
    ap.add_argument("--users", type=int, default=1200)
    ap.add_argument("--items", type=int, default=600)
    ap.add_argument("--degree", type=int, default=30)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--num_neg", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--tolerance", type=float, default=0.03)
    ap.add_argument("--warp_dense_mult", type=float, default=3.0)
    ap.add_argument("--warp_pool_size", type=int, default=1024)
    ap.add_argument("--fast_rng", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch

    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("torch_parity_mf: no CUDA GPU", file=sys.stderr)
            return 2
        device_name = torch.cuda.get_device_name(0)
    else:
        device_name = "cpu"
    with tempfile.TemporaryDirectory() as workdir:
        exe = build_oracle(workdir)
        per_seed = {seed: run_seed(exe, workdir, seed, args.cells, args)
                    for seed in args.seeds}
    cells, ok = {}, True
    for cell in args.cells:
        runs = [per_seed[s][cell] for s in args.seeds]
        mean = float(np.mean([r["delta"] for r in runs]))
        rmse = runs[0]["metric"] == "RMSE"  # lower is better
        passed = (mean <= args.tolerance if rmse
                  else mean >= -args.tolerance)
        cells[cell] = dict(metric=runs[0]["metric"], mean_delta=mean,
                           deltas=[r["delta"] for r in runs],
                           port=[r["port"] for r in runs],
                           oracle=[r["oracle"] for r in runs],
                           slab=runs[0]["slab"], parity=bool(passed))
        ok = ok and passed
    print(json.dumps(dict(device=args.device, device_name=device_name,
                          seeds=args.seeds, iters=args.iters,
                          tolerance=args.tolerance, cells=cells, ok=ok)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

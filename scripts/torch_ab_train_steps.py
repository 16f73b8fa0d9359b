#!/usr/bin/env python3
"""Warm training steps of cdae_tpu_torch from two source trees, in turns, on
one CUDA GPU: how a change moves each training cell's step time.

Each tree runs in its own process (its package and its kernel build), in
the order A, B, B, A, ... so that drift on the card and on the host falls on
both. A process makes ML-1M-sized low-rank data (6040 x 3706, 160 ratings a
user, seed 20141119), then per cell one warm-up epoch and ``--epochs``
timed epochs (host clock between synchronizes): CDAE unfused (D=50, batch
1024), WARP's kernel route (D=10, batch 8192), FISM's slab and sparse
routes (D=10, 128 users a batch) -- chip_smoke.py's configurations. It
prints one JSON line per process: ms a step and B2 launches a step.

    python3 scripts/torch_ab_train_steps.py --trees OLD_TREE NEW_TREE

Without a CUDA GPU it exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SEED = 20141119


def worker(tree: str, epochs: int) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import cdae_tpu_torch.ops.pallas_kernels as P
    from cdae_tpu_torch.data.synthetic import lowrank_interactions
    from cdae_tpu_torch.models.cdae import CDAE, CDAEConfig
    from cdae_tpu_torch.models.fism import FISM, FISMConfig
    from cdae_tpu_torch.models.mf import WARP, MFConfig

    train = lowrank_interactions(6040, 3706, 160, seed=SEED).split_by_user(
        0.2, seed=SEED)[0]
    cells = {
        "cdae_unfused": CDAE(CDAEConfig(num_dim=50, corruption_ratio=0.5,
                                        scaled=True, num_neg=5,
                                        loss="SQUARE", batch_size=1024,
                                        beta=1.0), device="cuda"),
        "warp_kernel": WARP(MFConfig(num_dim=10, num_neg=5, loss="HINGE",
                                     beta=0.0, lambda_=0.1, learn_rate=0.1,
                                     batch_size=8192), device="cuda"),
        "fism_slab": FISM(FISMConfig(num_dim=10, num_neg=5, loss="SQUARE",
                                     batch_size=128), device="cuda"),
        "fism_sparse": FISM(FISMConfig(num_dim=10, num_neg=5, loss="SQUARE",
                                       batch_size=128, dense_mode=False),
                            device="cuda"),
    }
    out = dict(tree=tree, epochs=epochs)
    for name, model in cells.items():
        state = model.reset(train, seed=SEED)
        model.train_one_iteration(state, SEED)  # warm-up, builds batches
        torch.cuda.synchronize()
        if name == "warp_kernel":
            steps = -(-len(train) // 8192)
        elif name == "fism_sparse":
            steps = len(state.aux["sparse_batches"])
        else:
            steps = state.aux["dense_batches"][0].shape[0]
        b2 = P.adagrad_update.launches
        t0 = time.perf_counter()
        for _ in range(epochs):
            model.train_one_iteration(state, SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[name] = dict(ms_per_step=wall * 1e3 / (epochs * steps),
                         b2_launches_per_step=(P.adagrad_update.launches
                                               - b2) / (epochs * steps))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--rounds", type=int, default=2,
                    help="A, B, B, A rounds (default 2)")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_ab_train_steps: no CUDA GPU", file=sys.stderr)
        return 2
    if args.worker:
        print(json.dumps(worker(args.worker, args.epochs)), flush=True)
        return 0
    a, b = args.trees
    rc = 0
    for _ in range(args.rounds):
        for tree in (a, b, b, a):
            rc |= subprocess.run([sys.executable, __file__, "--worker", tree,
                                  "--epochs", str(args.epochs)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""CDAE hyperparameter sweep on cdae_tpu_torch -- the reference's qsub grid
on one device (the port's counterpart of scripts/sweep_cdae.py).

Enumerates the WSDM'16 paper grid exactly as the reference sweep script
(ref apps/yelp/cdae.sh:3-36: scale x user_factor x cratio{0..1} x linear x
asym x loss{SQUARE,CE}, lr=0.1, dim=50, num_neg=5, beta=1, seed=20141119),
trains every point sequentially with CDAE's dense step and prints one JSON
line a point. Then, as ``#`` lines, the per-axis marginal means of R@10
beside those of the recorded round-2 sweep (SWEEP_CDAE_r2.jsonl, the same
grid on the default synthetic split; BASELINE.md's table) over the points
that ran, their differences, the best and the worst point, and the wall.

Usage:
  python scripts/torch_sweep_cdae.py --device cuda   # all 192 points
  python scripts/torch_sweep_cdae.py --cache_file data.bin [--limit N]
  python scripts/torch_sweep_cdae.py --device cpu --limit 2 --iters 2
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
RECORD = os.path.join(REPO, "SWEEP_CDAE_r2.jsonl")

# axis name, the grid key, its values in the order BASELINE.md lists them
AXES = (
    ("cratio", "cratio", (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)),
    ("loss", "loss", ("CE", "SQUARE")),
    ("user_factor", "user_factor", (True, False)),
    ("linear hidden", "linear", (True, False)),
    ("asym", "asym", (True, False)),
    ("scaled", "scaled", (True, False)),
)


def _mean(xs):
    return sum(xs) / len(xs) if xs else float("nan")


def axis_means(rows):
    """{axis: {value: mean R@10}} over ``rows``."""
    return {name: {v: _mean([r["R@10"] for r in rows if r[key] == v])
                   for v in values}
            for name, key, values in AXES}


def summary(rows, record, wall_s):
    """The ``#`` lines: per-axis means beside the record's over the same
    grid points, the best and the worst point, the wall."""
    ref = [record[r["grid_index"]] for r in rows
           if r["grid_index"] in record]
    port_m, ref_m = axis_means(rows), axis_means(ref)
    lines = [f"# {len(rows)} points, {len(ref)} in the record; mean R@10 "
             "port / record / delta"]
    for name, _, values in AXES:
        cells = [f"{v}: {port_m[name][v]:.4f} / {ref_m[name][v]:.4f} / "
                 f"{port_m[name][v] - ref_m[name][v]:+.4f}" for v in values]
        lines.append(f"# {name:<13} " + "; ".join(cells))
    deltas = [r["R@10"] - record[r["grid_index"]]["R@10"] for r in rows
              if r["grid_index"] in record]
    best = max(rows, key=lambda r: r["R@10"])
    worst = min(rows, key=lambda r: r["R@10"])
    lines += [
        f"# all points   {_mean([r['R@10'] for r in rows]):.4f} / "
        f"{_mean([r['R@10'] for r in ref]):.4f} / mean delta "
        f"{_mean(deltas):+.4f}",
        f"# best  {json.dumps(best)}",
        f"# worst {json.dumps(worst)}",
        f"# wall {wall_s:.1f} s, {wall_s / max(len(rows), 1):.2f} s a point",
    ]
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache_file", default="")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--users", type=int, default=2000)
    ap.add_argument("--items", type=int, default=800)
    ap.add_argument("--degree", type=int, default=40)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=20141119)
    ap.add_argument("--limit", type=int, default=0,
                    help="run only N grid points from --offset (0 = all)")
    ap.add_argument("--offset", type=int, default=0,
                    help="skip the first N grid points (parallel sharding)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a "
                         "GPU) or cpu")
    args = ap.parse_args()

    from cdae_tpu_torch.data import io as data_io
    from cdae_tpu_torch.models.base import resolve_device
    from cdae_tpu_torch.sweep import run_sweep

    resolve_device(args.device)
    if args.synthetic or not args.cache_file:
        from cdae_tpu_torch.data.synthetic import lowrank_interactions

        data = lowrank_interactions(args.users, args.items, args.degree,
                                    seed=args.seed)
    else:
        data = data_io.load_interactions(args.cache_file)
    train, test = data.split_by_user(0.2, seed=args.seed)
    print(f"# {data} -> train {len(train)} / test {len(test)}",
          file=sys.stderr)
    t0 = time.perf_counter()
    rows = run_sweep(train, test, iters=args.iters,
                     batch_size=args.batch_size, seed=args.seed,
                     limit=args.limit, offset=args.offset,
                     device=args.device)
    wall = time.perf_counter() - t0
    with open(RECORD) as f:
        record = {r["grid_index"]: r for r in map(json.loads, f)}
    for line in summary(rows, record, wall):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

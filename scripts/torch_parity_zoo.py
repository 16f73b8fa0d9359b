#!/usr/bin/env python3
"""Metric parity of cdae_tpu_torch against the C++ oracle
(csrc/baseline_cdae.cpp), from several seeds. One table of cells, each
with the port's model, the oracle's command and its tolerance, run by one
driver; scripts/torch_parity_mf.py runs its MF cells.

The zoo, on scripts/parity_zoo.py's protocol (``ZOO``): per seed, low-rank
data of 1200 users x 600 items, degree 30 (rated 1-5 for PMF), split 0.2 by
user, D=10, 20 iterations, num_neg 5, lr 0.1, batch 64; test recall@10
(RMSE for PMF, LINEAR and FM); gate 0.03 on the mean over the seeds.

  MF          IMF, SQUARE, beta 1, lambda 0.01 (the reference's MF)
  PMF         PMF on ratings, the instance epoch (dense_mode False)
  PMF_DENSE   PMF's user slab at 2x lr (the slab's equal-epoch protocol)
  BPR         BPR, LOG, the sparse step
  BPR_DENSE   BPR's user slab at 2x lr
  WARP        WARP, HINGE, beta 0, lambda 0.1, its dense path
  WARP_DENSE  WARP's user slab, 3x lr, a 1024-id violator pool
  ALS, WRMF   ``parity_als``: lambda 0.01, scalar 40 (WRMF's ridge solve)
  ITEMCF, USERCF, POP
              ``parity_sim``: Jaccard, top-50 neighbours; Popularity
  FISM        SQUARE
  NEGMF       NegMF, LOG, no global mean (``parity_mf NegMF``)
  NEGMF_DENSE NegMF's user slab at 2x lr, against the same oracle
  LINEAR      LinearModel on ratings, SQUARE, lambda 0.01, RMSE
              (``parity_fm LINEAR``, D=5 as the oracle takes it)
  FM          FactorModel on ratings, D=5, batch 16, 60 iterations on
              both sides (``parity_fm FM``)

CDAE's grid, on scripts/parity_cdae.py's protocol (``CDAE``) and its
``GRID``: per seed, 2000 users x 800 items, degree 40, split 0.2, D=50, 30
epochs, batch 64, scaled corruption 0.5, num_neg 5, SQUARE, user factor;
each cell's oracle flags and config overrides as the GRID gives them (the
sparse cells set ``use_pallas: False``); gate 0.02 on the mean. On a CUDA
device the kernels each cell leaves on run (``use_pallas`` and
``fast_rng`` default on there).

A recall@10 cell passes when its mean is no more than its tolerance below
the oracle's, an RMSE cell when no more than it above. The script imports
nothing of cdae_tpu (``GRID`` comes from scripts/parity_cdae.py, whose
module level imports none of it). ``--device`` is cuda (the kernels) or
cpu (their plain versions). It prints one JSON line per cell and seed on
stderr, then one JSON object with every seed's delta and each cell's mean,
and exits 0 when every cell passes on its mean, 1 otherwise.

    python3 scripts/torch_parity_zoo.py --device cuda
    python3 scripts/torch_parity_zoo.py --device cpu --seeds 20141119 \
        --cells ALS CDAE:base
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import parity_cdae  # noqa: E402  (GRID; no cdae_tpu import)

SEEDS = [20141119, 7, 11]
# scripts/parity_zoo.py's protocol
ZOO = dict(users=1200, items=600, degree=30, iters=20, dim=10, num_neg=5,
           lr=0.1, batch=64)
# scripts/parity_cdae.py's protocol
CDAE = dict(users=2000, items=800, degree=40, iters=30, dim=50, num_neg=5,
            lr=0.1, cratio=0.5)
ALS_LAMBDA, ALS_SCALAR, SIM_TOPK = 0.01, 40.0, 50
# parity_zoo.py's fm_cell: D=5, lambda 0.01; FM at batch <= 16 and 60
# iterations
FM_DIM, FM_LAMBDA, FM_BATCH, FM_ITERS = 5, 0.01, 16, 60


@dataclasses.dataclass(frozen=True)
class Cell:
    """``model(device)`` is the port's model with the oracle's
    hyperparameters; ``oracle`` the oracle's arguments after the train and
    test paths' mode; ``data`` the split ("zoo", "rated" or "cdae")."""

    model: Callable
    oracle: Callable
    data: str = "zoo"
    tolerance: float = 0.03
    iters: int = ZOO["iters"]

    @property
    def metric(self) -> str:
        return "RMSE" if self.data == "rated" else "R@10"


def _mf(cls_name, loss, beta, lam, lr_mult=1.0, dense=None, pool=None):
    def make(device):
        from cdae_tpu_torch.models import mf

        return getattr(mf, cls_name)(mf.MFConfig(
            loss=loss, beta=beta, lambda_=lam, dense_mode=dense,
            warp_pool=pool, learn_rate=ZOO["lr"] * lr_mult,
            num_dim=ZOO["dim"], num_neg=ZOO["num_neg"],
            batch_size=ZOO["batch"]), device=device)
    return make


def _als(name):
    def make(device):
        from cdae_tpu_torch import models as M

        return getattr(M, name)(M.ALSConfig(num_dim=ZOO["dim"],
                                            lambda_=ALS_LAMBDA,
                                            scalar=ALS_SCALAR), device=device)
    return make


def _sim(name):
    def make(device):
        from cdae_tpu_torch import models as M

        if name == "POP":
            return M.Popularity(device=device)
        cls = M.ItemCF if name == "ITEMCF" else M.UserCF
        return cls(M.SimilarityConfig(sim_type="JACCARD", topk=SIM_TOPK),
                   device=device)
    return make


def _fism(device):
    from cdae_tpu_torch import models as M

    return M.FISM(M.FISMConfig(learn_rate=ZOO["lr"], num_dim=ZOO["dim"],
                               num_neg=ZOO["num_neg"],
                               batch_size=ZOO["batch"], loss="SQUARE"),
                  device=device)


def _negmf(lr_mult=1.0, dense=None):
    def make(device):
        from cdae_tpu_torch import models as M

        return M.NegMF(M.FactorModelConfig(
            learn_rate=ZOO["lr"] * lr_mult, num_dim=ZOO["dim"],
            num_neg=ZOO["num_neg"], batch_size=ZOO["batch"], loss="LOG",
            using_global_mean=False, dense_mode=dense), device=device)
    return make


def _linear(name):
    def make(device):
        from cdae_tpu_torch import models as M

        kw = dict(loss="SQUARE", lambda_=FM_LAMBDA, learn_rate=ZOO["lr"],
                  batch_size=ZOO["batch"], using_global_mean=True,
                  using_adagrad=True)
        if name == "LINEAR":
            return M.LinearModel(M.LinearModelConfig(**kw), device=device)
        kw["batch_size"] = min(ZOO["batch"], FM_BATCH)
        return M.FactorModel(M.FactorModelConfig(num_dim=FM_DIM, **kw),
                             device=device)
    return make


def _cdae(overrides):
    """parity_cdae.py's ``tpu_run`` configuration in the port."""
    def make(device):
        from cdae_tpu_torch.models.cdae import CDAE as Model, CDAEConfig

        cfg = dict(num_dim=CDAE["dim"], learn_rate=CDAE["lr"], lambda_=0.01,
                   loss="SQUARE", corruption_ratio=CDAE["cratio"],
                   scaled=True, num_neg=CDAE["num_neg"], user_factor=True,
                   batch_size=64)
        cfg.update(overrides)
        return Model(CDAEConfig(**cfg), device=device)
    return make


def _zoo_argv(mode, method=None, iters=ZOO["iters"]):
    """The oracle's trailing arguments for a zoo mode."""
    head = [mode] + ([method] if method else [])
    if mode == "parity_fm":
        return lambda tr, te: head + [tr, te, iters, FM_DIM, ZOO["lr"],
                                      FM_LAMBDA]
    if mode == "parity_sim":
        return lambda tr, te: head + [tr, te, SIM_TOPK]
    if mode == "parity_als":
        return lambda tr, te: head + [tr, te, ZOO["iters"], ZOO["dim"],
                                      ALS_LAMBDA, ALS_SCALAR]
    if mode == "parity_pmf":
        return lambda tr, te: head + [tr, te, ZOO["iters"], ZOO["dim"],
                                      ZOO["lr"]]
    return lambda tr, te: head + [tr, te, ZOO["iters"], ZOO["dim"],
                                  ZOO["num_neg"], ZOO["lr"]]


def _grid_argv(flags, overrides):
    cratio = overrides.get("corruption_ratio", CDAE["cratio"])
    return lambda tr, te: (["parity", tr, te, CDAE["iters"], CDAE["dim"],
                            cratio, CDAE["num_neg"], CDAE["lr"]] + flags)


CELLS = {
    "MF": Cell(_mf("IMF", "SQUARE", 1.0, 0.01),
               _zoo_argv("parity_mf", "MF")),
    "PMF": Cell(_mf("PMF", "SQUARE", 1.0, 0.01, dense=False),
                _zoo_argv("parity_pmf"), data="rated"),
    "PMF_DENSE": Cell(_mf("PMF", "SQUARE", 1.0, 0.01, 2.0, dense=True),
                      _zoo_argv("parity_pmf"), data="rated"),
    "BPR": Cell(_mf("BPR", "LOG", 1.0, 0.01),
                _zoo_argv("parity_mf", "BPR")),
    "BPR_DENSE": Cell(_mf("BPR", "LOG", 1.0, 0.01, 2.0, dense=True),
                      _zoo_argv("parity_mf", "BPR")),
    "WARP": Cell(_mf("WARP", "HINGE", 0.0, 0.1),
                 _zoo_argv("parity_mf", "WARP")),
    "WARP_DENSE": Cell(_mf("WARP", "HINGE", 0.0, 0.1, 3.0, dense=True,
                           pool=1024), _zoo_argv("parity_mf", "WARP")),
    "ALS": Cell(_als("ALS"), _zoo_argv("parity_als", "ALS")),
    "WRMF": Cell(_als("WRMF"), _zoo_argv("parity_als", "WRMF")),
    "ITEMCF": Cell(_sim("ITEMCF"), _zoo_argv("parity_sim", "ITEMCF"),
                   iters=1),
    "USERCF": Cell(_sim("USERCF"), _zoo_argv("parity_sim", "USERCF"),
                   iters=1),
    "POP": Cell(_sim("POP"), _zoo_argv("parity_sim", "POP"), iters=1),
    "FISM": Cell(_fism, _zoo_argv("parity_mf", "FISM")),
    "NEGMF": Cell(_negmf(), _zoo_argv("parity_mf", "NegMF")),
    "NEGMF_DENSE": Cell(_negmf(2.0, dense=True),
                        _zoo_argv("parity_mf", "NegMF")),
    "LINEAR": Cell(_linear("LINEAR"), _zoo_argv("parity_fm", "LINEAR"),
                   data="rated"),
    "FM": Cell(_linear("FM"), _zoo_argv("parity_fm", "FM", FM_ITERS),
               data="rated", iters=FM_ITERS),
    **{f"CDAE:{name}": Cell(_cdae(overrides), _grid_argv(flags, overrides),
                            data="cdae", tolerance=0.02, iters=CDAE["iters"])
       for name, flags, overrides in parity_cdae.GRID},
}
MF_CELLS = ["MF", "PMF", "PMF_DENSE", "BPR", "BPR_DENSE", "WARP",
            "WARP_DENSE"]
REST_CELLS = [c for c in CELLS if c not in MF_CELLS]


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


def _split(kind: str, seed: int, workdir: str):
    """The seed's split of one kind, and its train and test files."""
    from cdae_tpu_torch.data import synthetic as S

    proto = CDAE if kind == "cdae" else ZOO
    make = S.lowrank_rated if kind == "rated" else S.lowrank_interactions
    train, test = make(proto["users"], proto["items"], proto["degree"],
                       seed=seed).split_by_user(0.2, seed=seed)
    write = S.write_triples if kind == "rated" else S.write_pairs
    paths = []
    for part, d in (("train", train), ("test", test)):
        path = os.path.join(workdir, f"{kind}_{part}_{seed}.txt")
        write(path, d)
        paths.append(path)
    return train, test, paths


def run_cell(exe: str, name: str, split, seed: int, device: str) -> dict:
    from cdae_tpu_torch.evaluation import Evaluation

    cell = CELLS[name]
    train, test, (tr, te) = split
    want = oracle(exe, cell.oracle(tr, te))
    t0 = time.perf_counter()
    model = cell.model(device)
    state = model.reset(train, seed=seed)
    rmse = cell.metric == "RMSE"
    ev = Evaluation.create("RMSE" if rmse else "TOPN")
    start = ev.evaluate(model, state, test, train)[cell.metric]
    if cell.data == "cdae":
        state = model.train_epochs(state, cell.iters, seed)
    else:
        for _ in range(cell.iters):
            state = model.train_one_iteration(state, seed)
    got = ev.evaluate(model, state, test, train)
    key = "rmse" if rmse else "recall_at_10"
    out = dict(oracle=want[key], port_start=start, port=got[cell.metric],
               delta=got[cell.metric] - want[key],
               dense="dense_R" in state.aux,
               port_seconds=time.perf_counter() - t0)
    if not rmse:
        out.update(oracle_map=want["map_at_10"], port_map=got["MAP@10"])
    cfg = getattr(model, "cfg", None)
    if hasattr(cfg, "use_pallas"):
        out["use_pallas"] = cfg.use_pallas
    return out


def main(default_cells=REST_CELLS) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=SEEDS)
    ap.add_argument("--cells", nargs="+", default=list(default_cells),
                    choices=list(CELLS), metavar="CELL")
    args = ap.parse_args()
    import numpy as np
    import torch

    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            print(f"{os.path.basename(sys.argv[0])}: no CUDA GPU",
                  file=sys.stderr)
            return 2
        device_name = torch.cuda.get_device_name(0)
    else:
        device_name = "cpu"
    t0 = time.perf_counter()
    per_seed = {}
    with tempfile.TemporaryDirectory() as workdir:
        exe = build_oracle(workdir)
        for seed in args.seeds:
            splits = {}
            for name in args.cells:
                kind = CELLS[name].data
                if kind not in splits:
                    splits[kind] = _split(kind, seed, workdir)
                per_seed[seed, name] = run = run_cell(
                    exe, name, splits[kind], seed, args.device)
                print(json.dumps(dict(seed=seed, cell=name, **run)),
                      file=sys.stderr, flush=True)
    cells, ok = {}, True
    for name in args.cells:
        cell = CELLS[name]
        runs = [per_seed[s, name] for s in args.seeds]
        mean = float(np.mean([r["delta"] for r in runs]))
        passed = (mean <= cell.tolerance if cell.metric == "RMSE"
                  else mean >= -cell.tolerance)
        cells[name] = dict(metric=cell.metric, mean_delta=mean,
                           tolerance=cell.tolerance,
                           deltas=[r["delta"] for r in runs],
                           **{k: [r[k] for r in runs] for k in
                              ("port_start", "port", "oracle", "port_map",
                               "oracle_map", "port_seconds")
                              if k in runs[0]},
                           **{k: runs[0][k] for k in ("dense", "use_pallas")
                              if k in runs[0]},
                           parity=bool(passed))
        ok = ok and passed
    print(json.dumps(dict(device=args.device, device_name=device_name,
                          seeds=args.seeds, seconds=time.perf_counter() - t0,
                          cells=cells, ok=ok)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""CLI of the port (port of cdae_tpu/cli.py: every --method it takes).

The flag surface is cdae_tpu's, so command lines carry over, plus
``--device`` (default ``cuda``; ``--device cpu`` is the only way onto the
CPU -- a CUDA request without a GPU raises). Tasks:

  prepare  -- parse the text input, build vocabs, write the cache
  split    -- per-user split of the cache, write train/test caches
  train    -- load --cache_file, split it (--test_ratio, --seed), train and
              evaluate the Popularity baseline (one TOPN row; skipped with
              --skip_popularity), as cdae_tpu does; then, unless --method
              is NONE, train --method CDAE, MF (IMF), IMF, PMF, BPR, WARP,
              FISM, FISMPAIR, ALS, WRMF, ITEMCF, USERCF, NEGMF, LINEAR, FM
              or POP (or POPULARITY) with Solver.train (SGDSolver with
              --learn_rate for FISM, FISMPAIR, LINEAR, FM and NEGMF, as
              cdae_tpu), evaluating every --eval_iters with
              --eval (TOPN, RANKING, RMSE, MAE); --init_checkpoint resumes,
              --checkpoint / --checkpoint_every write checkpoints. CDAE
              trains in dense mode while the int8 (U, I) matrix fits
              (--dense_mode auto), else with the sparse step.
  test     -- load split caches, restore --init_checkpoint (a cdae_tpu or
              cdae_tpu_torch checkpoint), evaluate any of those methods
  sweep    -- load --cache_file, split it (--test_ratio, --seed), run the
              paper's CDAE grid (sweep.py; --max_iters epochs a point,
              --batch_size, --sweep_limit points, 0 = all 192): one JSON
              line a point

``prepare`` parses the two built-in formats with the multithreaded host
loader (--num_thread threads, 0 = all cores). A method cdae_tpu does not
know exits with ``unknown --method``. LINEAR and FM have no TOPN scores
(cdae_tpu's have none either): train them with ``--eval RMSE`` or ``MAE``.

``--sharded true`` trains (or tests) the method's sharded wrapper
(``wrap_sharded``, parallel/trainer.py) over a ('data', 'model') mesh of
processes, --mesh_model of them on 'model' (--shard_items: the MF family's
item-sharded ShardedMFTP). Every process runs the same command line with
CDAE_COORDINATOR (``host:port`` of rank 0, or a ``file://`` path),
CDAE_NUM_PROCESSES and CDAE_PROCESS_ID set (parallel/distributed.py; none
set: one process, a 1 x 1 mesh); NCCL on CUDA devices (rank r on
``cuda:r % device_count``), gloo on the CPU. Every rank trains and
evaluates; only rank 0 logs and writes checkpoints.

Run: ``python -m cdae_tpu_torch.cli --task train --method CDAE ...``
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import torch

from cdae_tpu_torch.data import io as data_io
from cdae_tpu_torch.data.dataset import (
    Interactions,
    default_line_parser,
    movielens_line_parser,
)
from cdae_tpu_torch.utils.logging import get_logger

logger = get_logger()

PARSERS = {
    "default": default_line_parser,  # "user item" -> label 1
    "movielens": movielens_line_parser,  # "u::i::r::ts"
}

def _booly(v: str) -> bool:
    return str(v).lower() in ("1", "true", "t", "yes", "y")


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cdae_tpu_torch",
        description="CDAE and model-zoo training and top-N serving on "
                    "PyTorch/CUDA (cdae_tpu port)",
    )
    # -- cdae_tpu's flag surface --
    p.add_argument("--input_file", default="./yelp_10core.txt")
    p.add_argument("--cache_file", default="./yelp.bin")
    p.add_argument("--train_cache_file", default="./yelp.train.bin")
    p.add_argument("--test_cache_file", default="./yelp.test.bin")
    p.add_argument("--task", default="train",
                   choices=["prepare", "split", "train", "test", "sweep"])
    p.add_argument("--seed", type=int, default=20141119)
    p.add_argument("--method", default="NONE")
    p.add_argument("--num_dim", type=int, default=10)
    p.add_argument("--num_neg", type=int, default=5)
    p.add_argument("--learn_rate", type=float, default=0.1)
    p.add_argument("--adagrad", type=_booly, default=True)
    p.add_argument("--bias", type=_booly, default=True)
    p.add_argument("--linear_function", type=_booly, default=False)
    p.add_argument("--tanh", type=_booly, default=False)
    p.add_argument("--asym", type=_booly, default=False)
    p.add_argument("--linear", type=_booly, default=False)
    p.add_argument("--scaled", type=_booly, default=False)
    p.add_argument("--user_factor", type=_booly, default=True)
    p.add_argument("--linear_output", type=_booly, default=False,
                   help="accepted and unused, as in cdae_tpu (the decoder "
                        "is always linear)")
    p.add_argument("--num_thread", type=int, default=0,
                   help="host loader threads (0 = all cores)")
    p.add_argument("--cnum", type=int, default=1)
    p.add_argument("--cratio", type=float, default=0.0)
    p.add_argument("--loss_type", default="SQUARE")
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--lambda", dest="lambda_", type=float, default=0.01)
    p.add_argument("--parser", default="default", choices=sorted(PARSERS))
    p.add_argument("--max_iters", type=int, default=50)
    p.add_argument("--eval_iters", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--test_ratio", type=float, default=0.2)
    p.add_argument("--eval", default="TOPN",
                   help="comma-separated eval types (TOPN,RANKING,RMSE,MAE)")
    p.add_argument("--rel_threshold", type=float, default=4.0,
                   help="RANKING relevance cut for a hit")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--init_checkpoint", default="",
                   help="test: restore params; train: resume from it")
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--guard_nan", type=_booly, default=False)
    p.add_argument("--loss_sample", type=int, default=0)
    p.add_argument("--sweep_limit", type=int, default=0,
                   help="sweep task: run only the first N grid points")
    p.add_argument("--trace_dir", default="")
    p.add_argument("--dense_mode", default="auto",
                   help="int8 dense interaction matrix: auto|true|false")
    p.add_argument("--warp_pool", type=int, default=0)
    p.add_argument("--num_shared_neg", type=int, default=32)
    p.add_argument("--epoch_chunk", type=int, default=0)
    p.add_argument("--fast_rng", type=_booly, default=False)
    p.add_argument("--bf16_compute", type=_booly, default=False,
                   help="bf16 matmul operands, f32 sums")
    p.add_argument("--skip_popularity", action="store_true")
    p.add_argument("--sim_type", default="JACCARD")
    p.add_argument("--sim_topk", type=int, default=50)
    p.add_argument("--scalar", type=float, default=40.0)
    p.add_argument("--alpha", type=int, default=1)
    p.add_argument("--sharded", type=_booly, default=False)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--shard_items", type=_booly, default=False)
    p.add_argument("--platform", default="",
                   help="accepted and unused (a jax platform in cdae_tpu); "
                        "see --device")
    # -- port additions --
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a GPU) "
                        "or cpu")
    return p


def build_model(args):
    """--method dispatch over the port's ``MODEL_REGISTRY``; the config
    comes from the flags by the model's config class, as in cdae_tpu."""
    from cdae_tpu_torch.models import (MODEL_REGISTRY, ALSConfig, CDAEConfig,
                                       FactorModelConfig, FISMConfig,
                                       LinearModelConfig, MFConfig,
                                       SimilarityConfig)

    method = args.method.upper()
    # the reference's MF is IMF; cdae_tpu takes POPULARITY for POP
    method = {"MF": "IMF", "POPULARITY": "POP"}.get(method, method)
    if method not in MODEL_REGISTRY:
        raise SystemExit(f"unknown --method {args.method}")
    dense = None if args.dense_mode == "auto" else _booly(args.dense_mode)
    cls, cfg_cls = MODEL_REGISTRY[method]
    if cfg_cls is SimilarityConfig:
        return cls(SimilarityConfig(sim_type=args.sim_type,
                                    topk=args.sim_topk), device=args.device)
    if cfg_cls is ALSConfig:
        return cls(ALSConfig(lambda_=args.lambda_, scalar=args.scalar,
                             num_dim=args.num_dim), device=args.device)
    if cfg_cls is MFConfig:
        # --dense_mode true opts BPR and WARP into their slab steps
        return cls(MFConfig(
            learn_rate=args.learn_rate, beta=args.beta, lambda_=args.lambda_,
            loss=args.loss_type, num_dim=args.num_dim, num_neg=args.num_neg,
            using_bias_term=args.bias, using_adagrad=args.adagrad,
            batch_size=args.batch_size, dense_mode=dense,
            warp_pool=(args.warp_pool or None),
            num_shared_neg=args.num_shared_neg,
            epoch_chunk=(args.epoch_chunk or None),
            fast_rng=(True if args.fast_rng else None),
        ), device=args.device)
    if cfg_cls is FISMConfig:
        # cdae_tpu passes FISM no --dense_mode and an eighth of the batch
        return cls(FISMConfig(
            lambda_=args.lambda_, loss=args.loss_type, num_dim=args.num_dim,
            num_neg=args.num_neg, alpha=args.alpha,
            using_adagrad=args.adagrad, learn_rate=args.learn_rate,
            batch_size=max(args.batch_size // 8, 1),
        ), device=args.device)
    if cfg_cls is LinearModelConfig:
        return cls(LinearModelConfig(
            lambda_=args.lambda_, loss=args.loss_type,
            using_adagrad=args.adagrad, learn_rate=args.learn_rate,
            batch_size=args.batch_size,
        ), device=args.device)
    if cfg_cls is FactorModelConfig:
        kw = dict(lambda_=args.lambda_, loss=args.loss_type,
                  num_dim=args.num_dim, using_adagrad=args.adagrad,
                  learn_rate=args.learn_rate, batch_size=args.batch_size)
        if method == "NEGMF":  # --dense_mode true: NegMF's slab step
            kw.update(num_neg=args.num_neg, dense_mode=dense)
        return cls(FactorModelConfig(**kw), device=args.device)
    if cfg_cls is not CDAEConfig:
        # no flag of cdae_tpu's sets it (POP; MULTVAE, the paper's
        # settings): the model's own defaults
        return cls(device=args.device)
    return cls(CDAEConfig(
        lambda_=args.lambda_, learn_rate=args.learn_rate,
        loss=args.loss_type, num_dim=args.num_dim,
        using_adagrad=args.adagrad, corruption_ratio=args.cratio,
        num_corruptions=args.cnum, asymmetric=args.asym,
        user_factor=args.user_factor, linear=args.linear,
        num_neg=args.num_neg, scaled=args.scaled, beta=args.beta,
        linear_function=args.linear_function, tanh=args.tanh,
        batch_size=min(args.batch_size, 1024), dense_mode=dense,
        compute_dtype=torch.bfloat16 if args.bf16_compute else None,
    ), device=args.device)


def wrap_sharded(model, args):
    """--sharded dispatch: the mesh-sharded trainer for --method (the
    order and the refusals of cdae_tpu's). Drop-in for Solver/Evaluation;
    the mesh from --mesh_model (the rest on 'data'), over the processes of
    the group (``initialize`` first)."""
    from cdae_tpu_torch import models as M
    from cdae_tpu_torch.parallel import trainer as T
    from cdae_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_model=max(args.mesh_model, 1),
                     device="cpu" if args.device == "cpu" else None)
    if isinstance(model, M.CDAE):
        return T.ShardedCDAE(model.cfg, mesh=mesh)
    if isinstance(model, (M.BPR, M.WARP, M.IMF, M.PMF)):
        if args.shard_items:
            from cdae_tpu_torch.parallel.tp_pairwise import ShardedMFTP

            return ShardedMFTP(model, mesh=mesh)
        if isinstance(model, M.IMF) and _booly(args.dense_mode):
            return T.ShardedIMF(model.cfg, mesh=mesh)  # dense (U,I) slabs
        return T.ShardedPairwise(model, mesh=mesh)
    if isinstance(model, M.WRMF):  # before ALS: WRMF subclasses it
        return T.ShardedWRMF(model.cfg, mesh=mesh)
    if isinstance(model, M.ALS):
        return T.ShardedALS(model.cfg, mesh=mesh)
    if isinstance(model, M.FISMPair):
        raise SystemExit("--sharded does not cover FISMPAIR (pointwise "
                         "ShardedFISM only); train it single-chip")
    if isinstance(model, M.FISM):
        return T.ShardedFISM(model.cfg, mesh=mesh)
    if isinstance(model, M.NegMF):
        return T.ShardedNegMF(model, mesh=mesh)
    raise SystemExit(f"--sharded not supported for --method {args.method}")


def _build(args):
    """``build_model``, wrapped by ``wrap_sharded`` under --sharded (the
    process group joined first)."""
    if args.sharded:
        import logging

        from cdae_tpu_torch.parallel.distributed import initialize, is_primary

        initialize(device=args.device)
        if not is_primary():
            logger.setLevel(logging.WARNING)  # rank 0 logs the run
    model = build_model(args)
    return wrap_sharded(model, args) if args.sharded else model


def _eval_types(args) -> list:
    from cdae_tpu_torch.evaluation import Evaluation

    eval_types = [e.strip() for e in args.eval.split(",") if e.strip()]
    if args.rel_threshold != 4.0:
        eval_types = [
            Evaluation.create(e, rel_threshold=args.rel_threshold)
            if e.upper() == "RANKING" else e
            for e in eval_types
        ]
    return eval_types


def train(args):
    """The train task: split ``--cache_file``, train and evaluate
    Popularity first unless ``--skip_popularity`` (cdae_tpu's order), then
    train ``--method`` with Solver.train (SGDSolver from --learn_rate for
    FISM and the feature-group models, as cdae_tpu). Returns the method's
    Solver (its ``history`` holds every eval row, iteration 0 included),
    Popularity's for --method NONE, or None when nothing trains (--method
    NONE --skip_popularity)."""
    from cdae_tpu_torch.models import FISM, LinearModel, Popularity
    from cdae_tpu_torch.solver.solver import SGDSolver, Solver

    none = args.method.upper() == "NONE"
    if none and args.skip_popularity:
        return None
    # resolve --device (and the method) before loading: fails fast
    pop = None if args.skip_popularity else Popularity(device=args.device)
    model = None if none else _build(args)
    if model is not None and args.sharded and pop is not None:
        pop = Popularity(device=model.device)  # the rank's own device
    data = data_io.load_interactions(args.cache_file)
    logger.info("loaded %s", data)
    train_data, test = data.split_by_user(args.test_ratio, seed=args.seed)
    logger.info("train %s / test %s", train_data, test)
    if pop is not None:
        pop_solver = Solver(pop, max_iteration=1, seed=args.seed)
        pop_solver.train(train_data, test, ["TOPN"])
    if none:
        return pop_solver
    inner = getattr(model, "inner", model) if args.sharded else model
    solver_cls = (SGDSolver if isinstance(inner, (FISM, LinearModel))
                  else Solver)
    solver = solver_cls(model, max_iteration=args.max_iters,
                        eval_iterations=args.eval_iters, seed=args.seed,
                        trace_dir=args.trace_dir or None,
                        guard=args.guard_nan,
                        loss_sample_size=args.loss_sample)
    if isinstance(solver, SGDSolver):
        solver.learn_rate0 = args.learn_rate
    solver.train(
        train_data, test, _eval_types(args),
        resume_from=args.init_checkpoint or None,
        checkpoint_path=args.checkpoint or None,
        checkpoint_every=args.checkpoint_every,
    )
    if args.checkpoint:
        logger.info("checkpoint -> %s", args.checkpoint)
    return solver


def run(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Run one task; returns the test metrics (test), the last eval row
    (train), or {} (prepare/split/sweep)."""
    args = build_arg_parser().parse_args(argv)
    if args.task == "prepare":
        data = Interactions.from_text(args.input_file, PARSERS[args.parser],
                                      num_threads=args.num_thread)
        logger.info("loaded %s", data)
        data_io.save_interactions(data, args.cache_file)
        logger.info("cached -> %s", args.cache_file)
        return {}
    if args.task == "split":
        data = data_io.load_interactions(args.cache_file)
        logger.info("loaded %s", data)
        train_data, test = data.split_by_user(args.test_ratio, seed=args.seed)
        logger.info("train %s / test %s", train_data, test)
        data_io.save_interactions(train_data, args.train_cache_file)
        data_io.save_interactions(test, args.test_cache_file)
        return {}
    if args.task == "sweep":
        # the reference's qsub grid (apps/yelp/cdae.sh) as one sequential run
        from cdae_tpu_torch.models.base import resolve_device
        from cdae_tpu_torch.sweep import run_sweep

        resolve_device(args.device)  # fails fast, before loading
        data = data_io.load_interactions(args.cache_file)
        logger.info("loaded %s", data)
        train_data, test = data.split_by_user(args.test_ratio, seed=args.seed)
        run_sweep(train_data, test, iters=args.max_iters,
                  batch_size=args.batch_size, seed=args.seed,
                  limit=args.sweep_limit, device=args.device)
        return {}

    if args.task == "train":
        solver = train(args)
        return solver.history[-1] if solver is not None else {}

    from cdae_tpu_torch.solver.solver import Solver
    from cdae_tpu_torch.utils import checkpoint as ckpt

    model = _build(args)  # resolves --device first: fails fast
    eval_types = _eval_types(args)
    train_data = data_io.load_interactions(args.train_cache_file)
    test = data_io.load_interactions(args.test_cache_file)
    logger.info("train %s / test %s", train_data, test)
    solver = Solver(model)
    solver.state = model.reset(train_data, seed=args.seed)
    if args.init_checkpoint:
        ckpt.load_model_checkpoint(model, args.init_checkpoint,
                                   solver.state)
    return solver.test(test, eval_types, train_data=train_data)


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())

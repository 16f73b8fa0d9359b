"""CLI of the port (port of cdae_tpu/cli.py, CDAE tasks).

The flag surface is cdae_tpu's, so command lines carry over, plus
``--device`` (default ``cuda``; ``--device cpu`` is the only way onto the
CPU -- a CUDA request without a GPU raises). Tasks:

  prepare  -- parse the text input, build vocabs, write the cache
  split    -- per-user split of the cache, write train/test caches
  train    -- load --cache_file, split it (--test_ratio, --seed), train
              --method CDAE with Solver.train, evaluating every
              --eval_iters; --init_checkpoint resumes, --checkpoint /
              --checkpoint_every write checkpoints. cdae_tpu trains the
              Popularity baseline first, which is not ported yet (ROADMAP
              A9): pass --skip_popularity.
  test     -- load split caches, restore --init_checkpoint (a cdae_tpu or
              cdae_tpu_torch checkpoint), evaluate --method CDAE

``sweep``, and every method but CDAE, come with later slices of the port
and exit with a message saying so.

Run: ``python -m cdae_tpu_torch.cli --task train --method CDAE
--skip_popularity ...``
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

_LATER = ("is not ported to cdae_tpu_torch yet: it comes with a later "
          "slice of the port (ROADMAP.md)")


def _booly(v: str) -> bool:
    return str(v).lower() in ("1", "true", "t", "yes", "y")


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cdae_tpu_torch",
        description="CDAE training and top-N serving on PyTorch/CUDA "
                    "(cdae_tpu port)",
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
                   help="accepted and unused (the loader is pure Python)")
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
                   help="comma-separated eval types (TOPN,RANKING)")
    p.add_argument("--rel_threshold", type=float, default=4.0,
                   help="RANKING relevance cut for a hit")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--init_checkpoint", default="",
                   help="test: restore params; train: resume from it")
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--guard_nan", type=_booly, default=False)
    p.add_argument("--loss_sample", type=int, default=0)
    p.add_argument("--sweep_limit", type=int, default=0)
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
    """--method dispatch; the port serves CDAE."""
    from cdae_tpu_torch.models.cdae import CDAE, CDAEConfig

    if args.method.upper() != "CDAE":
        raise SystemExit(f"--method {args.method} {_LATER}")
    if args.sharded:
        raise SystemExit(f"--sharded {_LATER}")
    dense = None if args.dense_mode == "auto" else _booly(args.dense_mode)
    return CDAE(CDAEConfig(
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
    """The train task: split ``--cache_file``, train with Solver.train,
    return the Solver (its ``history`` holds every eval row, iteration 0
    included)."""
    from cdae_tpu_torch.solver.solver import Solver

    if not args.skip_popularity:
        raise SystemExit(
            "--task train trains the Popularity baseline first, as cdae_tpu "
            f"does; Popularity (ROADMAP A9) {_LATER}. Pass --skip_popularity"
        )
    model = build_model(args)  # resolves --device first: fails fast
    data = data_io.load_interactions(args.cache_file)
    logger.info("loaded %s", data)
    train_data, test = data.split_by_user(args.test_ratio, seed=args.seed)
    logger.info("train %s / test %s", train_data, test)
    solver = Solver(model, max_iteration=args.max_iters,
                    eval_iterations=args.eval_iters, seed=args.seed,
                    trace_dir=args.trace_dir or None, guard=args.guard_nan,
                    loss_sample_size=args.loss_sample)
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
    (train), or {} (prepare/split)."""
    args = build_arg_parser().parse_args(argv)
    if args.task == "sweep":
        raise SystemExit(f"--task {args.task} {_LATER}")
    if args.task == "prepare":
        data = Interactions.from_text(args.input_file, PARSERS[args.parser])
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

    if args.task == "train":
        return train(args).history[-1]

    from cdae_tpu_torch.solver.solver import Solver
    from cdae_tpu_torch.utils import checkpoint as ckpt

    model = build_model(args)  # resolves --device first: fails fast
    eval_types = _eval_types(args)
    train_data = data_io.load_interactions(args.train_cache_file)
    test = data_io.load_interactions(args.test_cache_file)
    logger.info("train %s / test %s", train_data, test)
    solver = Solver(model)
    solver.state = model.reset(train_data, seed=args.seed)
    if args.init_checkpoint:
        ckpt.load_checkpoint(args.init_checkpoint, solver.state)
    return solver.test(test, eval_types, train_data=train_data)


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())

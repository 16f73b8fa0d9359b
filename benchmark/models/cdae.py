"""CDAE under the benchmark (configuration ``"model": "cdae"``): how the
program's CDAE is built from the seeded data and weights, driven, read,
and judged against the plain reference at the configuration's
``reference`` path.

Set-up builds the program's ``Interactions`` from the generated pairs and
its state through ``CDAE.reset``, then puts the benchmark's own weights
(``weights``) in it: W (I, D) and Wu (U, D) uniform in (-s, s) with
s = 4 sqrt(6 / (I + D)), b and b' zero, drawn by one generator on the
device in two calls. The reference makes the same weights from the seed
itself and reads nothing the program made.

A driver calls, for training: ``train_unit`` (one epoch through
``CDAE.train_one_iteration(state, seed)``, the call ``Solver.train``
makes), ``steps_per_unit``, ``unit_flops``, ``snapshot`` and
``program_readings`` (by leaf, the gradient norms from the AdaGrad state
and the change norms), ``reference_readings``; for serving:
``recommend`` (``model.recommend(state, uids, train, k)``, ids to the
host), ``request_flops`` and ``reference_scores``.
"""

from __future__ import annotations

import math
import types
from typing import Dict

import numpy as np
import torch

from benchmark.harness import compare, counts, spec

LEAVES = ("W", "b", "b_prime", "Wu")


def reference(ctx):
    """The plain reference module the configuration names."""
    return spec.load_path(ctx.config["reference"])


def weights(ctx) -> Dict[str, torch.Tensor]:
    """CDAE's initial tables for the run's seed, float32 on the run's
    device."""
    dev = ctx.device
    D = int(ctx.config["cdae"]["num_dim"])
    U, I = ctx.num_users, ctx.num_items
    gen = torch.Generator(device=dev).manual_seed(int(ctx.seed) ^ 0x5EED_BE7C)
    s = 4.0 * math.sqrt(6.0 / (I + D))
    W = torch.rand((I, D), generator=gen, device=dev)
    Wu = torch.rand((U, D), generator=gen, device=dev)
    return {
        "W": W.mul_(2.0 * s).sub_(s),
        "Wu": Wu.mul_(2.0 * s).sub_(s),
        "b": torch.zeros(D, device=dev),
        "b_prime": torch.zeros(I, device=dev),
    }


def build(ctx):
    """The program's model, state and training data, with the
    benchmark's weights in the state."""
    from cdae_tpu_torch.data.dataset import Interactions
    from cdae_tpu_torch.models.cdae import CDAE, CDAEConfig

    train = Interactions.from_arrays(ctx.users, ctx.items,
                                     num_users=ctx.num_users,
                                     num_items=ctx.num_items)
    model = CDAE(CDAEConfig(**ctx.config["cdae"]), device=ctx.device)
    state = model.reset(train, seed=ctx.seed)
    ctx.log("bench: reset done")
    w = weights(ctx)
    with torch.no_grad():
        for k, v in w.items():
            state.params[k].copy_(v)
    return types.SimpleNamespace(model=model, state=state, train=train)


# ------------------------------------------------------------ training --

def train_unit(ctx) -> None:
    p = ctx.program
    p.model.train_one_iteration(p.state, ctx.seed)


def steps_per_unit(ctx) -> int:
    cfg = ctx.config["cdae"]
    return (-(-ctx.num_users // cfg["batch_size"])
            * cfg.get("num_corruptions", 1))


def unit_flops(ctx) -> float:
    """Needed FLOPs of an epoch (``counts.train_user_flops``)."""
    cfg = ctx.config["cdae"]
    return float(np.sum(counts.train_user_flops(
        ctx.lengths, cfg["num_dim"], cfg["num_neg"],
        cfg["corruption_ratio"])))


def snapshot(ctx) -> Dict[str, torch.Tensor]:
    p = ctx.program.state.params
    return {k: p[k].clone() for k in LEAVES}


def program_readings(ctx, before: Dict[str, torch.Tensor]):
    """(gradient norms, change norms) by leaf of the program's state
    since ``before``."""
    ref = reference(ctx)
    p = ctx.program.state.params
    return (ref.grad_norms({k: p[k + "_ag"] for k in LEAVES}),
            compare.leaf_norms({k: p[k] - before[k] for k in LEAVES}))


def reference_readings(ctx, device, drop_half: bool = False,
                       tf32: bool = False):
    """(gradient norms, change norms) by leaf of the reference's first
    epoch from the seed's weights, on ``device``. ``drop_half`` plants the
    fault of half of each batch left out; ``tf32`` is the control's
    precision."""
    ref = reference(ctx)
    cfg = ctx.config["cdae"]
    P = {k: v.to(device) for k, v in weights(ctx).items()}
    P0 = {k: v.clone() for k, v in P.items()}
    rows = ref.Rows(ctx.users, ctx.items, ctx.num_users, ctx.num_items)
    A = ref.train_epoch(P, cfg, rows, bool(cfg["dense_mode"]), ctx.seed,
                        drop_half=drop_half, tf32=tf32)
    return (ref.grad_norms(A),
            compare.leaf_norms({k: P[k] - P0[k] for k in P}))


# ------------------------------------------------------------- serving --

def recommend(ctx, uids: np.ndarray, k: int) -> np.ndarray:
    p = ctx.program
    return p.model.recommend(p.state, uids, p.train, k=k).cpu().numpy()


def request_flops(ctx, uids: np.ndarray) -> float:
    return counts.serve_flops(ctx.lengths[uids], ctx.num_items,
                              ctx.config["cdae"]["num_dim"])


def reference_scores(ctx, device, tf32: bool = False):
    """A function of user ids that gives the reference's (B, I) scores,
    rated items at -inf, from the seed's weights on ``device``."""
    ref = reference(ctx)
    P = {k: v.to(device) for k, v in weights(ctx).items()}
    rows = ref.Rows(ctx.users, ctx.items, ctx.num_users, ctx.num_items)
    return lambda uids: ref.scores(P, rows, np.asarray(uids, np.int64),
                                   tf32=tf32)

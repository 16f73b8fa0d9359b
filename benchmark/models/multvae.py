"""Mult-VAE under the benchmark (configuration ``"model": "multvae"``):
how the program's Mult-VAE (``cdae_tpu_torch/models/multvae.py``) is
built from the seeded data and weights, driven, read, and judged against
the plain reference at the configuration's ``reference`` path.

Set-up builds the program's ``Interactions`` from the generated pairs and
its state through ``MultVAE.reset``, then puts the benchmark's own weights
(``weights``) in it: Glorot-uniform W_q1 (I, H), W_q2 (H, 2K), W_p1 (K, H),
W_p2 (H, I) and biases normal with std 0.001, drawn by one generator on
the device in that order. The reference makes the same weights from the
seed itself and reads nothing the program made.

A driver calls, for training: ``train_unit`` (one epoch through
``MultVAE.train_one_iteration(state, seed)``), ``steps_per_unit``,
``unit_flops``, ``snapshot`` and ``program_readings``,
``reference_readings``; for serving: ``recommend``, ``request_flops`` and
``reference_scores``.

The check compares the first ``COMPARED_STEPS`` updates of epoch 0 from
the seed's weights, not the whole first epoch: by leaf, the norm of
Adam's second moment v, which stands where CDAE's AdaGrad accumulator
does, and the norm of the change. Two float32 runs whose sums differ
only in order part ways in the encoder between the 100th and the 300th
update on some seeds (the reference against itself, its first layer
summed as a dense product and as a gather-sum over the rated items), and
by the epoch's end such a seed reads as far from the reference as the
TF32 control does on others; over the first 20 updates every float32 run
stays near the reference and the control does not. ``snapshot`` runs
that stretch in set-up, before the first epoch, on a copy of the
program's state.
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import Dict

import numpy as np
import torch

from benchmark.harness import compare, spec

LEAVES = ("W_q1", "b_q1", "W_q2", "b_q2", "W_p1", "b_p1", "W_p2", "b_p2")
# the updates of epoch 0 the check compares (of 927 at Netflix's size)
COMPARED_STEPS = 20


def reference(ctx):
    """The plain reference module the configuration names."""
    return spec.load_path(ctx.config["reference"])


def weights(ctx) -> Dict[str, torch.Tensor]:
    """Mult-VAE's initial tables for the run's seed, float32 on the run's
    device."""
    cfg = ctx.config["multvae"]
    dev = ctx.device
    I, H, K = ctx.num_items, int(cfg["hidden_dim"]), int(cfg["latent_dim"])
    gen = torch.Generator(device=dev).manual_seed(int(ctx.seed) ^ 0x5EED_7AE0)

    def glorot(fan_in, fan_out):
        s = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand((fan_in, fan_out), generator=gen, device=dev)
        return u.mul_(2.0 * s).sub_(s)

    def bias(n):
        return torch.randn((n,), generator=gen, device=dev).mul_(1e-3)

    return {"W_q1": glorot(I, H), "b_q1": bias(H),
            "W_q2": glorot(H, 2 * K), "b_q2": bias(2 * K),
            "W_p1": glorot(K, H), "b_p1": bias(H),
            "W_p2": glorot(H, I), "b_p2": bias(I)}


def build(ctx):
    """The program's model, state and training data, with the
    benchmark's weights in the state."""
    from cdae_tpu_torch.data.dataset import Interactions
    from cdae_tpu_torch.models.multvae import MultVAE, MultVAEConfig

    train = Interactions.from_arrays(ctx.users, ctx.items,
                                     num_users=ctx.num_users,
                                     num_items=ctx.num_items)
    model = MultVAE(MultVAEConfig(**ctx.config["multvae"]),
                    device=ctx.device)
    state = model.reset(train, seed=ctx.seed)
    ctx.log("bench: reset done")
    with torch.no_grad():
        for k, v in weights(ctx).items():
            state.params[k].copy_(v)
    return types.SimpleNamespace(model=model, state=state, train=train)


# ------------------------------------------------------------ training --

def train_unit(ctx) -> None:
    p = ctx.program
    p.model.train_one_iteration(p.state, ctx.seed)


def steps_per_unit(ctx) -> int:
    return -(-ctx.num_users // int(ctx.config["multvae"]["batch_size"]))


def unit_flops(ctx) -> float:
    """Needed FLOPs of an epoch: the sparse first layer forward and
    backward over the kept pairs (2 k H each, k = (1 - q) of the training
    pairs), the three dense layers' products forward, to their weights and
    to their inputs (6 B a b each), and 4 operations a cell of the
    softmax's (B, I) slab (its exponential, sum and normalisation, the
    gradient's scale)."""
    cfg = ctx.config["multvae"]
    H, K, I = int(cfg["hidden_dim"]), int(cfg["latent_dim"]), ctx.num_items
    U = ctx.num_users
    kept = (1.0 - float(cfg["dropout"])) * float(len(ctx.items))
    dense = 6.0 * U * (H * 2 * K + K * H + H * I)
    return 4.0 * kept * H + dense + 4.0 * U * I


def snapshot(ctx):
    """The program's readings of the compared stretch: its first
    ``COMPARED_STEPS`` updates of epoch 0 (``train_one_iteration`` with
    ``steps``), run on a copy of the state as built, so the first epoch
    still starts from the seed's weights. By leaf: the norms of Adam's v
    and of the change."""
    p = ctx.program
    state = dataclasses.replace(
        p.state, params={k: v.clone() for k, v in p.state.params.items()})
    p.model.train_one_iteration(state, ctx.seed, steps=COMPARED_STEPS)
    now, before = state.params, p.state.params
    return (compare.leaf_norms({k: now[k + "_v"] for k in LEAVES}),
            compare.leaf_norms({k: now[k] - before[k] for k in LEAVES}))


def program_readings(ctx, before):
    """The readings ``snapshot`` took (the first epoch adds nothing to
    them)."""
    return before


def reference_readings(ctx, device, drop_half: bool = False,
                       tf32: bool = False):
    """(norms of Adam's v, change norms) by leaf of the reference's first
    ``COMPARED_STEPS`` updates of epoch 0 from the seed's weights, on
    ``device``. ``drop_half`` plants the fault of half of each batch left
    out; ``tf32`` is the control's precision."""
    ref = reference(ctx)
    P = {k: v.to(device) for k, v in weights(ctx).items()}
    P0 = {k: v.clone() for k, v in P.items()}
    rows = ref.Rows(ctx.users, ctx.items, ctx.num_users, ctx.num_items)
    V = ref.train_epoch(P, ctx.config["multvae"], rows, ctx.seed,
                        drop_half=drop_half, tf32=tf32,
                        steps=COMPARED_STEPS)
    return (compare.leaf_norms(V),
            compare.leaf_norms({k: P[k] - P0[k] for k in P}))


# ------------------------------------------------------------- serving --

def recommend(ctx, uids: np.ndarray, k: int) -> np.ndarray:
    p = ctx.program
    return p.model.recommend(p.state, uids, p.train, k=k).cpu().numpy()


def request_flops(ctx, uids: np.ndarray) -> float:
    """Needed FLOPs of scoring ``uids``: the first layer over their rated
    items (2 n H), the q layer's and the decoder's products (2 a b each)."""
    cfg = ctx.config["multvae"]
    H, K, I = int(cfg["hidden_dim"]), int(cfg["latent_dim"]), ctx.num_items
    n = ctx.lengths[uids].astype(np.float64)
    return float(np.sum(2.0 * n * H)
                 + len(uids) * 2.0 * (H * 2 * K + K * H + H * I))


def reference_scores(ctx, device, tf32: bool = False):
    """A function of user ids that gives the reference's (B, I) logits,
    rated items at -inf, from the seed's weights on ``device``."""
    ref = reference(ctx)
    P = {k: v.to(device) for k, v in weights(ctx).items()}
    rows = ref.Rows(ctx.users, ctx.items, ctx.num_users, ctx.num_items)
    return lambda uids: ref.scores(P, ctx.config["multvae"], rows,
                                   np.asarray(uids, np.int64), tf32=tf32)

"""The reference's CDAE hyperparameter sweep as a library call (port of
cdae_tpu/sweep.py).

The reference ships its one published experimental surface as a qsub grid
(ref apps/yelp/cdae.sh:3-36: SCALE x USER_FACTOR x RATIO{0,.2,..,1} x
LINEAR x ASYM x LOSS{SQUARE,CE}; lr=0.1, dim=50, num_neg=5, beta=1,
seed=20141119). Here the grid is a generator and a sequential runner on
one device: each point trains CDAE's dense step (``train_epochs``) and is
scored by the TOPN evaluator. Exposed as ``scripts/torch_sweep_cdae.py``
and ``cdae_tpu_torch.cli --task sweep``.
"""

from __future__ import annotations

import itertools
import json
import sys
from typing import Iterator, Optional, TextIO

PAPER_SEED = 20141119


def paper_grid() -> Iterator[dict]:
    """The exact loops of ref apps/yelp/cdae.sh:3-25, in script order."""
    for scale, uf, ratio, linear, asym, loss in itertools.product(
        (False, True),                    # SCALE
        (True, False),                    # USER_FACTOR
        (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),  # RATIO
        (False, True),                    # LINEAR
        (True, False),                    # ASYM
        ("SQUARE", "CE"),                 # LOSS
    ):
        yield dict(scaled=scale, user_factor=uf, cratio=ratio,
                   linear=linear, asym=asym, loss=loss)


def point_config(g: dict, batch_size: int):
    """The CDAEConfig of grid point ``g``: the paper's fixed settings
    (lr 0.1, D=50, one corruption, AdaGrad, beta 1, num_neg 5, lambda
    0.01) with the point's axes."""
    from cdae_tpu_torch.models.cdae import CDAEConfig

    return CDAEConfig(
        learn_rate=0.1, num_dim=50, num_corruptions=1,
        corruption_ratio=g["cratio"], using_adagrad=True,
        asymmetric=g["asym"], linear=g["linear"], scaled=g["scaled"],
        user_factor=g["user_factor"], loss=g["loss"], beta=1.0,
        linear_function=False, tanh=False, num_neg=5, lambda_=0.01,
        batch_size=batch_size,
    )


def run_sweep(
    train,
    test,
    iters: int = 50,
    batch_size: int = 64,
    seed: int = PAPER_SEED,
    limit: int = 0,
    offset: int = 0,
    out: Optional[TextIO] = None,
    device="cuda",
) -> list:
    """Train + TOPN-evaluate every grid point on ``device``; returns the
    result dicts and streams one JSON line per point to ``out`` (default
    stdout). ``offset``/``limit`` select a contiguous slice of the grid,
    so the 192 points can be split across processes."""
    from cdae_tpu_torch.evaluation import Evaluation
    from cdae_tpu_torch.models.cdae import CDAE

    out = sys.stdout if out is None else out
    ev = Evaluation.create("TOPN")
    results = []
    for n, g in enumerate(paper_grid()):
        if n < offset:
            continue
        if limit and n >= offset + limit:
            break
        model = CDAE(point_config(g, batch_size), device=device)
        state = model.reset(train, seed=seed)
        state = model.train_epochs(state, iters, seed)
        res = ev.evaluate(model, state, test, train)
        rec = dict(g, grid_index=n,
                   **{"R@10": round(res["R@10"], 5),
                      "MAP@10": round(res["MAP@10"], 5)})
        print(json.dumps(rec), file=out, flush=True)
        results.append(rec)
    return results

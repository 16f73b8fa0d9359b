"""Synthetic interaction generators (numpy), the port's copies of
cdae_tpu/data/synthetic.py:lowrank_interactions and bench.py's
geometric-degree ``synthetic_interactions``. Same seeds give the same
interactions as the originals."""

from __future__ import annotations

import numpy as np

from cdae_tpu_torch.data.dataset import Interactions


def lowrank_interactions(
    num_users: int,
    num_items: int,
    avg_degree: int,
    rank: int = 8,
    popularity_exp: float = 1.0,
    seed: int = 20141119,
) -> Interactions:
    """Sample implicit interactions from softmax(low-rank logits + log-pop).

    Each user draws ``~Geometric(1/avg_degree)`` distinct items from their
    personalized distribution.
    """
    rng = np.random.default_rng(seed)
    uf = rng.standard_normal((num_users, rank)).astype(np.float32)
    vf = rng.standard_normal((num_items, rank)).astype(np.float32)
    pop = 1.0 / np.arange(1, num_items + 1) ** popularity_exp
    rng.shuffle(pop)
    log_pop = np.log(pop / pop.sum()).astype(np.float32)

    users_out, items_out = [], []
    block = 2048
    for start in range(0, num_users, block):
        end = min(start + block, num_users)
        logits = uf[start:end] @ vf.T / np.sqrt(rank) + log_pop[None, :]
        logits *= 2.0  # sharpen
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        p /= p.sum(axis=1, keepdims=True)
        sizes = np.minimum(
            1 + rng.geometric(1.0 / avg_degree, size=end - start),
            num_items // 2,
        )
        for row, n in enumerate(sizes):
            picks = rng.choice(num_items, size=n, replace=False, p=p[row])
            users_out.append(np.full(n, start + row, np.int32))
            items_out.append(picks.astype(np.int32))
    users = np.concatenate(users_out)
    items = np.concatenate(items_out)
    return Interactions.from_arrays(
        users, items, np.ones(len(users), np.float32),
        num_users=num_users, num_items=num_items,
    )


def synthetic_interactions(num_users: int, num_items: int, avg_degree: int,
                           seed: int = 20141119) -> Interactions:
    """Uniform item picks with geometric per-user degrees (mean
    ``avg_degree``), deduplicated -- the ML-1M-scale serving workload when
    called as (6040, 3706, 160)."""
    rng = np.random.default_rng(seed)
    degrees = np.minimum(
        1 + rng.geometric(1.0 / avg_degree, size=num_users), num_items - 1
    )
    users = np.repeat(np.arange(num_users, dtype=np.int64), degrees)
    items = rng.integers(0, num_items, size=len(users))
    pairs = np.unique(users * num_items + items)
    return Interactions.from_arrays(
        (pairs // num_items).astype(np.int32),
        (pairs % num_items).astype(np.int32),
        num_users=num_users,
        num_items=num_items,
    )

"""Synthetic interaction generators (numpy), the port's copies of
cdae_tpu/data/synthetic.py (``lowrank_interactions``, its rated variant
``lowrank_rated``, and the oracle's text writers ``write_pairs`` and
``write_triples``) and bench.py's geometric-degree
``synthetic_interactions``. Same seeds give the same interactions as the
originals."""

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


def lowrank_rated(
    num_users: int,
    num_items: int,
    avg_degree: int,
    rank: int = 8,
    seed: int = 20141119,
) -> Interactions:
    """Rated variant of ``lowrank_interactions``: each sampled (u, i)
    carries a 1..5 rating tied to a low-rank affinity plus noise,
    standardized per user, so roughly a third of the ratings clear the
    RANKING evaluator's rel >= 4 threshold."""
    data = lowrank_interactions(num_users, num_items, avg_degree,
                                rank=rank, seed=seed)
    rng = np.random.default_rng(seed + 1)
    uf = rng.standard_normal((num_users, rank)).astype(np.float32)
    vf = rng.standard_normal((num_items, rank)).astype(np.float32)
    aff = np.einsum("ur,ur->u", uf[data.users], vf[data.items]) / np.sqrt(rank)
    aff = aff + 0.35 * rng.standard_normal(len(aff)).astype(np.float32)
    # per-user standardization -> quantile-ish buckets over N(0, 1)
    mean = np.zeros(num_users, np.float32)
    np.add.at(mean, data.users, aff)
    cnt = np.bincount(data.users, minlength=num_users).astype(np.float32)
    mean /= np.maximum(cnt, 1)
    var = np.zeros(num_users, np.float32)
    np.add.at(var, data.users, (aff - mean[data.users]) ** 2)
    std = np.sqrt(var / np.maximum(cnt, 1) + 1e-6)
    z = (aff - mean[data.users]) / std[data.users]
    edges = np.array([-1.1, -0.4, 0.25, 0.95], np.float32)  # 1..5 buckets
    ratings = (1.0 + np.searchsorted(edges, z)).astype(np.float32)
    return Interactions.from_arrays(
        data.users, data.items, ratings,
        num_users=num_users, num_items=num_items,
    )


def write_pairs(path: str, data: Interactions) -> None:
    """Write ``user item`` integer-id lines (the C++ oracle's input)."""
    with open(path, "w") as f:
        for u, i in zip(data.users, data.items):
            f.write(f"{u} {i}\n")


def write_triples(path: str, data: Interactions) -> None:
    """Write ``user item rating`` lines (the C++ oracle's rated input)."""
    with open(path, "w") as f:
        for u, i, r in zip(data.users, data.items, data.ratings):
            f.write(f"{u} {i} {r:g}\n")


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

"""Degree law: ``min_degree`` plus a geometric draw whose mean makes the
dataset's mean degree (``num_ratings / num_users``).

The sequence is the geometric law's quantiles at (k + 1/2) / U, rounded
so that it sums to ``num_ratings`` exactly; the generator's seed only
deals it out to the users, so every seed trains on the same set of row
lengths, in another order.
"""

from __future__ import annotations

import math

import numpy as np


def degrees(data: dict, num_items: int) -> np.ndarray:
    """The sorted (ascending) degrees of ``data`` (a configuration's
    ``data`` section), each at most ``num_items``."""
    return degree_sequence(int(data["num_users"]), int(data["num_ratings"]),
                           int(data["min_degree"]), num_items)


def degree_sequence(num_users: int, num_ratings: int, min_degree: int,
                    cap: int) -> np.ndarray:
    """``min_degree`` plus geometric quantiles with the mean that makes
    ``num_ratings``, rounded to sum to it exactly, each at most ``cap``."""
    extra_mean = num_ratings / num_users - min_degree
    if extra_mean < 0:
        raise ValueError("num_ratings is below num_users * min_degree")
    q = (np.arange(num_users, dtype=np.float64) + 0.5) / num_users
    # continuous quantiles of the exponential law with the same mean; their
    # floors are the geometric law's quantiles (rate -log(1 - p), p =
    # 1 / (1 + mean))
    t = -np.log1p(-q) / -math.log1p(-1.0 / (1.0 + extra_mean)) \
        if extra_mean > 0 else np.zeros(num_users)
    x = np.floor(t)
    short = num_ratings - num_users * min_degree - int(x.sum())
    # the remainder goes, one each, to the largest fractional parts
    if not 0 <= short <= num_users:
        # mean of the floors is off by more than one a user: scale first
        t = t * (num_ratings - num_users * min_degree) / max(t.sum(), 1.0)
        x = np.floor(t)
        short = num_ratings - num_users * min_degree - int(x.sum())
    order = np.argsort(-(t - x), kind="stable")
    x[order[:short]] += 1
    deg = np.sort(x.astype(np.int64) + min_degree)
    if deg[-1] > cap:
        raise ValueError(f"a degree of {deg[-1]} exceeds the {cap} items")
    return deg

"""Seeded synthetic rating data, made on the device.

The data follow a configuration's ``data`` section: a published dataset's
user and item counts and its rating count, with the two laws it names
(``benchmark/laws/<law>.py``):

- ``degree_law``: the sorted degree sequence (``degrees(data,
  num_items)``); the seed deals it out to the users.
- ``popularity_law``: each item's log weight from its popularity rank
  (``log_weights(data, rank)``); the seed deals the ranks to item ids.
  Each user's items are drawn without replacement in proportion to the
  weights (the exponential-keys form of successive sampling), on the
  device in blocks of users.
- Split: each user's items are split at random, ``floor(test_ratio * d)``
  held out, the rest kept for training. No cell evaluates, so only the
  training part is returned.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from benchmark.harness import spec

_BLOCK_CELLS = 1 << 26  # users x items per block of the draw


def degrees(data: Dict) -> np.ndarray:
    """The sorted degree sequence of ``data`` by its ``degree_law``."""
    law = spec.load_module("laws", data["degree_law"])
    return law.degrees(data, int(data["num_items"]))


def synthetic_train(data: Dict, seed: int, device) -> Tuple[np.ndarray,
                                                            np.ndarray]:
    """The training pairs (users, items) of ``data`` (a configuration's
    ``data`` section) for ``seed``: int32 arrays sorted by user, then
    item."""
    U, I = int(data["num_users"]), int(data["num_items"])
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    deg_sorted = degrees(data)
    perm = torch.randperm(U, generator=gen, device=dev)
    degree = torch.empty(U, dtype=torch.int64, device=dev)
    degree[perm] = torch.as_tensor(deg_sorted, device=dev)
    n_train = degree - torch.floor(
        degree.to(torch.float64) * float(data["test_ratio"])).to(torch.int64)
    rank = torch.randperm(I, generator=gen, device=dev).to(torch.float32)
    log_w = spec.load_module("laws", data["popularity_law"]).log_weights(
        data, rank)
    users_out, items_out = [], []
    block = max(1, _BLOCK_CELLS // I)
    for start in range(0, U, block):
        d = degree[start:start + block]
        n = d.shape[0]
        kmax = int(d.max())
        e = torch.empty((n, I), device=dev).exponential_(generator=gen)
        keys = log_w[None, :] - torch.log(e.clamp_(min=1e-30))
        picked = torch.topk(keys, kmax, dim=1).indices  # (n, kmax)
        del e, keys
        col = torch.arange(kmax, device=dev)[None, :]
        valid = col < d[:, None]
        # a uniformly random n_train of each user's d items for training
        r = torch.rand((n, kmax), generator=gen, device=dev)
        r = torch.where(valid, r, 2.0)
        pos = torch.argsort(torch.argsort(r, dim=1), dim=1)
        train = pos < n_train[start:start + n, None]
        picked = torch.where(train, picked, I)
        picked = torch.sort(picked, dim=1).values
        keep = picked < I
        uid = torch.arange(start, start + n, device=dev)[:, None].expand(
            -1, kmax)
        users_out.append(uid[keep].to(torch.int32))
        items_out.append(picked[keep].to(torch.int32))
    return (torch.cat(users_out).cpu().numpy(),
            torch.cat(items_out).cpu().numpy())

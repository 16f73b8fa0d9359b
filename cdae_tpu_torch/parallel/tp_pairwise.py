"""Tensor-parallel sparse-MF trainer: the item table PHYSICALLY sharded
(port of cdae_tpu/parallel/tp_pairwise.py).

ShardedPairwise (parallel/trainer.py) replicates every table, which caps
the catalog at one device's memory. Here the item factor table ``iv``
(I, D), the item bias ``ib`` and their AdaGrad accumulators live in
contiguous row blocks over 'model' (I / n_model rows a rank, zero-padded
to a multiple of n_model), while each batch splits over 'data'. It covers
the instance epoch of BPR (ref bpr.hpp:72-106), WARP's candidate-scan
path (ref warp.hpp:63-117) and IMF / PMF (ref imf.hpp:71-115,
pmf.hpp:80-104), through the models' own step functions with a
``Collectives`` argument:

  gather    the rows of the rank's instances are a masked local gather of
            the rank's block plus one sum over 'model' (cdae_tpu's
            ``_psum_gather``): B * nn * D values a batch, never the (I, D)
            table;
  aggregate the contribution rows are all-gathered over 'data' (B * nn *
            C values, independent of U and I); each rank then sums them,
            with B8, into ONLY its own item block, and into the replicated
            user table;
  apply     one B2 launch over the rank's blocks and the user tables.

Every rank draws the whole batch's negatives with the single-device
step's seeds, so training matches the single-device model up to the order
of float sums. WARP always takes the scan path (its dense path needs the
(U, I) rated mask, which is what does not fit at the catalog sizes this
trainer exists for).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cdae_tpu_torch.data.dataset import Interactions
from cdae_tpu_torch.ops.topk import NEG_INF
from cdae_tpu_torch.parallel.mesh import Mesh, make_mesh
from cdae_tpu_torch.parallel.topk import distributed_topk_unrated
from cdae_tpu_torch.parallel.trainer import _Sharded, _pad_rows

_ITEM_SPECS = {"iv": ("model", None), "iv_ag": ("model", None),
               "ib": ("model",), "ib_ag": ("model",)}


class ShardedMFTP(_Sharded):
    """BPR / WARP / IMF / PMF over a ('data', 'model') mesh, the item table
    sharded. Drop-in for Solver / Evaluation like the wrapped model.
    Requires batch_size % n_data == 0 (each data rank owns an equal slice
    of every batch)."""

    name = "ShardedMFTP"

    def __init__(self, inner, mesh: Optional[Mesh] = None, device=None):
        from cdae_tpu_torch.models.mf import BPR, IMF, PMF, WARP

        if not isinstance(inner, (BPR, IMF, PMF, WARP)):
            raise TypeError(
                "ShardedMFTP shards the BPR/WARP/IMF/PMF item table; got "
                f"{type(inner)}"
            )
        self.mesh = (mesh if mesh is not None else make_mesh(
            n_model=2, device=device if device is not None else inner.device))
        self.device = self.mesh.device
        nd = self.mesh.shape["data"]
        if inner.cfg.batch_size % nd:
            raise ValueError(
                f"batch_size={inner.cfg.batch_size} must divide over "
                f"n_data={nd}"
            )
        # the instance epoch on the scan path: no (U, I) mask, no pool, and
        # the dense apply over the rank's blocks
        cfg = dataclasses.replace(inner.cfg, dense_mode=False,
                                  warp_pool=None, row_update=False)
        self.inner = type(inner)(cfg, device=self.device)
        self.cfg = self.inner.cfg
        self.loss = self.inner.loss
        self.name = f"Sharded{inner.name}TP"

    # ------------------------------------------------------------- reset ----
    def _padded(self, params) -> dict:
        """The item tables zero-padded to n_model row blocks (accumulators
        at their init value: a zero accumulator with beta = 0 would make a
        pad row's zero-gradient update 0/0)."""
        from cdae_tpu_torch.solver.optimizer import ADAGRAD_INIT

        nm = self.mesh.shape["model"]
        I = params["iv"].shape[0]
        pad = -(-I // nm) * nm - I
        if not pad:
            return dict(params)
        p = dict(params)
        for k in _ITEM_SPECS:
            fill = ADAGRAD_INIT if k.endswith("_ag") else 0.0
            v = p[k]
            p[k] = torch.cat([v, v.new_full((pad,) + tuple(v.shape[1:]),
                                            fill)])
        return p

    def reset(self, data: Interactions, seed: int = 0):
        state = self.inner.reset(data, seed)
        state.aux.pop("dense_R", None)
        state.aux.pop("dense_ratings", None)
        state.params = self._padded(state.params)
        I_pad = state.params["iv"].shape[0]
        specs = {k: _ITEM_SPECS.get(k, ()) for k in state.params}
        self._shard(state, specs, split_users=False, gather_contribs=True,
                    table_items=I_pad)
        return state

    def train_one_iteration(self, state, seed: int = 0):
        return self.inner.train_one_iteration(state, seed, coll=self.coll)

    # ------------------------------------------------ whole tables / eval ---
    def gathered(self, state):
        """The whole tables with the item padding sliced off."""
        full = super().gathered(state)
        I = state.num_items
        full.params = {k: (v[:I] if k in _ITEM_SPECS else v)
                       for k, v in full.params.items()}
        return full

    def restore_view(self, state, view) -> None:
        view = dataclasses.replace(view, params=self._padded(view.params))
        super().restore_view(state, view)

    def _score_block(self, state, uids):
        """(B, I_pad / n_model) scores of the rank's item block, the
        padding columns at -inf (never recommended)."""
        p = state.params
        lo, hi = self.coll.items
        s = (p["ub"][uids][:, None] + p["ib"][None, :]
             + p["uv"][uids] @ p["iv"].t())
        cols = torch.arange(lo, hi, device=s.device)[None, :]
        return torch.where(cols < state.num_items, s, NEG_INF)

    def batch_scores(self, state, uids, rated_items, rated_mask):
        """The whole (B, I) scores on every rank from the item blocks."""
        uids = torch.as_tensor(uids, dtype=torch.long,
                               device=self.device).reshape(-1)
        full = self.coll.model_gather(self._score_block(state, uids), dim=1)
        return full[:, :state.num_items]

    def batch_topk(self, state, uids, rated_items, rated_mask, k: int):
        """Per-block top-k over the rank's rows of the batch and its item
        block, merged over 'model' (parallel/topk.py), the rows gathered
        over 'data': the (B, I) scores are never whole on one device."""
        I = state.num_items
        B, uids, rated = _pad_rows(
            self.mesh.shape["data"], uids,
            (torch.as_tensor(rated_items, dtype=torch.long,
                             device=self.device), I))
        uids = uids.to(self.device)
        sl = self.coll.rows(uids.shape[0])
        ids, _ = distributed_topk_unrated(
            self.mesh, self._score_block(state, uids[sl]), rated[sl], k)
        return self.coll.data_gather(ids)[:B]


# the class began life pairwise-only; keep the original name importable
ShardedPairwiseTP = ShardedMFTP

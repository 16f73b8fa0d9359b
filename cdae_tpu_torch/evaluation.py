"""Batched evaluation (port of cdae_tpu/evaluation.py): RMSE/MAE over
validation (user, item, rating) triples, and top-N (TOPN, RANKING).

RMSE / MAE: the triples in fixed-size batches (the last padded with
weight-0 rows) through the model's ``predict``; each batch's error sum
(squared or absolute) stays on the device, with one readback per
``evaluate`` call.

TOPN / RANKING: validation users are processed in fixed-size batches,
ordered by their train row length so each batch's padded rated rows stay
short. A batch is ranked by the model's ``topk_ids`` (its own
``batch_topk`` when it has one for the catalog size, else full-catalog
``batch_scores`` -> mask rated -> top-10); then per-user metric rows.
Column sums accumulate in float64 on the device, with one readback per
``evaluate`` call, and are divided by the number of validation users.
``TestTime`` is reported as a column.
"""

from __future__ import annotations

import enum
from typing import Dict, Optional

import numpy as np
import torch

from cdae_tpu_torch.data.dataset import Interactions, rows_from_csr
from cdae_tpu_torch.ops import metrics as M
from cdae_tpu_torch.utils.timer import Timer


class EvalType(enum.Enum):
    RMSE = "RMSE"
    MAE = "MAE"
    TOPN = "TOPN"
    RANKING = "RANKING"

    @classmethod
    def parse(cls, name) -> "EvalType":
        if isinstance(name, cls):
            return name
        return cls(str(name).upper())


def _metric_rows(rec, val_items, val_ratings, val_mask, kind: "EvalType",
                 rel_threshold: float) -> torch.Tensor:
    if kind == EvalType.TOPN:
        return M.topn_user_metrics(rec, val_items, val_mask)
    return M.ranking_user_metrics(rec, val_items, val_ratings, val_mask,
                                  rel_threshold)


class Evaluation:
    """Base evaluator; use ``Evaluation.create(kind)``."""

    kind: EvalType
    columns: tuple

    @staticmethod
    def create(kind, batch_size: int = 1024,
               rel_threshold: float = 4.0) -> "Evaluation":
        if isinstance(kind, Evaluation):  # pre-built (e.g. custom threshold)
            return kind
        kind = EvalType.parse(kind)
        if kind in (EvalType.RMSE, EvalType.MAE):
            return PointwiseEvaluation(kind, batch_size)
        return RecListEvaluation(kind, batch_size, rel_threshold)

    def evaluate(self, model, state, validation: Interactions,
                 train: Optional[Interactions] = None) -> Dict[str, float]:
        raise NotImplementedError


def _pointwise_partial(preds, labels, weight, kind: "EvalType"
                       ) -> torch.Tensor:
    """A batch's weighted error sum as a device scalar: squared for RMSE,
    absolute for MAE."""
    err = (preds.to(torch.float32) - labels.to(torch.float32)) * weight
    if kind == EvalType.RMSE:
        return torch.sum(err * err)
    return torch.sum(torch.abs(err))


class PointwiseEvaluation(Evaluation):
    """RMSE / MAE over the validation triples (ref evaluation.hpp:37-91)."""

    def __init__(self, kind, batch_size: int = 4096):
        self.kind = EvalType.parse(kind)
        self.columns = (self.kind.value,)
        self.batch_size = max(int(batch_size), 1)

    def evaluate(self, model, state, validation: Interactions,
                 train: Optional[Interactions] = None) -> Dict[str, float]:
        t = Timer()
        n = len(validation)
        if n == 0:
            return {self.kind.value: 0.0, "TestTime": t.elapsed()}
        total = torch.zeros((), dtype=torch.float64, device=model.device)
        bs = self.batch_size
        for start in range(0, n, bs):
            sel = slice(start, min(start + bs, n))
            users = validation.users[sel]
            items = validation.items[sel]
            labels = validation.ratings[sel]
            pad = bs - len(users)
            weight = np.ones(bs, dtype=np.float32)
            if pad > 0:  # every batch has one shape
                users = np.pad(users, (0, pad))
                items = np.pad(items, (0, pad))
                labels = np.pad(labels, (0, pad))
                weight[bs - pad:] = 0.0
            preds = model.predict(state, users, items)
            total += _pointwise_partial(
                preds, torch.as_tensor(labels, device=model.device),
                torch.as_tensor(weight, device=model.device), self.kind)
        total = float(total)  # the one device sync
        val = np.sqrt(total / n) if self.kind == EvalType.RMSE else total / n
        return {self.kind.value: float(val), "TestTime": t.elapsed()}


class RecListEvaluation(Evaluation):
    """TOPN / RANKING evaluation over length-10 rec lists."""

    def __init__(self, kind, batch_size: int = 1024,
                 rel_threshold: float = 4.0):
        self.kind = EvalType.parse(kind)
        self.rel_threshold = float(rel_threshold)
        self.columns = (
            M.TOPN_COLUMNS if self.kind == EvalType.TOPN
            else M.RANKING_COLUMNS
        )
        self.batch_size = max(int(batch_size), 1)
        self._cache_key = None
        self._cache = None

    def _batches(self, validation: Interactions, train: Interactions,
                 device: torch.device):
        """Device-resident eval batches, built once per (train, validation,
        device): the same datasets are evaluated every cadence. Keyed by
        identity with strong refs, so a collected dataset's id cannot be
        reused to serve stale batches."""
        key = (train, validation, self.batch_size, device)
        if self._cache_key is not None and all(
            a is b or a == b for a, b in zip(self._cache_key, key)
        ):
            return self._cache
        train_csr = train.csr()
        val_csr = validation.csr()
        val_users = np.nonzero(np.diff(val_csr.indptr) > 0)[0].astype(
            np.int32
        )
        # order by train row length: each batch's padded rated rows tighten
        # to its own max (metric sums are order-invariant)
        tl = np.diff(train_csr.indptr)[val_users]
        val_users = val_users[np.argsort(tl, kind="stable")]
        # clamp to the validation population (next pow2): a small fixture
        # must not pad every batch to batch_size rows
        pop = max(len(val_users), 1)
        bs = min(self.batch_size, 1 << (pop - 1).bit_length())
        batches = []
        for start in range(0, len(val_users), bs):
            sel = val_users[start : start + bs]
            pad = bs - len(sel)
            weight = np.ones(bs, dtype=np.float32)
            if pad > 0:
                weight[bs - pad :] = 0.0
                sel = np.concatenate([sel, np.zeros(pad, dtype=sel.dtype)])
            rated_items, _, rated_mask, _ = rows_from_csr(
                train_csr, sel, train.num_items
            )
            val_items, val_ratings, val_mask, _ = rows_from_csr(
                val_csr, sel, validation.num_items
            )
            val_mask = val_mask & (weight[:, None] > 0)
            batches.append((sel,) + tuple(
                torch.as_tensor(x, device=device) for x in (
                    rated_items, rated_mask, val_items, val_ratings, val_mask
                )
            ))
        self._cache_key = key
        self._cache = (len(val_users), batches)
        return self._cache

    def evaluate(self, model, state, validation: Interactions,
                 train: Optional[Interactions] = None) -> Dict[str, float]:
        t = Timer()
        if train is None:
            raise ValueError(
                f"{self.kind.value} evaluation requires train data")
        num_val_users, batches = self._batches(validation, train, model.device)
        if num_val_users == 0:
            out = {c: 0.0 for c in self.columns}
            out["TestTime"] = t.elapsed()
            return out
        if hasattr(model, "pre_recommend"):
            model.pre_recommend(state)  # ref evaluation.hpp:135 hook
        col_sum = torch.zeros(len(self.columns), dtype=torch.float64,
                              device=model.device)
        for (uids, rated_items, rated_mask, val_items, val_ratings,
             val_mask) in batches:
            rec = model.topk_ids(state, uids, rated_items, rated_mask, 10)
            rows = _metric_rows(rec, val_items, val_ratings, val_mask,
                                self.kind, self.rel_threshold)
            col_sum += rows.to(torch.float64).sum(dim=0)
        col_sum = col_sum.cpu().numpy()  # the one device sync
        out = {
            c: float(v / num_val_users) for c, v in zip(self.columns, col_sum)
        }
        out["TestTime"] = t.elapsed()
        return out

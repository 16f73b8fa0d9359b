"""Batched ranking metrics (port of cdae_tpu/ops/metrics.py).

Per-user metric rows over padded lists, in float32 like the JAX version:

  - TOPN:  P@1/5/10, R@1/5/10, MAP@5/10 over a length-10 rec list
  - RANKING: NDCG@5/10 (natural-log discount, 2^rel-1 gains), Prec/Recall
           @5/10 with a relevance threshold, MAP@5/10

Rows of users with no validation items are zero; evaluators divide the
column sums by the number of validation users (``topn_mean``). ``rmse``
and ``mae`` are the pointwise errors of a prediction vector.
"""

from __future__ import annotations

import torch

TOPN_COLUMNS = ("P@1", "P@5", "P@10", "R@1", "R@5", "R@10", "MAP@5", "MAP@10")
RANKING_COLUMNS = (
    "NDCG@5", "NDCG@10", "Prec@5", "Prec@10",
    "Recall@5", "Recall@10", "MAP@5", "MAP@10",
)


def _hits(rec: torch.Tensor, val_items: torch.Tensor,
          val_mask: torch.Tensor) -> torch.Tensor:
    """(B, K, Lv) bool: rec[b, k] equals a valid validation item of b."""
    return (rec[:, :, None] == val_items[:, None, :]) & val_mask[:, None, :]


def topn_user_metrics(
    rec: torch.Tensor,  # (B, 10) int recommended item ids, ranked
    val_items: torch.Tensor,  # (B, Lv) int, padded
    val_mask: torch.Tensor,  # (B, Lv) bool
) -> torch.Tensor:
    """Per-user (B, 8) metric rows in TOPN_COLUMNS order."""
    if rec.shape[1] < 10:
        raise ValueError("TOPN evaluation requires a length-10 rec list")
    f32 = torch.float32
    member = _hits(rec[:, :10], val_items, val_mask).any(dim=-1).to(f32)
    hit_cum = torch.cumsum(member, dim=1)
    nval = val_mask.sum(dim=1).to(f32)
    nval_safe = torch.clamp(nval, min=1.0)

    p1 = hit_cum[:, 0]
    p5 = hit_cum[:, 4] / 5.0
    p10 = hit_cum[:, 9] / 10.0
    r1 = hit_cum[:, 0] / nval_safe
    r5 = hit_cum[:, 4] / nval_safe
    r10 = hit_cum[:, 9] / nval_safe

    ranks = torch.arange(1, 11, dtype=f32, device=rec.device)[None, :]
    prec_at_rank = member * hit_cum / ranks
    map5 = prec_at_rank[:, :5].sum(dim=1) / torch.clamp(nval_safe, max=5.0)
    map10 = prec_at_rank[:, :10].sum(dim=1) / torch.clamp(nval_safe, max=10.0)

    rows = torch.stack([p1, p5, p10, r1, r5, r10, map5, map10], dim=1)
    return rows * (nval > 0).to(f32)[:, None]


def topn_mean(rows: torch.Tensor, val_mask: torch.Tensor) -> torch.Tensor:
    """(8,) mean of per-user rows over the validation users, those with at
    least one validation item (ref evaluation.hpp:160-166)."""
    num_val_users = torch.clamp(
        val_mask.any(dim=1).to(torch.float32).sum(), min=1.0)
    return rows.sum(dim=0) / num_val_users


def ranking_user_metrics(
    rec: torch.Tensor,  # (B, 10) int
    val_items: torch.Tensor,  # (B, Lv) int, padded
    val_ratings: torch.Tensor,  # (B, Lv) float32 relevances
    val_mask: torch.Tensor,  # (B, Lv) bool
    rel_threshold: float = 4.0,
) -> torch.Tensor:
    """Per-user (B, 8) rows in RANKING_COLUMNS order (rel >= threshold
    counts a hit)."""
    f32 = torch.float32
    dev = rec.device
    eq = _hits(rec[:, :10], val_items, val_mask)
    member = eq.any(dim=-1)
    # relevance of each recommended item (0 if not in the validation set)
    rel = torch.where(eq, val_ratings[:, None, :], 0.0).amax(dim=-1)
    rel = torch.clamp(rel, min=0.0)
    nval = val_mask.sum(dim=1).to(f32)

    discount = 1.0 / torch.log(torch.arange(10, dtype=f32, device=dev) + 2.0)
    discount = discount[None, :]
    gains = (torch.exp2(rel) - 1.0) * member.to(f32) * discount
    dcg5 = gains[:, :5].sum(dim=1)
    dcg10 = gains.sum(dim=1)

    # ideal DCG from the validation relevances sorted descending
    sorted_rel = -torch.sort(
        torch.where(val_mask, -val_ratings, float("inf")), dim=1
    ).values[:, :10]
    pad10 = 10 - sorted_rel.shape[1]
    if pad10 > 0:
        sorted_rel = torch.cat(
            [sorted_rel, sorted_rel.new_zeros((sorted_rel.shape[0], pad10))],
            dim=1,
        )
    in_gt = torch.arange(10, dtype=f32, device=dev)[None, :] < nval[:, None]
    igains = ((torch.exp2(torch.where(in_gt, sorted_rel, 0.0)) - 1.0)
              * in_gt * discount)
    idcg5 = igains[:, :5].sum(dim=1)
    idcg10 = igains.sum(dim=1)

    relevant = (member & (rel >= rel_threshold)).to(f32)
    hit_cum = torch.cumsum(relevant, dim=1)
    hit5 = hit_cum[:, 4]
    hit10 = hit_cum[:, 9]
    ranks = torch.arange(1, 11, dtype=f32, device=dev)[None, :]
    prec_at_rank = relevant * hit_cum / ranks
    map5 = prec_at_rank[:, :5].sum(dim=1)
    map10 = prec_at_rank.sum(dim=1)

    num_rels = (val_mask & (val_ratings >= rel_threshold)).to(f32).sum(dim=1)
    has_rel = (num_rels > 0).to(f32)
    num_rels_safe = torch.clamp(num_rels, min=1.0)
    nval_safe = torch.clamp(nval, min=1.0)

    rows = torch.stack(
        [
            dcg5 / torch.clamp(idcg5, min=1e-12),
            dcg10 / torch.clamp(idcg10, min=1e-12),
            hit5 / 5.0,
            hit10 / 10.0,
            has_rel * hit5 / num_rels_safe,
            has_rel * hit10 / num_rels_safe,
            has_rel * map5 / torch.clamp(nval_safe, max=5.0),
            has_rel * map10 / torch.clamp(nval_safe, max=10.0),
        ],
        dim=1,
    )
    return rows * (nval > 0).to(f32)[:, None]


def rmse(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Root-mean-square error (ref evaluation.hpp:46-61)."""
    err = preds - labels
    return torch.sqrt(torch.mean(err * err))


def mae(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean absolute error (ref evaluation.hpp:74-89)."""
    return torch.mean(torch.abs(preds - labels))

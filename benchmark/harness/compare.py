"""The comparisons that decide ``correct``: by leaf for training, by
served list for serving. Each takes the program's readings and the
reference's and returns the numbers a cell compares with its limits."""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np
import torch


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each tensor's 2-norm, summed in float64."""
    return {k: float(torch.linalg.vector_norm(v.to(torch.float64)))
            for k, v in tensors.items()}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   leaves: Iterable[str]) -> float:
    """max over ``leaves`` of |got - want| / max(want, median of want)."""
    med = float(np.median([want[k] for k in want]))
    return max((abs(got[k] - want[k]) / max(want[k], med, 1e-300)
                for k in leaves), default=0.0)


def moved_leaves(want_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient norm is above a thousandth of
    the median leaf's (the others move by round-off alone)."""
    med = float(np.median(list(want_grad.values())))
    return [k for k in want_grad if want_grad[k] > 1e-3 * med]


def training_gaps(got, want) -> Dict[str, float]:
    """The two numbers a training cell compares, from (gradient norms,
    change norms) by leaf of the program (``got``) and of the reference
    (``want``): the worst leaf's gap of gradient norms, and of change norms
    over the moved leaves."""
    return {
        "grad_gap": worst_leaf_gap(got[0], want[0], list(want[0])),
        "change_gap": worst_leaf_gap(got[1], want[1],
                                     moved_leaves(want[0])),
    }


def leaf_gaps(got, want) -> Dict[str, Dict[str, float]]:
    """Each leaf's relative gaps of gradient and change norms (for the
    calibration's records)."""
    return {
        name: {k: abs(got[i][k] - want[i][k]) / max(want[i][k], 1e-300)
               for k in want[i]}
        for i, name in enumerate(("grad", "change"))}


def topk_gaps(scores: torch.Tensor, served: np.ndarray) -> torch.Tensor:
    """Per user, the widest gap by which a served item's reference score
    lies below the reference's score at the same rank of its top-k;
    ``scores`` (B, I) are the reference's with rated items at -inf, so a
    served id that is rated, out of the catalog or repeated reads inf."""
    I = scores.shape[1]
    k = served.shape[1]
    ids = torch.as_tensor(served, dtype=torch.int64, device=scores.device)
    best = torch.topk(scores, k, dim=1).values
    ok = (ids >= 0) & (ids < I)
    got = torch.gather(scores, 1, ids.clamp(0, I - 1))
    got = torch.where(ok, got, float("-inf"))
    srt = torch.sort(ids, dim=1).values
    repeated = (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    gap = (best - got).clamp(min=0.0).amax(dim=1)
    return torch.where(repeated, float("inf"), gap)

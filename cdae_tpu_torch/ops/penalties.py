"""L1/L2 regularization penalties (port of cdae_tpu/ops/penalties.py).

``evaluate`` returns the raw norm of a whole tensor (the squared norm for
L2, the sum of absolute values for L1); models apply their own 0.5*lambda
scaling.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import torch


class PenaltyType(enum.Enum):
    L1 = "L1"
    L2 = "L2"

    @classmethod
    def parse(cls, name: str) -> "PenaltyType":
        return cls(name.upper())


def _l2(mat: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(mat))


def _l1(mat: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(mat))


@dataclasses.dataclass(frozen=True)
class Penalty:
    kind: PenaltyType
    evaluate: Callable
    is_smooth: bool

    @property
    def name(self) -> str:
        return self.kind.value

    @staticmethod
    def create(pt) -> "Penalty":
        if isinstance(pt, str):
            pt = PenaltyType.parse(pt)
        return _REGISTRY[pt]


_REGISTRY = {
    PenaltyType.L2: Penalty(PenaltyType.L2, _l2, True),
    PenaltyType.L1: Penalty(PenaltyType.L1, _l1, False),
}

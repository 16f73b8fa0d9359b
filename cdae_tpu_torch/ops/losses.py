"""Pluggable scalar losses (port of cdae_tpu/ops/losses.py).

Each loss exposes ``evaluate(pred, truth)``, ``gradient(pred, truth)``,
``predict(x)`` and the positive/negative label conventions the training
loops rely on; every function is elementwise over tensors of any shape, and
``truth`` may be a tensor or a Python number.

  loss            positive  negative   saturation guards
  SQUARE            1.        0.       --
  LOGISTIC          1.        0.       eval: log(max(1e-4, .)); grad clips p to
                                       [1e-7, 1 - 1e-7]
  CROSS_ENTROPY     1.        0.       +-18 on the logit, exp capped at +-80
  LOG               1.       -1.       +-18 on z = pred*truth, exp capped at 80
  LOGM              1.       -1.       +-18 on pred, exp capped at 80
  HINGE             1.       -1.       z > 1 -> 0
  SQUARED_HINGE     1.       -1.       z > 1 -> 0

``LossType.parse`` accepts the aliases CE and SQ_HINGE.

Mult-VAE's multinomial log-likelihood is a loss over a whole row of the
catalog, not an elementwise one: ``multinomial_nll`` and
``multinomial_gradient`` below, outside the registry.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import torch


class LossType(enum.Enum):
    SQUARE = "SQUARE"
    LOGISTIC = "LOGISTIC"
    LOG = "LOG"
    HINGE = "HINGE"
    SQUARED_HINGE = "SQUARED_HINGE"
    CROSS_ENTROPY = "CROSS_ENTROPY"
    LOGM = "LOGM"

    @classmethod
    def parse(cls, name: str) -> "LossType":
        name = name.upper()
        aliases = {"CE": "CROSS_ENTROPY", "SQ_HINGE": "SQUARED_HINGE"}
        return cls(aliases.get(name, name))


@dataclasses.dataclass(frozen=True)
class Loss:
    """A loss bundle; create via ``Loss.create(name or LossType)``."""

    kind: LossType
    evaluate: Callable  # (pred, truth) -> loss
    gradient: Callable  # (pred, truth) -> dloss/dpred
    predict: Callable  # raw score -> prediction
    positive_label: float
    negative_label: float

    @property
    def name(self) -> str:
        return self.kind.value

    @staticmethod
    def create(lt) -> "Loss":
        if isinstance(lt, str):
            lt = LossType.parse(lt)
        return _REGISTRY[lt]


def _elementwise(fn):
    """Let ``truth`` be a Python number as well as a tensor."""
    def wrapped(pred, truth):
        return fn(pred, torch.as_tensor(truth, dtype=pred.dtype,
                                        device=pred.device))
    return wrapped


# -- square: l = (y - a)^2 ----------------------------------------------------

def _square_eval(pred, truth):
    err = truth - pred
    return err * err


def _square_grad(pred, truth):
    return -2.0 * (truth - pred)


# -- logistic: l = -y log p - (1-y) log(1-p), p already in (0, 1) ------------

def _logistic_eval(pred, truth):
    p_pos = torch.clamp(pred, min=1e-4)
    p_neg = torch.clamp(1.0 - pred, min=1e-4)
    return torch.where(truth == 1.0, -torch.log(p_pos), -torch.log(p_neg))


def _logistic_grad(pred, truth):
    p = torch.clamp(pred, 1e-7, 1.0 - 1e-7)
    return (p - truth) / (p * (1.0 - p))


# -- cross-entropy on logits: l = (1-y)a + log(1+exp(-a)) ---------------------

def _ce_eval(pred, truth):
    ret = (1.0 - truth) * pred
    mid = torch.log1p(torch.exp(-torch.clamp(pred, -18.0, 18.0)))
    tail = torch.where(pred > 18.0, torch.exp(-torch.clamp(pred, max=80.0)),
                       -pred)
    return ret + torch.where(torch.abs(pred) <= 18.0, mid, tail)


def _ce_grad(pred, truth):
    low = torch.exp(torch.clamp(pred, min=-80.0)) - truth
    high = 1.0 - truth
    mid = 1.0 / (1.0 + torch.exp(-torch.clamp(pred, -18.0, 18.0))) - truth
    return torch.where(pred < -18.0, low, torch.where(pred > 18.0, high, mid))


def _ce_predict(x):
    return 1.0 / (1.0 + torch.exp(-x))


# -- log loss: l = log(1+exp(-a*y)) ------------------------------------------

def _log_eval(pred, truth):
    z = pred * truth
    mid = torch.log1p(torch.exp(-torch.clamp(z, -18.0, 18.0)))
    tail = torch.where(z > 18.0, torch.exp(-torch.clamp(z, max=80.0)), -z)
    return torch.where(torch.abs(z) <= 18.0, mid, tail)


def _log_grad(pred, truth):
    z = pred * truth
    high = -truth * torch.exp(-torch.clamp(z, max=80.0))
    low = -truth
    mid = -truth / (1.0 + torch.exp(torch.clamp(z, -18.0, 18.0)))
    return torch.where(z > 18.0, high, torch.where(z < -18.0, low, mid))


# -- multiplicative log loss: l = y log(1+exp(-a)) ----------------------------

def _logm_eval(pred, truth):
    z = pred
    mid = truth * torch.log1p(torch.exp(-torch.clamp(z, -18.0, 18.0)))
    tail = torch.where(z > 18.0, truth * torch.exp(-torch.clamp(z, max=80.0)),
                       -z * truth)
    return torch.where(torch.abs(z) <= 18.0, mid, tail)


def _logm_grad(pred, truth):
    z = pred
    high = -truth * torch.exp(-torch.clamp(z, max=80.0))
    low = -truth
    mid = -truth / (1.0 + torch.exp(torch.clamp(z, -18.0, 18.0)))
    return torch.where(z > 18.0, high, torch.where(z < -18.0, low, mid))


# -- hinge: l = max(0, 1-a*y) -------------------------------------------------

def _hinge_eval(pred, truth):
    return torch.clamp(1.0 - pred * truth, min=0.0)


def _hinge_grad(pred, truth):
    return torch.where(pred * truth > 1.0, 0.0, -truth)


# -- squared hinge: l = 0.5*max(0, 1-a*y)^2 -----------------------------------

def _sq_hinge_eval(pred, truth):
    d = torch.clamp(1.0 - pred * truth, min=0.0)
    return 0.5 * d * d


def _sq_hinge_grad(pred, truth):
    z = pred * truth
    return torch.where(z > 1.0, 0.0, -truth * (1.0 - z))


def _identity(x):
    return x


def _loss(kind, evaluate, gradient, predict, pos, neg) -> Loss:
    return Loss(kind, _elementwise(evaluate), _elementwise(gradient), predict,
                pos, neg)


_REGISTRY = {
    LossType.SQUARE: _loss(LossType.SQUARE, _square_eval, _square_grad,
                           _identity, 1.0, 0.0),
    LossType.LOGISTIC: _loss(LossType.LOGISTIC, _logistic_eval,
                             _logistic_grad, _identity, 1.0, 0.0),
    LossType.CROSS_ENTROPY: _loss(LossType.CROSS_ENTROPY, _ce_eval, _ce_grad,
                                  _ce_predict, 1.0, 0.0),
    LossType.LOG: _loss(LossType.LOG, _log_eval, _log_grad, _identity,
                        1.0, -1.0),
    LossType.LOGM: _loss(LossType.LOGM, _logm_eval, _logm_grad, _identity,
                         1.0, -1.0),
    LossType.HINGE: _loss(LossType.HINGE, _hinge_eval, _hinge_grad,
                          _identity, 1.0, -1.0),
    LossType.SQUARED_HINGE: _loss(LossType.SQUARED_HINGE, _sq_hinge_eval,
                                  _sq_hinge_grad, _identity, 1.0, -1.0),
}


# -- multinomial log-likelihood over a row: l = -sum_i x_i log softmax(a)_i --

def multinomial_nll(logits: torch.Tensor, items: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """(B,) -sum_i x_i log_softmax(logits)_i of binary rows x given as
    (B, L) rated ``items``, padded (any id; ``mask`` False there)."""
    logp = torch.log_softmax(logits, dim=1)
    at = torch.gather(logp, 1, items.long().clamp(0, logits.shape[1] - 1))
    return -(at * mask).sum(dim=1)


def multinomial_gradient(logits: torch.Tensor, counts: torch.Tensor,
                         rated: torch.Tensor, ones: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """(B, I) d/dlogits of ``scale`` * -sum_i x_i log_softmax(logits)_i for
    binary rows x: scale * (softmax(logits) * |x|_1 - x). ``counts`` (B,)
    holds each row's |x|_1 and ``rated`` (P,) the flat ids b * I + i of its
    ones, each once; ``ones`` is P ones. The softmax's slab is the
    result."""
    d = torch.softmax(logits, dim=1).mul_((counts * scale)[:, None])
    return d.view(-1).index_add_(0, rated, ones, alpha=-scale).view(
        logits.shape)

"""Backtracking (Armijo) line search (port of cdae_tpu/solver/line_search.py;
ref: src/solver/line_search.hpp:11-42).

Unused by any reference model (SURVEY §2d) but part of the solver layer's
public surface: a host-side utility over numpy arrays and any callable
that returns a number (a closure over tensors included).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def line_search(
    f: Callable[[np.ndarray], float],
    x: np.ndarray,
    direction: np.ndarray,
    grad: np.ndarray,
    step0: float = 1.0,
    shrink: float = 0.5,
    c1: float = 1e-4,
    max_iters: int = 50,
    min_step: float = 1e-12,
) -> Tuple[float, float]:
    """Find a step satisfying the Armijo condition
    f(x + t·d) <= f(x) + c1·t·<g, d>; returns (step, f_new).

    Falls back to the smallest tried step if no sufficient decrease is found
    (mirroring the reference's clipped backtracking loop).
    """
    fx = float(f(x))
    slope = float(np.dot(np.ravel(grad), np.ravel(direction)))
    t = step0
    f_new = fx
    for _ in range(max_iters):
        f_new = float(f(x + t * direction))
        if f_new <= fx + c1 * t * slope:
            return t, f_new
        t *= shrink
        if t < min_step:
            break
    return t, f_new

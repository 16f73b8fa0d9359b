"""Host-side randomness (port of cdae_tpu/utils/random.py).

``step_seed``: cdae_tpu splits jax PRNG keys inside its fused epochs; the
port dispatches step by step from Python, so each step's draws come from a
32-bit seed that is a pure host function of the solver seed and the step's
coordinates. A run resumed from a checkpoint's ``step`` replays the
unbroken run's draws, and no random stream is stored.

The global facade (``seed``, ``timed_seed``, ``generator``, ``uniform``,
``uniform_int``, ``normal``, ``shuffle``, ``discrete``): the reference
keeps one process-wide mt19937_64 behind static methods
(src/base/random.hpp:13-82); here, as in cdae_tpu, one process-wide
``np.random.Generator`` for host-side seeding, splits and shuffles, so the
same seed gives cdae_tpu's draws.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finalizer over a 64-bit int."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def step_seed(seed: int, step: int, batch: int, draw: int) -> int:
    """The 32-bit (signed) seed of one train step's draw: a pure function
    of the solver seed, the epoch (``state.step``), the batch index and
    the draw index (CDAE: the corruption; MF: which of the step's draws),
    so a resumed run replays the unbroken run's draws."""
    x = _mix64(seed & _MASK64)
    for v in (step, batch, draw):
        x = _mix64(x ^ (v & _MASK64))
    x >>= 32
    return x - (1 << 32) if x >= (1 << 31) else x


_rng = np.random.default_rng(0)


def seed(n: int) -> None:
    """ref Random::seed (random.hpp:21-23)."""
    global _rng
    _rng = np.random.default_rng(int(n))


def timed_seed() -> None:
    """ref Random::timed_seed (random.hpp:25-28)."""
    seed(time.time_ns() & 0xFFFFFFFF)


def generator() -> np.random.Generator:
    return _rng


def uniform(low: float = 0.0, high: float = 1.0, size=None):
    return _rng.uniform(low, high, size)


def uniform_int(low: int, high: int, size=None):
    """Uniform integer in [low, high) (ref random.hpp:38-44)."""
    return _rng.integers(low, high, size)


def normal(mean: float = 0.0, std: float = 1.0, size=None):
    return _rng.normal(mean, std, size)


def shuffle(x) -> None:
    """In-place shuffle (ref random.hpp:56-60)."""
    _rng.shuffle(x)


def discrete(weights: Sequence[float], size=None):
    """Sample indices proportionally to weights (ref random.hpp:62-73)."""
    w = np.asarray(weights, dtype=np.float64)
    return _rng.choice(len(w), size=size, p=w / w.sum())

"""Host-side random seeds (the counterpart of cdae_tpu/utils/random.py).

cdae_tpu splits jax PRNG keys inside its fused epochs; the port dispatches
step by step from Python, so each step's draws come from a 32-bit seed that
is a pure host function of the solver seed and the step's coordinates.
A run resumed from a checkpoint's ``step`` replays the unbroken run's
draws, and no random stream is stored.
"""

from __future__ import annotations

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

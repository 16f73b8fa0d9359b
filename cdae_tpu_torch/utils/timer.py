"""Wall-clock timer (ref: src/base/timer.hpp:9-38).

The reference Timer reports elapsed milliseconds and is streamable; ours
reports seconds via ``elapsed()`` and formats like the reference when
stringified. ``time_function`` mirrors utils.hpp:85-91.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple, TypeVar

T = TypeVar("T")


class Timer:
    def __init__(self):
        self._start = time.perf_counter()

    def reset(self) -> None:
        self._start = time.perf_counter()

    def elapsed(self) -> float:
        """Elapsed wall-clock seconds since construction/reset."""
        return time.perf_counter() - self._start

    def __str__(self) -> str:
        return f"{self.elapsed():.3f}s"


def time_function(fn: Callable[[], T]) -> Tuple[T, float]:
    """Run ``fn`` and return (result, elapsed_seconds)."""
    t = Timer()
    out = fn()
    return out, t.elapsed()

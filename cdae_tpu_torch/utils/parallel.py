"""Host-side parallel primitives (port of cdae_tpu/utils/parallel.py; ref:
src/base/parallel/parallel_lambda.hpp).

The host-side equivalents of the reference's thread helpers, for IO and
preprocessing work that stays off the device:

  in_parallel(fn)            — fn(tid, nthreads) on every worker
                               (ref parallel_lambda.hpp:36-58)
  parallel_for(s, e, fn)     — static range split (ref :70-82)
  parallel_for_each(xs, fn)  — static item split (ref :93-104)
  dynamic_parallel_for(...)  — work-queue scheduling (ref :189-212)
  parallel_accumulate(...)   — map + sum reduction (ref :126-187)

All verified against their serial counterparts (the reference's de-facto
race-detection strategy, test/parallel_test.hpp:45-48).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Sequence, TypeVar

T = TypeVar("T")


def num_hardware_threads() -> int:
    """ref parallel.hpp:18-23 (capped at local cores)."""
    return os.cpu_count() or 1


def in_parallel(fn: Callable[[int, int], None],
                num_threads: int = 0) -> None:
    n = num_threads or num_hardware_threads()
    with ThreadPoolExecutor(max_workers=n) as ex:
        list(ex.map(lambda tid: fn(tid, n), range(n)))


def parallel_for(start: int, end: int, fn: Callable[[int], None],
                 num_threads: int = 0) -> None:
    n = num_threads or num_hardware_threads()

    def worker(tid: int, nthreads: int) -> None:
        total = end - start
        chunk = (total + nthreads - 1) // nthreads
        lo = start + tid * chunk
        hi = min(lo + chunk, end)
        for i in range(lo, hi):
            fn(i)

    in_parallel(worker, n)


def parallel_for_each(items: Sequence[T], fn: Callable[[T], None],
                      num_threads: int = 0) -> None:
    parallel_for(0, len(items), lambda i: fn(items[i]), num_threads)


def dynamic_parallel_for(start: int, end: int, fn: Callable[[int], None],
                         num_threads: int = 0) -> None:
    """Work-queue scheduling (ref parallel_lambda.hpp:189-212).

    Routes through the NATIVE dynamic pool (csrc cdae_dynamic_parallel_for
    — C threads pulling chunks off an atomic counter, the reference
    ThreadPool's semantics) when the library is present; otherwise a
    ThreadPoolExecutor queue. Either way the BODY runs under the GIL unless
    it releases it (numpy/IO) — for CPU-bound pure-Python work this gives
    scheduling parity, not speedup (the native data paths — text parsing,
    CSR builds — run fully native instead)."""
    if end <= start:
        return
    from cdae_tpu_torch import _native

    def chunk(lo: int, hi: int) -> None:
        for i in range(lo, hi):
            fn(i)

    n = num_threads or num_hardware_threads()
    grain = max(1, (end - start) // (8 * n))
    if _native.dynamic_parallel_for(start, end, chunk, grain=grain,
                                    num_threads=n):
        return
    with ThreadPoolExecutor(max_workers=n) as ex:
        list(ex.map(fn, range(start, end)))


def parallel_accumulate(start: int, end: int, fn: Callable[[int], float],
                        init: float = 0.0, num_threads: int = 0) -> float:
    """Σ fn(i) (ref parallel_accumulate_and_reduce, :157-187)."""
    n = num_threads or num_hardware_threads()
    partials: List[float] = [0.0] * n

    def worker(tid: int, nthreads: int) -> None:
        total = end - start
        chunk = (total + nthreads - 1) // nthreads
        lo = start + tid * chunk
        hi = min(lo + chunk, end)
        acc = 0.0
        for i in range(lo, hi):
            acc += fn(i)
        partials[tid] = acc

    in_parallel(worker, n)
    return init + sum(partials)

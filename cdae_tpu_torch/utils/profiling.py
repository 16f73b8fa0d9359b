"""Tracing of the port: named spans, set-up phases, counters and the
device trace (port of cdae_tpu/utils/profiling.py, on torch.profiler).

``span(name)`` marks a stretch of the hot path (a step, a request, a
phase of either). With no torch profiler running it returns one shared
no-op context: it reads no clock, allocates nothing and touches no device.
With one running it opens a range in the profiler's trace (``_range``), so
the span lands there on the same clock as the device's kernels, and adds
one call and its host seconds to an in-memory tally. Spans nest by the
calling thread's order, which gives each its parent.

``phase(name)`` marks one-shot set-up work (building the CSR, the padded
rows, the device batches): it always tallies, and opens a range too when a
profiler runs. ``count(name, n)`` is a counter, gated like ``span``.
``tallies()`` reads both; ``reset_tallies()`` clears them.

Nothing here synchronises the device or reads a device value: a span's
seconds are the host's (for a step, the time to enqueue its work).

``trace(dir)`` records the CPU and, where there is one, the CUDA timeline
of its body and writes it as a Chrome trace, ``<dir>/trace.json``
(chrome://tracing or Perfetto opens it), spans included. An empty ``dir``
makes it a no-op, so the solver can always enter it.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()  # the one no-op context of every span
# torch's C++ range, a host event of the trace like a torch op: ~1 us a
# range on an H100's host, against ~11 us for ``record_function`` (PERF.md)
_range = torch._C._profiler._RecordFunctionFast
_lock = threading.Lock()
_spans: Dict[str, Tuple[int, float]] = {}  # name -> (calls, host seconds)
_counters: Dict[str, int] = {}


class Tallies(NamedTuple):
    spans: Dict[str, Tuple[int, float]]  # name -> (calls, host seconds)
    counters: Dict[str, int]


def profiler_active() -> bool:
    """Whether a torch profiler is recording: the flag torch keeps for
    this check, set while any ``torch.profiler.profile`` (or the autograd
    profiler) runs."""
    return _autograd_profiler._is_profiler_enabled


def _add(name: str, seconds: float) -> None:
    with _lock:
        calls, total = _spans.get(name, (0, 0.0))
        _spans[name] = (calls + 1, total + seconds)


class _Span:
    """A range in the profiler's trace and one tallied call."""

    __slots__ = ("_name", "_rf", "_t0")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        self._rf = _range(self._name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        self._rf.__exit__(*exc)
        _add(self._name, seconds)
        return False


def span(name: str):
    """``with span(name):`` a traced and tallied stretch of the hot path
    while a profiler runs; otherwise the shared no-op context."""
    if not profiler_active():
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """``with phase(name):`` (or ``@phase(name)``) one-shot set-up work:
    always tallied, and a range in the trace while a profiler runs."""
    with _range(name) if profiler_active() else _OFF:
        t0 = time.perf_counter()
        yield
        _add(name, time.perf_counter() - t0)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while a profiler runs."""
    if not profiler_active():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def tallies() -> Tallies:
    """A copy of the spans' (calls, host seconds) and the counters."""
    with _lock:
        return Tallies(dict(_spans), dict(_counters))


def reset_tallies() -> None:
    with _lock:
        _spans.clear()
        _counters.clear()


@contextlib.contextmanager
def trace(trace_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace of the body into ``trace_dir``; no-op when
    ``trace_dir`` is falsy. The device is synchronised before the
    profiler stops, so the trace holds the body's last kernels."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    on_cuda = torch.cuda.is_available()
    if on_cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if on_cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

"""Reading the device trace, and the census of the hand kernels' calls.

``profile(fn)`` runs ``fn`` under torch.profiler and reduces its events
to a ``Trace``: the device's busy intervals (kernels, copies and sets, as
a union), kernel counts and time by kernel name, the idle gaps between
device work with the innermost host event that was running across each,
and the host-side window.

``Census`` records, with ``sys.setprofile``, every call of the program's
kernel wrappers that ``counts.KERNELS`` knows (decode_scores, hw_uniform,
the AdaGrad list launch, B8's plan and reduce, ...) with its arguments'
shapes turned into a least time. The census runs outside the traced
stretch, over the same units, so that the hook's cost is not in the
trace.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

from benchmark.harness import counts


def kernel_base_name(name: str) -> str:
    """A CUDA kernel's function name without namespace, template
    arguments or parameters: '(anonymous namespace)::f<4>(float*)' -> 'f'."""
    n = name.replace("(anonymous namespace)::", "")
    n = re.sub(r"^void ", "", n)
    n = re.split(r"[(<]", n, maxsplit=1)[0]
    return n.rsplit("::", 1)[-1].strip()


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclasses.dataclass
class Trace:
    window_s: float  # host clock over the traced stretch
    busy_s: float  # union of device operations inside it
    kernels: int  # kernel launches (copies and sets not counted)
    device_s_by_name: Dict[str, float]  # full names of device operations
    kernel_s_by_base: Dict[str, float]  # by kernel_base_name
    idle_by_host: Dict[str, float]  # idle device seconds by host activity

    def device_ops(self, n: int = 10) -> List[list]:
        top = sorted(self.device_s_by_name.items(), key=lambda kv: -kv[1])
        return [[k[:120], v] for k, v in top[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        top = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])
        return [[k[:120], v] for k, v in top[:n]]


def innermost_at(host: List[Tuple[float, float, str]],
                 times: List[float]) -> List[Optional[str]]:
    """For each of ``times``, the name of the innermost of the ``host``
    events (start, end, name; one thread's, so nested) that spans it, or
    None: one sweep over the events and the sorted times."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out: List[Optional[str]] = [None] * len(times)
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[q] = stack[-1][2] if stack else None
    return out


def reduce_events(dev: List[Tuple[float, float, str, bool]],
                  host: List[Tuple[float, float, str]],
                  window_us: Tuple[float, float], window_s: float) -> Trace:
    """A ``Trace`` from device operations (start, end, name, is a kernel)
    and one thread's host events (start, end, name), in the profiler's
    microseconds, over the host window [start, end]."""
    lo, hi = window_us
    dev = [(max(s, lo), min(e, hi), n, k) for s, e, n, k in dev]
    dev = [d for d in dev if d[1] > d[0]]
    by_name: Dict[str, float] = {}
    by_base: Dict[str, float] = {}
    kernels = 0
    for s, e, name, is_kernel in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        if is_kernel:
            kernels += 1
            base = kernel_base_name(name)
            by_base[base] = by_base.get(base, 0.0) + (e - s) * 1e-6
    busy = _union([(s, e) for s, e, _, _ in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    # idle gaps inside the window, each named by the innermost host event
    # spanning its middle
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    names = innermost_at(host, [0.5 * (s + e) for s, e in gaps])
    idle: Dict[str, float] = {}
    for (s, e), name in zip(gaps, names):
        key = name or "host: outside any recorded event"
        idle[key] = idle.get(key, 0.0) + (e - s) * 1e-6
    return Trace(window_s=window_s, busy_s=busy_s, kernels=kernels,
                 device_s_by_name=by_name, kernel_s_by_base=by_base,
                 idle_by_host=idle)


DEVICE_CATS = {"kernel": True, "gpu_memcpy": False, "gpu_memset": False}


def chrome_events(trace_events: list, span: str = "bench.traced"):
    """(device operations, host events of the span's thread, the span's
    window) from a chrome trace's ``traceEvents``, as ``reduce_events``
    takes them. Device-side copies of host spans
    (``gpu_user_annotation``) are no device work and are left out."""
    mark = next(e for e in trace_events if e.get("name") == span
                and e.get("cat") == "user_annotation")
    tid = mark["tid"]
    dev, host = [], []
    for e in trace_events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((s, s + d, e["name"], DEVICE_CATS[cat]))
        elif e.get("tid") == tid and not str(cat).startswith("gpu_"):
            host.append((s, s + d, e["name"]))
    return dev, host, (float(mark["ts"]), float(mark["ts"]) + float(
        mark["dur"]))


def profile(fn: Callable[[], None], sync: Callable[[], None]) -> Trace:
    """Run ``fn`` once under torch.profiler (host and CUDA activity),
    inside a ``bench.traced`` span, and reduce its trace (written to a
    temporary file under TMPDIR and read back: much faster than the
    profiler's own event objects)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with tprofile(activities=acts) as prof:
        with torch.profiler.record_function("bench.traced"):
            t0 = time.perf_counter()
            fn()
            sync()
            wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev, host, window = chrome_events(events)
    return reduce_events(dev, host, window, wall)


class Census:
    """Least times of the counted kernel wrappers' calls while active
    (``with census:``), summed by the wrapper's kernels."""

    def __init__(self):
        from cdae_tpu_torch.ops import cdae_fused, pallas_kernels

        self._codes = {}
        for mod in (pallas_kernels, cdae_fused):
            for name in counts.KERNELS:
                fn = getattr(mod, name, None)
                if fn is not None and hasattr(fn, "__code__"):
                    self._codes[fn.__code__] = name
        self.least_s: Dict[str, float] = {}  # wrapper -> summed least time
        self.calls: Dict[str, int] = {}
        self._prev = None

    def _hook(self, frame, event, arg):
        if event == "call":
            name = self._codes.get(frame.f_code)
            if name is not None:
                least = counts.call_least_seconds(name, dict(frame.f_locals))
                self.least_s[name] = self.least_s.get(name, 0.0) + least
                self.calls[name] = self.calls.get(name, 0) + 1
        if self._prev is not None:
            self._prev(frame, event, arg)

    def __enter__(self):
        self._prev = sys.getprofile()
        sys.setprofile(self._hook)
        return self

    def __exit__(self, *exc):
        sys.setprofile(self._prev)
        return False


def kernel_roofline(census_least_s: Dict[str, float], repeats: float,
                    trace: Trace) -> Optional[float]:
    """Share (%) of the counted kernels' device time that their least time
    makes up: ``repeats`` times the census's least time over the traced
    device time of the same kernels. None where none of them ran."""
    names = {k for w in census_least_s
             for k in counts.KERNELS[w][1]}
    device = sum(trace.kernel_s_by_base.get(k, 0.0) for k in names)
    least = repeats * sum(census_least_s.values())
    if device <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / device

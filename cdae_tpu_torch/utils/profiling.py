"""Device tracing (port of cdae_tpu/utils/profiling.py, on torch.profiler).

``trace(dir)`` records the CPU and, where there is one, the CUDA timeline
of its body and writes it as a Chrome trace, ``<dir>/trace.json``
(chrome://tracing or Perfetto opens it). An empty ``dir`` makes it a no-op,
so the solver can always enter it.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(trace_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace of the body into ``trace_dir``; no-op when
    ``trace_dir`` is falsy."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

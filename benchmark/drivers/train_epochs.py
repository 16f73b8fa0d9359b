"""Traffic driver ``train_epochs``: whole training units (epochs) of the
configuration's model, one after another, with no evaluation in the
window.

Set-up runs the first unit (every batch shape, so also the warm-up) and
reads from the state it leaves the numbers the check compares. The window
runs whole units until ``seconds`` have passed; the rate is every user of
every completed unit over the whole window. Traffic parameters:
``trace_seconds``, the length of the traced stretch.
"""

from __future__ import annotations

import math
import time
from typing import Dict

import torch

from benchmark.harness import compare


class Driver:
    kind = "train"

    def __init__(self, ctx):
        self.ctx = ctx  # runner.Context
        self.model = ctx.adapter

    def _unit(self) -> None:
        with torch.profiler.record_function("bench.epoch"):
            self.model.train_unit(self.ctx)

    def setup(self) -> None:
        c, m = self.ctx, self.model
        before = m.snapshot(c)
        c.log("bench: state built; first epoch")
        self._unit()
        c.sync()
        self.program = m.program_readings(c, before)
        del before
        self.steps_per_unit = m.steps_per_unit(c)
        self.unit_flops = m.unit_flops(c)

    def window(self, seconds: float) -> Dict:
        c = self.ctx
        units = 0
        marks = []
        t0 = time.perf_counter()
        while True:
            self._unit()
            units += 1
            marks.append(time.perf_counter() - t0)
            if marks[-1] >= seconds:
                break
        c.sync()
        wall = time.perf_counter() - t0
        c.log("bench: epochs end (host clock, s): "
              + " ".join(f"{m:.4f}" for m in marks))
        self.unit_s = wall / units
        return dict(wall=wall, units=units * self.steps_per_unit,
                    failed=0, flops=units * self.unit_flops,
                    metrics={"train_users_per_s":
                             units * c.num_users / wall})

    def traced(self, seconds: float):
        self.traced_units = max(1, math.ceil(seconds / self.unit_s))
        return (lambda: [self._unit() for _ in range(self.traced_units)],
                self.traced_units * self.steps_per_unit)

    def census_run(self) -> float:
        """One unit (under the census); the traced stretch repeats it."""
        self._unit()
        self.ctx.sync()
        return float(self.traced_units)

    def reference(self, device, **kw):
        """The reference's readings (``kw``: the model's faults and
        precision)."""
        return self.model.reference_readings(self.ctx, device, **kw)

    def check(self, device) -> Dict[str, float]:
        return compare.training_gaps(self.program, self.reference(device))

"""On the card, at each cell's own size: the control (the plain
reference in the program's place, the operands of its products rounded to
TF32) and, for the training cells, the planted fault of half of each batch
left out, each fail at least one of the cell's limits, while the program
on the same seed passes. Run with ``python -m pytest benchmark/tests -m
cuda`` on the card; skipped elsewhere."""

import pytest

from benchmark.calibrate import readings
from benchmark.harness import spec

CELLS = ("cdae_ml20m.train", "cdae_ml10m.train", "cdae_ml20m.serve_batch",
         "cdae_ml20m.serve_online")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_fault_fail_the_limits(cell, cuda):
    limits = spec.load_cell(cell).limits
    rows = {r["who"]: r for r in readings(cell, 2**31 + 321, control=True,
                                          window=2.0, device="cuda")}

    def fails(row):
        return any(row[k] > limit for k, limit in limits.items())

    assert not fails(rows["program"]), rows["program"]
    assert fails(rows["control_tf32"]), rows["control_tf32"]
    if "fault_half_batch" in rows:
        assert fails(rows["fault_half_batch"])

"""Readings that the correctness limits of a cell are set from, on the
card at the cell's own size (a measurement tool; the benchmark's runs do
not call it).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--witness-seeds 7,8] \\
        [--witness cpu | --witness '{"cdae": {"fused_step": true}}'] \\
        [--window 2]

Every row judges something in the program's place against the reference
on the card in float32, exactly as a run compares (training: the first
epoch's readings; serving: the answers of a ``--window``-second window at
the cell's load):

- ``program``: the program (each seed of every list);
- ``control_tf32`` (``--control-seeds``): the reference in the precision
  below float32, its products' operands rounded to TF32;
- ``fault_half_batch`` (training, ``--control-seeds``): the reference
  with half of each batch left out;
- ``reference_again`` (training, ``--control-seeds``): the reference a
  second time, a witness of its own run-to-run rounding (its
  ``index_add_`` sums run in no fixed order);
- ``witness_cpu`` / ``witness_config`` (training, ``--witness-seeds``):
  another sound order of the same sums, the reference on the CPU or the
  program with the configuration changed as ``--witness`` says (an
  option of the program that computes the same step another way).

One JSON line a row; a training row also gives each leaf's gaps
(``leaves``).
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import compare, runner, spec  # noqa: E402


def _program(cell, seed, dev, window, log):
    """The program's run up to the check: set-up and, for serving, a
    window; the program released. Returns the driver."""
    ctx, driver = runner.prepare(cell, seed, dev, log)
    driver.setup()
    if driver.kind == "serve":
        driver.window(window)
    ctx.sync()
    runner.release(ctx)
    return driver


def _train_row(who, got, want) -> dict:
    return dict(who=who, **compare.training_gaps(got, want),
                leaves=dict(**compare.leaf_gaps(got, want),
                            want_grad=want[0], want_change=want[1],
                            moved=compare.moved_leaves(want[0])))


def readings(name: str, seed: int, control: bool = False,
             witness: str = "", window: float = 2.0, device: str = "cuda",
             overrides=None, log=None) -> list:
    """The JSON rows of one seed: the program's readings, with
    ``control`` the control's and (training) the fault's and the
    reference's again, with ``witness`` ('cpu', or a JSON object of
    configuration sections) the witness's."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = spec.load_cell(name, overrides=overrides)
    dev = torch.device(device)
    t0 = time.perf_counter()
    driver = _program(cell, seed, dev, window, log)
    train = driver.kind == "train"
    rows = []
    with runner.tf32_off():
        if train:
            want = driver.reference(dev)
            rows.append(_train_row("program", driver.program, want))
        else:
            rows.append(dict(who="program", **driver.check(dev)))
        if control and train:
            rows.append(_train_row("control_tf32",
                                   driver.reference(dev, tf32=True), want))
            rows.append(_train_row("reference_again", driver.reference(dev),
                                   want))
            rows.append(_train_row("fault_half_batch",
                                   driver.reference(dev, drop_half=True),
                                   want))
        elif control:
            lists = driver.reference_lists(dev, tf32=True)
            rows.append(dict(who="control_tf32",
                             **driver.check(dev, served=lists)))
        if witness == "cpu" and train:
            rows.append(_train_row("witness_cpu",
                                   driver.reference(torch.device("cpu")),
                                   want))
        elif witness and train:
            extra = json.loads(witness)
            merged = {**(overrides or {})}
            for section, values in extra.items():
                merged[section] = {**merged.get(section, {}), **values}
            other = _program(spec.load_cell(name, overrides=merged), seed,
                             dev, window, log)
            rows.append(dict(_train_row("witness_config", other.program,
                                        want), config=extra))
    for r in rows:
        r.update(workload=name, seed=seed,
                 seconds=round(time.perf_counter() - t0, 3))
    return rows


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--witness", default="cpu")
    ap.add_argument("--window", type=float, default=2.0)
    args = ap.parse_args()

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    control, witness = seeds(args.control_seeds), seeds(args.witness_seeds)
    every = list(dict.fromkeys(seeds(args.seeds) + control + witness))
    for seed in every:
        for row in readings(args.workload, seed, control=seed in control,
                            witness=args.witness if seed in witness else "",
                            window=args.window):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

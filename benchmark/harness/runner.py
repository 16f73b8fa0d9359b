"""One run of one cell: set-up, the measured window, the traced stretch
(``trace``), the correctness check, and the result line.

Set-up makes the data from the seed on the device, lets the
configuration's model module (``models/<model>.py``) build the program
from it with the benchmark's seeded weights, then lets the traffic's
driver (``drivers/<driver>.py``) warm up. ``setup_s`` runs from the
process's start to the window's first unit. The window runs the driver
for ``seconds``; a traced run then profiles a short stretch of the same
units and takes a census of the hand kernels' calls over them. After the
device's peak memory is read and the program's state released, the
driver compares what the window produced with the plain reference; each
number compared is printed beside its limit.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np

from benchmark.harness import generator, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "cdae_tpu")


@dataclasses.dataclass
class Context:
    """What the model module and the driver work on."""

    config: dict
    traffic: dict
    seed: int
    device: object  # torch.device of the run
    adapter: object  # the configuration's models/<model>.py
    users: np.ndarray  # the training pairs the benchmark made
    items: np.ndarray
    lengths: np.ndarray  # training items per user
    num_users: int
    num_items: int
    sync: Callable[[], None]
    log: Callable[[str], None]
    program: object = None  # what the model module built; None once freed


@dataclasses.dataclass
class TraceContext:
    """What a per-layer metric reader reads."""

    kind: str  # the driver's: "train" or "serve"
    trace: object  # trace.Trace of the traced stretch
    units: int  # steps or requests in the traced stretch
    roofline: Optional[float]  # the counted kernels' share, %
    window_s: float  # the untraced window of the same run
    window_flops: float  # needed FLOPs of its completed units
    window_metrics: Dict[str, float]  # its end-to-end readings


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def prepare(cell: "spec.Cell", seed: int, dev, log) -> tuple:
    """The seeded data, the program built from it by the configuration's
    model module, and the cell's driver (not yet set up)."""
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    data = cell.config["data"]
    users, items = generator.synthetic_train(data, seed, dev)
    log(f"bench: data made, {len(users)} training pairs")
    U, I = int(data["num_users"]), int(data["num_items"])
    ctx = Context(config=cell.config, traffic=cell.traffic, seed=seed,
                  device=dev,
                  adapter=spec.load_module("models", cell.config["model"]),
                  users=users, items=items,
                  lengths=np.bincount(users, minlength=U),
                  num_users=U, num_items=I, sync=sync, log=log)
    ctx.program = ctx.adapter.build(ctx)
    driver = spec.load_module("drivers", cell.traffic["driver"]).Driver(ctx)
    return ctx, driver


def release(ctx: Context) -> None:
    """Drop the program and return the device memory it held."""
    import torch

    ctx.program = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class tf32_off:
    """``with tf32_off():`` float32 products of the backend with TF32 off,
    as the reference runs (its control rounds explicitly instead)."""

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        import torch

        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             overrides: Optional[dict] = None, log=None) -> Dict:
    """Run cell ``name`` once and return its result object (the keys of
    the result line). ``device`` and ``overrides`` are for tests on the
    CPU; a run of the benchmark takes the card and the files as they
    are."""
    import torch

    from benchmark.harness import trace as tr

    if log is None:
        def log(msg):
            print(f"[{time.perf_counter() - t_start:8.3f}] {msg}",
                  file=sys.stderr, flush=True)
    cell = spec.load_cell(name, overrides=overrides)
    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    ctx, driver = prepare(cell, seed, dev, log)
    sync = ctx.sync
    driver.setup()
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"bench: {name} seed {seed}: set-up {setup_s:.3f} s")

    win = driver.window(seconds)
    log(f"bench: window {win['wall']:.3f} s, {win['units']} units")
    result: Dict = {"correct": False, "attempted": int(win["units"]),
                    "failed": int(win["failed"])}
    device_info: Dict = {
        "platform": "gpu" if on_cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
        "count": 1,
    }
    if trace:
        stretch, units = driver.traced(float(cell.traffic["trace_seconds"]))
        tstats = tr.profile(stretch, sync)
        census = tr.Census()
        with census:
            repeats = driver.census_run()
        tctx = TraceContext(
            kind=driver.kind, trace=tstats, units=units,
            roofline=tr.kernel_roofline(census.least_s, repeats, tstats),
            window_s=win["wall"], window_flops=win["flops"],
            window_metrics=win["metrics"])
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(tctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=tstats.busy_s, window_s=tstats.window_s)
        result["breakdown"] = {"device_ops": tstats.device_ops(),
                               "idle_gaps": tstats.idle_gaps()}
        limit = _power_limit() if on_cuda else None
        log(f"bench: card and power limit: {limit}; census calls "
            f"{census.calls}")
    else:
        metrics = {m["name"]: {"value": win["metrics"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    sync()
    device_info["memory_peak_bytes"] = (
        int(torch.cuda.max_memory_allocated(dev)) if on_cuda else 0)

    # the program's state goes before the reference runs
    release(ctx)
    log("bench: program released; reference check")
    with tf32_off():
        readings = driver.check(dev)
    checks = {k: {"value": readings[k], "limit": cell.limits[k]}
              for k in cell.limits}
    result["correct"] = all(np.isfinite(c["value"])
                            and c["value"] <= c["limit"]
                            for c in checks.values())
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = checks
    log("bench: check done")
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("bench: torch.cuda.is_available() is False; this benchmark "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"bench: {cell.chips} cards wanted, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        print(f"bench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 3
    # "checks" stays the last key of the line
    print(json.dumps(result), flush=True)
    return 0

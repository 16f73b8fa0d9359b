"""Find a cell and everything it names by the names in BENCHMARK.json.

A cell names a configuration (``configs/<config>.json``, via the
configuration entry's ``file``) and a traffic mix
(``traffic/<traffic>.json``); its correctness limits are
``limits/<cell>.json``. The files name the code that serves them, each a
module found by name:

- the configuration's ``model``: ``models/<model>.py``, which builds the
  program from the seeded data, drives and reads it, and judges it against
  the plain reference at the path in the configuration's ``reference``;
- its ``data`` section's ``degree_law`` and ``popularity_law``:
  ``laws/<law>.py``, which the one generator reads;
- the traffic mix's ``driver``: ``drivers/<driver>.py``, what the window
  drives, with the mix's parameters;
- each per-layer metric: ``metrics/<metric>.py``, or for a name with a
  dot whose own file is absent, ``metrics/<name before the dot>.py``.

Adding any of them adds files and entries only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

_MODULES: Dict[Path, object] = {}


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # the configuration file's content
    traffic: dict  # the traffic file's content
    limits: Dict[str, float]  # number compared -> its limit
    chips: int
    end_to_end: List[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def load_path(path) -> object:
    """The Python file at ``path`` (relative to the checkout's root or
    absolute) as a module, loaded once."""
    path = (ROOT / path).resolve()
    if path not in _MODULES:
        rel = path.relative_to(BENCH_DIR).with_suffix("")
        mod_spec = importlib.util.spec_from_file_location(
            "benchmark_" + "_".join(rel.parts).replace(".", "_"), path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def load_module(folder: str, name: str) -> object:
    """``benchmark/<folder>/<name>.py``."""
    path = BENCH_DIR / folder / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {folder} named {name!r}: {path}")
    return load_path(path)


def metric_reader(name: str):
    """The ``read`` of metric ``name``: ``metrics/<name>.py``, else the
    reader of the name before its first dot."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = BENCH_DIR / "metrics" / f"{name.split('.', 1)[0]}.py"
    return load_path(path).read


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json",
              overrides: dict = None) -> Cell:
    """The cell ``name`` of ``bench_file``. ``overrides`` (tests and the
    calibration) merges into the configuration's sections, e.g. a smaller
    ``data``."""
    spec = json.loads(Path(bench_file).read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {bench_file}")
    cfg_entry = next(c for c in spec["configs"]
                     if c["name"] == entry["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    for section, values in (overrides or {}).items():
        config[section] = {**config.get(section, {}), **values}
    traffic = json.loads(
        (BENCH_DIR / "traffic" / f"{entry['traffic']}.json").read_text())
    limits = json.loads((BENCH_DIR / "limits" / f"{name}.json").read_text())
    return Cell(
        name=name, config=config, traffic=traffic,
        limits={k: float(v["limit"]) for k, v in limits.items()},
        chips=int(entry["chips"]),
        end_to_end=[m for m in spec["end_to_end"] if _reported_in(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reported_in(m, name)],
    )

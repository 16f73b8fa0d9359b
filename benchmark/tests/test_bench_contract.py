"""BENCHMARK.json's names, units and files, and what the benchmark
imports."""

import ast
import json
import re
from pathlib import Path

import pytest

from benchmark.harness import spec

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/")
        assert ".." not in word
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_keys_names_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = set(e) - ENTRY_KEYS[section] - {"workloads"}
        assert ENTRY_KEYS[section] <= set(e) and not extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                              "higher")
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end":
                assert LINE.match(e[key]), (e["name"], key)


def test_cells_configs_metrics_are_consistent():
    configs = {c["name"]: c for c in BENCH["configs"]}
    cells = {w["name"]: w for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    pairs = {(w["config"], w["traffic"]) for w in cells.values()}
    assert len(pairs) == len(cells)
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(
        1, len(cells) // 4)
    for w in cells.values():
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (spec.BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists()
        traffic = spec.load_cell(w["name"]).traffic
        assert (spec.BENCH_DIR / "drivers"
                / f"{traffic['driver']}.py").exists()
        assert (spec.BENCH_DIR / "limits" / f"{w['name']}.json").exists()
        cell = spec.load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, w["name"]
    for c in configs.values():
        f = ROOT / c["file"]
        assert f.exists() and c["file"].startswith("benchmark/")
        config = json.loads(f.read_text())
        assert (spec.BENCH_DIR / "models" / f"{config['model']}.py").exists()
        assert (ROOT / config["reference"]).exists()
        assert config["reference"].startswith("benchmark/reference/")
        for law in ("degree_law", "popularity_law"):
            assert (spec.BENCH_DIR / "laws"
                    / f"{config['data'][law]}.py").exists()
        assert len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in cells.values())
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert callable(spec.metric_reader(m["name"]))
        for cell_name in m.get("workloads", cells):
            cell = spec.load_cell(cell_name)
            assert m["moves"] in {x["name"] for x in cell.end_to_end}
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())  # one spelling each


def test_roofline_and_mfu_names():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    for path in spec.BENCH_DIR.rglob("*.py"):
        for top in _imports(path):
            assert top not in ("jax", "jaxlib", "flax", "cdae_tpu"), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (spec.BENCH_DIR / "reference").rglob("*.py"):
        for top in _imports(path):
            assert top in ("__future__", "typing", "numpy", "torch"), (
                path, top)

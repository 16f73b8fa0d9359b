"""The command as the driver runs it: without a card, or without the
program beside it, it exits non-zero and prints no result; a run loads
nothing of JAX or the JAX package."""

import os
import shutil
import subprocess
import sys

from benchmark.harness import spec

ARGS = ["benchmark/run.py", "--workload", "cdae_ml20m.train", "--seed",
        "2147483700", "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_exits_nonzero_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(spec.ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_with_only_the_benchmarks_files_exits_nonzero(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_run_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, '.')\n"
        "from benchmark.harness import runner\n"
        "from benchmark.tests.conftest import SMALL\n"
        "r = runner.run_cell('cdae_ml10m.train', 7, 0.2, False, "
        "time.perf_counter(), device='cpu', overrides=SMALL, "
        "log=lambda m: None)\n"
        "print(r['correct'], runner.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"

"""cdae_tpu_torch stands alone: it imports with jax blocked, it never moves
a CUDA request onto the CPU, and its prepare/split tasks write the caches
cdae_tpu's tasks write."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import pkgutil, importlib, cdae_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cdae_tpu_torch.__path__,
                                               "cdae_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules if m == "cdae_tpu" or m.startswith("cdae_tpu.")]
assert not bad, bad
print(len(names))
"""


def test_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15  # every module was imported


def test_cuda_request_raises_without_gpu(monkeypatch, tmp_path):
    from cdae_tpu_torch import cli
    from cdae_tpu_torch.models.cdae import CDAE

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        CDAE(device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        cli.run(["--task", "test", "--method", "CDAE",
                 "--train_cache_file", str(tmp_path / "missing.bin")])


def test_later_tasks_and_methods_exit_with_message():
    from cdae_tpu_torch import cli

    with pytest.raises(SystemExit, match="later slice"):
        cli.run(["--task", "sweep", "--method", "CDAE"])
    # train runs Popularity first unless told not to; Popularity is later
    with pytest.raises(SystemExit, match="Popularity.*later slice"):
        cli.run(["--task", "train", "--method", "CDAE", "--device", "cpu"])
    with pytest.raises(SystemExit, match="later slice"):
        cli.run(["--task", "test", "--method", "BPR", "--device", "cpu"])


def test_prepare_and_split_tasks_match_cdae_tpu(movielens_path, tmp_path):
    from cdae_tpu import cli as jcli
    from cdae_tpu.data import io as jio
    from cdae_tpu_torch import cli as tcli
    from cdae_tpu_torch.data import io as tio

    for name, mod in (("j", jcli), ("t", tcli)):
        d = tmp_path / name
        common = ["--cache_file", str(d / "all.bin"),
                  "--train_cache_file", str(d / "train.bin"),
                  "--test_cache_file", str(d / "test.bin")]
        assert mod.main(["--task", "prepare", "--parser", "movielens",
                         "--input_file", movielens_path] + common) == 0
        assert mod.main(["--task", "split"] + common) == 0
    for part in ("all", "train", "test"):
        a = jio.load_interactions(str(tmp_path / "j" / f"{part}.bin"))
        b = tio.load_interactions(str(tmp_path / "t" / f"{part}.bin"))
        for f in ("users", "items", "ratings"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))

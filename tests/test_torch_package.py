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
for name in cdae_tpu_torch.__all__:  # the lazy top-level names too
    getattr(cdae_tpu_torch, name)
bad = [m for m in sys.modules if m == "cdae_tpu" or m.startswith("cdae_tpu.")]
assert not bad, bad
print(" ".join(names))
"""


def test_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 15  # every module was imported
    for mod in ("_native", "sweep", "utils.parallel", "solver.line_search",
                "utils.random", "utils.checkpoint", "cli", "parallel",
                "parallel.mesh", "parallel.distributed", "parallel.topk",
                "parallel.sharded", "parallel.trainer",
                "parallel.tp_pairwise"):
        assert f"cdae_tpu_torch.{mod}" in names, mod


def test_top_level_api_equals_cdae_tpu():
    """The port's ``__all__`` is cdae_tpu's and every name resolves (the
    eight model, solver and evaluator names lazily, as there); the
    registry holds cdae_tpu's names and MULTVAE."""
    import cdae_tpu
    import cdae_tpu_torch

    assert cdae_tpu_torch.__all__ == cdae_tpu.__all__
    for name in cdae_tpu_torch.__all__:
        port, ref = getattr(cdae_tpu_torch, name), getattr(cdae_tpu, name)
        assert type(port) is type(ref) or (callable(port) and callable(ref))
        if isinstance(ref, dict):  # the registry: cdae_tpu's model names
            # and the port's own Mult-VAE
            assert set(port) == set(ref) | {"MULTVAE"}, name


def test_parallel_api_equals_cdae_tpu():
    """cdae_tpu_torch.parallel has cdae_tpu.parallel's ``__all__`` (the
    trainers lazily, as there), and the sharded checkpoints and neighbour
    build sit where cdae_tpu has them. The import walk above holds every
    one of its modules to no jax and no cdae_tpu."""
    import cdae_tpu.parallel as jpar
    import cdae_tpu_torch.parallel as tpar
    from cdae_tpu_torch.models import similarity
    from cdae_tpu_torch.utils import checkpoint

    assert tpar.__all__ == jpar.__all__
    for name in tpar.__all__:
        assert callable(getattr(tpar, name)), name
    for name in ("save_sharded", "load_sharded", "sharded_manifest",
                 "sharded_rng_key"):
        assert callable(getattr(checkpoint, name)), name
    assert callable(similarity.build_topk_neighbors_sharded)


def test_cuda_request_raises_without_gpu(monkeypatch, tmp_path):
    from cdae_tpu_torch import cli
    from cdae_tpu_torch.models.cdae import CDAE

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        CDAE(device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        cli.run(["--task", "test", "--method", "CDAE",
                 "--train_cache_file", str(tmp_path / "missing.bin")])


def test_later_tasks_and_methods_exit_with_message(movielens_path,
                                                   tmp_path, capsys):
    """--sharded and the sweep task, which once exited naming a later
    slice, run (one process's sharded BPR, one grid point here);
    every method cdae_tpu takes builds (LINEAR, FM and NEGMF were the last
    to come; ALS, WRMF, ITEMCF and USERCF before them) and one it does not
    know exits with ``unknown --method``; --task train trains Popularity
    first (it once refused to run without --skip_popularity): with
    --method NONE it trains Popularity alone and returns its TOPN row, as
    cdae_tpu's CLI does."""
    from cdae_tpu_torch import cli

    cache = str(tmp_path / "ml.bin")
    cli.run(["--task", "prepare", "--parser", "movielens",
             "--input_file", movielens_path, "--cache_file", cache])
    capsys.readouterr()
    assert cli.run(["--task", "sweep", "--method", "CDAE", "--cache_file",
                    cache, "--sweep_limit", "1", "--max_iters", "1",
                    "--device", "cpu"]) == {}
    (line,) = capsys.readouterr().out.splitlines()
    assert '"grid_index": 0' in line
    args = cli.build_arg_parser().parse_args(
        ["--task", "train", "--method", "NONE", "--cache_file", cache,
         "--device", "cpu"])
    solver = cli.train(args)
    assert type(solver.model).__name__ == "Popularity"
    assert [r["iter"] for r in solver.history] == [0.0, 1.0]
    assert 0.0 < solver.history[-1]["R@10"] <= 1.0
    for method, name in (("ALS", "ALS"), ("WRMF", "WRMF"),
                         ("ITEMCF", "ItemCF"), ("USERCF", "UserCF"),
                         ("LINEAR", "LinearModel"), ("fm", "FactorModel"),
                         ("NegMF", "NegMF")):
        model = cli.build_model(cli.build_arg_parser().parse_args(
            ["--method", method, "--device", "cpu"]))
        assert type(model).__name__ == name
    with pytest.raises(SystemExit, match="unknown --method LINEARX"):
        cli.run(["--task", "test", "--method", "LINEARX", "--device", "cpu"])
    row = cli.run(["--task", "train", "--method", "BPR", "--sharded", "true",
                   "--cache_file", cache, "--device", "cpu",
                   "--skip_popularity", "--max_iters", "1"])
    assert row["iter"] == 1.0 and 0.0 <= row["R@10"] <= 1.0


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

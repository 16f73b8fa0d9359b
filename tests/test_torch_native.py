"""cdae_tpu_torch's host runtime (cdae_tpu_torch/_native, built by g++ from
cdae_tpu_torch/csrc/cdae_host.cpp) against its Python paths and cdae_tpu's:
the text loader (arrays and vocabulary order, single- and multithreaded),
the counting-sort CSR build against the lexsort, the dynamic work queue,
utils/parallel.py's helpers against their serial forms, the fall-back when
the library is turned off, and two concurrent first builds."""

import ctypes
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from cdae_tpu.data.dataset import Interactions as JInteractions
from cdae_tpu_torch import _native
from cdae_tpu_torch.data import dataset as tds
from cdae_tpu_torch.data.dataset import Interactions as TInteractions
from cdae_tpu_torch.utils import parallel as tpar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("users", "items", "ratings")


@pytest.fixture(scope="module")
def native():
    """The library, built here with g++ (not skipped: this host has it)."""
    assert _native.available(), "the host runtime did not build"
    return _native


def _write_big(path, n=200_000, seed=7):
    """n movielens lines (> 1 MB: the chunked multithreaded parse), ids
    as tokens that are not their first-seen order."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, 3000, n)
    items = rng.integers(0, 5000, n)
    with open(path, "w") as f:
        f.writelines(f"u{u:05d}::m{i:05d}::{(u + i) % 5 + 1}::1234\n"
                     for u, i in zip(users.tolist(), items.tolist()))
    assert os.path.getsize(path) > (1 << 20)


def _input(kind, movielens_path, tmp_path):
    if kind == "sample_movielens":
        return movielens_path, "movielens"
    if kind == "default_implicit":
        p = tmp_path / "pairs.txt"
        p.write_text("u1 i1 5\nu2 i2\n\nu1 i2 3\r\n  u3\ti1  \nbad\nu2 i3 2\n")
        return str(p), "default"
    p = tmp_path / "big.txt"
    _write_big(str(p))
    return str(p), "movielens"


def _same(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.num_users, a.num_items) == (b.num_users, b.num_items)
    assert a.user_vocab.to_list() == b.user_vocab.to_list()
    assert a.item_vocab.to_list() == b.item_vocab.to_list()


@pytest.mark.parametrize("kind", ["sample_movielens", "default_implicit",
                                  "multithreaded_200k"])
def test_native_parse_matches_python_and_cdae_tpu(native, kind,
                                                  movielens_path, tmp_path):
    from cdae_tpu.data.dataset import default_line_parser as jdefault
    from cdae_tpu.data.dataset import movielens_line_parser as jml

    path, fmt = _input(kind, movielens_path, tmp_path)
    tparser = {"default": tds.default_line_parser,
               "movielens": tds.movielens_line_parser}[fmt]
    jparser = {"default": jdefault, "movielens": jml}[fmt]
    port_native = TInteractions.from_text(path, tparser, use_native=True,
                                          num_threads=4)
    port_auto = TInteractions.from_text(path, tparser)  # native by default
    port_py = TInteractions.from_text(path, tparser, use_native=False)
    jax_native = JInteractions.from_text(path, jparser, use_native=True)
    jax_py = JInteractions.from_text(path, jparser, use_native=False)
    for other in (port_auto, port_py, jax_native, jax_py):
        _same(port_native, other)
    if fmt == "default":  # every label 1 (ref yelp.cpp:60-66)
        assert (port_native.ratings == 1.0).all()
        assert len(port_native) == 5


def test_parse_text_threads_and_missing_file(native, tmp_path):
    path = str(tmp_path / "big.txt")
    _write_big(path, n=120_000, seed=3)
    one = native.parse_text(path, "movielens", 1)
    many = native.parse_text(path, "movielens", 8)
    for a, b in zip(one[:3], many[:3]):
        np.testing.assert_array_equal(a, b)
    assert one[3:] == many[3:]
    with pytest.raises(IOError, match="failed to open"):
        native.parse_text(str(tmp_path / "missing.txt"))


def test_build_csr_matches_lexsort(native):
    """> 100,000 keys with repeated (key, column) pairs: rows sorted by
    (column, input order), as the lexsort and cdae_tpu's build give."""
    rng = np.random.default_rng(5)
    n, K = 150_000, 700
    keys = rng.integers(0, K - 1, n).astype(np.int32)  # key K-1 stays empty
    vals = rng.integers(0, 300, n).astype(np.int32)
    ratings = rng.standard_normal(n).astype(np.float32)
    indptr, indices, values = native.build_csr(keys, vals, ratings, K)
    order = np.lexsort((vals, keys))
    np.testing.assert_array_equal(indices, vals[order])
    np.testing.assert_array_equal(values, ratings[order])
    np.testing.assert_array_equal(
        indptr, np.concatenate([[0], np.cumsum(np.bincount(keys,
                                                           minlength=K))]))
    # through Interactions (the native build above 100,000 rows), against
    # cdae_tpu's CSR by user and by item
    t = TInteractions(keys, vals, ratings, K, 300)
    j = JInteractions(keys, vals, ratings, K, 300)
    for tc, jc in ((t.csr(), j.csr()), (t.csr_by_item(), j.csr_by_item())):
        for f in ("indptr", "indices", "values"):
            np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    with pytest.raises(ValueError, match="outside"):
        native.build_csr(keys, vals, ratings, K - 5)


def test_dynamic_parallel_for_covers_once_and_reraises(native):
    hits = np.zeros(10_007, np.int64)

    def chunk(lo, hi):
        hits[lo:hi] += 1

    assert native.dynamic_parallel_for(0, len(hits), chunk, grain=97,
                                       num_threads=6)
    assert (hits == 1).all()

    def bad(lo, hi):
        if lo <= 500 < hi:
            raise ValueError("boom at 500")

    with pytest.raises(ValueError, match="boom at 500"):
        native.dynamic_parallel_for(0, 1000, bad, grain=10, num_threads=4)
    assert native.dynamic_parallel_for(5, 5, chunk)  # empty range: no call


@pytest.mark.parametrize("helper", ["parallel_for", "parallel_for_each",
                                    "dynamic_parallel_for",
                                    "parallel_accumulate", "in_parallel"])
def test_parallel_helpers_match_serial(native, helper):
    n = 1000
    out = np.zeros(n, np.int64)
    if helper == "parallel_for":
        tpar.parallel_for(0, n, lambda i: out.__setitem__(i, i * i), 4)
    elif helper == "parallel_for_each":
        xs = list(range(n))
        tpar.parallel_for_each(xs, lambda x: out.__setitem__(x, x * x), 3)
    elif helper == "dynamic_parallel_for":
        tpar.dynamic_parallel_for(0, n, lambda i: out.__setitem__(i, i * i),
                                  5)
    elif helper == "parallel_accumulate":
        got = tpar.parallel_accumulate(0, n, lambda i: float(i * i), 2.0, 3)
        assert got == 2.0 + sum(float(i * i) for i in range(n))
        return
    else:
        seen = []
        tpar.in_parallel(lambda tid, nt: seen.append((tid, nt)), 4)
        assert sorted(seen) == [(t, 4) for t in range(4)]
        return
    np.testing.assert_array_equal(out, np.arange(n) ** 2)
    assert tpar.num_hardware_threads() >= 1


def test_without_library_the_numpy_paths_agree(native, monkeypatch,
                                               tmp_path):
    path = str(tmp_path / "big.txt")
    _write_big(path, n=110_000, seed=9)
    with_lib = TInteractions.from_text(path, tds.movielens_line_parser)
    csr_lib = with_lib.csr()  # > 100,000 rows: the native build
    monkeypatch.setenv("CDAE_TPU_NO_NATIVE", "1")
    assert not _native.available()
    assert _native.parse_text(path, "movielens") is None
    assert _native.build_csr(with_lib.users, with_lib.items,
                             with_lib.ratings, with_lib.num_users) is None
    assert not _native.dynamic_parallel_for(0, 3, lambda lo, hi: None)
    without = TInteractions.from_text(path, tds.movielens_line_parser)
    _same(with_lib, without)
    csr_np = without.csr()  # the lexsort
    for f in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(csr_lib, f), getattr(csr_np, f))
    out = np.zeros(300, np.int64)
    tpar.dynamic_parallel_for(0, 300, lambda i: out.__setitem__(i, i), 4)
    np.testing.assert_array_equal(out, np.arange(300))


_BUILD = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("native_under_test", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print(mod.build(sys.argv[2]))
"""


def test_concurrent_first_builds_leave_one_library(tmp_path):
    """Two processes build into an empty directory at once: the lock lets
    one compile; both get the same library, and nothing else is left."""
    src = os.path.join(REPO, "cdae_tpu_torch", "_native", "__init__.py")
    out_dir = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, src, out_dir],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(out_dir)) == sorted(
        ["cdae_host.lock", os.path.basename(paths.pop())])
    spec = importlib.util.spec_from_file_location("native_check", src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod._bind(ctypes.CDLL(str(mod.library_path(out_dir))))
    keys = np.array([2, 0, 2, 1], np.int32)
    vals = np.array([5, 3, 1, 4], np.int32)
    indptr = np.empty(4, np.int64)
    indices = np.empty(4, np.int32)
    values = np.empty(4, np.float32)
    lib.cdae_build_csr(keys, vals, np.ones(4, np.float32), 4, 3, indptr,
                       indices, values)
    np.testing.assert_array_equal(indptr, [0, 1, 2, 4])
    np.testing.assert_array_equal(indices, [3, 4, 1, 5])

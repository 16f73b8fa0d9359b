"""ctypes bindings for the port's host runtime (csrc/cdae_host.cpp).

The multithreaded text loader (``parse_text``), the counting-sort CSR
build (``build_csr``) and a dynamic work queue (``dynamic_parallel_for``),
with the JAX package's signatures and results. Host C++, not a kernel:
``g++`` builds it on first use into ``build/cdae_tpu_torch/`` beside the
package (listed in .gitignore) under a name keyed by a hash of the source,
the flags and the host CPU's feature flags (``-march=native`` code must
not load on another CPU sharing the checkout), in a temporary file
renamed into place under a file lock, so concurrent first builds (test
workers, threads) leave one library.
Nothing here runs at import time.

Without a compiler, or with ``CDAE_TPU_NO_NATIVE`` set, ``available()``
is False and each entry point returns None / False: callers fall back to
their numpy versions, which give the same results.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "cdae_host.cpp"
BUILD_DIR = _PKG.parent / "build" / "cdae_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-march=native", "-shared")

CHUNK_FN = ctypes.CFUNCTYPE(None, ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_void_p)
FORMATS = {"default": 0, "movielens": 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False  # a build or load failed once: do not retry every call


def _cpu_flags() -> bytes:
    """The host CPU's feature flags (Linux), which -march=native targets."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    return line
    except OSError:
        pass
    return b""


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """Where the library for the current source, flags and CPU lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_flags())
    h.update(SOURCE.read_bytes())
    return Path(build_dir) / f"libcdae_host_{h.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the library if it is missing; returns its path. Raises
    RuntimeError without ``g++`` or when the compile fails."""
    out = library_path(build_dir)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host runtime is built from "
                           "source on first use")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "cdae_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # built by another process while this one waited
            return out
        fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so.tmp")
        os.close(fd)
        try:
            res = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE), "-lpthread"],
                capture_output=True, text=True, timeout=300,
            )
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, out)  # atomic: nobody loads half a file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.cdae_loader_parse.restype = ctypes.c_void_p
    lib.cdae_loader_parse.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int]
    for fn in ("cdae_loader_num_rows", "cdae_loader_num_users",
               "cdae_loader_num_items"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.cdae_loader_copy.restype = None
    lib.cdae_loader_copy.argtypes = [ctypes.c_void_p, i32, i32, f32]
    for fn in ("cdae_loader_user_token", "cdae_loader_item_token"):
        getattr(lib, fn).restype = ctypes.c_char_p
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.cdae_loader_free.restype = None
    lib.cdae_loader_free.argtypes = [ctypes.c_void_p]
    lib.cdae_build_csr.restype = None
    lib.cdae_build_csr.argtypes = [i32, i32, f32, ctypes.c_int64,
                                   ctypes.c_int64, i64, i32, f32]
    lib.cdae_dynamic_parallel_for.restype = None
    lib.cdae_dynamic_parallel_for.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, CHUNK_FN,
        ctypes.c_void_p, ctypes.c_int,
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on first use; None when it is
    turned off (``CDAE_TPU_NO_NATIVE``) or cannot be built."""
    global _lib, _failed
    if os.environ.get("CDAE_TPU_NO_NATIVE"):
        return None
    with _lock:
        if _lib is None and not _failed:
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (RuntimeError, OSError, subprocess.SubprocessError) as e:
                _failed = True
                warnings.warn(f"cdae_tpu_torch host runtime unavailable, "
                              f"using the numpy paths: {e}")
    return _lib


def available() -> bool:
    return _load() is not None


def dynamic_parallel_for(start: int, end: int, chunk_fn, grain: int = 1,
                         num_threads: int = 0) -> bool:
    """Dynamic work-queue parallel_for (the reference ThreadPool's
    scheduling, thread_pool-inl.hpp:5-58): native threads pull [lo, hi)
    chunks of ``grain`` off an atomic counter and call ``chunk_fn(lo,
    hi)``. The callable re-acquires the interpreter lock on entry, so
    bodies that release it (numpy, IO) run in parallel and pure-Python
    bodies only get the scheduling. The first exception a body raises is
    re-raised here once every chunk has run. Returns False when the
    library is unavailable (the caller falls back)."""
    lib = _load()
    if lib is None:
        return False
    err: list = []

    @CHUNK_FN
    def _cb(lo, hi, _ctx):
        try:
            chunk_fn(int(lo), int(hi))
        except BaseException as e:  # noqa: BLE001 -- never unwind into C
            err.append(e)

    lib.cdae_dynamic_parallel_for(int(start), int(end), max(int(grain), 1),
                                  _cb, None, int(num_threads))
    if err:
        raise err[0]
    return True


def parse_text(path: str, fmt: str = "default", num_threads: int = 0):
    """Parse a ratings text file natively: ``fmt`` "default" (``user item
    [rating]``, every label 1) or "movielens" (``u::i::r[::ts]``).
    Returns (users, items, ratings, user_tokens, item_tokens), ids in
    first-seen order, or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    h = lib.cdae_loader_parse(os.fsencode(path), FORMATS[fmt],
                              int(num_threads))
    if not h:
        raise IOError(f"native loader failed to open {path}")
    try:
        n = lib.cdae_loader_num_rows(h)
        nu = lib.cdae_loader_num_users(h)
        ni = lib.cdae_loader_num_items(h)
        users = np.empty(n, np.int32)
        items = np.empty(n, np.int32)
        ratings = np.empty(n, np.float32)
        lib.cdae_loader_copy(h, users, items, ratings)
        u_tok = [lib.cdae_loader_user_token(h, i).decode() for i in range(nu)]
        i_tok = [lib.cdae_loader_item_token(h, i).decode() for i in range(ni)]
    finally:
        lib.cdae_loader_free(h)
    return users, items, ratings, u_tok, i_tok


def build_csr(
    keys: np.ndarray, vals: np.ndarray, ratings: np.ndarray, num_keys: int
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Counting-sort CSR: (indptr, indices, values) with each row sorted
    by (column, input order) -- the arrays a lexsort on (key, column)
    gives. None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, np.int32)
    vals = np.ascontiguousarray(vals, np.int32)
    ratings = np.ascontiguousarray(ratings, np.float32)
    n = len(keys)
    if not len(vals) == len(ratings) == n:
        raise ValueError("keys/vals/ratings length mismatch")
    if n and (int(keys.min()) < 0 or int(keys.max()) >= num_keys):
        raise ValueError(f"keys outside [0, {num_keys})")
    indptr = np.empty(num_keys + 1, np.int64)
    indices = np.empty(n, np.int32)
    values = np.empty(n, np.float32)
    lib.cdae_build_csr(keys, vals, ratings, n, int(num_keys), indptr,
                       indices, values)
    return indptr, indices, values

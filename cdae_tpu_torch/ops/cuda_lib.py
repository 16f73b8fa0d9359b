"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``cdae_tpu_torch/csrc/*.cu`` into one shared library
with a plain C interface for ``sm_90a`` (Hopper), and ctypes loads it. The
sources compile in parallel, one nvcc process each, and are then linked.
The library is built on first use into ``build/cdae_tpu_torch/`` beside the
package (listed in .gitignore) under a name keyed by a hash of the sources,
the headers they include (``*.cuh``) and the flags, so an edited kernel is
rebuilt and an unchanged one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cdae_tpu_torch"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the kernels' entry points (csrc/*.cu); each returns the
# cudaError_t of its launch
_SIGNATURES = {
    "cdae_decode_scores": (_P, _P, _P, _P) + (_I,) * 4 + (_P,),
    "cdae_fused_topk_dense": (_P,) * 8 + (_I,) * 7 + (_P, _I, _P),
    "cdae_fused_topk_csr": (_P, _P, _P, _P, _I, _P, _P, _P, _P)
                           + (_I,) * 7 + (_P, _I, _P),
    "cdae_hw_uniform": (_P,) + (_I,) * 6 + (_P,),
    "cdae_adagrad_update_tables": (_P, _I, _F, _F, _P),
    "cdae_fused_step": (_P,) * 17 + (_I,) * 4 + (_F,) * 5 + (_I,) * 8 + (_P,),
    "cdae_warp_select": (_I,) + (_P,) * 8 + (_I,) * 8 + (_P,),
    "cdae_scatter_plan": (_P, _I, _I, _P, _P, _P, _P),
    "cdae_scatter_reduce": (_P, _P, _P, _P) + (_I,) * 5 + (_P,),
    "cdae_gather_rows": (_P, _P, _P, _I, _I, _I, _I, _P),
    "cdae_csr_rows": (_P,) * 5 + (_I,) * 3 + (_P,),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "cdae_tpu_torch are built from source on first use"
        )
    return found


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcdae_kernels_{h.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the kernels if the library is missing; returns nvcc's
    report (registers, shared memory and spills per kernel from
    ``-Xptxas -v``), or "" when the library was already built."""
    out = library_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = Path(tmpdir)
        sources = sorted(CSRC.glob("*.cu"))
        objects = [tmp / f"{src.stem}.o" for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objects)
        ]
        logs = [p.communicate()[0] for p in procs]  # waits for every one
        failed = [f"{src.name}:\n{log}" for src, p, log
                  in zip(sources, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        link = subprocess.run(
            [nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp / out.name), *map(str, objects)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        # atomic: a concurrent build never loads half a file
        os.replace(tmp / out.name, out)
    return "".join(logs) + link.stdout + link.stderr


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            loaded = ctypes.CDLL(str(library_path()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            loaded.cdae_error_string.argtypes = (ctypes.c_int,)
            loaded.cdae_error_string.restype = ctypes.c_char_p
            _lib = loaded
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if rc != 0:
        text = lib().cdae_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} at launch ({text})")

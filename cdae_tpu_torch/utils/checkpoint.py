"""Model checkpoints in cdae_tpu's npz format (port of the npz half of
cdae_tpu/utils/checkpoint.py).

A checkpoint is a zip of ``arrays.npz`` (one array per parameter, numpy)
and ``manifest.json`` (format version, step, data dims, parameter names,
extra metadata). The format is framework-neutral, so a checkpoint written
by cdae_tpu serves unchanged here and the other way round;
``params_from_numpy`` is the one place parameters cross into tensors.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from cdae_tpu_torch.models.base import ModelState

_FORMAT_VERSION = 2


def params_from_numpy(arrays: Dict[str, np.ndarray],
                      device) -> Dict[str, torch.Tensor]:
    """cdae_tpu parameter arrays (W, b, b_prime, Wu, V, Uu and their
    ``_ag`` AdaGrad accumulators, or any other model's flat dict) ->
    contiguous tensors on ``device`` with the same names, shapes and
    dtypes. Both packages keep tables as (rows, D), row-major."""
    return {
        name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for name, a in arrays.items()
    }


def save_checkpoint(path: str, state: ModelState,
                    extra: Optional[dict] = None) -> None:
    """Atomically write ``state``'s params + step to ``path``."""
    arrays = {k: v.detach().cpu().numpy() for k, v in state.params.items()}
    manifest = {
        "version": _FORMAT_VERSION,
        "step": state.step,
        "num_users": state.num_users,
        "num_items": state.num_items,
        "param_names": sorted(arrays),
        "extra": extra or {},
    }
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            with zipfile.ZipFile(f, "w",
                                 compression=zipfile.ZIP_DEFLATED) as zf:
                zf.writestr("arrays.npz", buf.getvalue())
                zf.writestr("manifest.json", json.dumps(manifest))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str, state: ModelState) -> ModelState:
    """Restore params + step into a state from ``model.reset`` on the same
    data; the parameters land on the device the state's params are on.
    Dims and parameter names must match."""
    device = next(iter(state.params.values())).device
    with zipfile.ZipFile(path, "r") as zf:
        manifest = json.loads(zf.read("manifest.json"))
        if manifest["num_users"] != state.num_users or (
            manifest["num_items"] != state.num_items
        ):
            raise ValueError(
                "checkpoint dims "
                f"({manifest['num_users']}x{manifest['num_items']}) do not "
                f"match state ({state.num_users}x{state.num_items})"
            )
        missing = set(manifest["param_names"]) ^ set(state.params)
        if missing:
            raise ValueError(f"param name mismatch: {sorted(missing)}")
        arrs = np.load(io.BytesIO(zf.read("arrays.npz")))
        state.params = params_from_numpy(
            {k: arrs[k] for k in manifest["param_names"]}, device
        )
        state.step = int(manifest["step"])
    return state

"""Model checkpoints in cdae_tpu's npz format (port of the npz half of
cdae_tpu/utils/checkpoint.py).

A checkpoint is a zip of ``arrays.npz`` (one array per parameter, numpy)
and ``manifest.json`` (format version, step, data dims, parameter names,
extra metadata, and optionally the config ``fingerprint``). The format is
framework-neutral, so a checkpoint written by cdae_tpu loads unchanged here
and the other way round; ``params_from_numpy`` is the one place parameters
cross into tensors.

Exact resume needs params, accumulators and ``step`` only: the port's step
seeds are functions of (solver seed, step, batch, corruption), so no random
stream is stored (cdae_tpu stores its threefry key as ``rng_key``). The
fingerprint hashes the model class, its config and the data dims, with
dtypes written by name; a resume under another configuration raises. The
two packages' fingerprints differ for one config (their dtypes and routing
defaults differ), so a checkpoint of one package resumes in the other only
without ``expect_fingerprint``.
"""

from __future__ import annotations

import dataclasses
import hashlib
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


def _by_name(v):
    """JSON form of a config value: dtypes by name (``float32``), not by a
    repr that names their module."""
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    return repr(v)


def config_fingerprint(model, state: ModelState) -> str:
    """Stable hash of (model class, config dataclass, data dims)."""
    cfg = getattr(model, "cfg", None)
    payload = {
        "model": type(model).__name__,
        "config": dataclasses.asdict(cfg)
        if cfg is not None and dataclasses.is_dataclass(cfg)
        else repr(cfg),
        "num_users": state.num_users,
        "num_items": state.num_items,
    }
    blob = json.dumps(payload, sort_keys=True, default=_by_name).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def save_checkpoint(path: str, state: ModelState, extra: Optional[dict] = None,
                    fingerprint: Optional[str] = None) -> None:
    """Atomically write ``state``'s params + step (and ``fingerprint``, from
    ``config_fingerprint``) to ``path``."""
    arrays = {k: v.detach().cpu().numpy() for k, v in state.params.items()}
    manifest = {
        "version": _FORMAT_VERSION,
        "step": state.step,
        "num_users": state.num_users,
        "num_items": state.num_items,
        "param_names": sorted(arrays),
        "extra": extra or {},
    }
    if fingerprint is not None:
        manifest["fingerprint"] = fingerprint
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


def load_checkpoint(path: str, state: ModelState,
                    expect_fingerprint: Optional[str] = None) -> ModelState:
    """Restore params + step into a state from ``model.reset`` on the same
    data; the parameters land on the device the state's params are on.
    Dims and parameter names must match, and so must the fingerprints when
    both ``expect_fingerprint`` and the stored one are present."""
    device = next(iter(state.params.values())).device
    with zipfile.ZipFile(path, "r") as zf:
        manifest = json.loads(zf.read("manifest.json"))
        stored_fp = manifest.get("fingerprint")
        if expect_fingerprint and stored_fp and stored_fp != expect_fingerprint:
            raise ValueError(
                f"checkpoint fingerprint {stored_fp} does not match the "
                f"current model/config/data ({expect_fingerprint}); refusing "
                "to resume a different experiment"
            )
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


def checkpoint_manifest(path: str) -> dict:
    """The full manifest (step, dims, parameter names, fingerprint,
    extra)."""
    with zipfile.ZipFile(path, "r") as zf:
        return json.loads(zf.read("manifest.json"))

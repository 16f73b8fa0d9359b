"""Model checkpoints (port of cdae_tpu/utils/checkpoint.py): cdae_tpu's
npz format, and the sharded checkpoints of the mesh-sharded trainers.

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
    dtypes. Both packages keep tables as (rows, D), row-major. Each
    tensor owns a copy: the models update their tables in place, which
    must never write through into the caller's arrays (on the CPU,
    ``torch.from_numpy`` would share their memory)."""
    return {
        name: torch.tensor(np.ascontiguousarray(a), device=device)
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


def save_model_checkpoint(model, path: str, state: ModelState,
                          extra: Optional[dict] = None,
                          fingerprint: Optional[str] = None) -> None:
    """``save_checkpoint`` of a model's state; a sharded wrapper's whole
    tables (its ``checkpoint_view``, a gather every rank joins), written by
    rank 0 alone."""
    from cdae_tpu_torch.parallel.distributed import is_primary

    view = getattr(model, "checkpoint_view", None)
    if view is not None:
        state = view(state)
    if is_primary():
        save_checkpoint(path, state, extra=extra, fingerprint=fingerprint)
    if view is not None:
        model.mesh.barrier()


def load_model_checkpoint(model, path: str, state: ModelState,
                          expect_fingerprint: Optional[str] = None
                          ) -> ModelState:
    """``load_checkpoint`` into a model's state; a sharded wrapper reads
    the whole tables and keeps its blocks (``restore_view``)."""
    view = getattr(model, "checkpoint_view", None)
    if view is None:
        return load_checkpoint(path, state, expect_fingerprint)
    whole = load_checkpoint(path, view(state), expect_fingerprint)
    model.restore_view(state, whole)
    return state


def checkpoint_extra(path: str) -> dict:
    """The ``extra`` metadata a checkpoint was saved with."""
    return checkpoint_manifest(path)["extra"]


def checkpoint_manifest(path: str) -> dict:
    """The full manifest (step, dims, parameter names, fingerprint,
    extra)."""
    with zipfile.ZipFile(path, "r") as zf:
        return json.loads(zf.read("manifest.json"))


# ---------------------------------------------------------------- sharded ---
# Checkpoints of mesh-sharded states on torch.distributed.checkpoint: every
# rank writes only its own blocks (no gather of whole tables onto one
# rank), and a restore reads each rank's blocks back. Rank 0 writes the
# sidecar manifest (cdae_tpu's keys) that makes the checkpoint exactly
# resumable and guards it with the config fingerprint. The files are
# torch.distributed.checkpoint's, not orbax's.

_MANIFEST = "cdae_manifest.json"


def _blocks(state: ModelState) -> Dict[str, torch.Tensor]:
    """This rank's parameter blocks under their global names: a block's
    name carries its global row range, so a table split over an axis is
    one entry per block and a replicated one a single entry that the
    ranks holding it share (torch.distributed.checkpoint writes it once).
    A sharded wrapper records its layout in ``state.aux["layout"]``
    (mesh, layouts, whole shapes); without one the tables are whole."""
    from cdae_tpu_torch.parallel.mesh import _block, _fit_spec

    layout = state.aux.get("layout")
    out = {}
    for name, v in state.params.items():
        lo, hi = 0, v.shape[0] if v.dim() else 0
        if layout is not None:
            mesh, specs, shapes = layout
            spec = _fit_spec(mesh, specs[name], shapes[name])
            idx = _block(mesh, spec, shapes[name])
            if idx and idx[0].start is not None:
                lo, hi = idx[0].start, idx[0].stop
        out[f"params/{name}/{lo}:{hi}"] = v
    return out


def save_sharded(path: str, state: ModelState, force: bool = True,
                 rng_key=None, fingerprint: Optional[str] = None,
                 extra: Optional[dict] = None) -> None:
    """Write a (possibly sharded) ModelState as a directory at ``path``.

    EVERY rank calls this: each writes its own blocks, and rank 0 the
    sidecar manifest (``version``, ``step``, ``extra``, and ``rng_key`` /
    ``fingerprint`` when given), so a sharded checkpoint resumes exactly
    like the npz format. ``force`` replaces an existing checkpoint."""
    import shutil

    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    from cdae_tpu_torch.parallel.distributed import is_primary

    path = os.path.abspath(path)
    if os.path.exists(path) and not force:
        raise FileExistsError(f"{path} exists (force=False)")
    if is_primary() and os.path.exists(path):
        shutil.rmtree(path)
    if dist.is_initialized():
        dist.barrier()
    sd = _blocks(state)
    sd["meta"] = torch.tensor([state.step, state.num_users,
                               state.num_items], dtype=torch.int64)
    dcp.save(sd, checkpoint_id=path)
    if is_primary():
        manifest = {"version": _FORMAT_VERSION, "step": state.step,
                    "extra": extra or {}}
        if rng_key is not None:
            manifest["rng_key"] = np.asarray(rng_key).tolist()
        if fingerprint is not None:
            manifest["fingerprint"] = fingerprint
        with open(os.path.join(path, _MANIFEST), "w") as f:
            json.dump(manifest, f)
    if dist.is_initialized():
        dist.barrier()


def sharded_manifest(path: str) -> dict:
    """The sidecar manifest of a sharded checkpoint (rng_key, fingerprint,
    step, extra) -- {} for a checkpoint without one."""
    p = os.path.join(os.path.abspath(path), _MANIFEST)
    if not os.path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)


def sharded_rng_key(path: str):
    """The random-stream value stored at save time, as uint32 numpy (or
    None: the port's draws derive from ``step``, so it stores none unless
    given one)."""
    key = sharded_manifest(path).get("rng_key")
    return None if key is None else np.asarray(key, np.uint32)


def load_sharded(path: str, state: ModelState,
                 expect_fingerprint: Optional[str] = None) -> ModelState:
    """Restore into a reset ModelState of the same layout: each rank reads
    back only its own blocks, in place. With ``expect_fingerprint`` the
    manifest's fingerprint must match, and the data dims must match the
    state's (the refusals of ``load_checkpoint``)."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    stored_fp = sharded_manifest(path).get("fingerprint")
    if expect_fingerprint and stored_fp and stored_fp != expect_fingerprint:
        raise ValueError(
            f"checkpoint fingerprint {stored_fp} does not match the "
            f"current model/config/data ({expect_fingerprint}); refusing "
            "to resume a different experiment"
        )
    meta = {"meta": torch.zeros(3, dtype=torch.int64)}
    dcp.load(meta, checkpoint_id=path)
    step, U, I = (int(x) for x in meta["meta"])
    if U != state.num_users or I != state.num_items:
        raise ValueError(
            f"checkpoint dims ({U}x{I}) do not match state "
            f"({state.num_users}x{state.num_items})"
        )
    sd = _blocks(state)
    dcp.load(sd, checkpoint_id=path)  # fills the blocks in place
    state.step = step
    return state

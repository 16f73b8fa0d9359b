"""Dataset caches and small-file IO (port of cdae_tpu/data/io.py).

  - save_interactions / load_interactions: the same zip archive as
    cdae_tpu (``arrays.npz`` with users/items/ratings + ``meta.json`` with
    dims and vocabularies), so a cache written by either package loads in
    the other
  - read_lines: stream the non-empty lines of a file through a callback
  - split_line: the reference's tokenizer (each separator character a
    delimiter, empty tokens dropped)
  - load_dense_vectors: one dense float vector per line
  - load_libsvm: ``label idx:val ...`` lines as GroupedInstances
  - read_config_file / write_config_file: ``key : value`` files
"""

from __future__ import annotations

import io as _io
import json
import os
import zipfile
from typing import Callable, Dict, List, Optional

import numpy as np

from cdae_tpu_torch.data.dataset import Interactions
from cdae_tpu_torch.data.instances import GroupedInstances
from cdae_tpu_torch.data.vocab import Vocab


def save_interactions(data: Interactions, path: str) -> None:
    """Persist an Interactions dataset as a compressed archive."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    meta = {
        "num_users": data.num_users,
        "num_items": data.num_items,
        "user_vocab": data.user_vocab.to_list() if data.user_vocab else None,
        "item_vocab": data.item_vocab.to_list() if data.item_vocab else None,
        "version": 1,
    }
    buf = _io.BytesIO()
    np.savez_compressed(
        buf, users=data.users, items=data.items, ratings=data.ratings
    )
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("arrays.npz", buf.getvalue())
        zf.writestr("meta.json", json.dumps(meta))


def load_interactions(path: str) -> Interactions:
    with zipfile.ZipFile(path, "r") as zf:
        meta = json.loads(zf.read("meta.json"))
        arrs = np.load(_io.BytesIO(zf.read("arrays.npz")))
        uv = Vocab.from_list(meta["user_vocab"]) if meta.get("user_vocab") else None
        iv = Vocab.from_list(meta["item_vocab"]) if meta.get("item_vocab") else None
        return Interactions(
            arrs["users"], arrs["items"], arrs["ratings"],
            meta["num_users"], meta["num_items"], uv, iv,
        )


def read_lines(path: str, callback: Callable[[str], None]) -> int:
    """Stream non-empty lines through ``callback``; returns lines processed."""
    n = 0
    with open(path, "r") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            callback(line)
            n += 1
    return n


def split_line(line: str, sep: str = " ") -> List[str]:
    """Tokens of ``line``: every character of ``sep`` is a delimiter and
    empty tokens are dropped (boost::char_separator's behaviour, which the
    reference uses)."""
    out: List[str] = []
    token: List[str] = []
    sepset = set(sep)
    for ch in line:
        if ch in sepset:
            if token:
                out.append("".join(token))
                token = []
        else:
            token.append(ch)
    if token:
        out.append("".join(token))
    return out


def load_dense_vectors(
    path: str, sep: Optional[str] = None, skip_header: bool = False
) -> np.ndarray:
    """One dense float vector per line, no label; (rows, dim) float32."""
    rows: List[List[float]] = []
    with open(path, "r") as f:
        for lineno, line in enumerate(f):
            if skip_header and lineno == 0:
                continue
            line = line.strip()
            if not line:
                continue
            rows.append([float(x) for x in line.split(sep)])
    return np.asarray(rows, dtype=np.float32)


def load_libsvm(path: str) -> GroupedInstances:
    """LIBSVM lines ``label idx:val ...`` (a bare ``idx`` has value 1) as
    GroupedInstances of one feature group: F = the longest row's feature
    count, shorter rows padded with index 0, value 0 and ``mask`` False;
    the group's dimension is the largest index + 1."""
    labels: List[float] = []
    rows: List[List[int]] = []
    vals: List[List[float]] = []
    max_idx = -1
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            r, v = [], []
            for tok in parts[1:]:
                i, _, x = tok.partition(":")
                i = int(i)
                r.append(i)
                v.append(float(x) if x else 1.0)
                max_idx = max(max_idx, i)
            rows.append(r)
            vals.append(v)
    n = len(labels)
    F = max((len(r) for r in rows), default=1)
    idx = np.zeros((n, F), dtype=np.int32)
    val = np.zeros((n, F), dtype=np.float32)
    mask = np.zeros((n, F), dtype=bool)
    for k, (r, v) in enumerate(zip(rows, vals)):
        idx[k, : len(r)] = r
        val[k, : len(r)] = v
        mask[k, : len(r)] = True
    return GroupedInstances(
        idx=idx, vals=val, mask=mask,
        labels=np.asarray(labels, dtype=np.float32),
        group_of=tuple([0] * F),
        group_dims=(max_idx + 1,),
        total_dim=max_idx + 1,
    )


def write_config_file(path: str, cfg: Dict[str, str]) -> None:
    """One ``key : value`` line per entry."""
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k} : {v}\n")


def read_config_file(path: str) -> Dict[str, str]:
    """``key : value`` lines (split at the first colon, both sides
    stripped); lines without a colon are skipped."""
    out: Dict[str, str] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or ":" not in line:
                continue
            k, _, v = line.partition(":")
            out[k.strip()] = v.strip()
    return out

"""Dataset caches: the same zip archive as cdae_tpu/data/io.py
(``arrays.npz`` with users/items/ratings + ``meta.json`` with dims and
vocabularies), so a cache written by either package loads in the other."""

from __future__ import annotations

import io as _io
import json
import os
import zipfile

import numpy as np

from cdae_tpu_torch.data.dataset import Interactions
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

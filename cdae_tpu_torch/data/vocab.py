"""String→dense-id vocabularies.

Equivalent capability to the reference's FeatureGroupInfo::get_index, which
grows a string→index map as instances are loaded
(ref: src/base/instance-inl.hpp:22-37). Here a Vocab is a standalone object so
datasets can share user/item id spaces across train/test splits.
"""

from __future__ import annotations

from typing import Iterable, List


class Vocab:
    """Insertion-ordered string→dense-id map (ids are 0..n-1)."""

    __slots__ = ("_index", "_keys", "frozen")

    def __init__(self, keys: Iterable[str] = ()):  # noqa: D107
        self._index: dict = {}
        self._keys: List[str] = []
        self.frozen = False
        for k in keys:
            self.add(k)

    def add(self, key: str) -> int:
        """Return the id for ``key``, inserting it if unseen."""
        idx = self._index.get(key)
        if idx is None:
            if self.frozen:
                raise KeyError(f"vocab is frozen; unknown key {key!r}")
            idx = len(self._keys)
            self._index[key] = idx
            self._keys.append(key)
        return idx

    def get(self, key: str) -> int:
        """Return the id for ``key``; raises KeyError if missing."""
        return self._index[key]

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def __len__(self) -> int:
        return len(self._keys)

    def key(self, idx: int) -> str:
        return self._keys[idx]

    def keys(self) -> List[str]:
        return list(self._keys)

    def freeze(self) -> "Vocab":
        self.frozen = True
        return self

    # -- serialization ------------------------------------------------------
    def to_list(self) -> List[str]:
        return list(self._keys)

    @classmethod
    def from_list(cls, keys: List[str]) -> "Vocab":
        return cls(keys)

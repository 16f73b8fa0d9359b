"""Sparse user-item interaction datasets (numpy, host side).

The port's copy of cdae_tpu/data/dataset.py: the COO ``Interactions``
container, its CSR (by user and by item), padded, item-side and dense
views, the per-user and global splits, shuffles, the two built-in text
parsers and the schema printer. Text loading for the two built-in parsers
and CSR builds above 100,000 rows go through the host runtime
(cdae_tpu_torch/_native: multithreaded C++), with the Python and numpy
paths as the fallback; both give the same arrays and vocabularies. The
splits and shuffles draw from the same seeded numpy streams as cdae_tpu,
so both packages produce the same result from the same data and seed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from cdae_tpu_torch.data.vocab import Vocab
from cdae_tpu_torch.utils.profiling import phase

LineParser = Callable[[str], Optional[Tuple[str, str, str]]]


def default_line_parser(line: str) -> Optional[Tuple[str, str, str]]:
    """`user item [rating]` whitespace-separated; implicit rating=1."""
    parts = line.split()
    if len(parts) < 2:
        return None
    return parts[0], parts[1], "1"


def movielens_line_parser(line: str) -> Optional[Tuple[str, str, str]]:
    """`user::item::rating::timestamp` (MovieLens format)."""
    parts = line.split("::")
    if len(parts) < 3:
        return None
    return parts[0], parts[1], parts[2]


@dataclasses.dataclass
class CSR:
    """Per-key compressed row view: ``indices[indptr[k]:indptr[k+1]]``."""

    indptr: np.ndarray  # (num_keys + 1,) int64
    indices: np.ndarray  # (nnz,) int32
    values: np.ndarray  # (nnz,) float32

    def row(self, k: int) -> np.ndarray:
        return self.indices[self.indptr[k] : self.indptr[k + 1]]

    def row_values(self, k: int) -> np.ndarray:
        return self.values[self.indptr[k] : self.indptr[k + 1]]

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)


@dataclasses.dataclass
class PaddedUserBatch:
    """Padded per-user interaction lists: items sorted ascending per user,
    padded with ``num_items``."""

    uids: np.ndarray  # (U,) int32
    items: np.ndarray  # (U, L) int32, padded with num_items
    ratings: np.ndarray  # (U, L) float32, 0 at padding
    mask: np.ndarray  # (U, L) bool
    lengths: np.ndarray  # (U,) int32
    num_items: int

    @property
    def num_users(self) -> int:
        return self.uids.shape[0]

    @property
    def max_len(self) -> int:
        return self.items.shape[1]


class Interactions:
    """A user-item interaction dataset (COO layout + shared dims)."""

    def __init__(
        self,
        users: np.ndarray,
        items: np.ndarray,
        ratings: np.ndarray,
        num_users: int,
        num_items: int,
        user_vocab: Optional[Vocab] = None,
        item_vocab: Optional[Vocab] = None,
    ):
        self.users = np.asarray(users, dtype=np.int32)
        self.items = np.asarray(items, dtype=np.int32)
        self.ratings = np.asarray(ratings, dtype=np.float32)
        if not (len(self.users) == len(self.items) == len(self.ratings)):
            raise ValueError("users/items/ratings length mismatch")
        self.num_users = int(num_users)
        self.num_items = int(num_items)
        self.user_vocab = user_vocab
        self.item_vocab = item_vocab
        self._csr_user: Optional[CSR] = None
        self._csr_item: Optional[CSR] = None
        self._csr_device: Dict[object, tuple] = {}

    @classmethod
    def from_text(
        cls,
        path: str,
        parser: LineParser = default_line_parser,
        skip_header: bool = False,
        user_vocab: Optional[Vocab] = None,
        item_vocab: Optional[Vocab] = None,
        use_native: Optional[bool] = None,
        num_threads: int = 0,
    ) -> "Interactions":
        """Stream a text file through ``parser``, skipping blank lines.

        For the two built-in parsers the multithreaded host loader
        (``_native.parse_text``, ``num_threads`` threads, 0 = all cores)
        parses the file when it is available; a custom ``parser``,
        ``skip_header``, pre-seeded vocabs or ``use_native=False`` take
        the Python line loop. Both give the same arrays and vocabularies.
        """
        if use_native is None:
            use_native = not skip_header and user_vocab is None and (
                item_vocab is None
            )
        native_fmt = {default_line_parser: "default",
                      movielens_line_parser: "movielens"}.get(parser)
        if use_native and native_fmt is not None:
            from cdae_tpu_torch import _native

            out = _native.parse_text(path, native_fmt, num_threads)
            if out is not None:
                users, items, ratings, u_tok, i_tok = out
                return cls(
                    users, items, ratings,
                    num_users=len(u_tok), num_items=len(i_tok),
                    user_vocab=Vocab.from_list(u_tok),
                    item_vocab=Vocab.from_list(i_tok),
                )
        user_vocab = user_vocab if user_vocab is not None else Vocab()
        item_vocab = item_vocab if item_vocab is not None else Vocab()
        users, items, ratings = [], [], []
        with open(path, "r") as f:
            for lineno, line in enumerate(f):
                if skip_header and lineno == 0:
                    continue
                line = line.strip()
                if not line:
                    continue
                parsed = parser(line)
                if parsed is None:
                    continue
                u, i, r = parsed
                users.append(user_vocab.add(u))
                items.append(item_vocab.add(i))
                ratings.append(float(r))
        return cls(
            np.asarray(users, dtype=np.int32),
            np.asarray(items, dtype=np.int32),
            np.asarray(ratings, dtype=np.float32),
            num_users=len(user_vocab),
            num_items=len(item_vocab),
            user_vocab=user_vocab,
            item_vocab=item_vocab,
        )

    @classmethod
    def from_arrays(
        cls,
        users: np.ndarray,
        items: np.ndarray,
        ratings: Optional[np.ndarray] = None,
        num_users: Optional[int] = None,
        num_items: Optional[int] = None,
    ) -> "Interactions":
        users = np.asarray(users)
        items = np.asarray(items)
        if ratings is None:
            ratings = np.ones(len(users), dtype=np.float32)
        if num_users is None:
            num_users = int(users.max()) + 1 if len(users) else 0
        if num_items is None:
            num_items = int(items.max()) + 1 if len(items) else 0
        return cls(users, items, ratings, num_users, num_items)

    def __len__(self) -> int:
        return len(self.users)

    @property
    def size(self) -> int:
        return len(self.users)

    def __repr__(self) -> str:
        return (
            f"Interactions(n={len(self)}, users={self.num_users}, "
            f"items={self.num_items})"
        )

    def describe(self, head: int = 5) -> str:
        """Schema + head pretty-printer (ref Data operator<<,
        src/base/data-inl.hpp:82-105: dims, group sizes, head rows)."""
        lengths = self.csr().row_lengths()
        lo = int(lengths.min()) if len(self) else 0
        hi = int(lengths.max()) if len(self) else 0
        density = len(self) / max(self.num_users * self.num_items, 1)
        lines = [
            repr(self),
            f"  density: {density:.6f}",
            f"  per-user interactions: min={lo} max={hi} "
            f"mean={len(self) / max(self.num_users, 1):.1f}",
            "  head (user, item, rating):",
        ]
        for j in range(min(head, len(self))):
            u, i, r = self.users[j], self.items[j], self.ratings[j]
            uo = self.user_vocab.key(int(u)) if self.user_vocab else u
            io_ = self.item_vocab.key(int(i)) if self.item_vocab else i
            lines.append(f"    {uo} {io_} {r}")
        return "\n".join(lines)

    def with_dims(self, num_users: int, num_items: int) -> "Interactions":
        """The same rows under other dimensions (e.g. a test split widened
        to the training id space)."""
        return Interactions(
            self.users, self.items, self.ratings, num_users, num_items,
            self.user_vocab, self.item_vocab,
        )

    def shuffled(self, rng: np.random.Generator) -> "Interactions":
        """Row shuffle (ref Data::shuffle_data, src/base/data-inl.hpp:200)."""
        return self._take(rng.permutation(len(self)))

    def csr(self) -> CSR:
        """Per-user sorted item lists."""
        if self._csr_user is None:
            with phase("data.csr"):
                self._csr_user = _build_csr(
                    self.users, self.items, self.ratings, self.num_users
                )
        return self._csr_user

    def csr_on(self, device, upload: Callable) -> tuple:
        """The user CSR's ``indptr`` (int64) and ``indices`` (int32) on
        ``device``, copied there once a device by ``upload`` (host array ->
        tensor on ``device``); the ratings stay on the host. The copies are
        kept as long as this object (at ML-20M 65.3 MB a device), under the
        device with its index resolved, so ``cuda`` and ``cuda:0`` share
        one; an object made by ``with_dims`` has a CSR, and copies, of its
        own."""
        import torch

        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._csr_device:
            csr = self.csr()
            self._csr_device[device] = (
                upload(csr.indptr.astype(np.int64, copy=False)),
                upload(csr.indices.astype(np.int32, copy=False)))
        return self._csr_device[device]

    def csr_by_item(self) -> CSR:
        """Per-item sorted user lists."""
        if self._csr_item is None:
            self._csr_item = _build_csr(
                self.items, self.users, self.ratings, self.num_items
            )
        return self._csr_item

    def by_item(self) -> "Interactions":
        """The same interactions with the axes swapped (items as the rows):
        its ``padded()`` holds each item's users, ascending, padded with
        ``num_users``."""
        return Interactions(self.items, self.users, self.ratings,
                            self.num_items, self.num_users)

    def user_item_dict(self) -> Dict[int, Dict[int, float]]:
        """uid -> {iid: rating} for every user (ref
        get_feature_pair_label_hashtable(0, 1), src/base/data-inl.hpp:
        413-429); where a pair repeats, the first occurrence wins, as the
        reference's ``insert`` does."""
        out: Dict[int, Dict[int, float]] = {
            u: {} for u in range(self.num_users)
        }
        for u, i, r in zip(self.users.tolist(), self.items.tolist(),
                           self.ratings.tolist()):
            out[u].setdefault(i, r)
        return out

    @phase("data.padded")
    def padded(self, max_len: Optional[int] = None) -> PaddedUserBatch:
        """Padded per-user item lists for ALL users (0..num_users-1); items
        ascending in each row, padded with ``num_items``. The width is the
        longest row, or ``max_len`` (at least 1), which truncates longer
        rows to their first (lowest) ``max_len`` items."""
        items, ratings, mask, lengths = rows_from_csr(
            self.csr(), np.arange(self.num_users), self.num_items
        )
        if max_len is not None:
            L = max(int(max_len or 1), 1)
            extra = ((0, 0), (0, max(L - items.shape[1], 0)))
            items = np.pad(items[:, :L], extra,
                           constant_values=self.num_items)
            ratings = np.pad(ratings[:, :L], extra)
            lengths = np.minimum(lengths, L).astype(np.int32)
            mask = np.arange(L)[None, :] < lengths[:, None]
        return PaddedUserBatch(
            uids=np.arange(self.num_users, dtype=np.int32),
            items=items,
            ratings=ratings,
            mask=mask,
            lengths=lengths,
            num_items=self.num_items,
        )

    def dense_matrix(self, binary: bool = False) -> np.ndarray:
        """(num_users, num_items) float32 rating matrix, built on the host
        (small catalogs only). ``binary``: 1 at every rated pair; else the
        rating, and where a pair is rated several times the first
        occurrence wins (the reference's user_item_dict semantics)."""
        m = np.zeros((self.num_users, self.num_items), dtype=np.float32)
        if binary:
            m[self.users, self.items] = 1.0
            return m
        keys = self.users.astype(np.int64) * self.num_items + self.items
        _, first = np.unique(keys, return_index=True)
        m[self.users[first], self.items[first]] = self.ratings[first]
        return m

    def random_split(
        self, test_ratio: float, seed: int = 0
    ) -> Tuple["Interactions", "Interactions"]:
        """Global random split: a seeded permutation, the first
        int((1 - test_ratio) * n) rows to train (ref Data::random_split,
        src/base/data-inl.hpp:206-229)."""
        perm = np.random.default_rng(seed).permutation(len(self))
        num_train = int((1.0 - test_ratio) * len(self))
        return self._take(perm[:num_train]), self._take(perm[num_train:])

    def split_by_user(
        self, test_ratio: float, seed: int = 0
    ) -> Tuple["Interactions", "Interactions"]:
        """Per-user leave-``test_ratio``-out split: bucket instances by
        user, shuffle each bucket, the first floor(len*ratio) go to test,
        the rest to train; both splits keep the full dimensions. Same
        draws, in the same order, as cdae_tpu's split."""
        rng = np.random.default_rng(seed)
        if self.num_users > 100_000:
            # vectorized protocol for huge user counts: random order within
            # each user via one lexsort
            n = len(self)
            order = np.lexsort((rng.random(n), self.users))
            counts = np.bincount(self.users, minlength=self.num_users)
            indptr = np.zeros(self.num_users + 1, dtype=np.int64)
            indptr[1:] = np.cumsum(counts)
            pos = np.arange(n) - indptr[self.users[order]]
            k = np.floor(counts * test_ratio).astype(np.int64)
            is_test = pos < k[self.users[order]]
            te = order[is_test]
            tr = order[~is_test]
            rng.shuffle(tr)
            rng.shuffle(te)
            return self._take(tr), self._take(te)
        order = np.argsort(self.users, kind="stable")
        counts = np.bincount(self.users, minlength=self.num_users)
        indptr = np.zeros(self.num_users + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(counts)
        train_idx, test_idx = [], []
        for u in range(self.num_users):
            bucket = order[indptr[u] : indptr[u + 1]].copy()
            rng.shuffle(bucket)
            k = int(len(bucket) * test_ratio)
            test_idx.append(bucket[:k])
            train_idx.append(bucket[k:])
        tr = np.concatenate(train_idx) if train_idx else np.empty(0, np.int64)
        te = np.concatenate(test_idx) if test_idx else np.empty(0, np.int64)
        rng.shuffle(tr)
        rng.shuffle(te)
        return self._take(tr), self._take(te)

    def _take(self, idx: np.ndarray) -> "Interactions":
        return Interactions(
            self.users[idx], self.items[idx], self.ratings[idx],
            self.num_users, self.num_items, self.user_vocab, self.item_vocab,
        )


def rows_from_csr(csr: CSR, users: np.ndarray, num_items: int):
    """Padded (len(users), L) item/rating/mask rows for specific users,
    straight from CSR. L = max row length among them (min 1); items are
    padded with ``num_items``. Returns (items, ratings, mask, lengths)."""
    lengths = np.diff(csr.indptr)[users].astype(np.int32)
    L = max(int(lengths.max()) if len(lengths) else 1, 1)
    n = len(users)
    items = np.full((n, L), num_items, dtype=np.int32)
    ratings = np.zeros((n, L), dtype=np.float32)
    counts = lengths.astype(np.int64)
    total = int(counts.sum())
    if total:
        row_of = np.repeat(np.arange(n), counts)
        cum0 = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = np.arange(total) - np.repeat(cum0, counts)
        src = np.repeat(csr.indptr[users], counts) + pos
        items[row_of, pos] = csr.indices[src]
        ratings[row_of, pos] = csr.values[src]
    mask = np.arange(L)[None, :] < lengths[:, None]
    return items, ratings, mask, lengths


def _build_csr(
    keys: np.ndarray, vals: np.ndarray, ratings: np.ndarray, num_keys: int
) -> CSR:
    """Rows by key, each sorted by (column, input order): the host
    runtime's counting sort above 100,000 rows, else one lexsort (the
    same arrays)."""
    if len(keys) > 100_000:
        from cdae_tpu_torch import _native

        out = _native.build_csr(keys, vals, ratings, num_keys)
        if out is not None:
            return CSR(*out)
    # single lexsort: primary key = row, secondary = column (ascending)
    order = np.lexsort((vals, keys))
    indptr = np.zeros(num_keys + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(keys, minlength=num_keys))
    return CSR(indptr=indptr, indices=vals[order].astype(np.int32),
               values=ratings[order].astype(np.float32))

"""cdae_tpu_torch data layer vs cdae_tpu's, array for array: splits, CSR,
padded rows, caches in both directions, synthetic generators."""

import numpy as np
import pytest

from cdae_tpu.data import io as jio
from cdae_tpu.data import synthetic as jsyn
from cdae_tpu.data.dataset import Interactions as JInteractions
from cdae_tpu.data.dataset import movielens_line_parser as jml
from cdae_tpu.data.dataset import rows_from_csr as jrows
from cdae_tpu_torch.data import io as tio
from cdae_tpu_torch.data import synthetic as tsyn
from cdae_tpu_torch.data.dataset import Interactions as TInteractions
from cdae_tpu_torch.data.dataset import movielens_line_parser as tml
from cdae_tpu_torch.data.dataset import rows_from_csr as trows


def _same(a, b):
    for f in ("users", "items", "ratings"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.num_users, a.num_items) == (b.num_users, b.num_items)


@pytest.fixture(scope="module")
def both(movielens_path):
    return (JInteractions.from_text(movielens_path, jml),
            TInteractions.from_text(movielens_path, tml))


def test_text_load_matches(both):
    j, t = both
    _same(j, t)
    assert j.user_vocab.to_list() == t.user_vocab.to_list()
    assert j.item_vocab.to_list() == t.item_vocab.to_list()


@pytest.mark.parametrize("seed", [0, 20141119])
@pytest.mark.parametrize("ratio", [0.2, 0.5])
def test_split_by_user_matches(both, seed, ratio):
    j, t = both
    for a, b in zip(j.split_by_user(ratio, seed),
                    t.split_by_user(ratio, seed)):
        _same(a, b)


def test_split_by_user_vectorized_matches():
    """The > 100k-user protocol (one lexsort) draws the same stream."""
    rng = np.random.default_rng(3)
    U, I, n = 100_500, 50, 300_000
    users = rng.integers(0, U, n).astype(np.int32)
    items = rng.integers(0, I, n).astype(np.int32)
    j = JInteractions.from_arrays(users, items, num_users=U, num_items=I)
    t = TInteractions.from_arrays(users, items, num_users=U, num_items=I)
    for a, b in zip(j.split_by_user(0.2, 7), t.split_by_user(0.2, 7)):
        _same(a, b)


def test_csr_and_rows_match(both):
    j, t = both
    jc, tc = j.csr(), t.csr()
    for f in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(jc, f), getattr(tc, f))
    users = np.array([3, 0, 7, 7, 24], np.int32)
    for a, b in zip(jrows(jc, users, j.num_items),
                    trows(tc, users, t.num_items)):
        np.testing.assert_array_equal(a, b)
    jp, tp = j.padded(), t.padded()
    for f in ("uids", "items", "ratings", "mask", "lengths"):
        np.testing.assert_array_equal(getattr(jp, f), getattr(tp, f))


def test_cache_round_trip_both_ways(both, tmp_path):
    j, t = both
    jio.save_interactions(j, str(tmp_path / "j.bin"))
    tio.save_interactions(t, str(tmp_path / "t.bin"))
    _same(tio.load_interactions(str(tmp_path / "j.bin")), j)
    back = jio.load_interactions(str(tmp_path / "t.bin"))
    _same(back, t)
    assert back.item_vocab.to_list() == t.item_vocab.to_list()


def test_synthetic_generators_match():
    _same(jsyn.lowrank_interactions(60, 40, 5, seed=4),
          tsyn.lowrank_interactions(60, 40, 5, seed=4))
    t = tsyn.synthetic_interactions(300, 100, 12, seed=5)
    assert t.num_users == 300 and t.num_items == 100
    pairs = t.users.astype(np.int64) * 100 + t.items
    assert len(np.unique(pairs)) == len(pairs)  # deduplicated
    assert 8 < len(t) / 300 < 14  # ~avg_degree per user

import types

import numpy as np
import pytest
import torch

from benchmark.harness import generator, spec

DATA = dict(num_users=500, num_items=400, num_ratings=500 * 60,
            min_degree=20, test_ratio=0.2, degree_law="geometric_floor",
            popularity_law="power", popularity_exponent=0.6)
degree_sequence = spec.load_module("laws", "geometric_floor").degree_sequence


def test_degree_sequence_sums_and_floor():
    deg = degree_sequence(138_493, 20_000_263, 20, 26_744)
    assert deg.sum() == 20_000_263
    assert deg.min() == 20
    assert abs(deg.mean() - 20_000_263 / 138_493) < 1e-9
    assert np.all(np.diff(deg) >= 0)


def test_same_seed_same_data_other_seed_same_lengths():
    a = generator.synthetic_train(DATA, 7, "cpu")
    b = generator.synthetic_train(DATA, 7, "cpu")
    c = generator.synthetic_train(DATA, 2**31 + 5, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])
    la = np.sort(np.bincount(a[0], minlength=500))
    lc = np.sort(np.bincount(c[0], minlength=500))
    assert np.array_equal(la, lc)  # the same row lengths in another order


def test_split_floor_mean_and_distinct_items():
    users, items = generator.synthetic_train(DATA, 3, "cpu")
    n = np.bincount(users, minlength=500)
    deg = degree_sequence(500, DATA["num_ratings"], 20, 400)
    kept = np.sort(deg - np.floor(deg * 0.2).astype(int))
    assert np.array_equal(np.sort(n), kept)  # 80/20 of every row
    assert n.min() == 20 - 4  # the degree floor of 20, 16 kept
    assert sum(deg) == DATA["num_ratings"]
    pairs = users.astype(np.int64) * 400 + items
    assert len(np.unique(pairs)) == len(pairs)  # no repeated (user, item)
    assert np.all(np.diff(pairs) > 0)  # sorted by user, then item
    assert items.min() >= 0 and items.max() < 400


def test_popularity_is_skewed():
    data = dict(DATA, test_ratio=0.0)
    users, items = generator.synthetic_train(data, 11, "cpu")
    counts = np.sort(np.bincount(items, minlength=400))[::-1]
    assert counts[0] > 5 * np.median(counts)


def test_weights_shapes_and_range():
    cdae = spec.load_module("models", "cdae")
    ctx = types.SimpleNamespace(device=torch.device("cpu"), seed=9,
                                num_users=50, num_items=40,
                                config={"cdae": {"num_dim": 8}})
    w = cdae.weights(ctx)
    s = 4.0 * np.sqrt(6.0 / 48)
    assert w["W"].shape == (40, 8) and w["Wu"].shape == (50, 8)
    assert float(w["W"].abs().max()) <= s
    assert torch.count_nonzero(w["b"]) == 0
    assert torch.equal(w["W"], cdae.weights(ctx)["W"])


def test_the_laws_are_found_by_name():
    assert np.array_equal(generator.degrees(DATA),
                          degree_sequence(500, 500 * 60, 20, 400))
    with pytest.raises(FileNotFoundError):
        generator.degrees(dict(DATA, degree_law="no_such_law"))


@pytest.mark.parametrize("bad", [dict(num_ratings=500 * 10)])
def test_degree_sequence_rejects_impossible_counts(bad):
    with pytest.raises(ValueError):
        degree_sequence(500, bad["num_ratings"], 20, 400)

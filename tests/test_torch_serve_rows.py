"""The rated rows of ``RecsysModel.recommend``, built on the model's device
from a device copy of the training CSR (``ops/pallas_kernels.py csr_rows``;
here its plain version): the same items and mask, bit for bit, as the host
``rows_from_csr`` over seeded CSRs (empty rows, a request of empty rows
only, repeated and unsorted uids, the longest row); the device CSR copied
once a device; uids outside the users refused; and ``recommend``'s ids
equal to the host-rows path it replaced, for CDAE sparse, CDAE dense and
IMF."""

import numpy as np
import pytest
import torch

import cdae_tpu_torch.models.cdae as tcdae
import cdae_tpu_torch.models.mf as tmf
from cdae_tpu_torch.data.dataset import Interactions, rows_from_csr
from cdae_tpu_torch.data.dataset import movielens_line_parser as tparser
from cdae_tpu_torch.ops.pallas_kernels import csr_rows
from cdae_tpu_torch.ops.topk import topk_unrated

torch.set_num_threads(2)


def _data(seed, U=60, I=45, empty=(5, 17, 33), longest=(40, 44)):
    """Seeded interactions: row lengths drawn geometric, the users in
    ``empty`` with none, and ``longest`` = (user, length) the longest row."""
    rng = np.random.default_rng(seed)
    lengths = np.minimum(rng.geometric(0.12, U), I - 1)
    lengths[list(empty)] = 0
    lengths[longest[0]] = longest[1]
    users = np.repeat(np.arange(U), lengths)
    items = np.concatenate([rng.choice(I, n, replace=False)
                            for n in lengths])
    return Interactions.from_arrays(users, items, num_users=U, num_items=I)


REQUESTS = {
    "with_empty_rows": np.array([0, 5, 1, 17, 2, 33], np.int32),
    "empty_rows_only": np.array([17, 5, 33, 5], np.int32),
    "repeated_unsorted": np.array([9, 3, 9, 58, 0, 3, 21, 9], np.int32),
    "longest_row": np.array([12, 40, 7], np.int32),
    "every_user": np.arange(60, dtype=np.int32)[::-1].copy(),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("request_name", sorted(REQUESTS))
def test_device_rows_equal_rows_from_csr(seed, request_name):
    data = _data(seed)
    uids = REQUESTS[request_name]
    items, _, mask, _ = rows_from_csr(data.csr(), uids, data.num_items)
    if request_name == "empty_rows_only":
        assert items.shape[1] == 1
    if request_name == "longest_row":
        assert items.shape[1] == 44
    indptr, indices = data.csr_on("cpu", torch.as_tensor)
    got_items, got_mask = csr_rows(indptr, indices,
                                   torch.as_tensor(uids.astype(np.int64)),
                                   items.shape[1], data.num_items)
    assert got_items.dtype == torch.int32 and got_mask.dtype == torch.bool
    np.testing.assert_array_equal(got_items.numpy(), items)
    np.testing.assert_array_equal(got_mask.numpy(), mask)


def test_device_rows_of_a_dataset_with_no_interactions():
    data = Interactions.from_arrays(np.zeros(0, np.int32),
                                    np.zeros(0, np.int32), num_users=4,
                                    num_items=7)
    uids = np.array([3, 0, 3], np.int32)
    items, _, mask, _ = rows_from_csr(data.csr(), uids, data.num_items)
    indptr, indices = data.csr_on("cpu", torch.as_tensor)
    got = csr_rows(indptr, indices, torch.as_tensor(uids.astype(np.int64)),
                   1, data.num_items)
    np.testing.assert_array_equal(got[0].numpy(), items)
    np.testing.assert_array_equal(got[1].numpy(), mask)


def test_the_device_csr_is_copied_once_a_device():
    data = _data(0)
    copies = []

    def upload(a):
        copies.append(a.dtype)
        return torch.as_tensor(a)

    first = data.csr_on("cpu", upload)
    again = data.csr_on("cpu", upload)
    assert copies == [np.int64, np.int32]
    assert first[0] is again[0] and first[1] is again[1]
    np.testing.assert_array_equal(first[0].numpy(), data.csr().indptr)
    np.testing.assert_array_equal(first[1].numpy(), data.csr().indices)


def test_the_device_csr_is_kept_once_for_one_device_however_named():
    data = _data(0)
    copies = []

    def upload(a):
        copies.append(a.dtype)
        return torch.as_tensor(a)

    first = data.csr_on("cpu", upload)
    again = data.csr_on(torch.device("cpu"), upload)
    assert copies == [np.int64, np.int32]
    assert first[0] is again[0] and first[1] is again[1]


@pytest.mark.parametrize("method", ["IMF", "CDAE"])
def test_recommend_copies_the_uids_once_for_rows_and_scores(method):
    """A warm request copies one host array to the device, the int64 uids,
    and hands that tensor to ``csr_rows`` and ``batch_scores`` alike."""
    data = _data(0)
    if method == "IMF":
        model = tmf.IMF(tmf.MFConfig(num_dim=4), device="cpu")
    else:
        model = tcdae.CDAE(tcdae.CDAEConfig(num_dim=4, dense_mode=False),
                           device="cpu")
    state = model.reset(data, seed=0)
    uids = np.array([9, 3, 9, 58, 0], np.int32)
    model.recommend(state, uids, data, k=5)  # the CSR's copy
    host, seen = [], {}
    tensor, scores = model._tensor, model.batch_scores

    def spy_tensor(x, dtype=None):
        if not isinstance(x, torch.Tensor):
            host.append(np.asarray(x))
        return tensor(x, dtype)

    def spy_scores(st, u, rated, mask):
        seen["uids"] = u
        return scores(st, u, rated, mask)

    model._tensor, model.batch_scores = spy_tensor, spy_scores
    model.recommend(state, uids, data, k=5)
    assert len(host) == 1 and host[0].dtype == np.int64
    np.testing.assert_array_equal(host[0], uids)
    assert isinstance(seen["uids"], torch.Tensor)
    assert seen["uids"].dtype == torch.long


@pytest.mark.parametrize("uids", [[0, 60], [-1, 2]])
def test_recommend_refuses_uids_outside_the_users(uids):
    data = _data(0)
    model = tmf.IMF(tmf.MFConfig(num_dim=4), device="cpu")
    state = model.reset(data, seed=0)
    with pytest.raises(IndexError):
        model.recommend(state, np.array(uids, np.int32), data, k=5)


# ------------------------------------------ recommend against host rows ----

def _host_rows_recommend(model, state, uids, train, k):
    """``recommend`` as it served before its rows moved to the device: the
    padded rows built on the host by ``rows_from_csr`` and copied over."""
    uids = np.asarray(uids, dtype=np.int32).reshape(-1)
    rated, _, mask, _ = rows_from_csr(train.csr(), uids, train.num_items)
    rated = model._tensor(rated)
    mask = model._tensor(mask)
    scores = model.batch_scores(state, uids, rated, mask)
    ids, _ = topk_unrated(scores, rated, k)
    return ids


@pytest.fixture(scope="module")
def train(movielens_path):
    return Interactions.from_text(movielens_path, tparser)


def _model(name):
    if name == "IMF":
        return tmf.IMF(tmf.MFConfig(num_dim=8, batch_size=64, num_neg=2,
                                    loss="SQUARE"), device="cpu")
    return tcdae.CDAE(tcdae.CDAEConfig(
        num_dim=8, loss="SQUARE", corruption_ratio=0.5, batch_size=32,
        learn_rate=0.5, dense_mode=name == "CDAE_dense"), device="cpu")


@pytest.mark.parametrize("name", ["IMF", "CDAE_dense", "CDAE_sparse"])
@pytest.mark.parametrize("k", [1, 10])
def test_recommend_equals_the_host_rows_path(train, name, k):
    model = _model(name)
    state = model.reset(train, seed=0)
    model.train_one_iteration(state, seed=1)
    if name != "IMF":
        assert ("dense_R" in state.aux) == (name == "CDAE_dense")
    for uids in ([3, 0, 24, 7, 7, 12], np.arange(train.num_users)[::-1]):
        got = model.recommend(state, uids, train, k=k)
        want = _host_rows_recommend(model, state, uids, train, k)
        assert got.dtype == want.dtype == torch.int32
        assert torch.equal(got, want)

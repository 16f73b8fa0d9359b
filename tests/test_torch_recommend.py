"""RecsysModel.recommend of cdae_tpu_torch against cdae_tpu's: the same
top-k unrated ids for IMF and CDAE (dense and sparse scoring, kernels' plain
versions here) from the same parameters, carried across with
params_from_numpy; no rated id in any list; the sentinel num_items in the
slots past a user's unrated items (here a catalog smaller than k); and the
evaluator's pre_recommend hook called once per evaluate."""

import jax
import numpy as np
import pytest
import torch

import cdae_tpu.models.cdae as jcdae
import cdae_tpu.models.mf as jmf
import cdae_tpu_torch.models.cdae as tcdae
import cdae_tpu_torch.models.mf as tmf
from cdae_tpu.data.dataset import Interactions as JInteractions
from cdae_tpu.data.dataset import movielens_line_parser as jparser
from cdae_tpu_torch.data.dataset import Interactions as TInteractions
from cdae_tpu_torch.data.dataset import movielens_line_parser as tparser
from cdae_tpu_torch.evaluation import RecListEvaluation
from cdae_tpu_torch.utils.checkpoint import params_from_numpy

torch.set_num_threads(2)
SEED = 20141119


@pytest.fixture(scope="module")
def splits(movielens_path):
    j = JInteractions.from_text(movielens_path, jparser)
    t = TInteractions.from_text(movielens_path, tparser)
    return j.split_by_user(0.2, seed=SEED), t.split_by_user(0.2, seed=SEED)


def _imf(splits):
    (jtrain, _), (ttrain, _) = splits
    cfg = dict(num_dim=8, batch_size=64, num_neg=2, loss="SQUARE")
    jm = jmf.IMF(jmf.MFConfig(**cfg))
    tm = tmf.IMF(tmf.MFConfig(**cfg), device="cpu")
    js, ts = jm.reset(jtrain, seed=0), tm.reset(ttrain, seed=0)
    rng = np.random.default_rng(3)
    p = {k: np.array(v) for k, v in js.params.items()}
    for k in ("uv", "iv", "ub", "ib"):
        p[k] = (rng.standard_normal(p[k].shape) * 0.3).astype(np.float32)
    js.params = {k: jax.numpy.asarray(v) for k, v in p.items()}
    ts.params = params_from_numpy(p, "cpu")
    return jm, js, tm, ts


def _cdae(splits, dense):
    """cdae_tpu trains 3 iterations; the port takes its parameters."""
    (jtrain, _), (ttrain, _) = splits
    cfg = dict(num_dim=8, loss="SQUARE", corruption_ratio=0.5,
               batch_size=32, learn_rate=0.5, dense_mode=dense)
    jm = jcdae.CDAE(jcdae.CDAEConfig(**cfg, use_pallas=False))
    js = jm.reset(jtrain, seed=0)
    for it in range(3):
        js = jm.train_one_iteration(js, jax.random.PRNGKey(it))
    tm = tcdae.CDAE(tcdae.CDAEConfig(**cfg), device="cpu")
    ts = tm.reset(ttrain, seed=0)
    assert ("dense_R" in ts.aux) == dense
    ts.params = params_from_numpy(
        {k: np.asarray(v) for k, v in js.params.items()}, "cpu")
    return jm, js, tm, ts


@pytest.fixture(scope="module")
def models(splits):
    """Each model pair, built once (recommend changes no state)."""
    return {"IMF": _imf(splits), "CDAE_dense": _cdae(splits, True),
            "CDAE_sparse": _cdae(splits, False)}


@pytest.mark.parametrize("model", ["IMF", "CDAE_dense", "CDAE_sparse"])
@pytest.mark.parametrize("k", [1, 10, 20])
def test_recommend_ids_equal_cdae_tpu(splits, models, model, k):
    jm, js, tm, ts = models[model]
    (jtrain, _), (ttrain, _) = splits
    uids = np.array([3, 0, 24, 7, 7, 12], np.int32)
    got = tm.recommend(ts, uids, ttrain, k=k)
    assert got.dtype == torch.int32 and tuple(got.shape) == (len(uids), k)
    want = jm.recommend(js, uids, jtrain, k=k)
    np.testing.assert_array_equal(got.numpy(), want)
    csr = ttrain.csr()
    for row, u in zip(got.numpy(), uids):
        assert not set(row.tolist()) & set(csr.row(u).tolist())
        assert len(set(row.tolist())) == k  # no id twice


def test_catalog_smaller_than_k_pads_with_num_items(splits):
    jm, js, tm, ts = _imf(splits)
    (jtrain, _), (ttrain, _) = splits
    I = ttrain.num_items
    k = I + 4
    uids = np.arange(ttrain.num_users, dtype=np.int32)
    got = tm.recommend(ts, uids, ttrain, k=k).numpy()
    want = jm.recommend(js, uids, jtrain, k=k)
    csr = ttrain.csr()
    for u, row in enumerate(got):
        # every unrated item first, then the sentinel in every slot past
        # them: cdae_tpu lists the rated ones there (scored -inf), and its
        # slots past the catalog hold the sentinel too
        unrated = set(range(I)) - set(csr.row(u).tolist())
        np.testing.assert_array_equal(row[:len(unrated)],
                                      want[u, :len(unrated)])
        assert set(row[:len(unrated)].tolist()) == unrated
        assert (row[len(unrated):] == I).all()
        assert (want[u, I:] == I).all()


def test_recommend_lists_equal_topn_ranking(splits):
    """recommend's lists are the ones the TOPN evaluator ranks: the same
    users' top-10 through RecListEvaluation's batches."""
    _, _, tm, ts = _cdae(splits, dense=True)
    (ttrain, ttest) = splits[1]
    ev = RecListEvaluation("TOPN")
    seen = {}
    orig = tm.batch_scores

    def spy(state, uids, rated_items, rated_mask):
        scores = orig(state, uids, rated_items, rated_mask)
        from cdae_tpu_torch.ops.topk import topk_unrated

        ids, _ = topk_unrated(scores, rated_items, 10)
        for u, row in zip(np.asarray(uids).tolist(), ids.numpy()):
            seen.setdefault(u, row)
        return scores

    tm.batch_scores = spy
    ev.evaluate(tm, ts, ttest, ttrain)
    del tm.batch_scores
    users = np.array(sorted(seen), np.int32)
    got = tm.recommend(ts, users, ttrain, k=10).numpy()
    np.testing.assert_array_equal(got, np.stack([seen[u] for u in users]))


def test_pre_recommend_hook_once_per_evaluate(splits):
    _, _, tm, ts = _imf(splits)
    (ttrain, ttest) = splits[1]
    calls = []
    tm.pre_recommend = lambda state: calls.append(state)
    ev = RecListEvaluation("TOPN")
    ev.evaluate(tm, ts, ttest, ttrain)
    assert len(calls) == 1 and calls[0] is ts
    ev.evaluate(tm, ts, ttest, ttrain)
    assert len(calls) == 2
    empty = TInteractions(np.zeros(0, np.int32), np.zeros(0, np.int32),
                          np.zeros(0, np.float32), ttrain.num_users,
                          ttrain.num_items)
    ev.evaluate(tm, ts, empty, ttrain)  # no validation user: no ranking
    assert len(calls) == 2

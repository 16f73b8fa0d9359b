"""cdae_tpu_torch's ItemCF and UserCF against cdae_tpu's on the same data:
the neighbour lists (ids and sims equal bit for bit, Jaccard and Cosine, at
a block size that splits the rows and at one that does not), the scores
(to 1e-6; the sums run in the same order, so they come out equal), the
top-10 lists and the TOPN row, then the CLI with a checkpoint that the
port's --task test restores.

Count, divide and mask are the same IEEE operations in both packages, and
the port's top-k keeps lax.top_k's order on equal similarities (lower id
first), which Jaccard on small counts hits often.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cdae_tpu.models.similarity as jsim
import cdae_tpu_torch.models.similarity as tsim
from cdae_tpu.data import io as jio
from cdae_tpu.data.dataset import Interactions as JInteractions
from cdae_tpu.data.dataset import movielens_line_parser as jparser
from cdae_tpu.data.synthetic import lowrank_interactions
from cdae_tpu.evaluation import Evaluation as JEvaluation
from cdae_tpu_torch import cli as tcli
from cdae_tpu_torch import models as tmodels
from cdae_tpu_torch.data.dataset import Interactions as TInteractions
from cdae_tpu_torch.evaluation import Evaluation as TEvaluation
from cdae_tpu_torch.ops.topk import topk_unrated

torch.set_num_threads(2)

SEED = 20141119
MODELS = ("ItemCF", "UserCF")


@pytest.fixture(scope="module")
def data():
    """300 x 300 low-rank data split 0.2, in both packages."""
    j = lowrank_interactions(300, 300, 12, seed=3)
    t = TInteractions(j.users, j.items, j.ratings, j.num_users, j.num_items)
    return j.split_by_user(0.2, seed=SEED), t.split_by_user(0.2, seed=SEED)


def _pair(name, data, **kw):
    (jtrain, _), (ttrain, _) = data
    cfg = dict(sim_type="JACCARD", topk=20)
    cfg.update(kw)
    jm = getattr(jsim, name)(jsim.SimilarityConfig(sharded=False, **cfg))
    tm = getattr(tsim, name)(tsim.SimilarityConfig(**cfg), device="cpu")
    return jm, jm.reset(jtrain), tm, tm.reset(ttrain)


@pytest.mark.parametrize("block_size", [64, 1024])
@pytest.mark.parametrize("sim_type", ["JACCARD", "COSINE"])
@pytest.mark.parametrize("name", MODELS)
def test_neighbors_equal_cdae_tpu(data, name, sim_type, block_size):
    jm, js, tm, ts = _pair(name, data, sim_type=sim_type,
                           block_size=block_size)
    ids, sims = ts.params["nbr_ids"], ts.params["nbr_sims"]
    assert ids.dtype == torch.int32 and sims.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(js.params["nbr_ids"]))
    np.testing.assert_array_equal(sims.numpy(),
                                  np.asarray(js.params["nbr_sims"]))
    N = ts.num_items if name == "ItemCF" else ts.num_users
    assert ids.shape == (N, 20)
    pad = ids == N
    # some items have fewer than 20 co-occurring items
    assert pad.any() or name == "UserCF"
    assert (sims[pad] == 0).all() and (sims[~pad] > 0).all()


@pytest.mark.parametrize("sim_type", ["JACCARD", "COSINE"])
def test_build_functions_equal_cdae_tpu(data, sim_type):
    """build_topk_neighbors (dense rows) and build_topk_neighbors_rows
    (padded rows, binarised on the device) return cdae_tpu's numpy lists,
    with k = min(topk, max(N - 1, 1)) on a 5-row catalog."""
    from cdae_tpu_torch.data.dataset import rows_from_csr

    (jtrain, _), (ttrain, _) = data
    binary = jtrain.dense_matrix(binary=True).T  # items x users
    want = jsim.build_topk_neighbors(binary, sim_type, 10, 100)
    got = tsim.build_topk_neighbors(binary, sim_type, 10, 100, device="cpu")
    rows, _, _, _ = rows_from_csr(ttrain.csr_by_item(),
                                  np.arange(ttrain.num_items),
                                  ttrain.num_users)
    got_rows = tsim.build_topk_neighbors_rows(rows, ttrain.num_users,
                                              sim_type, 10, 100,
                                              device="cpu")
    for a, b, c in zip(got, got_rows, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    small = binary[:5]
    w_ids, w_sims = jsim.build_topk_neighbors(small, sim_type, 50)
    g_ids, g_sims = tsim.build_topk_neighbors(small, sim_type, 50,
                                              device="cpu")
    assert g_ids.shape == (5, 4)
    np.testing.assert_array_equal(g_ids, w_ids)
    np.testing.assert_array_equal(g_sims, w_sims)


@pytest.mark.parametrize("mode", ["auto", "pallas"])
@pytest.mark.parametrize("name", MODELS)
def test_scores_and_topk_match(data, name, mode, monkeypatch):
    """batch_scores to 1e-6 (the scatter-add's plain route and B8's plain
    version alike), the top-10 lists wherever no tie straddles the cut,
    and predict."""
    from cdae_tpu_torch.ops import scatter

    real = scatter.scatter_add_rows
    monkeypatch.setattr(tsim, "scatter_add_rows",
                        lambda *a, **kw: real(*a, **{**kw, "mode": mode}))
    jm, js, tm, ts = _pair(name, data)
    pb = js.padded
    uids = np.arange(0, js.num_users, 3)
    want = np.asarray(jm.batch_scores(js, uids, pb.items[uids],
                                      pb.mask[uids]))
    got = tm.batch_scores(ts, uids, pb.items[uids], pb.mask[uids])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    ids, vals = topk_unrated(got, torch.from_numpy(pb.items[uids]), 11)
    from cdae_tpu.ops.topk import topk_unrated as jtopk

    w_ids, _ = jtopk(jnp.asarray(want), jnp.asarray(pb.items[uids]), 10)
    sure = (vals[:, 9] - vals[:, 10]).numpy() > 1e-6
    assert sure.sum() > len(uids) // 2
    np.testing.assert_array_equal(ids[:, :10].numpy()[sure],
                                  np.asarray(w_ids)[sure])
    users, items = uids[:20], np.arange(20) % js.num_items
    np.testing.assert_allclose(tm.predict(ts, users, items).numpy(),
                               np.asarray(jm.predict(js, users, items)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", MODELS)
def test_topn_row_matches(data, name):
    """The TOPN row equals cdae_tpu's, with the port's own neighbour lists
    and with cdae_tpu's carried over by params_from_numpy (int32 ids)."""
    from cdae_tpu_torch.utils.checkpoint import params_from_numpy

    (jtrain, jtest), (ttrain, ttest) = data
    jm, js, tm, ts = _pair(name, data)
    carried = params_from_numpy({k: np.asarray(v)
                                 for k, v in js.params.items()}, "cpu")
    assert carried["nbr_ids"].dtype == torch.int32
    pb = js.padded
    uids = np.arange(0, js.num_users, 5)
    assert torch.equal(
        tm.batch_scores(ts, uids, pb.items[uids], pb.mask[uids]),
        tm.batch_scores(type(ts)(carried, ts.padded, ts.num_users,
                                 ts.num_items), uids, pb.items[uids],
                        pb.mask[uids]))
    want = JEvaluation.create("TOPN").evaluate(jm, js, jtest, jtrain)
    got = TEvaluation.create("TOPN").evaluate(tm, ts, ttest, ttrain)
    for col in ("P@10", "R@10", "MAP@10"):
        assert got[col] == pytest.approx(want[col], abs=1e-6), col
    assert got["R@10"] > 0.05
    assert tm.train_one_iteration(ts, 0) is ts and tm.data_loss(ts) == 0.0


def test_registry_config_and_refusals():
    for name, cls in (("itemcf", tsim.ItemCF), ("USERCF", tsim.UserCF)):
        assert isinstance(tmodels.create_model(name, device="cpu"), cls)
    cfg = tsim.SimilarityConfig()
    assert (cfg.sim_type, cfg.topk, cfg.block_size) == ("JACCARD", 50, 1024)
    # sharded=True is the mesh-parallel build now (one process: the whole
    # graph on its one rank), no longer a refusal
    one = TInteractions.from_arrays([0, 1], [0, 0])
    got = tsim.ItemCF(tsim.SimilarityConfig(sharded=True),
                      device="cpu").reset(one).params
    want = tsim.ItemCF(tsim.SimilarityConfig(sharded=False),
                       device="cpu").reset(one).params
    for k in want:
        assert torch.equal(got[k], want[k])
    with pytest.raises(ValueError, match="sim_type"):
        tsim.UserCF(sim_type="PEARSON", device="cpu")


@pytest.mark.parametrize("method,sim_type", [("ITEMCF", "JACCARD"),
                                             ("USERCF", "COSINE")])
def test_cli_trains_and_test_task_restores(movielens_path, tmp_path, method,
                                           sim_type):
    """--method ITEMCF / USERCF through the CLI on the CPU (Popularity
    first); the checkpoint's nbr_ids come back int32 through --task test,
    which scores what the training run scored."""
    from cdae_tpu_torch.utils.checkpoint import load_checkpoint

    data = JInteractions.from_text(movielens_path, jparser)
    cache = str(tmp_path / "all.bin")
    jio.save_interactions(data, cache)
    ckpt = str(tmp_path / "cf.ckpt")
    argv = ["--task", "train", "--method", method, "--device", "cpu",
            "--cache_file", cache, "--sim_type", sim_type, "--sim_topk", "7",
            "--max_iters", "1", "--checkpoint", ckpt]
    solver = tcli.train(tcli.build_arg_parser().parse_args(argv))
    model = solver.model
    assert type(model).__name__ == {"ITEMCF": "ItemCF",
                                    "USERCF": "UserCF"}[method]
    assert (model.cfg.sim_type, model.cfg.topk) == (sim_type, 7)
    row = solver.history[-1]
    assert row["iter"] == 1.0 and 0.0 < row["R@10"] <= 1.0
    jtrain, jtest = data.split_by_user(0.2, seed=SEED)
    tr, te = str(tmp_path / "tr.bin"), str(tmp_path / "te.bin")
    jio.save_interactions(jtrain, tr)
    jio.save_interactions(jtest, te)
    state = load_checkpoint(ckpt, model.reset(jio.load_interactions(tr)))
    assert state.params["nbr_ids"].dtype == torch.int32
    assert torch.equal(state.params["nbr_ids"],
                       solver.state.params["nbr_ids"])
    got = tcli.run(["--task", "test", "--method", method, "--device", "cpu",
                    "--sim_type", sim_type, "--sim_topk", "7",
                    "--train_cache_file", tr, "--test_cache_file", te,
                    "--init_checkpoint", ckpt])
    assert got["R@10"] == pytest.approx(row["R@10"], abs=1e-6)

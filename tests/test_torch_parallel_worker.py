"""The rank program of the multi-process tests of cdae_tpu_torch.parallel,
and the helpers that spawn its worlds (pytest collects no test here).

Each rank imports only torch, numpy and cdae_tpu_torch, joins a gloo group
through a ``file://`` rendezvous (never a TCP port: several test workers
run at once), builds its ('data', 'model') mesh and runs every case on the
CPU; rank 0 writes the results to an npz that parametrised tests read:

  python tests/test_torch_parallel_worker.py RANK WORLD N_MODEL RDV IN OUT

Cases (``CASES``): every sharded trainer two epochs from the same seeds
as its single-device model (``models``), with the tables gathered and the
TOPN R@10 of the sharded model's own evaluation; a sharded checkpoint
saved after epoch 1 and resumed; and the deterministic pieces held against
cdae_tpu by the tests -- the distributed top-k of a score matrix, CDAE's
sharded scores, two ALS / WRMF iterations, each from cdae_tpu's tables
before it, and the
sharded neighbour build (inputs from ``IN``, written by the test).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

EPOCHS = 2
SEED = 3  # reset seed
SOLVER_SEED = 5  # the step seeds' solver seed
# the ALS / WRMF sweeps' data: dense enough that every row with data has
# at least 2 * D observations (full-rank Grams: the port's ALS tolerance)
SWEEP_DATA = {"n": 2400}
SWEEP_D = 4


def tiny(num_users=48, num_items=64, seed=2, n=700):
    """The synthetic interactions of a case (the port's Interactions)."""
    from cdae_tpu_torch.data.dataset import Interactions

    rng = np.random.default_rng(seed)
    pairs = np.unique(rng.integers(0, num_users * num_items, n))
    ratings = rng.integers(1, 6, len(pairs)).astype(np.float32)
    data = Interactions.from_arrays(
        (pairs // num_items).astype(np.int32),
        (pairs % num_items).astype(np.int32), ratings,
        num_users=num_users, num_items=num_items)
    return data.split_by_user(0.25, seed=9)


def models(name: str, mesh=None):
    """(single-device model, its sharded wrapper over ``mesh`` or None,
    data kwargs) of a case, on the CPU."""
    import dataclasses

    from cdae_tpu_torch.models import (ALS, BPR, CDAE, FISM, IMF, PMF, WARP,
                                       WRMF, ALSConfig, CDAEConfig,
                                       FactorModelConfig, FISMConfig,
                                       MFConfig, NegMF)
    from cdae_tpu_torch.parallel import trainer as T
    from cdae_tpu_torch.parallel.tp_pairwise import ShardedMFTP

    dev = "cpu"
    cdae = CDAEConfig(num_dim=8, loss="SQUARE", corruption_ratio=0.3,
                      num_neg=2, batch_size=16, use_pallas=True,
                      fast_rng=True)
    mf = MFConfig(num_dim=8, num_neg=2, batch_size=32, dense_mode=False,
                  use_pallas=True, fast_rng=True)
    warp = dataclasses.replace(mf, loss="HINGE", lambda_=0.1, beta=0.0,
                               num_tries=6)
    als = ALSConfig(num_dim=6, lambda_=0.1, scalar=5.0, solve_batch=16)
    data = {}
    if name == "cdae_dense":
        cfg = dataclasses.replace(cdae, dense_mode=True)
        single, wrap = CDAE(cfg, device=dev), lambda: T.ShardedCDAE(cfg, mesh)
    elif name == "cdae_sparse":
        cfg = dataclasses.replace(cdae, dense_mode=False)
        single, wrap = CDAE(cfg, device=dev), lambda: T.ShardedCDAE(cfg, mesh)
    elif name == "cdae_pool":
        cfg = dataclasses.replace(cdae, dense_mode=False, neg_pool=24,
                                  asymmetric=True)
        single, wrap = CDAE(cfg, device=dev), lambda: T.ShardedCDAE(cfg, mesh)
    elif name == "imf_slab":
        cfg = MFConfig(num_dim=6, num_neg=3, batch_size=16, dense_mode=True,
                       use_pallas=True, fast_rng=True)
        single, wrap = IMF(cfg, device=dev), lambda: T.ShardedIMF(cfg, mesh)
    elif name == "fism":
        cfg = FISMConfig(num_dim=6, num_neg=2, batch_size=16, dense_mode=True)
        single, wrap = FISM(cfg, device=dev), lambda: T.ShardedFISM(cfg, mesh)
    elif name in ("als", "wrmf"):
        cls, wcls = (ALS, T.ShardedALS) if name == "als" else (
            WRMF, T.ShardedWRMF)
        single, wrap = cls(als, device=dev), lambda: wcls(als, mesh)
    elif name == "negmf":
        cfg = FactorModelConfig(num_dim=6, num_neg=2, loss="LOG",
                                batch_size=32, using_global_mean=False)
        single = NegMF(cfg, device=dev)
        wrap = lambda: T.ShardedNegMF(NegMF(cfg, device=dev), mesh)  # noqa
    elif name.startswith(("pw_", "tp_")):
        kind = name[3:]
        cls = {"bpr": BPR, "warp": WARP, "imf": IMF, "pmf": PMF}[kind]
        cfg = warp if kind == "warp" else mf
        if name == "tp_warp":  # ShardedMFTP: WARP's scan path
            cfg = dataclasses.replace(cfg, dense_mode=False)
        single = cls(cfg, device=dev)
        wcls = T.ShardedPairwise if name.startswith("pw_") else ShardedMFTP
        wrap = lambda: wcls(cls(cfg, device=dev), mesh)  # noqa: E731
        if name == "tp_bpr":
            data = {"num_items": 63}  # an item table that needs padding
    else:
        raise KeyError(name)
    return single, (wrap() if mesh is not None else None), data


CASES = ("cdae_dense", "cdae_sparse", "cdae_pool", "imf_slab", "fism", "als",
         "wrmf", "negmf", "pw_bpr", "pw_warp", "pw_imf", "pw_pmf", "tp_bpr",
         "tp_warp", "tp_imf", "tp_pmf")
# the cases whose rank holds a block of dense_R
DENSE_CASES = ("cdae_dense", "imf_slab", "fism")


def train_single(name: str):
    """The single-device reference of a case: tables after EPOCHS epochs
    and TOPN R@10 (RMSE for PMF)."""
    single, _, data_kw = models(name)
    train, test = tiny(**data_kw)
    state = single.reset(train, seed=SEED)
    for _ in range(EPOCHS):
        single.train_one_iteration(state, SOLVER_SEED)
    return ({k: v.numpy() for k, v in state.params.items()},
            _metric(name, single, state, train, test))


def single_dense_loss() -> float:
    """The single-device dense CDAE's data_loss after EPOCHS epochs."""
    single, _, _ = models("cdae_dense")
    train, _ = tiny()
    state = single.reset(train, seed=SEED)
    for _ in range(EPOCHS):
        single.train_one_iteration(state, SOLVER_SEED)
    return single.data_loss(state)


def _metric(name, model, state, train, test) -> float:
    from cdae_tpu_torch.evaluation import Evaluation

    kind = "RMSE" if name.endswith("pmf") else "TOPN"
    res = Evaluation.create(kind).evaluate(model, state, test, train)
    return float(res["RMSE" if kind == "RMSE" else "R@10"])


def write_inputs(path: str) -> dict:
    """The deterministic pieces' inputs (written to ``path`` for the ranks)
    and cdae_tpu's answers on them, on the conftest's fake 8-device mesh
    (4 x 2). Called by the tests: it imports cdae_tpu (jax)."""
    import jax
    import jax.numpy as jnp

    from cdae_tpu.data.dataset import Interactions as JInteractions
    from cdae_tpu.models.als import ALS as JALS, ALSConfig as JALSConfig
    from cdae_tpu.models.cdae import CDAE as JCDAE, CDAEConfig as JCDAEConfig
    from cdae_tpu.models.similarity import (
        build_topk_neighbors_sharded as jnbr)
    from cdae_tpu.parallel import trainer as JT
    from cdae_tpu.parallel.mesh import make_mesh as jmesh
    from cdae_tpu.parallel.sharded import (make_sharded_scores,
                                           shard_cdae_state)
    from cdae_tpu.parallel.topk import distributed_topk_unrated as jtopk

    mesh = jmesh(n_data=4, n_model=2)
    rng = np.random.default_rng(20141119)
    ins, want = {}, {}
    scores = rng.standard_normal((16, 64)).astype(np.float32)
    rated = np.sort(np.stack([rng.choice(64, 6, replace=False)
                              for _ in range(16)]), axis=1).astype(np.int32)
    ins["topk_scores"], ins["topk_rated"] = scores, rated
    ids, vals = jtopk(mesh, jnp.asarray(scores), jnp.asarray(rated), 10)
    want["topk/ids"], want["topk/vals"] = np.asarray(ids), np.asarray(vals)

    train, _ = tiny()
    jtrain = JInteractions.from_arrays(train.users, train.items,
                                       train.ratings, train.num_users,
                                       train.num_items)
    jm = JCDAE(JCDAEConfig(num_dim=8, loss="SQUARE", corruption_ratio=0.3,
                           num_neg=2, batch_size=16, dense_mode=False,
                           use_pallas=False))
    jstate = jm.reset(jtrain, seed=0)
    for k, v in jstate.params.items():
        ins[f"cdae/{k}"] = np.asarray(v)
    pb = jtrain.padded()
    uids = np.arange(16, dtype=np.int32)
    ins["score_uids"] = uids
    ins["score_items"], ins["score_mask"] = pb.items[uids], pb.mask[uids]
    psh = shard_cdae_state(mesh, jstate.params)
    want["scores"] = np.asarray(make_sharded_scores(jm, mesh, psh)(
        psh, jnp.asarray(uids), jnp.asarray(pb.items[uids]),
        jnp.asarray(pb.mask[uids])))

    strain, _ = tiny(**SWEEP_DATA)
    jstrain = JInteractions.from_arrays(strain.users, strain.items,
                                        strain.ratings, strain.num_users,
                                        strain.num_items)
    for counts in (np.bincount(strain.users), np.bincount(strain.items)):
        assert counts[counts > 0].min() >= 2 * SWEEP_D
    cfg = JALSConfig(num_dim=SWEEP_D, lambda_=0.1, scalar=5.0,
                     solve_batch=16)
    for name, cls in (("als", JT.ShardedALS), ("wrmf", JT.ShardedWRMF)):
        init = JALS(cfg).reset(jstrain, seed=0).params
        for k in ("p", "q"):
            ins[f"{name}_init/{k}"] = np.asarray(init[k])
        sh = cls(cfg, mesh=mesh)
        st = sh.reset(jstrain, seed=0)
        st.params = {k: jnp.asarray(ins[f"{name}_init/{k}"])
                     for k in ("p", "q")}
        # each iteration from the same tables: cdae_tpu's first iteration
        # is the port's second one's input
        for it in (1, 2):
            st = sh.train_one_iteration(st, None)
            for k in ("p", "q"):
                ins[f"{name}_iter{it}/{k}"] = np.asarray(st.params[k])
                want[f"{name}_sweeps{it}/{k}"] = ins[f"{name}_iter{it}/{k}"]

    import tempfile

    from cdae_tpu.utils import checkpoint as jckpt

    with tempfile.TemporaryDirectory() as d:
        jckpt.save_sharded(os.path.join(d, "ck"), jstate,
                           fingerprint="f" * 16, extra={"epoch": 1})
        want["ckpt/manifest_keys"] = sorted(
            jckpt.sharded_manifest(os.path.join(d, "ck")))

    binary = (rng.random((100, 70)) < 0.1).astype(np.int8)
    ins["binary"] = binary
    for sim in ("JACCARD", "COSINE"):
        i, s = jnbr(binary, sim, 10)
        want[f"nbr_{sim}/ids"], want[f"nbr_{sim}/sims"] = i, s
    np.savez(path, **ins)
    del jax
    return want


def run_worlds(base, worlds: dict):
    """Every world of ``worlds`` (name -> (processes, n_model)) spawned at
    once on cdae_tpu's inputs, the single-device references taken while
    they run: (results by world, references by case, cdae_tpu's answers)."""
    inp = str(base / "inputs.npz")
    want = write_inputs(inp)
    heads = {w: spawn_world(str(base / w), n, nm, inp)
             for w, (n, nm) in worlds.items()}
    refs = {case: train_single(case) for case in CASES}
    refs["_loss"] = single_dense_loss()
    outs = {w: dict(np.load(wait_world(h))) for w, h in heads.items()}
    return outs, refs, want


def check_trainer(got, case: str, ref, exact: bool) -> None:
    """A case's gathered tables and metric against the single-device run:
    bit for bit (``exact``), else rtol 1e-4 / atol 1e-5 and 0.005."""
    params, metric = ref
    for k, want in params.items():
        g = got[f"{case}/{k}"]
        if exact:
            np.testing.assert_array_equal(g, want, err_msg=k)
        else:
            np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    assert abs(float(got[f"{case}/metric"]) - metric) <= (
        0.0 if exact else 0.005)


def check_dense_blocks(got, case: str, n_data: int, n_model: int,
                       ref_loss: float, exact: bool) -> None:
    """A rank holds its (U / n_data, I / n_model) block of dense_R and no
    whole matrix; the sharded dense CDAE's data_loss, summed from the
    blocks, is the single device's (bit for bit at world 1, else rtol
    1e-4)."""
    train, _ = tiny()
    U, I = train.num_users, train.num_items
    want = (U // n_data if U % n_data == 0 else U,
            I // n_model if I % n_model == 0 else I)
    assert tuple(got[f"{case}/dense_R_block_shape"]) == want
    assert not bool(got[f"{case}/dense_R_whole"])
    if case == "cdae_dense":
        import pytest

        loss = float(got["cdae_dense/data_loss"])
        assert loss == (ref_loss if exact else pytest.approx(ref_loss,
                                                             rel=1e-4))


def check_pieces(got, want):
    ids, vals = got["topk/ids"], got["topk/vals"]
    np.testing.assert_allclose(vals, want["topk/vals"], rtol=1e-5)
    # ids equal wherever the next score is more than 1e-5 away
    gap = np.abs(np.diff(want["topk/vals"], axis=1)) > 1e-5
    sure = np.concatenate([gap[:, :1], gap[:, 1:] & gap[:, :-1],
                           gap[:, -1:]], axis=1)
    np.testing.assert_array_equal(ids[sure], want["topk/ids"][sure])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5,
                               atol=1e-6)
    # WRMF's confidence-weighted Grams (scalar * r up to 25) carry the BLAS
    # order noise of an iteration's user sweep into its item sweep: on
    # this data the single-device port and cdae_tpu's single-device WRMF
    # differ by 4.2e-5 after their second iteration, so WRMF takes 1e-4
    for name, tol in (("als", 1e-5), ("wrmf", 1e-4)):
        for it in (1, 2):
            for k in ("p", "q"):
                w = want[f"{name}_sweeps{it}/{k}"]
                np.testing.assert_allclose(
                    got[f"{name}_sweeps{it}/{k}"], w, rtol=tol,
                    atol=tol * max(1.0, float(np.abs(w).max())),
                    err_msg=f"{name} iteration {it} {k}")
    for sim in ("JACCARD", "COSINE"):
        np.testing.assert_array_equal(got[f"nbr_{sim}/ids"],
                                      want[f"nbr_{sim}/ids"])
        np.testing.assert_allclose(got[f"nbr_{sim}/sims"],
                                   want[f"nbr_{sim}/sims"], rtol=1e-6)


def check_checkpoint(got, want):
    """Resumed bit for bit at step 2, both refusals, cdae_tpu's manifest
    keys (both saved with a fingerprint and no random key)."""
    assert bool(got["ckpt/bitwise"])
    assert int(got["ckpt/step"]) == 2
    assert list(got["ckpt/refused"]) == [True, True]
    assert list(got["ckpt/manifest_keys"]) == want["ckpt/manifest_keys"]


# ------------------------------------------------------------ the ranks ----

def _run(rank: int, world: int, n_model: int, rdv: str, inp: str,
         out: str) -> None:
    import torch

    from cdae_tpu_torch.parallel.distributed import initialize, shutdown
    from cdae_tpu_torch.parallel.mesh import make_mesh, shard_params
    from cdae_tpu_torch.utils import checkpoint as ckpt

    torch.set_num_threads(1)
    assert initialize(f"file://{rdv}", world, rank, device="cpu")
    mesh = make_mesh(n_model=n_model, device="cpu")
    res = {"mesh_shape": np.array([mesh.shape["data"], mesh.shape["model"]])}
    errors = []
    for args in ({"n_data": 3}, {"n_model": 3}, {"n_data": 2 * world}):
        try:
            make_mesh(device="cpu", **args)
            errors.append("")
        except ValueError as e:
            errors.append(str(e))
    res["mesh_errors"] = np.array(errors)
    for name in CASES:
        _, model, data_kw = models(name, mesh)
        train, test = tiny(**data_kw)
        state = model.reset(train, seed=SEED)
        for _ in range(EPOCHS):
            model.train_one_iteration(state, SOLVER_SEED)
        for k, v in model.gathered(state).params.items():
            res[f"{name}/{k}"] = v.numpy()
        if name in DENSE_CASES:
            res[f"{name}/dense_R_block_shape"] = np.array(
                state.aux["dense_R_block"].shape)
            res[f"{name}/dense_R_whole"] = np.array("dense_R" in state.aux)
        if name == "cdae_dense":
            res[f"{name}/data_loss"] = np.array(model.data_loss(state))
        res[f"{name}/metric"] = np.array(
            _metric(name, model, state, train, test))
    ins = np.load(inp)

    # -- a sharded checkpoint after epoch 1 resumes bit for bit
    from cdae_tpu_torch.parallel.trainer import ShardedCDAE

    _, model, _ = models("cdae_dense", mesh)
    train, test = tiny()
    state = model.reset(train, seed=SEED)
    fp = ckpt.config_fingerprint(model, state)
    path = os.path.join(os.path.dirname(rdv), "sharded.ckpt")
    model.train_one_iteration(state, SOLVER_SEED)
    ckpt.save_sharded(path, state, fingerprint=fp, extra={"epoch": 1})
    model.train_one_iteration(state, SOLVER_SEED)
    unbroken = model.gathered(state).params
    fresh = model.reset(train, seed=SEED + 1)
    ckpt.load_sharded(path, fresh, expect_fingerprint=fp)
    model.train_one_iteration(fresh, SOLVER_SEED)
    resumed = model.gathered(fresh).params
    res["ckpt/bitwise"] = np.array(all(torch.equal(unbroken[k], resumed[k])
                                       for k in unbroken))
    res["ckpt/step"] = np.array(fresh.step)
    res["ckpt/manifest_keys"] = np.array(sorted(ckpt.sharded_manifest(path)))
    refused = []
    try:
        ckpt.load_sharded(path, model.reset(train, seed=SEED),
                          expect_fingerprint="0" * 16)
    except ValueError as e:
        refused.append("fingerprint" in str(e))
    other, _ = tiny(num_users=40)
    try:
        ckpt.load_sharded(path, ShardedCDAE(model.cfg, mesh).reset(
            other, seed=SEED))
    except ValueError as e:
        refused.append("dims" in str(e))
    res["ckpt/refused"] = np.array(refused)

    # -- the deterministic pieces, on inputs from cdae_tpu
    from cdae_tpu_torch.parallel.topk import distributed_topk_unrated
    from cdae_tpu_torch.utils.checkpoint import params_from_numpy

    scores = torch.as_tensor(ins["topk_scores"])
    rated = torch.as_tensor(ins["topk_rated"])
    coll = mesh.collectives(scores.shape[0], scores.shape[1])
    sl, (lo, hi) = coll.rows(scores.shape[0]), coll.items
    ids, vals = distributed_topk_unrated(mesh, scores[sl, lo:hi].contiguous(),
                                         rated[sl], 10)
    res["topk/ids"] = coll.data_gather(ids).numpy()
    res["topk/vals"] = coll.data_gather(vals).numpy()

    cfg = models("cdae_sparse")[0].cfg
    sh = ShardedCDAE(cfg, mesh)
    state = sh.reset(train, seed=SEED)
    whole = params_from_numpy(
        {k[len("cdae/"):]: ins[k] for k in ins.files if k.startswith("cdae/")},
        "cpu")
    state.params = shard_params(mesh, whole, sh._specs)
    uids = ins["score_uids"]
    res["scores"] = sh.batch_scores(state, uids, torch.as_tensor(
        ins["score_items"]), torch.as_tensor(ins["score_mask"])).numpy()

    strain, _ = tiny(**SWEEP_DATA)
    for name in ("als", "wrmf"):
        _, model, _ = models(name, mesh)
        state = model.reset(strain, seed=SEED)
        for it, src in ((1, "init"), (2, "iter1")):
            state.params = {k: torch.tensor(ins[f"{name}_{src}/{k}"])
                            for k in ("p", "q")}
            model.train_one_iteration(state, 0)
            for k in ("p", "q"):
                res[f"{name}_sweeps{it}/{k}"] = state.params[k].numpy()

    from cdae_tpu_torch.models.similarity import build_topk_neighbors_sharded

    for sim in ("JACCARD", "COSINE"):
        nids, sims = build_topk_neighbors_sharded(ins["binary"], sim, 10,
                                                  mesh=mesh)
        res[f"nbr_{sim}/ids"], res[f"nbr_{sim}/sims"] = nids, sims
    if rank == 0:
        np.savez(out, **res)
    mesh.barrier()
    shutdown()


def spawn_world(tmp_dir: str, world: int, n_model: int, inp: str,
                timeout: float = 240.0) -> subprocess.Popen:
    """Start the ``world`` ranks of one mesh (returns rank 0's process,
    with the others in its ``ranks`` attribute); ``wait_world`` joins."""
    os.makedirs(tmp_dir, exist_ok=True)
    rdv = os.path.join(tmp_dir, "rdv")
    out = os.path.join(tmp_dir, "out.npz")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(n_model), rdv, inp, out],
        cwd=tmp_dir, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    procs[0].ranks = procs
    procs[0].out = out
    procs[0].deadline = time.time() + timeout
    return procs[0]


def wait_world(head: subprocess.Popen) -> str:
    """Wait for every rank (each killed at the deadline); returns the
    results' path, or raises with the ranks' output."""
    logs, codes = [], []
    for p in head.ranks:
        try:
            log, _ = p.communicate(timeout=max(head.deadline - time.time(),
                                               1.0))
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
        logs.append(log)
        codes.append(p.returncode)
    if any(codes) or not os.path.exists(head.out):
        raise RuntimeError(f"ranks exited {codes}:\n" + "\n".join(
            f"--- rank {r}\n{log[-3000:]}" for r, log in enumerate(logs)))
    return head.out


if __name__ == "__main__":
    _run(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5], sys.argv[6])

"""cdae_tpu_torch.parallel in one process, against cdae_tpu on the
conftest's fake 8-device mesh where there is a counterpart: the layouts of
every table and ``_fit_spec``'s rule, a rank's blocks, the mesh's shapes
and errors, the offsets of B1 and B7's plain versions, and the CLI's
``--sharded`` dispatch (the same wrapper class per method, the same
refusals, and at world 1 the same run bit for bit). The multi-process
worlds are tests/test_torch_parallel_train.py and _mesh.py."""

import jax
import numpy as np
import pytest
import torch

from cdae_tpu import cli as jcli
from cdae_tpu.data import io as jio
from cdae_tpu.data.dataset import Interactions as JInteractions
from cdae_tpu.data.dataset import movielens_line_parser as jparser
from cdae_tpu.parallel import mesh as jmesh
from cdae_tpu_torch import cli as tcli
from cdae_tpu_torch.ops.pallas_kernels import (hw_uniform_plain,
                                               warp_violator_select_plain)
from cdae_tpu_torch.parallel import mesh as tmesh


def _jspec(p):
    return tuple(p)


def _tables():
    """Parameter dicts (numpy) of every model family, keyed like the port's
    and cdae_tpu's."""
    from cdae_tpu_torch.models import (ALS, CDAE, FISM, IMF, CDAEConfig,
                                       FISMConfig, MFConfig)
    from cdae_tpu_torch.data.dataset import Interactions

    rng = np.random.default_rng(0)
    pairs = np.unique(rng.integers(0, 32 * 64, 400))
    data = Interactions.from_arrays((pairs // 64).astype(np.int32),
                                    (pairs % 64).astype(np.int32),
                                    num_users=32, num_items=64)
    out = {}
    for name, m in (
        ("cdae", CDAE(CDAEConfig(num_dim=8, asymmetric=True,
                                 user_factor=True, linear_function=True),
                      device="cpu")),
        ("imf", IMF(MFConfig(num_dim=4), device="cpu")),
        ("fism", FISM(FISMConfig(num_dim=4), device="cpu")),
        ("als", ALS(device="cpu")),
    ):
        out[name] = {k: v.numpy() for k, v in m.reset(data).params.items()}
    return out


def test_param_specs_match_cdae_tpu():
    """Per table name, the same axis as cdae_tpu's PartitionSpecs."""
    for name, params in _tables().items():
        fn = "cdae_param_specs" if name == "cdae" else "mf_param_specs"
        got = getattr(tmesh, fn)(params)
        want = getattr(jmesh, fn)(params)
        assert set(got) == set(params)
        for k in params:
            assert got[k] == _jspec(want[k]), (name, k)
    got, want = tmesh.batch_specs(), jmesh.batch_specs()
    assert {k: v for k, v in got.items()} == {
        k: _jspec(v) for k, v in want.items()}


@pytest.mark.parametrize("n_data,n_model", [(4, 2), (8, 1), (2, 4)])
def test_fit_spec_and_blocks(n_data, n_model):
    """``_fit_spec`` replicates a dimension its axis does not divide, as
    cdae_tpu's; ``shard_params`` cuts each rank's contiguous block and
    ``gather_params``' layout puts the blocks back in rank order."""
    jm = jmesh.make_mesh(n_data=n_data, n_model=n_model)
    params = {"W": np.arange(64 * 3, dtype=np.float32).reshape(64, 3),
              "b_prime": np.arange(64, dtype=np.float32),
              "Wu": np.arange(30 * 3, dtype=np.float32).reshape(30, 3),
              "b": np.arange(3, dtype=np.float32)}
    specs = tmesh.cdae_param_specs(params)
    jspecs = jmesh.cdae_param_specs(params)
    blocks = {k: [] for k in params}
    for rank in range(n_data * n_model):
        m = tmesh.Mesh(n_data, n_model, "cpu", rank=rank)
        for k, v in params.items():
            fit = tmesh._fit_spec(m, specs[k], v.shape)
            assert fit == _jspec(jmesh._fit_spec(jm, jspecs[k], v.shape)), k
        got = tmesh.shard_params(m, params, specs)
        for k in params:
            blocks[k].append((m.d, m.m, got[k].numpy()))
    for k, v in params.items():
        fit = tmesh._fit_spec(tmesh.Mesh(n_data, n_model, "cpu"), specs[k],
                              v.shape)
        ax = fit[0] if fit else None
        if ax is None:  # replicated: every rank holds the whole table
            assert all(np.array_equal(b, v) for _, _, b in blocks[k])
            continue
        order = sorted(blocks[k], key=lambda t: (t[0] if ax == "data"
                                                 else t[1]))
        seen = {}
        for d, m, b in order:
            seen.setdefault(d if ax == "data" else m, b)
        np.testing.assert_array_equal(
            np.concatenate([seen[i] for i in sorted(seen)]), v)


def test_make_mesh_one_process_matches_cdae_tpu():
    """One process is a 1 x 1 mesh; the shapes and errors of cdae_tpu's
    make_mesh over one device."""
    one = jax.devices()[:1]
    m = tmesh.make_mesh(device="cpu")
    assert m.shape == jmesh.make_mesh(devices=one).shape
    assert m.size == 1 and (m.d, m.m) == (0, 0)
    for kw in ({"n_model": 2}, {"n_data": 3}, {"n_data": 2, "n_model": 1}):
        with pytest.raises(ValueError) as got:
            tmesh.make_mesh(device="cpu", **kw)
        with pytest.raises(ValueError) as want:
            jmesh.make_mesh(devices=one, **kw)
        assert str(got.value) == str(want.value)


def test_collectives_one_process_are_identities():
    coll = tmesh.make_mesh(device="cpu").collectives(10, 20)
    x = torch.arange(6.0).reshape(2, 3)
    for fn in (coll.data_sum, coll.model_sum, coll.model_gather,
               coll.data_gather):
        assert fn(x) is x
    assert coll.rows(8) == slice(0, 8)
    assert (coll.items, coll.users) == ((0, 20), (0, 10))
    ids = torch.tensor([0, 5, 19, 20])
    assert torch.equal(coll.own_items(ids), ids)
    table = torch.randn(20, 4)
    assert torch.equal(coll.gather_items(table, ids[:3]), table[ids[:3]])


@pytest.mark.parametrize("r0,c0", [(0, 0), (3, 0), (0, 17), (5, 29),
                                   (2**31 - 7, 2**31 - 9)])
def test_hw_uniform_plain_offsets_cut_the_whole_draw(r0, c0):
    """A block drawn at (row_offset, col_offset) equals that block of the
    whole draw; far offsets wrap as the kernel's 32-bit rows do."""
    if r0 > 2**20:  # no whole draw that far: the hash at those rows
        blk = hw_uniform_plain(7, (3, 4), 1, device="cpu", row_offset=r0,
                               col_offset=c0)
        from cdae_tpu.ops.cdae_fused import _hash_uniform
        import jax.numpy as jnp

        r = jnp.asarray(np.arange(r0, r0 + 3, dtype=np.int64)
                        .astype(np.uint32).view(np.int32))[:, None]
        c = jnp.asarray(np.arange(c0, c0 + 4, dtype=np.int64)
                        .astype(np.uint32).view(np.int32))[None, :]
        want = np.asarray(_hash_uniform(jnp.int32(7), r, c, 1))
        np.testing.assert_array_equal(blk.numpy(), want)
        return
    whole = hw_uniform_plain(7, (r0 + 6, c0 + 9), 1, device="cpu")
    blk = hw_uniform_plain(7, (6, 9), 1, device="cpu", row_offset=r0,
                           col_offset=c0)
    assert torch.equal(blk, whole[r0:, c0:])


@pytest.mark.parametrize("noise", ["mshift", "hash"])
def test_warp_select_plain_row_offset_cuts_the_whole_batch(noise):
    g = torch.Generator().manual_seed(3)
    B, I, D, nn = 24, 90, 5, 4
    uv = torch.randn(B, D, generator=g)
    iv, ib = torch.randn(I, D, generator=g), torch.randn(I, generator=g)
    thr = torch.randn(B, generator=g)
    mask = (torch.rand(B, I, generator=g) < 0.2).to(torch.int8)
    nv, j = warp_violator_select_plain(11, uv, iv, ib, thr, mask, nn, noise)
    for lo, hi in ((0, 8), (8, 24), (5, 13)):
        nv2, j2 = warp_violator_select_plain(
            11, uv[lo:hi], iv, ib, thr[lo:hi], mask[lo:hi], nn, noise,
            row_offset=lo)
        assert torch.equal(nv2, nv[lo:hi]) and torch.equal(j2, j[lo:hi])


METHODS = [
    ("CDAE", []), ("IMF", []), ("IMF", ["--shard_items", "true"]),
    ("IMF", ["--dense_mode", "true"]), ("PMF", []), ("BPR", []),
    ("WARP", []), ("WARP", ["--shard_items", "true"]), ("ALS", []),
    ("WRMF", []), ("FISM", []), ("NEGMF", []), ("FISMPAIR", []),
    ("ITEMCF", []), ("USERCF", []), ("LINEAR", []), ("FM", []), ("POP", []),
]


@pytest.mark.parametrize("method,extra", METHODS,
                         ids=[m + "".join(e) for m, e in METHODS])
def test_cli_sharded_dispatch_matches_cdae_tpu(method, extra):
    """--sharded builds the wrapper class cdae_tpu's wrap_sharded builds
    for the method, or refuses it with the same words."""
    argv = ["--method", method, "--sharded", "true", "--device", "cpu",
            "--batch_size", "64"] + extra
    args = tcli.build_arg_parser().parse_args(argv)
    try:
        want = type(jcli.wrap_sharded(jcli.build_model(args), args)).__name__
    except SystemExit as e:
        with pytest.raises(SystemExit) as got:
            tcli._build(args)
        assert str(got.value) == str(e)
        return
    assert type(tcli._build(args)).__name__ == want


@pytest.mark.parametrize("dense", ["true", "false"])
def test_cli_sharded_one_process_is_the_single_device_run(
        movielens_path, tmp_path, dense):
    """--sharded true in one process (a 1 x 1 mesh) trains the same tables
    and evaluates the same rows as the run without it, bit for bit; its
    npz checkpoint (whole tables, written by rank 0) equals the other's."""
    from cdae_tpu_torch.utils.checkpoint import load_checkpoint

    cache = str(tmp_path / "all.bin")
    jio.save_interactions(JInteractions.from_text(movielens_path, jparser),
                          cache)
    base = ["--task", "train", "--method", "CDAE", "--device", "cpu",
            "--skip_popularity", "--cache_file", cache, "--num_dim", "8",
            "--cratio", "0.5", "--scaled", "true", "--num_neg", "3",
            "--batch_size", "16", "--max_iters", "2", "--eval_iters", "1",
            "--dense_mode", dense]
    runs = {}
    for sharded in ("false", "true"):
        ck = str(tmp_path / f"{sharded}.ckpt")
        solver = tcli.train(tcli.build_arg_parser().parse_args(
            base + ["--sharded", sharded, "--checkpoint", ck]))
        runs[sharded] = (solver.history, ck, solver.model)
    (h0, ck0, m0), (h1, ck1, m1) = runs["false"], runs["true"]
    assert type(m1).__name__ == "ShardedCDAE"
    for r0, r1 in zip(h0, h1):
        assert {k: v for k, v in r0.items() if k not in ("time", "TestTime")
                } == {k: v for k, v in r1.items()
                      if k not in ("time", "TestTime")}
    from cdae_tpu_torch.data import io as tio

    train, _ = tio.load_interactions(cache).split_by_user(0.2, seed=20141119)
    s0 = load_checkpoint(ck0, m0.reset(train, seed=0))
    s1 = load_checkpoint(ck1, m0.reset(train, seed=0))
    assert s0.step == s1.step == 2
    for k in s0.params:
        assert torch.equal(s0.params[k], s1.params[k]), k


def test_sharded_neighbour_build_one_process():
    """SimilarityConfig(sharded=True) in one process builds the serial
    graph (the refusal of the earlier slices is gone)."""
    from cdae_tpu_torch.data.dataset import Interactions
    from cdae_tpu_torch.models.similarity import (
        ItemCF, SimilarityConfig, build_topk_neighbors,
        build_topk_neighbors_sharded)

    rng = np.random.default_rng(2)
    binary = (rng.random((50, 40)) < 0.15).astype(np.int8)
    for sim in ("JACCARD", "COSINE"):
        i0, s0 = build_topk_neighbors(binary, sim, 7, block_size=16,
                                      device="cpu")
        i1, s1 = build_topk_neighbors_sharded(binary, sim, 7, device="cpu",
                                              block_size=16)
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(s0, s1)
    u, i = np.nonzero(binary)
    data = Interactions.from_arrays(u.astype(np.int32), i.astype(np.int32),
                                    num_users=50, num_items=40)
    a = ItemCF(SimilarityConfig(sharded=True), device="cpu").reset(data)
    b = ItemCF(SimilarityConfig(sharded=False), device="cpu").reset(data)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])


def test_make_batch_matches_cdae_tpu():
    """sharded.make_batch: cdae_tpu's host batch of the chosen users."""
    from cdae_tpu.parallel.sharded import make_batch as jmake_batch
    from cdae_tpu_torch.data.dataset import Interactions
    from cdae_tpu_torch.parallel.sharded import make_batch

    rng = np.random.default_rng(4)
    pairs = np.unique(rng.integers(0, 40 * 30, 300))
    u, i = (pairs // 30).astype(np.int32), (pairs % 30).astype(np.int32)
    t = Interactions.from_arrays(u, i, num_users=40, num_items=30).padded()
    j = JInteractions.from_arrays(u, i, num_users=40, num_items=30).padded()
    sel = np.array([3, 17, 5, 39, 0])
    for B in (5, 8):
        for got, want in zip(make_batch(t, sel, B), jmake_batch(j, sel, B)):
            np.testing.assert_array_equal(got, np.asarray(want))


def _sharded_cdae_step_is_cdaes(kind, data, mesh):
    """One step of ShardedCDAE over a 1 x 1 mesh (its inner CDAE's step
    under the wrapper's Collectives, on its sharded tables) and of CDAE on
    the first batch: the same tables, bit for bit. ShardedCDAE's epoch and
    loss are the inner CDAE's, not its own."""
    from cdae_tpu_torch.models import CDAE, CDAEConfig
    from cdae_tpu_torch.models import cdae as tcdae
    from cdae_tpu_torch.parallel.trainer import ShardedCDAE

    assert "train_one_iteration" not in vars(ShardedCDAE)
    assert "data_loss" not in vars(ShardedCDAE)
    cfg = CDAEConfig(num_dim=4, batch_size=8, num_neg=2, loss="SQUARE",
                     corruption_ratio=0.3, use_pallas=True, fast_rng=True,
                     dense_mode=kind == "cdae_dense",
                     neg_pool=16 if kind == "cdae_pool" else None)
    sharded = ShardedCDAE(cfg, mesh)
    assert sharded.train_one_iteration == sharded.inner.train_one_iteration
    assert sharded.data_loss == sharded.inner.data_loss
    runs = []
    for model in (CDAE(sharded.cfg, device="cpu"), sharded):
        state = model.reset(data, seed=1)
        inner = getattr(model, "inner", model)
        kw = dict(cfg=inner.cfg, loss=inner.loss, coll=state.aux["coll"])
        R = tcdae._resident_R(state)
        if R is None:
            tcdae._train_step(state.params, *inner._device_batches(state)[0],
                              11, **kw)
        else:
            uids, w = (t[0] for t in inner._dense_batches(state))
            tcdae._dense_train_step(state.params, R, uids, w, 11, **kw)
        runs.append(state.params)
    assert set(runs[0]) == set(runs[1])
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


@pytest.mark.parametrize("kind", ["imf", "fism", "cdae_sparse", "cdae_pool",
                                  "cdae_dense"])
def test_sharded_slab_steps_one_process_are_the_single_steps(kind):
    """make_sharded_mf_dense_step / make_sharded_fism_dense_step over a
    1 x 1 mesh: the single-device slab step, bit for bit; CDAE's sparse
    (exact and pooled) and dense steps: ``_sharded_cdae_step_is_cdaes``."""
    import functools

    from cdae_tpu_torch.data.dataset import Interactions
    from cdae_tpu_torch.models import FISM, IMF, FISMConfig, MFConfig
    from cdae_tpu_torch.models.fism import _fism_dense_step
    from cdae_tpu_torch.parallel import sharded

    rng = np.random.default_rng(6)
    pairs = np.unique(rng.integers(0, 24 * 40, 200))
    data = Interactions.from_arrays((pairs // 40).astype(np.int32),
                                    (pairs % 40).astype(np.int32),
                                    num_users=24, num_items=40)
    mesh = tmesh.make_mesh(device="cpu")
    if kind.startswith("cdae"):
        return _sharded_cdae_step_is_cdaes(kind, data, mesh)
    if kind == "imf":
        model = IMF(MFConfig(num_dim=4, batch_size=8, dense_mode=True,
                             fast_rng=True), device="cpu")
        step = sharded.make_sharded_mf_dense_step(model, mesh, 24, 40)
    else:
        model = FISM(FISMConfig(num_dim=4, batch_size=8, dense_mode=True),
                     device="cpu")
        step = sharded.make_sharded_fism_dense_step(model, mesh, 24, 40)
    runs = []
    for coll in (False, True):
        state = model.reset(data, seed=1)
        R = state.aux["dense_R"]
        if coll:
            state.aux["dense_R_block"] = R
        uids, w = (t[0] for t in model._dense_user_batches(state))
        single = functools.partial(
            model._dense_step if kind == "imf" else _fism_dense_step,
            cfg=model.cfg, loss=model.loss)
        args = ((state.params, R, R, uids, w, (11, 12)) if kind == "imf"
                else (state.params, R, uids, w, 0.05, 11))
        (step if coll else single)(*args)
        runs.append(state.params)
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k

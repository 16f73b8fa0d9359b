"""cdae_tpu_torch's feature-group layer against cdae_tpu's on the same
inputs: GroupedInstances and data/io.py on the same files, the zero-init
AdaGrad rule, each step (LinearModel's, FactorModel's forward and step with
the recsys groups, three groups with two slots in one, and one LIBSVM
group with ragged masks; NegMF's sparse step and dense slab), whole epochs
with the very draws cdae_tpu makes injected, the scores and losses on
carried tables, and the CLI.

Tables are N(0, 0.3) with AdaGrad accumulators at a trained scale (0.5-1.5)
and a quarter of them at zero (untouched), carried across with
``params_from_numpy``. Tolerances: a step within 1e-6 of each table's scale
and an epoch within 1e-5 (f32 sums in another order); the data layer
exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cdae_tpu.models.linear as jlin
import cdae_tpu_torch.models.linear as tlin
from cdae_tpu.data import io as jio
from cdae_tpu.data import synthetic as jsyn
from cdae_tpu.data.instances import GroupedInstances as JGI
from cdae_tpu_torch import cli as tcli
from cdae_tpu_torch import models as tmodels
from cdae_tpu_torch.data import io as tio
from cdae_tpu_torch.data import synthetic as tsyn
from cdae_tpu_torch.data.instances import GroupedInstances as TGI
from cdae_tpu_torch.solver.solver import SGDSolver
from cdae_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

SEED = 20141119
STEP_TOL, EPOCH_TOL = 1e-6, 1e-5


def _close(got, want, tol, msg=""):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=msg)


def _all_close(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], tol, k)


def _gi_equal(a, b):
    for f in ("idx", "vals", "mask", "labels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert tuple(a.group_of) == tuple(b.group_of)
    assert tuple(a.group_dims) == tuple(b.group_dims)
    assert a.total_dim == b.total_dim and len(a) == len(b)
    assert a.num_slots == b.num_slots


@pytest.fixture(scope="module")
def rated():
    """40 x 30 low-rank rated data in both packages, split 0.2."""
    j = jsyn.lowrank_rated(40, 30, 8, seed=3).split_by_user(0.2, seed=3)
    t = tsyn.lowrank_rated(40, 30, 8, seed=3).split_by_user(0.2, seed=3)
    return j, t


@pytest.fixture(scope="module")
def implicit():
    """40 x 30 low-rank implicit data in both packages, user 0 with every
    item rated (its negatives are sentinels)."""
    out = []
    for syn in (jsyn, tsyn):
        d = syn.lowrank_interactions(40, 30, 8, seed=5)
        keep = d.users != 0
        users = np.concatenate([d.users[keep], np.zeros(30, np.int32)])
        items = np.concatenate([d.items[keep], np.arange(30, dtype=np.int32)])
        out.append(type(d)(users, items, np.ones(len(users), np.float32), 40,
                           30))
    return out


# the step cases: (group_of, group_dims) of the instances
CASES = {
    "recsys": ((0, 1), (12, 9)),
    "three_groups": ((0, 1, 2, 2), (7, 5, 11)),
    "libsvm": ((0, 0, 0, 0), (19,)),
}


def _instances(case, n=48, seed=0):
    """numpy (idx, vals, labels, weight, group_of, total) of a step: ids
    in each slot's group, values N(1, 0.5); the LIBSVM case has ragged rows
    (masked slots: id 0, value 0); the last 5 rows padding (weight 0)."""
    group_of, dims = CASES[case]
    rng = np.random.default_rng(seed)
    offs = np.concatenate([[0], np.cumsum(dims)])[:-1]
    idx = np.stack([rng.integers(0, dims[g], n) + offs[g] for g in group_of],
                   axis=1).astype(np.int32)
    vals = (1.0 + 0.5 * rng.standard_normal(idx.shape)).astype(np.float32)
    if case == "libsvm":
        lengths = rng.integers(1, len(group_of) + 1, n)
        mask = np.arange(len(group_of))[None, :] < lengths[:, None]
        idx = np.where(mask, idx, 0).astype(np.int32)
        vals = np.where(mask, vals, 0.0).astype(np.float32)
    labels = rng.integers(1, 6, n).astype(np.float32)
    w = np.ones(n, np.float32)
    w[-5:] = 0.0
    return idx, vals, labels, w, group_of, int(sum(dims))


def _tables(T, D, seed=1, factors=True):
    """numpy tables: N(0, 0.3) w (and V), accumulators in [0.5, 1.5) with a
    quarter of the rows at zero."""
    rng = np.random.default_rng(seed)
    untouched = rng.random(T) < 0.25
    p = {"w": (0.3 * rng.standard_normal(T)).astype(np.float32),
         "w_ag": np.where(untouched, 0.0, rng.uniform(0.5, 1.5, T)
                          ).astype(np.float32)}
    if factors:
        p["V"] = (0.3 * rng.standard_normal((T, D))).astype(np.float32)
        p["V_ag"] = np.where(untouched[:, None], 0.0,
                             rng.uniform(0.5, 1.5, (T, D))).astype(np.float32)
    return p


def _j(p):
    return {k: jnp.array(v) for k, v in p.items()}


def _t(*arrays):
    out = []
    for a in arrays:
        t = torch.from_numpy(np.array(a))
        out.append(t.long() if t.dtype in (torch.int32, torch.int64) else t)
    return out


# ----------------------------------------------------------- data layer ----

def test_grouped_instances_match_cdae_tpu(rated):
    """from_interactions (group 0 users, group 1 items at offset U),
    from_arrays with and without values, head and num_slots equal
    cdae_tpu's."""
    (jtrain, _), (ttrain, _) = rated
    _gi_equal(TGI.from_interactions(ttrain), JGI.from_interactions(jtrain))
    _gi_equal(TGI.from_interactions(ttrain).head(17),
              JGI.from_interactions(jtrain).head(17))
    _gi_equal(TGI.from_interactions(ttrain).head(10 ** 6),
              JGI.from_interactions(jtrain))
    rng = np.random.default_rng(2)
    cols = [rng.integers(0, d, 25) for d in (6, 4, 9)]
    labels = rng.standard_normal(25)
    values = [rng.standard_normal(25) for _ in cols]
    for kw in ({}, {"group_values": values}):
        a = TGI.from_arrays(cols, (6, 4, 9), labels, **kw)
        _gi_equal(a, JGI.from_arrays(cols, (6, 4, 9), labels, **kw))
        assert a.group_of == (0, 1, 2) and a.total_dim == 19


_LIBSVM = """1 3:0.5 7:1.25 2
-1 1:2
0.5\t4:1 5:-1 6:3 9:0.25

2 11
"""


@pytest.mark.parametrize("what", ["libsvm", "dense_vectors", "read_lines",
                                  "split_line", "config_file"])
def test_io_matches_cdae_tpu(tmp_path, what):
    """Each small-file reader of data/io.py on the same file as cdae_tpu's:
    LIBSVM (ragged rows, bare ids, a blank line, a tab), dense vectors
    (with a header), the line stream, the char-set tokenizer and the
    ``key : value`` config files."""
    path = str(tmp_path / "f.txt")
    if what == "libsvm":
        open(path, "w").write(_LIBSVM)
        a, b = tio.load_libsvm(path), jio.load_libsvm(path)
        _gi_equal(a, b)
        assert a.group_of == (0, 0, 0, 0) and a.total_dim == 12
        assert a.mask.sum(1).tolist() == [3, 1, 4, 1]
    elif what == "dense_vectors":
        open(path, "w").write("a b c\n1 2.5 -3\n\n4e-1 5 6\n")
        for kw in ({"skip_header": True}, {"sep": " ", "skip_header": True}):
            np.testing.assert_array_equal(tio.load_dense_vectors(path, **kw),
                                          jio.load_dense_vectors(path, **kw))
    elif what == "read_lines":
        open(path, "w").write("x y\n\nz\n  \nlast")
        got, want = [], []
        assert tio.read_lines(path, got.append) == jio.read_lines(
            path, want.append) == 4
        assert got == want
    elif what == "split_line":
        for line, sep in (("a  b,c", " ,"), (",,a,,", ","), ("", " "),
                          ("u::i::r", "::"), ("one", "xyz")):
            assert tio.split_line(line, sep) == jio.split_line(line, sep)
    else:
        cfg = {"num_dim": "10", "loss": "LOG", "path": "a:b"}
        tio.write_config_file(path, cfg)
        jio.write_config_file(str(tmp_path / "j.txt"), cfg)
        assert open(path).read() == open(tmp_path / "j.txt").read()
        with open(path, "a") as f:
            f.write("no colon here\n\n  spaced :  value  \n")
        assert tio.read_config_file(path) == jio.read_config_file(path)
        assert tio.read_config_file(path)["path"] == "a:b"


# ------------------------------------------------------------ the steps ----

@pytest.mark.parametrize("use", [True, False])
def test_zero_init_adagrad_matches(use):
    """The zero-init rule: untouched entries (acc 0, g 0) do not move, a
    first touch steps by sign(g) * lr; with using_adagrad off, plain SGD
    and the accumulators unchanged."""
    rng = np.random.default_rng(4)
    p = rng.standard_normal((50, 3)).astype(np.float32)
    a = np.where(rng.random((50, 3)) < 0.3, 0.0,
                 rng.uniform(0.5, 1.5, (50, 3))).astype(np.float32)
    g = np.where(rng.random((50, 3)) < 0.3, 0.0,
                 rng.standard_normal((50, 3))).astype(np.float32)
    want_p, want_a = jlin._zero_init_adagrad(jnp.array(p), jnp.array(a),
                                             jnp.array(g), 0.05, use)
    got_p, got_a = tlin._zero_init_adagrad(*_t(p, a, g), 0.05, use)
    _close(got_p, want_p, STEP_TOL)
    _close(got_a, want_a, STEP_TOL)
    untouched = (a == 0) & (g == 0)
    assert np.array_equal(got_p.numpy()[untouched], p[untouched])
    if use:
        first = (a == 0) & (g != 0)
        np.testing.assert_allclose(got_p.numpy()[first],
                                   p[first] - 0.05 * np.sign(g[first]),
                                   rtol=1e-6)
    else:
        assert np.array_equal(got_a.numpy(), a)


@functools.lru_cache(maxsize=None)
def _jax_step(kind, case, terms):
    """cdae_tpu's LinearModel (``kind`` "linear") or FactorModel step on a
    case's instances and tables, once for both of the port's scatter
    modes."""
    idx, vals, labels, w, group_of, T = _instances(case)
    args = map(jnp.asarray, (idx, vals, labels, w))
    loss = jlin.Loss.create("SQUARE")
    if kind == "linear":
        return jlin._linear_step(
            _j(_tables(T, 0, factors=False)), *args, jnp.float32(2.5),
            jnp.float32(0.07), loss=loss, cfg=jlin.LinearModelConfig(
                lambda_=0.05, loss="SQUARE", learn_rate=0.07))
    return jlin._fm_step(
        _j(_tables(T, 4)), *args, jnp.float32(3.0), jnp.float32(0.05),
        loss=loss, group_of=group_of, cfg=jlin.FactorModelConfig(
            num_dim=4, lambda_=0.03, learn_rate=0.05, loss="SQUARE",
            using_bias_term=terms[0], using_factor_term=terms[1]))


@pytest.mark.parametrize("mode", ["auto", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_linear_step_matches(monkeypatch, case, mode):
    """LinearModel's step on each case; "pallas" sums with B8's plain
    version (the card's route)."""
    monkeypatch.setattr(tlin, "_SCATTER_MODE", mode)
    idx, vals, labels, w, group_of, T = _instances(case)
    cfg = dict(lambda_=0.05, loss="SQUARE", learn_rate=0.07)
    p = _tables(T, 0, factors=False)
    want = _jax_step("linear", case, ())
    got = tlin._linear_step(tckpt.params_from_numpy(p, "cpu"),
                            *_t(idx, vals, labels, w), 2.5, 0.07,
                            cfg=tlin.LinearModelConfig(**cfg),
                            loss=tlin.Loss.create("SQUARE"))
    _all_close(got, want, STEP_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_fm_forward_matches(case):
    """The cross-group-only score on each case (the LIBSVM group's pairs
    are all same-group, so its pair term is 0)."""
    idx, vals, _, _, group_of, T = _instances(case)
    p = _tables(T, 4)
    want = jlin._fm_forward(_j(p), jnp.asarray(idx), jnp.asarray(vals),
                            1.5, group_of)
    got = tlin._fm_forward(tckpt.params_from_numpy(p, "cpu"),
                           *_t(idx, vals), 1.5, group_of)
    _close(got, want, STEP_TOL)


@pytest.mark.parametrize("case,mode,terms", [
    (case, mode, (True, True)) for case in CASES for mode in ("auto",
                                                              "pallas")] + [
    ("three_groups", "auto", (True, False)),
    ("three_groups", "auto", (False, True))])
def test_fm_step_matches(monkeypatch, case, mode, terms):
    """FactorModel's step on each case, with the bias and factor terms on
    and off: both updates read the tables as they were before the step
    (one row sum of [contrib_w | contrib_V])."""
    monkeypatch.setattr(tlin, "_SCATTER_MODE", mode)
    idx, vals, labels, w, group_of, T = _instances(case)
    cfg = dict(num_dim=4, lambda_=0.03, learn_rate=0.05, loss="SQUARE",
               using_bias_term=terms[0], using_factor_term=terms[1])
    p = _tables(T, 4)
    want = _jax_step("fm", case, terms)
    got = tlin._fm_step(tckpt.params_from_numpy(p, "cpu"),
                        *_t(idx, vals, labels, w), 3.0, 0.05,
                        cfg=tlin.FactorModelConfig(**cfg),
                        loss=tlin.Loss.create("SQUARE"), group_of=group_of)
    _all_close(got, want, STEP_TOL)


def _negmf_pair(implicit, **kw):
    """cdae_tpu's NegMF + state and the port's (CPU), with the same
    tables (U + I rows, D = 4)."""
    jtrain, ttrain = implicit
    cfg = dict(num_dim=4, num_neg=3, batch_size=32, learn_rate=0.05,
               loss="LOG", using_global_mean=False)
    cfg.update(kw)
    jm = jlin.NegMF(jlin.FactorModelConfig(**cfg))
    tm = tlin.NegMF(tlin.FactorModelConfig(**cfg), device="cpu")
    js, ts = jm.reset(jtrain, seed=0), tm.reset(ttrain, seed=0)
    p = _tables(jtrain.num_users + jtrain.num_items, 4, seed=7)
    js.params = _j(p)
    ts.params = tckpt.params_from_numpy(p, "cpu")
    return jm, js, tm, ts


@pytest.mark.parametrize("loss", ["LOG", "SQUARE"])
def test_negmf_dense_step_matches(implicit, loss):
    """One slab of 48 users (40, then 8 wrap rows repeating uids at weight
    0) with cdae_tpu's (B, I) uniforms injected: LOG labels negatives -1,
    SQUARE 0."""
    jm, js, tm, ts = _negmf_pair(implicit, dense_mode=True, batch_size=48,
                                 loss=loss)
    assert np.array_equal(ts.aux["dense_R"].numpy(),
                          np.asarray(js.aux["dense_R"]))
    uids = (np.arange(48) % 40).astype(np.int32)
    w = (np.arange(48) < 40).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jlin._negmf_dense_step(
        js.params, js.aux["dense_R"], jnp.asarray(uids), jnp.asarray(w),
        jnp.float32(0.0), jnp.float32(0.05), key, cfg=jm.cfg, loss=jm.loss,
        i_off=40)
    u01 = torch.from_numpy(np.array(jax.random.uniform(key, (48, 30))))
    got = tlin._negmf_dense_step(ts.params, ts.aux["dense_R"], *_t(uids, w),
                                 0.0, 0.05, cfg=tm.cfg, loss=tm.loss,
                                 i_off=40, u01=u01)
    _all_close(got, want, STEP_TOL)


def _negmf_sparse_draws(jm, js, key):
    """The permutation and per-step complement uniforms cdae_tpu's fused
    NegMF epoch draws from ``key``."""
    users = js.aux["coo"][0]
    lengths = js.padded.lengths
    n, bs, nn, I = len(users), jm.cfg.batch_size, jm.cfg.num_neg, js.num_items
    nb = max(-(-n // bs), 1)
    kperm, k = jax.random.split(key)
    perm = np.array(jax.random.permutation(kperm, n))
    sel_all = np.concatenate([perm, np.zeros(nb * bs - n, perm.dtype)])
    draws = []
    for b in range(nb):
        k, sub = jax.random.split(k)
        free = np.maximum(I - lengths[users[sel_all[b * bs:(b + 1) * bs]]], 1)
        draws.append({"u": torch.from_numpy(np.array(jax.random.randint(
            sub, (bs, nn), 0, jnp.asarray(free)[:, None], dtype=jnp.int32)))})
    return torch.from_numpy(perm).long(), draws


@pytest.mark.parametrize("loss", ["LOG", "SQUARE"])
def test_negmf_sparse_step_matches(implicit, loss):
    """One NegMF sparse step (batch 512 >= the instances: the whole epoch
    is one step, padded at weight 0) with cdae_tpu's permutation and
    complement draws injected; user 0 rated every item, so its negatives
    are the sentinel id, zero-weighted."""
    jm, js, tm, ts = _negmf_pair(implicit, batch_size=512, loss=loss)
    key = jax.random.PRNGKey(11)
    perm, draws = _negmf_sparse_draws(jm, js, key)
    assert len(draws) == 1
    js = jm.train_one_iteration(js, key)
    tm.train_one_iteration(ts, perm=perm, draws=draws)
    _all_close(ts.params, js.params, STEP_TOL)


def test_negmf_sparse_sentinel_rows_are_zero_weighted():
    """A batch of one user whose complement is empty: every negative is the
    sentinel, weighted 0, so only the positive moves the tables (num_neg 0
    gives the same tables)."""
    cfg = tlin.FactorModelConfig(num_dim=3, num_neg=2, loss="LOG")
    p = tckpt.params_from_numpy(_tables(9, 3, seed=2), "cpu")
    users, items, w = _t(np.zeros(4, np.int64), np.arange(4),
                         np.ones(4, np.float32))
    rated = torch.arange(5, dtype=torch.int32)[None].expand(4, 5)
    lengths = torch.full((4,), 5, dtype=torch.int32)
    got = tlin._negmf_sparse_step(p, users, items, w, rated, lengths, 0.0,
                                  0.1, cfg=cfg, loss=tlin.Loss.create("LOG"),
                                  i_off=4, num_items=5,
                                  u=torch.zeros((4, 2), dtype=torch.int32))
    want = tlin._negmf_sparse_step(p, users, items, w, rated, lengths, 0.0,
                                   0.1,
                                   cfg=dataclasses.replace(cfg, num_neg=0),
                                   loss=tlin.Loss.create("LOG"), i_off=4,
                                   num_items=5)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ----------------------------------------------------------- the epochs ----

@pytest.mark.parametrize("loss", ["LOG", "SQUARE"])
def test_negmf_sparse_epoch_matches(implicit, loss):
    """A whole sparse epoch (batch 32: several steps, the last padded) with
    cdae_tpu's fused epoch's draws injected."""
    jm, js, tm, ts = _negmf_pair(implicit, loss=loss)
    key = jax.random.PRNGKey(5)
    perm, draws = _negmf_sparse_draws(jm, js, key)
    assert len(draws) > 3
    js = jm.train_one_iteration(js, key)
    tm.train_one_iteration(ts, perm=perm, draws=draws)
    _all_close(ts.params, js.params, EPOCH_TOL)


def test_negmf_dense_epoch_matches(implicit):
    """A dense epoch of 16-user slabs (the last wraps) with cdae_tpu's
    per-slab uniforms injected."""
    jm, js, tm, ts = _negmf_pair(implicit, dense_mode=True, batch_size=16)
    key = jax.random.PRNGKey(6)
    draws, k = [], key
    for _ in range(3):
        k, sub = jax.random.split(k)
        draws.append({"u01": torch.from_numpy(np.array(
            jax.random.uniform(sub, (16, 30))))})
    js = jm.train_one_iteration(js, key)
    tm.train_one_iteration(ts, draws=draws)
    assert ts.aux["dense_batches"][0].shape == (3, 16)
    _all_close(ts.params, js.params, EPOCH_TOL)


def _libsvm(tmp_path, n=60, seed=8):
    """A LIBSVM file of ``n`` ragged rows over 25 feature ids."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        ids = np.sort(rng.choice(25, rng.integers(1, 6), replace=False))
        lines.append(f"{rng.integers(1, 6)} " + " ".join(
            f"{i}:{rng.uniform(0.2, 2.0):.3f}" for i in ids))
    path = str(tmp_path / "train.svm")
    open(path, "w").write("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("data", ["rated", "libsvm"])
@pytest.mark.parametrize("name", ["LinearModel", "FactorModel"])
def test_epoch_matches_with_cdae_tpu_permutation(rated, tmp_path, name,
                                                 data):
    """Two epochs (batch 32, the last padded) from the same tables, with
    the permutation cdae_tpu draws from its key injected: on the rated
    recsys data and on a LIBSVM file (one group, ragged rows)."""
    if data == "rated":
        (jdata, _), (tdata, _) = rated
    else:
        path = _libsvm(tmp_path)
        jdata, tdata = jio.load_libsvm(path), tio.load_libsvm(path)
    cfg = dict(batch_size=32, learn_rate=0.05, lambda_=0.02)
    if name == "FactorModel":
        cfg["num_dim"] = 4
    jm = getattr(jlin, name)(getattr(jlin, name + "Config")(**cfg))
    tm = getattr(tlin, name)(getattr(tlin, name + "Config")(**cfg),
                             device="cpu")
    js, ts = jm.reset(jdata, seed=0), tm.reset(tdata, seed=0)
    assert ts.aux["global_mean"] == js.aux["global_mean"]
    p = _tables(js.aux["instances"].total_dim, 4, seed=9,
                factors=name == "FactorModel")
    js.params, ts.params = _j(p), tckpt.params_from_numpy(p, "cpu")
    key = jax.random.PRNGKey(3)
    for _ in range(2):
        key, sub = jax.random.split(key)
        perm = np.random.default_rng(
            np.asarray(jax.random.key_data(sub))[-1]).permutation(
                len(js.aux["instances"]))
        js = jm.train_one_iteration(js, sub)
        tm.train_one_iteration(ts, perm=perm)
    assert ts.step == js.step == 2
    _all_close(ts.params, js.params, EPOCH_TOL)


# ------------------------------------------------- scores, losses, CLI ----

@pytest.mark.parametrize("name", ["LinearModel", "FactorModel", "NegMF"])
def test_scores_and_losses_on_carried_tables(rated, name):
    """predict, batch_scores (FactorModel and NegMF), data_loss over all
    instances and the first 50, and penalty_loss on the same tables; the
    port's RMSE evaluator against cdae_tpu's predictions."""
    from cdae_tpu_torch.evaluation import Evaluation as TEvaluation

    (jtrain, jtest), (ttrain, ttest) = rated
    cfg = dict(num_dim=4) if name != "LinearModel" else {}
    jm = getattr(jlin, name)(getattr(jlin, name.replace("NegMF", "FactorModel")
                                     + "Config")(**cfg))
    tm = getattr(tlin, name)(getattr(tlin, name.replace("NegMF", "FactorModel")
                                     + "Config")(**cfg), device="cpu")
    js, ts = jm.reset(jtrain, seed=0), tm.reset(ttrain, seed=0)
    p = _tables(70, 4, seed=10, factors=name != "LinearModel")
    js.params, ts.params = _j(p), tckpt.params_from_numpy(p, "cpu")
    users, items = jtest.users, jtest.items
    _close(tm.predict(ts, users, items), jm.predict(js, users, items),
           STEP_TOL)
    if name != "LinearModel":
        uids = np.arange(0, 40, 3)
        _close(tm.batch_scores(ts, uids, None, None),
               jm.batch_scores(js, uids, None, None), STEP_TOL)
    for n in (0, 50):
        assert tm.data_loss(ts, n) == pytest.approx(jm.data_loss(js, n),
                                                    rel=STEP_TOL, abs=1e-9)
    assert tm.penalty_loss(ts) == pytest.approx(jm.penalty_loss(js),
                                                rel=STEP_TOL, abs=1e-12)
    err = np.asarray(jm.predict(js, users, items)) - jtest.ratings
    got = TEvaluation.create("RMSE").evaluate(tm, ts, ttest)["RMSE"]
    assert got == pytest.approx(float(np.sqrt(np.mean(err.astype(np.float64)
                                                      ** 2))), rel=1e-5)


def test_registry_and_negmf_defaults(rated):
    """The registry builds the three models; NegMF defaults to LOG only
    without a config and a loss; NegMF refuses GroupedInstances."""
    assert type(tmodels.create_model("linear", device="cpu")) is \
        tlin.LinearModel
    assert type(tmodels.create_model("FM", device="cpu")) is tlin.FactorModel
    assert tmodels.create_model("negmf", device="cpu").cfg.loss == "LOG"
    assert tlin.NegMF(device="cpu", loss="HINGE").cfg.loss == "HINGE"
    assert tlin.NegMF(tlin.FactorModelConfig(), device="cpu").cfg.loss == \
        "SQUARE"
    for cls in ("LinearModelConfig", "FactorModelConfig"):
        jf = {f.name: f.default for f in
              jlin.__dict__[cls].__dataclass_fields__.values()}
        tf = {f.name: f.default for f in
              tlin.__dict__[cls].__dataclass_fields__.values()}
        assert jf.keys() == tf.keys()
        assert {k: v for k, v in jf.items() if k != "dtype"} == \
            {k: v for k, v in tf.items() if k != "dtype"}
    (_, _), (ttrain, _) = rated
    with pytest.raises(ValueError, match="Interactions"):
        tlin.NegMF(device="cpu").reset(TGI.from_interactions(ttrain))


@pytest.mark.parametrize("method,extra", [
    ("LINEAR", ["--eval", "RMSE,MAE"]),
    ("FM", ["--eval", "RMSE"]),
    ("NEGMF", ["--loss_type", "LOG"]),
    ("NEGMF", ["--dense_mode", "true"]),
])
def test_cli_trains_with_sgd_solver(movielens_path, tmp_path, method, extra):
    """--method LINEAR, FM and NEGMF through the CLI on the CPU: SGDSolver
    with --learn_rate, finite metrics; --dense_mode true reaches NegMF's
    slab (and only NegMF takes it); cdae_tpu's model of the same flags
    reads the checkpoint."""
    from cdae_tpu import cli as jcli
    from cdae_tpu.data.dataset import Interactions as JInteractions
    from cdae_tpu.data.dataset import movielens_line_parser as jparser
    from cdae_tpu.utils.checkpoint import load_checkpoint as jload

    cache = str(tmp_path / "all.bin")
    jio.save_interactions(JInteractions.from_text(movielens_path, jparser),
                          cache)
    ckpt = str(tmp_path / "m.ckpt")
    argv = ["--task", "train", "--method", method, "--device", "cpu",
            "--skip_popularity", "--cache_file", cache, "--num_dim", "4",
            "--num_neg", "2", "--batch_size", "32", "--max_iters", "2",
            "--eval_iters", "2", "--learn_rate", "0.05", "--checkpoint",
            ckpt] + extra
    args = tcli.build_arg_parser().parse_args(argv)
    solver = tcli.train(args)
    assert type(solver) is SGDSolver and solver.learn_rate0 == 0.05
    assert solver.model._lr == 0.05
    assert type(solver.model) is {"LINEAR": tlin.LinearModel,
                                  "FM": tlin.FactorModel,
                                  "NEGMF": tlin.NegMF}[method]
    assert ("dense_R" in solver.state.aux) == ("true" in extra)
    row = solver.history[-1]
    assert row["iter"] == 2.0
    for col in args.eval.split(","):
        assert np.isfinite(row["R@10" if col == "TOPN" else col]), col
    assert solver.model.cfg.loss == args.loss_type
    jmodel = jcli.build_model(args)
    assert dataclasses.asdict(jmodel.cfg).keys() == \
        dataclasses.asdict(solver.model.cfg).keys()
    for k, v in dataclasses.asdict(jmodel.cfg).items():
        if k != "dtype":
            assert getattr(solver.model.cfg, k) == v, k
    jtrain, _ = jio.load_interactions(cache).split_by_user(0.2, seed=SEED)
    js = jload(ckpt, jmodel.reset(jtrain, seed=0))
    assert js.step == 2

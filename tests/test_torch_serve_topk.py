"""``RecsysModel.recommend``'s two routes to its top-k: the model's
``batch_topk`` (CDAE's fused decode + top-k: B6 on the sorted rated rows,
B5 on dense_R rows, or the plain streaming loop with the kernels off) where
it answers, else the whole (B, I) slab through ``batch_scores`` and
``topk_unrated``.

On the CPU the kernel wrappers run their plain versions, and lowering
``_TOPK_DEFER_CELLS`` drives the fused route at fixture scale. The same
ids on both routes and as cdae_tpu's ``recommend`` from the same
parameters, for every k up to the kernels' 32 and every serving variant;
``num_items`` in every slot past a user's unrated items (duplicate rated
entries counted once); the lower id first on equal scores; k = 33 and
small requests on the slab route; the route each request takes and the
serving spans on each route. The ``cuda`` case holds B6's route against
the slab route on the card at (1,024, 200,000, 50) by the gap of a served
item's reference score below the reference's at its rank.

This file imports jax only inside the fixture of the parity test, so the
``cuda`` case also runs where jax is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_serve_topk.py
"""

import math

import numpy as np
import pytest
import torch

import cdae_tpu_torch.models.base as tbase
import cdae_tpu_torch.models.cdae as tcdae
from cdae_tpu_torch.data.dataset import Interactions
from cdae_tpu_torch.utils import profiling as prof

torch.set_num_threads(2)

SEED = 20141119
NEVER = 10 ** 18  # a _TOPK_DEFER_CELLS no request reaches: the slab route
BASE = dict(num_dim=8, loss="SQUARE", corruption_ratio=0.5, batch_size=32,
            learn_rate=0.5)
VARIANTS = {  # test_torch_cdae_serve.py's serving variants
    "default": {},
    "asymmetric": dict(asymmetric=True),
    "tanh": dict(tanh=True),
    "linear": dict(linear=True),
    "no_user_factor": dict(user_factor=False),
    "linear_function": dict(linear_function=True),
    "cratio_1": dict(corruption_ratio=1.0),
}
MODES = {  # batch_topk's mode each configuration takes above the threshold
    "fused_csr": dict(use_pallas=True, dense_mode=False),
    "fused_dense": dict(use_pallas=True, dense_mode=True),
    "streaming": dict(use_pallas=False, dense_mode=False),
}
MAX_K = 32


@pytest.fixture(autouse=True)
def clean_tallies():
    prof.reset_tallies()
    yield
    prof.reset_tallies()


def _route_log(monkeypatch) -> list:
    """The route of each later request, in order: "fused" where CDAE's
    ``batch_topk`` answered, "slab" where ``topk_unrated`` ranked the
    (B, I) scores."""
    log = []
    topk, unrated = tcdae.CDAE.batch_topk, tbase.topk_unrated

    def batch_topk(self, *a, **kw):
        ids = topk(self, *a, **kw)
        if ids is not None:
            log.append("fused")
        return ids

    def topk_unrated(*a, **kw):
        log.append("slab")
        return unrated(*a, **kw)

    monkeypatch.setattr(tcdae.CDAE, "batch_topk", batch_topk)
    monkeypatch.setattr(tbase, "topk_unrated", topk_unrated)
    return log


def _routes(monkeypatch, model, state, uids, train, k):
    """(fused route's ids, slab route's ids) of one request."""
    monkeypatch.setattr(tcdae, "_TOPK_DEFER_CELLS", 0)
    fused = model.recommend(state, uids, train, k=k)
    monkeypatch.setattr(tcdae, "_TOPK_DEFER_CELLS", NEVER)
    slab = model.recommend(state, uids, train, k=k)
    return fused, slab


def _sentinel_past_unrated(ids, uids, train):
    """cdae_tpu's ids with num_items in each slot past the user's unrated
    items (where cdae_tpu lists rated ids scored -inf)."""
    out = np.array(ids, copy=True)
    csr, I = train.csr(), train.num_items
    for row, u in enumerate(uids):
        out[row, I - len(set(csr.row(u).tolist())):] = I
    return out


@pytest.fixture(scope="module")
def trained(movielens_path):
    """Per variant: cdae_tpu's CDAE after 3 iterations, its top-32 lists
    for every user (a shorter k's are their prefix: lax.top_k sorts), and
    its parameters as numpy arrays."""
    import jax

    import cdae_tpu.models.cdae as jcdae
    from cdae_tpu.data.dataset import Interactions as JInteractions
    from cdae_tpu.data.dataset import movielens_line_parser as jparser

    jtrain, _ = JInteractions.from_text(movielens_path, jparser) \
        .split_by_user(0.2, seed=SEED)
    uids = np.concatenate([np.arange(jtrain.num_users), [7, 7, 0]])
    out = {}
    for name, kw in VARIANTS.items():
        jm = jcdae.CDAE(jcdae.CDAEConfig(**{**BASE, **kw}, use_pallas=False))
        js = jm.reset(jtrain, seed=0)
        for it in range(3):
            js = jm.train_one_iteration(js, jax.random.PRNGKey(it))
        out[name] = (np.asarray(jm.recommend(js, uids, jtrain, k=MAX_K)),
                     {k: np.asarray(v) for k, v in js.params.items()})
    return uids.astype(np.int32), out


@pytest.fixture(scope="module")
def train(movielens_path):
    from cdae_tpu_torch.data.dataset import movielens_line_parser

    return Interactions.from_text(movielens_path, movielens_line_parser) \
        .split_by_user(0.2, seed=SEED)[0]


def _port(train, variant, mode, params=None):
    from cdae_tpu_torch.utils.checkpoint import params_from_numpy

    model = tcdae.CDAE(tcdae.CDAEConfig(**{**BASE, **VARIANTS[variant]},
                                        **MODES[mode]), device="cpu")
    state = model.reset(train, seed=0)
    assert ("dense_R" in state.aux) == MODES[mode]["dense_mode"]
    if params is not None:
        state.params = params_from_numpy(params, "cpu")
    return model, state


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_both_routes_give_cdae_tpus_ids_for_every_k(trained, train, variant,
                                                    mode, monkeypatch):
    uids, by_variant = trained
    want32, params = by_variant[variant]
    model, state = _port(train, variant, mode, params)
    for k in range(1, MAX_K + 1):
        fused, slab = _routes(monkeypatch, model, state, uids, train, k)
        assert fused.dtype == slab.dtype == torch.int32
        assert tuple(fused.shape) == tuple(slab.shape) == (len(uids), k)
        want = _sentinel_past_unrated(want32[:, :k], uids, train)
        np.testing.assert_array_equal(fused.numpy(), want, err_msg=f"k={k}")
        np.testing.assert_array_equal(slab.numpy(), want, err_msg=f"k={k}")


def _short_rows_data():
    """12 items; user 0 rated all but items 3, 8 and 10 (item 5 twice),
    user 1 nothing, user 2 items 0 and 11, user 3 all but item 6."""
    rows = {0: [i for i in range(12) if i not in (3, 8, 10)] + [5],
            1: [], 2: [0, 11], 3: [i for i in range(12) if i != 6]}
    users = np.array([u for u, r in rows.items() for _ in r], np.int32)
    items = np.array([i for r in rows.values() for i in r], np.int32)
    return Interactions.from_arrays(users, items, num_users=4,
                                    num_items=12), rows


@pytest.mark.parametrize("mode", sorted(MODES))
def test_slots_past_a_users_unrated_items_hold_num_items(mode, monkeypatch):
    data, rows = _short_rows_data()
    model = tcdae.CDAE(tcdae.CDAEConfig(**BASE, **MODES[mode]), device="cpu")
    state = model.reset(data, seed=1)
    uids = np.array([0, 1, 2, 3, 0])
    k = 8
    for ids in _routes(monkeypatch, model, state, uids, data, k):
        ids = ids.numpy()
        for row, u in enumerate(uids):
            unrated = set(range(12)) - set(rows[u])
            n = min(len(unrated), k)
            listed = set(ids[row, :n].tolist())
            assert len(listed) == n and listed <= unrated, (u, ids[row])
            assert (ids[row, n:] == 12).all(), (u, ids[row])
    fused, slab = _routes(monkeypatch, model, state, uids, data, k)
    np.testing.assert_array_equal(fused.numpy(), slab.numpy())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_equal_scores_put_the_lower_id_first(train, mode, monkeypatch):
    """W (the tied decoder) zero but one column of small integers, b' zero:
    each score is z_0 * c_i, exactly equal for equal c_i in any sum order,
    so most of the catalog ties."""
    model, state = _port(train, "default", mode)
    I = train.num_items
    c = torch.from_numpy(np.random.default_rng(5).integers(1, 4, I)) \
        .to(torch.float32)
    with torch.no_grad():
        state.params["W"].zero_()
        state.params["W"][:, 0] = c
        state.params["b_prime"].zero_()
    uids = np.arange(train.num_users)
    scores = model.batch_scores(state, uids, state.padded.items[uids],
                                state.padded.mask[uids]).numpy()
    assert len(np.unique(scores[0])) < I // 4  # ties, many
    csr = train.csr()
    k = 20
    for ids in _routes(monkeypatch, model, state, uids, train, k):
        for row, u in enumerate(uids):
            rated = set(csr.row(u).tolist())
            unrated = np.array([i for i in range(I) if i not in rated])
            # the larger score first, then the lower id
            order = unrated[np.lexsort((unrated, -scores[row, unrated]))]
            want = np.full(k, I)
            want[:min(k, len(order))] = order[:k]
            np.testing.assert_array_equal(ids[row].numpy(), want)


def test_k_past_the_kernels_takes_the_slab_route(train, monkeypatch):
    model, state = _port(train, "default", "fused_csr")
    uids = np.arange(train.num_users)
    rated = state.padded.items[uids]
    mask = state.padded.mask[uids]
    monkeypatch.setattr(tcdae, "_TOPK_DEFER_CELLS", 0)
    assert model.batch_topk(state, uids, rated, mask, MAX_K + 1) is None
    assert model.batch_topk(state, uids, rated, mask, 0) is None
    assert model.batch_topk(state, uids, rated, mask, MAX_K) is not None
    log = _route_log(monkeypatch)
    with torch.profiler.profile():
        fused33, slab33 = _routes(monkeypatch, model, state, uids, train,
                                  MAX_K + 1)
    assert log == ["slab", "slab"]
    np.testing.assert_array_equal(fused33.numpy(), slab33.numpy())
    assert tuple(fused33.shape) == (len(uids), MAX_K + 1)


@pytest.mark.parametrize("route", ["fused", "slab"])
def test_topk_fused_counts_one_per_request_on_the_fused_route(
        train, route, monkeypatch):
    """Each request takes the route its size picks (``batch_topk``
    answers it on the fused route, ``topk_unrated`` on the slab route),
    and holds rows, scores and top-k in that order on either route, each
    once."""
    model, state = _port(train, "default", "fused_csr")
    monkeypatch.setattr(tcdae, "_TOPK_DEFER_CELLS",
                        0 if route == "fused" else NEVER)
    prof.reset_tallies()  # reset's phases
    model.recommend(state, np.arange(8), train, k=5)
    assert prof.tallies() == prof.Tallies({}, {})  # nothing without one
    log = _route_log(monkeypatch)
    with torch.profiler.profile() as p:
        for n in (8, 1, 24):
            model.recommend(state, np.arange(n)[::-1], train, k=5)
    t = prof.tallies()
    assert log == [route] * 3
    assert {n: c for n, (c, _) in t.spans.items()} == {
        "serve.request": 3, "serve.rows": 3, "serve.scores": 3,
        "serve.topk": 3}
    r = {}
    for e in p.events():
        r.setdefault(e.name, []).append((e.time_range.start,
                                         e.time_range.end))
    for j, request in enumerate(sorted(r["serve.request"])):
        parts = [sorted(r[name])[j]
                 for name in ("serve.rows", "serve.scores", "serve.topk")]
        assert all(request[0] <= s and e <= request[1] for s, e in parts)
        assert parts == sorted(parts)


def test_below_the_threshold_recommend_takes_the_slab_route(
        train, monkeypatch):
    """At the real threshold a fixture request (25 users x 38 items) is
    far below 2e8 cells: batch_topk defers to the slab route."""
    model, state = _port(train, "default", "fused_csr")
    uids = np.arange(train.num_users)
    assert model.batch_topk(state, uids, state.padded.items[uids],
                            state.padded.mask[uids], 10) is None
    log = _route_log(monkeypatch)
    with torch.profiler.profile():
        model.recommend(state, uids, train, k=10)
    assert log == ["slab"]


def _reference_gap(ref_scores, served):
    """Per user, the widest gap of a served item's reference score below
    the reference's at its rank (rated items at -inf; a rated, repeated
    or out-of-catalog id reads inf)."""
    I = ref_scores.shape[1]
    ids = served.long()
    best = torch.topk(ref_scores, served.shape[1], dim=1).values
    ok = (ids >= 0) & (ids < I)
    got = torch.gather(ref_scores, 1, ids.clamp(0, I - 1))
    got = torch.where(ok, got, float("-inf"))
    srt = torch.sort(ids, dim=1).values
    repeated = (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    gap = (best - got).clamp(min=0.0).amax(dim=1)
    return torch.where(repeated, float("inf"), gap)


@pytest.mark.cuda
def test_b6_route_against_the_slab_route_on_the_card(monkeypatch):
    """(1,024 users, 200,000 items, D=50), 50 rated items a user, the
    benchmark's weight law: at the real threshold (2.048e8 cells) recommend
    takes B6, and its lists, like the slab route's (B3 and the sort), sit
    within 1e-6 of the plain float32 reference's scores at every rank."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 reference
    from cdae_tpu_torch.models.cdae import CDAE, CDAEConfig
    from cdae_tpu_torch.ops import pallas_kernels as P

    U, I, D, per_user = 1024, 200_000, 50, 50
    rng = np.random.default_rng(SEED)
    users = np.repeat(np.arange(U, dtype=np.int32), per_user)
    items = np.concatenate([rng.choice(I, per_user, replace=False)
                            for _ in range(U)]).astype(np.int32)
    data = Interactions.from_arrays(users, items, num_users=U, num_items=I)
    model = CDAE(CDAEConfig(num_dim=D, dense_mode=False), device="cuda")
    state = model.reset(data, seed=3)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    s = 4.0 * math.sqrt(6.0 / (I + D))
    with torch.no_grad():
        for name in ("W", "Wu"):
            t = state.params[name]
            t.copy_(torch.rand(t.shape, generator=gen, device="cuda")
                    .mul_(2 * s).sub_(s))
    uids = rng.permutation(U)
    launches = P.fused_topk_scores_csr.launches
    fused = model.recommend(state, uids, data, k=10)
    assert P.fused_topk_scores_csr.launches == launches + 1
    monkeypatch.setattr(tcdae, "_TOPK_DEFER_CELLS", NEVER)
    slab = model.recommend(state, uids, data, k=10)
    assert P.fused_topk_scores_csr.launches == launches + 1
    plain = CDAE(CDAEConfig(num_dim=D, dense_mode=False, use_pallas=False),
                 device="cuda")
    pb = data.padded()
    rated = torch.as_tensor(pb.items[uids], device="cuda")
    ref = plain.batch_scores(state, uids, rated,
                             torch.as_tensor(pb.mask[uids], device="cuda"))
    ref = torch.cat([ref, ref.new_zeros((U, 1))], dim=1)  # takes the pads
    ref = ref.scatter_(1, rated.long(), float("-inf"))[:, :I]
    for ids in (fused, slab):
        assert float(_reference_gap(ref, ids).max()) < 1e-6

"""Mult-VAE in the port (cdae_tpu_torch/models/multvae.py) against the
benchmark's plain reference of it (benchmark/reference/multvae.py) on the
CPU at a small size: one batch's forward pass, loss and gradients, the
draws, Adam, whole epochs across a change of the KL weight, serving, the
spans and counter, and the model on the normal path (registry, solver
entry points)."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.harness import compare
from benchmark.reference import multvae as ref
from cdae_tpu_torch.data.dataset import Interactions
from cdae_tpu_torch.models import MODEL_REGISTRY, create_model
from cdae_tpu_torch.models import multvae as mv
from cdae_tpu_torch.ops.losses import multinomial_gradient, multinomial_nll
from cdae_tpu_torch.solver.optimizer import dense_adam_steps
from cdae_tpu_torch.utils import profiling

torch.set_num_threads(2)

CPU = torch.device("cpu")
U, I = 64, 300
# widths cut to the CPU (600-200-600 -> 60-20-60); batch 24, so an epoch
# is three steps, the last of 16 users
CFG = dict(hidden_dim=60, latent_dim=20, batch_size=24)
SEED = 2**31 + 11
# Both sides are float32 on the CPU and draw the same uniforms; only the
# order of the sums differs (the port's embedding_bag, hand-written
# gradients and B8's plain version against the reference's dense products
# and autograd). That moves a value by a few float32 ulps a step: the
# norm of a difference stays under 1e-6 of its table's after an epoch
# here (worst 2.7e-7), and under 1e-5 for a gradient, whose smallest
# tables sum a few hundred terms. A fault of the model's (a missing KL
# term, the wrong anneal step) moves them by 1e-3 and more.
TOL = 1e-5


def _data():
    rng = np.random.default_rng(7)
    users, items = [], []
    for u in range(U - 1):  # the last user rates nothing
        n = int(rng.integers(1, 60)) if u else I - 1  # user 0: all but one
        users += [u] * n
        items += sorted(rng.choice(I, n, replace=False).tolist())
    return Interactions.from_arrays(np.array(users), np.array(items),
                                    num_users=U, num_items=I)


DATA = _data()


def _model(**cfg):
    model = create_model("MULTVAE", device="cpu", **{**CFG, **cfg})
    state = model.reset(DATA, seed=5)
    return model, state


def _rows():
    return ref.Rows(DATA.users, DATA.items, U, I)


def _rated(model, uids):
    """The port's (B, L) rated rows of ``uids`` and their mask."""
    uids = np.asarray(uids, dtype=np.int64)
    return model._rated_rows(uids, torch.as_tensor(uids), DATA)


def _ref_cfg(model):
    return dataclasses.asdict(model.cfg)


def _rel(got, want):
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()))


def _batch(model, state, j):
    """Batch j of epoch 0: its users and the port's slices of them."""
    perm = mv.permutation(SEED, 0, U)
    pairs = model._epoch_pairs(state, perm)
    a, b = mv._batch_users(U, model.cfg.batch_size)[j]
    s, e = int(pairs.ptr[a]), int(pairs.ptr[b])
    return perm[a:b], dict(
        items=pairs.items[s:e], rows=pairs.rows[s:e], flat=pairs.flat[s:e],
        coef=pairs.coef[s:e], offsets=pairs.offsets[a:b],
        lengths=pairs.lengths[a:b], ones=pairs.ones[:e - s])


def test_registry_and_config_defaults():
    assert MODEL_REGISTRY["MULTVAE"] == (mv.MultVAE, mv.MultVAEConfig)
    cfg = mv.MultVAEConfig()
    assert (cfg.hidden_dim, cfg.latent_dim, cfg.dropout, cfg.batch_size) == (
        600, 200, 0.5, 500)
    assert (cfg.learn_rate, cfg.beta1, cfg.beta2, cfg.eps) == (
        1e-3, 0.9, 0.999, 1e-8)
    assert (cfg.anneal_cap, cfg.total_anneal_steps) == (0.2, 200_000)
    assert [mv.kl_weight(cfg, t) for t in (0, 1, 40_000, 10**6)] == [
        0.0, 5e-6, 0.2, 0.2]


@pytest.mark.parametrize("j", [0, 2])
@pytest.mark.parametrize("beta", [0.0, 0.2])
def test_forward_loss_and_gradients_match_autograd(j, beta):
    model, state = _model()
    cfg = model.cfg
    uids, b = _batch(model, state, j)
    seed = ref.step_seed(SEED, 0, j, 0)
    P = {k: state.params[k] for k in mv.LEAVES}
    keep, eps = mv._step_draws(seed, b["items"].shape[0], len(uids), cfg, CPU)
    x = b["coef"] * keep
    h, mu, logvar = mv._encode(P, b["items"], b["offsets"], x, cfg)
    std = torch.exp(0.5 * logvar)
    z = torch.addcmul(mu, eps, std)
    g, logits = mv._decode(P, z)
    grads = mv._gradients(P, (h, mu, logvar, std, z, g, logits), b["items"],
                          b["rows"], b["flat"], x, b["lengths"], b["ones"],
                          eps, beta)

    X = _rows().dense(uids, CPU)
    keep_r = ref.dropout_keep(X, seed, cfg.dropout)
    eps_r = ref.gaussian(seed, len(uids), cfg.latent_dim, CPU)
    leaves = {k: v.clone().requires_grad_() for k, v in P.items()}
    logits_r, mu_r, logvar_r = ref.forward(leaves, X, keep_r, eps_r,
                                           _ref_cfg(model))
    for got, want in ((logits, logits_r), (mu, mu_r), (logvar, logvar_r)):
        assert _rel(got, want.detach()) < 1e-6
    value = ref.loss(leaves, X, keep_r, eps_r, beta, _ref_cfg(model))
    items, mask = _rated(model, uids)
    nll = multinomial_nll(logits, items, mask)
    kl = 0.5 * (-logvar + torch.exp(logvar) + mu * mu - 1.0)
    assert float(nll.mean() + beta * kl.sum(dim=1).mean()) == pytest.approx(
        float(value.detach()), rel=1e-6)
    want = torch.autograd.grad(value, [leaves[k] for k in mv.LEAVES])
    for k, w in zip(mv.LEAVES, want):
        assert _rel(grads[k], w) < TOL, k
    # W_q1's rows of items nobody in the batch kept read exactly zero
    kept = torch.zeros(I, dtype=torch.bool)
    kept[b["items"][keep]] = True
    assert torch.all(grads["W_q1"][~kept] == 0)


@pytest.mark.parametrize("j", [0, 1, 2])
def test_draws_are_the_references_bit_for_bit(j):
    model, state = _model()
    uids, b = _batch(model, state, j)
    seed = ref.step_seed(SEED, 0, j, 0)
    keep, eps = mv._step_draws(seed, b["items"].shape[0], len(uids),
                               model.cfg, CPU)
    X = _rows().dense(uids, CPU)
    keep_r = ref.dropout_keep(X, seed, model.cfg.dropout)
    assert torch.equal(keep.float(), keep_r[X > 0])
    assert torch.equal(keep_r[b["rows"], b["items"]], keep.float())
    assert torch.equal(eps, ref.gaussian(seed, len(uids), 20, CPU))
    assert 0.3 < float(keep.float().mean()) < 0.7
    assert abs(float(eps.mean())) < 0.2 and 0.8 < float(eps.std()) < 1.2
    for epoch in (0, 1, 5):
        assert np.array_equal(mv.permutation(SEED, epoch, U),
                              ref.permutation(SEED, epoch, U))
    assert not np.array_equal(mv.permutation(SEED, 0, U),
                              mv.permutation(SEED, 1, U))


def test_multinomial_gradient_is_the_nll_gradient():
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(5, 40, generator=g, requires_grad=True)
    X = (torch.rand(5, 40, generator=g) < 0.2).float()
    X[0] = 0.0  # a row without ratings
    rows, cols = torch.nonzero(X, as_tuple=True)
    items = torch.full((5, 40), 40)
    mask = torch.zeros(5, 40, dtype=torch.bool)
    for r, c in zip(rows.tolist(), cols.tolist()):
        n = int(mask[r].sum())
        items[r, n], mask[r, n] = c, True
    nll = multinomial_nll(logits, items, mask)
    want = -(torch.log_softmax(logits, 1) * X).sum(1)
    assert torch.allclose(nll, want, rtol=1e-6, atol=1e-6)
    (grad,) = torch.autograd.grad(0.25 * want.sum(), [logits])
    got = multinomial_gradient(logits.detach(), X.sum(1), rows * 40 + cols,
                               torch.ones(len(rows)), 0.25)
    assert torch.allclose(got, grad, rtol=1e-6, atol=1e-7)


def test_adam_matches_the_references_form():
    g = torch.Generator().manual_seed(4)
    shapes = [(7, 3), (5,)]
    P = [torch.randn(s, generator=g) for s in shapes]
    Pr = {str(i): p.clone() for i, p in enumerate(P)}
    M = [torch.zeros(s) for s in shapes]
    V = [torch.zeros(s) for s in shapes]
    Mr = {k: torch.zeros_like(v) for k, v in Pr.items()}
    Vr = {k: torch.zeros_like(v) for k, v in Pr.items()}
    cfg = dict(learn_rate=1e-3, beta1=0.9, beta2=0.999, eps=1e-8)
    counts = torch.arange(1, 4, dtype=torch.float32)
    for t in range(3):
        G = [torch.randn(s, generator=g) * 10.0 ** -t for s in shapes]
        dense_adam_steps(list(zip(P, G, M, V)), counts[t], lr=1e-3,
                         beta1=0.9, beta2=0.999, eps=1e-8)
        ref.adam(Pr, {str(i): x for i, x in enumerate(G)}, Mr, Vr, t + 1,
                 cfg)
    assert torch.equal(counts, torch.arange(1, 4, dtype=torch.float32))
    for i in range(len(shapes)):
        assert torch.allclose(P[i], Pr[str(i)], rtol=0, atol=1e-7)
        assert torch.allclose(V[i], Vr[str(i)], rtol=1e-6, atol=0)


def _epochs(n, **cfg):
    """The port and the reference after ``n`` epochs from the same
    tables: (port params, reference tables, reference v)."""
    model, state = _model(**cfg)
    P = {k: state.params[k].clone() for k in mv.LEAVES}
    M = {k: torch.zeros_like(v) for k, v in P.items()}
    V = {k: torch.zeros_like(v) for k, v in P.items()}
    rows, rc = _rows(), _ref_cfg(model)
    steps = model.steps_per_epoch(state)
    for epoch in range(n):
        model.train_one_iteration(state, SEED)
        perm = ref.permutation(SEED, epoch, U)
        for j, a in enumerate(range(0, U, rc["batch_size"])):
            ref.train_step(P, M, V, rc, rows, perm[a:a + rc["batch_size"]],
                           ref.step_seed(SEED, epoch, j, 0),
                           epoch * steps + j)
    assert state.step == n
    return model, state, P, M, V


@pytest.mark.parametrize("anneal", [200_000, 8])
def test_epochs_match_the_reference(anneal):
    """One epoch with the paper's anneal; two with a short one, whose KL
    weight goes 0, 0.125, 0.2 (capped) in the first epoch's three steps
    and stays at the cap in the second: the update count runs on across
    epochs."""
    n = 1 if anneal > 8 else 2
    model, state, P, M, V = _epochs(n, total_anneal_steps=anneal)
    if anneal == 8:
        assert [mv.kl_weight(model.cfg, t) for t in range(4)] == [
            0.0, 0.125, 0.2, 0.2]
    start = _model()[1]
    for k in mv.LEAVES:
        assert _rel(state.params[k], P[k]) < 1e-6, k
        assert _rel(state.params[k + "_m"], M[k]) < TOL, k
        assert _rel(state.params[k + "_v"], V[k]) < TOL, k
        assert not torch.equal(state.params[k], start.params[k]), k


@pytest.mark.parametrize("steps", [1, 2])
def test_an_epochs_prefix_is_its_first_updates(steps):
    """``steps`` stops the epoch after its first updates and leaves the
    epoch count; the reference's ``train_epoch`` stops at the same
    place."""
    model, state = _model()
    P = {k: state.params[k].clone() for k in mv.LEAVES}
    model.train_one_iteration(state, SEED, steps=steps)
    assert state.step == 0
    V = ref.train_epoch(P, _ref_cfg(model), _rows(), SEED, steps=steps)
    for k in mv.LEAVES:
        assert _rel(state.params[k], P[k]) < 1e-6, k
        assert _rel(state.params[k + "_v"], V[k]) < TOL, k
    whole = _model()
    whole[0].train_one_iteration(whole[1], SEED)
    assert not torch.equal(whole[1].params["W_p2"], state.params["W_p2"])


def test_a_missing_kl_term_is_caught():
    """The check the benchmark makes (norms of v and of the change by
    leaf) reads a fault of the KL term far above the sound order of sums:
    the port trained with the KL weight 0 against the reference's
    annealed weight."""
    model, state, P, M, V = _epochs(2, total_anneal_steps=8)
    start = _model()[1]
    got = (compare.leaf_norms({k: state.params[k + "_v"]
                               for k in mv.LEAVES}),
           compare.leaf_norms({k: state.params[k] - start.params[k]
                               for k in mv.LEAVES}))
    want = (compare.leaf_norms(V),
            compare.leaf_norms({k: P[k] - start.params[k]
                                for k in mv.LEAVES}))
    sound = compare.training_gaps(got, want)
    assert max(sound.values()) < 1e-6
    bad = _model(total_anneal_steps=8, anneal_cap=0.0)[0]
    _, bad_state = bad, bad.reset(DATA, seed=5)
    for _ in range(2):
        bad.train_one_iteration(bad_state, SEED)
    faulty = (compare.leaf_norms({k: bad_state.params[k + "_v"]
                                  for k in mv.LEAVES}),
              compare.leaf_norms({k: bad_state.params[k] - start.params[k]
                                  for k in mv.LEAVES}))
    assert max(compare.training_gaps(faulty, want).values()) > 1e-3


def test_recommend_matches_the_references_top_k():
    model, state = _model()
    model.train_one_iteration(state, SEED)
    uids = np.array([0, 1, 5, 17, 40, 62, 63])
    ids = model.recommend(state, uids, DATA, k=10).numpy()
    P = {k: state.params[k] for k in mv.LEAVES}
    s = ref.scores(P, _ref_cfg(model), _rows(), uids)
    assert float(compare.topk_gaps(s[1:], ids[1:]).max()) < 1e-5
    want = torch.topk(s, 10, dim=1).indices.numpy()
    assert (ids[1:] == want[1:]).mean() > 0.95
    # user 0 rated all but one item: that one, then the past-the-end id
    assert ids[0, 0] == np.setdiff1d(np.arange(I), DATA.items[
        DATA.users == 0])[0] and np.all(ids[0, 1:] == I)
    # batch_scores, predict and topk_ids agree
    items, mask = _rated(model, uids)
    scores = model.batch_scores(state, uids, items, mask)
    fin = torch.isfinite(s)
    assert torch.allclose(scores[fin], s[fin], rtol=1e-5, atol=1e-6)
    pred = model.predict(state, [1, 5], [3, 4])
    assert torch.allclose(pred, scores[[1, 2], [3, 4]])


def test_data_loss_is_the_summed_negative_elbo():
    model, state = _model()
    model.train_one_iteration(state, SEED)
    beta = mv.kl_weight(model.cfg, model.steps_per_epoch(state))
    P = {k: state.params[k] for k in mv.LEAVES}
    X = _rows().dense(np.arange(U), CPU)
    logits, mu, logvar = ref.forward(P, X, None, None, _ref_cfg(model))
    want = (-(torch.log_softmax(logits, 1) * X).sum()
            + beta * (0.5 * (-logvar + torch.exp(logvar) + mu * mu - 1.0))
            .sum())
    assert model.data_loss(state) == pytest.approx(float(want), rel=1e-5)
    assert model.current_loss(state) == model.data_loss(state)


def test_spans_and_decode_cells_tally_once_a_step():
    model, state = _model()
    profiling.reset_tallies()
    model.reset(DATA, seed=5)
    assert profiling.tallies().spans["multvae.reset"][0] == 1
    with torch.profiler.profile():
        model.train_one_iteration(state, SEED)
    t = profiling.tallies()
    steps = model.steps_per_epoch(state)
    assert steps == 3
    for name in ("multvae.step", "multvae.step.encode", "multvae.step.decode",
                 "multvae.step.loss", "multvae.step.update"):
        assert t.spans[name][0] == steps, name
    assert t.spans["multvae.epoch"][0] == 1
    assert t.counters["decode_cells"] == U * I
    # Adam's sweep: 28 bytes an element of the 8 tables, once a step
    assert t.counters["table_bytes"] == steps * 28 * sum(
        state.params[k].numel() for k in mv.LEAVES)
    assert t.spans["multvae.pairs"][0] == 1
    # without a profiler only the phases tally: the epoch's pairs again
    model.train_one_iteration(state, SEED)
    after = profiling.tallies()
    assert after.counters == t.counters
    assert after.spans.pop("multvae.pairs")[0] == 2
    assert after.spans == {k: v for k, v in t.spans.items()
                           if k != "multvae.pairs"}


def test_the_normal_path_trains_and_serves():
    """create_model, the Solver's entry points and the evaluator's top-k:
    training lowers the loss, and the served ids are unrated."""
    from cdae_tpu_torch.evaluation import Evaluation

    model, state = _model(learn_rate=1e-2)
    before = model.current_loss(state)
    for _ in range(3):
        model.train_one_iteration(state, SEED)
    assert model.current_loss(state) < before
    ev = Evaluation.create("TOPN")
    result = ev.evaluate(model, state, DATA, DATA)
    assert result
    items, mask = _rated(model, np.arange(U))
    ids = model.topk_ids(state, torch.arange(U), items, mask, k=5)
    rated = items.masked_fill(~mask, -1)
    # (user 0 has one unrated item: slots past it are recommend's to fill)
    assert not (ids[1:, :, None] == rated[1:, None, :]).any()


def test_the_cli_builds_it_at_the_papers_settings():
    from cdae_tpu_torch import cli

    for method in ("MULTVAE", "multvae"):
        model = cli.build_model(cli.build_arg_parser().parse_args(
            ["--method", method, "--device", "cpu", "--num_dim", "50"]))
        assert type(model) is mv.MultVAE
        assert model.cfg == mv.MultVAEConfig()

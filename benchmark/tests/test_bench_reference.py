"""The plain reference against the port on the CPU at a small size: a
whole first epoch of each step (sparse and dense) from the same weights
and seed, and ``recommend``'s lists."""

import numpy as np
import pytest
import torch

from benchmark.harness import compare, runner
from benchmark.harness.spec import load_cell
from benchmark.reference import cdae as ref
from benchmark.tests.conftest import SMALL

CPU = torch.device("cpu")


def _port(cell_name, seed, **cdae):
    cell = load_cell(cell_name, overrides={**SMALL,
                                           "cdae": {**SMALL["cdae"], **cdae}})
    ctx, driver = runner.prepare(cell, seed, CPU, lambda msg: None)
    return cell, ctx


@pytest.mark.parametrize("cell_name,dense", [("cdae_ml20m.train", False),
                                             ("cdae_ml10m.train", True)])
def test_first_epoch_matches_the_port(cell_name, dense):
    seed = 2**31 + 99
    cell, ctx = _port(cell_name, seed)
    prog = ctx.program
    assert ("dense_R" in prog.state.aux) == dense
    prog.model.train_one_iteration(prog.state, seed)
    cfg = cell.config["cdae"]
    P = ctx.adapter.weights(ctx)
    rows = ref.Rows(ctx.users, ctx.items, ctx.num_users, ctx.num_items)
    A = ref.train_epoch(P, cfg, rows, dense, seed)
    for k in ("W", "b", "b_prime", "Wu"):
        got = prog.state.params[k]
        assert torch.allclose(got, P[k], rtol=1e-4, atol=1e-6), k
        assert torch.allclose(prog.state.params[k + "_ag"], A[k],
                              rtol=1e-4, atol=1e-9), k
        assert not torch.equal(P[k], ctx.adapter.weights(ctx)[k])


def test_recommend_matches_the_reference():
    seed = 12345
    cell, ctx = _port("cdae_ml20m.serve_batch", seed)
    uids = np.random.default_rng(0).permutation(ctx.num_users)[:64]
    prog = ctx.program
    ids = prog.model.recommend(prog.state, uids, prog.train, k=10).numpy()
    P = ctx.adapter.weights(ctx)
    rows = ref.Rows(ctx.users, ctx.items, ctx.num_users, ctx.num_items)
    s = ref.scores(P, rows, uids.astype(np.int64))
    want = torch.topk(s, 10, dim=1).indices.numpy()
    assert (ids == want).mean() > 0.99
    assert float(compare.topk_gaps(s, ids).max()) < 1e-6
    # a rated item served reads inf, a repeated one too
    bad = ids.copy()
    bad[0, 0] = rows.items[rows.indptr[uids[0]]]
    bad[1, 1] = bad[1, 0]
    gaps = compare.topk_gaps(s, bad)
    assert torch.isinf(gaps[0]) and torch.isinf(gaps[1])


def test_hash_stream_matches_the_ports_draws():
    from cdae_tpu_torch.ops.pallas_kernels import hw_uniform_plain
    from cdae_tpu_torch.ops.sampling import hw_randint
    from cdae_tpu_torch.utils.random import step_seed

    for args in ((0, 0, 0, 0), (2**31 + 7, 3, 17, 0), (-5, 1, 2, 0)):
        assert ref.step_seed(*args) == step_seed(*args)
    s = ref.step_seed(99, 0, 3, 0)
    for draw in (0, 1):
        assert torch.equal(ref.hash_uniform(s, 7, 300, draw, CPU),
                           hw_uniform_plain(s, (7, 300), draw, device=CPU))
    free = torch.tensor([300, 17, 1, 29999])
    got = ref.hash_randint(s, ref.NEG_SALT, 4, 50, free)
    want = hw_randint(s, (4, 50), free[:, None], salt=ref.NEG_SALT,
                      device=CPU, use_kernel=False)
    assert torch.equal(got, want.to(torch.int64))


def test_tf32_round_keeps_ten_mantissa_bits_to_nearest_even():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's spacing at 1
    x = torch.tensor([one, one + ulp / 2, one + 1.5 * ulp, one + 0.49 * ulp,
                      -(one + 0.51 * ulp), 3.0e-5, 0.0])
    r = ref.tf32_round(x)
    want = [one, one, one + 2 * ulp, one, -(one + ulp)]
    assert r[:5].tolist() == pytest.approx(want, rel=0, abs=0)
    bits = r.view(torch.int32)
    assert torch.all((bits & 0x1FFF) == 0)
    assert float((r[5] - x[5]).abs()) <= 3.0e-5 * 2.0 ** -11
    assert r[6] == 0.0
    # every product's operands in the control are so rounded
    g = torch.Generator().manual_seed(1)
    a = torch.rand(64, 64, generator=g)
    assert torch.equal(ref.tf32_round(ref.tf32_round(a)), ref.tf32_round(a))
    assert not torch.equal(ref.tf32_round(a), a)


@pytest.mark.parametrize("cell_name", ["cdae_ml20m.train",
                                       "cdae_ml10m.train"])
def test_the_control_departs_from_the_reference(cell_name):
    seed = 2**31 + 17
    cell, ctx = _port(cell_name, seed)
    want = ctx.adapter.reference_readings(ctx, CPU)
    again = ctx.adapter.reference_readings(ctx, CPU)
    low = ctx.adapter.reference_readings(ctx, CPU, tf32=True)
    assert compare.training_gaps(again, want) == {"grad_gap": 0.0,
                                                   "change_gap": 0.0}
    gaps = compare.training_gaps(low, want)
    assert gaps["grad_gap"] > 1e-6 and gaps["change_gap"] > 1e-6

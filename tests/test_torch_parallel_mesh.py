"""The sharded trainers of cdae_tpu_torch.parallel in real multi-process
worlds on the CPU (gloo): a 2 x 1 mesh (the batch split over 'data') and
a 2 x 2 mesh (both axes). Each world is spawned once for the module
(tests/test_torch_parallel_worker.py) and runs every case; the tests read
its results.

- every trainer after two epochs against the port's single-device model
  with the same seeds: within rtol 1e-4 / atol 1e-5 per table and 0.005
  of R@10 (RMSE for PMF) (cdae_tpu's
  own limit is 5e-4; the single-device model is held against cdae_tpu by
  the other test files);
- the deterministic pieces against cdae_tpu's sharded functions on the
  fake 8-device mesh: the distributed top-k (ids equal where the score
  gap exceeds 1e-5, values rtol 1e-5), CDAE's sharded scores (rtol 1e-5,
  atol 1e-6), two ALS / WRMF iterations, each from cdae_tpu's tables
  before it (the port's one-iteration ALS tolerance 1e-5, on data whose
  Grams have full rank; WRMF 1e-4, see ``check_pieces``), the neighbour
  build (ids equal, sims rtol 1e-6);
- a rank holds its block of dense_R alone, and the sharded dense CDAE's
  data_loss is the single device's (bit for bit at world 1, rtol 1e-4);
- a sharded checkpoint saved mid-run resumes bit for bit, refuses another
  fingerprint and other dims, and its manifest has cdae_tpu's keys.
"""

import pytest

import test_torch_parallel_worker as W

WORLDS = {"2x1": (2, 1), "2x2": (4, 2)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return W.run_worlds(tmp_path_factory.mktemp("parallel_mesh"), WORLDS)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", W.CASES)
def test_trainer_matches_single_device(runs, world, case):
    outs, refs, _ = runs
    W.check_trainer(outs[world], case, refs[case], exact=False)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", W.DENSE_CASES)
def test_dense_R_is_the_ranks_block(runs, world, case):
    outs, refs, _ = runs
    n, nm = WORLDS[world]
    W.check_dense_blocks(outs[world], case, n // nm, nm, refs["_loss"],
                         exact=n == 1)


@pytest.mark.parametrize("world", WORLDS)
def test_deterministic_pieces_match_cdae_tpu(runs, world):
    outs, _, want = runs
    W.check_pieces(outs[world], want)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_checkpoint_resumes_and_refuses(runs, world):
    W.check_checkpoint(runs[0][world], runs[2])


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_shapes(runs, world):
    n, nm = WORLDS[world]
    assert list(runs[0][world]["mesh_shape"]) == [n // nm, nm]

"""cdae_tpu_torch -- the PyTorch/CUDA port of cdae_tpu.

A second package beside the JAX one (which stays the reference), with the
same top-level API (``__all__``). On one GPU it trains, evaluates and
serves everything cdae_tpu does there:

  - every model of the registry: CDAE (dense step, fused step and the
    sparse step past the dense-mode rule), PMF, IMF, BPR, WARP (every
    route), FISM, FISMPair, ALS, WRMF, ItemCF, UserCF, LinearModel,
    FactorModel, NegMF and Popularity;
  - the Solver and SGDSolver, the TOPN/RANKING/RMSE/MAE evaluators,
    ``RecsysModel.recommend`` (top-k unrated ids), npz checkpoints in
    cdae_tpu's format, the paper's hyperparameter sweep (sweep.py);
  - data: text loading (multithreaded C++ host runtime, _native/), caches,
    splits, LIBSVM feature groups, synthetic generators;
  - the CLI tasks prepare, split, train, test and sweep.

Hand-written CUDA kernels for Hopper (csrc/*.cu) replace each of
cdae_tpu's nine Pallas kernels: full-catalog decode, fused decode + top-k
(dense mask and CSR), the mask uniforms, AdaGrad over a step's tables,
the fused CDAE step, WARP's violator count + select, the row aggregation
and the row gather. The sharded trainers come with a later slice.

Layout mirrors cdae_tpu's module names:
  data/     -- datasets, vocabularies, splits, caches, feature groups,
               synthetic data
  ops/      -- losses, penalties, corruption, sampling, top-k, metrics,
               the kernels' wrappers (pallas_kernels.py, cdae_fused.py)
               and their build (cuda_lib.py)
  csrc/     -- the CUDA sources and the host runtime's C++ source
  models/   -- the model zoo and the registry
  solver/   -- Solver, SGDSolver, AdaGrad, line search
  utils/    -- logging, timers, profiling, checkpoints, host randomness,
               host parallel helpers
  _native/  -- ctypes bindings of the host runtime (text loader, CSR build)

Imports torch and numpy only: never jax, never cdae_tpu.
"""

__version__ = "0.1.0"

from cdae_tpu_torch.data.dataset import Interactions
from cdae_tpu_torch.ops.losses import Loss, LossType
from cdae_tpu_torch.ops.penalties import Penalty, PenaltyType


def __getattr__(name):
    # the model, solver and evaluator names import on first use
    if name in ("CDAE", "CDAEConfig", "create_model", "MODEL_REGISTRY"):
        import cdae_tpu_torch.models as _m

        return getattr(_m, name)
    if name in ("Solver", "SGDSolver"):
        import cdae_tpu_torch.solver.solver as _s

        return getattr(_s, name)
    if name in ("Evaluation", "EvalType"):
        import cdae_tpu_torch.evaluation as _e

        return getattr(_e, name)
    raise AttributeError(f"module 'cdae_tpu_torch' has no attribute {name!r}")


__all__ = [
    "Interactions",
    "Loss",
    "LossType",
    "Penalty",
    "PenaltyType",
    "CDAE",
    "CDAEConfig",
    "create_model",
    "MODEL_REGISTRY",
    "Solver",
    "SGDSolver",
    "Evaluation",
    "EvalType",
    "__version__",
]

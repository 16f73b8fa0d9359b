"""cdae_tpu_torch -- the PyTorch/CUDA port of cdae_tpu.

A second package beside the JAX one (which stays the reference). It
trains and serves CDAE (dense mode) and WARP (its dense path): data caches
and splits, parameter reset, training through the Solver, checkpoints
(cdae_tpu's format), the TOPN/RANKING evaluators and the CLI tasks, with
hand-written CUDA kernels for Hopper on those paths: full-catalog decode,
fused decode + top-k, the mask uniforms, AdaGrad, the fused CDAE step and
WARP's violator count + select.

Layout mirrors cdae_tpu's module names:
  data/     -- datasets, vocabularies, splits, caches, synthetic data
  ops/      -- top-k, metrics, the kernels' wrappers (pallas_kernels.py)
               and their build (cuda_lib.py)
  csrc/     -- the CUDA sources
  models/   -- CDAE, WARP (mf.py) and the registry
  solver/   -- Solver, SGDSolver, AdaGrad
  utils/    -- logging, timers, checkpoints

Imports torch and numpy only: never jax, never cdae_tpu.
"""

__version__ = "0.1.0"

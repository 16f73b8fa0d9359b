"""cdae_tpu_torch -- the PyTorch/CUDA port of cdae_tpu.

A second package beside the JAX one (which stays the reference). This
slice serves CDAE top-N recommendations: data caches and splits, parameter
reset, checkpoints (cdae_tpu's format), the hidden encode and three
hand-written CUDA kernels for Hopper -- full-catalog decode, and fused
decode + top-k with dense or CSR rated exclusion -- under the TOPN/RANKING
evaluators, the Solver's test pass and the CLI ``--task test``.

Layout mirrors cdae_tpu's module names:
  data/     -- datasets, vocabularies, splits, caches, synthetic data
  ops/      -- top-k, metrics, the kernels' wrappers (pallas_kernels.py)
               and their build (cuda_lib.py)
  csrc/     -- the CUDA sources
  models/   -- CDAE
  solver/   -- Solver (test)
  utils/    -- logging, timers, checkpoints

Imports torch and numpy only: never jax, never cdae_tpu.
"""

__version__ = "0.1.0"

"""The sharded trainers on torch.distributed (port of cdae_tpu/parallel):
process meshes and layouts (mesh.py), the process group (distributed.py),
the distributed top-k (topk.py), the sharded steps (sharded.py), the
trainers (trainer.py, tp_pairwise.py)."""

from cdae_tpu_torch.parallel.mesh import (batch_specs, cdae_param_specs,
                                          make_mesh)
from cdae_tpu_torch.parallel.topk import distributed_topk_unrated

__all__ = [
    "make_mesh",
    "cdae_param_specs",
    "batch_specs",
    "distributed_topk_unrated",
    "ShardedCDAE",
    "ShardedIMF",
    "ShardedPairwise",
    "ShardedNegMF",
    "ShardedFISM",
    "ShardedALS",
    "ShardedWRMF",
    "ShardedMFTP",
    "ShardedPairwiseTP",
]


def __getattr__(name):  # lazy: trainer pulls in the model zoo
    if name in ("ShardedCDAE", "ShardedIMF", "ShardedPairwise",
                "ShardedNegMF", "ShardedFISM", "ShardedALS", "ShardedWRMF"):
        from cdae_tpu_torch.parallel import trainer

        return getattr(trainer, name)
    if name in ("ShardedMFTP", "ShardedPairwiseTP"):
        from cdae_tpu_torch.parallel import tp_pairwise

        return getattr(tp_pairwise, name)
    raise AttributeError(name)

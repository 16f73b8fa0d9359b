from cdae_tpu_torch.data.vocab import Vocab
from cdae_tpu_torch.data.dataset import Interactions, PaddedUserBatch
from cdae_tpu_torch.data.instances import GroupedInstances
from cdae_tpu_torch.data import io

__all__ = ["Vocab", "Interactions", "PaddedUserBatch", "GroupedInstances",
           "io"]

"""Models of the port: CDAE (serving)."""

from cdae_tpu_torch.models.cdae import CDAE, CDAEConfig

__all__ = ["CDAE", "CDAEConfig"]

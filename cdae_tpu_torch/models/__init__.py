"""Models of the port: CDAE (dense and sparse training, serving), the
matrix-factorization family (PMF, IMF, BPR, WARP: every route), FISM /
FISMPair (training and serving), ALS / WRMF, the neighbourhood models
ItemCF / UserCF, the feature-group models (LinearModel, FactorModel, NegMF)
and the Popularity baseline, with cdae_tpu's registry: the same 15 names,
and the port's own MULTVAE (Mult-VAE, models/multvae.py).

``create_model(name, **cfg)`` mirrors cdae_tpu's (the reference app's
``--method`` dispatch).
"""

from cdae_tpu_torch.models.als import ALS, WRMF, ALSConfig
from cdae_tpu_torch.models.base import ModelState, RecsysModel
from cdae_tpu_torch.models.cdae import CDAE, CDAEConfig
from cdae_tpu_torch.models.fism import FISM, FISMConfig, FISMPair
from cdae_tpu_torch.models.linear import (FactorModel, FactorModelConfig,
                                          LinearModel, LinearModelConfig,
                                          NegMF)
from cdae_tpu_torch.models.mf import BPR, IMF, PMF, WARP, MFConfig
from cdae_tpu_torch.models.multvae import MultVAE, MultVAEConfig
from cdae_tpu_torch.models.popularity import Popularity
from cdae_tpu_torch.models.similarity import (ItemCF, SimilarityConfig,
                                              UserCF)

MODEL_REGISTRY = {
    "CDAE": (CDAE, CDAEConfig),
    "PMF": (PMF, MFConfig),
    "IMF": (IMF, MFConfig),
    "BPR": (BPR, MFConfig),
    "WARP": (WARP, MFConfig),
    "FISM": (FISM, FISMConfig),
    "FISMPAIR": (FISMPair, FISMConfig),
    "NEGMF": (NegMF, FactorModelConfig),
    "LINEAR": (LinearModel, LinearModelConfig),
    "FM": (FactorModel, FactorModelConfig),
    "ALS": (ALS, ALSConfig),
    "WRMF": (WRMF, ALSConfig),
    "ITEMCF": (ItemCF, SimilarityConfig),
    "USERCF": (UserCF, SimilarityConfig),
    "POP": (Popularity, None),
    "MULTVAE": (MultVAE, MultVAEConfig),
}


def create_model(name: str, device="cuda", **cfg):
    """Instantiate a model by registry name with config kwargs, on
    ``device`` (default cuda)."""
    key = name.upper()
    if key not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    cls, cfg_cls = MODEL_REGISTRY[key]
    if cfg_cls is None:  # no knobs (Popularity)
        return cls(device=device)
    return cls(device=device, **cfg)


__all__ = ["RecsysModel", "ModelState", "MODEL_REGISTRY", "create_model",
           "CDAE", "CDAEConfig", "PMF", "IMF", "BPR", "WARP", "MFConfig",
           "FISM", "FISMPair", "FISMConfig", "ALS", "WRMF", "ALSConfig",
           "ItemCF", "UserCF", "SimilarityConfig", "LinearModel",
           "LinearModelConfig", "FactorModel", "FactorModelConfig", "NegMF",
           "Popularity", "MultVAE", "MultVAEConfig"]

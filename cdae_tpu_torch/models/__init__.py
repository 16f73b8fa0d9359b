"""Models of the port: CDAE (dense and sparse training, serving), the
matrix-factorization family (PMF, IMF, BPR, WARP: every route), FISM /
FISMPair (training and serving), ALS / WRMF, the neighbourhood models
ItemCF / UserCF and the Popularity baseline, with cdae_tpu's registry.

``create_model(name, **cfg)`` mirrors cdae_tpu's (the reference app's
``--method`` dispatch). Every other model of cdae_tpu's zoo raises
NotImplementedError naming the ROADMAP entry of the slice it comes with.
"""

from cdae_tpu_torch.models.als import ALS, WRMF, ALSConfig
from cdae_tpu_torch.models.base import ModelState, RecsysModel
from cdae_tpu_torch.models.cdae import CDAE, CDAEConfig
from cdae_tpu_torch.models.fism import FISM, FISMConfig, FISMPair
from cdae_tpu_torch.models.mf import BPR, IMF, PMF, WARP, MFConfig
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
    "ALS": (ALS, ALSConfig),
    "WRMF": (WRMF, ALSConfig),
    "ITEMCF": (ItemCF, SimilarityConfig),
    "USERCF": (UserCF, SimilarityConfig),
    "POP": (Popularity, None),
}

# cdae_tpu's other registry names -> the ROADMAP entry that ports them
LATER_MODELS = {"NEGMF": "A9", "LINEAR": "A9", "FM": "A9"}


def create_model(name: str, device="cuda", **cfg):
    """Instantiate a model by registry name with config kwargs, on
    ``device`` (default cuda)."""
    key = name.upper()
    if key in LATER_MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported to cdae_tpu_torch yet: it comes "
            f"with a later slice (ROADMAP {LATER_MODELS[key]})")
    if key not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    cls, cfg_cls = MODEL_REGISTRY[key]
    if cfg_cls is None:  # no knobs (Popularity)
        return cls(device=device)
    return cls(device=device, **cfg)


__all__ = ["RecsysModel", "ModelState", "MODEL_REGISTRY", "LATER_MODELS",
           "create_model", "CDAE", "CDAEConfig", "PMF", "IMF", "BPR", "WARP",
           "MFConfig", "FISM", "FISMPair", "FISMConfig", "ALS", "WRMF",
           "ALSConfig", "ItemCF", "UserCF", "SimilarityConfig", "Popularity"]

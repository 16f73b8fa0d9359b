"""On-device integer draws (port of cdae_tpu/ops/sampling.py, the part the
WARP dense path uses).

``hw_randint`` is cdae_tpu's uniform int in [0, maxval) built on the
uniform stream of ``hw_uniform`` (kernel B1) with a salt XORed into the
seed. cdae_tpu derives that seed from a PRNG key (``key_seed``); the port
passes its host step seeds (utils/random.py ``step_seed``) instead.

``sample_unrated`` and ``is_rated`` (the exact complement sampler and the
CSR membership test) serve WARP's scan and pool paths and the sparse CDAE
step; they come with those slices (ROADMAP A7, A8).
"""

from __future__ import annotations

import torch

from cdae_tpu_torch.ops.pallas_kernels import hw_uniform, hw_uniform_plain

_MASK32 = 0xFFFFFFFF


def hw_randint(seed: int, shape, maxval, salt: int = 0, *, device,
               use_kernel: bool = True) -> torch.Tensor:
    """int32 uniform in [0, maxval) of ``shape``: ``floor(u * maxval)``
    capped at maxval - 1, with ``u = hw_uniform(seed ^ salt, shape)`` (its
    kernel for a CUDA device when ``use_kernel``, else its plain version).
    ``maxval`` is a number or a tensor broadcastable to ``shape``, >= 1.
    The float scaling biases a draw by less than maxval * 2**-24."""
    s = (int(seed) ^ int(salt)) & _MASK32
    s = s - (1 << 32) if s >= (1 << 31) else s
    draw = hw_uniform if use_kernel else hw_uniform_plain
    u01 = draw(s, tuple(shape), device=device)
    mx = torch.as_tensor(maxval, device=u01.device)
    scaled = (u01 * mx.to(torch.float32)).to(torch.int32)
    return torch.minimum(scaled, mx.to(torch.int32) - 1)

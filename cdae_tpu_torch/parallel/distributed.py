"""Process-group initialisation (port of cdae_tpu/parallel/distributed.py).

cdae_tpu initialises ``jax.distributed`` so that ``jax.devices()`` spans
every host. Here one process drives one device, and the processes form a
``torch.distributed`` process group: NCCL for CUDA devices, gloo for the
CPU. The same environment variables configure it:

  CDAE_COORDINATOR   host:port of process 0, or a ``file://`` / ``tcp://``
                     init URL (default: none = a single process)
  CDAE_NUM_PROCESSES total process count
  CDAE_PROCESS_ID    this process's rank

A mesh (parallel/mesh.py) then spans the processes, as cdae_tpu's spans
``jax.devices()``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def _init_method(address: str) -> str:
    if "://" in address:
        return address
    return f"tcp://{address}"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    backend: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Join the process group; returns True when this is a multi-process
    run (the group is then initialised), False with no coordinator set
    (a single process: nothing is set up and the world is 1).

    ``backend`` defaults to NCCL when ``device`` is a CUDA device (default:
    CUDA when a GPU is present) and gloo for the CPU; the CUDA device of a
    process is ``cuda:<rank % device_count>``. An explicit ``backend="gloo"``
    runs gloo on CUDA tensors (several ranks on one card, which NCCL
    refuses). A rank that does not arrive within ``timeout`` fails the
    initialisation instead of hanging it."""
    coordinator_address = coordinator_address or os.environ.get(
        "CDAE_COORDINATOR")
    if not coordinator_address:
        return False
    if num_processes is None:
        num_processes = int(os.environ["CDAE_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["CDAE_PROCESS_ID"])
    if dist.is_initialized():
        if (dist.get_world_size() != num_processes
                or dist.get_rank() != process_id):
            raise RuntimeError(
                f"a process group of world {dist.get_world_size()} rank "
                f"{dist.get_rank()} exists; asked for world "
                f"{num_processes} rank {process_id}")
        return True
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    kw = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index if dev.index is not None
                           else process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        kw["device_id"] = dev  # binds the group (and its barrier) to it
    dist.init_process_group(
        backend=backend, init_method=_init_method(coordinator_address),
        world_size=num_processes, rank=process_id, timeout=timeout, **kw)
    return True


def world_size() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that should write checkpoints / logs."""
    return process_index() == 0


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()

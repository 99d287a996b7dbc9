"""Multi-process training: joining the process group.

Port of ``marius_tpu/parallel/multihost.py``. The JAX package joins the
``jax.distributed`` coordination service and then sees every process's
devices; here every process is one rank of a ``torch.distributed`` process
group and drives one device. Usage (the same script in every process):

    from marius_tpu_torch.parallel import mesh, multihost
    dev = multihost.initialize("host0:1234", num_processes=4, process_id=i)
    m = mesh.make_mesh(num_data=2, num_node=2, device=dev)
    trainer = LinkPredictionTrainer(..., mesh=m)      # identical arguments
    trainer.train(epochs)                              # collective epochs

The backend is a rule, not a fallback:

- NCCL when every rank on the host has a card of its own
  (the host's ranks <= ``torch.cuda.device_count()``);
- gloo on the CPU (``device="cpu"``), and when ranks share a card (more
  ranks on the host than cards): NCCL refuses two ranks on one device.

Rank i drives ``cuda:{local rank % device_count}`` unless the caller asks
for the CPU; a rank that finds no card raises. The manager logs the choice
with the mesh (``manager._init_lp``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from marius_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT


def rank_device(local_rank: int, device=None) -> torch.device:
    """The device this rank drives: ``device`` when given, else its card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for this rank; pass device='cpu' "
                           "to train on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """NCCL when each of the host's ranks has a card of its own, else gloo."""
    if device.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _init_method(address: str) -> str:
    """``host:port`` as a TCP rendezvous; a ``tcp://`` or ``file://`` URL as given."""
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               device=None, local_rank: Optional[int] = None,
               local_world_size: Optional[int] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join the process group as rank ``process_id`` of ``num_processes``;
    returns this rank's device (made the current card). ``local_rank`` and
    ``local_world_size`` default to ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``
    from the environment, else to one host holding every rank."""
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    dev = rank_device(local_rank, device)
    backend = choose_backend(dev, local_world_size)
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=num_processes, rank=process_id, timeout=timeout,
                            **kwargs)
    return dev


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def shutdown() -> None:
    """Leave the process group (every rank calls it)."""
    if dist.is_initialized():
        dist.destroy_process_group()

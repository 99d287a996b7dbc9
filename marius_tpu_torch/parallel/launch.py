"""Process-group start-up from the environment, and the global mesh.

Port of ``marius_tpu/parallel/launch.py``. ``torchrun`` and most cluster
launchers set ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``; ``initialize_distributed`` reads
them where its arguments are not given. Usage in every process:

    from marius_tpu_torch.parallel.launch import initialize_distributed, global_mesh
    initialize_distributed()             # env-driven
    mesh = global_mesh(num_node=2)       # (data, node) over every rank
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

from marius_tpu_torch.parallel import multihost
from marius_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device=None):
    """Join the process group; arguments not given come from the environment.
    Returns this rank's device."""
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    return multihost.initialize(coordinator_address, num_processes, process_id, device=device)


def global_mesh(num_node: int = 1, num_data: Optional[int] = None, device=None) -> Mesh:
    """A (data, node) mesh over every rank of the job."""
    return make_mesh(num_data=num_data, num_node=num_node, device=device)


def process_shard(n: int) -> slice:
    """This rank's contiguous slice of an n-element dataset."""
    p, i = dist.get_world_size(), dist.get_rank()
    per = -(-n // p)
    return slice(i * per, min(n, (i + 1) * per))

"""Multi-process bring-up (counterpart of parallel/distributed.py).

Every process calls `initialize()`, builds its `make_env_mesh()` over its
own devices and runs the same ShardedVecEnv program on its slice of the
global env axis. Lockstep envs are independent, so the env loop has no
per-step collective; the process group carries only the reductions asked
for (ShardedVecEnv.mean_reward).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """torch.distributed.init_process_group with the JAX package's
    env-var fallbacks (COORDINATOR_ADDRESS as host:port, NUM_PROCESSES,
    PROCESS_ID) over tcp://host:port; a no-op when single-process (no
    coordinator) or when the group exists. The backend is NCCL when a
    CUDA device is present, else gloo."""
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if coordinator_address is None or dist.is_initialized():
        return
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", 1))
    process_id = process_id if process_id is not None else int(
        os.environ.get("PROCESS_ID", 0))
    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo",
        init_method="tcp://" + coordinator_address,
        world_size=num_processes, rank=process_id)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_env_count(envs_per_device: int, mesh) -> int:
    """Envs of a ShardedVecEnv over `mesh` (make_env_mesh) with
    envs_per_device on every device of every process."""
    return envs_per_device * mesh.size


def local_shard(sharded, axis: int = 0) -> np.ndarray:
    """This process's slice of a global env-axis value of ShardedVecEnv
    (a tuple of per-shard tensors, one per local device, in global env
    order) as one host numpy array, concatenated along the env axis
    (`axis`: 0 for reset and step outputs, 1 for multi_step's)."""
    return np.concatenate([t.detach().cpu().numpy() for t in sharded],
                          axis=axis)

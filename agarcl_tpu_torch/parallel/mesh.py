"""Envs sharded over devices and processes (counterpart of
parallel/mesh.py).

The global env axis of N envs is split into mesh.size equal shards,
process-major: shard g = rank * L + j holds the global envs
g * N / size ... (g + 1) * N / size - 1 and lives on device j of process
`rank` (L devices a process). Each local shard is a VecEnv of its own on
its device; lockstep envs are independent, so a step needs no
communication, and only `mean_reward` reduces over the process group.

Values that carry the env axis (states, obs, rewards, dones) are tuples
with one entry per local shard, in global env order
(distributed.local_shard concatenates them on the host). `reset` gives
each shard its slice of the global seeds (env.reset_seeds with the
shard's offset), so the envs equal a single VecEnv's of num_envs envs,
bit for bit. `step` and `multi_step` take global-shaped actions, as the
JAX class does, and hand each shard its rows; every local shard is
launched before any is waited on.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.parallel import distributed as D
from agarcl_tpu_torch.vec import VecEnv


@dataclasses.dataclass(frozen=True)
class EnvMesh:
    """This process's devices, and its place among the processes."""
    devices: tuple
    rank: int
    world: int

    @property
    def size(self) -> int:
        """Shards over all processes (every process has as many
        devices)."""
        return self.world * len(self.devices)

    def shard_index(self, j: int) -> int:
        return self.rank * len(self.devices) + j


def make_env_mesh(devices=None) -> EnvMesh:
    """A mesh over this process's devices (default: every local CUDA
    device; pass CPU devices, possibly one several times, to run shards
    on the CPU) and the process group of distributed.initialize, if
    any."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_env_mesh lays envs over CUDA devices "
                               "and none is available (pass devices=, "
                               "e.g. [torch.device('cpu')] * 2)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return EnvMesh(tuple(torch.device(d) for d in devices),
                   D.process_index(), D.process_count())


def _on(dev):
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


class ShardedVecEnv:
    """VecEnv with the env axis sharded over a mesh's devices and
    processes. num_envs must divide evenly by mesh.size. backend and
    obs_config as VecEnv's ("cuda" runs the kernels on every shard's
    card; "torch" the plain engine on any device)."""

    def __init__(self, cfg: EnvConfig, num_envs: int, mesh: EnvMesh,
                 obs_type: str = "ram", obs_config=None,
                 backend: str = "cuda"):
        if num_envs % mesh.size:
            raise ValueError(f"num_envs ({num_envs}) must divide by the "
                             f"mesh's {mesh.size} shards")
        self.cfg = cfg
        self.num_envs = num_envs
        self.mesh = mesh
        self.obs_type = obs_type
        self.envs_per_shard = num_envs // mesh.size
        self.envs = tuple(VecEnv(cfg, self.envs_per_shard, obs_type,
                                 backend=backend, device=d,
                                 obs_config=obs_config)
                          for d in mesh.devices)
        self.offsets = tuple(mesh.shard_index(j) * self.envs_per_shard
                             for j in range(len(mesh.devices)))

    def _each(self, fn, *per_shard):
        """fn(env, *args) on every local shard, each under its device,
        launched in turn without waiting; returns the results' fields
        regrouped as tuples over shards."""
        outs = []
        for j, env in enumerate(self.envs):
            with _on(env.device):
                outs.append(fn(env, *(a[j] for a in per_shard)))
        if not isinstance(outs[0], tuple):
            return tuple(outs)
        return tuple(None if o[0] is None else tuple(o)
                     for o in zip(*outs))

    def _actions(self, actions):
        a = torch.as_tensor(actions, dtype=torch.float32).reshape(
            self.num_envs, self.cfg.num_agents, 3)
        n = self.envs_per_shard
        return tuple(a[o:o + n].to(env.device)
                     for o, env in zip(self.offsets, self.envs))

    def reset(self, seed: int = 0):
        """(states, obs): each shard reset with its slice of the global
        seeds of VecEnv.reset(seed)."""
        return self._each(lambda env, off: env.reset(seed, off),
                          self.offsets)

    def step(self, states, actions):
        """One step of every shard from global-shaped (N, A, 3) actions:
        (states, obs | None, rewards, dones), each a tuple over shards."""
        return self._each(lambda env, s, a: env.step(s, a), states,
                          self._actions(actions))

    def multi_step(self, states, actions, k: int, stack_obs: bool = True):
        """k steps of every shard (VecEnv.multi_step; resident states
        stay resident)."""
        return self._each(
            lambda env, s, a: env.multi_step(s, a, k, stack_obs=stack_obs),
            states, self._actions(actions))

    def make_resident(self, states):
        return self._each(lambda env, s: env.make_resident(s), states)

    def materialize(self, states):
        return self._each(lambda env, s: env.materialize(s), states)

    def mean_reward(self, rewards) -> float:
        """Mean of the global rewards: each process sums its shards in
        float64, then one all_reduce of (sum, count) over the process
        group (on the first local device for NCCL, the CPU for gloo)."""
        dev = self.mesh.devices[0]
        if dist.is_initialized() and dist.get_backend() != "nccl":
            dev = torch.device("cpu")
        tot = torch.zeros(2, dtype=torch.float64, device=dev)
        for r in rewards:
            tot[0] += r.to(torch.float64).sum().to(dev)
            tot[1] += r.numel()
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.all_reduce(tot)
        return float(tot[0] / tot[1])

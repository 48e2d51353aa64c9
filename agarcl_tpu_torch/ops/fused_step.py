"""Resident multi-step env step (counterpart of ops/fused_step.py): the
kernel-layout state carrier and the rim that turns the per-step
(mass, alive) rows of the multi-step tick into rewards and dones
(BaseEnvironment.hpp:89-122 semantics, as fused_env_multi_step_resident).
"""

from __future__ import annotations

import dataclasses

import torch

from agarcl_tpu_torch import constants as C
from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.obs.ram import RamObsConfig
from agarcl_tpu_torch.ops import fused_tick as FT
from agarcl_tpu_torch.state import GameState, zero_state


@dataclasses.dataclass
class ResidentState:
    """Kernel-layout env state kept between multi_step calls: the
    to_kernel_arrays planes, plus the previous step's per-agent masses
    (the `before` of delta-mass rewards) and the latched dones — the only
    other fields the rim reads. On CUDA the multi-step kernel updates the
    planes in place, so a carrier passed to multi_step is consumed: keep
    the returned one."""
    raw: list
    last_mass: torch.Tensor     # (N, A) f32
    dones: torch.Tensor         # (N, A) bool


def supports_multi(cfg: EnvConfig, obs_type: str) -> bool:
    """Whether multi_step runs as multi-step-tick calls: a K1
    configuration, RAM or no observation, and no between-step respawn
    (mode 0's respawn_all needs state surgery outside the kernel)."""
    return (FT.supports(cfg) and obs_type in ("ram", "none")
            and not cfg.mode_spec.respawn_all)


def to_resident(cfg: EnvConfig, states: GameState) -> ResidentState:
    A = cfg.num_agents
    return ResidentState(
        raw=FT.to_kernel_arrays(states),
        last_mass=states.player_mass()[:, :A].to(torch.float32),
        dones=states.dones.clone())


def from_resident(cfg: EnvConfig, resident: ResidentState) -> GameState:
    """Materialize a GameState (main_respawned is always False on this
    path)."""
    N = resident.last_mass.shape[0]
    template = zero_state(cfg, N, resident.last_mass.device)
    return FT.from_kernel_arrays(template, resident.raw).replace(
        dones=resident.dones.clone())


def multi_step_resident(cfg: EnvConfig, resident: ResidentState, actions,
                        k: int, ocfg: RamObsConfig | None,
                        step=FT.multi_step_raw):
    """k env steps on resident state through `step`: the K1 wrapper
    fused_tick.multi_step_raw by default, or its plain version
    fused_tick.multi_step_raw_plain (the "torch" backend, any device).

    Returns (resident, obs (k, N, 1, A, R) | None, rewards (k, N, A) f32,
    dones (k, N, A) bool)."""
    A = cfg.num_agents
    ms = cfg.mode_spec
    raw, obs, info = step(cfg, resident.raw, actions, k, ocfg)
    mass_a = info[:, :, 0, :A]                               # (k, N, A)
    step_alive = info[:, :, 1, :] > 0.0                      # (k, N, P)
    dones = resident.dones[None].expand(k, -1, -1).clone()
    if ms.done_on_death:
        dones[:, :, 0] = (~step_alive).any(-1)
    if ms.done_on_max_mass:
        hit = (mass_a >= C.MODE3_MAX_MASS).any(-1)           # (k, N)
        dones[:, :, 0] |= torch.cumsum(hit.to(torch.int32), 0) > 0
    rewards = mass_a
    if cfg.reward_type:
        prev = torch.cat([resident.last_mass[None], mass_a[:-1]], dim=0)
        rewards = mass_a - prev
    new_res = ResidentState(raw=list(raw), last_mass=mass_a[-1].clone(),
                            dones=dones[-1].clone())
    return new_res, (obs[:, :, None] if obs is not None else None), \
        rewards, dones

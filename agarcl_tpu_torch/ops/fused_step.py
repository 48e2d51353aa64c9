"""Batched env steps on the kernels (counterpart of ops/fused_step.py).

- `multi_step_resident`: the kernel-layout state carrier and the rim that
  turns the per-step (mass, alive) rows of the multi-step tick into rewards
  and dones (BaseEnvironment.hpp:89-122 semantics, as
  fused_env_multi_step_resident), with per-step screen or grid frames for a
  ScreenObsConfig or GridObsConfig;
- `fused_env_step`: one step on a GameState (as fused_env_step): the tick
  kernel, the frame kernel (screen or grid) on the post-step planes, then
  `_finish_step` (main respawn, mode rules, rewards, auto-reset).

A step that returns F frames (num_frames) follows the JAX fused step's
chain (agarcl_tpu/ops/fused_step.py:66-80, :117-131): K1 with a tick count
(fused_tick.engine_tick_raw) with the actions and ticks_per_step - F + 1
ticks, then the frame; then F - 1 times K1 with one tick and no actions,
then the frame. (The JAX chain runs ticks_per_step - F ticks and a first
one-tick call; folding them into one launch gives the same states.) At
F = 1 this is one whole step and one frame. For
F > ticks_per_step the step returns ticks_per_step frames behind
F - ticks_per_step zero frames, the shape of the XLA env_step
(agarcl_tpu/env.py:152-157); the JAX fused step returns
min(F, ticks_per_step) frames instead (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import dataclasses

import torch

from agarcl_tpu_torch import constants as C
from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.env import finish_step, reset_done
from agarcl_tpu_torch.obs.gobigger import GoBiggerObsConfig, gobigger_frame
from agarcl_tpu_torch.obs.grid import GridObsConfig
from agarcl_tpu_torch.obs.ram import RamObsConfig
from agarcl_tpu_torch.obs.screen import ScreenObsConfig
from agarcl_tpu_torch.ops import fused_grid as FG
from agarcl_tpu_torch.ops import fused_screen as FS
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


def frame_kernel(ocfg):
    """(wrapper, per-frame shape, dtype) of a frame observation on
    kernel-layout planes, routed as the JAX package routes it: the grid
    kernel K4 for a GridObsConfig; for a ScreenObsConfig the screen kernel
    K3 (circle mode, or `poly` mode for polygon configurations it takes,
    fused_screen.supports_polygon), else the GameState route
    (fused_screen.class_map_frame: the wavy virus rim, S > 128); None for
    RAM and no observation. Each wrapper returns (N, A, ...)."""
    if isinstance(ocfg, GridObsConfig):
        G = ocfg.grid_size
        return (FG.fused_grid_frame, (ocfg.channels_per_frame, G, G),
                ocfg.torch_dtype)
    if isinstance(ocfg, ScreenObsConfig):
        S = ocfg.screen_len
        shape = (S, S, 4 if ocfg.agent_view else 3)
        if ocfg.polygon_edges and not FS.supports_polygon(ocfg):
            return FS.class_map_frame, shape, torch.uint8
        return FS.fused_screen_frame, shape, torch.uint8
    return None


def _framed_step(cfg, raw, actions, ocfg, F, frame, tick, out):
    """One step that writes its F frames into out (F, N, A, ...) through
    `tick` (engine_tick_raw or its plain version): the chain of the module
    docstring, zero frames first when F > ticks_per_step. Returns (planes,
    info (N, 2, P))."""
    Fe = min(F, cfg.ticks_per_step)
    out[:F - Fe].zero_()
    raw, _, inf = tick(cfg, raw, cfg.ticks_per_step - Fe + 1, None, actions)
    frame(cfg, ocfg, raw, out=out[F - Fe])
    for f in range(F - Fe + 1, F):
        raw, _, inf = tick(cfg, raw, 1)
        frame(cfg, ocfg, raw, out=out[f])
    return raw, inf


def _frame_steps(cfg, raw, actions, k, ocfg, tick, stack_obs):
    """k framed steps (`_framed_step`) of F = ocfg.num_frames frames each.
    Returns (planes, obs (k, N, F, A, ...) or a k-tuple of (N, F, A, ...),
    info (k, N, 2, P)). Each frame is written into its slice of a
    (k, F, N, A, ...) buffer, returned as a (k, N, F, A, ...) view."""
    frame, shape, dtype = frame_kernel(ocfg)
    F = ocfg.num_frames
    N = raw[0].shape[-1]
    dev = raw[0].device
    full = (F, N, cfg.num_agents) + shape
    buf = (torch.empty((k,) + full, dtype=dtype, device=dev) if stack_obs
           else None)
    frames, info = [], []
    for t in range(k):
        out = (buf[t] if stack_obs
               else torch.empty(full, dtype=dtype, device=dev))
        raw, inf = _framed_step(cfg, raw, actions, ocfg, F, frame, tick, out)
        info.append(inf)
        if not stack_obs:
            frames.append(out.transpose(0, 1))
    obs = buf.transpose(1, 2) if stack_obs else tuple(frames)
    return raw, obs, torch.stack(info)


def multi_step_resident(cfg: EnvConfig, resident: ResidentState, actions,
                        k: int, ocfg, plain: bool = False,
                        stack_obs: bool = True):
    """k env steps on resident state through the K1 wrappers
    (fused_tick.multi_step_raw, and engine_tick_raw for frames), or with
    plain=True through their plain versions on any device. RAM and no
    observation run as one multi_step_raw call; a ScreenObsConfig or
    GridObsConfig runs each step as `_framed_step`'s chain of
    engine_tick_raw calls, a frame wrapper (`frame_kernel`: K3 or K4 on
    CUDA) after each.

    Returns (resident, obs, rewards (k, N, A) f32, dones (k, N, A) bool);
    obs is (k, N, 1, A, R) for RAM, (k, N, F, A, S, S, C) uint8 for screen,
    (k, N, F, A, C, G, G) for grid (screen and grid: a k-tuple of
    (N, F, A, ...) with stack_obs=False), or None."""
    A = cfg.num_agents
    ms = cfg.mode_spec
    if frame_kernel(ocfg) is not None:
        tick = FT.engine_tick_raw_plain if plain else FT.engine_tick_raw
        raw, obs, info = _frame_steps(cfg, resident.raw, actions, k, ocfg,
                                      tick, stack_obs)
    else:
        step = FT.multi_step_raw_plain if plain else FT.multi_step_raw
        raw, obs, info = step(cfg, resident.raw, actions, k, ocfg)
        obs = obs[:, :, None] if obs is not None else None
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
    return new_res, obs, rewards, dones


def fused_env_step(cfg: EnvConfig, states: GameState, actions, ocfg,
                   num_frames: int = 1, auto_reset: bool = False,
                   respawn_main_during_obs: bool = False):
    """One env step of a batch through the kernel wrappers: apply actions
    plus ticks_per_step ticks (multi_step_raw with k=1, K1 on CUDA, which
    also writes the RAM frames of a RamObsConfig), or for a frame
    observation `_framed_step`'s chain of engine_tick_raw calls and frames
    (`frame_kernel`: a ScreenObsConfig: fused_screen_frame, K3 on CUDA, or
    class_map_frame for polygon screens K3 does not take; a GridObsConfig:
    fused_grid_frame, K4 on CUDA); then `_finish_step`. A
    GoBiggerObsConfig takes the plain gobigger_frame of the post-step state
    (the JAX package has no kernel for it). Returns (states,
    obs (N, F, A, ...), a GoBigger dict of (N, 1, A, ...) or None,
    rewards (N, A), dones (N, A))."""
    A = cfg.num_agents
    before = states.player_mass()[:, :A].to(torch.float32)
    ram = isinstance(ocfg, RamObsConfig)
    planes = FT.to_kernel_arrays(states)
    route = frame_kernel(ocfg)
    if route is not None:
        frame, shape, dtype = route
        out = torch.empty((num_frames, states.num_envs, A) + shape,
                          dtype=dtype, device=states.device)
        planes, _ = _framed_step(cfg, planes, actions, ocfg, num_frames,
                                 frame, FT.engine_tick_raw, out)
        obs = out.transpose(0, 1)
    else:
        planes, obs, _ = FT.multi_step_raw(cfg, planes, actions, 1,
                                           ocfg if ram else None)
        obs = obs[0][:, None] if ram else None
    template = states.replace(main_respawned=torch.zeros_like(
        states.main_respawned))
    states = FT.from_kernel_arrays(template, planes)
    if isinstance(ocfg, GoBiggerObsConfig):
        obs = {k: v[:, None] for k, v in gobigger_frame(cfg, ocfg,
                                                        states).items()}
    return _finish_step(cfg, states, obs, before, respawn_main_during_obs,
                        auto_reset)


def _finish_step(cfg: EnvConfig, states: GameState, obs, before,
                 respawn_main_during_obs: bool, auto_reset: bool):
    """Post-frame tail of a step: env.finish_step (main respawn, the mode's
    respawn / termination, rewards), then auto-reset
    (agarcl_tpu/ops/fused_step.py _finish_step)."""
    states, rewards, dones = finish_step(cfg, states, before,
                                         respawn_main_during_obs)
    if auto_reset:
        states = reset_done(cfg, states, dones)
    return states, obs, rewards, dones

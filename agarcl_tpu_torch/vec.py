"""Batched lockstep environments (counterpart of vec.py).

VecEnv(cfg, num_envs, obs_type="ram"|"none", backend="torch"|"cuda",
device=...):

- backend="torch" runs the plain engine (engine_tick plus ram_frame) on any
  device, cpu by default;
- backend="cuda" runs the hand-written kernels: K1, the multi-step tick
  (ops/fused_tick.py), on resident (feature, N) planes, and K2, the RAM
  frame (ops/fused_obs.py), for the reset observation. It needs a CUDA
  device and raises without one; nothing falls back to the CPU or to the
  plain version.

Shapes follow the JAX package: reset obs (N, A, R); multi_step obs
(k, N, 1, A, R) f32, rewards (k, N, A) f32, dones (k, N, A) bool; step
returns them without the k axis.
"""

from __future__ import annotations

import torch

from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.engine.tick import check_supported
from agarcl_tpu_torch.env import env_reset, env_step, reset_seeds
from agarcl_tpu_torch.obs.ram import RamObsConfig, ram_frame
from agarcl_tpu_torch.ops import fused_obs, fused_step
from agarcl_tpu_torch.ops import fused_tick as FT
from agarcl_tpu_torch.state import GameState


class VecEnv:
    def __init__(self, cfg: EnvConfig, num_envs: int, obs_type: str = "ram",
                 backend: str = "torch", device=None, obs_config=None):
        if obs_type not in ("ram", "none"):
            raise ValueError(f"obs_type {obs_type!r} is not ported yet "
                             "(ram and none are)")
        if backend not in ("torch", "cuda"):
            raise ValueError(f"unknown backend {backend!r}")
        check_supported(cfg)
        if backend == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("backend='cuda' needs a CUDA device and "
                                   "none is available")
            device = torch.device(device or "cuda")
            if device.type != "cuda":
                raise ValueError("backend='cuda' runs on a CUDA device")
            if not fused_step.supports_multi(cfg, obs_type):
                raise NotImplementedError(
                    "the cuda backend runs the multi-step tick kernel, which "
                    "this configuration does not fit")
        self.cfg = cfg
        self.num_envs = num_envs
        self.obs_type = obs_type
        self.backend = backend
        self.device = torch.device(device or "cpu")
        self.ocfg = (obs_config or RamObsConfig()) if obs_type == "ram" \
            else None

    def reset(self, seed: int = 0):
        """(states, obs (N, A, R) | None); per-env seeds as
        agarcl_tpu/vec.py:207-208."""
        seeds = reset_seeds(self.num_envs, seed, self.device)
        states = env_reset(self.cfg, seeds)
        obs = None
        if self.ocfg is not None:
            if self.backend == "cuda":
                obs = fused_obs.fused_ram_obs(self.cfg, self.ocfg,
                                              FT.to_kernel_arrays(states))
            else:
                obs = ram_frame(self.cfg, self.ocfg, states)
        return states, obs

    def _actions(self, actions) -> torch.Tensor:
        a = torch.as_tensor(actions, dtype=torch.float32, device=self.device)
        return a.reshape(self.num_envs, self.cfg.num_agents, 3)

    def step(self, states, actions):
        """One env step: (states, obs (N, 1, A, R) | None, rewards (N, A),
        dones (N, A))."""
        states, obs, r, d = self.multi_step(states, actions, 1)
        return states, (obs[0] if obs is not None else None), r[0], d[0]

    def multi_step(self, states, actions, k: int):
        """k env steps with the same actions; `states` is a GameState or a
        ResidentState (from make_resident or a previous resident call),
        and the result has the same kind."""
        actions = self._actions(actions)
        if isinstance(states, fused_step.ResidentState):
            step = (FT.multi_step_raw if self.backend == "cuda"
                    else FT.multi_step_raw_plain)
            return fused_step.multi_step_resident(
                self.cfg, states, actions, k, self.ocfg, step=step)
        if self.backend == "cuda":
            res = fused_step.to_resident(self.cfg, states)
            res, obs, r, d = fused_step.multi_step_resident(
                self.cfg, res, actions, k, self.ocfg)
            return fused_step.from_resident(self.cfg, res), obs, r, d
        obs, rs, ds = [], [], []
        for _ in range(k):
            states, r, d = env_step(self.cfg, states, actions)
            if self.ocfg is not None:
                obs.append(ram_frame(self.cfg, self.ocfg, states)[:, None])
            rs.append(r)
            ds.append(d)
        return (states, torch.stack(obs) if obs else None, torch.stack(rs),
                torch.stack(ds))

    def supports_resident(self) -> bool:
        return fused_step.supports_multi(self.cfg, self.obs_type)

    def make_resident(self, states: GameState) -> fused_step.ResidentState:
        if not self.supports_resident():
            raise NotImplementedError(
                "resident state needs a multi-step-tick configuration with "
                "ram or none observations and no mode-0 respawn")
        return fused_step.to_resident(self.cfg, states)

    def materialize(self, states) -> GameState:
        if isinstance(states, fused_step.ResidentState):
            return fused_step.from_resident(self.cfg, states)
        return states

"""Batched lockstep environments (counterpart of vec.py).

VecEnv(cfg, num_envs, obs_type="ram"|"screen"|"grid"|"gobigger"|"none",
backend="cuda", device="cuda", obs_config=None, auto_reset=False,
respawn_main_during_obs=False). It runs on the card unless the caller asks
for the CPU (backend="torch", device="cpu"); without a CUDA device a card
run raises.

- backend="cuda" runs the hand-written kernels: K1, the multi-step tick
  of rosters up to 9 players with bots (ops/fused_tick.py), K2, the RAM
  frame (ops/fused_obs.py), K3, the screen frame in circle and polygon
  mode (ops/fused_screen.py), and K4, the grid frame (ops/fused_grid.py),
  K3 and K4 drawing one frame per (env, agent). Polygon screens that K3
  does not take (polygon_virus="wavy", or screen_len > 128) go through
  obs/screen.py::screen_frame on the card, as the JAX package sends them
  through its XLA class map. RAM and no observations run as one K1 call per
  multi_step on resident (feature, N) planes. Screen and grid observations
  run on planes converted once per call, each step with num_frames F as K1
  with a tick count (engine_tick_raw) with the actions and
  ticks_per_step - F + 1 ticks, then F - 1 one-tick K1 calls, a K3 or K4
  frame after each (ops/fused_step.py::_framed_step). GoBigger
  observations are a K1 step, then the plain obs/gobigger.py::
  gobigger_frame of the GameState on the card (the JAX package has no
  kernel for them). With auto_reset, respawn_main_during_obs, mode 0's
  respawn or GoBigger every observation type goes step by step through a
  GameState (ops/fused_step.py::fused_env_step; RAM frames from K1 itself).
  Nothing falls back to the CPU or to the plain version.
- backend="torch" runs the plain engine (engine_tick) and the plain frames
  (obs/ram.py::ram_frame; ops/fused_screen.py::frame_plain, or
  obs/screen.py::screen_frame for the polygon screens K3 does not take;
  ops/fused_grid.py::frame_plain) on any device.

Shapes follow the JAX package: reset obs (N, A, R), (N, A, S, S, C),
(N, A, C, G, G) or a GoBigger dict of (N, A, K, F) tables and (N, A, K)
masks; multi_step obs (k, N, F, A, ...) with F = num_frames for screen
(uint8) and grid (the GridObsConfig's dtype), F = 1 for RAM and GoBigger
(screen and grid also as a k-tuple of (N, F, A, ...) with
stack_obs=False; with F > ticks_per_step the first F - ticks_per_step
frames of a step are zeros, as the XLA env_step pads them), rewards
(k, N, A) f32, dones (k, N, A) bool; step returns them without the k axis.
"""

from __future__ import annotations

import torch

from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.engine.tick import check_supported
from agarcl_tpu_torch.env import (env_reset, env_step, reset_done,
                                  reset_seeds, stack_frames)
from agarcl_tpu_torch.obs.gobigger import GoBiggerObsConfig, gobigger_frame
from agarcl_tpu_torch.obs.grid import GridObsConfig
from agarcl_tpu_torch.obs.ram import RamObsConfig, ram_frame
from agarcl_tpu_torch.obs.screen import (ScreenObsConfig, check_config,
                                         screen_frame)
from agarcl_tpu_torch.ops import fused_obs, fused_step
from agarcl_tpu_torch.ops import fused_grid as FG
from agarcl_tpu_torch.ops import fused_screen as FS
from agarcl_tpu_torch.ops import fused_tick as FT
from agarcl_tpu_torch.state import GameState


class VecEnv:
    def __init__(self, cfg: EnvConfig, num_envs: int, obs_type: str = "ram",
                 backend: str = "cuda", device=None, obs_config=None,
                 auto_reset: bool = False,
                 respawn_main_during_obs: bool = False):
        if obs_type not in ("ram", "screen", "grid", "gobigger", "none"):
            raise ValueError(f"unknown obs_type {obs_type!r}")
        if backend not in ("torch", "cuda"):
            raise ValueError(f"unknown backend {backend!r}")
        check_supported(cfg)
        device = torch.device(device or "cuda")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VecEnv runs on a CUDA device and none is "
                               "available (pass backend='torch', "
                               "device='cpu' to run the plain engine on the "
                               "CPU)")
        self.ocfg = None
        if obs_type == "ram":
            self.ocfg = obs_config or RamObsConfig()
        elif obs_type == "screen":
            self.ocfg = obs_config or ScreenObsConfig()
            check_config(self.ocfg)
        elif obs_type == "grid":
            self.ocfg = obs_config or GridObsConfig()
            self.ocfg.torch_dtype                 # validates out_dtype
        elif obs_type == "gobigger":
            self.ocfg = obs_config or GoBiggerObsConfig()
        self._per_step = (auto_reset or respawn_main_during_obs
                          or cfg.mode_spec.respawn_all
                          or obs_type == "gobigger")
        if backend == "cuda":
            if device.type != "cuda":
                raise ValueError("backend='cuda' runs on a CUDA device")
            frames = obs_type in ("screen", "grid")
            fits = (FT.supports(cfg) if frames or self._per_step
                    else fused_step.supports_multi(cfg, obs_type))
            if not fits:
                raise NotImplementedError(
                    "the cuda backend runs the tick kernel, which this "
                    "configuration does not fit")
        self.cfg = cfg
        self.num_envs = num_envs
        self.obs_type = obs_type
        self.backend = backend
        self.device = device
        self.auto_reset = auto_reset
        self.respawn_main_during_obs = respawn_main_during_obs

    def observe(self, states: GameState):
        """(N, A, ...) observation of a GameState, or None."""
        cuda = self.backend == "cuda"
        if self.obs_type == "ram":
            if cuda:
                return fused_obs.fused_ram_obs(self.cfg, self.ocfg,
                                               FT.to_kernel_arrays(states))
            return ram_frame(self.cfg, self.ocfg, states)
        if self.obs_type == "gobigger":
            return gobigger_frame(self.cfg, self.ocfg, states)
        if self.obs_type in ("screen", "grid"):
            route = fused_step.frame_kernel(self.ocfg)[0]
            if route is FS.class_map_frame:
                return screen_frame(self.cfg, self.ocfg, states)
            if not cuda:
                route = (FS.frame_plain if self.obs_type == "screen"
                         else FG.frame_plain)
            return route(self.cfg, self.ocfg, FT.to_kernel_arrays(states))
        return None

    def reset(self, seed: int = 0):
        """(states, obs (N, A, ...) | None); per-env seeds as
        agarcl_tpu/vec.py:207-208."""
        states = env_reset(self.cfg, reset_seeds(self.num_envs, seed,
                                                 self.device))
        return states, self.observe(states)

    def _actions(self, actions) -> torch.Tensor:
        a = torch.as_tensor(actions, dtype=torch.float32, device=self.device)
        return a.reshape(self.num_envs, self.cfg.num_agents, 3)

    def step(self, states, actions):
        """One env step: (states, obs (N, F, A, ...) | None, rewards (N, A),
        dones (N, A))."""
        states, obs, r, d = self.multi_step(states, actions, 1,
                                            stack_obs=False)
        return states, (obs[0] if obs is not None else None), r[0], d[0]

    def multi_step(self, states, actions, k: int, stack_obs: bool = True):
        """k env steps with the same actions; `states` is a GameState or,
        for ram and none observations, a ResidentState (from make_resident
        or a previous resident call), and the result has the same kind.
        stack_obs=False returns the frames as a k-tuple."""
        actions = self._actions(actions)
        if isinstance(states, fused_step.ResidentState):
            return fused_step.multi_step_resident(
                self.cfg, states, actions, k, self.ocfg,
                plain=self.backend != "cuda")
        if self.backend == "cuda" and not self._per_step:
            res = fused_step.to_resident(self.cfg, states)
            res, obs, r, d = fused_step.multi_step_resident(
                self.cfg, res, actions, k, self.ocfg, stack_obs=stack_obs)
            if not stack_obs and self.obs_type == "ram":
                obs = tuple(obs)
            return fused_step.from_resident(self.cfg, res), obs, r, d
        obs, rs, ds = [], [], []
        for _ in range(k):
            if self.backend == "cuda":
                states, o, r, d = fused_step.fused_env_step(
                    self.cfg, states, actions, self.ocfg, self._num_frames(),
                    self.auto_reset, self.respawn_main_during_obs)
            else:
                states, o, r, d = self._plain_step(states, actions)
            obs.append(o)
            rs.append(r)
            ds.append(d)
        if self.ocfg is None:
            obs = None
        elif stack_obs:
            obs = stack_frames(obs, 0)
        else:
            obs = tuple(obs)
        return states, obs, torch.stack(rs), torch.stack(ds)

    def _num_frames(self) -> int:
        """Frames per step: num_frames for screen and grid, else 1."""
        return (self.ocfg.num_frames if self.obs_type in ("screen", "grid")
                else 1)

    def _plain_step(self, states, actions):
        obs_fn = self.observe if self.ocfg is not None else None
        out = env_step(self.cfg, states, actions,
                       self.respawn_main_during_obs, obs_fn=obs_fn,
                       num_frames=self._num_frames())
        if obs_fn is None:
            states, r, d = out
            o = None
        else:
            states, o, r, d = out
        if self.auto_reset:
            states = reset_done(self.cfg, states, d)
        return states, o, r, d

    def supports_resident(self) -> bool:
        return (fused_step.supports_multi(self.cfg, self.obs_type)
                and not self._per_step)

    def make_resident(self, states: GameState) -> fused_step.ResidentState:
        if not self.supports_resident():
            raise NotImplementedError(
                "resident state needs a multi-step-tick configuration with "
                "ram or none observations, no auto_reset, no "
                "respawn_main_during_obs and no mode-0 respawn")
        return fused_step.to_resident(self.cfg, states)

    def materialize(self, states) -> GameState:
        if isinstance(states, fused_step.ResidentState):
            return fused_step.from_resident(self.cfg, states)
        return states

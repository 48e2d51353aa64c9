"""Batched env steps on the kernels (counterpart of ops/fused_step.py).

- `multi_step_resident`: the kernel-layout state carrier and the rim that
  turns the per-step (mass, alive) rows of the multi-step tick into rewards
  and dones (BaseEnvironment.hpp:89-122 semantics, as
  fused_env_multi_step_resident), with per-step screen or grid frames for a
  ScreenObsConfig or GridObsConfig;
- `fused_env_step`: one step on a GameState (as fused_env_step): the tick
  kernel, the frame kernel (screen or grid) on the post-step planes, then
  `_finish_step` (main respawn, mode rules, rewards, auto-reset);
- `StepGraphs`: the same step on one static GameState, its PyTorch glue
  (`_step_in`, `_step_out`) replayed as two CUDA graphs around the eager
  kernel launches (`_step_kernels`); the gym core's step on the card.

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
from agarcl_tpu_torch.profiling import register_counters, span
from agarcl_tpu_torch.state import STATE_FIELDS, GameState, zero_state

graph_captures = 0    # StepGraphs captures (two graphs each)
graph_steps = 0       # gym steps replayed through StepGraphs
eager_steps = 0       # gym steps that took VecEnv.step instead
register_counters(__name__, "fused_step",
                  ("graph_captures", "graph_steps", "eager_steps"))


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


def frame_kernel(ocfg, plain: bool = False):
    """(wrapper, per-frame shape, dtype) of a frame observation on
    kernel-layout planes, routed by the observation config as the JAX
    package routes it: for a GridObsConfig the grid kernel K4 where it
    takes the size (fused_grid.supports: G <= 238), else
    fused_grid.frame_plain on the planes' device (the JAX package's XLA
    grid_frame for a G its kernel does not take); for a ScreenObsConfig
    the screen kernel K3 (circle mode, or `poly` mode for the polygon
    configurations it takes) where fused_screen.supports, else the
    GameState route fused_screen.class_map_frame (the wavy virus rim,
    polygons above S = 128, circles above S = 544); None for RAM and no
    observation. plain=True gives K3's and K4's plain versions in place of
    the kernel wrappers. The counters tell the routes apart (fused_screen
    and fused_grid `launches` / `plain_calls`, obs/screen.py::
    class_map_calls). Each wrapper returns (N, A, ...)."""
    if isinstance(ocfg, GridObsConfig):
        G = ocfg.grid_size
        frame = (FG.fused_grid_frame if FG.supports(ocfg) and not plain
                 else FG.frame_plain)
        return frame, (ocfg.channels_per_frame, G, G), ocfg.torch_dtype
    if isinstance(ocfg, ScreenObsConfig):
        S = ocfg.screen_len
        shape = (S, S, 4 if ocfg.agent_view else 3)
        if not FS.supports(ocfg):
            return FS.class_map_frame, shape, torch.uint8
        frame = FS.frame_plain if plain else FS.fused_screen_frame
        return frame, shape, torch.uint8
    return None


def frame_buffer(cfg: EnvConfig, ocfg, lead: tuple, N: int, device):
    """An empty (*lead, N, A, ...) buffer for frames of a screen or grid
    observation (`frame_kernel`'s per-frame shape and dtype): lead (F,)
    holds one step's frames, (k, F) a call's."""
    _, shape, dtype = frame_kernel(ocfg)
    return torch.empty(lead + (N, cfg.num_agents) + shape, dtype=dtype,
                       device=device)


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


def _frame_steps(cfg, raw, actions, k, ocfg, plain, stack_obs):
    """k framed steps (`_framed_step`) of F = ocfg.num_frames frames each,
    through the kernel wrappers or, with plain=True, their plain versions.
    Returns (planes, obs (k, N, F, A, ...) or a k-tuple of (N, F, A, ...),
    info (k, N, 2, P)). Each frame is written into its slice of a
    (k, F, N, A, ...) buffer, returned as a (k, N, F, A, ...) view."""
    frame = frame_kernel(ocfg, plain)[0]
    tick = FT.engine_tick_raw_plain if plain else FT.engine_tick_raw
    F = ocfg.num_frames
    N = raw[0].shape[-1]
    dev = raw[0].device
    buf = frame_buffer(cfg, ocfg, (k, F), N, dev) if stack_obs else None
    frames, info = [], []
    for t in range(k):
        out = (buf[t] if stack_obs
               else frame_buffer(cfg, ocfg, (F,), N, dev))
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
        raw, obs, info = _frame_steps(cfg, resident.raw, actions, k, ocfg,
                                      plain, stack_obs)
    else:
        step = FT.multi_step_raw_plain if plain else FT.multi_step_raw
        raw, obs, info = step(cfg, resident.raw, actions, k, ocfg)
        obs = obs[:, :, None] if obs is not None else None
    with span("rim.rewards"):
        mass_a = info[:, :, 0, :A]                           # (k, N, A)
        step_alive = info[:, :, 1, :] > 0.0                  # (k, N, P)
        dones = resident.dones[None].expand(k, -1, -1).clone()
        if ms.done_on_death:
            dones[:, :, 0] = (~step_alive).any(-1)
        if ms.done_on_max_mass:
            hit = (mass_a >= C.MODE3_MAX_MASS).any(-1)       # (k, N)
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
                   respawn_main_during_obs: bool = False, out=None):
    """One env step of a batch through the kernel wrappers: apply actions
    plus ticks_per_step ticks (multi_step_raw with k=1, K1 on CUDA, which
    also writes the RAM frames of a RamObsConfig), or for a frame
    observation `_framed_step`'s chain of engine_tick_raw calls and frames
    (`frame_kernel`: a ScreenObsConfig: fused_screen_frame, K3 on CUDA, or
    class_map_frame for screens K3 does not take; a GridObsConfig:
    fused_grid_frame, K4 on CUDA, or frame_plain for grids K4 does not
    take); then `_finish_step`. A
    GoBiggerObsConfig takes the plain gobigger_frame of the post-step state
    (the JAX package has no kernel for it). Returns (states,
    obs (N, F, A, ...), a GoBigger dict of (N, 1, A, ...) or None,
    rewards (N, A), dones (N, A)).

    The frames are drawn into `out`, an (F, N, A, ...) buffer such as one
    step's slice of `frame_buffer(cfg, ocfg, (k, F), ...)` (obs is then its
    transposed view), or without it into a fresh buffer; other
    observations take no `out`.

    The step is three pieces: `_step_in` and `_step_out`, the PyTorch glue
    around `_step_kernels`, the hand-written kernels; `StepGraphs` replays
    the two glue pieces as CUDA graphs."""
    planes, before, template = _step_in(cfg, states)
    planes, obs = _step_kernels(cfg, planes, actions, ocfg, num_frames, out)
    states, gb_obs, rewards, dones = _step_out(
        cfg, template, planes, before, ocfg, respawn_main_during_obs,
        auto_reset)
    return states, (obs if gb_obs is None else gb_obs), rewards, dones


def _step_in(cfg: EnvConfig, states: GameState):
    """The glue before a step's kernels: the agents' masses before the
    step (the `before` of delta-mass rewards), the kernel-layout planes
    (fresh copies) and the template `from_kernel_arrays` fills, with
    main_respawned zeroed. Returns (planes, before, template)."""
    before = states.player_mass()[:, :cfg.num_agents].to(torch.float32)
    planes = FT.to_kernel_arrays(states)
    template = states.replace(main_respawned=torch.zeros_like(
        states.main_respawned))
    return planes, before, template


def _step_kernels(cfg: EnvConfig, planes, actions, ocfg, num_frames: int,
                  out=None):
    """A step's kernels on the planes (in place on CUDA): K1 through
    multi_step_raw (with the RAM frame of a RamObsConfig), or for a frame
    observation `_framed_step`'s chain into `out` (F, N, A, ...), a fresh
    buffer when None. Returns (planes, obs (N, F, A, ...) or None)."""
    route = frame_kernel(ocfg)
    if route is not None:
        if out is None:
            out = frame_buffer(cfg, ocfg, (num_frames,), planes[0].shape[-1],
                               planes[0].device)
        planes, _ = _framed_step(cfg, planes, actions, ocfg, num_frames,
                                 route[0], FT.engine_tick_raw, out)
        return planes, out.transpose(0, 1)
    ram = isinstance(ocfg, RamObsConfig)
    planes, obs, _ = FT.multi_step_raw(cfg, planes, actions, 1,
                                       ocfg if ram else None)
    return planes, (obs[0][:, None] if ram else None)


def _step_out(cfg: EnvConfig, template: GameState, planes, before, ocfg,
              respawn_main_during_obs: bool, auto_reset: bool):
    """The glue after a step's kernels: the GameState of the planes, the
    GoBigger frame of a GoBiggerObsConfig, then `_finish_step`. Returns
    (states, GoBigger obs dict or None, rewards (N, A), dones (N, A))."""
    states = FT.from_kernel_arrays(template, planes)
    obs = None
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
    with span("rim.finish"):
        states, rewards, dones = finish_step(cfg, states, before,
                                             respawn_main_during_obs)
        if auto_reset:
            states = reset_done(cfg, states, dones)
    return states, obs, rewards, dones


class StepGraphs:
    """`fused_env_step` (no auto-reset) of one configuration, RAM, screen or
    grid observation config and batch size on a static GameState that it
    steps in place, with the glue around the kernels replayed as CUDA
    graphs on the state's device: graph A is `_step_in` of the static
    state, graph B `_step_out` and a copy of the new state, rewards and
    dones into static buffers. K1 and K3 / K4 run
    eagerly between the two replays (`_step_kernels`), through their
    wrappers and the library's C entry points, on graph A's planes in
    place; graph B reads them. At one env the glue is some 450 small
    kernels a step, each a launch from the host; a replay is one.

    `state` is the static GameState (the same object for the life of the
    graphs); `load(states)` copies another state into it. The graphs are
    captured at the first step, after one eager warm-up of both pieces on a
    side stream, into one memory pool. The captured pieces copy nothing from
    the host and never wait for the device. `step` returns the static
    state, rewards and dones: the next step overwrites them."""

    def __init__(self, cfg: EnvConfig, ocfg, num_envs: int, device,
                 num_frames: int = 1, respawn_main_during_obs: bool = False):
        self.cfg, self.ocfg = cfg, ocfg
        self.num_frames = num_frames
        self.respawn = respawn_main_during_obs
        self.state = zero_state(cfg, num_envs, device)
        self.rewards = torch.zeros((num_envs, cfg.num_agents),
                                   dtype=torch.float32, device=device)
        self.dones = torch.zeros((num_envs, cfg.num_agents),
                                 dtype=torch.bool, device=device)
        self._in = self._a = self._b = None

    def load(self, states: GameState) -> None:
        """Copy every field of `states` into the static state."""
        for f in STATE_FIELDS:
            getattr(self.state, f).copy_(getattr(states, f))

    def _warm(self) -> None:
        """Both pieces once, eagerly, the static state left as it was: what
        they build once (cached constants) is built before the capture."""
        planes, before, template = _step_in(self.cfg, self.state)
        _step_out(self.cfg, template, planes, before, None, self.respawn,
                  False)

    def _out(self):
        """Graph B's body: `_step_out` of graph A's outputs, copied into the
        static state, rewards and dones."""
        planes, before, template = self._in
        new, _, rewards, dones = _step_out(self.cfg, template, planes,
                                           before, None, self.respawn, False)
        self.load(new)
        self.rewards.copy_(rewards)
        self.dones.copy_(dones)

    def _capture(self) -> None:
        global graph_captures
        dev = self.state.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._warm()
        main.wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        self._a, self._b = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._a, pool=pool):
            self._in = _step_in(self.cfg, self.state)
        with torch.cuda.graph(self._b, pool=pool):
            self._out()
        graph_captures += 1

    def step(self, actions):
        """One step of the static state with (N, A, 3) actions: (state,
        obs (N, F, A, ...) or None, rewards (N, A), dones (N, A))."""
        global graph_steps
        with torch.cuda.device(self.state.device):
            if self._b is None:
                self._capture()
            with span("gym.graph"):
                self._a.replay()
            _, obs = _step_kernels(self.cfg, self._in[0], actions,
                                   self.ocfg, self.num_frames)
            with span("gym.graph"):
                self._b.replay()
        graph_steps += 1
        return self.state, obs, self.rewards, self.dones

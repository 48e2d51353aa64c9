"""Multi-step tick: k whole env steps per call on kernel-layout state
(counterpart of ops/fused_tick.py).

Kernel K1 (csrc/tick.cu) replaces the TPU kernel
agarcl_tpu/ops/fused_tick.py::_make_kernel as launched in n_steps mode by
_multi_step_raw_core, for rosters of up to 9 players (agents plus scripted
bots, with bot decisions and cross-player eating inside the kernel). For
every step it applies the agent actions (env.py::apply_actions), runs
ticks_per_step engine ticks (engine/tick.py), then writes the step's RAM
frame for every agent and each player's (mass, alive) row.

State layout: the `_SPLIT_PLAN` planes of the JAX package — every field as
a contiguous (feature, N) tensor with the env axis last, 41 planes; the
resident carrier (ops/fused_step.py) keeps exactly this layout between
calls. K1 runs one warp per env, B envs a block: a block copies its envs'
columns of the planes (B contiguous words a row) into shared memory at
launch start and back at the end (`launch_shape` reports B, the shared
bytes and the resident blocks per SM); a configuration whose one env does
not fit in a block's shared memory is refused with an error. Outputs are env-major, already in
their public layout: obs (k, N, A, R) f32 and info (k, N, 2, P) f32 (row 0
the player masses, row 1 alive as 0/1).

`multi_step_raw` launches K1 for CUDA tensors and runs the plain version,
`multi_step_raw_plain` (the engine_tick loop plus ram_frame), only for CPU
tensors. `engine_tick_raw`, the counterpart of fused_engine_tick, is K1
called with a tick count and optional actions (null action planes skip the
action phase): the steps that return frames run through it, as do the
partial steps of a multi-frame step; its plain version is
`engine_tick_raw_plain`. Both plain versions share one body. `launches`
counts every K1 launch, `tick_launches` those made through engine_tick_raw.
"""

from __future__ import annotations

import ctypes

import torch

from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.engine.tick import MAX_ROSTER, engine_tick
from agarcl_tpu_torch.env import apply_actions
from agarcl_tpu_torch.obs.ram import RamObsConfig, ram_frame, ram_size
from agarcl_tpu_torch.ops import _build
from agarcl_tpu_torch.ops import params as KP
from agarcl_tpu_torch.state import GameState, zero_state

# (name, kind): "s" per-env scalar -> (1, N); "p" per-player -> (P, N);
# "pk"/"pc" (N,P,F) -> (P*F, N); "v2p" (N,P,2) -> two (P, N);
# "v2c" (N,P,F,2) -> two (P*F, N); "v2" (N,F,2) -> two (F, N);
# "2d" (N,F) -> (F, N). Order and kinds are agarcl_tpu's _SPLIT_PLAN.
SPLIT_PLAN = [
    ("target", "v2p"),
    ("action", "p"), ("split_cooldown", "p"), ("feed_cooldown", "p"),
    ("elapsed_ticks", "p"), ("last_decay_tick", "p"),
    ("anti_team_decay", "p"),
    ("virus_eaten_ticks", "pk"), ("virus_eaten_ptr", "p"),
    ("food_eaten", "p"), ("highest_mass", "p"), ("viruses_eaten", "p"),
    ("cells_eaten", "p"),
    ("cell_pos", "v2c"), ("cell_vel", "v2c"), ("cell_split_vel", "v2c"),
    ("cell_mass", "pc"), ("cell_alive", "pc"), ("cell_id", "pc"),
    ("cell_recombine_at", "pc"), ("next_cell_id", "s"),
    ("pellet_key", "2d"),
    ("virus_pos", "v2"), ("virus_vel", "v2"), ("virus_mass", "2d"),
    ("virus_hits", "2d"), ("virus_alive", "2d"),
    ("food_pos", "v2"), ("food_vel", "v2"), ("food_alive", "2d"),
    ("food_next", "s"), ("ticks", "s"), ("seed", "s"),
]
N_STATE_PLANES = sum(2 if k in ("v2", "v2p", "v2c") else 1
                     for _, k in SPLIT_PLAN)
# field name -> its plane index, or its (x, y) plane indices
PLANE_INDEX = {}
for _name, _kind in SPLIT_PLAN:
    _i = sum(len(v) for v in PLANE_INDEX.values())
    PLANE_INDEX[_name] = ((_i, _i + 1) if _kind in ("v2", "v2p", "v2c")
                          else (_i,))

launches = 0          # K1 launches (multi_step_raw and engine_tick_raw)
tick_launches = 0     # K1 launches made through engine_tick_raw
plain_calls = 0       # multi_step_raw_plain / engine_tick_raw_plain calls


def _seed_plane(seed: torch.Tensor) -> torch.Tensor:
    """int64 [0, 2^32) -> int32 holding the uint32 bit pattern."""
    s = seed & 0xFFFFFFFF
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32)


def to_kernel_arrays(states: GameState) -> list:
    """GameState -> list of contiguous (feature, N) planes. Every plane is
    a fresh copy: K1 updates the planes in place and must never write
    through to the GameState they came from."""
    N = states.num_envs
    out = []
    for name, kind in SPLIT_PLAN:
        x = getattr(states, name)
        if name == "seed":
            x = _seed_plane(x)
        if kind == "s":
            out.append(x[None, :])
        elif kind == "p" or kind == "2d":
            out.append(x.T)
        elif kind in ("pk", "pc"):
            out.append(x.reshape(N, -1).T)
        elif kind == "v2p" or kind == "v2":
            out += [x[..., 0].T, x[..., 1].T]
        elif kind == "v2c":
            out += [x[..., 0].reshape(N, -1).T, x[..., 1].reshape(N, -1).T]
        else:
            raise ValueError(kind)
    return [p.clone(memory_format=torch.contiguous_format) for p in out]


def from_kernel_arrays(template: GameState, planes) -> GameState:
    """Inverse of to_kernel_arrays; the template supplies the fields the
    planes do not carry (dones, main_respawned) and the shapes. Every
    field is a fresh copy, never a view of a plane."""
    kw = {}
    i = 0
    for name, kind in SPLIT_PLAN:
        shp = getattr(template, name).shape
        if kind == "s":
            x = planes[i][0].clone()
            if name == "seed":
                x = x.to(torch.int64) & 0xFFFFFFFF
            kw[name] = x
            i += 1
        elif kind in ("p", "2d", "pk", "pc"):
            kw[name] = planes[i].T.reshape(shp).clone(
                memory_format=torch.contiguous_format)
            i += 1
        else:
            kw[name] = torch.stack([planes[i].T.reshape(shp[:-1]),
                                    planes[i + 1].T.reshape(shp[:-1])],
                                   dim=-1)
            i += 2
    return template.replace(**kw)


def supports(cfg: EnvConfig) -> bool:
    """Configurations K1 covers: rosters of up to 9 players (agents plus
    bots; the JAX package's fused-path cap) at the pinned cell and
    virus-tick capacities."""
    return (cfg.num_players <= MAX_ROSTER
            and cfg.max_cells == KP.MAX_CELLS
            and cfg.virus_ticks_capacity == KP.MAX_TICKS_RING
            and cfg.virus_capacity <= KP.MAX_VIRUSES)


def _actions_planes(cfg: EnvConfig, actions: torch.Tensor, N: int):
    acts = actions.to(torch.float32).reshape(N, cfg.num_agents, 3)
    return (acts[..., 0].T.contiguous(), acts[..., 1].T.contiguous(),
            acts[..., 2].to(torch.int32).T.contiguous())


def _plain_steps(cfg: EnvConfig, planes, actions, k: int, n_ticks: int,
                 ocfg: RamObsConfig | None):
    """The one body of K1's plain versions: from the planes, k times
    (apply_actions unless actions is None, n_ticks x engine_tick, ram_frame
    of a RamObsConfig, mass/alive rows), back to planes. Returns (planes,
    obs (k,N,A,R) | None, info (k,N,2,P))."""
    global plain_calls
    plain_calls += 1
    N = planes[0].shape[-1]
    state = from_kernel_arrays(zero_state(cfg, N, planes[0].device), planes)
    obs, info = [], []
    for _ in range(k):
        if actions is not None:
            state = apply_actions(cfg, state, actions)
        for _ in range(n_ticks):
            state = engine_tick(cfg, state)
        if ocfg is not None:
            obs.append(ram_frame(cfg, ocfg, state))
        info.append(torch.stack([state.player_mass().to(torch.float32),
                                 state.player_alive().to(torch.float32)],
                                dim=1))
    obs_t = torch.stack(obs) if ocfg is not None else None
    return to_kernel_arrays(state), obs_t, torch.stack(info)


def multi_step_raw_plain(cfg: EnvConfig, planes, actions, k: int,
                         ocfg: RamObsConfig | None):
    """The plain version of K1 on any device: k times (apply_actions,
    ticks_per_step x engine_tick, ram_frame, mass/alive rows). Returns
    (planes, obs (k,N,A,R) | None, info (k,N,2,P))."""
    return _plain_steps(cfg, planes, actions, k, cfg.ticks_per_step, ocfg)


def engine_tick_raw_plain(cfg: EnvConfig, planes, n_ticks: int,
                          ocfg: RamObsConfig | None = None, actions=None):
    """The plain version of engine_tick_raw on any device: optional
    apply_actions, n_ticks x engine_tick, then the RAM frame of a
    RamObsConfig and the (mass, alive) rows. Returns (planes,
    obs (N,A,R) | None, info (N,2,P))."""
    planes, obs, info = _plain_steps(cfg, planes, actions, 1, n_ticks, ocfg)
    return planes, (obs[0] if obs is not None else None), info[0]


def _plane_specs(cfg: EnvConfig):
    """(field name, rows, dtype) of every plane, in SPLIT_PLAN order."""
    P, Cc, K = cfg.num_players, cfg.max_cells, cfg.virus_ticks_capacity
    f32, i32, b = torch.float32, torch.int32, torch.bool
    rows = {"s": 1, "p": P}
    dtypes = {"target": f32, "anti_team_decay": f32, "cell_pos": f32,
              "cell_vel": f32, "cell_split_vel": f32, "virus_pos": f32,
              "virus_vel": f32, "food_pos": f32, "food_vel": f32,
              "cell_alive": b, "virus_alive": b, "food_alive": b}
    widths = {"virus_eaten_ticks": P * K, "cell_mass": P * Cc,
              "cell_alive": P * Cc, "cell_id": P * Cc,
              "cell_recombine_at": P * Cc, "cell_pos": P * Cc,
              "cell_vel": P * Cc, "cell_split_vel": P * Cc,
              "pellet_key": cfg.pellet_capacity,
              "virus_pos": cfg.virus_capacity, "virus_vel": cfg.virus_capacity,
              "virus_mass": cfg.virus_capacity,
              "virus_hits": cfg.virus_capacity,
              "virus_alive": cfg.virus_capacity,
              "food_pos": cfg.food_capacity, "food_vel": cfg.food_capacity,
              "food_alive": cfg.food_capacity}
    specs = []
    for name, kind in SPLIT_PLAN:
        r = rows.get(kind, widths.get(name, P))
        dt = dtypes.get(name, i32)
        specs += [(name, r, dt)] * (2 if kind in ("v2", "v2p", "v2c") else 1)
    return specs


def check_planes(cfg: EnvConfig, planes) -> int:
    """Validate count, device, dtype, shape and contiguity of the planes
    (all on the first plane's device); returns N."""
    specs = _plane_specs(cfg)
    if len(planes) != len(specs):
        raise ValueError(f"expected {len(specs)} state planes, got "
                         f"{len(planes)}")
    N = planes[0].shape[-1]
    dev = planes[0].device
    for p, (name, rows, dtype) in zip(planes, specs):
        if p.device != dev:
            raise ValueError(f"plane {name} is on {p.device}, expected "
                             f"{dev}")
        if p.dtype != dtype:
            raise TypeError(f"plane {name} has dtype {p.dtype}, expected "
                            f"{dtype}")
        if tuple(p.shape) != (rows, N):
            raise ValueError(f"plane {name} has shape {tuple(p.shape)}, "
                             f"expected {(rows, N)}")
        if not p.is_contiguous():
            raise ValueError(f"plane {name} is not contiguous")
    return N


def _ptr_array(tensors):
    arr = (ctypes.c_void_p * len(tensors))()
    for i, t in enumerate(tensors):
        arr[i] = t.data_ptr()
    return arr


def _check_call(cfg: EnvConfig, planes, actions):
    """Validate a K1 call (roster, device, planes, actions); returns N."""
    if not supports(cfg):
        raise NotImplementedError(
            f"the multi-step kernel covers rosters of up to {MAX_ROSTER} "
            f"players at the pinned capacities ({cfg.num_players} players)")
    dev = planes[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    N = check_planes(cfg, planes)
    if actions is not None:
        A = cfg.num_agents
        if actions.device != dev or actions.numel() != N * A * 3:
            raise ValueError(f"actions must be ({N}, {A}, 3) on {dev}")
    return N


def _launch(cfg: EnvConfig, planes, actions, k: int, n_ticks: int,
            ocfg: RamObsConfig | None, N: int):
    """One K1 launch: k x (actions unless None, n_ticks ticks, RAM frame,
    info rows) on the planes in place. Returns (obs (k,N,A,R) | None,
    info (k,N,2,P))."""
    global launches
    dev = planes[0].device
    A, P = cfg.num_agents, cfg.num_players
    R = ram_size(cfg, ocfg or RamObsConfig())
    obs = (torch.empty((k, N, A, R), dtype=torch.float32, device=dev)
           if ocfg is not None else None)
    info = torch.empty((k, N, 2, P), dtype=torch.float32, device=dev)
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    ax = ay = aact = None
    if actions is not None:
        ax, ay, aact = _actions_planes(cfg, actions, N)
    lib = _build.load()
    prm = KP.env_params(cfg, ocfg)
    status = lib.agarcl_multi_step(
        ctypes.byref(prm), _ptr_array(planes), ptr(ax), ptr(ay), ptr(aact),
        ptr(obs), info.data_ptr(), N, k, n_ticks,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, status, "multi-step tick kernel")
    launches += 1
    return obs, info


def launch_shape(cfg: EnvConfig, N: int) -> dict:
    """K1's launch shape for N envs on the card: blocks, envs (warps) per
    block, dynamic shared bytes, resident blocks per SM (the occupancy
    API) and one env's region bytes. Raises if K1 refuses the
    configuration (one env does not fit in a block)."""
    lib = _build.load()
    out = (ctypes.c_int * 5)()
    status = lib.agarcl_multi_step_shape(
        ctypes.byref(KP.env_params(cfg, None)), N, out)
    _build.check(lib, status, "multi-step tick kernel shape")
    return dict(zip(("blocks", "envs_per_block", "smem_bytes",
                     "blocks_per_sm", "env_bytes"), out))


def multi_step_raw(cfg: EnvConfig, planes, actions, k: int,
                   ocfg: RamObsConfig | None):
    """k env steps on kernel-layout planes: K1 for CUDA tensors (updated
    in place), the plain version for CPU tensors. Returns (planes,
    obs (k,N,A,R) | None, info (k,N,2,P))."""
    actions = torch.as_tensor(actions)
    N = _check_call(cfg, planes, actions)
    if k < 1:
        raise ValueError("k must be >= 1")
    if planes[0].device.type == "cpu":
        return multi_step_raw_plain(cfg, planes, actions, k, ocfg)
    obs, info = _launch(cfg, planes, actions, k, cfg.ticks_per_step, ocfg, N)
    return planes, obs, info


def engine_tick_raw(cfg: EnvConfig, planes, n_ticks: int,
                    ocfg: RamObsConfig | None = None, actions=None):
    """K1 with a tick count (fused_engine_tick's counterpart): optional
    actions, then n_ticks engine ticks of the planes, then the RAM frame of
    a RamObsConfig and the info rows. K1 for CUDA tensors (planes updated
    in place), engine_tick_raw_plain for CPU tensors. Returns (planes,
    obs (N,A,R) | None, info (N,2,P))."""
    if actions is not None:
        actions = torch.as_tensor(actions)
    N = _check_call(cfg, planes, actions)
    if n_ticks < 0:
        raise ValueError("n_ticks must be >= 0")
    if planes[0].device.type == "cpu":
        return engine_tick_raw_plain(cfg, planes, n_ticks, ocfg, actions)
    global tick_launches
    obs, info = _launch(cfg, planes, actions, 1, n_ticks, ocfg, N)
    tick_launches += 1
    return planes, (obs[0] if obs is not None else None), info[0]

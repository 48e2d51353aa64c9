"""Environment core on batched states (counterpart of env.py).

Mirrors BaseEnvironment (BaseEnvironment.hpp:34-428): action application,
the ticks_per_step engine loop, per-mode respawn/termination and the mass
or delta-mass rewards.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from agarcl_tpu_torch import constants as C
from agarcl_tpu_torch import prng
from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.engine import geometry as G
from agarcl_tpu_torch.engine import spawn as S
from agarcl_tpu_torch.engine.tick import engine_tick
from agarcl_tpu_torch.profiling import span
from agarcl_tpu_torch.state import GameState, zero_state


def env_reset(cfg: EnvConfig, seeds: torch.Tensor) -> GameState:
    """Fresh games, one per seed ((N,) ints in [0, 2^32)): world init and
    one 25-mass (or agent_mass) cell per player."""
    with span("reset.engine"):
        return _reset(cfg, seeds)


def _reset(cfg: EnvConfig, seeds: torch.Tensor) -> GameState:
    seeds = torch.as_tensor(seeds).to(torch.int64) & 0xFFFFFFFF
    dev = seeds.device
    N = seeds.shape[0]
    state = zero_state(cfg, N, dev).replace(seed=seeds)
    pellet_key = S.initial_pellets(cfg, seeds)
    virus_pos, virus_alive = S.initial_viruses(cfg, seeds)
    state = state.replace(pellet_key=pellet_key, virus_pos=virus_pos,
                          virus_alive=virus_alive)
    P = cfg.num_players
    pid = torch.arange(P, dtype=torch.int32, device=dev)
    loc = S.respawn_location(cfg, state.pellet_xy_alive(cfg)[0], seeds,
                             torch.full((N,), -1, dtype=torch.int32,
                                        device=dev), pid)
    mass0 = max(C.CELL_MIN_SIZE, cfg.mode_spec.agent_mass)
    cell_pos = state.cell_pos.clone()
    cell_pos[:, :, 0] = loc
    cell_mass = state.cell_mass.clone()
    cell_mass[:, :, 0] = mass0
    cell_alive = state.cell_alive.clone()
    cell_alive[:, :, 0] = True
    cell_id = state.cell_id.clone()
    cell_id[:, :, 0] = pid + 1
    return state.replace(
        cell_pos=cell_pos, cell_mass=cell_mass, cell_alive=cell_alive,
        cell_id=cell_id,
        next_cell_id=torch.full((N,), P + 1, dtype=torch.int32, device=dev))


def reset_seeds(num_envs: int, seed: int, device=None,
                offset: int = 0) -> torch.Tensor:
    """The per-env seeds of VecEnv.reset(seed) (agarcl_tpu/vec.py:207-208):
    arange(N) + (seed * 0x9E3779B9 mod 2^32), wrapping in uint32. `offset`
    is the global index of the first env: a shard of ShardedVecEnv gets
    its slice offset:offset+N of the global seeds
    (agarcl_tpu/parallel/mesh.py:102-106)."""
    base = (seed * 0x9E3779B9) & 0xFFFFFFFF
    return (torch.arange(offset, offset + num_envs, dtype=torch.int64,
                         device=device) + base) & 0xFFFFFFFF


def apply_actions(cfg: EnvConfig, state: GameState, actions) -> GameState:
    """take_actions (BaseEnvironment.hpp:141-176): each live agent gets
    target = centroid + 10*(dx, dy) and action = act; the centroid and the
    fused multiply-add are XLA-CPU's forms, so targets equal the jitted JAX
    package's bit for bit.

    actions: (N, A, 3) f32 columns (dx, dy, act in {0,1,2})."""
    A = cfg.num_agents
    N = state.num_envs
    actions = torch.as_tensor(actions, dtype=torch.float32,
                              device=state.device).reshape(N, A, 3)
    centroid = state.player_centroid()[:, :A]
    alive = state.player_alive()[:, :A]
    tgt = G.fma32(C.TARGET_ACTION_SCALE, actions[..., :2], centroid)
    act = actions[..., 2].to(torch.int32)
    target = state.target.clone()
    target[:, :A] = torch.where(alive[..., None], tgt, state.target[:, :A])
    action = state.action.clone()
    action[:, :A] = torch.where(alive, act, state.action[:, :A])
    return state.replace(target=target, action=action)


def respawn_players(cfg: EnvConfig, state: GameState,
                    mask: torch.Tensor) -> GameState:
    """Engine::respawn for every masked (N, P) player: all cells cleared,
    cooldowns / anti-team / elapsed reset, one fresh cell of
    max(25, agent_mass) at a random (or squared-layout) location."""
    P = cfg.num_players
    dev = state.device
    pid = torch.arange(P, dtype=torch.int32, device=dev)
    loc = S.respawn_location(cfg, state.pellet_xy_alive(cfg)[0], state.seed,
                             state.ticks, pid)
    mass0 = max(C.CELL_MIN_SIZE, cfg.mode_spec.agent_mass)
    m = mask
    mc = m[..., None]
    order = torch.cumsum(m.to(torch.int32), -1) - 1
    new_ids = state.next_cell_id[:, None] + order
    oh0 = (torch.arange(cfg.max_cells, device=dev) == 0) & mc
    i32 = torch.int32
    return state.replace(
        cell_pos=torch.where(oh0[..., None], loc[:, :, None, :],
                             state.cell_pos),
        cell_vel=torch.where(mc[..., None], 0.0, state.cell_vel),
        cell_split_vel=torch.where(mc[..., None], 0.0, state.cell_split_vel),
        cell_mass=torch.where(oh0, mass0, torch.where(mc, 0, state.cell_mass)
                              ).to(i32),
        cell_alive=torch.where(mc, oh0, state.cell_alive),
        cell_id=torch.where(oh0, new_ids[..., None], state.cell_id).to(i32),
        cell_recombine_at=torch.where(mc, 0, state.cell_recombine_at).to(i32),
        next_cell_id=state.next_cell_id + m.sum(-1, dtype=i32),
        split_cooldown=torch.where(m, 0, state.split_cooldown).to(i32),
        feed_cooldown=torch.where(m, 0, state.feed_cooldown).to(i32),
        elapsed_ticks=torch.where(m, 0, state.elapsed_ticks).to(i32),
        last_decay_tick=torch.where(m, 0, state.last_decay_tick).to(i32),
        anti_team_decay=torch.where(m, 1.0, state.anti_team_decay),
        virus_eaten_ticks=torch.where(mc, -(2**30),
                                      state.virus_eaten_ticks).to(i32),
        virus_eaten_ptr=torch.where(m, 0, state.virus_eaten_ptr).to(i32),
    )


def agent_masses(cfg: EnvConfig, state: GameState) -> torch.Tensor:
    """(N, A) f32 masses of the RL agents."""
    return state.player_mass()[:, :cfg.num_agents].to(torch.float32)


def env_step(cfg: EnvConfig, state: GameState, actions,
             respawn_main_during_obs: bool = False, obs_fn=None,
             num_frames: int = 1):
    """One environment step (BaseEnvironment::step): apply actions, run
    ticks_per_step engine ticks, apply the mode's respawn / termination,
    and return (state, rewards (N, A) f32, dones (N, A) bool).

    With obs_fn (state -> (N, ...) frame) it returns (state, obs, rewards,
    dones), obs (N, num_frames, ...) holding one frame for each of the last
    num_frames ticks, zero frames first when num_frames > ticks_per_step.
    respawn_main_during_obs respawns a dead main player once the frames
    are taken and charges the step c_death (ScreenEnvironment.hpp:233-243).
    """
    state = apply_actions(cfg, state, actions)
    before = agent_masses(cfg, state)
    state = state.replace(main_respawned=torch.zeros_like(
        state.main_respawned))
    F = min(num_frames, cfg.ticks_per_step) if obs_fn is not None else 0
    frames = []
    for t in range(cfg.ticks_per_step):
        state = engine_tick(cfg, state)
        if t >= cfg.ticks_per_step - F:
            frames.append(obs_fn(state))
    if obs_fn is not None and num_frames > F:
        frames = [torch.zeros_like(frames[0])] * (num_frames - F) + frames
    state, rewards, dones = finish_step(cfg, state, before,
                                        respawn_main_during_obs)
    if obs_fn is None:
        return state, rewards, dones
    return state, stack_frames(frames, 1), rewards, dones


def stack_frames(frames, dim: int):
    """Stack frames along dim; a structured (dict) frame is stacked key by
    key."""
    if isinstance(frames[0], dict):
        return {k: torch.stack([f[k] for f in frames], dim)
                for k in frames[0]}
    return torch.stack(frames, dim)


def finish_step(cfg: EnvConfig, state: GameState, before,
                respawn_main_during_obs: bool = False):
    """The tail of a step once its ticks ran and its frames were taken:
    the main respawn, the mode's respawn / termination and the rewards
    against the agents' masses `before` the ticks. Returns (state, rewards
    (N, A) f32, dones (N, A) bool)."""
    ms = cfg.mode_spec
    if respawn_main_during_obs:
        main_dead = ~state.player_alive()[:, 0]
        mask = main_dead[:, None] & (torch.arange(
            cfg.num_players, device=state.device) == 0)
        state = respawn_players(cfg, state, mask)
        state = state.replace(main_respawned=state.main_respawned | main_dead)
    dones = state.dones.clone()
    if ms.respawn_all:                                   # mode 0
        with span("rim.respawn_all"):
            state = respawn_players(cfg, state, ~state.player_alive())
    elif ms.done_on_death:                               # modes 7-10
        dones[:, 0] = (~state.player_alive()).any(-1) | state.main_respawned
    rewards = agent_masses(cfg, state)
    if ms.done_on_max_mass:                              # mode 3
        dones[:, 0] = dones[:, 0] | (rewards >= C.MODE3_MAX_MASS).any(-1)
    if cfg.reward_type:
        penalty = torch.where(state.main_respawned,
                              float(np.float32(cfg.c_death)), 0.0)[:, None]
        rewards = rewards - (before - penalty)
    return state.replace(dones=dones), rewards, dones


def reset_done(cfg: EnvConfig, state: GameState, dones) -> GameState:
    """Replace every env with a done agent by a fresh reset, seeded from
    its seed and tick (agarcl_tpu/vec.py:91-102)."""
    done_env = dones.any(1)
    if not bool(done_env.any()):
        return state
    fresh = env_reset(cfg, prng.hash_u32(state.seed, 7, state.ticks, 0, 0))
    kw = {}
    for f in dataclasses.fields(GameState):
        s, n = getattr(state, f.name), getattr(fresh, f.name)
        kw[f.name] = torch.where(
            done_env.reshape((-1,) + (1,) * (s.dim() - 1)), n, s)
    return GameState(**kw)

"""World initialization, respawn placement and pellet/virus regeneration
(counterpart of engine/spawn.py).

Reference: initialize_game / add_pellets / add_viruses /
create_squared_pellets (Engine.hpp:111-117,418-485), respawn
(Engine.hpp:119-137), regeneration (Engine.hpp:230-237). Placement of slot
n at tick t is a pure function of (seed, stream, t, n) (SPEC D2).
"""

from __future__ import annotations

import numpy as np
import torch

from agarcl_tpu_torch import constants as C
from agarcl_tpu_torch import prng
from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.engine.geometry import fma32
from agarcl_tpu_torch.state import encode_pellet_key

INIT_TICK = -1  # "tick" counter value of the initial placement draws


def _f32(x) -> float:
    return float(np.float32(x))


def random_location(arena_w, arena_h, radius, seed, stream, tick, slot):
    """Engine::random_location: uniform in [r, W-r) x [r, H-r), drawn as
    fma(f32(W - 2r), u, f32(r)) with u the f32 uniform (W - 2r formed in
    f64 first). XLA-CPU fuses uniform_range(0, W - 2r) + r into that one
    fma in every context the JAX package draws it (reset, respawn, regen),
    read off its output; the product rounded first differs on about a
    quarter of the draws."""
    r = _f32(radius)
    x = fma32(_f32(arena_w - 2.0 * radius),
              prng.uniform(seed, stream, tick, slot, 0), r)
    y = fma32(_f32(arena_h - 2.0 * radius),
              prng.uniform(seed, stream, tick, slot, 1), r)
    return torch.stack([x, y], dim=-1)


def pellet_qparams(cfg: EnvConfig):
    """(q_lo_x, nq_x, q_lo_y, nq_y) ints of the quantized pellet spawn
    draw: the margin comes from the f32 pellet radius, computed in f64."""
    rad = np.float32(np.sqrt(C.PELLET_MASS / np.pi))

    def p(arena):
        q_lo = int(np.ceil(float(rad) * 32768.0 / float(arena)))
        return q_lo, 32768 - 2 * q_lo

    qx, nx = p(cfg.arena_width)
    qy, ny = p(cfg.arena_height)
    return qx, nx, qy, ny


def pellet_spawn_keys(cfg: EnvConfig, seed, tick, slot) -> torch.Tensor:
    """i32 pellet keys drawn on the quantized grid with exact integer
    arithmetic (prng.uniform_q)."""
    qlx, nqx, qly, nqy = pellet_qparams(cfg)
    qx = prng.uniform_q(nqx, seed, prng.STREAM_PELLET, tick, slot, 0) + qlx
    qy = prng.uniform_q(nqy, seed, prng.STREAM_PELLET, tick, slot, 1) + qly
    return (qx << 15) | qy


def squared_pellet_layout(cfg: EnvConfig) -> np.ndarray:
    """create_squared_pellets: a pellet ring on a centered square of side
    min(W,H)/2, spacing 1, laid out top, right, bottom, left."""
    w, h = cfg.arena_width, cfg.arena_height
    size = min(w, h) / 2
    n = int(size / 1.0)
    cx, cy, half = w / 2, h / 2, size / 2
    pts = []
    for i in range(n):
        pts.append((cx - half + i, cy - half))
    for i in range(n):
        pts.append((cx + half, cy - half + i))
    for i in range(n):
        pts.append((cx + half - i, cy + half))
    for i in range(n):
        pts.append((cx - half, cy + half - i))
    pts = [(x, y) for (x, y) in pts if 0 <= x <= w and 0 <= y <= h]
    return np.asarray(pts, dtype=np.float32)


def initial_pellets(cfg: EnvConfig, seed: torch.Tensor) -> torch.Tensor:
    """(N, Np) i32 pellet keys for fresh games; seed (N,) int64."""
    Np = cfg.pellet_capacity
    dev = seed.device
    N = seed.shape[0]
    if cfg.mode_spec.squared_pellets:
        layout = squared_pellet_layout(cfg)
        n = layout.shape[0]
        pos = np.zeros((Np, 2), np.float32)
        pos[:n] = layout
        alive = np.zeros((Np,), bool)
        alive[:n] = True
        key = encode_pellet_key(cfg, torch.from_numpy(pos).to(dev),
                                torch.from_numpy(alive).to(dev))
        return key.expand(N, Np).clone()
    slot = torch.arange(Np, dtype=torch.int32, device=dev)
    key = pellet_spawn_keys(cfg, seed[:, None], INIT_TICK, slot)
    return torch.where(slot < cfg.num_pellets, key, -1).to(torch.int32)


def initial_viruses(cfg: EnvConfig, seed: torch.Tensor):
    """((N, Nv, 2) f32 positions, (N, Nv) bool alive)."""
    Nv = cfg.virus_capacity
    slot = torch.arange(Nv, dtype=torch.int32, device=seed.device)
    rad = float(np.sqrt(C.VIRUS_INITIAL_MASS / np.pi))
    pos = random_location(cfg.arena_width, cfg.arena_height, rad,
                          seed[:, None], prng.STREAM_VIRUS, INIT_TICK, slot)
    alive = (slot < cfg.num_viruses).expand(seed.shape[0], Nv).clone()
    return pos, alive


def respawn_location(cfg: EnvConfig, pellet_pos, seed, tick, player_slot):
    """Engine::respawn placement: squared-pellet modes place the player
    near pellet slot 0 offset by two min-cell radii (clamped); otherwise
    uniform with the min-cell radius margin.

    pellet_pos (N, Np, 2); seed and tick (N,); player_slot (P,).
    Returns (N, P, 2)."""
    rad25 = float(np.sqrt(C.CELL_MIN_SIZE / np.pi))
    N = seed.shape[0]
    P = player_slot.shape[0]
    if cfg.mode_spec.squared_pellets:
        loc = pellet_pos[:, 0] + _f32(2.0 * rad25)
        hi = torch.tensor([_f32(cfg.arena_width - rad25),
                           _f32(cfg.arena_height - rad25)],
                          dtype=torch.float32, device=loc.device)
        loc = torch.minimum(loc, hi)
        return loc[:, None, :].expand(N, P, 2).clone()
    return random_location(cfg.arena_width, cfg.arena_height, rad25,
                           seed[:, None], prng.STREAM_RESPAWN,
                           torch.as_tensor(tick)[..., None], player_slot)


def regen(cfg: EnvConfig, pellet_key, virus_pos, virus_vel, virus_mass,
          virus_hits, virus_alive, seed, tick):
    """Every REGEN_PERIOD ticks, refill pellets and viruses to their
    targets, dead slots lowest-first; draws key on (tick, slot).
    seed and tick are (N,)."""
    dev = pellet_key.device
    due = (torch.remainder(tick, C.REGEN_PERIOD) == 0)[:, None]
    rad_v = float(np.sqrt(C.VIRUS_INITIAL_MASS / np.pi))

    p_alive = pellet_key >= 0
    n_alive = p_alive.sum(-1, keepdim=True)
    deficit = torch.clamp(cfg.num_pellets - n_alive, min=0)
    dead_order = torch.cumsum((~p_alive).to(torch.int32), -1) - 1
    fill = due & ~p_alive & (dead_order < deficit)
    slot = torch.arange(pellet_key.shape[-1], dtype=torch.int32, device=dev)
    new_key = pellet_spawn_keys(cfg, seed[:, None], tick[:, None], slot)
    pellet_key = torch.where(fill, new_key, pellet_key).to(torch.int32)

    nv_alive = virus_alive.sum(-1, keepdim=True)
    deficit_v = torch.clamp(cfg.num_viruses - nv_alive, min=0)
    dead_order_v = torch.cumsum((~virus_alive).to(torch.int32), -1) - 1
    fill_v = due & ~virus_alive & (dead_order_v < deficit_v)
    vslot = torch.arange(virus_alive.shape[-1], dtype=torch.int32,
                         device=dev)
    new_vpos = random_location(cfg.arena_width, cfg.arena_height, rad_v,
                               seed[:, None], prng.STREAM_VIRUS,
                               tick[:, None], vslot)
    virus_pos = torch.where(fill_v[..., None], new_vpos, virus_pos)
    virus_vel = torch.where(fill_v[..., None], 0.0, virus_vel)
    virus_mass = torch.where(fill_v, C.VIRUS_INITIAL_MASS,
                             virus_mass).to(torch.int32)
    virus_hits = torch.where(fill_v, 0, virus_hits).to(torch.int32)
    virus_alive = virus_alive | fill_v
    return pellet_key, virus_pos, virus_vel, virus_mass, virus_hits, \
        virus_alive

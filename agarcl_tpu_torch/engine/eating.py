"""Order-pinned, mask-parallel eating resolution (counterpart of
engine/eating.py).

Contested prey always goes to the lowest (pid, cell-rank) eligible eater
(SPEC M1-M5), including cells of other players (cross_player_eat). Batched
over N envs; shapes (N, P, Cc) for cells.
"""

from __future__ import annotations

import torch

from agarcl_tpu_torch import constants as C
from agarcl_tpu_torch.engine import geometry as G

_BIG_I = 2**30


def order_key(rank: torch.Tensor) -> torch.Tensor:
    """(N,P,Cc) i32 global resolution key: pid * Cc + rank (SPEC M1)."""
    P, Cc = rank.shape[-2:]
    pid = torch.arange(P, dtype=torch.int32, device=rank.device)[:, None]
    return pid * Cc + rank


def _resolve(eligible: torch.Tensor, rank: torch.Tensor):
    """eligible (N,P,Cc,M) -> (eaten_per_cell (N,P,Cc) i32, eaten (N,M))."""
    N, P, Cc, M = eligible.shape
    key = torch.where(eligible, order_key(rank)[..., None],
                      torch.full((), _BIG_I, dtype=torch.int32,
                                 device=rank.device))
    min_key = key.reshape(N, P * Cc, M).min(1).values        # (N, M)
    eaten = min_key < _BIG_I
    winner = eligible & (key == min_key[:, None, None, :])
    return winner.sum(-1, dtype=torch.int32), eaten


def _dist2(cell_pos, xy):
    """(N,P,Cc,2) cells vs (N,M,2) entities -> (N,P,Cc,M) squared dist."""
    d = cell_pos[:, :, :, None, :] - xy[:, None, None, :, :]
    return G.norm2(d[..., 0], d[..., 1])


def eat_pellets(cell_pos, cell_mass, cell_alive, rank, pellet_pos,
                pellet_alive):
    """Pellet eating (Engine.hpp:976-1000) under SPEC M1: a pellet inside
    a live cell's radius goes to the lowest (pid, rank) such cell, +1 mass.

    Returns (eaten_per_cell (N,P,Cc) i32, pellet_alive (N,Np) bool)."""
    rad = G.radius(cell_mass)
    eligible = (cell_alive[..., None] & pellet_alive[:, None, None, :]
                & ((rad * rad)[..., None] >= _dist2(cell_pos, pellet_pos)))
    per_cell, eaten = _resolve(eligible, rank)
    return per_cell, pellet_alive & ~eaten


def eat_foods(cell_pos, cell_mass, cell_alive, rank, food_pos, food_alive):
    """Ejected-mass eating (Engine.hpp:1011-1025) under SPEC M5.

    Returns (eaten_per_cell (N,P,Cc) i32, food_alive (N,Nf) bool)."""
    rad = G.radius(cell_mass)
    rad_food = G.radius(float(C.FOOD_MASS))
    rm = torch.maximum(rad, rad_food)[..., None]
    can_eat = (cell_mass > int(C.FOOD_MASS * C.CELL_EAT_MARGIN))[..., None]
    eligible = (cell_alive[..., None] & food_alive[:, None, None, :]
                & can_eat & (rm * rm >= _dist2(cell_pos, food_pos)))
    per_cell, eaten = _resolve(eligible, rank)
    return per_cell, food_alive & ~eaten


def virus_events(cell_pos, cell_mass, cell_alive, rank, virus_pos,
                 virus_mass, virus_alive, can_eat_virus):
    """Virus collision selection (Engine.hpp:1223-1252) under SPEC M2.

    Per player, the eligible (cell, virus) pair minimizing (cell rank,
    virus slot); per virus only the lowest-pid player's event stands.
    can_eat_virus (N,P) bool: the player had >= NUM_CELLS_TO_SPLIT cells at
    tick start. Returns a dict of (N,P) tensors hit, cell_slot, virus_slot,
    mass_gain, disrupt, and the updated (N,Nv) virus_alive."""
    N, P, Cc = cell_mass.shape
    Nv = virus_mass.shape[-1]
    dev = cell_mass.device
    rad_c = G.radius(cell_mass)[..., None]
    rad_v = G.radius(virus_mass)[:, None, None, :]
    rm = torch.maximum(rad_c, rad_v)
    can_eat = (cell_mass[..., None].to(torch.float32)
               > virus_mass[:, None, None, :].to(torch.float32)
               * float(torch.tensor(C.CELL_EAT_MARGIN, dtype=torch.float32)))
    eligible = (cell_alive[..., None] & virus_alive[:, None, None, :]
                & can_eat & (rm * rm >= _dist2(cell_pos, virus_pos)))
    vslot = torch.arange(Nv, dtype=torch.int32, device=dev)
    big = torch.full((), _BIG_I, dtype=torch.int32, device=dev)
    pair_key = torch.where(eligible, rank[..., None] * Nv + vslot, big)
    best = pair_key.reshape(N, P, Cc * Nv).min(-1).values     # (N, P)
    hit = best < _BIG_I
    best_cell = pair_key.min(-1).values.argmin(-1).to(torch.int32)
    best_virus = torch.where(hit, best % Nv, 0).to(torch.int32)

    pid = torch.arange(P, dtype=torch.int32, device=dev)
    claim = hit[..., None] & (best_virus[..., None] == vslot)  # (N, P, Nv)
    claim_pid = torch.where(claim, pid[:, None], big)
    win_pid = claim_pid.min(1).values                          # (N, Nv)
    won = hit & (torch.gather(win_pid, 1, best_virus.long()) == pid)
    virus_removed = (claim & (claim_pid == win_pid[:, None, :])).any(1)
    gain = torch.where(won & can_eat_virus,
                       torch.gather(virus_mass, 1, best_virus.long()), 0)
    return dict(hit=won, cell_slot=best_cell, virus_slot=best_virus,
                mass_gain=gain.to(torch.int32),
                disrupt=won & ~can_eat_virus,
                virus_alive=virus_alive & ~virus_removed)


def cross_player_eat(cell_pos, cell_mass, cell_alive, rank):
    """players_collision (Engine.hpp:150-200) under SPEC M3.

    Cell i eats cell j of another player when both are alive, j's centre
    lies within the larger radius, mass_i > CELL_EAT_REQUIREMENT and
    f32(mass_i) > f32(mass_j) * 1.1. Contested prey goes to the lowest
    (pid, rank) eater; gains are the snapshot masses, summed in int32; an
    eaten cell still eats this tick (chains).

    Returns (gain_per_cell (N,P,Cc) i32, eaten (N,P,Cc) bool,
    eaten_count_per_player (N,P) i32, the cells_eaten credit)."""
    N, P, Cc = cell_mass.shape
    M = P * Cc
    pos = cell_pos.reshape(N, M, 2)
    mass = cell_mass.reshape(N, M)
    alive = cell_alive.reshape(N, M)
    key = order_key(rank).reshape(N, M)
    pid = torch.arange(M, device=cell_mass.device) // Cc

    rad = G.radius(mass)
    d = pos[:, None, :, :] - pos[:, :, None, :]                 # [i, j]
    dist2 = G.norm2(d[..., 0], d[..., 1])
    rm = torch.maximum(rad[:, :, None], rad[:, None, :])
    margin = float(torch.tensor(C.CELL_EAT_MARGIN, dtype=torch.float32))
    can_eat = ((mass[:, :, None] > C.CELL_EAT_REQUIREMENT)
               & (mass[:, :, None].to(torch.float32)
                  > mass[:, None, :].to(torch.float32) * margin))
    eligible = (alive[:, :, None] & alive[:, None, :]
                & (pid[:, None] != pid[None, :])
                & can_eat & (rm * rm >= dist2))
    big = torch.full((), _BIG_I, dtype=torch.int32, device=mass.device)
    eat_key = torch.where(eligible, key[:, :, None], big)       # [i, j]
    min_key = eat_key.min(1).values                             # per prey j
    eaten = min_key < _BIG_I
    winner = eligible & (eat_key == min_key[:, None, :])
    gain = torch.where(winner, mass[:, None, :], 0).sum(-1, dtype=torch.int32)
    count = winner.sum(-1, dtype=torch.int32)
    return (gain.reshape(N, P, Cc), eaten.reshape(N, P, Cc),
            count.reshape(N, P, Cc).sum(-1, dtype=torch.int32))


def move_foods_and_feed_viruses(food_pos, food_vel, food_alive, virus_pos,
                                virus_vel, virus_mass, virus_hits,
                                virus_alive, arena_w, arena_h, dt, dead_slot,
                                spawn_vel_scale=10.0):
    """move_foods + maybe_hit_virus (Engine.hpp:632-687) under SPEC M4.

    Moving foods decelerate, move, and each hits its lowest-slot colliding
    live virus and is consumed. A virus whose hits pass 7 resets and
    launches one new virus into `dead_slot` (N,) (-1 = none) along the
    lowest-index hitting food's pre-deceleration velocity; only the
    lowest-slot bursting virus spawns in a tick (documented deviation).
    """
    N, Nf = food_alive.shape
    Nv = virus_alive.shape[-1]
    dev = food_pos.device
    big = torch.full((), _BIG_I, dtype=torch.int32, device=dev)

    moving = food_alive & (G.vec_norm(food_vel) > 0.0)
    pre_vel = food_vel
    new_vel = G.decelerate(food_vel, C.FOOD_DECEL, dt)
    new_pos = G.fma32(new_vel, dt, food_pos)
    rad_f = G.radius(float(C.FOOD_MASS))
    new_pos = G.boundary_clamp(new_pos, rad_f, arena_w, arena_h)
    food_pos = torch.where(moving[..., None], new_pos, food_pos)
    food_vel = torch.where(moving[..., None], new_vel, food_vel)

    rad_v = G.radius(virus_mass)                               # (N, Nv)
    d = food_pos[:, :, None, :] - virus_pos[:, None, :, :]     # (N, Nf, Nv)
    dist2 = G.norm2(d[..., 0], d[..., 1])
    rm = torch.maximum(rad_f, rad_v)[:, None, :]
    collide = moving[..., None] & virus_alive[:, None, :] & (rm * rm >= dist2)
    vslot = torch.arange(Nv, dtype=torch.int32, device=dev)
    hit_virus = torch.where(collide, vslot, big).min(-1).values  # (N, Nf)
    food_hits = hit_virus < _BIG_I
    hit_matrix = food_hits[..., None] & (hit_virus[..., None] == vslot)
    hits_count = hit_matrix.sum(1, dtype=torch.int32)          # (N, Nv)

    new_hits = virus_hits + hits_count
    burst = virus_alive & (new_hits > C.NUMBER_OF_FOOD_HITS)
    post_hits = torch.clamp(new_hits - (C.NUMBER_OF_FOOD_HITS + 1), min=0)
    virus_hits = torch.where(burst, post_hits, new_hits)
    virus_mass = torch.where(burst, C.VIRUS_INITIAL_MASS
                             + post_hits * C.FOOD_MASS,
                             virus_mass + hits_count * C.FOOD_MASS)
    food_alive = food_alive & ~food_hits

    any_burst = burst.any(-1)                                  # (N,)
    burst_slot = burst.to(torch.int32).argmax(-1)              # first True
    fidx = torch.arange(Nf, dtype=torch.int32, device=dev)
    f_hit_b = food_hits & (hit_virus == burst_slot[:, None])
    src_food = torch.where(f_hit_b, fidx, big).min(-1).values
    src_food = torch.where(src_food < _BIG_I, src_food, 0).long()
    spawn_vel = torch.gather(pre_vel, 1,
                             src_food[:, None, None].expand(N, 1, 2))[:, 0]
    bpos = torch.gather(virus_pos, 1,
                        burst_slot.long()[:, None, None].expand(N, 1, 2))[:, 0]
    k = float(torch.tensor(dt, dtype=torch.float32)
              * torch.tensor(spawn_vel_scale, dtype=torch.float32))
    spawn_pos = bpos + spawn_vel * k
    rad_new = G.radius(float(C.VIRUS_INITIAL_MASS))
    spawn_pos = G.boundary_clamp(spawn_pos, rad_new, arena_w, arena_h)

    do_spawn = any_burst & (dead_slot >= 0)
    slot_oh = (torch.arange(Nv, device=dev) == dead_slot[:, None]) \
        & do_spawn[:, None]
    virus_pos = torch.where(slot_oh[..., None], spawn_pos[:, None, :],
                            virus_pos)
    virus_vel = torch.where(slot_oh[..., None], spawn_vel[:, None, :],
                            virus_vel)
    virus_mass = torch.where(slot_oh, C.VIRUS_INITIAL_MASS, virus_mass)
    virus_hits = torch.where(slot_oh, 0, virus_hits)
    virus_alive = virus_alive | slot_oh
    return (food_pos, food_vel, food_alive, virus_pos, virus_vel,
            virus_mass.to(torch.int32), virus_hits.to(torch.int32),
            virus_alive)

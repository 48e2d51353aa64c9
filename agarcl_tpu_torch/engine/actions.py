"""Player actions as masked tensor transforms (counterpart of
engine/actions.py): split / feed / auto-split / virus-pop creation,
recombining, mass decay and anti-team.

Reference semantics: emit_foods (Engine.hpp:1027-1054), player_split
(:1056-1107), may_be_auto_split (:592-601), disrupt (:1263-1294),
recombine_cells (:1160-1179), anti_team/mass_decay (:550-584). New cells
take the lowest free slots in creation order with fresh increasing ids
(SPEC M8). Cell tensors are (N, P, Cc[, 2]) in a dict with keys pos, vel,
split_vel, mass, alive, id, recombine_at.
"""

from __future__ import annotations

import numpy as np
import torch

from agarcl_tpu_torch import constants as C
from agarcl_tpu_torch.engine import geometry as G
from agarcl_tpu_torch.state import cell_rank_of

_BIG_I = 2**30
_EMPTY_TICK = -(2**30)


def _big(like):
    return torch.full((), _BIG_I, dtype=torch.int32, device=like.device)


def place_new_cells(cells, new, next_cell_id):
    """Insert candidate cells into free slots (SPEC M8).

    new: dict with mask (N,P,K) bool, order (N,P,K) i32 (creation order
    within the player), pos/vel/split_vel (N,P,K,2), mass and
    recombine_at (N,P,K). Candidates beyond the free-slot count are dropped
    in creation order. Returns (cells, next_cell_id (N,))."""
    alive = cells["alive"]
    free = ~alive
    num_free = free.sum(-1, keepdim=True, dtype=torch.int32)    # (N,P,1)
    free_rank = torch.cumsum(free.to(torch.int32), -1) - 1     # (N,P,Cc)

    order = torch.where(new["mask"], new["order"], _big(alive))
    valid = new["mask"] & (order < num_free)
    counts = valid.sum(-1, dtype=torch.int32)                  # (N,P)
    offsets = torch.cumsum(counts, -1) - counts                # exclusive
    ids = next_cell_id[:, None, None] + offsets[..., None] + order
    next_cell_id = next_cell_id + counts.sum(-1, dtype=torch.int32)

    onehot = (valid[..., :, None] & free[..., None, :]
              & (free_rank[..., None, :] == order[..., :, None]))  # (N,P,K,Cc)
    claimed = onehot.any(-2)                                   # (N,P,Cc)

    def write(old, vals):
        if vals.dim() == onehot.dim():                         # (N,P,K,2)
            w = torch.where(onehot[..., None], vals[..., :, None, :],
                            torch.zeros((), dtype=vals.dtype,
                                        device=vals.device)).sum(-3)
            return torch.where(claimed[..., None], w.to(old.dtype), old)
        w = torch.where(onehot, vals[..., :, None],
                        torch.zeros((), dtype=vals.dtype,
                                    device=vals.device)).sum(-2)
        return torch.where(claimed, w.to(old.dtype), old)

    out = dict(cells)
    out["pos"] = write(cells["pos"], new["pos"])
    out["vel"] = write(cells["vel"], new["vel"])
    out["split_vel"] = write(cells["split_vel"], new["split_vel"])
    out["mass"] = write(cells["mass"],
                        torch.clamp(new["mass"], min=C.CELL_MIN_SIZE))
    out["id"] = write(cells["id"], ids)
    out["recombine_at"] = write(cells["recombine_at"], new["recombine_at"])
    out["alive"] = alive | claimed
    return out, next_cell_id


def split_fields(pos, mass, target, elapsed, arena_w, arena_h):
    """cell_split (Engine.hpp:1067-1093): halve the mass first; the
    geometry uses the remaining radius; the new cell's velocity and
    splitting velocity are both dir * split_speed(split_mass).
    Returns (remaining_mass, new-cell fields)."""
    split_mass = mass // 2
    remaining = torch.clamp(mass - split_mass, min=C.CELL_MIN_SIZE)
    rad = G.radius(remaining)
    d = G.normed(target - pos)
    loc = G.fma32(d, rad[..., None], pos)
    loc = G.boundary_clamp(loc, rad, arena_w, arena_h)
    vel = d * G.split_speed(split_mass)[..., None]
    return remaining, dict(pos=loc, vel=vel, split_vel=vel, mass=split_mass,
                           recombine_at=elapsed + C.RECOMBINE_TICKS)


def selection_order(mask, rank):
    """order[c] = number of selected cells of the player with lower rank;
    _BIG_I where unselected."""
    sel = mask[..., :, None] & mask[..., None, :]
    lower = rank[..., None, :] < rank[..., :, None]
    cnt = (sel & lower).sum(-1, dtype=torch.int32)
    return torch.where(mask, cnt, _big(cnt))


def auto_split(cells, target, elapsed, n_cells_start, arena_w, arena_h):
    """may_be_auto_split: cells >= 22500 split toward the target when the
    player's tick-start cell count is below the limit, else clamp to
    22000. Returns (cells, new candidates, created count (N,P))."""
    alive = cells["alive"]
    over = alive & (cells["mass"] >= C.MAX_MASS_IN_THE_GAME)
    may = (n_cells_start < C.PLAYER_CELL_LIMIT)[..., None]
    do_split = over & may
    clamp = over & ~may
    tgt = target[..., None, :].expand_as(cells["pos"])
    el = elapsed[..., None].expand_as(cells["mass"])
    remaining, nf = split_fields(cells["pos"], cells["mass"], tgt, el,
                                 arena_w, arena_h)
    cells = dict(cells)
    cells["mass"] = torch.where(
        do_split, remaining,
        torch.where(clamp, C.NEW_MASS_IF_NO_SPLIT, cells["mass"])
    ).to(torch.int32)
    cells["recombine_at"] = torch.where(do_split, el + C.RECOMBINE_TICKS,
                                        cells["recombine_at"])
    order = selection_order(do_split, cell_rank_of(cells["id"], alive))
    new = dict(mask=do_split, order=order, **nf)
    return cells, new, do_split.sum(-1, dtype=torch.int32)


def player_split(cells, target, action, split_cooldown, elapsed,
                 create_limit, arena_w, arena_h):
    """maybe_split + player_split: on action==split with zero cooldown the
    first create_limit cells of mass >= 50 split in rank order; the
    cooldown resets to 30 even if nothing split (SPEC Q6/Q7).
    Returns (cells, new candidates, split_cooldown)."""
    split_cooldown = torch.clamp(split_cooldown - 1, min=0)
    do_act = (action == 2) & (split_cooldown == 0)
    limit = torch.clamp(create_limit, min=0)
    alive = cells["alive"]
    eligible = (alive & (cells["mass"] >= C.CELL_SPLIT_MINIMUM)
                & do_act[..., None])
    order = selection_order(eligible, cell_rank_of(cells["id"], alive))
    chosen = eligible & (order < limit[..., None])
    tgt = target[..., None, :].expand_as(cells["pos"])
    el = elapsed[..., None].expand_as(cells["mass"])
    remaining, nf = split_fields(cells["pos"], cells["mass"], tgt, el,
                                 arena_w, arena_h)
    cells = dict(cells)
    cells["mass"] = torch.where(chosen, remaining, cells["mass"])
    cells["recombine_at"] = torch.where(chosen, el + C.RECOMBINE_TICKS,
                                        cells["recombine_at"])
    new = dict(mask=chosen, order=order, **nf)
    split_cooldown = torch.where(do_act, C.SPLIT_COOLDOWN,
                                 split_cooldown).to(torch.int32)
    return cells, new, split_cooldown


def disrupt_candidates(cells, ev, virus_pos, n_cells_start, elapsed):
    """disrupt (Engine.hpp:1263-1294) as an (N,P,PLAYER_CELL_LIMIT)
    candidate table; applies the popping cell's mass cut in place. The
    splitting-velocity angle keeps the doubled-direction quirk (SPEC Q3).
    """
    N, P, Cc = cells["mass"].shape
    K = C.PLAYER_CELL_LIMIT
    dev = cells["mass"].device
    cslot = ev["cell_slot"].long()                              # (N,P)
    do = ev["disrupt"]
    total = torch.gather(cells["mass"], 2, cslot[..., None])[..., 0]
    cur = torch.clamp((total.to(torch.float32)
                       / C.CELL_POP_REDUCTION).to(torch.int32),
                      min=C.CELL_MIN_SIZE)
    cur = cur + torch.remainder(total - cur, C.CELL_POP_SIZE)
    pop_mass = total - cur
    num_new = torch.div(pop_mass + C.CELL_POP_SIZE - 1, C.CELL_POP_SIZE,
                        rounding_mode="floor")
    create_limit = torch.clamp(C.PLAYER_CELL_LIMIT - n_cells_start, min=0)
    num_new = torch.where(do, torch.minimum(num_new, create_limit), 0)

    hit_oh = do[..., None] & (torch.arange(Cc, device=dev) == cslot[..., None])
    cells = dict(cells)
    cells["mass"] = torch.where(hit_oh, cur[..., None], cells["mass"])
    cells["recombine_at"] = torch.where(
        hit_oh, (elapsed + C.RECOMBINE_TICKS)[..., None],
        cells["recombine_at"])

    cell_vel = torch.gather(cells["vel"], 2,
                            cslot[..., None, None].expand(N, P, 1, 2))[:, :, 0]
    theta = G.direction(cell_vel)                               # (N,P)
    k = torch.arange(K, dtype=torch.float32, device=dev)
    nn = torch.clamp(num_new, min=1).to(torch.float32)[..., None]
    two_pi = float(np.float32(2.0 * np.pi))
    ang = theta[..., None] + (theta[..., None] + two_pi * k / nn)
    pop_speed = G.max_speed(float(C.CELL_POP_SIZE))
    svel = torch.stack([G.cos32(ang), G.sin32(ang)], dim=-1) * pop_speed

    kk = torch.arange(K, dtype=torch.int32, device=dev)
    mass_k = torch.clamp(pop_mass[..., None] - C.CELL_POP_SIZE * kk,
                         max=C.CELL_POP_SIZE)
    mask = do[..., None] & (kk < num_new[..., None])
    vidx = ev["virus_slot"].long()
    vpos = torch.gather(virus_pos, 1, vidx[..., None].expand(N, P, 2))
    rec = (elapsed + C.RECOMBINE_TICKS)[..., None].expand(N, P, K)
    new = dict(
        mask=mask,
        order=torch.where(mask, kk, _big(kk)),
        pos=vpos[:, :, None, :].expand(N, P, K, 2),
        vel=cell_vel[:, :, None, :].expand(N, P, K, 2),
        split_vel=svel,
        mass=torch.clamp(mass_k, min=1),
        recombine_at=rec,
    )
    return cells, new, num_new.to(torch.int32)


def emit_foods(cells, target, action, feed_cooldown, food_pos, food_vel,
               food_alive, food_next, rank):
    """maybe_emit_food + emit_foods: each cell of mass >= 35 of a feeding
    player ejects one 10-mass food at its rim toward the target at speed
    100 and loses 10 mass; foods land in ring-buffer slots in (pid, rank)
    order (SPEC Q14)."""
    N, P, Cc = cells["mass"].shape
    Nf = food_alive.shape[-1]
    dev = food_pos.device
    feed_cooldown = torch.clamp(feed_cooldown - 1, min=0)
    do_act = (action == 1) & (feed_cooldown == 0)
    emit = (cells["alive"] & do_act[..., None]
            & (cells["mass"] >= C.CELL_MIN_SIZE + C.FOOD_MASS))
    d = G.normed(target[..., None, :] - cells["pos"])
    # the rim point fused, as XLA-CPU forms it inside the food fusion
    loc = G.fma32(d, G.radius(cells["mass"])[..., None], cells["pos"])
    vel = d * C.FOOD_SPEED

    key = (torch.arange(P, dtype=torch.int32, device=dev)[:, None] * Cc
           + rank).reshape(N, P * Cc)
    m = emit.reshape(N, P * Cc)
    cnt_before = (m[:, None, :] & (key[:, None, :] < key[:, :, None])).sum(
        -1, dtype=torch.int32)
    gorder = torch.where(m, cnt_before, _big(cnt_before))
    slot = torch.remainder(food_next[:, None] + gorder, Nf)

    oh = m[..., None] & (slot[..., None]
                         == torch.arange(Nf, dtype=torch.int32, device=dev))
    prio = torch.where(oh, gorder[..., None] + 1, 0)           # (N, PC, Nf)
    winner = prio.argmax(1)                                    # (N, Nf)
    written = oh.any(1)
    loc_f = loc.reshape(N, P * Cc, 2)
    vel_f = vel.reshape(N, P * Cc, 2)
    widx = winner[..., None].expand(N, Nf, 2)
    food_pos = torch.where(written[..., None], torch.gather(loc_f, 1, widx),
                           food_pos)
    food_vel = torch.where(written[..., None], torch.gather(vel_f, 1, widx),
                           food_vel)
    food_alive = food_alive | written
    food_next = food_next + m.sum(-1, dtype=torch.int32)
    cells = dict(cells)
    cells["mass"] = torch.where(emit, cells["mass"] - C.FOOD_MASS,
                                cells["mass"])
    feed_cooldown = torch.where(do_act, C.FEED_COOLDOWN,
                                feed_cooldown).to(torch.int32)
    return cells, food_pos, food_vel, food_alive, food_next, feed_cooldown


def recombine(cells, elapsed):
    """recombine_cells under SPEC M7: per player, repeatedly merge the
    lowest-(rank_i, rank_j) touching pair whose timers have both expired
    into the lower-rank cell, until none is left (at most Cc merges)."""
    N, P, Cc = cells["mass"].shape
    dev = cells["mass"].device
    mass, alive, recomb = cells["mass"], cells["alive"], cells["recombine_at"]
    pos = cells["pos"]
    d = pos[..., None, :, :] - pos[..., :, None, :]             # pos_j - pos_i
    dist2 = G.norm2(d[..., 0], d[..., 1])
    iota = torch.arange(Cc, device=dev)
    eps = float(np.float32(C.RECOMBINE_TOUCH_EPS))
    for _ in range(Cc):
        can = alive & (elapsed[..., None] >= recomb)
        rank = cell_rank_of(cells["id"], alive)
        rad = G.radius(mass)
        rsum_e = (rad[..., :, None] + rad[..., None, :]) + eps
        touch = rsum_e * rsum_e >= dist2
        lower = rank[..., :, None] < rank[..., None, :]
        elig = can[..., :, None] & can[..., None, :] & touch & lower
        if not bool(elig.any()):
            break
        key = torch.where(elig, rank[..., :, None] * Cc + rank[..., None, :],
                          _big(rank))
        flat = key.reshape(N, P, Cc * Cc)
        best, bidx = flat.min(-1)
        has = best < _BIG_I
        bi = torch.div(bidx, Cc, rounding_mode="floor")
        bj = bidx % Cc
        oh_i = has[..., None] & (iota == bi[..., None])
        oh_j = has[..., None] & (iota == bj[..., None])
        gain = torch.where(has, torch.gather(mass, 2, bj[..., None])[..., 0], 0)
        mass = torch.where(oh_i, mass + gain[..., None], mass)
        alive = alive & ~oh_j
    cells = dict(cells)
    cells["mass"], cells["alive"] = mass, alive
    return cells


def decay_and_anti_team(cells, elapsed, last_decay, anti_team, virus_ticks,
                        player_alive):
    """Every 60 player ticks: expire old virus-eat events, refresh
    anti_team = 1.1^(n-1) when n > 0 (a stale value persists when the
    window empties), then decay every cell by (1 - 0.002*anti_team),
    floored at 25 and truncated like the reference's uint cast."""
    due = player_alive & (torch.remainder(elapsed, 60) == 0)
    fall_off = elapsed[..., None] - C.ANTI_TEAM_ACTIVATION_TICKS
    expired = virus_ticks < fall_off
    virus_ticks = torch.where(due[..., None] & expired, _EMPTY_TICK,
                              virus_ticks).to(torch.int32)
    n = (virus_ticks != _EMPTY_TICK).sum(-1, dtype=torch.int32)
    base = torch.full_like(anti_team, float(np.float32(1.1)))
    anti_team = torch.where(due & (n > 0),
                            torch.pow(base.double(), (n - 1).double()).to(
                                torch.float32), anti_team)
    do_decay = due & (elapsed - last_decay >= C.DECAY_TICKS)
    rate = float(np.float32(C.PLAYER_DECAY_RATE))
    decayed = torch.clamp(
        (cells["mass"].to(torch.float32)
         * (1.0 - rate * anti_team[..., None])).to(torch.int32),
        min=C.CELL_MIN_SIZE)
    cells = dict(cells)
    cells["mass"] = torch.where(do_decay[..., None] & cells["alive"], decayed,
                                cells["mass"])
    last_decay = torch.where(do_decay, elapsed, last_decay)
    return cells, last_decay, anti_team, virus_ticks

"""Scripted-opponent policies (counterpart of engine/bots.py), batched
over N envs.

The four reference bots (bots/*.hpp) as masked selects over the (P players,
Np pellets) state, evaluated every BOT_ACTION_PERIOD ticks from the
start-of-tick snapshot (SPEC Q12). Bot types: 1 HungryBot (nearest
pellet), 2 HungryShyBot (flee any player within SHY_RADIUS, else forage;
SPEC Q1), 3 AggressiveBot (hunt the first player in pid order within
AGGRESSIVE_RADIUS with edible mass, else forage), 4 AggressiveShyBot
(flee, else hunt, else forage).

f32 forms follow XLA-CPU's jitted twin, read off its output on crafted
and random rosters: every norm is sqrt(fma(x, x, y*y)); the hunt target
`c + 3*(prey - c)` is fma(3, prey - c, c); the prey centroid's numerator
is a chain of fmas in slot order (state.weighted_sum), its total a plain
slot-order sum, as in the centroids the caller passes
(GameState.player_centroid). `2*c - c_j` is exact in any form.
"""

from __future__ import annotations

import torch

from agarcl_tpu_torch import constants as C
from agarcl_tpu_torch import prng
from agarcl_tpu_torch.engine import geometry as G
from agarcl_tpu_torch.state import slot_sum, weighted_sum

_BIG = 3.4e38
_BIG_I = 2**30


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    idx = torch.arange(mask.shape[-1], device=mask.device)
    first = torch.where(mask, idx, _BIG_I).min(-1).values
    return torch.where(first < _BIG_I, first, 0)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (N, M, ...) gathered at idx (N, P) along M -> (N, P, ...)."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, flat)


def bot_decide(bot_types, centroid, pmass, palive, cell_pos, cell_mass,
               cell_alive, pellet_pos, pellet_alive, arena_w, arena_h, seed,
               tick):
    """Returns (target (N,P,2) f32, action (N,P) i32, update (N,P) bool).

    bot_types: static (P,) ints (0 = RL agent, never updated). centroid
    (N,P,2), pmass and palive (N,P), cell tensors (N,P,Cc[,2]), pellets
    (N,Np[,2]), seed and tick (N,)."""
    N, P = pmass.shape
    dev = pmass.device
    bt = torch.as_tensor(bot_types, dtype=torch.int32, device=dev)
    pid = torch.arange(P, dtype=torch.int32, device=dev)

    # --- nearest pellet (Bot.hpp:92-129): dist > 0.01, else the fallbacks
    d_pel = G.vec_norm(centroid[:, :, None, :] - pellet_pos[:, None, :, :])
    ok = pellet_alive[:, None, :] & (d_pel > 0.01)
    d_masked = torch.where(ok, d_pel, torch.full_like(d_pel, _BIG))
    nearest = d_masked.argmin(-1)                               # first min
    has_pellet = ok.any(-1)
    any_pellet = pellet_alive.any(-1)[:, None]
    rx = prng.uniform_range(0.0, arena_w, seed[:, None], prng.STREAM_BOT,
                            tick[:, None], pid, 0)
    ry = prng.uniform_range(0.0, arena_h, seed[:, None], prng.STREAM_BOT,
                            tick[:, None], pid, 1)
    rand_loc = torch.stack([torch.floor(rx), torch.floor(ry)], dim=-1)
    pellet_target = torch.where(
        has_pellet[..., None], _take(pellet_pos, nearest),
        torch.where(any_pellet[..., None], torch.zeros_like(rand_loc),
                    rand_loc))

    # --- pairwise player geometry, dist[i, j] = |c_i - c_j| ---------------
    dist = G.vec_norm(centroid[:, :, None, :] - centroid[:, None, :, :])
    other = (pid[:, None] != pid[None, :]) & palive[:, None, :]

    # --- flee (HungryShyBot.hpp:24-49): the first player within SHY_RADIUS
    scary = other & (dist < C.SHY_RADIUS) & (pmass[:, None, :] > 0)
    flee_j = _first(scary)
    has_flee = scary.any(-1)
    flee_target = 2.0 * centroid - _take(centroid, flee_j)

    # --- hunt (AggressiveBot.hpp:27-55): the largest own cell; the first
    # player in pid order within AGGRESSIVE_RADIUS with edible mass -------
    lm = torch.where(cell_alive, cell_mass, -1)
    big_slot = lm.argmax(-1)                                    # first max
    big_mass = torch.gather(cell_mass, 2, big_slot[..., None])[..., 0]
    margin = float(torch.tensor(C.CELL_EAT_MARGIN, dtype=torch.float32))
    bm = big_mass[:, :, None, None]
    can = ((bm > C.CELL_EAT_REQUIREMENT)
           & (bm.to(torch.float32)
              > cell_mass[:, None].to(torch.float32) * margin)
           & cell_alive[:, None])                               # (N,P,P,Cc)
    edible = torch.where(can, cell_mass[:, None], 0).sum(-1)    # (N,P,P)
    near = other & (dist <= C.AGGRESSIVE_RADIUS) & (edible > 0)
    hunt_j = _first(near)
    has_hunt = near.any(-1)
    # target_player (Bot.hpp:56-67): mass-weighted centroid of edible cells
    can_h = torch.gather(can, 2, hunt_j[:, :, None, None].expand(
        N, P, 1, can.shape[-1]))[:, :, 0]                       # (N,P,Cc)
    w = torch.where(can_h, _take(cell_mass, hunt_j), 0).to(torch.float32)
    wsum = torch.clamp(slot_sum(w, -1), min=1.0)
    prey = weighted_sum(_take(cell_pos, hunt_j), w) / wsum[..., None]
    hunt_target = G.fma32(3.0, prey - centroid, centroid)

    use_hunt = (((bt == 3) | (bt == 4)) & has_hunt)[..., None]
    use_flee = (((bt == 2) | (bt == 4)) & has_flee)[..., None]
    target = torch.where(use_hunt, hunt_target, pellet_target)
    target = torch.where(use_flee, flee_target, target)
    update = (bt > 0) & palive
    return target, torch.zeros((N, P), dtype=torch.int32, device=dev), update

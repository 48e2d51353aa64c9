"""One engine tick on a batched GameState (counterpart of engine/tick.py).

Phase order follows Engine::tick + tick_player (Engine.hpp:208-240,
495-542) under the simultaneous, order-pinned schedule of SPEC.md:

  1  bot decisions (every BOT_ACTION_PERIOD ticks, start-of-tick snapshot)
  2  elapsed_ticks++ for live players
  3  movement + same-player collision relaxation
  4  virus events (eat / pop)
  5  pellet eating + stats
  6  auto-split; food eating
  7  feed emission
  8  player split
  9  place created cells (pop, auto-split, split order)
  10 recombine
  11 anti-team + mass decay
  13 food movement + virus feeding
  14 pellet/virus regeneration
  15 ticks++

Rosters of up to MAX_ROSTER players (agents plus scripted bots) tick,
the cap of the JAX package's fused path (agarcl_tpu/ops/fused_tick.py::
supports); larger ones raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from agarcl_tpu_torch import constants as C
from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.engine import actions as A
from agarcl_tpu_torch.engine import bots as B
from agarcl_tpu_torch.engine import eating as E
from agarcl_tpu_torch.engine import physics as PH
from agarcl_tpu_torch.engine import spawn as S
from agarcl_tpu_torch.state import GameState, cell_rank_of


MAX_ROSTER = 9     # players; the JAX package's fused-path cap


def check_supported(cfg: EnvConfig) -> None:
    """Raise for rosters above MAX_ROSTER players (agents plus bots)."""
    if cfg.num_players > MAX_ROSTER:
        raise NotImplementedError(
            f"the port ticks rosters of up to {MAX_ROSTER} players "
            f"(agents plus bots); this configuration has "
            f"{cfg.num_players}")


def engine_tick(cfg: EnvConfig, state: GameState) -> GameState:
    check_supported(cfg)
    W, H = cfg.arena_width, cfg.arena_height
    dt = float(np.float32(cfg.dt))
    dev = state.device
    palive = state.player_alive()
    pellet_pos, pellet_alive = state.pellet_xy_alive(cfg)
    P = state.cell_mass.shape[1]

    # --- 1. bots -----------------------------------------------------------
    target, action = state.target, state.action
    bot_types = cfg.bot_types()
    if any(bt > 0 for bt in bot_types):
        btgt, bact, bupd = B.bot_decide(
            bot_types, state.player_centroid(), state.player_mass(), palive,
            state.cell_pos, state.cell_mass, state.cell_alive, pellet_pos,
            pellet_alive, W, H, state.seed, state.ticks)
        do = (torch.remainder(state.ticks, C.BOT_ACTION_PERIOD)
              == 0)[:, None] & bupd
        target = torch.where(do[..., None], btgt, target)
        action = torch.where(do, bact, action)
    action_eff = torch.where(palive, action, 0)

    # --- 2. elapsed --------------------------------------------------------
    elapsed = state.elapsed_ticks + palive.to(torch.int32)

    # --- 3. movement -------------------------------------------------------
    pos, vel, svel = PH.move_cells(target, state.cell_pos,
                                   state.cell_split_vel, state.cell_mass,
                                   state.cell_alive, W, H, dt)
    rank = state.cell_rank()
    pos, vel = PH.self_collisions(pos, vel, svel, state.cell_mass,
                                  state.cell_alive, rank, target, W, H, dt)
    cells = dict(pos=pos, vel=vel, split_vel=svel, mass=state.cell_mass,
                 alive=state.cell_alive, id=state.cell_id,
                 recombine_at=state.cell_recombine_at)
    Cc = cells["mass"].shape[-1]

    # --- 4. virus events ---------------------------------------------------
    n_start = cells["alive"].sum(-1, dtype=torch.int32)
    can_eat_virus = n_start >= C.NUM_CELLS_TO_SPLIT          # SPEC Q2
    ev = E.virus_events(cells["pos"], cells["mass"], cells["alive"], rank,
                        state.virus_pos, state.virus_mass, state.virus_alive,
                        can_eat_virus)
    virus_alive = ev["virus_alive"]
    eat_oh = (ev["hit"] & ~ev["disrupt"])[..., None] & (
        torch.arange(Cc, device=dev) == ev["cell_slot"][..., None])
    cells["mass"] = cells["mass"] + torch.where(
        eat_oh, ev["mass_gain"][..., None], 0)
    viruses_eaten = state.viruses_eaten + ev["hit"].to(torch.int32)
    K = state.virus_eaten_ticks.shape[-1]
    push_slot = torch.remainder(state.virus_eaten_ptr, K)
    push_oh = ev["hit"][..., None] & (
        torch.arange(K, device=dev) == push_slot[..., None])
    virus_ticks = torch.where(push_oh, elapsed[..., None],
                              state.virus_eaten_ticks)
    virus_ptr = state.virus_eaten_ptr + ev["hit"].to(torch.int32)
    cells, new_disrupt, n_disrupt = A.disrupt_candidates(
        cells, ev, state.virus_pos, n_start, elapsed)

    # --- 5. pellets --------------------------------------------------------
    eaten_pc, pellet_alive = E.eat_pellets(cells["pos"], cells["mass"],
                                           cells["alive"], rank, pellet_pos,
                                           pellet_alive)
    pellet_key = torch.where(pellet_alive, state.pellet_key, -1).to(
        torch.int32)
    cells["mass"] = cells["mass"] + eaten_pc * C.PELLET_MASS
    food_eaten = state.food_eaten + eaten_pc.sum(-1, dtype=torch.int32)
    pmass_now = torch.where(cells["alive"], cells["mass"], 0).sum(
        -1, dtype=torch.int32)
    highest_mass = torch.maximum(state.highest_mass, pmass_now)

    # --- 6. auto-split + food eating --------------------------------------
    cells, new_auto, n_auto = A.auto_split(cells, target, elapsed, n_start,
                                           W, H)
    eaten_fc, food_alive = E.eat_foods(cells["pos"], cells["mass"],
                                       cells["alive"], rank, state.food_pos,
                                       state.food_alive)
    cells["mass"] = cells["mass"] + eaten_fc * C.FOOD_MASS
    food_eaten = food_eaten + eaten_fc.sum(-1, dtype=torch.int32)

    # --- 7. feed emission --------------------------------------------------
    (cells, food_pos, food_vel, food_alive, food_next,
     feed_cd) = A.emit_foods(cells, target, action_eff, state.feed_cooldown,
                             state.food_pos, state.food_vel, food_alive,
                             state.food_next, rank)
    feed_cd = torch.where(palive, feed_cd, state.feed_cooldown)

    # --- 8. split ----------------------------------------------------------
    create_limit2 = C.PLAYER_CELL_LIMIT - n_start - n_disrupt - n_auto
    cells, new_split, split_cd = A.player_split(
        cells, target, action_eff, state.split_cooldown, elapsed,
        create_limit2, W, H)
    split_cd = torch.where(palive, split_cd, state.split_cooldown)

    # --- 9. place created cells (SPEC M8 order) ----------------------------
    next_id = state.next_cell_id
    cells, next_id = A.place_new_cells(cells, new_disrupt, next_id)
    cells, next_id = A.place_new_cells(cells, new_auto, next_id)
    cells, next_id = A.place_new_cells(cells, new_split, next_id)

    # --- 10. recombine -----------------------------------------------------
    cells = A.recombine(cells, elapsed)

    # --- 11. anti-team + decay --------------------------------------------
    last_decay, anti_team = state.last_decay_tick, state.anti_team_decay
    if cfg.mode_spec.mass_decay:
        cells, last_decay, anti_team, virus_ticks = A.decay_and_anti_team(
            cells, elapsed, last_decay, anti_team, virus_ticks, palive)

    # --- 12. cross-player eating ------------------------------------------
    cells_eaten = state.cells_eaten
    if P > 1:
        rank2 = cell_rank_of(cells["id"], cells["alive"])
        gain, eaten, cnt = E.cross_player_eat(cells["pos"], cells["mass"],
                                              cells["alive"], rank2)
        cells["mass"] = cells["mass"] + gain
        cells["alive"] = cells["alive"] & ~eaten
        cells_eaten = cells_eaten + cnt

    # --- 13. foods move + virus feeding -----------------------------------
    any_dead_v = (~virus_alive).any(-1)
    dead_slot = torch.where(any_dead_v,
                            virus_alive.to(torch.int32).argmin(-1), -1)
    (food_pos, food_vel, food_alive, virus_pos, virus_vel, virus_mass,
     virus_hits, virus_alive) = E.move_foods_and_feed_viruses(
        food_pos, food_vel, food_alive, state.virus_pos, state.virus_vel,
        state.virus_mass, state.virus_hits, virus_alive, W, H, dt, dead_slot)

    # --- 14. regeneration --------------------------------------------------
    if cfg.mode_spec.pellet_regen:
        (pellet_key, virus_pos, virus_vel, virus_mass, virus_hits,
         virus_alive) = S.regen(cfg, pellet_key, virus_pos, virus_vel,
                                virus_mass, virus_hits, virus_alive,
                                state.seed, state.ticks)

    # --- 15. assemble ------------------------------------------------------
    keepc = cells["alive"]
    return state.replace(
        target=target, action=action,
        split_cooldown=split_cd, feed_cooldown=feed_cd,
        elapsed_ticks=elapsed, last_decay_tick=last_decay,
        anti_team_decay=anti_team, virus_eaten_ticks=virus_ticks,
        virus_eaten_ptr=virus_ptr, food_eaten=food_eaten,
        highest_mass=highest_mass, cells_eaten=cells_eaten,
        viruses_eaten=viruses_eaten,
        cell_pos=cells["pos"], cell_vel=cells["vel"],
        cell_split_vel=torch.where(keepc[..., None], cells["split_vel"], 0.0),
        cell_mass=torch.where(keepc, cells["mass"], 0).to(torch.int32),
        cell_alive=keepc, cell_id=cells["id"].to(torch.int32),
        cell_recombine_at=cells["recombine_at"].to(torch.int32),
        next_cell_id=next_id,
        pellet_key=pellet_key,
        virus_pos=virus_pos, virus_vel=virus_vel, virus_mass=virus_mass,
        virus_hits=virus_hits, virus_alive=virus_alive,
        food_pos=food_pos, food_vel=food_vel, food_alive=food_alive,
        food_next=food_next,
        ticks=state.ticks + 1,
    )

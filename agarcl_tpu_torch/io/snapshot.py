"""JSON environment snapshots in the reference's schema (counterpart of
io/snapshot.py).

Save mirrors BaseEnvironment::save_env_state (BaseEnvironment.hpp:213-318);
load mirrors Engine::load_env_state (Engine.hpp:247-348): players are
rebuilt by name ("HungryBot" etc. select the bot policy), ticks reset to
0, the RNG is re-seeded from the stored seed. As in the reference,
recombine timers and virus food-hit counters are not stored (the format is
lossy). The port's states are batched: `save_env_state` writes one env of
a batch, `load_env_state` returns a batch of one. A snapshot written by
either package loads in the other, field for field.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from agarcl_tpu_torch.bridge import state_from_numpy, state_to_numpy
from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.state import GameState, encode_pellet_key, zero_state

_BOT_NAMES = {0: None, 1: "HungryBot", 2: "HungryShyBot", 3: "AggressiveBot",
              4: "AggressiveShyBot"}
_NAME_TO_TYPE = {v: k for k, v in _BOT_NAMES.items() if v}


def save_env_state(cfg: EnvConfig, state: GameState, filename: str,
                   env: int = 0) -> None:
    """Write env `env` of a batched state as a reference JSON snapshot."""
    s = {f: a[env] for f, a in state_to_numpy(state).items()}
    pp, pa = state.pellet_xy_alive(cfg)
    pellet_pos = pp[env].detach().cpu().numpy()
    pellet_alive = pa[env].detach().cpu().numpy()
    bot_types = cfg.bot_types()
    players = []
    agent_idx = 0
    for p in range(cfg.num_players):
        bt = bot_types[p]
        if bt:
            name = _BOT_NAMES[bt]
        else:
            name = f"agent{agent_idx}"
            agent_idx += 1
        cells = []
        for c in range(cfg.max_cells):
            if not s["cell_alive"][p, c]:
                continue
            cells.append({
                "id": int(s["cell_id"][p, c]),
                "x": float(s["cell_pos"][p, c, 0]),
                "y": float(s["cell_pos"][p, c, 1]),
                "mass": int(s["cell_mass"][p, c]),
                "velocity_x": float(s["cell_vel"][p, c, 0]),
                "velocity_y": float(s["cell_vel"][p, c, 1]),
                "color": 0,
            })
        vticks = [int(t) for t in s["virus_eaten_ticks"][p] if t > -(2**29)]
        players.append({
            "pid": p,
            "name": name,
            "target_x": float(s["target"][p, 0]),
            "target_y": float(s["target"][p, 1]),
            "is_bot": bool(bt),
            "dead": not bool(s["cell_alive"][p].any()),
            "split_cooldown": int(s["split_cooldown"][p]),
            "feed_cooldown": int(s["feed_cooldown"][p]),
            "virus_eaten_ticks": sorted(vticks),
            "cells": cells,
            "anti_team_decay": float(s["anti_team_decay"][p]),
            "elapsed_ticks": int(s["elapsed_ticks"][p]),
            "last_decay_tick": int(s["last_decay_tick"][p]),
            "food_eaten": int(s["food_eaten"][p]),
            "highest_mass": int(s["highest_mass"][p]),
            "cells_eaten": int(s["cells_eaten"][p]),
            "viruses_eaten": int(s["viruses_eaten"][p]),
            "top_position": 0,
        })

    data = {
        "num_agents": cfg.num_agents,
        "ticks_per_step": cfg.ticks_per_step,
        "arena_size": cfg.arena_size,
        "num_bots": cfg.num_bots,
        "reward_type": cfg.reward_type,
        "seed": int(s["seed"]),
        "c_death": cfg.c_death,
        "mode_number": cfg.mode,
        "pellet_regen": cfg.pellet_regen,
        "pellet_count": int(pellet_alive.sum()),
        "players": players,
        # decoded coordinates (the reference schema; loading re-quantizes
        # them to the key grid, lossless for the package's own snapshots)
        "pellets": [{"x": float(pellet_pos[i, 0]),
                     "y": float(pellet_pos[i, 1])}
                    for i in range(pellet_alive.shape[0])
                    if pellet_alive[i]],
        "viruses": [{"x": float(s["virus_pos"][i, 0]),
                     "y": float(s["virus_pos"][i, 1]),
                     "velocity_x": float(s["virus_vel"][i, 0]),
                     "velocity_y": float(s["virus_vel"][i, 1]),
                     "mass": float(s["virus_mass"][i])}
                    for i in range(s["virus_alive"].shape[0])
                    if s["virus_alive"][i]],
        "foods": [{"x": float(s["food_pos"][i, 0]),
                   "y": float(s["food_pos"][i, 1]),
                   "velocity_x": float(s["food_vel"][i, 0]),
                   "velocity_y": float(s["food_vel"][i, 1])}
                  for i in range(s["food_alive"].shape[0])
                  if s["food_alive"][i]],
    }
    with open(filename, "w") as f:
        json.dump(data, f, indent=4)


def roster_from_snapshot(data: dict) -> tuple:
    """The per-player bot-type roster of a snapshot's player list, by the
    reference's name dispatch (Engine.hpp:274-284): "HungryBot" etc. select
    the bot class, any other name is an agent. A player flagged is_bot
    whose name matches no bot class is an error."""
    types = []
    for pdata in data["players"]:
        name = pdata.get("name", "")
        bt = _NAME_TO_TYPE.get(name, 0)
        if pdata.get("is_bot", bool(bt)) and not bt:
            raise ValueError(
                f"snapshot player {name!r} is flagged is_bot but matches no "
                f"known bot class (expected one of {sorted(_NAME_TO_TYPE)})")
        types.append(bt)
    return tuple(types)


def load_env_state(cfg: EnvConfig, filename: str, device=None) -> GameState:
    """A batch of one env rebuilt from a snapshot file on `device`. The
    file's roster must match cfg's slot for slot, and its mode cfg's mode;
    entities beyond cfg's capacities are dropped."""
    with open(filename) as f:
        data = json.load(f)

    file_roster = roster_from_snapshot(data)
    cfg_roster = cfg.bot_types()
    if file_roster != cfg_roster:
        names = {k: v or "agent" for k, v in _BOT_NAMES.items()}
        raise ValueError(
            "snapshot roster does not match the environment config: file has "
            f"{[names[t] for t in file_roster]}, config expects "
            f"{[names[t] for t in cfg_roster]} (num_agents={cfg.num_agents}, "
            f"mode={cfg.mode}, num_bots={cfg.num_bots})")
    if "mode_number" in data and int(data["mode_number"]) != cfg.mode:
        raise ValueError(
            f"snapshot mode_number={data['mode_number']} does not match the "
            f"environment config mode={cfg.mode} (the reference re-applies "
            "the file's mode on load, Engine.hpp:263)")

    s = {f: a[0].copy() for f, a in state_to_numpy(zero_state(cfg, 1)).items()}
    Cc = cfg.max_cells
    max_id = 0
    for p, pdata in enumerate(data["players"][:cfg.num_players]):
        s["target"][p] = (pdata["target_x"], pdata["target_y"])
        for k in ("split_cooldown", "feed_cooldown", "elapsed_ticks",
                  "last_decay_tick", "anti_team_decay", "food_eaten",
                  "cells_eaten", "viruses_eaten", "highest_mass"):
            s[k][p] = pdata[k]
        ts = pdata.get("virus_eaten_ticks", [])[-cfg.virus_ticks_capacity:]
        s["virus_eaten_ticks"][p, :len(ts)] = ts
        s["virus_eaten_ptr"][p] = len(ts)
        for c, cdata in enumerate(pdata["cells"][:Cc]):
            s["cell_pos"][p, c] = (cdata["x"], cdata["y"])
            s["cell_vel"][p, c] = (cdata["velocity_x"], cdata["velocity_y"])
            s["cell_mass"][p, c] = cdata["mass"]
            s["cell_alive"][p, c] = True
            s["cell_id"][p, c] = cdata["id"]
            max_id = max(max_id, int(cdata["id"]))

    Np = cfg.pellet_capacity
    ppos = np.zeros((Np, 2), np.float32)
    palive = np.zeros((Np,), bool)
    for i, pd in enumerate(data.get("pellets", [])[:Np]):
        ppos[i] = (pd["x"], pd["y"])
        palive[i] = True
    s["pellet_key"] = encode_pellet_key(
        cfg, torch.from_numpy(ppos), torch.from_numpy(palive)).numpy()

    for i, vd in enumerate(data.get("viruses", [])[:cfg.virus_capacity]):
        s["virus_pos"][i] = (vd["x"], vd["y"])
        s["virus_vel"][i] = (vd["velocity_x"], vd["velocity_y"])
        s["virus_mass"][i] = int(vd["mass"])
        s["virus_alive"][i] = True

    foods = data.get("foods", [])[:cfg.food_capacity]
    for i, fd in enumerate(foods):
        s["food_pos"][i] = (fd["x"], fd["y"])
        s["food_vel"][i] = (fd["velocity_x"], fd["velocity_y"])
        s["food_alive"][i] = True
    s["next_cell_id"] = np.int32(max_id + 1)
    s["food_next"] = np.int32(len(foods))
    s["ticks"] = np.int32(0)               # Engine.hpp:346: reset on load
    s["seed"] = np.uint32(data.get("seed", 0))
    return state_from_numpy({f: np.asarray(a)[None] for f, a in s.items()},
                            device)

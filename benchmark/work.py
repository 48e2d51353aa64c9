"""The least device time of a cell's kernel launches per call, from its
shapes alone (benchmark/roofline.py's counts), for the roofline readers.

A call of a "resident" traffic is one tick-kernel launch of k steps (with
its RAM frames, for RAM observations). A framed step (screen) with F
frames is the port's chain: one tick-kernel launch with the actions and
ticks_per_step - F + 1 ticks, then F - 1 one-tick launches, and a screen
frame after each (for F > ticks_per_step only ticks_per_step frames are
drawn). Each launch reads and writes the state once.
"""

from __future__ import annotations

from benchmark import driver, roofline
from benchmark.reference import layout
from benchmark.reference.config import EnvConfig
from benchmark.reference.obs.ram import RamObsConfig, ram_size
from benchmark.reference.state import zero_state


def _cfg(cell) -> EnvConfig:
    return EnvConfig(**driver.env_kwargs(cell.config))


def k1_per_call(cell, envs: int) -> float:
    """Least seconds of one call's tick-kernel launches."""
    cfg = _cfg(cell)
    common = dict(n=envs, state_bytes=layout.plane_bytes_per_env(
        zero_state(cfg, 1)), agents=cfg.num_agents, players=cfg.num_players,
        pellet_capacity=cfg.pellet_capacity)
    kind = cell.config["obs_type"]
    if kind == "screen":
        F = min(driver.frames_per_step(cell.config), cfg.ticks_per_step)
        steps = int(cell.traffic.get("k", 1))
        first = roofline.k1_call(k=1, n_ticks=cfg.ticks_per_step - F + 1,
                                 actions=True, **common)
        rest = roofline.k1_call(k=1, n_ticks=1, actions=False, **common)
        return steps * (roofline.bound_s(*first)
                        + (F - 1) * roofline.bound_s(*rest))
    R = ram_size(cfg, RamObsConfig(**driver.obs_kwargs(cell.config)))
    call = roofline.k1_call(k=int(cell.traffic.get("k", 1)),
                            n_ticks=cfg.ticks_per_step, actions=True,
                            ram_floats=R, live_pellets=cfg.num_pellets,
                            live_viruses=cfg.num_viruses, **common)
    return roofline.bound_s(*call)


def k3_per_call(cell, envs: int) -> float:
    """Least seconds of one call's screen-kernel launches."""
    cfg = _cfg(cell)
    c = cell.config
    F = min(driver.frames_per_step(c), cfg.ticks_per_step)
    frame = roofline.k3_call(
        n=envs, agents=cfg.num_agents, players=cfg.num_players,
        max_cells=cfg.max_cells, pellet_capacity=cfg.pellet_capacity,
        food_capacity=cfg.food_capacity, virus_capacity=cfg.virus_capacity,
        screen_len=c["screen_len"], channels=4 if c["agent_view"] else 3)
    return int(cell.traffic.get("k", 1)) * F * roofline.bound_s(*frame)

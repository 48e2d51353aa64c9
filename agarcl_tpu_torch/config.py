"""Typed, hashable environment configuration.

A copy of agarcl_tpu/config.py without its package import (which pulls in
JAX): one frozen dataclass replaces the reference's compile-time defines,
CMake options, gym kwargs and runtime mode switch
(Engine.hpp:367-416, AgarioEnv.py:298-363). tests/test_torch_config.py
checks every derived property against the JAX package for modes 0-10.
"""

from __future__ import annotations

import dataclasses

from agarcl_tpu_torch import constants as C


@dataclasses.dataclass(frozen=True)
class ModeSpec:
    """Per-mode rule flags (Engine.hpp:367-416 + BaseEnvironment mode logic)."""
    mass_decay: bool
    squared_pellets: bool
    pellet_regen: bool
    agent_mass: int
    # BaseEnvironment.hpp: mode 0 respawns everyone; modes 7-10 end on any death;
    # mode 3 ends at mass >= 23000. Modes 7-10 add one specific bot type.
    respawn_all: bool
    done_on_death: bool
    done_on_max_mass: bool
    forced_bot_type: int  # 0 = none; 1..4 = Hungry/HungryShy/Aggressive/AggressiveShy


def _mode_spec(mode: int) -> ModeSpec:
    base = dict(respawn_all=False, done_on_death=False, done_on_max_mass=False,
                forced_bot_type=0)
    if mode == 0:
        return ModeSpec(True, False, True, 25, True, False, False, 0)
    if mode == 1:
        return ModeSpec(False, True, False, 25, **base)
    if mode == 2:
        return ModeSpec(True, True, False, 25, **base)
    if mode == 3:
        return ModeSpec(False, False, True, 25, respawn_all=False,
                        done_on_death=False, done_on_max_mass=True,
                        forced_bot_type=0)
    if mode == 4:
        return ModeSpec(True, False, True, 25, **base)
    if mode == 5:  # mode 2 rules with heavy agent (Engine.hpp:399-401)
        return ModeSpec(True, True, False, 1000, **base)
    if mode == 6:  # mode 4 rules with heavy agent (Engine.hpp:403-405)
        return ModeSpec(True, False, True, 1000, **base)
    if mode in (7, 8, 9, 10):  # mode 4 rules + duel vs one bot type
        return ModeSpec(True, False, True, 25, respawn_all=False,
                        done_on_death=True, done_on_max_mass=False,
                        forced_bot_type=mode - 7 + 1)
    raise ValueError(f"Invalid mode number {mode}")


def squared_pellet_count(arena_width: float, arena_height: float) -> int:
    """Number of pellets the squared layout produces (Engine.hpp:426-475)."""
    square_size = min(arena_width, arena_height) / 2
    points_per_side = int(square_size / 1.0)
    return 4 * points_per_side


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration.

    Mirrors BaseEnvironment's constructor arguments
    (BaseEnvironment.hpp:39-66) plus the
    pinned fixed capacities from SPEC.md.
    """
    num_agents: int = 1
    ticks_per_step: int = 4
    arena_size: int = C.DEFAULT_ARENA_WIDTH
    pellet_regen: bool = True
    num_pellets: int = C.DEFAULT_NUM_PELLETS
    num_viruses: int = C.DEFAULT_NUM_VIRUSES
    num_bots: int = 0
    reward_type: bool = True      # True: delta-mass reward; False: absolute mass
    c_death: int = 0
    mode: int = 0
    dt: float = C.DEFAULT_DT

    # pinned capacities (SPEC.md)
    max_cells: int = C.MAX_CELLS_PER_PLAYER
    food_capacity: int = C.FOOD_CAPACITY
    virus_ticks_capacity: int = C.VIRUS_TICKS_CAPACITY

    @property
    def arena_width(self) -> float:
        return float(self.arena_size)

    @property
    def arena_height(self) -> float:
        return float(self.arena_size)

    @property
    def mode_spec(self) -> ModeSpec:
        return _mode_spec(self.mode)

    @property
    def total_bots(self) -> int:
        # Bots join only in mode 0 (num_bots of them) or modes 7-10 (exactly one
        # of the forced type); modes 1-6 ignore num_bots
        # (BaseEnvironment.hpp:194-197).
        if self.mode == 0:
            return self.num_bots
        if self.mode_spec.forced_bot_type:
            return 1
        return 0

    @property
    def num_players(self) -> int:
        return self.num_agents + self.total_bots

    @property
    def pellet_capacity(self) -> int:
        cap = self.num_pellets
        if self.mode_spec.squared_pellets:
            cap = max(cap, squared_pellet_count(self.arena_width, self.arena_height))
        return max(cap, 1)

    @property
    def virus_capacity(self) -> int:
        return max(self.num_viruses + C.VIRUS_HEADROOM, 1)

    def bot_types(self) -> tuple:
        """Static per-player bot type: 0 for agents, 1..4 for bots.

        Mode 0 roster follows BaseEnvironment.hpp:381-397 (`switch(i % num_bots)`:
        the first four bots get the four types, the rest default to HungryBot —
        SPEC Q5). Modes 7-10 add exactly one bot of the forced type
        (BaseEnvironment.hpp:401-425).
        """
        types = [0] * self.num_agents
        if self.mode_spec.forced_bot_type:
            types.append(self.mode_spec.forced_bot_type)
        elif self.mode == 0:
            for i in range(self.num_bots):
                types.append(i + 1 if i < 4 else 1)
        return tuple(types)

"""Peaks of the card and the least work of each kernel's call, counted from
a cell's shapes: each input byte read once and each output byte written
once, whatever a kernel reads again, and the f32 operations the function
needs at the least (the arithmetic of the port's chip_smoke.py, copied).

Shares of a roofline use `bound_s` (the larger of bytes over the HBM rate
and operations over the f32 rate) divided by the measured time.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, at its 700 W limit
F32_OPS_PER_S = 67e12       # f32 outside the tensor cores


def bound_s(nbytes: float, ops: float) -> float:
    """Least seconds the card could take for this work."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def k1_call(*, n: int, k: int, n_ticks: int, state_bytes: int, agents: int,
            players: int, pellet_capacity: int, actions: bool,
            ram_floats: int = 0, live_pellets: int = 0,
            live_viruses: int = 0):
    """(bytes, ops) of one tick-kernel call of k steps of n_ticks ticks on
    n envs: every state byte read and written once, the actions read
    (12 bytes an agent), per step the RAM frames (ram_floats f32 an agent,
    0 for none) and the (mass, alive) rows (8 bytes a player) written.
    Operations: the pellet-eat distance tests of one cell per player and
    tick (6 each), and per RAM frame one key evaluation (8 operations) per
    live pellet and virus of each agent."""
    per_env = 2 * state_bytes + (12 * agents if actions else 0)
    per_env += k * (4 * agents * ram_floats + 8 * players)
    per_step = n_ticks * pellet_capacity * 6 * players
    if ram_floats:
        per_step += 8 * agents * (live_pellets + live_viruses)
    return float(n * per_env), float(n * k * per_step)


def k3_call(*, n: int, agents: int, players: int, max_cells: int,
            pellet_capacity: int, food_capacity: int, virus_capacity: int,
            screen_len: int, channels: int):
    """(bytes, ops) of one screen-kernel call on n envs: the cell (13 bytes
    a slot: position, mass, alive, id, recombine), pellet (4), food (9)
    and virus (13) columns read once, one S x S x C uint8 frame per agent
    written once; per frame 22 operations per pixel row or column (the
    pixel-centre tables and grid flags) and one per pixel (the grid). The
    per-entity pixel tests depend on the state and are left out, so the
    operations are a lower bound."""
    read = (players * max_cells * 13 + 4 * pellet_capacity
            + 9 * food_capacity + 13 * virus_capacity)
    S = screen_len
    nbytes = n * (read + agents * S * S * channels)
    ops = n * agents * (22 * S + S * S)
    return float(nbytes), float(ops)

"""Fixed-capacity struct-of-arrays game state, batch-first.

The counterpart of agarcl_tpu/state.py. Field names and per-env shapes
match it field for field; every tensor here carries a leading env axis N
(the JAX package vmaps an unbatched state instead). Dtypes match too, with
one exception: `seed` is int64 holding the uint32 value in [0, 2^32),
because torch has no usable uint32 arithmetic on the CPU.

Pellets are one int32 key per slot, [qx:15][qy:15] on a 32768 x 32768
arena-normalized grid, dead = -1 (SPEC "Pellet position quantization").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from agarcl_tpu_torch import constants as C
from agarcl_tpu_torch.config import EnvConfig

PELLET_QBITS = 15
PELLET_Q = 1 << PELLET_QBITS           # 32768
DEAD_PELLET_KEY = -1
_BIG_I = 2**30


def pellet_scales(cfg: EnvConfig):
    """(scale_x, scale_y, inv_x, inv_y) f32 constants for encode/decode."""
    return (np.float32(PELLET_Q / cfg.arena_width),
            np.float32(PELLET_Q / cfg.arena_height),
            np.float32(cfg.arena_width / PELLET_Q),
            np.float32(cfg.arena_height / PELLET_Q))


def encode_pellet_key(cfg: EnvConfig, pos: torch.Tensor,
                      alive: torch.Tensor) -> torch.Tensor:
    """(..., 2) f32 positions + (...,) alive -> (...,) i32 keys."""
    sx, sy, _, _ = pellet_scales(cfg)
    qmax = PELLET_Q - 1
    qx = torch.clamp(torch.floor(pos[..., 0] * float(sx)).to(torch.int32),
                     0, qmax)
    qy = torch.clamp(torch.floor(pos[..., 1] * float(sy)).to(torch.int32),
                     0, qmax)
    key = (qx << PELLET_QBITS) | qy
    return torch.where(alive, key, torch.full_like(key, DEAD_PELLET_KEY))


def decode_pellet_xy(cfg: EnvConfig, key: torch.Tensor):
    """(...,) i32 keys -> ((..., 2) f32 positions, (...,) bool alive).

    Dead slots decode to the position of key 0; mask by the alive flag."""
    _, _, ix, iy = pellet_scales(cfg)
    qmask = PELLET_Q - 1
    qx = (key >> PELLET_QBITS) & qmask
    qy = key & qmask
    x = (qx.to(torch.float32) + 0.5) * float(ix)
    y = (qy.to(torch.float32) + 0.5) * float(iy)
    return torch.stack([x, y], dim=-1), key >= 0


def slot_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum along `dim` in slot order, one add at a time.

    f32 sums are pinned to this order in the plain engine and in the CUDA
    kernels alike (torch.sum picks its own order)."""
    x = x.movedim(dim, 0)
    acc = x[0].clone()
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def cell_rank_of(cell_id: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """(..., Cc) i32 rank of each live cell among its player's cells by id
    (the pinned "vector order", SPEC M1-M8); dead cells rank after all
    live ones."""
    key = torch.where(alive, cell_id, torch.full_like(cell_id, _BIG_I))
    lower = key[..., :, None] > key[..., None, :]
    return lower.sum(-1).to(torch.int32)


@dataclasses.dataclass
class GameState:
    """Batched game state; see agarcl_tpu/state.py for each field's
    meaning. Shapes are (N, ...) with P players, Cc cell slots, K virus-tick
    slots, Np pellets, Nv viruses, Nf foods and A agents."""
    # --- players (slot index is the pid: SPEC D1) ---
    target: torch.Tensor          # (N, P, 2) f32
    action: torch.Tensor          # (N, P) i32 — {0 none, 1 feed, 2 split}
    split_cooldown: torch.Tensor  # (N, P) i32
    feed_cooldown: torch.Tensor   # (N, P) i32
    elapsed_ticks: torch.Tensor   # (N, P) i32
    last_decay_tick: torch.Tensor  # (N, P) i32
    anti_team_decay: torch.Tensor  # (N, P) f32
    virus_eaten_ticks: torch.Tensor  # (N, P, K) i32 — -2**30 = empty
    virus_eaten_ptr: torch.Tensor    # (N, P) i32
    food_eaten: torch.Tensor      # (N, P) i32
    highest_mass: torch.Tensor    # (N, P) i32
    cells_eaten: torch.Tensor     # (N, P) i32
    viruses_eaten: torch.Tensor   # (N, P) i32

    # --- cells ---
    cell_pos: torch.Tensor        # (N, P, Cc, 2) f32
    cell_vel: torch.Tensor        # (N, P, Cc, 2) f32
    cell_split_vel: torch.Tensor  # (N, P, Cc, 2) f32
    cell_mass: torch.Tensor       # (N, P, Cc) i32
    cell_alive: torch.Tensor      # (N, P, Cc) bool
    cell_id: torch.Tensor         # (N, P, Cc) i32
    cell_recombine_at: torch.Tensor  # (N, P, Cc) i32
    next_cell_id: torch.Tensor    # (N,) i32

    # --- pellets ---
    pellet_key: torch.Tensor      # (N, Np) i32

    # --- viruses ---
    virus_pos: torch.Tensor       # (N, Nv, 2) f32
    virus_vel: torch.Tensor       # (N, Nv, 2) f32
    virus_mass: torch.Tensor      # (N, Nv) i32
    virus_hits: torch.Tensor      # (N, Nv) i32
    virus_alive: torch.Tensor     # (N, Nv) bool

    # --- foods ---
    food_pos: torch.Tensor        # (N, Nf, 2) f32
    food_vel: torch.Tensor        # (N, Nf, 2) f32
    food_alive: torch.Tensor      # (N, Nf) bool
    food_next: torch.Tensor       # (N,) i32

    # --- globals ---
    ticks: torch.Tensor           # (N,) i32
    seed: torch.Tensor            # (N,) i64 holding a uint32
    dones: torch.Tensor           # (N, A) bool
    main_respawned: torch.Tensor  # (N,) bool

    def replace(self, **kw) -> "GameState":
        return dataclasses.replace(self, **kw)

    @property
    def num_envs(self) -> int:
        return self.ticks.shape[0]

    @property
    def device(self) -> torch.device:
        return self.ticks.device

    def player_mass(self) -> torch.Tensor:
        """(N, P) i32 total mass per player (Player.hpp:121-126)."""
        return torch.where(self.cell_alive, self.cell_mass, 0).sum(
            -1, dtype=torch.int32)

    def player_alive(self) -> torch.Tensor:
        """(N, P) bool — a player is dead when it has no cells."""
        return self.cell_alive.any(-1)

    def player_centroid(self) -> torch.Tensor:
        """(N, P, 2) f32 mass-weighted centroid in XLA-CPU's form
        (`xla_centroid_of`); dead players get (0, 0)."""
        return xla_centroid_of(self.cell_pos, self.cell_mass,
                               self.cell_alive)

    def cell_rank(self) -> torch.Tensor:
        """(N, P, Cc) i32 rank of each live cell by id."""
        return cell_rank_of(self.cell_id, self.cell_alive)

    def pellet_xy_alive(self, cfg: EnvConfig):
        """Decoded ((N, Np, 2) f32, (N, Np) bool) pellet view."""
        return decode_pellet_xy(cfg, self.pellet_key)

    @property
    def pellet_alive(self) -> torch.Tensor:
        return self.pellet_key >= 0


def centroid_of(pos, mass, alive):
    """(..., Cc, 2), (..., Cc), (..., Cc) -> (..., 2) centroid (slot-order
    f32 sums of rounded products; total clamped at 1 so dead players land
    on (0, 0)): the screen and grid cameras' form, as the Pallas kernels'
    section emission forms them."""
    w = torch.where(alive, mass, 0).to(torch.float32)
    total = slot_sum(w, -1)
    num = slot_sum(pos * w[..., None], -2)
    return num / torch.clamp(total, min=1.0)[..., None]


def weighted_sum(x, w, dim: int = -2):
    """sum_i x_i * w_i over slots in slot order as XLA-CPU forms a
    reduction of products: the first product rounded, then one fma per
    slot (fma32 in geometry.py's sense). x (..., Cc, 2), w (..., Cc)."""
    x = x.movedim(dim, 0)
    w = w.movedim(-1, 0)[..., None]
    acc = x[0] * w[0]
    for i in range(1, x.shape[0]):
        acc = (x[i].double() * w[i].double() + acc.double()).to(
            torch.float32)
    return acc


def xla_centroid_of(pos, mass, alive):
    """The centroid in XLA-CPU's form (agarcl_tpu/state.py under jit):
    the mass total in slot order, the numerator as `weighted_sum`; dead
    players land on (0, 0). Actions, bots and the RAM frame use it."""
    w = torch.where(alive, mass, 0).to(torch.float32)
    return weighted_sum(pos, w) / torch.clamp(slot_sum(w, -1),
                                               min=1.0)[..., None]


def frame_centroid(pos, mass, alive, agents: int):
    """The centroid of a screen or grid frame's camera: the slot-order form
    (`centroid_of`) with one agent, as the tick's section emission forms
    it; XLA's fma chain (`xla_centroid_of`) with more, as the JAX table
    build for A > 1 takes it from player_centroid(). csrc/common.cuh
    frame_camera is the kernels' copy."""
    return (xla_centroid_of if agents > 1 else centroid_of)(pos, mass, alive)


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(GameState))


def zero_state(cfg: EnvConfig, num_envs: int, device=None) -> GameState:
    """All-empty batched state with the static shapes of cfg."""
    N = num_envs
    P = cfg.num_players
    Cc = cfg.max_cells
    Np = cfg.pellet_capacity
    Nv = cfg.virus_capacity
    Nf = cfg.food_capacity
    K = cfg.virus_ticks_capacity
    f32, i32, b = torch.float32, torch.int32, torch.bool

    def z(shape, dtype, fill=0):
        return torch.full((N,) + shape, fill, dtype=dtype, device=device)

    return GameState(
        target=z((P, 2), f32),
        action=z((P,), i32),
        split_cooldown=z((P,), i32),
        feed_cooldown=z((P,), i32),
        elapsed_ticks=z((P,), i32),
        last_decay_tick=z((P,), i32),
        anti_team_decay=z((P,), f32, 1.0),
        virus_eaten_ticks=z((P, K), i32, -(2**30)),
        virus_eaten_ptr=z((P,), i32),
        food_eaten=z((P,), i32),
        highest_mass=z((P,), i32, C.CELL_MIN_SIZE),
        cells_eaten=z((P,), i32),
        viruses_eaten=z((P,), i32),
        cell_pos=z((P, Cc, 2), f32),
        cell_vel=z((P, Cc, 2), f32),
        cell_split_vel=z((P, Cc, 2), f32),
        cell_mass=z((P, Cc), i32),
        cell_alive=z((P, Cc), b, False),
        cell_id=z((P, Cc), i32),
        cell_recombine_at=z((P, Cc), i32),
        next_cell_id=z((), i32),
        pellet_key=z((Np,), i32, DEAD_PELLET_KEY),
        virus_pos=z((Nv, 2), f32),
        virus_vel=z((Nv, 2), f32),
        virus_mass=z((Nv,), i32, C.VIRUS_INITIAL_MASS),
        virus_hits=z((Nv,), i32),
        virus_alive=z((Nv,), b, False),
        food_pos=z((Nf, 2), f32),
        food_vel=z((Nf, 2), f32),
        food_alive=z((Nf,), b, False),
        food_next=z((), i32),
        ticks=z((), i32),
        seed=z((), torch.int64),
        dones=z((cfg.num_agents,), b, False),
        main_respawned=z((), b, False),
    )

"""Grid observations: ego-centric multi-channel integer grids (counterpart
of obs/grid.py).

Per frame and agent, the 8 channels of the JAX package's grid kernel
(agarcl_tpu/ops/fused_grid.py), in this order:

  0 out-of-bounds (0 / -1)      4 virus total mass
  1 pellet presence (0 / 1)     5 own cells' total mass
  2 pellet count                6 other players' cells, min mass
  3 virus max mass              7 other players' cells, max mass

An `observe_*` flag set to False drops its channels; the rest keep this
order ([0] + [1, 2] + [3, 4] + [5] + [6, 7]). Channels with no entity in a
bin hold 0, and worlds of one player have zeros in channels 6-7.

Bins. An entity at x lands in row bin trunc(G*(x - cx)/view + G/2) and
column bin trunc(G*(y - cy)/view + G/2), f32 with a true division, where
(cx, cy) is the agent's centroid (slot-order products with one agent,
XLA's fma chain with more: `camera`) and view = clamp(2*mass, 100, 300);
trunc is the C int cast, so (-1, 0) falls in bin 0. Frame pixel [r, c] is
row bin r, column bin c. The out-of-bounds channel tests the
world coordinates cx + (i - G/2)*view/G of row i and cy + (j - G/2)*view/G
of column j against [0, W) x [0, H) in XLA-CPU's form of that expression,
read off its output with cameras a few ulps from the arena edge:
fma((i - G/2)*view, f32(1/G), cx). For G a power of two the quotient is
exact and every form agrees; for other G the form as written misses bins.

The plain rasterizer works on per-frame entity tables (`grid_tables`, the
sections of the JAX kernel: dead pellets, viruses and other players' cells
parked at 1e9, own cells in every slot with weight 0 when dead), so the
GameState path here and the kernel-plane path (ops/fused_grid.py) share it.
Narrow dtypes saturate (clip, then cast), never wrap.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.engine.geometry import fma32
from agarcl_tpu_torch.state import GameState, frame_centroid

PARK = 1e9                 # coordinate of a dead lane: out of every grid
INF = 2**30                # min-channel weight of a dead lane
_DTYPES = dict(int32=torch.int32, int16=torch.int16, int8=torch.int8)


@dataclasses.dataclass(frozen=True)
class GridObsConfig:
    num_frames: int = 1
    grid_size: int = 128
    observe_cells: bool = True
    observe_others: bool = True
    observe_viruses: bool = True
    observe_pellets: bool = True
    out_dtype: str = "int16"

    @property
    def channels_per_frame(self) -> int:
        return int(1 + self.observe_cells + 2 * self.observe_others
                   + 2 * self.observe_viruses + 2 * self.observe_pellets)

    @property
    def torch_dtype(self) -> torch.dtype:
        if self.out_dtype not in _DTYPES:
            raise ValueError(f"out_dtype must be one of {sorted(_DTYPES)}, "
                             f"got {self.out_dtype!r}")
        return _DTYPES[self.out_dtype]


def channel_index(ocfg: GridObsConfig) -> list:
    """Indices of the selected channels among the 8."""
    idx = [0]
    if ocfg.observe_pellets:
        idx += [1, 2]
    if ocfg.observe_viruses:
        idx += [3, 4]
    if ocfg.observe_cells:
        idx += [5]
    if ocfg.observe_others:
        idx += [6, 7]
    return idx


def grid_tables(cam, pellet_pos, pellet_alive, virus_pos, virus_mass,
                virus_alive, cell_pos, cell_mass, cell_alive, agent: int):
    """Entity tables of one agent's frames: {name: (N, width) f32}.

    cam (N, 3) = (cx, cy, view); pellet_pos (N, Np, 2), virus_* (N, Nv),
    cell_* (N, P, Cc). params = (cx, cy, view, 0, 0, 0, 0, 0); pellets and
    viruses parked at 1e9 when dead (vm = mass or 0); own cells (player
    `agent`) in every slot, mm = mass or 0; others (every other player)
    parked when dead, om = mass or 0, ok = mass or 2^30 (the min weight).
    With one player the other-cell tables are 8 zero lanes, as in the JAX
    package (its kernel skips them)."""
    f32 = torch.float32
    N = cam.shape[0]
    P = cell_mass.shape[1]
    park = torch.tensor(PARK, dtype=f32, device=cam.device)
    zero8 = torch.zeros((N, 8), dtype=f32, device=cam.device)

    def parked(pos, alive):
        return (torch.where(alive, pos[..., 0], park),
                torch.where(alive, pos[..., 1], park))

    px, py = parked(pellet_pos, pellet_alive)
    vx, vy = parked(virus_pos, virus_alive)
    own_m = cell_mass[:, agent].to(f32)
    t = dict(params=torch.cat([cam.to(f32), zero8[:, :5]], 1),
             px=px, py=py, vx=vx, vy=vy,
             vm=torch.where(virus_alive, virus_mass.to(f32), 0.0),
             mx=cell_pos[:, agent, :, 0], my=cell_pos[:, agent, :, 1],
             mm=torch.where(cell_alive[:, agent], own_m, 0.0))
    others = [p for p in range(P) if p != agent]
    if others:
        opos = cell_pos[:, others].reshape(N, -1, 2)
        oalive = cell_alive[:, others].reshape(N, -1)
        om = cell_mass[:, others].reshape(N, -1).to(f32)
        t["ox"], t["oy"] = parked(opos, oalive)
        t["om"] = torch.where(oalive, om, 0.0)
        t["ok"] = torch.where(oalive, om, float(INF))
    else:
        t.update(ox=zero8, oy=zero8, om=zero8, ok=zero8)
    return {k: v.to(f32).contiguous() for k, v in t.items()}


def camera(pos, mass, alive, agents: int = 1) -> torch.Tensor:
    """(N, 3) (cx, cy, view) of players (N, Cc, ...): the centroid
    (state.frame_centroid) and view = clamp(2*mass, 100, 300)."""
    cen = frame_centroid(pos, mass, alive, agents)
    pmass = torch.where(alive, mass, 0).sum(-1, dtype=torch.int32)
    view = torch.clamp(2.0 * pmass.to(torch.float32), 100.0, 300.0)
    return torch.cat([cen, view[:, None]], 1)


def _bins(G: int, x, y, cam) -> torch.Tensor:
    """(M, E) int64 flat bin r*G + c of entities, or -1 off the grid."""
    cx, cy, view = cam[:, 0:1], cam[:, 1:2], cam[:, 2:3]
    half = float(G) / 2.0
    bx = torch.trunc(float(G) * (x - cx) / view + half)
    by = torch.trunc(float(G) * (y - cy) / view + half)
    ok = (bx >= 0) & (bx < G) & (by >= 0) & (by < G)
    flat = torch.where(ok, bx * G + by, -1.0)
    return flat.to(torch.int64)


def in_bounds(cfg: EnvConfig, G: int, cam) -> torch.Tensor:
    """(M, G, G) bool: the bin's world coordinate lies inside the arena.
    The coordinate is fma(t*view, f32(1/G), c) with t = i - G/2: XLA turns
    the division by G into a product with the f32 reciprocal and fuses it
    with the add (t*view is exact: view is an even integer)."""
    t = torch.arange(G, dtype=torch.float32, device=cam.device)
    tv = (t - float(G) / 2.0) * cam[:, 2:3]
    rg = float(np.float32(1.0 / G))
    wx = fma32(tv, rg, cam[:, 0:1])
    wy = fma32(tv, rg, cam[:, 1:2])
    in_x = (wx >= 0) & (wx < cfg.arena_width)
    in_y = (wy >= 0) & (wy < cfg.arena_height)
    return in_x[:, :, None] & in_y[:, None, :]


def _scatter(M: int, G: int, flat, val, reduce: str, init: int):
    """(M, G*G) int32 reduction of val (M, E) into the bins flat (M, E)."""
    dev = flat.device
    n = M * G * G
    rows = torch.arange(M, device=dev)[:, None] * (G * G)
    idx = torch.where(flat >= 0, rows + flat, n).reshape(-1)
    acc = torch.full((n + 1,), init, dtype=torch.int32, device=dev)
    v = val.to(torch.int32).expand_as(flat).reshape(-1)
    if reduce == "sum":
        acc.index_add_(0, idx, v)
    else:
        acc.scatter_reduce_(0, idx, v, reduce, include_self=True)
    return acc[:n].reshape(M, G * G)


def rasterize(cfg: EnvConfig, G: int, t: dict) -> torch.Tensor:
    """(M, 8, G, G) int32 channels of entity tables (`grid_tables` layout,
    any padding); the other-player channels are 0 for one-player
    configurations."""
    cam = t["params"][:, :3]
    M = cam.shape[0]
    pb = _bins(G, t["px"], t["py"], cam)
    vb = _bins(G, t["vx"], t["vy"], cam)
    mb = _bins(G, t["mx"], t["my"], cam)
    one = torch.ones((), dtype=torch.int32, device=cam.device)
    count = _scatter(M, G, pb, one, "sum", 0)
    zero = torch.zeros_like(count)
    chans = [torch.where(in_bounds(cfg, G, cam).reshape(M, -1), 0, -1)
             .to(torch.int32),
             torch.clamp(count, max=1), count,
             _scatter(M, G, vb, t["vm"], "amax", 0),
             _scatter(M, G, vb, t["vm"], "sum", 0),
             _scatter(M, G, mb, t["mm"], "sum", 0)]
    if cfg.num_players > 1:
        ob = _bins(G, t["ox"], t["oy"], cam)
        omin = _scatter(M, G, ob, t["ok"], "amin", INF)
        chans += [torch.where(omin == INF, 0, omin),
                  _scatter(M, G, ob, t["om"], "amax", 0)]
    else:
        chans += [zero, zero]
    return torch.stack(chans, 1).reshape(M, 8, G, G)


def saturate(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int32 -> dtype, clipped to its range."""
    if dtype == torch.int32:
        return x
    info = torch.iinfo(dtype)
    return torch.clamp(x, info.min, info.max).to(dtype)


def grid_frame(cfg: EnvConfig, ocfg: GridObsConfig,
               state: GameState) -> torch.Tensor:
    """(N, A, C, G, G) frames in ocfg's dtype, one per agent."""
    G = ocfg.grid_size
    dtype = ocfg.torch_dtype
    ppos, palive = state.pellet_xy_alive(cfg)
    idx = channel_index(ocfg)
    frames = []
    for a in range(cfg.num_agents):
        cam = camera(state.cell_pos[:, a], state.cell_mass[:, a],
                     state.cell_alive[:, a], cfg.num_agents)
        t = grid_tables(cam, ppos, palive, state.virus_pos,
                        state.virus_mass, state.virus_alive, state.cell_pos,
                        state.cell_mass, state.cell_alive, a)
        frames.append(saturate(rasterize(cfg, G, t)[:, idx], dtype))
    return torch.stack(frames, 1)


def grid_observe(cfg: EnvConfig, ocfg: GridObsConfig,
                 state: GameState) -> torch.Tensor:
    """Single-frame convenience wrapper: (N, A, C, G, G)."""
    return grid_frame(cfg, ocfg, state)

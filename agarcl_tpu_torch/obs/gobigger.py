"""GoBigger-style structured observations (counterpart of obs/gobigger.py).

Per env and agent, padded tables of the entities whose grid-projected
location falls inside the view window (the grid observation's window law,
clamp(2*mass, 100, 300), GoBiggerEnvironment.hpp:423-425), positions
relative to the player:

  foods  (pellets):  rel_x, rel_y, radius, score
  viruses:           rel_x, rel_y, radius, score, vel=(0,0)
  spores (foods):    rel_x, rel_y, radius, score, vel=(0,0), owner
  clones (own cells only): rel_x, rel_y, radius, score, vel, direction,
                     owner, team_id=0

with the reference's quirks: a spore's owner is the observing player's pid,
virus and spore velocities are (0, 0), can_eject / can_split stay true.

`gobigger_frame` is plain torch on the state's device, batch-first: a dict
of (N, A, K, F) f32 tables, (N, A, K) bool masks, score and last_frame
(N, A). The JAX package has no kernel for it. `to_player_states` and
`batch_player_states` convert one env's frame to reference-shaped objects
on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.engine import geometry as G
from agarcl_tpu_torch.state import GameState


@dataclasses.dataclass(frozen=True)
class GoBiggerObsConfig:
    map_width: int = 512
    map_height: int = 512
    frame_limit: int = 1000
    grid_size: int = 128   # the inclusion window's discretization


def _inside(pos, centroid, view, Gs: int):
    """In-window test of the grid law: trunc(G * (pos - c) / view + G/2)
    inside [0, G) on both axes. pos (N, A|1, K, 2), centroid (N, A, 1, 2),
    view (N, A, 1, 1)."""
    g = torch.trunc(float(Gs) * (pos - centroid) / view + float(Gs) / 2.0)
    g = g.to(torch.int32)
    return ((g[..., 0] >= 0) & (g[..., 0] < Gs)
            & (g[..., 1] >= 0) & (g[..., 1] < Gs))


def gobigger_frame(cfg: EnvConfig, ocfg: GoBiggerObsConfig,
                   state: GameState) -> Dict[str, torch.Tensor]:
    """Structured frame of every env: a dict of (N, A, K, F) tables and
    (N, A, K) masks (agarcl_tpu/obs/gobigger.py::gobigger_frame, batched)."""
    A = cfg.num_agents
    Gs = ocfg.grid_size
    f32 = torch.float32
    dev = state.device
    centroid = state.player_centroid()[:, :A]                 # (N, A, 2)
    pmass = state.player_mass().to(f32)
    view = torch.clamp(2.0 * pmass[:, :A], 100.0, 300.0)[..., None, None]
    cen = centroid[:, :, None, :]

    def in_window(pos, alive):
        return _inside(pos[:, None], cen, view, Gs) & alive[:, None]

    def rel(pos):
        return pos[:, None] - cen

    def col(x, ok):
        return x.expand(ok.shape)[..., None]

    pid_col = torch.arange(A, dtype=f32, device=dev)[None, :, None]

    pellet_pos, pellet_alive = state.pellet_xy_alive(cfg)
    p_ok = in_window(pellet_pos, pellet_alive)
    pk = p_ok[..., None]
    foods = torch.cat([
        rel(pellet_pos) * pk,
        col(G.radius(torch.tensor(1.0, dtype=f32, device=dev)), p_ok) * pk,
        torch.ones_like(p_ok, dtype=f32)[..., None] * pk], dim=-1)

    v_ok = in_window(state.virus_pos, state.virus_alive)
    vk = v_ok[..., None]
    viruses = torch.cat([
        rel(state.virus_pos) * vk,
        col(G.radius(state.virus_mass)[:, None], v_ok),
        col(state.virus_mass.to(f32)[:, None], v_ok),
        torch.zeros(v_ok.shape + (2,), dtype=f32, device=dev)],
        dim=-1) * vk

    f_ok = in_window(state.food_pos, state.food_alive)
    fk = f_ok[..., None]
    spores = torch.cat([
        rel(state.food_pos) * fk,
        col(G.radius(torch.tensor(10.0, dtype=f32, device=dev)), f_ok) * fk,
        torch.full(f_ok.shape + (1,), 10.0, dtype=f32, device=dev) * fk,
        torch.zeros(f_ok.shape + (2,), dtype=f32, device=dev),
        col(pid_col, f_ok) * fk], dim=-1)

    own_pos = state.cell_pos[:, :A]
    own_mass = state.cell_mass[:, :A]
    own_vel = state.cell_vel[:, :A]
    c_ok = _inside(own_pos, cen, view, Gs) & state.cell_alive[:, :A]
    ck = c_ok[..., None]
    clones = torch.cat([
        (own_pos - cen) * ck,
        G.radius(own_mass)[..., None] * ck,
        own_mass.to(f32)[..., None] * ck,
        own_vel * ck,
        G.direction(own_vel)[..., None] * ck,
        col(pid_col, c_ok) * ck,
        torch.zeros(c_ok.shape + (1,), dtype=f32, device=dev)], dim=-1)

    return dict(
        foods=foods, foods_mask=p_ok,
        viruses=viruses, viruses_mask=v_ok,
        spores=spores, spores_mask=f_ok,
        clones=clones, clones_mask=c_ok,
        score=pmass[:, :A],
        last_frame=state.ticks[:, None].expand(-1, A),
    )


# --------------------------------------------------------------------- rim
@dataclasses.dataclass
class FoodInfo:
    position: tuple
    radius: float
    score: float


@dataclasses.dataclass
class VirusInfo:
    position: tuple
    radius: float
    score: float
    velocity: tuple


@dataclasses.dataclass
class SporeInfo:
    position: tuple
    radius: float
    score: float
    velocity: tuple
    owner: int


@dataclasses.dataclass
class CloneInfo:
    position: tuple
    radius: float
    score: float
    velocity: tuple
    direction: float
    owner: int
    team_id: int


@dataclasses.dataclass
class PlayerState:
    player_id: int
    food_infos: List[FoodInfo]
    virus_infos: List[VirusInfo]
    spore_infos: List[SporeInfo]
    clone_infos: List[CloneInfo]
    team_name: str
    score: float
    can_eject: bool = True   # the reference never updates these
    can_split: bool = True


@dataclasses.dataclass
class GlobalState:
    map_width: int
    map_height: int
    frame_limit: int
    last_frame_count: int
    team_num: int


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def to_player_states(cfg: EnvConfig, ocfg: GoBiggerObsConfig,
                     frame: Dict) -> tuple:
    """One env's frame ((A, K, F) tables) -> (GlobalState,
    {pid: PlayerState}) on the host."""
    f = {k: _host(v) for k, v in frame.items()}
    players = {}
    for a in range(cfg.num_agents):
        foods = [FoodInfo(tuple(r[:2]), float(r[2]), float(r[3]))
                 for r in f["foods"][a][f["foods_mask"][a]]]
        viruses = [VirusInfo(tuple(r[:2]), float(r[2]), float(r[3]),
                             (float(r[4]), float(r[5])))
                   for r in f["viruses"][a][f["viruses_mask"][a]]]
        spores = [SporeInfo(tuple(r[:2]), float(r[2]), float(r[3]),
                            (float(r[4]), float(r[5])), int(r[6]))
                  for r in f["spores"][a][f["spores_mask"][a]]]
        clones = [CloneInfo(tuple(r[:2]), float(r[2]), float(r[3]),
                            (float(r[4]), float(r[5])), float(r[6]),
                            int(r[7]), int(r[8]))
                  for r in f["clones"][a][f["clones_mask"][a]]]
        players[a] = PlayerState(
            a, foods, viruses, spores, clones, "",
            float(np.asarray(f["score"][a]).reshape(-1)[0]))
    gs = GlobalState(ocfg.map_width, ocfg.map_height, ocfg.frame_limit,
                     int(np.asarray(f["last_frame"]).reshape(-1)[0]),
                     cfg.num_agents)
    return gs, players


def batch_player_states(cfg: EnvConfig, ocfg: GoBiggerObsConfig,
                        frame: Dict, env: int) -> tuple:
    """The rim conversion of env `env` of a batched frame."""
    return to_player_states(cfg, ocfg, {k: _host(v)[env]
                                        for k, v in frame.items()})

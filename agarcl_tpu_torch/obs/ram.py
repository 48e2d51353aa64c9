"""RAM (flat-vector) observations (counterpart of obs/ram.py).

One fixed-shape ego-centric feature vector per agent:

  [ centroid_x/W, centroid_y/H, total_mass,
    per own cell slot (max_cells): rel_x, rel_y, mass, vel_x, vel_y, alive,
    K_p nearest pellets: rel_x, rel_y, alive,
    K_v nearest viruses: rel_x, rel_y, mass, alive,
    per player pid (num_players): rel_x, rel_y, total_mass, alive ]

Relative positions are in world units; dead or padded entries are zero; the
player block keeps one slot per pid with the agent's own slot zeroed.
`ram_frame` is the plain version of the RAM-frame kernel
(ops/fused_obs.py, csrc/ram_frame.cuh).
"""

from __future__ import annotations

import dataclasses

import torch

from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.state import GameState

DEAD_KEY = 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class RamObsConfig:
    num_pellets: int = 32   # K_p nearest pellets
    num_viruses: int = 8    # K_v nearest viruses


def key_index_bits(capacity: int) -> int:
    return max(1, (max(capacity, 2) - 1).bit_length())


def pack_nearest_key(d2: torch.Tensor, idx: torch.Tensor, alive: torch.Tensor,
                     capacity: int) -> torch.Tensor:
    """Sortable unique int32 selection key: the f32 squared distance's bits
    (monotonic for non-negative floats) with the low B bits replaced by
    the entity index, B = ceil(log2(capacity)); dead entries get
    DEAD_KEY. The smallest key is the nearest entity, ties (and near ties)
    going to the lowest index."""
    b = key_index_bits(capacity)
    bits = d2.to(torch.float32).contiguous().view(torch.int32)
    key = (bits & (-1 << b)) | idx
    return torch.where(alive, key, DEAD_KEY)


def ram_size(cfg: EnvConfig, ocfg: RamObsConfig) -> int:
    kp = min(ocfg.num_pellets, cfg.pellet_capacity)
    kv = min(ocfg.num_viruses, cfg.virus_capacity)
    return 3 + cfg.max_cells * 6 + kp * 3 + kv * 4 + cfg.num_players * 4


def ram_frame(cfg: EnvConfig, ocfg: RamObsConfig,
              state: GameState) -> torch.Tensor:
    """(N, A, ram_size) f32 observation for every env and agent."""
    A = cfg.num_agents
    P = cfg.num_players
    N = state.num_envs
    dev = state.device
    f32 = torch.float32
    centroid = state.player_centroid()                       # (N, P, 2)
    pmass = state.player_mass().to(f32)                      # (N, P)
    palive = state.player_alive()
    me = centroid[:, :A]                                     # (N, A, 2)
    # XLA turns the division by the arena size into a product with the
    # f32 reciprocal
    inv_wh = torch.tensor([1.0 / cfg.arena_width, 1.0 / cfg.arena_height],
                          dtype=f32, device=dev)
    feats = [me * inv_wh, pmass[:, :A, None]]

    rel = state.cell_pos[:, :A] - me[:, :, None, :]          # (N, A, Cc, 2)
    a = state.cell_alive[:, :A, :, None].to(f32)
    cells = torch.cat([rel * a, state.cell_mass[:, :A, :, None].to(f32) * a,
                       state.cell_vel[:, :A] * a, a], dim=-1)
    feats.append(cells.reshape(N, A, -1))

    def nearest(pos, alive, k, extra=None):
        n = pos.shape[1]
        rel = pos[:, None, :, :] - me[:, :, None, :]          # (N, A, n, 2)
        d2 = rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1]
        iota = torch.arange(n, dtype=torch.int32, device=dev)
        key = pack_nearest_key(d2, iota, alive[:, None, :], n)
        sel_key, idx = torch.topk(key, k, dim=-1, largest=False, sorted=True)
        sel_rel = torch.gather(rel, 2, idx[..., None].expand(N, A, k, 2))
        af = (sel_key != DEAD_KEY)[..., None].to(f32)
        cols = [sel_rel * af]
        if extra is not None:
            ex = extra[:, None, :].to(f32).expand(N, A, n)
            cols.append(torch.gather(ex, 2, idx)[..., None] * af)
        cols.append(af)
        return torch.cat(cols, dim=-1).reshape(N, A, -1)

    pellet_pos, pellet_alive = state.pellet_xy_alive(cfg)
    feats.append(nearest(pellet_pos, pellet_alive,
                         min(ocfg.num_pellets, cfg.pellet_capacity)))
    feats.append(nearest(state.virus_pos, state.virus_alive,
                         min(ocfg.num_viruses, cfg.virus_capacity),
                         extra=state.virus_mass))

    rel_o = centroid[:, None, :, :] - me[:, :, None, :]      # (N, A, P, 2)
    self_mask = (torch.arange(P, device=dev)[None, :]
                 == torch.arange(A, device=dev)[:, None])
    keep = (palive[:, None, :] & ~self_mask)[..., None].to(f32)
    players = torch.cat(
        [rel_o, pmass[:, None, :, None].expand(N, A, P, 1),
         torch.ones((N, A, P, 1), dtype=f32, device=dev)], dim=-1) * keep
    feats.append(players.reshape(N, A, -1))
    return torch.cat(feats, dim=-1)

"""The parameter block the CUDA kernels take (struct EnvParams in
csrc/common.cuh), computed once per configuration on the host.

Constants that the plain engine forms in float64 and rounds to f32 (the
virus spawn range, the pellet decode scales) are rounded here the same way
and handed to the kernels as f32 values, so both sides use the same bits.
"""

from __future__ import annotations

import ctypes

import numpy as np

from agarcl_tpu_torch import constants as C
from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.engine.spawn import pellet_qparams
from agarcl_tpu_torch.obs.ram import RamObsConfig, key_index_bits, ram_size
from agarcl_tpu_torch.state import pellet_scales

# compile-time capacities of the kernels (csrc/common.cuh)
MAX_CELLS = 16
MAX_TICKS_RING = 16
MAX_VIRUSES = 64
MAX_PLAYERS = 16


class EnvParams(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in (
        "P", "A", "Cc", "Np", "Nv", "Nf", "K", "num_pellets", "num_viruses",
        "mass_decay", "pellet_regen", "ticks_per_step",
        "qlx", "nqx", "qly", "nqy", "kp", "kv", "R", "kbits_p", "kbits_v")] + [
        (name, ctypes.c_float) for name in (
        "W", "H", "dt", "inv_w", "inv_h", "p_invx", "p_invy", "kdec_split",
        "kdec_food", "spawn_k", "virus_hi_x", "virus_hi_y", "virus_rad")] + [
        ("n_bots", ctypes.c_int), ("bot_type", ctypes.c_int * MAX_PLAYERS)]


def env_params(cfg: EnvConfig, ocfg: RamObsConfig | None) -> EnvParams:
    f32 = np.float32
    ocfg = ocfg or RamObsConfig()
    qlx, nqx, qly, nqy = pellet_qparams(cfg)
    _, _, ix, iy = pellet_scales(cfg)
    rad_v = float(np.sqrt(C.VIRUS_INITIAL_MASS / np.pi))
    dt = f32(cfg.dt)
    ms = cfg.mode_spec
    types = cfg.bot_types()
    return EnvParams(
        P=cfg.num_players, A=cfg.num_agents, Cc=cfg.max_cells,
        Np=cfg.pellet_capacity, Nv=cfg.virus_capacity,
        Nf=cfg.food_capacity, K=cfg.virus_ticks_capacity,
        num_pellets=cfg.num_pellets, num_viruses=cfg.num_viruses,
        mass_decay=int(ms.mass_decay), pellet_regen=int(ms.pellet_regen),
        ticks_per_step=cfg.ticks_per_step,
        qlx=qlx, nqx=nqx, qly=qly, nqy=nqy,
        kp=min(ocfg.num_pellets, cfg.pellet_capacity),
        kv=min(ocfg.num_viruses, cfg.virus_capacity),
        R=ram_size(cfg, ocfg),
        kbits_p=key_index_bits(cfg.pellet_capacity),
        kbits_v=key_index_bits(cfg.virus_capacity),
        W=cfg.arena_width, H=cfg.arena_height, dt=dt,
        inv_w=f32(1.0 / cfg.arena_width), inv_h=f32(1.0 / cfg.arena_height),
        p_invx=ix, p_invy=iy,
        kdec_split=f32(C.SPLIT_DECELERATION) * dt,
        kdec_food=f32(C.FOOD_DECEL) * dt,
        spawn_k=dt * f32(10.0),
        virus_hi_x=f32(cfg.arena_width - 2.0 * rad_v),
        virus_hi_y=f32(cfg.arena_height - 2.0 * rad_v),
        virus_rad=f32(rad_v),
        n_bots=sum(t > 0 for t in types),
        bot_type=(ctypes.c_int * MAX_PLAYERS)(*types),
    )

"""Grid frames from kernel-layout planes (counterpart of ops/fused_grid.py).

Kernel K4 (csrc/grid.cu) replaces the TPU kernel
agarcl_tpu/ops/fused_grid.py::_make_kernel (launched by fused_grid_channels
and fused_grid_frame_from_secs) together with the tick kernel's `grid_tab`
section emission (fused_tick.py:2436-2457) and the XLA table build of its
multi-agent rows (`_build_grid_table(agents=A)`): one thread block per
(env, agent) builds the agent's camera and entity bins straight from the K1
planes, counts pellets in a shared-memory histogram and writes the selected
channels.

The plain version is two functions: `grid_sections`, the emission (the 13
input sections of `section_meta`, computed from the planes for one agent),
and `rasterize_plain`, the rasterizer on those sections
(obs/grid.py::rasterize, the same rasterizer the GameState path uses), then
channel selection and saturation to the output dtype.

The camera's centroid is state.frame_centroid (obs/grid.py::camera).

`fused_grid_frame` launches K4 for CUDA planes and runs the plain version
only for CPU planes; `launches` and `plain_calls` count which ran.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.obs.grid import (PARK, GridObsConfig, camera,
                                       channel_index, grid_tables, rasterize,
                                       saturate)
from agarcl_tpu_torch.ops import _build
from agarcl_tpu_torch.ops import params as KP
from agarcl_tpu_torch.ops.fused_tick import (PLANE_INDEX, _ptr_array,
                                             check_planes)
from agarcl_tpu_torch.state import decode_pellet_xy

launches = 0          # K4 launches
plain_calls = 0       # frame_plain calls
MAX_GRID = 238        # K4 keeps a G x G int32 histogram in shared memory
_ELEM = {torch.int32: 4, torch.int16: 2, torch.int8: 1}
_CHUNK = 1024         # envs per pass of the plain rasterizer (memory)


def section_meta(cfg: EnvConfig):
    """(name, width, padded width, pad fill) of the 13 input sections."""
    P, Cc = cfg.num_players, cfg.max_cells
    Np, Nv = cfg.pellet_capacity, cfg.virus_capacity
    ow = (P - 1) * Cc or 8
    rows = [("params", 8, 0.0),
            ("px", Np, PARK), ("py", Np, PARK),
            ("vx", Nv, PARK), ("vy", Nv, PARK), ("vm", Nv, 0.0),
            ("mx", Cc, PARK), ("my", Cc, PARK), ("mm", Cc, 0.0),
            ("ox", ow, PARK), ("oy", ow, PARK), ("om", ow, 0.0),
            ("ok", ow, 0.0)]
    return [(n, w, -(-w // 128) * 128, f) for n, w, f in rows]


def _plane(planes, name: str, axis: int = 0) -> torch.Tensor:
    return planes[PLANE_INDEX[name][axis]]


def grid_sections(cfg: EnvConfig, planes, agent: int = 0) -> dict:
    """The grid sections of agent `agent`'s frames from (feature, N)
    planes (T2's `grid_tab` emission for one agent, the rows of
    `_build_grid_table(agents=A)` for more): {name: (N, padded width) f32}
    in `section_meta` order (obs/grid.py::grid_tables)."""
    N = planes[0].shape[-1]
    P, Cc = cfg.num_players, cfg.max_cells
    cpos = torch.stack([_plane(planes, "cell_pos", 0).T,
                        _plane(planes, "cell_pos", 1).T], -1).reshape(
                            N, P, Cc, 2)
    cmass = _plane(planes, "cell_mass").T.reshape(N, P, Cc)
    calive = _plane(planes, "cell_alive").T.reshape(N, P, Cc)
    ppos, palive = decode_pellet_xy(cfg, _plane(planes, "pellet_key").T)
    vpos = torch.stack([_plane(planes, "virus_pos", 0).T,
                        _plane(planes, "virus_pos", 1).T], -1)
    cam = camera(cpos[:, agent], cmass[:, agent], calive[:, agent],
                 cfg.num_agents)
    t = grid_tables(cam, ppos, palive, vpos, _plane(planes, "virus_mass").T,
                    _plane(planes, "virus_alive").T, cpos, cmass, calive,
                    agent)
    out = {}
    for name, w, pw, fill in section_meta(cfg):
        v = t[name]
        out[name] = torch.cat([v, torch.full((N, pw - w), fill,
                                             dtype=v.dtype,
                                             device=v.device)], 1)
    return out


def rasterize_plain(cfg: EnvConfig, G: int, secs: dict,
                    out_dtype: str = "int32") -> torch.Tensor:
    """(N, 8, G, G) frames of grid sections in out_dtype, saturating (the
    plain version of the TPU kernel), in chunks of _CHUNK envs."""
    dtype = GridObsConfig(out_dtype=out_dtype).torch_dtype
    N = secs["params"].shape[0]
    out = torch.empty((N, 8, G, G), dtype=dtype,
                      device=secs["params"].device)
    for n0 in range(0, N, _CHUNK):
        sec = {k: v[n0:n0 + _CHUNK] for k, v in secs.items()}
        out[n0:n0 + _CHUNK] = saturate(rasterize(cfg, G, sec), dtype)
    return out


def frame_plain(cfg: EnvConfig, ocfg: GridObsConfig, planes,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """(N, A, C, G, G) frames of the planes on any device, one per agent:
    the plain version of K4 (grid_sections for each agent, then
    rasterize_plain)."""
    global plain_calls
    plain_calls += 1
    G, idx = ocfg.grid_size, channel_index(ocfg)
    frame = torch.stack([
        rasterize_plain(cfg, G, grid_sections(cfg, planes, a),
                        ocfg.out_dtype)[:, idx]
        for a in range(cfg.num_agents)], 1)
    if out is None:
        return frame
    return out.copy_(frame)


class GridParams(ctypes.Structure):
    """struct GridParams in csrc/grid.cu."""
    _fields_ = [("G", ctypes.c_int), ("C", ctypes.c_int),
                ("elem", ctypes.c_int), ("A", ctypes.c_int),
                ("chan", ctypes.c_int * 8),
                ("rg", ctypes.c_float), ("W", ctypes.c_float),
                ("H", ctypes.c_float)]


def grid_params(cfg: EnvConfig, ocfg: GridObsConfig) -> GridParams:
    idx = channel_index(ocfg)
    q = GridParams()
    q.G, q.C, q.elem = ocfg.grid_size, len(idx), _ELEM[ocfg.torch_dtype]
    q.A = cfg.num_agents
    for k, c in enumerate(idx):
        q.chan[k] = c
    q.rg = np.float32(1.0 / ocfg.grid_size)
    q.W, q.H = cfg.arena_width, cfg.arena_height
    return q


def _check_out(out, shape, dtype, dev) -> None:
    if (out.device != dev or out.dtype != dtype
            or tuple(out.shape) != shape or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {dtype} {shape} tensor "
                         f"on {dev}")


def fused_grid_frame(cfg: EnvConfig, ocfg: GridObsConfig, planes,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """(N, A, C, G, G) grid frames, one per agent, of kernel-layout planes
    (ops/fused_tick.py::to_kernel_arrays) in ocfg's dtype: K4 for CUDA
    planes, the plain version for CPU planes. `out`, if given, receives the
    frames (for instance one step of a stacked multi_step buffer)."""
    global launches
    if cfg.max_cells != KP.MAX_CELLS or cfg.num_players > KP.MAX_PLAYERS:
        raise NotImplementedError("the grid kernel takes 16 cell slots and "
                                  f"at most {KP.MAX_PLAYERS} players")
    if cfg.virus_capacity > KP.MAX_VIRUSES:
        raise NotImplementedError("the grid kernel takes at most "
                                  f"{KP.MAX_VIRUSES} viruses")
    G = ocfg.grid_size
    if not 1 <= G <= MAX_GRID:
        raise ValueError(f"grid_size must be in [1, {MAX_GRID}], got {G}")
    dtype = ocfg.torch_dtype
    dev = planes[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    N = check_planes(cfg, planes)
    shape = (N, cfg.num_agents, ocfg.channels_per_frame, G, G)
    if out is not None:
        _check_out(out, shape, dtype, dev)
    if dev.type == "cpu":
        return frame_plain(cfg, ocfg, planes, out)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=dev)
    lib = _build.load()
    prm = KP.env_params(cfg, None)
    q = grid_params(cfg, ocfg)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.agarcl_grid(ctypes.byref(prm), ctypes.byref(q),
                             _ptr_array(planes), out.data_ptr(), N, stream)
    _build.check(lib, status, "grid kernel")
    launches += 1
    return out

"""Screen frames from kernel-layout planes (counterpart of
ops/fused_screen.py, circle mode).

Kernel K3 (csrc/screen.cu) replaces the TPU kernel
agarcl_tpu/ops/fused_screen.py::_make_kernel (launched by
_rasterize_sections and _rasterize_table) together with the tick kernel's
`screen_tab` section emission (fused_tick.py:2459-2502): one thread block
per env builds the env's camera and entity rows straight from the K1
planes, draws the class map in shared memory and writes packed pixels.

The plain version is two functions: `screen_sections`, the emission (the 16
input sections of `section_meta`, computed from the planes), and
`rasterize_plain`, the rasterizer on those sections. Its f32 arithmetic is
the TPU kernel's as XLA on the CPU evaluates it in interpret mode, read off
its output with crafted sections: every pixel centre is
fma(idx, half, c); the cell and grid-line passes take idx rounded as
(i+0.5)*2 * f32(1/S) - 1, the pellet, food and virus strips take it as one
fma; the coverage limit r2 - dy*dy is fma(-dy, dy, r2); the grid half-width
is half * f32(1/S) and the line positions f32(f32(k)/7) * W. The camera's
z = fma(mass, f32(0.1), 100) is XLA's own rewrite of 100 + mass/10.

`fused_screen_frame` launches K3 for CUDA planes and runs the plain version
only for CPU planes; `launches` and `plain_calls` count which ran.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from agarcl_tpu_torch import constants as C
from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.engine.geometry import fma32, radius
from agarcl_tpu_torch.obs.screen import (_RAD_FOOD, _RAD_PELLET,
                                         _TAN_HALF_FOV, ScreenObsConfig,
                                         _coords, _idx, _strip_K,
                                         check_circle_mode, cover, palette)
from agarcl_tpu_torch.ops import _build
from agarcl_tpu_torch.ops import params as KP
from agarcl_tpu_torch.ops.fused_tick import (PLANE_INDEX, _ptr_array,
                                             check_planes)
from agarcl_tpu_torch.state import centroid_of, decode_pellet_xy

launches = 0          # K3 launches
plain_calls = 0       # frame_plain calls
_F32 = np.float32
_PARK = 1e9           # coordinate of a dead lane (fused_tick.py _DEAD)
MAX_SCREEN = 448      # K3 keeps the S x S class map in shared memory


def section_meta(cfg: EnvConfig):
    """(name, width, padded width, pad fill) of the 16 input sections."""
    P, Cc = cfg.num_players, cfg.max_cells
    Np, Nv = cfg.pellet_capacity, cfg.virus_capacity
    Nf = cfg.food_capacity
    ow = (P - 1) * Cc or 1
    rows = [("params", 8, 0.0),
            ("px", Np, _PARK), ("py", Np, _PARK), ("pr2", Np, -1.0),
            ("fx", Nf, _PARK), ("fy", Nf, _PARK), ("fr2", Nf, -1.0),
            ("mx", Cc, _PARK), ("my", Cc, _PARK), ("mr2", Cc, -1.0),
            ("ox", ow, _PARK), ("oy", ow, _PARK), ("or2", ow, -1.0),
            ("vx", Nv, _PARK), ("vy", Nv, _PARK), ("vr2", Nv, -1.0)]
    return [(n, w, -(-w // 128) * 128, f) for n, w, f in rows]


def _section_Ks(cfg: EnvConfig, S: int):
    """Strip row budgets (Kp, Kf, Kv) of the pellet, food and virus
    classes; viruses peak at 100 + 7 hits * 10 mass."""
    rv_max = math.sqrt((C.VIRUS_INITIAL_MASS + C.NUMBER_OF_FOOD_HITS
                        * C.FOOD_MASS) / math.pi)
    return (_strip_K(_RAD_PELLET, S), _strip_K(_RAD_FOOD, S),
            _strip_K(rv_max, S))


def _packed_palette(agent_view: bool):
    """Per-class colours packed little-endian into one int32 (byte c =
    channel c), so a frame is one 32-bit word per pixel."""
    tab = palette(agent_view).astype(np.uint32)
    if tab.shape[1] == 3:
        tab = np.concatenate([tab, np.zeros_like(tab[:, :1])], axis=1)
    packed = (tab[:, 0] | (tab[:, 1] << 8) | (tab[:, 2] << 16)
              | (tab[:, 3] << 24)).astype(np.uint32)
    return tuple(int(x) for x in packed.view(np.int32))


def _plane(planes, name: str, axis: int = 0) -> torch.Tensor:
    return planes[PLANE_INDEX[name][axis]]


def screen_sections(cfg: EnvConfig, planes) -> dict:
    """The screen sections of T2's `screen_tab` emission from (feature, N)
    planes: {name: (N, padded width) f32} in `section_meta` order. Cell rows
    keep slot order (uncompacted); dead pellets and viruses are parked at
    1e9, and every dead lane has r2 = -1. params = (cx, cy, half, 1 + highest
    live own slot, 1 + highest live other slot, 0, 0, 0)."""
    Cc = cfg.max_cells
    N = planes[0].shape[-1]
    dev = planes[0].device
    f32 = torch.float32
    cx_all, cy_all = _plane(planes, "cell_pos", 0).T, _plane(planes,
                                                             "cell_pos", 1).T
    cmass = _plane(planes, "cell_mass").T
    calive = _plane(planes, "cell_alive").T                   # (N, P*Cc)
    crad = radius(cmass)
    cr2 = torch.where(calive, crad * crad, -1.0)

    def top(alive):
        slot = torch.arange(1, alive.shape[1] + 1, device=dev)
        return torch.where(alive, slot, 0).amax(1).to(f32)

    cen = centroid_of(torch.stack([cx_all[:, :Cc], cy_all[:, :Cc]], -1),
                      cmass[:, :Cc], calive[:, :Cc])
    pmass = torch.where(calive[:, :Cc], cmass[:, :Cc], 0).sum(
        -1, dtype=torch.int32).to(f32)
    z = torch.clamp(fma32(pmass, float(_F32(0.1)), 100.0), 100.0, 900.0)
    cx, cy, half = cen[:, 0], cen[:, 1], z * float(_F32(_TAN_HALF_FOV))
    ppos, palive = decode_pellet_xy(cfg, _plane(planes, "pellet_key").T)
    rp, rf = _F32(_RAD_PELLET), _F32(_RAD_FOOD)
    valive = _plane(planes, "virus_alive").T
    vrad = radius(_plane(planes, "virus_mass").T)
    vals = dict(
        px=torch.where(palive, ppos[..., 0], _PARK),
        py=torch.where(palive, ppos[..., 1], _PARK),
        pr2=torch.where(palive, float(_F32(rp * rp)), -1.0),
        fx=_plane(planes, "food_pos", 0).T, fy=_plane(planes, "food_pos", 1).T,
        fr2=torch.where(_plane(planes, "food_alive").T, float(_F32(rf * rf)),
                        -1.0),
        mx=cx_all[:, :Cc], my=cy_all[:, :Cc], mr2=cr2[:, :Cc],
        vx=torch.where(valive, _plane(planes, "virus_pos", 0).T, _PARK),
        vy=torch.where(valive, _plane(planes, "virus_pos", 1).T, _PARK),
        vr2=torch.where(valive, vrad * vrad, -1.0))
    if cfg.num_players > 1:
        vals.update(ox=cx_all[:, Cc:], oy=cy_all[:, Cc:], or2=cr2[:, Cc:])
        ocnt = top(calive[:, Cc:])
    else:
        zero = torch.zeros((N, 1), dtype=f32, device=dev)
        vals.update(ox=zero, oy=zero, or2=zero)
        ocnt = zero[:, 0]
    zero = torch.zeros_like(cx)
    vals["params"] = torch.stack([cx, cy, half, top(calive[:, :Cc]), ocnt,
                                  zero, zero, zero], 1)
    out = {}
    for name, w, pw, fill in section_meta(cfg):
        v = vals[name].to(f32)
        out[name] = torch.cat([v, torch.full((N, pw - w), fill, dtype=f32,
                                             device=dev)], 1)
    return out


def _strip_cover(wx, wy, x, y, r2, K: int) -> torch.Tensor:
    """(n, S, S) bool coverage of entities (n, E) whose rows lie in a window
    of K + 2 rows from one row below floor(y - r) (>= 1 row of slack at both
    ends, as the TPU kernel's strips): the direct test on those rows only."""
    n, S = wx.shape
    R = K + 2
    pitch = (wy[:, 1] - wy[:, 0])[:, None]
    r = torch.sqrt(torch.clamp(r2, min=0.0))
    base = torch.floor((y - r - wy[:, :1]) / pitch) - 1.0
    base = torch.clamp(base, -R, S).to(torch.int64)           # dead -> off
    rows = base[..., None] + torch.arange(R, device=wx.device)  # (n, E, R)
    ok = (rows >= 0) & (rows < S)
    rows = rows.clamp(0, S - 1)
    dy = torch.gather(wy, 1, rows.reshape(n, -1)).reshape(rows.shape) \
        - y[..., None]
    lim = fma32(-dy, dy, r2[..., None])                         # (n, E, R)
    dx = wx[:, None, :] - x[..., None]                          # (n, E, S)
    cov = ((dx * dx)[:, :, None, :] <= lim[..., None]) & ok[..., None]
    acc = torch.zeros((n, S, S), dtype=torch.int32, device=wx.device)
    nidx = torch.arange(n, device=wx.device)[:, None, None].expand_as(rows)
    acc.index_put_((nidx, rows), cov.to(torch.int32), accumulate=True)
    return acc > 0


def rasterize_plain(cfg: EnvConfig, S: int, secs: dict, packed=None,
                    chunk: int = 256) -> torch.Tensor:
    """(N, S, S) int32 packed pixels (`_packed_palette`), or uint8 class
    ids when `packed` is None, of screen sections (the plain version of the
    TPU kernel in circle mode, draw order grid < pellet < food < main <
    other < virus)."""
    N = secs["params"].shape[0]
    dev = secs["params"].device
    Kp, Kf, Kv = _section_Ks(cfg, S)
    idx_c, idx_s = _idx(S, False, dev), _idx(S, True, dev)
    rc = float(_F32(1.0 / S))
    ks = [float(_F32(_F32(k) / _F32(7.0)) * _F32(w)) for w in
          (cfg.arena_width, cfg.arena_height) for k in range(8)]
    xs = torch.tensor(ks[:8], device=dev)
    ys = torch.tensor(ks[8:], device=dev)
    lo = float(_F32(-1e-3))
    hx = float(_F32(cfg.arena_width + 1e-3))
    hy = float(_F32(cfg.arena_height + 1e-3))
    n_other = (cfg.num_players - 1) * cfg.max_cells
    out = torch.empty((N, S, S), dtype=torch.int32 if packed else torch.uint8,
                      device=dev)
    for n0 in range(0, N, chunk):
        sec = {k: v[n0:n0 + chunk] for k, v in secs.items()}
        cx, cy, half = (sec["params"][:, j] for j in range(3))
        wxc, wyc = _coords(idx_c, half, cx), _coords(idx_c, half, cy)
        wxs, wys = _coords(idx_s, half, cx), _coords(idx_s, half, cy)
        ph = (half * rc)[:, None, None]
        on_v = ((wxc[..., None] - xs).abs() <= ph).any(-1)
        on_h = ((wyc[..., None] - ys).abs() <= ph).any(-1)
        in_x = (wxc >= lo) & (wxc <= hx)
        in_y = (wyc >= lo) & (wyc <= hy)
        grid = ((on_v[:, None, :] | on_h[:, :, None]) & in_x[:, None, :]
                & in_y[:, :, None])
        cls = grid.to(torch.uint8)
        for pre, K, cid in (("p", Kp, 2), ("f", Kf, 3)):
            cls[_strip_cover(wxs, wys, sec[pre + "x"], sec[pre + "y"],
                             sec[pre + "r2"], K)] = cid
        cls[cover(wxc, wyc, sec["mx"], sec["my"], sec["mr2"])] = 4
        if n_other:
            cls[cover(wxc, wyc, sec["ox"], sec["oy"], sec["or2"])] = 5
        cls[_strip_cover(wxs, wys, sec["vx"], sec["vy"], sec["vr2"], Kv)] = 6
        if packed is not None:
            tab = torch.tensor(packed, dtype=torch.int32, device=dev)
            cls = tab[cls.long()]
        out[n0:n0 + chunk] = cls
    return out


def frame_plain(cfg: EnvConfig, ocfg: ScreenObsConfig, planes,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 1, S, S, 3|4) uint8 frames of the planes on any device: the
    plain version of K3 (screen_sections, then rasterize_plain)."""
    global plain_calls
    plain_calls += 1
    check_circle_mode(ocfg)
    S = ocfg.screen_len
    packed = rasterize_plain(cfg, S, screen_sections(cfg, planes),
                             _packed_palette(ocfg.agent_view))
    frame = packed.view(torch.uint8).reshape(-1, 1, S, S, 4)
    if not ocfg.agent_view:
        frame = frame[..., :3]
    if out is None:
        return frame.contiguous()
    return out.copy_(frame)


class ScreenParams(ctypes.Structure):
    """struct ScreenParams in csrc/screen.cu."""
    _fields_ = ([("S", ctypes.c_int), ("C", ctypes.c_int),
                 ("palette", ctypes.c_uint32 * 8)]
                + [(n, ctypes.c_float) for n in (
                    "rc", "tan_half", "lo", "hi_x", "hi_y", "pr2", "fr2")]
                + [("xs", ctypes.c_float * 8), ("ys", ctypes.c_float * 8)])


def screen_params(cfg: EnvConfig, ocfg: ScreenObsConfig) -> ScreenParams:
    S = ocfg.screen_len
    q = ScreenParams()
    q.S, q.C = S, 4 if ocfg.agent_view else 3
    for k, v in enumerate(_packed_palette(ocfg.agent_view)):
        q.palette[k] = v & 0xFFFFFFFF
    rp, rf = _F32(_RAD_PELLET), _F32(_RAD_FOOD)
    q.rc, q.tan_half = _F32(1.0 / S), _F32(_TAN_HALF_FOV)
    q.lo = _F32(-1e-3)
    q.hi_x, q.hi_y = (_F32(cfg.arena_width + 1e-3),
                      _F32(cfg.arena_height + 1e-3))
    q.pr2, q.fr2 = _F32(rp * rp), _F32(rf * rf)
    for k in range(8):
        t = _F32(_F32(k) / _F32(7.0))
        q.xs[k] = _F32(t * _F32(cfg.arena_width))
        q.ys[k] = _F32(t * _F32(cfg.arena_height))
    return q


def _check_out(out, N: int, S: int, ch: int, dev) -> None:
    shape = (N, 1, S, S, ch)
    if (out.device != dev or out.dtype != torch.uint8
            or tuple(out.shape) != shape or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous uint8 {shape} tensor on "
                         f"{dev}")


def fused_screen_frame(cfg: EnvConfig, ocfg: ScreenObsConfig, planes,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 1, S, S, 3|4) uint8 screen frames of kernel-layout planes
    (ops/fused_tick.py::to_kernel_arrays): K3 for CUDA planes, the plain
    version for CPU planes. `out`, if given, receives the frames (for
    instance one step of a stacked multi_step buffer)."""
    global launches
    check_circle_mode(ocfg)
    if cfg.num_agents != 1:
        raise NotImplementedError("the screen kernel draws one agent's view")
    if cfg.max_cells != KP.MAX_CELLS or cfg.num_players > KP.MAX_PLAYERS:
        raise NotImplementedError("the screen kernel takes 16 cell slots and "
                                  f"at most {KP.MAX_PLAYERS} players")
    S = ocfg.screen_len
    if not 2 <= S <= MAX_SCREEN:
        raise ValueError(f"screen_len must be in [2, {MAX_SCREEN}], got {S}")
    dev = planes[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    N = check_planes(cfg, planes)
    ch = 4 if ocfg.agent_view else 3
    if out is not None:
        _check_out(out, N, S, ch, dev)
    if dev.type == "cpu":
        return frame_plain(cfg, ocfg, planes, out)
    if out is None:
        out = torch.empty((N, 1, S, S, ch), dtype=torch.uint8, device=dev)
    lib = _build.load()
    prm = KP.env_params(cfg, None)
    q = screen_params(cfg, ocfg)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.agarcl_screen(ctypes.byref(prm), ctypes.byref(q),
                               _ptr_array(planes), out.data_ptr(), N, stream)
    _build.check(lib, status, "screen kernel")
    launches += 1
    return out

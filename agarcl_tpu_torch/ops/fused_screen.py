"""Screen frames from kernel-layout planes (counterpart of
ops/fused_screen.py).

Kernel K3 (csrc/screen.cu) replaces the TPU kernel
agarcl_tpu/ops/fused_screen.py::_make_kernel (launched by
_rasterize_sections and _rasterize_table), in circle mode and in `poly`
mode, together with the tick kernel's `screen_tab` section emission
(fused_tick.py:2459-2502) and the XLA table build of its multi-agent rows
(`_build_table(agents=A)`): one thread block per (env, agent) builds the
agent's camera and entity rows straight from the K1 planes, draws the
class map in shared memory and writes packed pixels.

The plain version is two functions: `screen_sections`, the emission (the 16
input sections of `section_meta`, computed from the planes for one agent),
and `rasterize_plain`, the rasterizer on those sections. Its f32 arithmetic is
the TPU kernel's as XLA on the CPU evaluates it in interpret mode, read off
its output with crafted sections: every pixel centre is
fma(idx, half, c); the cell and grid-line passes take idx rounded as
(i+0.5)*2 * f32(1/S) - 1, the pellet, food and virus strips take it as one
fma; the coverage limit r2 - dy*dy is fma(-dy, dy, r2); the grid half-width
is half * f32(1/S) and the line positions f32(f32(k)/7) * W. The camera's
z = fma(mass, f32(0.1), 100) is XLA's own rewrite of 100 + mass/10.

`poly` mode (`supports_polygon`: polygon_edges with polygon_virus="circle"
and S <= 128) draws the reference's regular fans (5-gon pellets, 7-gon
foods, 50-gon cells; viruses stay circles) by the TPU kernel's half-plane
rule (`_poly_edges`): in a pixel row at offset dy from the centre the fan
covers one interval [xlo, xhi]; xhi is the minimum over the lines with
a > 0 of (c2*r - b*dy) * inv_a, xlo the maximum over the lines with a < 0,
and a flat line (|a| < 1e-9) empties the row when b*dy > c2*r; inv_a =
f32(1/a) and b = f32(sin(phi)) from float64, c2 = f32(cos(pi/n)) and
r = sqrt(max(r2, 0)), correctly rounded. XLA's forms, read off the
interpret-mode kernel on crafted sections: c2*r, b*dy, their difference
and the product with inv_a are each rounded (no fma); every pass takes the
one-fma pixel centres of the strips (rows and columns); pellets and foods
compare dx = wx - x with [xlo, xhi], cells compare wx with the rounded
absolute bounds xlo + x, xhi + x.

The camera's centroid is state.frame_centroid: slot-order products with
one agent, XLA's fma chain with more.

`fused_screen_frame` launches K3 for CUDA planes and runs the plain version
only for CPU planes; `launches` and `plain_calls` count which ran.
`class_map_frame` is the GameState route of polygon configurations that
K3 does not take (the wavy virus rim, S > 128): obs/screen.py::screen_frame
on the planes' device.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from agarcl_tpu_torch import constants as C
from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.engine.geometry import fma32, radius, sqrt32
from agarcl_tpu_torch.obs.screen import (_RAD_FOOD, _RAD_PELLET,
                                         _TAN_HALF_FOV, SIDES_CELL,
                                         SIDES_FOOD, SIDES_PELLET,
                                         ScreenObsConfig, _coords, _idx,
                                         _strip_K, check_config, cover,
                                         palette, screen_frame, strip_cover)
from agarcl_tpu_torch.ops import _build
from agarcl_tpu_torch.ops import params as KP
from agarcl_tpu_torch.ops.fused_tick import (PLANE_INDEX, _ptr_array,
                                             check_planes,
                                             from_kernel_arrays)
from agarcl_tpu_torch.state import (decode_pellet_xy, frame_centroid,
                                    zero_state)

launches = 0          # K3 launches
plain_calls = 0       # frame_plain calls
_F32 = np.float32
_PARK = 1e9           # coordinate of a dead lane (fused_tick.py _DEAD)
MAX_SCREEN = 448      # K3 keeps the S x S class map in shared memory
MAX_POLY_SCREEN = 128  # poly mode's limit (pixel rows ride TPU lanes)
MAX_LINES = 64        # half-plane lines of one fan in ScreenParams
_HUGE = float(_F32(3.0e38))


def supports_polygon(ocfg: ScreenObsConfig) -> bool:
    """Whether polygon frames ride K3 (agarcl_tpu/ops/fused_screen.py
    `supports_polygon`): the regular fans rasterize exactly by half-plane
    row intervals, the wavy virus rim is concave and is not taken, and the
    JAX kernel keeps pixel rows in lanes, so S <= 128."""
    return (ocfg.polygon_edges and ocfg.polygon_virus == "circle"
            and ocfg.screen_len <= MAX_POLY_SCREEN)


def _poly_edges(n_sides: int):
    """Half-plane constants of the reference's regular n-gon fan
    (circumradius 1, first rim vertex at angle d = 2*pi/n,
    renderables.hpp:191-200): edge t joins the vertices at angles (t+1)*d
    and (t+2)*d, its outward normal points at phi = (t+1.5)*d, its support
    is cos(pi/n). Returns float64 (rights, lefts, flats): rights / lefts
    are (1/a, b) for a = cos(phi) > 0 / < 0, flats are (b,) for |a| <
    1e-9, with b = sin(phi)."""
    d = 2.0 * math.pi / n_sides
    rights, lefts, flats = [], [], []
    for t in range(n_sides):
        phi = (t + 1.5) * d
        a, b = math.cos(phi), math.sin(phi)
        if abs(a) < 1e-9:
            flats.append(b)
        elif a > 0:
            rights.append((1.0 / a, b))
        else:
            lefts.append((1.0 / a, b))
    return rights, lefts, flats


def fan_lines(n_sides: int):
    """f32 (rights [(inv_a, b)], lefts, flats [b], c2) of the n-gon fan."""
    rights, lefts, flats = _poly_edges(n_sides)

    def f(v):
        return float(_F32(v))
    return ([(f(ia), f(b)) for ia, b in rights],
            [(f(ia), f(b)) for ia, b in lefts], [f(b) for b in flats],
            f(math.cos(math.pi / n_sides)))


def fan_bounds(dy, r, n_sides: int):
    """f32 (xlo, xhi) of the fan's row interval relative to its centre,
    for rows at offset dy of fans of radius r (broadcast); a row that
    misses the fan has xlo > xhi."""
    rights, lefts, flats, c2 = fan_lines(n_sides)
    c2r = r * c2
    shape = torch.broadcast_shapes(dy.shape, r.shape)
    xhi = torch.full(shape, _HUGE, dtype=torch.float32, device=dy.device)
    xlo = torch.full(shape, -_HUGE, dtype=torch.float32, device=dy.device)
    for inv_a, b in rights:
        xhi = torch.minimum(xhi, (c2r - dy * b) * inv_a)
    for inv_a, b in lefts:
        xlo = torch.maximum(xlo, (c2r - dy * b) * inv_a)
    for b in flats:
        xlo = torch.where(dy * b > c2r, _HUGE, xlo)
    return xlo, xhi


def fan_strip(n_sides: int):
    """Strip predicate (obs/screen.py::strip_cover) of the fan: dx within
    the row interval."""
    def pred(dx, dy, r2):
        xlo, xhi = fan_bounds(dy, sqrt32(torch.clamp(r2, min=0.0)), n_sides)
        return (dx >= xlo) & (dx <= xhi)
    return pred


def circle_strip(dx, dy, r2):
    """Strip predicate of the circle: dx*dx <= fma(-dy, dy, r2)."""
    return dx * dx <= fma32(-dy, dy, r2)


def _fan_cover(wx, wy, x, y, r2, n_sides: int, chunk: int = 16):
    """(n, S, S) bool coverage of fans (n, E) on every row: the row
    bounds made absolute (xlo + x, xhi + x, rounded) against the pixel
    columns; dead entities (r2 < 0) cover nothing."""
    n, S = wx.shape
    acc = torch.zeros((n, S, S), dtype=torch.bool, device=wx.device)
    for e0 in range(0, x.shape[1], chunk):
        sl = slice(e0, e0 + chunk)
        r = sqrt32(torch.clamp(r2[:, sl], min=0.0))[..., None]
        xlo, xhi = fan_bounds(wy[:, None, :] - y[:, sl, None], r, n_sides)
        xlo = torch.where(r2[:, sl, None] >= 0, xlo, _HUGE)
        lo = (xlo + x[:, sl, None])[..., None]               # (n, e, S, 1)
        hi = (xhi + x[:, sl, None])[..., None]
        col = wx[:, None, None, :]
        acc |= ((col >= lo) & (col <= hi)).any(1)
    return acc


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


def screen_sections(cfg: EnvConfig, planes, agent: int = 0) -> dict:
    """The screen sections of agent `agent`'s frames from (feature, N)
    planes (T2's `screen_tab` emission for one agent, the rows of
    `_build_table(agents=A)` for more): {name: (N, padded width) f32} in
    `section_meta` order. "m" rows are the agent's cells, "o" rows every
    other player's in pid order; cell rows keep slot order (uncompacted);
    dead pellets and viruses are parked at 1e9, and every dead lane has
    r2 = -1. params = (cx, cy, half, 1 + highest live own slot, 1 +
    highest live other slot, 0, 0, 0)."""
    Cc, P = cfg.max_cells, cfg.num_players
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

    own = torch.zeros(P * Cc, dtype=torch.bool, device=dev)
    own[agent * Cc:(agent + 1) * Cc] = True
    cen = frame_centroid(torch.stack([cx_all[:, own], cy_all[:, own]], -1),
                         cmass[:, own], calive[:, own], cfg.num_agents)
    pmass = torch.where(calive[:, own], cmass[:, own], 0).sum(
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
        mx=cx_all[:, own], my=cy_all[:, own], mr2=cr2[:, own],
        vx=torch.where(valive, _plane(planes, "virus_pos", 0).T, _PARK),
        vy=torch.where(valive, _plane(planes, "virus_pos", 1).T, _PARK),
        vr2=torch.where(valive, vrad * vrad, -1.0))
    if P > 1:
        vals.update(ox=cx_all[:, ~own], oy=cy_all[:, ~own],
                    or2=cr2[:, ~own])
        ocnt = top(calive[:, ~own])
    else:
        zero = torch.zeros((N, 1), dtype=f32, device=dev)
        vals.update(ox=zero, oy=zero, or2=zero)
        ocnt = zero[:, 0]
    zero = torch.zeros_like(cx)
    vals["params"] = torch.stack([cx, cy, half, top(calive[:, own]), ocnt,
                                  zero, zero, zero], 1)
    out = {}
    for name, w, pw, fill in section_meta(cfg):
        v = vals[name].to(f32)
        out[name] = torch.cat([v, torch.full((N, pw - w), fill, dtype=f32,
                                             device=dev)], 1)
    return out


def rasterize_plain(cfg: EnvConfig, S: int, secs: dict, packed=None,
                    chunk: int = 256, poly: bool = False) -> torch.Tensor:
    """(N, S, S) int32 packed pixels (`_packed_palette`), or uint8 class
    ids when `packed` is None, of screen sections (the plain version of the
    TPU kernel in circle mode, or in `poly` mode the fans of the module
    docstring; draw order grid < pellet < food < main < other < virus)."""
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
        for pre, K, cid, sides in (("p", Kp, 2, SIDES_PELLET),
                                   ("f", Kf, 3, SIDES_FOOD)):
            cls[strip_cover(wxs, wys, sec[pre + "x"], sec[pre + "y"],
                            sec[pre + "r2"], K,
                            fan_strip(sides) if poly else circle_strip)] = cid
        for pre, cid in (("m", 4), ("o", 5)):
            if pre == "o" and not n_other:
                continue
            x, y, r2 = sec[pre + "x"], sec[pre + "y"], sec[pre + "r2"]
            cls[_fan_cover(wxs, wys, x, y, r2, SIDES_CELL) if poly
                else cover(wxc, wyc, x, y, r2)] = cid
        cls[strip_cover(wxs, wys, sec["vx"], sec["vy"], sec["vr2"], Kv,
                        circle_strip)] = 6
        if packed is not None:
            tab = torch.tensor(packed, dtype=torch.int32, device=dev)
            cls = tab[cls.long()]
        out[n0:n0 + chunk] = cls
    return out


def frame_plain(cfg: EnvConfig, ocfg: ScreenObsConfig, planes,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """(N, A, S, S, 3|4) uint8 frames of the planes on any device, one per
    agent: the plain version of K3 (screen_sections for each agent, then
    rasterize_plain, in `poly` mode for polygon configurations)."""
    global plain_calls
    plain_calls += 1
    poly = _check_screen(cfg, ocfg)
    S = ocfg.screen_len
    packed = _packed_palette(ocfg.agent_view)
    px = torch.stack([
        rasterize_plain(cfg, S, screen_sections(cfg, planes, a), packed,
                        poly=poly)
        for a in range(cfg.num_agents)], 1)
    frame = px.view(torch.uint8).reshape(px.shape + (4,))
    if not ocfg.agent_view:
        frame = frame[..., :3]
    if out is None:
        return frame.contiguous()
    return out.copy_(frame)


def class_map_frame(cfg: EnvConfig, ocfg: ScreenObsConfig, planes,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """(N, A, S, S, 3|4) uint8 frames of the planes through the GameState
    route (obs/screen.py::screen_frame, counted in its class_map_calls) on
    the planes' device: the route of polygon configurations that K3 does
    not take."""
    N = check_planes(cfg, planes)
    state = from_kernel_arrays(zero_state(cfg, N, planes[0].device), planes)
    frame = screen_frame(cfg, ocfg, state)
    if out is None:
        return frame
    return out.copy_(frame)


def _check_screen(cfg: EnvConfig, ocfg: ScreenObsConfig) -> bool:
    """Whether K3 and its plain version take this configuration, and in
    `poly` mode; raises for a polygon configuration they do not take."""
    check_config(ocfg)
    if ocfg.polygon_edges and not supports_polygon(ocfg):
        raise NotImplementedError(
            "the screen kernel draws polygon frames with polygon_virus="
            f"'circle' and screen_len <= {MAX_POLY_SCREEN} only; this "
            "configuration goes through obs/screen.py::screen_frame "
            "(class_map_frame)")
    return ocfg.polygon_edges


class FanLines(ctypes.Structure):
    """struct FanLines in csrc/screen.cu: the fan_lines of one n-gon,
    rights then lefts then flats (b only)."""
    _fields_ = [("nr", ctypes.c_int), ("nl", ctypes.c_int),
                ("nf", ctypes.c_int), ("c2", ctypes.c_float),
                ("inv_a", ctypes.c_float * MAX_LINES),
                ("b", ctypes.c_float * MAX_LINES)]


class ScreenParams(ctypes.Structure):
    """struct ScreenParams in csrc/screen.cu."""
    _fields_ = ([("S", ctypes.c_int), ("C", ctypes.c_int),
                 ("A", ctypes.c_int), ("poly", ctypes.c_int),
                 ("palette", ctypes.c_uint32 * 8)]
                + [(n, ctypes.c_float) for n in (
                    "rc", "tan_half", "lo", "hi_x", "hi_y", "pr2", "fr2")]
                + [("xs", ctypes.c_float * 8), ("ys", ctypes.c_float * 8),
                   ("fan", FanLines * 3)])


def _fan_struct(n_sides: int) -> FanLines:
    rights, lefts, flats, c2 = fan_lines(n_sides)
    f = FanLines()
    f.nr, f.nl, f.nf, f.c2 = len(rights), len(lefts), len(flats), c2
    for k, (ia, b) in enumerate(rights + lefts):
        f.inv_a[k], f.b[k] = ia, b
    for k, b in enumerate(flats):
        f.b[len(rights) + len(lefts) + k] = b
    return f


def screen_params(cfg: EnvConfig, ocfg: ScreenObsConfig) -> ScreenParams:
    S = ocfg.screen_len
    q = ScreenParams()
    q.S, q.C = S, 4 if ocfg.agent_view else 3
    q.A, q.poly = cfg.num_agents, int(_check_screen(cfg, ocfg))
    for k, sides in enumerate((SIDES_PELLET, SIDES_FOOD, SIDES_CELL)):
        q.fan[k] = _fan_struct(sides)
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


def _check_out(out, N: int, A: int, S: int, ch: int, dev) -> None:
    shape = (N, A, S, S, ch)
    if (out.device != dev or out.dtype != torch.uint8
            or tuple(out.shape) != shape or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous uint8 {shape} tensor on "
                         f"{dev}")


def fused_screen_frame(cfg: EnvConfig, ocfg: ScreenObsConfig, planes,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """(N, A, S, S, 3|4) uint8 screen frames, one per agent, of
    kernel-layout planes (ops/fused_tick.py::to_kernel_arrays): K3 for CUDA
    planes, the plain version for CPU planes; polygon configurations in
    `poly` mode (supports_polygon; others raise). `out`, if given, receives
    the frames (for instance one step of a stacked multi_step buffer)."""
    global launches
    _check_screen(cfg, ocfg)
    if cfg.max_cells != KP.MAX_CELLS or cfg.num_players > KP.MAX_PLAYERS:
        raise NotImplementedError("the screen kernel takes 16 cell slots and "
                                  f"at most {KP.MAX_PLAYERS} players")
    S = ocfg.screen_len
    if not 2 <= S <= MAX_SCREEN:
        raise ValueError(f"screen_len must be in [2, {MAX_SCREEN}], got {S}")
    dev = planes[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    N, A = check_planes(cfg, planes), cfg.num_agents
    ch = 4 if ocfg.agent_view else 3
    if out is not None:
        _check_out(out, N, A, S, ch, dev)
    if dev.type == "cpu":
        return frame_plain(cfg, ocfg, planes, out)
    if out is None:
        out = torch.empty((N, A, S, S, ch), dtype=torch.uint8, device=dev)
    lib = _build.load()
    prm = KP.env_params(cfg, None)
    q = screen_params(cfg, ocfg)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.agarcl_screen(ctypes.byref(prm), ctypes.byref(q),
                               _ptr_array(planes), out.data_ptr(), N, stream)
    _build.check(lib, status, "screen kernel")
    launches += 1
    return out

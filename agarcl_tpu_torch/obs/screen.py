"""Screen observations: analytic circle and fan rasterization (counterpart
of obs/screen.py).

The camera hovers at z = clamp(100 + mass/10, 100, 900) above the agent's
centroid with a 45-degree field of view, so the visible world window is the
square of half-extent z*tan(22.5 deg) and a pixel is covered by an entity
when its centre passes the inclusive f32 test dx*dx <= r*r - dy*dy. Row 0 is
the bottom row. Per pixel the topmost class in draw order wins:
0 background, 1 grid, 2 pellet, 3 food, 4 main player, 5 other players,
6 virus; `agent_view` maps the classes to the 4-channel semantic palette,
otherwise to the natural RGB palette through GL_RGB565 quantization.

f32 arithmetic. The reference is what XLA on the CPU computes for the JAX
package's `_class_map` under jit(vmap), read off its output with crafted
states (entities and grid lines a few ulps from pixel centres):
- z = fma(mass, f32(0.1), 100): the division by 10 becomes a product with
  the f32 reciprocal, which fuses with the add;
- pixel centres c + idx*half are one fma, with idx = fma((i+0.5)*2,
  f32(1/S), -1) (`_idx(S, fused=True)`) — except the pixel columns of the
  pellet and food strips, whose idx rounds the product first
  (`_idx(S, fused=False)`);
- the coverage limit r2 - dy*dy is fma(-dy, dy, r2);
- the grid half-width half/S is z * f32(tan(22.5) * f32(1/S)) and the line
  positions k/7*W are k * f32(f32(1/7) * W).
fma is formed in float64 and rounded once (engine/geometry.py::fma32).

`polygon_edges=True` draws the reference's triangle-fan silhouettes
instead of circles: 5-gon pellets, 7-gon foods, 50-gon cells and, with
polygon_virus="wavy", the 150-gon wavy virus rim (polygon_virus="circle"
keeps viruses round). A pixel is covered when dx*dx + dy*dy <= r2 * f*f,
f the fan's local radius factor in the pixel's direction
(`_poly_radius_factor`, the polar chord formula), evaluated in float64
and rounded to f32. This form is not bit-equal to XLA's f32 atan2 / cos /
sin: the tests hold it to the float64 fan oracle of
tests/test_polygon_screen.py and to the JAX class map with a differing
share below 2e-3, the JAX suite's own bar. Pellets and foods are tested on
the rows of a strip around each entity only (`strip_cover`); polygon class
maps are built in chunks of envs (the polar factor takes (envs, entities,
rows, S) float64 temporaries).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.engine.geometry import fma32, radius
from agarcl_tpu_torch.profiling import register_counters
from agarcl_tpu_torch.state import GameState

_TAN_HALF_FOV = math.tan(math.radians(45.0 / 2.0))
_NUM_GRID_LINES = 8  # renderer.hpp:26
_RAD_PELLET = float(np.sqrt(np.float32(1.0) / np.float32(np.pi)))
_RAD_FOOD = float(np.sqrt(np.float32(10.0) / np.float32(np.pi)))
_F32 = np.float32
# polygon side counts (Entities.hpp:13-16)
SIDES_PELLET = 5
SIDES_FOOD = 7
SIDES_CELL = 50
SIDES_VIRUS = 150
# wavy virus rim: vertex i sits at radius 1 + sin(30*pi*i/N)/15
# (Entities.hpp:66-75)
_VIRUS_RIM = tuple(1.0 + math.sin(30.0 * math.pi * i / SIDES_VIRUS) / 15.0
                   for i in range(SIDES_VIRUS + 2))
_ENV_CHUNK = 128      # envs per pass of a polygon class map (memory)

class_map_calls = 0   # screen_frame calls (the GameState route)
register_counters(__name__, "screen", ("class_map_calls",))


@dataclasses.dataclass(frozen=True)
class ScreenObsConfig:
    screen_len: int = 84
    agent_view: bool = False
    num_frames: int = 1
    polygon_edges: bool = False
    polygon_virus: str = "wavy"


def check_config(ocfg: ScreenObsConfig) -> None:
    if ocfg.polygon_virus not in ("wavy", "circle"):
        raise ValueError("polygon_virus must be 'wavy' or 'circle', got "
                         f"{ocfg.polygon_virus!r}")


def _poly_radius_factor(dx, dy, n_sides: int, wavy: bool = False):
    """f32 local silhouette radius, relative to the circumradius, of the
    reference's triangle fan (centre plus rim vertices w_i * (cos(i*d),
    sin(i*d)), i = 1..N+1, d = 2*pi/N, renderables.hpp:191-200) in the
    direction of (dx, dy): cos(pi/N) / cos(t - pi/N) for a regular N-gon,
    the polar two-point line formula between the bracketing rim vertices
    for the wavy rim. Float64 inside."""
    d = 2.0 * math.pi / n_sides
    theta = torch.atan2(dy.double(), dx.double())
    k = torch.remainder(torch.floor((theta - d) / d).long(), n_sides)
    t = torch.remainder(theta - (k + 1).double() * d, 2.0 * math.pi)
    if not wavy:
        f = math.cos(math.pi / n_sides) / torch.cos(t - math.pi / n_sides)
    else:
        rim = torch.tensor(_VIRUS_RIM, dtype=torch.float64, device=dx.device)
        r1, r2 = rim[k + 1], rim[k + 2]
        f = r1 * r2 * math.sin(d) / (r2 * torch.sin(d - t)
                                     + r1 * torch.sin(t))
    return f.float()


def fan_polar(n_sides: int, wavy: bool = False):
    """Coverage predicate of the fan by the polar factor: dx*dx + dy*dy
    (one fma) <= r2 * f*f (`cover` and `strip_cover` argument)."""
    def pred(dx, dy, r2):
        f = _poly_radius_factor(dx, dy, n_sides, wavy)
        return fma32(dx, dx, dy * dy) <= r2 * (f * f)
    return pred


def _idx(S: int, fused: bool, device=None) -> torch.Tensor:
    """(S,) f32 pixel-centre offsets (i + 0.5) * 2/S - 1 in (-1, 1), with
    the division as a product with f32(1/S); `fused` rounds the product and
    the -1 once (one fma), otherwise the product is rounded first."""
    t = (torch.arange(S, dtype=torch.float32, device=device) + 0.5) * 2.0
    rc = float(_F32(1.0 / S))
    if fused:
        return fma32(t, rc, -1.0)
    return t * rc - 1.0


def _coords(idx: torch.Tensor, half: torch.Tensor, c: torch.Tensor):
    """(..., S) pixel-centre world coordinates fma(idx, half, c)."""
    return fma32(idx, half[..., None], c[..., None])


def _pixel_world_coords(center, z, S):
    """World coordinates of pixel centres. center (..., 2), z (...) ->
    (wx (..., S), wy (..., S), half (...), pixel_half (...))."""
    half = z * float(_F32(_TAN_HALF_FOV))
    idx = _idx(S, True, z.device)
    wx = _coords(idx, half, center[..., 0])
    wy = _coords(idx, half, center[..., 1])
    pixel_half = z * float(_F32(_F32(_TAN_HALF_FOV) * _F32(1.0 / S)))
    return wx, wy, half, pixel_half


def _strip_K(r: float, S: int) -> int:
    """Row budget of a circle of radius r at the finest pixel pitch (camera
    floor z=100), plus rounding margin (obs/screen.py::_strip_K)."""
    pitch_min = 2.0 * 100.0 * _TAN_HALF_FOV / S
    return min(S, int(math.ceil(2.0 * r / pitch_min)) + 2)


def cover(wx, wy, x, y, r2, chunk: int = 64, pred=None) -> torch.Tensor:
    """(..., S, S) bool [row, col]: any entity covers the pixel centre.

    wx, wy: (..., S) pixel-centre columns / rows; x, y, r2: (..., E), dead
    entities with r2 < 0. The circle test is dx*dx <= fma(-dy, dy, r2);
    `pred(dx (..., e, 1, S), dy (..., e, S, 1), r2 (..., e, 1, 1))` replaces
    it (a fan; it must cover nothing for r2 < 0). Entities are folded in
    chunks so the (..., E, S, S) tensor never exists whole."""
    S = wx.shape[-1]
    acc = torch.zeros(wx.shape[:-1] + (S, S), dtype=torch.bool,
                      device=wx.device)
    if pred is not None:
        chunk = min(chunk, 8)          # a fan takes float64 (e, S, S) temps
    for e0 in range(0, x.shape[-1], chunk):
        sl = slice(e0, e0 + chunk)
        dx = wx[..., None, :] - x[..., sl, None]                # (..., e, S)
        dy = wy[..., None, :] - y[..., sl, None]
        if pred is None:
            lim = fma32(-dy, dy, r2[..., sl, None])             # r2 - dy*dy
            cov = (dx * dx)[..., None, :] <= lim[..., :, None]
        else:
            cov = pred(dx[..., None, :], dy[..., :, None],
                       r2[..., sl, None, None])
        acc |= cov.any(-3)
    return acc


def strip_cover(wx, wy, x, y, r2, K: int, pred) -> torch.Tensor:
    """(n, S, S) bool coverage of entities (n, E) tested only on a window
    of K + 2 rows from one row below floor(y - r) (>= 1 row of slack at
    both ends, as the TPU kernel's strips): `pred(dx (n, E, 1, S),
    dy (n, E, R, 1), r2 (n, E, 1, 1))` on those rows, where dy takes the
    row's pixel centre from wy. Dead entities (r2 < 0) cover nothing."""
    n, S = wx.shape
    R = K + 2
    pitch = (wy[:, 1] - wy[:, 0])[:, None]
    r = torch.sqrt(torch.clamp(r2, min=0.0))
    base = torch.floor((y - r - wy[:, :1]) / pitch) - 1.0
    base = torch.clamp(base, -R, S).to(torch.int64)           # dead -> off
    rows = base[..., None] + torch.arange(R, device=wx.device)  # (n, E, R)
    ok = (rows >= 0) & (rows < S) & (r2 >= 0)[..., None]
    rows = rows.clamp(0, S - 1)
    dy = torch.gather(wy, 1, rows.reshape(n, -1)).reshape(rows.shape) \
        - y[..., None]
    dx = wx[:, None, :] - x[..., None]                          # (n, E, S)
    cov = pred(dx[:, :, None, :], dy[..., None], r2[..., None, None]) \
        & ok[..., None]
    acc = torch.zeros((n, S, S), dtype=torch.int32, device=wx.device)
    nidx = torch.arange(n, device=wx.device)[:, None, None].expand_as(rows)
    acc.index_put_((nidx, rows), cov.to(torch.int32), accumulate=True)
    return acc > 0


def _grid_cover(wx, wy, pixel_half, arena_w, arena_h):
    """(..., S, S) bool: the pixel lies on one of the 8x8 arena grid lines
    (renderables.hpp:245-340), inside the arena span."""
    r7 = _F32(1.0 / (_NUM_GRID_LINES - 1))
    k = torch.arange(_NUM_GRID_LINES, dtype=torch.float32, device=wx.device)
    xs = k * float(_F32(r7 * _F32(arena_w)))
    ys = k * float(_F32(r7 * _F32(arena_h)))
    ph = pixel_half[..., None, None]
    on_v = ((wx[..., None] - xs).abs() <= ph).any(-1)
    on_h = ((wy[..., None] - ys).abs() <= ph).any(-1)
    in_x = (wx >= float(_F32(-1e-3))) & (wx <= float(_F32(arena_w + 1e-3)))
    in_y = (wy >= float(_F32(-1e-3))) & (wy <= float(_F32(arena_h + 1e-3)))
    return ((on_v[..., None, :] | on_h[..., :, None])
            & in_x[..., None, :] & in_y[..., :, None])


def _take(state: GameState, sl: slice) -> GameState:
    return state.replace(**{f.name: getattr(state, f.name)[sl]
                            for f in dataclasses.fields(state)})


def _class_map(cfg: EnvConfig, state: GameState, S: int,
               polygon_edges: bool = False,
               polygon_virus: str = "wavy") -> torch.Tensor:
    """(N, A, S, S) uint8 class id per pixel, topmost in draw order;
    polygon_edges draws the fan silhouettes (module docstring), in chunks
    of _ENV_CHUNK envs."""
    N = state.cell_mass.shape[0]
    if polygon_edges and N > _ENV_CHUNK:
        return torch.cat([
            _class_map(cfg, _take(state, slice(n0, n0 + _ENV_CHUNK)), S,
                       True, polygon_virus)
            for n0 in range(0, N, _ENV_CHUNK)])
    A = cfg.num_agents
    N, P, Cc = state.cell_mass.shape
    centroid = state.player_centroid()[:, :A]
    pmass = state.player_mass()[:, :A].to(torch.float32)
    z = torch.clamp(fma32(pmass, float(_F32(0.1)), 100.0), 100.0, 900.0)
    wx, wy, half, ph = _pixel_world_coords(centroid, z, S)
    wx_strip = _coords(_idx(S, False, wx.device), half, centroid[..., 0])

    cls = torch.zeros((N, A, S, S), dtype=torch.uint8, device=wx.device)
    cls[_grid_cover(wx, wy, ph, cfg.arena_width, cfg.arena_height)] = 1

    def rows(v):
        return v[:, None].expand(N, A, v.shape[1])

    ppos, palive = state.pellet_xy_alive(cfg)
    foods = (state.food_pos, state.food_alive)
    for (pos, alive), rad, cid, sides in (
            ((ppos, palive), _RAD_PELLET, 2, SIDES_PELLET),
            (foods, _RAD_FOOD, 3, SIDES_FOOD)):
        r = _F32(rad)
        r2 = torch.where(alive, float(_F32(r * r)), -1.0)
        if polygon_edges:
            flat = (lambda v: rows(v).reshape(N * A, -1))
            cov = strip_cover(wx.reshape(N * A, S), wy.reshape(N * A, S),
                              flat(pos[..., 0]), flat(pos[..., 1]),
                              flat(r2), _strip_K(rad, S), fan_polar(sides))
            cls[cov.reshape(N, A, S, S)] = cid
        else:
            cls[cover(wx_strip, wy, rows(pos[..., 0]), rows(pos[..., 1]),
                      rows(r2))] = cid

    cell_pred = fan_polar(SIDES_CELL) if polygon_edges else None
    crad = radius(state.cell_mass)
    cr2 = torch.where(state.cell_alive, crad * crad, -1.0)   # (N, P, Cc)
    for a in range(A):
        mine = torch.arange(P, device=wx.device) == a
        for sel, cid in ((mine, 4), (~mine, 5)):
            x = state.cell_pos[:, sel, :, 0].reshape(N, -1)
            y = state.cell_pos[:, sel, :, 1].reshape(N, -1)
            r2 = cr2[:, sel].reshape(N, -1)
            if x.shape[1]:
                cls[:, a][cover(wx[:, a], wy[:, a], x, y, r2,
                                pred=cell_pred)] = cid

    wavy = polygon_edges and polygon_virus == "wavy"
    vrad = radius(state.virus_mass)
    vr2 = torch.where(state.virus_alive, vrad * vrad, -1.0)
    cls[cover(wx, wy, rows(state.virus_pos[..., 0]),
              rows(state.virus_pos[..., 1]), rows(vr2),
              pred=fan_polar(SIDES_VIRUS, True) if wavy else None)] = 6
    return cls


def _rgb565(rgb: np.ndarray) -> np.ndarray:
    """GL_RGB565 storage (FrameBufferObject.hpp:187): quantize to 5/6/5
    bits and expand back to 8."""
    rgb = np.asarray(rgb, np.int32)
    r, g, b = rgb[..., 0] >> 3, rgb[..., 1] >> 2, rgb[..., 2] >> 3
    return np.stack([(r << 3) | (r >> 2), (g << 2) | (g >> 4),
                     (b << 3) | (b >> 2)], axis=-1).astype(np.uint8)


# class colour tables (obs/screen.py)
_AGENT_VIEW_COLORS = np.asarray([
    [0, 0, 0, 0],        # background
    [0, 0, 0, 26],       # grid line
    [255, 0, 0, 0],      # pellet
    [255, 0, 0, 0],      # food
    [0, 0, 0, 230],      # main player
    [0, 255, 0, 0],      # other players
    [0, 0, 255, 0],      # virus
], dtype=np.uint8)

_NATURAL_COLORS = np.asarray([
    [255, 255, 255],     # background (white clear, renderer.hpp:174)
    [26, 0, 0],          # grid line
    [255, 0, 0],         # pellet
    [255, 0, 0],         # food
    [230, 0, 0],         # main player (0.9 red)
    [0, 255, 0],         # other players
    [0, 0, 255],         # virus
], dtype=np.uint8)


def palette(agent_view: bool) -> np.ndarray:
    """(7, 4|3) uint8 colour of each class (RGB565-quantized natural)."""
    return _AGENT_VIEW_COLORS if agent_view else _rgb565(_NATURAL_COLORS)


def _apply_palette(cls: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """(...) class ids -> (..., C) uint8 colours."""
    tab = torch.as_tensor(table, dtype=torch.uint8, device=cls.device)
    return tab[cls.long()]


def screen_frame(cfg: EnvConfig, ocfg: ScreenObsConfig,
                 state: GameState) -> torch.Tensor:
    """(N, A, S, S, 3|4) uint8 — one frame per env and agent, on the
    state's device (circle or fan silhouettes as ocfg says)."""
    global class_map_calls
    check_config(ocfg)
    class_map_calls += 1
    cls = _class_map(cfg, state, ocfg.screen_len, ocfg.polygon_edges,
                     ocfg.polygon_virus)
    return _apply_palette(cls, palette(ocfg.agent_view))


def render_rgb(cfg: EnvConfig, state: GameState, size: int = 512):
    """(N, size, size, 3) natural-colour render of agent 0's view, row 0 at
    the top (the rgb_array render mode, AgarioEnv.py:143-150)."""
    frame = screen_frame(cfg, ScreenObsConfig(screen_len=size), state)[:, 0]
    return frame.flip(1)

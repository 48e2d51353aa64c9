"""The port's polygon screens (the reference's triangle-fan silhouettes)
against the JAX package.

Two rasterizers, each held against its own JAX counterpart:
- the GameState route, obs/screen.py::_class_map(polygon_edges=True) with
  the polar radius factor, against the float64 fan oracle of
  tests/test_polygon_screen.py (the sandwich at eps = 1e-3, both virus
  modes) and against the XLA class map, with the JAX suite's own bar: a
  differing share below 2e-3 (the port takes the factor in float64, XLA in
  f32);
- the kernel form, ops/fused_screen.py::rasterize_plain(poly=True) (the
  plain version of K3's poly mode, half-plane row intervals), against the
  Pallas kernel with poly=True in interpret mode, pixel for pixel, on
  played states and on crafted sections that put fan edges a few ulps from
  pixel centres (they pin XLA's arithmetic forms).
VecEnv(backend="torch") on polygon configurations runs the kernel form
(polygon_virus="circle", held to the Pallas kernel) or the GameState route
(the wavy rim, held to the JAX VecEnv's frame function at the same 2e-3
bar)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_polygon_screen import check_class, pixel_grid

from agarcl_tpu import EnvConfig as JCfg
from agarcl_tpu import env_reset as j_reset
from agarcl_tpu import env_step as j_step
from agarcl_tpu.engine import geometry as JG
from agarcl_tpu.obs import screen as JS
from agarcl_tpu.ops import fused_screen as JFS
from agarcl_tpu.state import GameState as JState
from agarcl_tpu.state import encode_pellet_key
from agarcl_tpu_torch import EnvConfig as TCfg
from agarcl_tpu_torch.bridge import state_from_numpy, state_to_numpy
from agarcl_tpu_torch.obs import screen as TS
from agarcl_tpu_torch.ops import fused_screen as TFS
from agarcl_tpu_torch.ops import fused_step as TFstep
from agarcl_tpu_torch.ops.fused_tick import to_kernel_arrays
from agarcl_tpu_torch.vec import VecEnv as TVec

F32 = np.float32
DUEL = dict(num_agents=1, ticks_per_step=4, arena_size=120, num_pellets=64,
            num_viruses=4, num_bots=1, mode=7)
BAR = 2e-3            # tests/test_polygon_screen.py, polar vs half-plane


def _to_port(js):
    return state_from_numpy({f: np.asarray(getattr(js, f))
                             for f in js.__dataclass_fields__})


@functools.lru_cache(maxsize=None)
def _played():
    """(3,) duel states after 3 steps of splits, from masses 900 / 3000 /
    150 for the agent and 400 / 200 / 2500 for the bot: fans of 1-8 cells
    of every size, the bot drawn."""
    cfg = JCfg(**DUEL)
    js = jax.jit(jax.vmap(functools.partial(j_reset, cfg)))(
        jnp.arange(3, dtype=jnp.uint32) + 11)
    js = js.replace(cell_mass=js.cell_mass.at[:, :, 0].set(
        jnp.asarray([[900, 400], [3000, 200], [150, 2500]])))
    step = jax.jit(jax.vmap(functools.partial(j_step, cfg)))
    acts = jnp.tile(jnp.asarray([[0.6, -0.4, 2.0]], jnp.float32), (3, 1, 1))
    for _ in range(3):
        js, _, _ = step(js, acts)
    return js


ORACLE = dict(num_agents=1, ticks_per_step=1, arena_size=200,
              num_pellets=4, num_viruses=1, mode=4)


def _oracle_state():
    """The tests/test_polygon_screen.py scenario: one 400-mass cell at
    (100, 100) with pellets, foods and a virus well apart around it."""
    cfg = JCfg(**ORACLE)
    state = jax.jit(functools.partial(j_reset, cfg))(3)
    center = jnp.array([100.0, 100.0])
    ppos = state.pellet_xy_alive(cfg)[0]
    for i, d in enumerate(((14.0, 3.0), (-17.0, 6.0), (5.0, -19.0),
                           (-9.0, -13.0))):
        ppos = ppos.at[i].set(center + jnp.array(d))
    palive = jnp.zeros(ppos.shape[:1], bool).at[:4].set(True)
    fpos = state.food_pos.at[0].set(center + jnp.array([24.0, -7.0]))
    fpos = fpos.at[1].set(center + jnp.array([-26.0, -2.0]))
    return cfg, state.replace(
        cell_pos=state.cell_pos.at[0, 0].set(center),
        cell_mass=state.cell_mass.at[0, 0].set(400),
        pellet_key=encode_pellet_key(cfg, ppos, palive),
        food_pos=fpos, food_alive=jnp.zeros_like(state.food_alive).at[
            :2].set(True),
        virus_pos=state.virus_pos.at[0].set(center + jnp.array([0.0, 27.0])),
        virus_alive=jnp.zeros_like(state.virus_alive).at[0].set(True))


@pytest.mark.parametrize("virus", ["wavy", "circle"])
def test_class_map_vs_fan_oracle(virus):
    """The port's polygon class map covers every pixel of the fan shrunk
    by 1e-3 and none outside the fan grown by 1e-3: 5-gon pellets, 7-gon
    foods, the 50-gon cell, the wavy 150-gon virus (or a circle, held as
    a 1000-gon)."""
    cfg, state = _oracle_state()
    S = 128
    cls = TS._class_map(TCfg(**ORACLE), _to_port(jax.tree.map(
        lambda x: x[None], state)), S, True, virus).numpy()[0, 0]
    wx, wy = pixel_grid(cfg, state, 0, S)

    def rad(m):
        return float(np.asarray(JG.radius(jnp.float32(m))))

    check_class(cls, 2, wx, wy, [(np.asarray(state.pellet_xy_alive(cfg)[0])[
        i], rad(1.0)) for i in range(4)], 5)
    check_class(cls, 3, wx, wy, [(np.asarray(state.food_pos)[i], rad(10.0))
                                 for i in range(2)], 7)
    check_class(cls, 4, wx, wy, [(np.array([100.0, 100.0]), rad(400.0))], 50)
    vir = [(np.asarray(state.virus_pos)[0],
            float(np.asarray(JG.radius(state.virus_mass))[0]))]
    if virus == "wavy":
        check_class(cls, 6, wx, wy, vir, 150, wavy=True)
    else:
        check_class(cls, 6, wx, wy, vir, 1000)
    assert {2, 3, 4, 6}.issubset(set(np.unique(cls).tolist()))


@pytest.mark.parametrize("virus", ["wavy", "circle"])
def test_screen_frame_matches_xla_screen_frame(virus):
    """The port's polygon screen_frame (the GameState route, counted in
    class_map_calls) on played duel states against
    jax.jit(jax.vmap(screen_frame)) of the same states: differing share
    below 2e-3 (0 pixels differ here)."""
    js = _played()
    S = 48
    flags = dict(agent_view=True, polygon_edges=True, polygon_virus=virus)
    want = np.asarray(jax.jit(jax.vmap(functools.partial(
        JS.screen_frame, JCfg(**DUEL), JS.ScreenObsConfig(S, **flags))))(js))
    before = TS.class_map_calls
    got = TS.screen_frame(TCfg(**DUEL), TS.ScreenObsConfig(S, **flags),
                          _to_port(js)).numpy()
    assert TS.class_map_calls == before + 1
    diff = (got != want).any(-1)
    assert diff.mean() < BAR, int(diff.sum())
    assert int(diff.sum()) == 0
    colours = {tuple(c) for c in want.reshape(-1, 4).tolist()}
    assert {(255, 0, 0, 0), (0, 0, 0, 230), (0, 255, 0, 0),
            (0, 0, 255, 0)} <= colours


def _jax_sections(cfg, js, S):
    """The XLA build of the kernel's sections under jit, with the static
    arguments of _rasterize_sections."""
    secs = jax.jit(lambda st: JFS._build_table(
        cfg, S, st, _ablate="sections")[0])(js)
    return (secs, JFS._meta_offs(JFS.section_meta(cfg)),
            (cfg.num_players - 1) * cfg.max_cells, JFS._section_Ks(cfg, S))


@pytest.mark.parametrize("S", [32, 48])
def test_poly_rasterizer_matches_pallas_kernel(S):
    """rasterize_plain(poly=True) on the XLA-built sections against
    fused_screen_class_map(poly=True), the Pallas kernel in interpret mode
    (block_envs=1) on the same sections, pixel for pixel; then the port's
    own sections of the bridged states give the same frames."""
    js = _played()
    cfg = JCfg(**DUEL)
    secs = _jax_sections(cfg, js, S)[0]
    want = np.asarray(JFS.fused_screen_class_map(
        cfg, S, js, block_envs=1, interpret=True, poly=True))[:, 0]
    t = {k: torch.from_numpy(np.array(v)) for k, v in secs.items()}
    got = TFS.rasterize_plain(TCfg(**DUEL), S, t, poly=True).numpy()
    np.testing.assert_array_equal(got, want)
    assert {2, 4, 5, 6}.issubset(set(np.unique(want).tolist()))
    ocfg = TS.ScreenObsConfig(S, agent_view=True, polygon_edges=True,
                              polygon_virus="circle")
    frames = TFS.frame_plain(TCfg(**DUEL), ocfg,
                             to_kernel_arrays(_to_port(js))).numpy()
    np.testing.assert_array_equal(frames[:, 0], TS.palette(True)[want])
    circle = TFS.rasterize_plain(TCfg(**DUEL), S, t).numpy()
    assert (circle != want).sum() > 0                  # the fans differ


# ------------------------------------------- crafted fan-edge boundaries
def _fma(a, b, c):
    a, b, c = np.broadcast_arrays(np.float64(a), np.float64(b),
                                  np.float64(c))
    return (a * b + c).astype(F32)


def _idx(S, fused):
    t = (np.arange(S, dtype=F32) + F32(0.5)) * F32(2.0)
    rc = F32(1.0 / S)
    return _fma(t, rc, F32(-1)) if fused else (t * rc - F32(1)).astype(F32)


def _bounds(dy, r, n_sides, fused_line):
    """numpy f32 fan row bounds; fused_line takes c2*r - b*dy as one fma
    (the form XLA does not use here)."""
    rights, lefts, flats, c2 = TFS.fan_lines(n_sides)
    c2r = (F32(c2) * r).astype(F32)
    xhi = np.full(np.broadcast(dy, r).shape, F32(3e38), F32)
    xlo = np.full_like(xhi, F32(-3e38))

    def line(ia, b):
        v = (_fma(-F32(b), dy, c2r) if fused_line
             else (c2r - (F32(b) * dy).astype(F32)).astype(F32))
        return (v * F32(ia)).astype(F32)
    for ia, b in rights:
        xhi = np.minimum(xhi, line(ia, b))
    for ia, b in lefts:
        xlo = np.maximum(xlo, line(ia, b))
    for b in flats:
        xlo = np.where((F32(b) * dy).astype(F32) > c2r, F32(3e38), xlo)
    return xlo, xhi


# (fused rows, fused columns, fused line): the pinned form, then the
# alternatives the crafted sections must tell apart
FORMS = [(True, True, False), (True, True, True), (False, True, False),
         (True, False, False)]


def _covered(form, tabs, i, j, x, y, r, n_sides, absolute):
    """Coverage of pixel (row j, column i) by the fan at (x, y) in `form`
    (numpy, per element of the arrays)."""
    rowf, colf, fl = form
    wx, wy = tabs[colf][0][i], tabs[rowf][1][j]
    xlo, xhi = _bounds((wy - y).astype(F32), r, n_sides, fl)
    if absolute:
        return ((wx >= (xlo + x).astype(F32))
                & (wx <= (xhi + x).astype(F32)))
    dx = (wx - x).astype(F32)
    return (dx >= xlo) & (dx <= xhi)


def _edge_fan(rng, tabs, r, n_sides, alt, absolute):
    """(x, y) of a fan of radius r with one pixel centre a few ulps from an
    edge, placed (when it can be) where the pinned form and FORMS[alt]
    disagree on that pixel."""
    S = tabs[True][0].size
    d = 2 * np.pi / n_sides
    phi = (np.arange(n_sides) + 1.5) * d
    a, b = np.cos(phi), np.sin(phi)
    keep = np.abs(a) >= 1e-9
    a, b = a[keep], b[keep]
    for _ in range(8):
        i, j = rng.integers(2, S - 2, 2)
        y = F32(tabs[True][1][j] - F32(rng.uniform(-0.95, 0.95) * r))
        dy = float(F32(tabs[True][1][j] - y))
        v = (np.cos(np.pi / n_sides) * float(r) - b * dy) / a
        edge = v[a > 0].min() if rng.random() < 0.5 else v[a < 0].max()
        x0 = F32(tabs[True][0][i] - edge)
        cand = (x0 + np.arange(-12, 13) * np.spacing(x0)).astype(F32)
        cov = [_covered(FORMS[f], tabs, i, j, cand, y, F32(r), n_sides,
                        absolute) for f in (0, alt)]
        apart = np.flatnonzero(cov[0] != cov[1])
        if apart.size:
            return cand[apart[0]], y
    return x0, y


def test_poly_arithmetic_matches_pallas_on_crafted_boundaries():
    """Sections that put pixel centres within a few ulps of the edge of a
    pellet (5-gon), a food (7-gon), an own or another player's cell
    (50-gon): rasterize_plain(poly=True) reproduces the Pallas kernel in
    interpret mode pixel for pixel, and each alternative form (the line
    c2*r - b*dy as one fma, two-step pixel rows, two-step pixel columns)
    misses pixels."""
    rng = np.random.default_rng(7)
    cfg = JCfg(**dict(DUEL, num_pellets=80))
    S, n = 41, 8
    meta = JFS.section_meta(cfg)
    secs = {name: np.full((n, pw), fill, F32) for name, _, pw, fill in meta}
    half = rng.uniform(41.4, 120.0, n).astype(F32)
    cam = rng.uniform(40.0, 80.0, (n, 2)).astype(F32)
    secs["params"][:, 0], secs["params"][:, 1] = cam[:, 0], cam[:, 1]
    secs["params"][:, 2] = half
    tabs = [{f: (_fma(_idx(S, f), half[e], cam[e, 0]),
                 _fma(_idx(S, f), half[e], cam[e, 1])) for f in (True, False)}
            for e in range(n)]
    rp2 = F32(F32(TS._RAD_PELLET) ** 2)
    rf2 = F32(F32(TS._RAD_FOOD) ** 2)
    for e in range(n):            # 0-1 pellets, 2-3 foods, 4-5 own, 6-7 other
        if e < 4:
            pre, r2, sides, E = (("p", rp2, 5, 60) if e < 2
                                 else ("f", rf2, 7, 40))
            r2 = np.full(E, r2, F32)
        else:
            pre, sides, E = ("m" if e < 6 else "o"), 50, 16
            r2 = rng.uniform(20.0, 300.0, E).astype(F32)
        for k in range(E):
            r = F32(np.sqrt(np.float64(r2[k])))
            secs[pre + "x"][e, k], secs[pre + "y"][e, k] = _edge_fan(
                rng, tabs[e], r, sides, 1 + k % (len(FORMS) - 1), e >= 4)
        secs[pre + "r2"][e, :E] = r2
    want = np.asarray(JFS._rasterize_sections(
        cfg, S, {k: jnp.asarray(v) for k, v in secs.items()},
        JFS._meta_offs(meta), 16, JFS._section_Ks(cfg, S), block_envs=1,
        interpret=True, poly=True))
    got = TFS.rasterize_plain(TCfg(**dict(DUEL, num_pellets=80)), S, {
        k: torch.from_numpy(v) for k, v in secs.items()}, poly=True).numpy()
    np.testing.assert_array_equal(got, want)
    for form in FORMS[1:]:
        miss = 0
        for e in range(n):
            pre, sides, cid = [("p", 5, 2), ("f", 7, 3), ("m", 50, 4),
                               ("o", 50, 5)][e // 2]
            live = secs[pre + "r2"][e] >= 0
            x, y, r2 = (secs[pre + c][e][live] for c in ("x", "y", "r2"))
            r = np.sqrt(r2.astype(np.float64)).astype(F32)
            jj, ii = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
            cov = np.zeros((S, S), bool)
            for k in range(x.size):
                cov |= _covered(form, tabs[e], ii, jj, x[k], y[k], r[k],
                                sides, e >= 4)
            miss += int((cov != (want[e] == cid)).sum())
        assert miss > 0, form


# -------------------------------------------------------- VecEnv routes
def _polygon_env(virus, n, S):
    ocfg = TS.ScreenObsConfig(S, agent_view=True, polygon_edges=True,
                              polygon_virus=virus)
    return TVec(TCfg(**DUEL), n, "screen", backend="torch", device="cpu",
                obs_config=ocfg)


ACTS = np.tile(np.asarray([[0.6, -0.4, 0.0]], np.float32), (4, 1, 1))


def test_vecenv_wavy_route_matches_xla_screen_frame():
    """VecEnv(backend="torch") with the wavy virus rim takes the GameState
    route (obs/screen.py::screen_frame, counted in class_map_calls; no
    kernel-form call): its frames of the last step against
    jax.jit(jax.vmap(screen_frame)) of the same states, the JAX VecEnv's
    frame function, within the 2e-3 differing share."""
    n, S = 4, 32
    tenv = _polygon_env("wavy", n, S)
    assert TFstep.frame_kernel(tenv.ocfg)[0] is TFS.class_map_frame
    before = TS.class_map_calls, TFS.plain_calls
    ts, tobs = tenv.reset(3)
    ts, to, tr, td = tenv.multi_step(ts, ACTS, 2)
    assert (TS.class_map_calls - before[0], TFS.plain_calls - before[1]) \
        == (3, 0)
    assert tuple(tobs.shape) == (n, 1, S, S, 4)
    assert tuple(to.shape) == (2, n, 1, 1, S, S, 4)
    want = np.asarray(jax.jit(jax.vmap(functools.partial(
        JS.screen_frame, JCfg(**DUEL), JS.ScreenObsConfig(
            S, agent_view=True, polygon_edges=True))))(
        JState(**jax.tree.map(jnp.asarray, state_to_numpy(ts)))))
    diff = (to[-1, :, 0].numpy() != want).any(-1)
    assert diff.mean() < BAR, int(diff.sum())
    assert (want[..., 2] == 255).any()                  # viruses drawn
    np.testing.assert_array_equal(
        TFS.class_map_frame(TCfg(**DUEL), tenv.ocfg,
                            to_kernel_arrays(ts)).numpy(),
        TS.screen_frame(TCfg(**DUEL), tenv.ocfg, ts).numpy())


def test_vecenv_polygon_kernel_route_matches_pallas():
    """VecEnv(backend="torch") with polygon_virus="circle" takes the kernel
    form (frame_plain in poly mode; no GameState route): its last frames
    equal the Pallas kernel's with poly=True (interpret mode) on the same
    states, the route the JAX package's fused steps take."""
    n, S = 4, 32
    tenv = _polygon_env("circle", n, S)
    assert TFstep.frame_kernel(tenv.ocfg)[0] is TFS.fused_screen_frame
    before = TS.class_map_calls, TFS.plain_calls
    ts, tobs = tenv.reset(3)
    ts, to, tr, td = tenv.multi_step(ts, ACTS, 2)
    assert (TS.class_map_calls - before[0], TFS.plain_calls - before[1]) \
        == (0, 3)
    assert tuple(tobs.shape) == (n, 1, S, S, 4)
    assert tuple(to.shape) == (2, n, 1, 1, S, S, 4)
    jstate = jax.tree.map(jnp.asarray, state_to_numpy(ts))
    want = JFS.fused_screen_frame(JCfg(**DUEL), JS.ScreenObsConfig(
        S, agent_view=True, polygon_edges=True, polygon_virus="circle"),
        JState(**jstate), block_envs=1, interpret=True)
    np.testing.assert_array_equal(to[-1, :, 0].numpy(), np.asarray(want))


def test_large_polygon_screens_take_the_class_map_route():
    """Polygon screens beyond 128 pixels go through the GameState route
    even with circle viruses, as the JAX package routes them; a config no
    route takes raises."""
    big = TS.ScreenObsConfig(160, polygon_edges=True, polygon_virus="circle")
    assert not TFS.supports_polygon(big)
    assert TFstep.frame_kernel(big)[0] is TFS.class_map_frame
    assert TFS.supports_polygon(TS.ScreenObsConfig(
        128, polygon_edges=True, polygon_virus="circle"))
    with pytest.raises(ValueError, match="polygon_virus"):
        TVec(TCfg(**DUEL), 2, "screen", backend="torch", device="cpu",
             obs_config=TS.ScreenObsConfig(32, polygon_edges=True,
                                           polygon_virus="oval"))


def test_kernel_path_compositions_route_wavy_screens():
    """The cuda backend's step compositions on CPU planes (the wrappers
    take their plain versions there): multi_step_resident and
    fused_env_step send wavy-rim frames through class_map_frame, with the
    frames of the torch backend's GameState route."""
    n, S = 3, 24
    tenv = _polygon_env("wavy", n, S)
    cfg, ocfg = TCfg(**DUEL), tenv.ocfg
    s0, _ = tenv.reset(5)
    acts = torch.from_numpy(ACTS[:n])
    _, want, _, _ = tenv.multi_step(s0, acts, 2)
    before = TS.class_map_calls, TFS.plain_calls
    res, obs, _, _ = TFstep.multi_step_resident(
        cfg, TFstep.to_resident(cfg, s0), acts, 2, ocfg)
    s1, obs1, _, _ = TFstep.fused_env_step(cfg, s0, acts, ocfg)
    assert (TS.class_map_calls - before[0], TFS.plain_calls - before[1]) \
        == (3, 0)
    assert torch.equal(obs, want) and torch.equal(obs1, want[0])

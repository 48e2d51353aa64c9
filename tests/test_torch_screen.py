"""The port's screen path against the JAX package: the plain rasterizer
(ops/fused_screen.py::rasterize_plain, the plain version of the screen
kernel) on the JAX package's own sections against its Pallas kernel in
interpret mode and its XLA class map; the section build against the XLA
build; obs/screen.py::screen_frame against the XLA screen_frame; and
VecEnv(obs_type="screen", backend="torch") against the XLA VecEnv."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agarcl_tpu import EnvConfig as JCfg
from agarcl_tpu import env_reset as j_reset
from agarcl_tpu import env_step as j_step
from agarcl_tpu.obs import screen as JS
from agarcl_tpu.ops import fused_screen as JFS
from agarcl_tpu.state import encode_pellet_key
from agarcl_tpu.vec import VecEnv as JVec
from agarcl_tpu_torch import EnvConfig as TCfg
from agarcl_tpu_torch.bridge import state_from_numpy, state_to_numpy
from agarcl_tpu_torch.obs import screen as TS
from agarcl_tpu_torch.ops import fused_screen as TFS
from agarcl_tpu_torch.ops.fused_tick import to_kernel_arrays
from agarcl_tpu_torch.vec import VecEnv as TVec
from test_torch_vec import assert_same_state, xla_step_chain

SOLO = dict(num_agents=1, ticks_per_step=2, arena_size=120, num_pellets=80,
            num_viruses=4, num_bots=0, mode=4)
DUEL = dict(num_agents=1, ticks_per_step=2, arena_size=120, num_pellets=80,
            num_viruses=4, mode=7)
N = 6


def _played(kw, seed, steps, split=False, n=N):
    """(n,) vmapped JAX states after random actions (splits and feeds);
    `split` starts the agents at mass 400 and splits every step, so each
    ends with 2-10 cells."""
    cfg = JCfg(**kw)
    step = jax.jit(jax.vmap(functools.partial(j_step, cfg)))
    states = jax.jit(jax.vmap(functools.partial(j_reset, cfg)))(
        jnp.arange(n, dtype=jnp.uint32) + seed)
    if split:
        states = states.replace(cell_mass=states.cell_mass.at[:, 0, 0].set(
            400))
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        act = (np.full((n, 1, 1), 2) if split
               else rng.integers(0, 3, (n, 1, 1)))
        acts = np.concatenate([rng.uniform(-1, 1, (n, 1, 2)), act], -1)
        states, _, _ = step(states, jnp.asarray(acts, jnp.float32))
    return states


@functools.lru_cache(maxsize=None)
def _states(name):
    if name == "split":
        return _played(SOLO, 5, 4, split=True, n=64)
    return _played(SOLO, 3, 8) if name == "solo" else _played(DUEL, 7, 8)


def _to_port(js):
    return state_from_numpy({f: np.asarray(getattr(js, f))
                             for f in js.__dataclass_fields__})


def _jax_sections(kw, js, S):
    """The XLA build of the kernel's sections under jit, as the JAX package
    runs it (eagerly, XLA divides by pi where under jit it multiplies by
    f32(1/pi), and the cell radii differ by an ulp)."""
    cfg = JCfg(**kw)
    _, offs, n_other, Ks = jax.eval_shape(
        lambda st: JFS._build_table(cfg, S, st, _ablate="sections"), js)
    secs = jax.jit(lambda st: JFS._build_table(
        cfg, S, st, _ablate="sections")[0])(js)
    return secs, offs, n_other, Ks


def _plain_packed(kw, secs, S, agent_view):
    t = {k: torch.from_numpy(np.array(v)) for k, v in secs.items()}
    out = TFS.rasterize_plain(TCfg(**kw), S, t,
                              TFS._packed_palette(agent_view))
    return out.numpy()


def test_packed_palettes_match():
    for av in (True, False):
        assert TFS._packed_palette(av) == JFS._packed_palette(av)
    np.testing.assert_array_equal(TS._AGENT_VIEW_COLORS,
                                  np.asarray(JS._AGENT_VIEW_COLORS))
    np.testing.assert_array_equal(
        TS.palette(False), np.asarray(JS._rgb565(JS._NATURAL_COLORS)))


def test_rasterizer_matches_pallas_kernel_with_a_bot():
    """Class 5 (the bot's cells) included; both palettes through the
    kernel's packed output (T6 via fused_screen_frame, agent view, then T7
    via _rasterize_table, natural)."""
    js = _states("duel")
    cfg = JCfg(**DUEL)
    S = 41
    got = np.asarray(JFS.fused_screen_frame(
        cfg, JS.ScreenObsConfig(S, agent_view=True), js, block_envs=1,
        interpret=True))[:, 0]
    secs, offs, n_other, Ks = _jax_sections(DUEL, js, S)
    mine = _plain_packed(DUEL, secs, S, True).view(np.uint8).reshape(
        N, S, S, 4)
    np.testing.assert_array_equal(mine, got)
    assert (got[..., 1] == 255).any()                  # other player drawn
    S = 84
    tab, offs, n_other, Ks = JFS._build_table(cfg, S, js)
    packed = np.asarray(JFS._rasterize_table(
        cfg, S, tab, offs, n_other, Ks, block_envs=1, interpret=True,
        packed_table=JFS._packed_palette(False)))
    secs, _, _, _ = _jax_sections(DUEL, js, S)
    np.testing.assert_array_equal(_plain_packed(DUEL, secs, S, False),
                                  packed)


@pytest.mark.parametrize("name,S", [
    (name, S) for name in ("solo", "duel") for S in (32, 41, 84, 128)]
    + [("split", 41), ("split", 84)])
def test_rasterizer_matches_xla_class_map(name, S):
    """rasterize_plain on the XLA-built sections against the XLA
    rasterizer (obs/screen.py::_class_map) on the same states."""
    kw = DUEL if name == "duel" else SOLO
    js = _states(name)
    if S == 128:
        js = jax.tree.map(lambda x: x[:2], js)
    secs, _, _, _ = _jax_sections(kw, js, S)
    cls = np.asarray(jax.jit(jax.vmap(functools.partial(
        JS._class_map, JCfg(**kw), S=S)))(js))[:, 0]
    t = {k: torch.from_numpy(np.array(v)) for k, v in secs.items()}
    mine = TFS.rasterize_plain(TCfg(**kw), S, t).numpy()
    np.testing.assert_array_equal(mine, cls)
    assert {1, 2, 4}.issubset(set(np.unique(cls).tolist()))


@pytest.mark.parametrize("name", ["solo", "duel", "split"])
def test_screen_sections_match_xla_build(name):
    """The port's section emission on bridged states against the XLA build:
    the same camera (bit for bit for one-cell players; for players of 2-10
    cells, whose centroid sums run in slot order here and in XLA's order
    there, within two ulps), identical live lanes (the XLA build compacts the
    own and other cell rows alive-first, the emission keeps slot order),
    every dead lane at r2 = -1; the frames of both builds are equal."""
    kw = DUEL if name == "duel" else SOLO
    js = _states(name)
    n = js.ticks.shape[0]
    S = 64
    jsec = {k: np.asarray(v) for k, v in _jax_sections(kw, js, S)[0].items()}
    tsec = {k: v.numpy() for k, v in TFS.screen_sections(
        TCfg(**kw), to_kernel_arrays(_to_port(js))).items()}
    meta = TFS.section_meta(TCfg(**kw))
    assert [(n, pw) for n, _, pw, _ in meta] == [
        (n, pw) for n, _, pw, _ in JFS.section_meta(JCfg(**kw))]
    assert {k: v.shape for k, v in tsec.items()} == {
        k: v.shape for k, v in jsec.items()}
    if name == "split":
        assert (np.asarray(js.cell_alive)[:, 0].sum(-1) >= 2).all()
        np.testing.assert_array_max_ulp(tsec["params"][:, :2],
                                        jsec["params"][:, :2], maxulp=2)
        assert (tsec["params"][:, :2] != jsec["params"][:, :2]).any()
        np.testing.assert_array_equal(tsec["params"][:, 2],
                                      jsec["params"][:, 2])
    else:
        np.testing.assert_array_equal(tsec["params"][:, :3],
                                      jsec["params"][:, :3])
    for c in ("p", "f", "v"):
        r2 = tsec[c + "r2"]
        np.testing.assert_array_equal(r2, jsec[c + "r2"])
        live = r2 >= 0
        for ax in "xy":
            np.testing.assert_array_equal(tsec[c + ax][live],
                                          jsec[c + ax][live])
        if c != "f":                              # parked, as the tick's
            assert (tsec[c + "x"][~live] == 1e9).all()
    st = state_to_numpy(_to_port(js))
    for c, players in (("m", [0]), ("o", [1])):
        if c == "o" and kw["mode"] != 7:
            continue
        alive = st["cell_alive"][:, players].reshape(n, -1)
        top = np.where(alive, np.arange(1, alive.shape[1] + 1), 0).max(1)
        np.testing.assert_array_equal(tsec["params"][:, 3 if c == "m" else 4],
                                      top)
        for e in range(n):
            t_live = tsec[c + "r2"][e] >= 0
            cnt = int(t_live.sum())
            assert cnt == alive[e].sum()
            for s in ("x", "y", "r2"):
                np.testing.assert_array_equal(tsec[c + s][e][t_live],
                                              jsec[c + s][e][:cnt])
            assert (jsec[c + "r2"][e][cnt:] < 0).all()
    frames = [TFS.rasterize_plain(TCfg(**kw), S, {
        k: torch.from_numpy(v.copy()) for k, v in sec.items()}).numpy()
        for sec in (tsec, jsec)]
    np.testing.assert_array_equal(frames[0], frames[1])


F32 = np.float32


def _fma(a, b, c):
    a, b, c = np.broadcast_arrays(np.float64(a), np.float64(b),
                                  np.float64(c))
    return (a * b + c).astype(F32)


def _idx(S, fused):
    t = (np.arange(S, dtype=F32) + F32(0.5)) * F32(2.0)
    rc = F32(1.0 / S)
    return _fma(t, rc, F32(-1)) if fused else (t * rc - F32(1)).astype(F32)


def _near_boundary(rng, wx, wy, r2):
    """Entity centres (n, E) that put one pixel centre each within two
    ulps of the circle's edge for the pixel-centre tables wx, wy (n, S)."""
    n, E = r2.shape
    S = wx.shape[1]
    i, j = rng.integers(2, S - 2, (2, n, E))
    rows = np.arange(n)[:, None]
    dy = (rng.uniform(-0.95, 0.95, (n, E)) * np.sqrt(r2)).astype(F32)
    y = (wy[rows, j] - dy).astype(F32)
    dyv = (wy[rows, j] - y).astype(np.float64)
    dx = np.sqrt(np.maximum(np.float64(r2) - dyv ** 2, 0)).astype(F32)
    x = (wx[rows, i] - dx).astype(F32)
    x = (x + rng.integers(-2, 3, (n, E)) * np.spacing(x)).astype(F32)
    return x, y


def _written_order_map(secs, S, W, n_lines=8):
    """Class map of sections with every expression evaluated as written
    (true division, no fma): the form XLA does not use."""
    idx = ((np.arange(S, dtype=F32) + F32(0.5)) * F32(2.0) / F32(S)
           - F32(1)).astype(F32)
    cx, cy, half = (secs["params"][:, k:k + 1] for k in range(3))
    wx, wy = (cx + idx * half).astype(F32), (cy + idx * half).astype(F32)
    ph = (half / F32(S)).astype(F32)[..., None]
    xs = np.asarray([F32(k) / F32(7) * F32(W) for k in range(n_lines)], F32)
    on_v = (np.abs(wx[..., None] - xs) <= ph).any(-1)
    on_h = (np.abs(wy[..., None] - xs) <= ph).any(-1)
    ins = lambda w: (w >= F32(-1e-3)) & (w <= F32(W + 1e-3))
    cls = ((on_v[:, None, :] | on_h[:, :, None]) & ins(wx)[:, None, :]
           & ins(wy)[:, :, None]).astype(np.uint8)
    for c, cid in (("p", 2), ("f", 3), ("m", 4), ("v", 6)):
        dx = wx[:, None, None, :] - secs[c + "x"][:, :, None, None]
        dy = wy[:, None, :, None] - secs[c + "y"][:, :, None, None]
        lim = (secs[c + "r2"][:, :, None, None] - dy * dy).astype(F32)
        cls[((dx * dx).astype(F32) <= lim).any(1)] = cid
    return cls


def test_rasterizer_arithmetic_matches_pallas_on_crafted_boundaries():
    """Sections that put pixel centres within two ulps of an own cell's,
    a pellet's or a virus's edge, or of a grid line's half-width: the plain
    rasterizer's f32 forms (ops/fused_screen.py docstring) reproduce the
    Pallas kernel in interpret mode pixel for pixel, and the forms as
    written do not."""
    rng = np.random.default_rng(11)
    cfg = JCfg(**SOLO)
    S, n = 41, 8
    meta = JFS.section_meta(cfg)
    secs = {name: np.full((n, pw), fill, F32) for name, _, pw, fill in meta}
    half = rng.uniform(41.4, 120.0, n).astype(F32)
    cam = rng.uniform(40.0, 80.0, (n, 2)).astype(F32)
    cell = (lambda c: _fma(_idx(S, False)[None], half[:, None], c[:, None]))
    strip = (lambda c: _fma(_idx(S, True)[None], half[:, None], c[:, None]))
    # envs 6-7: a grid line (x = 0) at the half-width's edge of a column
    rc = F32(1.0 / S)
    for e in (6, 7):
        j = S - 3
        c0 = F32(half[e] * rc - _idx(S, False)[j] * half[e])
        cs = (c0 + np.arange(-200, 201) * np.spacing(c0)).astype(F32)
        w = _fma(_idx(S, False)[j], half[e], cs)
        cam[e, 0] = cs[np.argmin(np.abs(np.abs(w) - half[e] * rc))]
    secs["params"][:, 0], secs["params"][:, 1] = cam[:, 0], cam[:, 1]
    secs["params"][:, 2] = half
    wxc, wyc = cell(cam[:, 0]), cell(cam[:, 1])
    wxs, wys = strip(cam[:, 0]), strip(cam[:, 1])
    r2 = rng.uniform(20.0, 300.0, (2, 16)).astype(F32)
    secs["mx"][:2, :16], secs["my"][:2, :16] = _near_boundary(
        rng, wxc[:2], wyc[:2], r2)
    secs["mr2"][:2, :16] = r2
    rp2 = np.full((2, 60), F32(F32(JS._RAD_PELLET) ** 2), F32)
    secs["px"][2:4, :60], secs["py"][2:4, :60] = _near_boundary(
        rng, wxs[2:4], wys[2:4], rp2)
    secs["pr2"][2:4, :60] = rp2
    vr2 = rng.uniform(31.0, 54.0, (2, 20)).astype(F32)
    secs["vx"][4:6, :20], secs["vy"][4:6, :20] = _near_boundary(
        rng, wxs[4:6], wys[4:6], vr2)
    secs["vr2"][4:6, :20] = vr2
    want = np.asarray(JFS._rasterize_sections(
        cfg, S, {k: jnp.asarray(v) for k, v in secs.items()},
        JFS._meta_offs(meta), 0, JFS._section_Ks(cfg, S), block_envs=1,
        interpret=True))
    got = TFS.rasterize_plain(TCfg(**SOLO), S, {
        k: torch.from_numpy(v) for k, v in secs.items()}).numpy()
    np.testing.assert_array_equal(got, want)
    written = _written_order_map(secs, S, cfg.arena_width)
    assert (written != want).sum() > 0


def test_class_map_arithmetic_matches_xla_on_crafted_boundaries():
    """States that put pixel centres within two ulps of a virus's or a
    food's edge, or of a grid line's half-width: obs/screen.py's f32 forms
    (its docstring) reproduce the XLA class map pixel for pixel."""
    rng = np.random.default_rng(12)
    kw = dict(SOLO, arena_size=350, num_viruses=10)
    cfg = JCfg(**kw)
    S, n = 41, 8
    js = jax.jit(jax.vmap(functools.partial(j_reset, cfg)))(
        jnp.arange(n, dtype=jnp.uint32))
    mass = rng.integers(25, 3000, n).astype(np.int32)
    w = mass.astype(F32)
    cam = rng.uniform(80.0, 270.0, (n, 2)).astype(F32)
    z = np.clip(_fma(w, F32(0.1), F32(100)), F32(100), F32(900))
    half = (z * F32(JS._TAN_HALF_FOV)).astype(F32)
    ph = (z * F32(F32(JS._TAN_HALF_FOV) * F32(1.0 / S))).astype(F32)
    line = F32(F32(F32(1.0 / 7) * F32(350.0)) * F32(3))
    for e in (6, 7):                       # x = 150 at a column's edge
        j = S // 2 + 3
        c0 = F32(line + ph[e] - _idx(S, True)[j] * half[e])
        cs = (c0 + np.arange(-200, 201) * np.spacing(c0)).astype(F32)
        wj = _fma(_idx(S, True)[j], half[e], (cs * w[e]).astype(F32) / w[e])
        cam[e, 0] = cs[np.argmin(np.abs(np.abs(wj - line) - ph[e]))]
    centre = ((cam * w[:, None]).astype(F32) / w[:, None]).astype(F32)
    grid_x = _fma(_idx(S, True)[None], half[:, None], centre[:, :1])
    grid_y = _fma(_idx(S, True)[None], half[:, None], centre[:, 1:])
    strip_x = _fma(_idx(S, False)[None], half[:, None], centre[:, :1])
    Nv = js.virus_mass.shape[1]
    vm = rng.integers(100, 171, (n, Nv)).astype(np.int32)
    vrad = np.sqrt((vm.astype(F32) * F32(1 / np.pi)).astype(np.float64))
    vr2 = (vrad.astype(F32) ** 2).astype(F32)
    vx, vy = _near_boundary(rng, grid_x, grid_y, vr2)
    valive = np.zeros((n, Nv), bool)
    valive[:4] = True
    Nf = js.food_pos.shape[1]
    rf2 = np.full((n, 40), F32(F32(JS._RAD_FOOD) ** 2), F32)
    fx, fy = _near_boundary(rng, strip_x, grid_y, rf2)
    fpos = np.zeros((n, Nf, 2), F32)
    fpos[:, :40, 0], fpos[:, :40, 1] = fx, fy
    falive = np.zeros((n, Nf), bool)
    falive[4:6, :40] = True
    cp = np.asarray(js.cell_pos).copy()
    cp[:, 0, 0] = cam
    cm = np.asarray(js.cell_mass).copy()
    cm[:, 0, 0] = mass
    js = js.replace(cell_pos=jnp.asarray(cp), cell_mass=jnp.asarray(cm),
                    virus_pos=jnp.asarray(np.stack([vx, vy], -1)),
                    virus_mass=jnp.asarray(vm),
                    virus_alive=jnp.asarray(valive),
                    food_pos=jnp.asarray(fpos),
                    food_alive=jnp.asarray(falive),
                    pellet_key=jnp.full_like(js.pellet_key, -1))
    want = np.asarray(jax.jit(jax.vmap(functools.partial(
        JS._class_map, cfg, S=S)))(js))
    got = TS._class_map(TCfg(**kw), _to_port(js), S).numpy()
    np.testing.assert_array_equal(got, want)
    assert {1, 3, 4, 6}.issubset(set(np.unique(want).tolist()))


def _oracle_scenarios():
    """The test_screen_oracle scenarios: the boundary cross (S=41, 84) and
    the big mode-6 player (S=64), as (kw, unbatched JAX state, S)."""
    kw = dict(num_agents=1, ticks_per_step=1, arena_size=100, num_pellets=4,
              num_viruses=1, mode=4)
    cfg = JCfg(**kw)
    state = jax.jit(functools.partial(j_reset, cfg))(2)
    center = jnp.array([50.0, 50.0])
    ppos = state.pellet_xy_alive(cfg)[0]
    for i, d in enumerate(((0.9, 0.0), (-0.49, 0.0), (0.0, 3.0),
                           (20.0, 20.0))):
        ppos = ppos.at[i].set(center + jnp.array(d))
    palive = jnp.zeros(ppos.shape[:1], bool).at[:4].set(True)
    cross = state.replace(
        cell_pos=state.cell_pos.at[0, 0].set(center),
        pellet_key=encode_pellet_key(cfg, ppos, palive),
        virus_pos=state.virus_pos.at[0].set(center + jnp.array([10.0, -4.0])),
        virus_alive=jnp.zeros_like(state.virus_alive).at[0].set(True))
    big_kw = dict(num_agents=1, ticks_per_step=2, arena_size=200,
                  num_pellets=40, num_viruses=3, mode=6)
    bcfg = JCfg(**big_kw)
    big = jax.jit(functools.partial(j_reset, bcfg))(5)
    step = jax.jit(functools.partial(j_step, bcfg))
    rng = np.random.default_rng(5)
    for _ in range(6):
        acts = np.zeros((1, 3), np.float32)
        acts[:, :2] = rng.uniform(-1, 1, (1, 2))
        acts[:, 2] = rng.integers(0, 3, 1)
        big, _, _ = step(big, acts)
    return [(kw, cross, 41), (kw, cross, 84), (big_kw, big, 64)]


def test_screen_frame_matches_xla_on_oracle_scenarios():
    for kw, js, S in _oracle_scenarios():
        ts = _to_port(jax.tree.map(lambda x: x[None], js))
        for av in (False, True):
            ocfg_j = JS.ScreenObsConfig(screen_len=S, agent_view=av)
            want = np.asarray(jax.jit(functools.partial(
                JS.screen_frame, JCfg(**kw), ocfg_j))(js))
            got = TS.screen_frame(TCfg(**kw), TS.ScreenObsConfig(S, av), ts)
            np.testing.assert_array_equal(got[0].numpy(), want)
        if kw["mode"] == 6:
            assert (want[0, ..., 3] == 230).sum() > 100   # big main cell
    rgb = TS.render_rgb(TCfg(**kw), ts, size=32)
    np.testing.assert_array_equal(rgb[0].numpy(), np.asarray(jax.jit(
        functools.partial(JS.render_rgb, JCfg(**kw), size=32))(js)))


def _compare(j_out, t_out, js, ts):
    (jo, jr, jd), (to, tr, td) = j_out, t_out
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert_same_state(js, ts)
    jo, to = np.asarray(jo), to.numpy()
    assert to.shape == jo.shape and to.dtype == jo.dtype == np.uint8
    np.testing.assert_array_equal(to, jo)


def _envs(kw, S, av=True, **flags):
    j = JVec(JCfg(**kw), N, obs_type="screen", donate=False,
             obs_config=JS.ScreenObsConfig(S, agent_view=av), **flags)
    t = TVec(TCfg(**kw), N, "screen", backend="torch", device="cpu",
             obs_config=TS.ScreenObsConfig(S, agent_view=av), **flags)
    return j, t


ACTS = np.tile(np.asarray([[0.6, -0.4, 0.0]], np.float32), (N, 1, 1))


def test_vecenv_screen_matches_xla_vecenv():
    jenv, tenv = _envs(SOLO, 32)
    js, jobs = jenv.reset(4)
    ts, tobs = tenv.reset(4)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert tuple(tobs.shape) == (N, 1, 32, 32, 4)
    js, *jo = jenv.step(js, jnp.asarray(ACTS))
    ts, *to = tenv.step(ts, ACTS)
    assert tuple(to[0].shape) == (N, 1, 1, 32, 32, 4)
    _compare(jo, to, js, ts)
    js, *jo = xla_step_chain(jenv, js, ACTS, 2)
    ts, *to = tenv.multi_step(ts, ACTS, 2)
    assert tuple(to[0].shape) == (2, N, 1, 1, 32, 32, 4)
    _compare(jo, to, js, ts)
    ts, o, r, d = tenv.multi_step(ts, ACTS, 2, stack_obs=False)
    js, *jo = xla_step_chain(jenv, js, ACTS, 2)
    assert isinstance(o, tuple) and len(o) == 2
    _compare(jo, (torch.stack(o), r, d), js, ts)


def test_vecenv_screen_auto_reset_matches_xla():
    """Mode 3 ends an episode at mass 23000: two envs start with two
    20000-mass cells, finish on the first step and are reset in place."""
    kw = dict(SOLO, mode=3, reward_type=False)
    jenv, tenv = _envs(kw, 32, av=False, auto_reset=True)
    js, _ = jenv.reset(2)
    js = js.replace(
        cell_mass=js.cell_mass.at[:2, 0, :2].set(20000),
        cell_alive=js.cell_alive.at[:2, 0, 1].set(True),
        cell_id=js.cell_id.at[:2, 0, 1].set(9),
        cell_pos=js.cell_pos.at[:2, 0, 1].add(jnp.asarray([30.0, 0.0])))
    ts = _to_port(js)
    for t in range(2):
        js, *jo = jenv.step(js, jnp.asarray(ACTS))
        ts, *to = tenv.step(ts, ACTS)
        _compare(jo, to, js, ts)
        if t == 0:
            np.testing.assert_array_equal(np.asarray(jo[2])[:, 0],
                                          np.arange(N) < 2)
            np.testing.assert_array_equal(np.asarray(js.ticks),
                                          np.where(np.arange(N) < 2, 0, 2))


def test_vecenv_screen_respawn_main_matches_xla():
    """Two envs start with a dead main player: it is respawned when the
    frame is taken and the step pays c_death."""
    kw = dict(SOLO, c_death=-7)
    jenv, tenv = _envs(kw, 32, respawn_main_during_obs=True)
    js, _ = jenv.reset(6)
    js = js.replace(cell_alive=js.cell_alive.at[:2].set(False))
    ts = _to_port(js)
    js, *jo = jenv.step(js, jnp.asarray(ACTS))
    ts, *to = tenv.step(ts, ACTS)
    _compare(jo, to, js, ts)
    assert bool(np.asarray(js.main_respawned)[:2].all())
    assert (np.asarray(jo[1])[:2] > 0).all()          # 25 - (0 - 7)

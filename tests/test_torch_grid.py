"""The port's grid path against the JAX package: obs/grid.py::grid_frame
against the XLA grid_frame under jit(vmap); the section build
(ops/fused_grid.py::grid_sections) against the XLA build; the plain
rasterizer (ops/fused_grid.py::rasterize_plain, the plain version of the
grid kernel) on the JAX package's own sections against its Pallas kernel in
interpret mode; and VecEnv(obs_type="grid", backend="torch") against the
XLA VecEnv. Frames are integers: every comparison is exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agarcl_tpu import EnvConfig as JCfg
from agarcl_tpu import env_reset as j_reset
from agarcl_tpu import env_step as j_step
from agarcl_tpu.obs import grid as JG
from agarcl_tpu.ops import fused_grid as JFG
from agarcl_tpu.vec import VecEnv as JVec
from agarcl_tpu_torch import EnvConfig as TCfg
from agarcl_tpu_torch.bridge import state_from_numpy, state_to_numpy
from agarcl_tpu_torch.obs import grid as TG
from agarcl_tpu_torch.ops import fused_grid as TFG
from agarcl_tpu_torch.ops.fused_tick import to_kernel_arrays
from agarcl_tpu_torch.state import STATE_FIELDS
from agarcl_tpu_torch.vec import VecEnv as TVec

SOLO = dict(num_agents=1, ticks_per_step=2, arena_size=120, num_pellets=80,
            num_viruses=4, num_bots=0, mode=4)
DUEL = dict(num_agents=1, ticks_per_step=2, arena_size=120, num_pellets=80,
            num_viruses=4, mode=7)
N = 6
F32 = np.float32


def _played(kw, seed, steps, split=False, n=N):
    """(n,) vmapped JAX states after random actions; `split` starts the
    agents at mass 400 and splits every step (2-10 cells each)."""
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


def _collisions():
    """test_fused_grid_obs_bin_collisions's state: two viruses (masses 120
    and 180) and two of the bot's cells (40 and 90) forced into one bin."""
    js = _states("duel")
    c = js.player_centroid()[:, 0]
    vp = js.virus_pos.at[:, 0].set(c + 10.0).at[:, 1].set(c + 10.2)
    return js.replace(
        virus_pos=vp, virus_alive=js.virus_alive.at[:, :2].set(True),
        virus_mass=js.virus_mass.at[:, 0].set(120).at[:, 1].set(180),
        cell_pos=js.cell_pos.at[:, 1, 0].set(c - 8.0).at[:, 1, 1].set(c - 8.3),
        cell_alive=js.cell_alive.at[:, 1, :2].set(True),
        cell_mass=js.cell_mass.at[:, 1, 0].set(40).at[:, 1, 1].set(90))


@functools.lru_cache(maxsize=None)
def _states(name):
    if name == "split":
        return _played(SOLO, 5, 4, split=True)
    if name == "collisions":
        return _collisions()
    return _played(SOLO, 3, 6) if name == "solo" else _played(DUEL, 7, 6)


def _kw(name):
    return SOLO if name in ("solo", "split") else DUEL


def _to_port(js):
    return state_from_numpy({f: np.asarray(getattr(js, f))
                             for f in js.__dataclass_fields__})


def _ocfgs(G, dtype, flags):
    kw = dict(grid_size=G, out_dtype=dtype)
    if flags == "some off":
        kw.update(observe_pellets=False, observe_others=False)
    elif flags == "others off":
        kw.update(observe_viruses=False, observe_cells=False)
    return JG.GridObsConfig(**kw), TG.GridObsConfig(**kw)


@functools.lru_cache(maxsize=None)
def _xla_grid_frame(name, G, dtype, flags):
    oj, _ = _ocfgs(G, dtype, flags)
    return np.asarray(jax.jit(jax.vmap(functools.partial(
        JG.grid_frame, JCfg(**_kw(name)), oj)))(_states(name)))


@pytest.mark.parametrize("name,G,dtype,flags", [
    ("solo", 16, "int32", "all"), ("duel", 32, "int16", "all"),
    ("split", 32, "int8", "all"), ("duel", 16, "int32", "some off"),
    ("split", 16, "int16", "others off"), ("collisions", 32, "int8", "all")])
def test_grid_frame_matches_xla(name, G, dtype, flags):
    want = _xla_grid_frame(name, G, dtype, flags)
    _, ot = _ocfgs(G, dtype, flags)
    got = TG.grid_frame(TCfg(**_kw(name)), ot, _to_port(_states(name)))
    assert got.dtype == ot.torch_dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[2] == ot.channels_per_frame
    if name == "split" and dtype == "int8":           # own mass saturates
        assert (want[:, 0, 5] == 127).any()


@functools.lru_cache(maxsize=None)
def _jax_sections(name, G):
    """The XLA build of the kernel's sections under jit, as the JAX package
    runs it."""
    cfg = JCfg(**_kw(name))
    secs = jax.jit(lambda st: JFG._build_grid_table(
        cfg, G, st, sections=True)[0])(_states(name))
    return {k: np.asarray(v) for k, v in secs.items()}


@pytest.mark.parametrize("name", ["solo", "duel", "split"])
def test_grid_sections_match_xla_build(name):
    """The port's section emission on bridged states against the XLA
    build: the same layout and every value equal, the camera included
    (for players of 2-10 cells, whose centroid sums run in slot order here
    and in XLA's order there, within two ulps, and the frames of both
    builds equal)."""
    kw = _kw(name)
    G = 32
    jsec = _jax_sections(name, G)
    tsec = {k: v.numpy() for k, v in TFG.grid_sections(
        TCfg(**kw), to_kernel_arrays(_to_port(_states(name)))).items()}
    meta = TFG.section_meta(TCfg(**kw))
    assert [(n, pw, f) for n, _, pw, f in meta] == [
        (n, pw, f) for n, _, pw, f in JFG.section_meta(JCfg(**kw))]
    assert {k: v.shape for k, v in tsec.items()} == {
        k: v.shape for k, v in jsec.items()}
    for k in jsec:
        if k == "params" and name == "split":
            np.testing.assert_array_max_ulp(tsec[k], jsec[k], maxulp=2)
        else:
            np.testing.assert_array_equal(tsec[k], jsec[k], err_msg=k)
    frames = [TFG.rasterize_plain(TCfg(**kw), G, {
        k: torch.from_numpy(v.copy()) for k, v in sec.items()}).numpy()
        for sec in (tsec, jsec)]
    np.testing.assert_array_equal(frames[0], frames[1])


def _plain(kw, G, secs, dtype="int32"):
    t = {k: torch.from_numpy(np.array(v)) for k, v in secs.items()}
    return TFG.rasterize_plain(TCfg(**kw), G, t, dtype).numpy()


@pytest.mark.parametrize("name", ["solo", "collisions"])
def test_rasterizer_matches_pallas_kernel(name):
    """rasterize_plain on the XLA-built sections against the Pallas kernel
    (T4, fused_grid_frame in interpret mode) on a played state, and on
    two viruses and two of the bot's cells in one bin (the kernel's exact
    block rewrite: max below the total, min below the max)."""
    kw = _kw(name)
    G = 32
    got = np.asarray(JFG.fused_grid_frame(
        JCfg(**kw), JG.GridObsConfig(grid_size=G, out_dtype="int16"),
        _states(name), block_envs=1, interpret=True))[:, 0]
    mine = _plain(kw, G, _jax_sections(name, G), "int16")
    np.testing.assert_array_equal(mine, got)
    if name == "collisions":
        assert (got[:, 3] != got[:, 4]).any()
        assert (got[:, 6] != got[:, 7]).any()


def _edge(c, k, view, G, rng, shape):
    """f32 coordinates within three ulps of the edge c + k*view/G."""
    e = (np.float64(c) + k * np.float64(view) / G).astype(F32)
    return (e + rng.integers(-3, 4, shape) * np.spacing(e)).astype(F32)


def _edge_cameras(G, n, rng, W):
    """(n, 2) cameras inside the arena that put a grid row (column 0) and a
    grid column (column 1) within three ulps of the arena edge, and their
    views: an even integer in [100, 300]."""
    view = (2 * rng.integers(50, 151, n)).astype(F32)
    low = rng.random((n, 2)) < 0.5
    t = np.where(low, -rng.integers(1, G // 2 + 1, (n, 2)),
                 rng.integers(1, (G + 1) // 2, (n, 2)))
    edge = np.where(low, 0.0, W)
    cam = np.stack([_edge(edge[:, j], -t[:, j], view, G, rng, n)
                    for j in range(2)], 1)
    return cam, view


def _crafted_sections(cfg, G, n, rng):
    """Sections whose cameras put a grid row or column a few ulps from the
    arena edge, with viruses, own cells and pellets a few ulps from bin
    edges."""
    meta = JFG.section_meta(cfg)
    secs = {name: np.full((n, pw), fill, F32) for name, _, pw, fill in meta}
    cam, view = _edge_cameras(G, n, rng, cfg.arena_width)
    secs["params"][:, :3] = np.concatenate([cam, view[:, None]], 1)
    for x, y, m, w in (("vx", "vy", "vm", 4), ("mx", "my", "mm", 16),
                       ("px", "py", None, 60)):
        for ax, c in ((x, 0), (y, 1)):
            b = rng.integers(-1, G + 2, (n, w)) - G / 2.0
            secs[ax][:, :w] = _edge(cam[:, c:c + 1], b, view[:, None], G,
                                    rng, (n, w))
        if m is not None:
            secs[m][:, :w] = rng.integers(25, 400, (n, w))
    return secs


def test_rasterizer_arithmetic_matches_pallas_on_crafted_boundaries():
    """Crafted sections (`_crafted_sections`): the plain rasterizer
    reproduces the Pallas kernel fed the tick's section contract (T5,
    fused_grid_frame_from_secs in interpret mode) value for value, and bins
    taken with the reciprocal of the view instead of the division do not."""
    rng = np.random.default_rng(21)
    cfg, n, G = JCfg(**SOLO), 6, 16
    secs = _crafted_sections(cfg, G, n, rng)
    want = np.asarray(JFG.fused_grid_frame_from_secs(
        cfg, JG.GridObsConfig(grid_size=G, out_dtype="int32"),
        {k: jnp.asarray(v) for k, v in secs.items()}, block_envs=1,
        interpret=True))[:, 0]
    np.testing.assert_array_equal(_plain(SOLO, G, secs), want)
    assert (want[:, 0] == 0).any() and (want[:, 0] == -1).any()
    cx, cy, view = (secs["params"][:, j:j + 1] for j in range(3))
    inv = (F32(G) / view).astype(F32)
    bx = np.trunc(((secs["px"][:, :60] - cx) * inv + F32(G / 2)).astype(F32))
    by = np.trunc(((secs["py"][:, :60] - cy) * inv + F32(G / 2)).astype(F32))
    ok = (bx >= 0) & (bx < G) & (by >= 0) & (by < G)
    recip = np.zeros((n, G * G), np.int64)
    rows = np.broadcast_to(np.arange(n)[:, None], bx.shape)
    np.add.at(recip, (rows[ok], (bx * G + by)[ok].astype(np.int64)), 1)
    assert (recip.reshape(n, G, G) != want[:, 2]).any()


def test_grid_frame_arithmetic_matches_xla_on_crafted_boundaries():
    """States whose camera puts a grid row or column a few ulps from the
    arena edge at G=24, where the quotient view/G is inexact: obs/grid.py's
    fma((i - G/2)*view, f32(1/G), c) reproduces the XLA grid_frame, and the
    coordinate as written does not."""
    rng = np.random.default_rng(22)
    cfg, G, n = JCfg(**SOLO), 24, 64
    js = jax.jit(jax.vmap(functools.partial(j_reset, cfg)))(
        jnp.arange(n, dtype=jnp.uint32))
    x, view = _edge_cameras(G, n, rng, 120.0)
    mass = (view / 2).astype(np.int32)
    cp = np.asarray(js.cell_pos).copy()
    cp[:, 0, 0] = x
    cm = np.asarray(js.cell_mass).copy()
    cm[:, 0, 0] = mass
    js = js.replace(cell_pos=jnp.asarray(cp), cell_mass=jnp.asarray(cm))
    oj = JG.GridObsConfig(grid_size=G, out_dtype="int32")
    want = np.asarray(jax.jit(jax.vmap(functools.partial(
        JG.grid_frame, cfg, oj)))(js))[:, 0, 0]
    ts = _to_port(js)
    got = TG.grid_frame(TCfg(**SOLO), TG.GridObsConfig(
        grid_size=G, out_dtype="int32"), ts)[:, 0, 0].numpy()
    np.testing.assert_array_equal(got, want)
    cam = TG.camera(ts.cell_pos[:, 0], ts.cell_mass[:, 0],
                    ts.cell_alive[:, 0]).numpy()
    t = (np.arange(G) - G / 2.0).astype(F32)
    wx = (cam[:, :1] + ((t * cam[:, 2:3]).astype(F32) / F32(G))).astype(F32)
    wy = (cam[:, 1:2] + ((t * cam[:, 2:3]).astype(F32) / F32(G))).astype(F32)
    inb = (((wx >= 0) & (wx < 120))[:, :, None]
           & ((wy >= 0) & (wy < 120))[:, None, :])
    assert (np.where(inb, 0, -1) != want).any()


def _same_game_envs(js, ts):
    """(N,) bool: envs whose integer state is equal; the f32 state of every
    env must be within 2e-3 (the port's state tolerance,
    tests/test_torch_vec.py)."""
    t = state_to_numpy(ts)
    ok = np.ones(N, bool)
    for f in STATE_FIELDS:
        j = np.asarray(getattr(js, f))
        if np.issubdtype(j.dtype, np.floating):
            np.testing.assert_allclose(t[f], j, atol=2e-3, rtol=0,
                                       err_msg=f)
        else:
            ok &= (t[f] == j).reshape(N, -1).all(1)
    return ok


def _compare(j_out, t_out, js, ts):
    (jo, jr, jd), (to, tr, td) = j_out, t_out
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    same = _same_game_envs(js, ts)
    assert same.sum() >= N - 1, same
    jo, to = np.asarray(jo), to.numpy()
    assert to.shape == jo.shape and to.dtype == jo.dtype
    np.testing.assert_array_equal(to[..., same, :, :, :, :, :],
                                  jo[..., same, :, :, :, :, :])


ACTS = np.tile(np.asarray([[0.6, -0.4, 2.0]], np.float32), (N, 1, 1))


def _envs(kw, G, dtype, **flags):
    j = JVec(JCfg(**kw), N, obs_type="grid", donate=False,
             obs_config=JG.GridObsConfig(grid_size=G, out_dtype=dtype),
             **flags)
    t = TVec(TCfg(**kw), N, "grid", backend="torch", device="cpu",
             obs_config=TG.GridObsConfig(grid_size=G, out_dtype=dtype),
             **flags)
    return j, t


def test_vecenv_grid_matches_xla_vecenv():
    jenv, tenv = _envs(SOLO, 16, "int16")
    js, jobs = jenv.reset(4)
    ts, tobs = tenv.reset(4)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert tuple(tobs.shape) == (N, 1, 8, 16, 16)
    _same_game_envs(js, ts)
    js, *jo = jenv.multi_step(js, jnp.asarray(ACTS), 2)
    ts, *to = tenv.multi_step(ts, ACTS, 2)
    assert tuple(to[0].shape) == (2, N, 1, 1, 8, 16, 16)
    _compare(jo, to, js, ts)


def test_vecenv_grid_auto_reset_matches_xla():
    """Mode 3 ends an episode at mass 23000: two envs start with two
    20000-mass cells, finish on the first step and are reset in place;
    the frames come back as a k-tuple (stack_obs=False)."""
    kw = dict(SOLO, mode=3, reward_type=False)
    jenv, tenv = _envs(kw, 16, "int32", auto_reset=True)
    js, _ = jenv.reset(2)
    js = js.replace(
        cell_mass=js.cell_mass.at[:2, 0, :2].set(20000),
        cell_alive=js.cell_alive.at[:2, 0, 1].set(True),
        cell_id=js.cell_id.at[:2, 0, 1].set(9),
        cell_pos=js.cell_pos.at[:2, 0, 1].add(jnp.asarray([30.0, 0.0])))
    ts = _to_port(js)
    js, *jo = jenv.multi_step(js, jnp.asarray(ACTS), 2)
    ts, o, r, d = tenv.multi_step(ts, ACTS, 2, stack_obs=False)
    assert isinstance(o, tuple) and len(o) == 2
    _compare(jo, (torch.stack(o), r, d), js, ts)
    np.testing.assert_array_equal(np.asarray(jo[2])[0, :, 0],
                                  np.arange(N) < 2)
    assert (np.asarray(jo[0])[0, :2, 0, 0, 5] >= 20000).any()

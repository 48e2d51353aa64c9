"""Screen and grid frames of every agent.

With two agents the JAX package draws one frame per (env, agent): its XLA
route (jax.vmap of screen_frame / grid_frame, the VecEnv's reset and xla
steps) and its Pallas route (fused_screen_frame / fused_grid_frame, one
virtual env row per (env, agent), the route its fused steps take for
A > 1). The port's plain frames (ops/fused_screen.py::frame_plain,
ops/fused_grid.py::frame_plain, the torch backend's frames and the plain
versions of K3 and K4) build one section set per agent: agent a's camera,
player a's cells as "main" / "own", every other player's as "others".
The camera for A > 1 is XLA's centroid, an fma chain (the JAX table build
takes it from player_centroid()), checked bit for bit here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agarcl_tpu import EnvConfig as JCfg
from agarcl_tpu import env_reset as j_reset
from agarcl_tpu import env_step as j_step
from agarcl_tpu.obs import grid as JGd
from agarcl_tpu.obs import screen as JS
from agarcl_tpu.ops import fused_grid as JFG
from agarcl_tpu.ops import fused_screen as JFS
from agarcl_tpu.vec import VecEnv as JVec
from agarcl_tpu_torch import EnvConfig as TCfg
from agarcl_tpu_torch.bridge import state_from_numpy, state_to_numpy
from agarcl_tpu_torch.obs import grid as TGd
from agarcl_tpu_torch.obs import screen as TS
from agarcl_tpu_torch.ops import fused_grid as TFG
from agarcl_tpu_torch.ops import fused_screen as TFS
from agarcl_tpu_torch.ops.fused_tick import to_kernel_arrays
from agarcl_tpu_torch.state import centroid_of
from agarcl_tpu_torch.vec import VecEnv as TVec

KW = dict(num_agents=2, ticks_per_step=2, arena_size=120, num_pellets=60,
          num_viruses=4, num_bots=1, mode=0)
N = 3


def _to_port(js):
    return state_from_numpy({f: np.asarray(getattr(js, f))
                             for f in js.__dataclass_fields__})


@functools.lru_cache(maxsize=None)
def _split_states():
    """(4,) reset states of KW whose players own 2-6 cells each (masses
    30-900 within 12 of the player's first cell), so the centroid's form
    matters."""
    cfg = JCfg(**KW)
    js = jax.jit(jax.vmap(functools.partial(j_reset, cfg)))(
        jnp.arange(4, dtype=jnp.uint32) + 21)
    rng = np.random.default_rng(3)
    pos = np.asarray(js.cell_pos).copy()
    pos[:, :, 1:] = pos[:, :, :1] + rng.uniform(-12, 12, pos[:, :, 1:].shape)
    alive = np.arange(pos.shape[2]) < rng.integers(2, 7, (4, 3, 1))
    return js.replace(
        cell_pos=jnp.asarray(pos, jnp.float32),
        cell_mass=jnp.asarray(rng.integers(30, 900, alive.shape), jnp.int32),
        cell_alive=jnp.asarray(alive),
        cell_id=jnp.broadcast_to(jnp.arange(alive.shape[2], dtype=jnp.int32),
                                 alive.shape))


def test_vecenv_frames_of_every_agent_match_xla_vecenv():
    """VecEnv(backend="torch") with 2 agents and a bot in mode 0, screen
    and grid: reset frames (N, A, ...) and multi_step frames
    (k, N, 1, A, ...), each equal to the JAX VecEnv's (screen: its own
    frames; grid: its frame function, jax.vmap(grid_frame), on its states
    after each step), with its rewards and dones. (The torch backend once
    drew player 0's camera only and returned (N, 1, ...).)"""
    S, G = 32, 16
    jenv = JVec(JCfg(**KW), N, obs_type="screen", donate=False,
                obs_config=JS.ScreenObsConfig(S, agent_view=True))
    jgrid = jax.jit(jax.vmap(functools.partial(
        JGd.grid_frame, JCfg(**KW), JGd.GridObsConfig(grid_size=G))))
    tscr = TVec(TCfg(**KW), N, "screen", backend="torch", device="cpu",
                obs_config=TS.ScreenObsConfig(S, agent_view=True))
    tgrd = TVec(TCfg(**KW), N, "grid", backend="torch", device="cpu",
                obs_config=TGd.GridObsConfig(grid_size=G, out_dtype="int32"))
    acts = np.tile(np.asarray([[[0.6, -0.4, 0.0], [-0.5, 0.2, 0.0]]],
                              np.float32), (N, 1, 1))
    js, jobs = jenv.reset(7)
    jframes, jgrids, jr, jd = [], [jgrid(js)], [], []
    for _ in range(2):
        js, o, r, d = jenv.step(js, jnp.asarray(acts))
        jframes.append(np.asarray(o))
        jgrids.append(jgrid(js))
        jr.append(np.asarray(r))
        jd.append(np.asarray(d))
    for env, j0, jo in ((tscr, jobs, np.stack(jframes)),
                        (tgrd, jgrids[0], np.stack(jgrids[1:])[:, :, None])):
        ts, tobs = env.reset(7)
        assert tuple(tobs.shape[:2]) == (N, 2)
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(j0))
        ts, to, tr, td = env.multi_step(ts, acts, 2)
        assert tuple(to.shape[:4]) == (2, N, 1, 2)
        np.testing.assert_array_equal(to.numpy(), jo)
        np.testing.assert_allclose(tr.numpy(), np.stack(jr), atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(td.numpy(), np.stack(jd))
        assert not np.array_equal(jo[:, :, 0, 0], jo[:, :, 0, 1])
    t = state_to_numpy(ts)
    for f in ("cell_mass", "cell_alive", "pellet_key", "ticks"):
        np.testing.assert_array_equal(t[f], np.asarray(getattr(js, f)))


@pytest.mark.parametrize("kind", ["screen", "screen_poly", "grid"])
def test_plain_frames_match_pallas_at_two_agents(kind):
    """frame_plain of the bridged planes against the Pallas kernel's
    multi-agent rows in interpret mode (fused_screen_frame /
    fused_grid_frame, block_envs=1), value for value, on states where
    every player owns several cells."""
    js = _split_states()
    planes = to_kernel_arrays(_to_port(js))
    cfg = JCfg(**KW)
    if kind == "grid":
        jo = JGd.GridObsConfig(grid_size=32, out_dtype="int16")
        want = JFG.fused_grid_frame(cfg, jo, js, block_envs=1,
                                    interpret=True)
        got = TFG.frame_plain(TCfg(**KW), TGd.GridObsConfig(
            grid_size=32, out_dtype="int16"), planes)
    else:
        flags = (dict(polygon_edges=True, polygon_virus="circle")
                 if kind == "screen_poly" else {})
        want = JFS.fused_screen_frame(cfg, JS.ScreenObsConfig(
            40, agent_view=True, **flags), js, block_envs=1, interpret=True)
        got = TFS.frame_plain(TCfg(**KW), TS.ScreenObsConfig(
            40, agent_view=True, **flags), planes)
    want = np.asarray(want)
    assert got.shape == want.shape and want.shape[1] == 2
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want[:, 0], want[:, 1])


def test_cameras_match_the_xla_table_build_at_two_agents():
    """Each agent's camera in the port's sections equals the JAX table
    build's (_build_table / _build_grid_table with agents=2) bit for bit:
    XLA's fma-chain centroid, which the slot-order products of the
    one-agent emission miss on some of these multi-cell players."""
    js = _split_states()
    cfg, tcfg = JCfg(**KW), TCfg(**KW)
    ts = _to_port(js)
    planes = to_kernel_arrays(ts)
    n = js.ticks.shape[0]
    jscr = np.asarray(jax.jit(lambda st: JFS._build_table(
        cfg, 32, st, _ablate="sections", agents=2)[0]["params"])(js))
    jgrid = np.asarray(jax.jit(lambda st: JFG._build_grid_table(
        cfg, 16, st, sections=True, agents=2)[0]["params"])(js))
    for a in range(2):
        scr = TFS.screen_sections(tcfg, planes, a)["params"].numpy()
        grid = TFG.grid_sections(tcfg, planes, a)["params"].numpy()
        np.testing.assert_array_equal(scr[:, :3], jscr[a::2, :3])
        np.testing.assert_array_equal(grid[:, :3], jgrid[a::2, :3])
    slot = centroid_of(ts.cell_pos[:, :2], ts.cell_mass[:, :2],
                       ts.cell_alive[:, :2]).numpy().reshape(n * 2, 2)
    assert (slot != jscr[:, :2]).any()

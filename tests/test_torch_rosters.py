"""Configurations the port used to refuse, against the JAX package:
rosters above 9 players on the plain engine (backend="torch", as the JAX
package's XLA backend runs any roster), their screen and grid frames, the
frame routes for sizes the kernels do not take (circle screens above
fused_screen.MAX_SCREEN through the class map, grids above
fused_grid.MAX_GRID through the plain grid frame), and the cuda
backend's refusals, which name the limit and the torch backend.

References are jitted XLA functions of the JAX package, from states the
JAX reset builds or the port's engine hands over as numpy (bridge.py);
every field and frame value bit-equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agarcl_tpu import EnvConfig as JCfg
from agarcl_tpu import env_reset as j_reset
from agarcl_tpu.engine.tick import engine_tick as j_tick
from agarcl_tpu.obs import grid as JG
from agarcl_tpu.obs import screen as JS
from agarcl_tpu.state import GameState as JState
from agarcl_tpu_torch import EnvConfig as TCfg
from agarcl_tpu_torch.bridge import state_from_numpy, state_to_numpy
from agarcl_tpu_torch.engine.tick import engine_tick as t_tick
from agarcl_tpu_torch.obs import grid as TG
from agarcl_tpu_torch.obs import screen as TS
from agarcl_tpu_torch.ops import fused_grid as TFG
from agarcl_tpu_torch.ops import fused_screen as TFS
from agarcl_tpu_torch.ops import fused_step as TFstep
from agarcl_tpu_torch.ops import fused_tick as TFT
from agarcl_tpu_torch.ops.fused_tick import to_kernel_arrays
from agarcl_tpu_torch.state import STATE_FIELDS
from agarcl_tpu_torch.vec import VecEnv as TVec

torch.set_num_threads(1)

ROSTER12 = dict(num_agents=1, ticks_per_step=4, arena_size=100,
                num_pellets=40, num_viruses=2, num_bots=11, mode=0)
TINY = dict(num_agents=1, ticks_per_step=2, arena_size=40, num_pellets=12,
            num_viruses=1, num_bots=1, mode=7)
N = 8


def _np(js):
    return {f: np.asarray(getattr(js, f)) for f in js.__dataclass_fields__}


def _to_jax(ts):
    return JState(**{f: jnp.asarray(a) for f, a in
                     state_to_numpy(ts).items()})


@functools.lru_cache(maxsize=None)
def _jit(fn, kw, *args):
    cfg = JCfg(**dict(kw))
    return jax.jit(jax.vmap(functools.partial(fn, cfg, *args)))


def _kw(d):
    return tuple(sorted(d.items()))


@functools.lru_cache(maxsize=None)
def _ticked12():
    """The 12-player roster (mode 0, 11 bots: types 1-4 then HungryBots)
    after 6 ticks of the port's engine_tick, each tick held bit for bit
    against the jitted JAX engine_tick from the same state; returns the
    port's last state."""
    cfg = TCfg(**ROSTER12)
    js = _jit(j_reset, _kw(ROSTER12))(jnp.arange(N, dtype=jnp.uint32) + 3)
    tick = _jit(j_tick, _kw(ROSTER12))
    rng = np.random.default_rng(3)
    for t in range(6):
        c = np.asarray(js.player_centroid())
        tgt = np.array(js.target)
        tgt[:, 0] = c[:, 0] + rng.uniform(-15, 15, c[:, 0].shape)
        js = js.replace(target=jnp.asarray(tgt, jnp.float32),
                        action=js.action.at[:, 0].set(
                            jnp.asarray(rng.integers(0, 3, N), jnp.int32)))
        ts = t_tick(cfg, state_from_numpy(_np(js)))
        js = tick(js)
        got = state_to_numpy(ts)
        for f in STATE_FIELDS:
            np.testing.assert_array_equal(got[f], np.asarray(getattr(js, f)),
                                          err_msg=f"{f} tick {t}")
    return ts


def test_engine_tick_twelve_players_matches_xla():
    ts = _ticked12()
    cfg = TCfg(**ROSTER12)
    assert cfg.num_players == 12 and not TFT.supports(cfg)
    assert cfg.bot_types() == (0, 1, 2, 3, 4) + (1,) * 7
    assert tuple(ts.cell_mass.shape) == (N, 12, 16)
    assert (ts.target[:, 1:] != 0).any()                 # the bots decided


@pytest.mark.parametrize("kind", ["screen", "grid"])
def test_twelve_player_frames_match_xla(kind):
    """The torch backend's frames of the 12-player state (K3's and K4's
    plain versions on the planes, the route VecEnv takes) against the
    JAX package's class map and grid_frame: 0 differing values."""
    ts = _ticked12()
    cfg, js = TCfg(**ROSTER12), _to_jax(ts)
    planes = to_kernel_arrays(ts)
    if kind == "screen":
        oj, ot = JS.ScreenObsConfig(48), TS.ScreenObsConfig(48)
        want = np.asarray(_jit(JS.screen_frame, _kw(ROSTER12), oj)(js))
        got = TFS.frame_plain(cfg, ot, planes)
        assert (want[..., 1] == 255).any()               # other players
    else:
        oj, ot = JG.GridObsConfig(grid_size=24), TG.GridObsConfig(
            grid_size=24)
        want = np.asarray(_jit(JG.grid_frame, _kw(ROSTER12), oj)(js))
        got = TFG.frame_plain(cfg, ot, planes)
        assert (want[:, :, 7] > 0).any()                 # others' max mass
    np.testing.assert_array_equal(got.numpy(), want)


def test_vecenv_twelve_players_on_the_torch_backend():
    """VecEnv(backend="torch") runs the roster on every observation type:
    reset and one step, frames equal to the JAX frames of the same
    states."""
    cfg = TCfg(**ROSTER12)
    acts = torch.zeros(4, 1, 3)
    for obs_type, ocfg in (("ram", None),
                           ("screen", TS.ScreenObsConfig(32)),
                           ("grid", TG.GridObsConfig(grid_size=16)),
                           ("gobigger", None)):
        env = TVec(cfg, 4, obs_type, backend="torch", device="cpu",
                   obs_config=ocfg)
        s, o0 = env.reset(1)
        s, o, r, d = env.step(s, acts)
        assert tuple(r.shape) == (4, 1) and torch.isfinite(r).all()
        if obs_type == "screen":
            want = _jit(JS.screen_frame, _kw(ROSTER12),
                        JS.ScreenObsConfig(32))(_to_jax(s))
            np.testing.assert_array_equal(o[:, 0].numpy(), np.asarray(want))
        elif obs_type == "grid":
            want = _jit(JG.grid_frame, _kw(ROSTER12),
                        JG.GridObsConfig(grid_size=16))(_to_jax(s))
            np.testing.assert_array_equal(o[:, 0].numpy(), np.asarray(want))
        elif obs_type == "gobigger":
            assert o["clones"].shape[:3] == (4, 1, 1)
        else:
            assert tuple(o.shape[:2]) == (4, 1)


@pytest.mark.parametrize("kind", ["screen", "grid"])
def test_large_frame_routes_match_xla(kind):
    """A circle screen above MAX_SCREEN and a grid above MAX_GRID: the
    route is the class map or the plain grid frame (frame_kernel, on both
    backends), the counters show it, the frames equal the JAX package's
    frames of the same states at a tiny arena, and the kernel wrappers
    still refuse the size."""
    cfg = TCfg(**TINY)
    if kind == "screen":
        S = TFS.MAX_SCREEN + 16
        ot, oj = TS.ScreenObsConfig(S), JS.ScreenObsConfig(S)
        assert not TFS.supports(ot)
        assert TFstep.frame_kernel(ot)[0] is TFS.class_map_frame
        assert TFstep.frame_kernel(ot, plain=True)[0] is TFS.class_map_frame
        jfn = JS.screen_frame
    else:
        G = TFG.MAX_GRID + 2
        ot = TG.GridObsConfig(grid_size=G, out_dtype="int32")
        oj = JG.GridObsConfig(grid_size=G, out_dtype="int32")
        assert not TFG.supports(ot)
        assert TFstep.frame_kernel(ot)[0] is TFG.frame_plain
        jfn = JG.grid_frame
    env = TVec(cfg, 2, kind, backend="torch", device="cpu", obs_config=ot)
    before = TS.class_map_calls, TFS.plain_calls, TFG.plain_calls
    s, o0 = env.reset(2)
    planes = to_kernel_arrays(s)
    acts = torch.tensor([[[0.5, -0.3, 0.0]]]).expand(2, 1, 3)
    s, o, r, d = env.step(s, acts)
    calls = (TS.class_map_calls - before[0], TFS.plain_calls - before[1],
             TFG.plain_calls - before[2])
    assert calls == ((2, 0, 0) if kind == "screen" else (0, 0, 2))
    want = np.asarray(_jit(jfn, _kw(TINY), oj)(_to_jax(s)))
    np.testing.assert_array_equal(o[:, 0].numpy(), want)
    assert len(np.unique(want)) > 2
    if kind == "screen":
        np.testing.assert_array_equal(
            TFS.class_map_frame(cfg, ot, planes).numpy(), o0.numpy())
        with pytest.raises(ValueError, match="screen_len"):
            TFS.fused_screen_frame(cfg, ot, planes)
    else:
        with pytest.raises(ValueError, match="grid_size"):
            TFG.fused_grid_frame(cfg, ot, planes)


def test_cuda_backend_refuses_only_what_the_tick_kernel_cannot_take(
        monkeypatch):
    """backend="cuda" refuses a roster above 9, other max_cells or
    virus_ticks_capacity, and more than 64 virus slots, each with a
    NotImplementedError naming the limit and backend="torch"; the largest
    configurations it takes construct (a CUDA device is feigned: the
    constructor allocates nothing)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    base = dict(num_agents=1, arena_size=100, num_pellets=20, mode=0)
    refused = [
        (dict(base, num_bots=11), "9 players"),
        (dict(base, num_bots=9), "9 players"),
        (dict(base, num_bots=2, max_cells=8), "max_cells"),
        (dict(base, virus_ticks_capacity=8), "virus_ticks_capacity"),
        (dict(base, num_viruses=49), "64 virus slots"),
    ]
    for kw, limit in refused:
        with pytest.raises(NotImplementedError, match=limit) as e:
            TVec(TCfg(**kw), 2, "ram", backend="cuda")
        assert "backend='torch'" in str(e.value)
        env = TVec(TCfg(**kw), 2, "ram", backend="torch", device="cpu")
        assert env.backend == "torch"
    for kw in (dict(base, num_bots=8), dict(base, num_viruses=48),
               dict(base, num_agents=3, num_bots=6)):
        env = TVec(TCfg(**kw), 2, "screen", backend="cuda")
        assert env.device.type == "cuda" and TFT.refusal(env.cfg) is None

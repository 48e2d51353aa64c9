"""State, numpy bridge and kernel-layout planes of the port against the JAX
package."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agarcl_tpu import EnvConfig as JCfg
from agarcl_tpu import env_reset as j_reset
from agarcl_tpu import env_step as j_step
from agarcl_tpu.engine.tick import engine_tick as j_tick
from agarcl_tpu.ops.fused_tick import _from_kernel_arrays, _to_kernel_arrays
from agarcl_tpu.state import decode_pellet_xy, encode_pellet_key
from agarcl_tpu_torch import EnvConfig as TCfg
from agarcl_tpu_torch import state as TS
from agarcl_tpu_torch.bridge import state_from_numpy, state_to_numpy
from agarcl_tpu_torch.engine.tick import engine_tick as t_tick
from agarcl_tpu_torch.env import env_reset as t_reset
from agarcl_tpu_torch.env import env_step as t_step
from agarcl_tpu_torch.ops import fused_tick as FT

KW = dict(num_agents=1, ticks_per_step=4, arena_size=110, num_pellets=60,
          num_viruses=3, mode=4)
N = 6


def _jax_fields(s):
    return {f: np.asarray(getattr(s, f)) for f in s.__dataclass_fields__}


@functools.lru_cache(maxsize=None)
def _stepped_state():
    """A batched JAX state with several cells per player (splits of a
    heavy cell), after a few ticks."""
    cfg = JCfg(**KW)
    s = jax.jit(jax.vmap(functools.partial(j_reset, cfg)))(
        jnp.asarray([0, 1, 2, 2**32 - 5, 2**31, 77], jnp.uint32))
    s = s.replace(cell_mass=s.cell_mass.at[:, 0, 0].set(300),
                  action=jnp.full((N, 1), 2, jnp.int32))
    tick = jax.jit(jax.vmap(functools.partial(j_tick, cfg)))
    for _ in range(3):
        s = tick(s)
    return s


def test_bridge_round_trip_is_exact():
    js = _stepped_state()
    fields = _jax_fields(js)
    ts = state_from_numpy(fields)
    assert ts.seed.dtype == torch.int64
    back = state_to_numpy(ts)
    assert set(back) == set(fields)
    for f, a in fields.items():
        assert back[f].dtype == a.dtype, f
        np.testing.assert_array_equal(back[f], a, err_msg=f)


def test_zero_state_matches_jax_shapes_and_values():
    from agarcl_tpu.state import zero_state as j_zero
    for mode in (4, 1, 0):
        kw = dict(KW, mode=mode, num_bots=2)
        j = jax.vmap(lambda _: j_zero(JCfg(**kw)))(jnp.arange(3))
        t = state_to_numpy(TS.zero_state(TCfg(**kw), 3))
        for f, a in _jax_fields(j).items():
            assert t[f].shape == a.shape and t[f].dtype == a.dtype, f
            np.testing.assert_array_equal(t[f], a, err_msg=f)


def test_pellet_key_encode_decode_match():
    rng = np.random.default_rng(0)
    for arena in (100, 350):
        cfg_j, cfg_t = JCfg(arena_size=arena), TCfg(arena_size=arena)
        pos = rng.uniform(-5, arena + 5, (4, 300, 2)).astype(np.float32)
        alive = rng.random((4, 300)) < 0.8
        kj = np.asarray(encode_pellet_key(cfg_j, jnp.asarray(pos),
                                          jnp.asarray(alive)))
        kt = TS.encode_pellet_key(cfg_t, torch.from_numpy(pos),
                                  torch.from_numpy(alive)).numpy()
        np.testing.assert_array_equal(kj, kt)
        xj, aj = decode_pellet_xy(cfg_j, jnp.asarray(kj))
        xt, at = TS.decode_pellet_xy(cfg_t, torch.from_numpy(kt))
        np.testing.assert_array_equal(np.asarray(xj), xt.numpy())
        np.testing.assert_array_equal(np.asarray(aj), at.numpy())


def test_player_helpers_match():
    js = _stepped_state()
    ts = state_from_numpy(_jax_fields(js))
    assert int(ts.cell_alive.sum()) > N          # several cells per player
    np.testing.assert_array_equal(np.asarray(js.player_mass()),
                                  ts.player_mass().numpy())
    np.testing.assert_array_equal(np.asarray(js.player_alive()),
                                  ts.player_alive().numpy())
    np.testing.assert_array_equal(np.asarray(js.cell_rank()),
                                  ts.cell_rank().numpy())
    # centroid: slot-order f32 sums here, XLA's own order there
    np.testing.assert_allclose(np.asarray(js.player_centroid()),
                               ts.player_centroid().numpy(), atol=2e-3)


def test_kernel_planes_match_jax_and_invert():
    js = _stepped_state()
    ts = state_from_numpy(_jax_fields(js))
    jp = [np.asarray(x) for x in _to_kernel_arrays(js)]
    tp = FT.to_kernel_arrays(ts)
    assert len(tp) == len(jp) == FT.N_STATE_PLANES == 41
    for i, (a, b) in enumerate(zip(jp, tp)):
        assert b.is_contiguous()
        b = b.numpy()
        if a.dtype == np.uint32:                 # seed: uint32 bit pattern
            b = b.view(np.uint32)
        assert a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"plane {i}")
    back = state_to_numpy(FT.from_kernel_arrays(ts, tp))
    for f, a in _jax_fields(js).items():
        np.testing.assert_array_equal(back[f], a, err_msg=f)
    jback = _from_kernel_arrays(js, [jnp.asarray(p) for p in jp])
    np.testing.assert_array_equal(np.asarray(jback.cell_pos),
                                  back["cell_pos"])


def test_kernel_planes_are_copies():
    """The multi-step kernel updates planes in place: no plane may share
    memory with the GameState it came from, and no materialized field may
    share memory with a plane."""
    ts = state_from_numpy(_jax_fields(_stepped_state()))
    ptrs = {getattr(ts, f).data_ptr() for f in TS.STATE_FIELDS}
    planes = FT.to_kernel_arrays(ts)
    assert not ptrs & {p.data_ptr() for p in planes}
    back = FT.from_kernel_arrays(ts, planes)
    plane_ptrs = {p.data_ptr() for p in planes}
    assert not plane_ptrs & {getattr(back, f).data_ptr()
                             for f in TS.STATE_FIELDS}


def _assert_fields_equal(js, ts):
    t = state_to_numpy(ts)
    for f, a in _jax_fields(js).items():
        np.testing.assert_array_equal(t[f], a, err_msg=f)


@pytest.mark.parametrize("mode", [1, 2, 3, 4, 5, 6])
def test_reset_float_state_bit_equal_to_jax(mode):
    """Every field of a reset, floats included, equals
    jit(vmap(env_reset))'s: the spawn draw fma(f32(W - 2r), u, f32(r)) is
    XLA-CPU's fused form (engine/spawn.py::random_location)."""
    kw = dict(KW, mode=mode)
    seeds = np.array([0, 7, 4242, 2**31, 2**32 - 1], np.uint32)
    js = jax.jit(jax.vmap(functools.partial(j_reset, JCfg(**kw))))(
        jnp.asarray(seeds))
    _assert_fields_equal(js, t_reset(TCfg(**kw), torch.from_numpy(
        seeds.astype(np.int64))))


def test_respawn_and_regen_draws_bit_equal_to_jax():
    """The same draw in its other two contexts: a dead main player
    respawned by a jitted env_step (respawn_main_during_obs), and viruses
    regenerated by a jitted engine tick at a regen tick."""
    cfg_j, cfg_t = JCfg(**KW), TCfg(**KW)
    seeds = jnp.arange(N, dtype=jnp.uint32) + 3
    js = jax.jit(jax.vmap(functools.partial(j_reset, cfg_j)))(seeds)
    dead = js.replace(cell_alive=jnp.zeros_like(js.cell_alive))
    acts = np.zeros((N, 1, 3), np.float32)
    step = jax.jit(jax.vmap(functools.partial(
        j_step, cfg_j, respawn_main_during_obs=True)))
    jout, _, _ = step(dead, jnp.asarray(acts))
    tout, _, _ = t_step(cfg_t, state_from_numpy(_jax_fields(dead)),
                        torch.from_numpy(acts), True)
    assert bool(np.asarray(jout.main_respawned).all())
    _assert_fields_equal(jout, tout)
    regen = js.replace(virus_alive=jnp.zeros_like(js.virus_alive),
                       ticks=jnp.full_like(js.ticks, 240))
    jt = jax.jit(jax.vmap(functools.partial(j_tick, cfg_j)))(regen)
    tt = t_tick(cfg_t, state_from_numpy(_jax_fields(regen)))
    assert bool(np.asarray(jt.virus_alive).sum(-1).min() == KW["num_viruses"])
    _assert_fields_equal(jt, tt)

"""The port's plain engine (env_reset, engine_tick) against the JAX package.

Integers are held exact, f32 state to atol 2e-3 (the JAX suite's own bar,
tests/test_fused_tick.py:30-38). The eventful scenario (virus pops,
splits, feeds with up to 12 cells in a pile) free-runs for 12 ticks and is
compared tick by tick from the same JAX state over 40: the relaxation of a
crowded pile amplifies the port's rare one-ulp differences from XLA-CPU's
fused arithmetic after about 15 ticks (ROADMAP.md, Queue 3), so a longer
free run there measures chaos, not the engine.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agarcl_tpu import EnvConfig as JCfg
from agarcl_tpu import env_reset as j_reset
from agarcl_tpu.engine.tick import engine_tick as j_tick
from agarcl_tpu_torch import EnvConfig as TCfg
from agarcl_tpu_torch.bridge import state_from_numpy, state_to_numpy
from agarcl_tpu_torch.engine.tick import engine_tick as t_tick
from agarcl_tpu_torch.env import env_reset as t_reset

INT_FIELDS = ("cell_mass", "cell_alive", "cell_id", "cell_recombine_at",
              "pellet_key", "virus_alive", "virus_mass", "virus_hits",
              "food_alive", "food_eaten", "highest_mass", "viruses_eaten",
              "cells_eaten", "elapsed_ticks", "last_decay_tick",
              "split_cooldown", "feed_cooldown", "ticks", "next_cell_id",
              "food_next", "virus_eaten_ptr", "virus_eaten_ticks", "action",
              "seed", "dones", "main_respawned")
F32_FIELDS = ("cell_pos", "cell_vel", "cell_split_vel", "virus_pos",
              "virus_vel", "food_pos", "food_vel", "anti_team_decay",
              "target")
N = 8


def _cfgs(mode):
    kw = dict(num_agents=1, ticks_per_step=4, arena_size=110,
              num_pellets=80, num_viruses=4, mode=mode)
    return JCfg(**kw), TCfg(**kw)


def _fields(js):
    return {f: np.asarray(getattr(js, f)) for f in js.__dataclass_fields__}


def compare(js, ts, t):
    jd = _fields(js)
    td = state_to_numpy(ts)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(td[f], jd[f],
                                      err_msg=f"{f} at tick {t}")
    for f in F32_FIELDS:
        np.testing.assert_allclose(td[f], jd[f], atol=2e-3, rtol=0,
                                   err_msg=f"{f} at tick {t}")


def _steer(rng, js):
    c = np.asarray(js.player_centroid())[:, 0]
    tgt = (c + rng.uniform(-20, 20, c.shape)).astype(np.float32)[:, None]
    act = rng.integers(0, 3, (N, 1)).astype(np.int32)
    return tgt, act


@pytest.mark.parametrize("mode", [4, 1])
def test_env_reset_bit_equal(mode):
    """Under jit, as the JAX VecEnv resets (eagerly, XLA rounds the spawn
    draw's product before the add and virus positions differ by an ulp)."""
    cfg_j, cfg_t = _cfgs(mode)
    seeds = np.array([0, 1, 99, 4242, 2**31 - 1, 2**31, 2**32 - 2,
                      2**32 - 1], np.uint32)
    js = jax.jit(jax.vmap(functools.partial(j_reset, cfg_j)))(
        jnp.asarray(seeds))
    ts = t_reset(cfg_t, torch.from_numpy(seeds.astype(np.int64)))
    td = state_to_numpy(ts)
    for f, a in _fields(js).items():
        assert td[f].dtype == a.dtype, f
        np.testing.assert_array_equal(td[f], a, err_msg=f)


@pytest.mark.parametrize("mode", [4, 1])
def test_engine_tick_free_run(mode):
    """40 ticks from the same reset with steering targets and random
    feed/split actions, each side running on its own."""
    cfg_j, cfg_t = _cfgs(mode)
    js = jax.jit(jax.vmap(functools.partial(j_reset, cfg_j)))(
        jnp.arange(N, dtype=jnp.uint32) + 11)
    ts = state_from_numpy(_fields(js))
    tick = jax.jit(jax.vmap(functools.partial(j_tick, cfg_j)))
    rng = np.random.default_rng(0)
    for t in range(40):
        tgt, act = _steer(rng, js)
        js = js.replace(target=jnp.asarray(tgt), action=jnp.asarray(act))
        ts = ts.replace(target=torch.from_numpy(tgt),
                        action=torch.from_numpy(act))
        js, ts = tick(js), t_tick(cfg_t, ts)
        compare(js, ts, t)
    assert int(np.asarray(js.food_eaten).sum()) > 0


def _eventful(js):
    """Heavy cells at the arena centre, and for half the envs a virus
    beside the cell: virus pops, then splits and feeds of the pieces."""
    cm = np.asarray(js.cell_mass).copy()
    cm[:, 0, 0] = 400
    cp = np.asarray(js.cell_pos).copy()
    cp[:, 0, 0] = 55.0
    vp = np.asarray(js.virus_pos).copy()
    vp[: N // 2, 0] = 58.0
    return js.replace(cell_mass=jnp.asarray(cm), cell_pos=jnp.asarray(cp),
                      virus_pos=jnp.asarray(vp))


@pytest.mark.parametrize("mode", [4, 1])
def test_engine_tick_eventful_each_tick(mode):
    cfg_j, cfg_t = _cfgs(mode)
    js = _eventful(jax.jit(jax.vmap(functools.partial(j_reset, cfg_j)))(
        jnp.arange(N, dtype=jnp.uint32) + 3))
    tick = jax.jit(jax.vmap(functools.partial(j_tick, cfg_j)))
    rng = np.random.default_rng(1)
    for t in range(40):
        tgt, act = _steer(rng, js)
        js = js.replace(target=jnp.asarray(tgt), action=jnp.asarray(act))
        ts = t_tick(cfg_t, state_from_numpy(_fields(js)))
        js = tick(js)
        compare(js, ts, t)
    assert int(np.asarray(js.viruses_eaten).sum()) >= N // 2   # pops
    assert int(np.asarray(js.next_cell_id).min()) > 2          # splits
    assert int(np.asarray(js.food_next).sum()) > 0             # feeds
    assert int(np.asarray(js.cell_alive).sum(-1).max()) >= 10


@pytest.mark.parametrize("mode", [4, 1])
def test_engine_tick_eventful_free_run(mode):
    """12 ticks from the eventful state, each side running on its own:
    virus pops, the splits they make and feeds, short of the tick where the
    pile's one-ulp amplification (ROADMAP.md, Queue 3) leaves the bar."""
    cfg_j, cfg_t = _cfgs(mode)
    js = _eventful(jax.jit(jax.vmap(functools.partial(j_reset, cfg_j)))(
        jnp.arange(N, dtype=jnp.uint32) + 3))
    ts = state_from_numpy(_fields(js))
    tick = jax.jit(jax.vmap(functools.partial(j_tick, cfg_j)))
    rng = np.random.default_rng(1)
    for t in range(12):
        tgt, act = _steer(rng, js)
        js = js.replace(target=jnp.asarray(tgt), action=jnp.asarray(act))
        ts = ts.replace(target=torch.from_numpy(tgt),
                        action=torch.from_numpy(act))
        js, ts = tick(js), t_tick(cfg_t, ts)
        compare(js, ts, t)
    assert int(np.asarray(js.viruses_eaten).sum()) >= N // 2   # pops
    assert int(np.asarray(js.next_cell_id).min()) > 2          # splits
    assert int(np.asarray(js.food_next).sum()) > 0             # feeds


def test_engine_tick_refuses_bots():
    from agarcl_tpu_torch.env import env_reset
    """Rosters above the 9-player cap (here 1 agent + 9 bots) raise."""
    cfg = TCfg(num_agents=1, num_bots=9, arena_size=80, num_pellets=10,
               num_viruses=1, mode=0)
    s = env_reset(cfg, torch.arange(2))
    with pytest.raises(NotImplementedError):
        t_tick(cfg, s)

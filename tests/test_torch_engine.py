"""The port's plain engine (env_reset, engine_tick) against the JAX package.

Integers are held exact, f32 state to atol 2e-3 (the JAX suite's own bar,
tests/test_fused_tick.py:30-38). The eventful scenario (virus pops,
splits, feeds with up to 12 cells in a pile) free-runs for 40 ticks and is
compared tick by tick from the same JAX state over 40, and crowded corner
piles free-run for 12 ticks: the relaxation of a crowded pile amplifies any
one-ulp difference from XLA-CPU's fused arithmetic, so these runs hold the
relaxation's pinned forms (ROADMAP.md, Queue 3 item 1).
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
    """40 ticks from the eventful state, each side running on its own:
    virus pops, the splits they make and feeds (with the relaxation's forms
    read off XLA's vmapped tick; before them the run left the bar after
    about 15 ticks)."""
    cfg_j, cfg_t = _cfgs(mode)
    js = _eventful(jax.jit(jax.vmap(functools.partial(j_reset, cfg_j)))(
        jnp.arange(N, dtype=jnp.uint32) + 3))
    ts = state_from_numpy(_fields(js))
    tick = jax.jit(jax.vmap(functools.partial(j_tick, cfg_j)))
    rng = np.random.default_rng(1)
    for t in range(40):
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
    """A roster above K1's 9-player cap (here 1 agent + 9 bots): the plain
    engine ticks it, as the JAX package's XLA tick does, and only K1's
    wrapper refuses it, naming the cap (tests/test_torch_rosters.py holds
    such rosters against JAX)."""
    from agarcl_tpu_torch.env import env_reset
    from agarcl_tpu_torch.ops import fused_tick as FT
    cfg = TCfg(num_agents=1, num_bots=9, arena_size=80, num_pellets=10,
               num_viruses=1, mode=0)
    s = env_reset(cfg, torch.arange(2))
    nxt = t_tick(cfg, s)
    assert tuple(nxt.cell_mass.shape) == (2, 10, 16)
    assert (nxt.ticks == 1).all() and nxt.player_alive().all()
    with pytest.raises(NotImplementedError, match="9 players"):
        FT.engine_tick_raw(cfg, FT.to_kernel_arrays(s), 1)


def test_transcendentals_bit_equal():
    """XLA-CPU's f32 atan, cos and sin (glibc's atanf / cosf / sinf) are
    pinned in geometry.atan32 / cos32 / sin32: bit-equal over 2^20 inputs
    of each, covering direction()'s ratio (uniform, tan of uniform angles,
    tiny and wide normals) and the virus-pop angles in (-3pi, 3pi); the
    float64-rounded forms the port had before differ on 1-7% of them."""
    from agarcl_tpu.engine import geometry as JG
    from agarcl_tpu_torch.engine import geometry as G
    rng = np.random.default_rng(1)
    n = 1 << 20
    x = np.concatenate([rng.uniform(-10, 10, n // 4),
                        np.tan(rng.uniform(-1.5707, 1.5707, n // 4)),
                        rng.standard_normal(n // 4) * 1e-3,
                        rng.standard_normal(n // 4) * 50]).astype(np.float32)
    a = rng.uniform(-3 * np.pi, 3 * np.pi, n).astype(np.float32)
    v = (rng.standard_normal((n, 2))
         * rng.choice([1e-3, 1.0, 100.0], (n, 1))).astype(np.float32)
    v[:1000, 0] = 0.0
    v[1000:2000, 1] = 0.0
    v[2000:2100] = 0.0
    pairs = [(G.atan32(torch.from_numpy(x)), jax.jit(jnp.arctan)(x)),
             (G.cos32(torch.from_numpy(a)), jax.jit(jnp.cos)(a)),
             (G.sin32(torch.from_numpy(a)), jax.jit(jnp.sin)(a)),
             (G.direction(torch.from_numpy(v)), jax.jit(JG.direction)(v))]
    for ours, ref in pairs:
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _pile(js, rng, centres, n=14):
    """n cells of mass 25-300 piled within 6 of each env's centre (x = y),
    moving at up to 30 in each axis, no recombination."""
    d = {k: v.copy() for k, v in _fields(js).items()}
    NE = d["ticks"].shape[0]
    d["cell_mass"][:, 0, :n] = rng.integers(25, 300, (NE, n))
    d["cell_alive"][:, 0, :n] = True
    d["cell_id"][:, 0, :n] = np.arange(1, n + 1)
    d["next_cell_id"][:] = n + 1
    d["cell_pos"][:, 0, :n] = (np.asarray(centres)[:, None, None]
                               + rng.uniform(-6, 6, (NE, n, 2)))
    d["cell_vel"][:, 0, :n] = rng.uniform(-30, 30, (NE, n, 2))
    d["cell_recombine_at"][:] = 10**6
    return js.replace(**{k: jnp.asarray(v) for k, v in d.items()})


def test_engine_tick_corner_pile_free_run():
    """12 ticks of crowded 14-cell piles in a corner, each side running on
    its own: cells pinned at the borders zero velocity components through
    avoid_static_overlap's exact equality tests, so an ulp of difference
    there would grow to the cell's whole speed."""
    cfg_j, cfg_t = _cfgs(4)
    js = jax.jit(jax.vmap(functools.partial(j_reset, cfg_j)))(
        jnp.arange(N, dtype=jnp.uint32) + 3)
    rng = np.random.default_rng(0)
    js = _pile(js, rng, np.full(N, 12.0))
    ts = state_from_numpy(_fields(js))
    tick = jax.jit(jax.vmap(functools.partial(j_tick, cfg_j)))
    for t in range(12):
        c = np.asarray(js.player_centroid())[:, 0]
        tgt = (c + rng.uniform(-20, 20, c.shape)).astype(np.float32)[:, None]
        js = js.replace(target=jnp.asarray(tgt))
        ts = ts.replace(target=torch.from_numpy(tgt))
        js, ts = tick(js), t_tick(cfg_t, ts)
        compare(js, ts, t)
    assert int(np.asarray(js.cell_alive).sum()) >= 8 * N


def test_relaxation_bitwise_share_ceiling():
    """Crowded piles of 14 cells (half at a corner), each tick from the
    same JAX state: the share of live cells whose velocity is not
    bit-equal to jax.jit(jax.vmap(engine_tick))'s. The relaxation's fused
    products, read off the vmapped tick (v2's first product; the
    tangential products per output fusion), took it from 65 to 5 of 2688;
    the rest is not pinned (ROADMAP.md, Queue 3), and this ceiling keeps
    it from growing."""
    NE = 64
    kw = dict(num_agents=1, ticks_per_step=4, arena_size=110,
              num_pellets=80, num_viruses=4, mode=4)
    cfg_j, cfg_t = JCfg(**kw), TCfg(**kw)
    js = jax.jit(jax.vmap(functools.partial(j_reset, cfg_j)))(
        jnp.arange(NE, dtype=jnp.uint32) + 3)
    tick = jax.jit(jax.vmap(functools.partial(j_tick, cfg_j)))
    rng = np.random.default_rng(5)
    js = _pile(js, rng, np.where(np.arange(NE) % 2 == 0, 12.0, 55.0))
    diff = total = 0
    for _ in range(3):
        c = np.asarray(js.player_centroid())[:, 0]
        tgt = (c + rng.uniform(-20, 20, c.shape)).astype(np.float32)
        js = js.replace(target=jnp.asarray(tgt[:, None]))
        ts = t_tick(cfg_t, state_from_numpy(_fields(js)))
        js = tick(js)
        alive = np.asarray(js.cell_alive)
        ours = state_to_numpy(ts)["cell_vel"]
        diff += int(((ours != np.asarray(js.cell_vel)).any(-1)
                     & alive).sum())
        total += int(alive.sum())
    assert total == 2688
    assert diff <= 5, f"{diff} of {total} velocities differ (ceiling 5)"


def _pop_pile(js):
    """A 400-mass cell beside a virus in the corner of every env: the virus
    pops it into a corner pile, and the pieces' feeds fly off the walls."""
    d = {k: v.copy() for k, v in _fields(js).items()}
    d["cell_mass"][:, 0, 0] = 400
    d["cell_pos"][:, 0, 0] = 12.0
    d["virus_pos"][:, 0] = 15.0
    return js.replace(**{k: jnp.asarray(v) for k, v in d.items()})


def pop_pile_ticks(ticks):
    """(JAX state before, JAX state after) of each of `ticks` ticks of the
    virus-pop corner pile, steered with random feeds and splits."""
    cfg_j, _ = _cfgs(4)
    js = _pop_pile(jax.jit(jax.vmap(functools.partial(j_reset, cfg_j)))(
        jnp.arange(N, dtype=jnp.uint32) + 3))
    tick = jax.jit(jax.vmap(functools.partial(j_tick, cfg_j)))
    rng = np.random.default_rng(1)
    out = []
    for _ in range(ticks):
        tgt, act = _steer(rng, js)
        js = js.replace(target=jnp.asarray(tgt), action=jnp.asarray(act))
        out.append((js, tick(js)))
        js = out[-1][1]
    return out


def test_food_position_bit_equal_on_a_virus_pop_corner_pile():
    """Each tick from the same JAX state, the food positions of the
    virus-pop corner pile are bit-equal to jax.jit(jax.vmap(engine_tick))'s:
    XLA-CPU rounds the food movement's product before the add and fuses
    the feed's rim point fma(d, r, pos), both read off the vmapped tick's
    food fusion (ROADMAP.md, Queue 3 item 1). The earlier forms (a fused
    movement, a rounded rim point) differ from the first tick on."""
    _, cfg_t = _cfgs(4)
    steps = pop_pile_ticks(12)
    for t, (before, after) in enumerate(steps):
        ts = t_tick(cfg_t, state_from_numpy(_fields(before)))
        np.testing.assert_array_equal(state_to_numpy(ts)["food_pos"],
                                      np.asarray(after.food_pos),
                                      err_msg=f"food_pos at tick {t}")
    last = steps[-1][1]
    assert int(np.asarray(last.viruses_eaten).sum()) >= N     # pops
    assert int(np.asarray(last.food_next).sum()) > 0          # feeds

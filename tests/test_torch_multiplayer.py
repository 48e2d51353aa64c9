"""The port's multi-player tick against the JAX package: scripted bots
(engine/bots.py::bot_decide), cross-player eating
(engine/eating.py::cross_player_eat), engine_tick with bots and several
players, and VecEnv on duel and mode-0 rosters.

References are jitted XLA functions of the JAX package; the XLA tick is
what the JAX suite holds its Pallas kernel to
(tests/test_fused_tick.py:464-560, integer fields exact, f32 fields within
2e-3), with the same settings. The port is held bit for bit: engine_tick
tick by tick from the same JAX state, VecEnv against the XLA VecEnv's step
chain (test_torch_vec.py::xla_step_chain), bot targets."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import port_states
import pytest
import torch

import agarcl_tpu.ops.fused_step as JFS
import agarcl_tpu.ops.fused_tick as JFT
from agarcl_tpu import EnvConfig as JCfg
from agarcl_tpu import env_reset as j_reset
from agarcl_tpu.engine import bots as JB
from agarcl_tpu.engine import eating as JE
from agarcl_tpu.engine.tick import engine_tick as j_tick
from agarcl_tpu.obs import screen as JS
from agarcl_tpu.state import GameState as JState
from agarcl_tpu.vec import VecEnv as JVec
from agarcl_tpu_torch import EnvConfig as TCfg
from agarcl_tpu_torch.bridge import state_from_numpy, state_to_numpy
from agarcl_tpu_torch.engine import bots as TB
from agarcl_tpu_torch.engine import eating as TE
from agarcl_tpu_torch.engine.tick import engine_tick as t_tick
from agarcl_tpu_torch.obs import screen as TS
from agarcl_tpu_torch.ops import fused_step as TFS
from agarcl_tpu_torch.ops import fused_tick as TFT
from agarcl_tpu_torch.state import STATE_FIELDS, decode_pellet_xy
from agarcl_tpu_torch.vec import VecEnv as TVec
from test_torch_vec import assert_same_state, xla_step_chain

# The suite runs in several worker processes (pytest-xdist); one intra-op
# thread per process keeps torch's thread pools from oversubscribing the
# cores, which made the port's small-tensor tests about 4x slower in
# test-seconds. Every worker imports this module while it collects, so the
# setting holds for all of the port's tests in such a run.
torch.set_num_threads(1)

ROSTERS = {      # tests/test_fused_tick.py:464-519
    "duel10": dict(num_agents=1, ticks_per_step=4, arena_size=100,
                   num_pellets=40, num_viruses=2, num_bots=1, mode=10),
    "mode0_4bots": dict(num_agents=1, ticks_per_step=4, arena_size=80,
                        num_pellets=30, num_viruses=2, num_bots=4, mode=0),
    "mode0_8bots": dict(num_agents=1, ticks_per_step=4, arena_size=80,
                        num_pellets=24, num_viruses=2, num_bots=8, mode=0),
    "mode0_2agents": dict(num_agents=2, ticks_per_step=4, arena_size=80,
                          num_pellets=30, num_viruses=2, num_bots=1, mode=0),
}
N = 4


def _np(js):
    return {f: np.asarray(getattr(js, f)) for f in js.__dataclass_fields__}


def _to_port(js):
    return state_from_numpy(_np(js))


def _compare(js, ts, what):
    t = state_to_numpy(ts)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(t[f], np.asarray(getattr(js, f)),
                                      err_msg=f"{f} {what}")


@functools.lru_cache(maxsize=None)
def _j_reset(kw):
    return jax.jit(jax.vmap(functools.partial(j_reset, JCfg(**dict(kw)))))


@functools.lru_cache(maxsize=None)
def _j_tick(kw):
    return jax.jit(jax.vmap(functools.partial(j_tick, JCfg(**dict(kw)))))


# ----------------------------------------------------------------- bots
ROSTER5 = dict(num_agents=1, ticks_per_step=4, arena_size=100,
               num_pellets=30, num_viruses=2, num_bots=4, mode=0)


@functools.lru_cache(maxsize=None)
def _j_bots(kw):
    cfg = JCfg(**dict(kw))
    bt = jnp.asarray(cfg.bot_types(), jnp.int32)

    def one(s):
        pp, pa = s.pellet_xy_alive(cfg)
        return JB.bot_decide(bt, s.player_centroid(), s.player_mass(),
                             s.player_alive(), s.cell_pos, s.cell_mass,
                             s.cell_alive, pp, pa, cfg.arena_width,
                             cfg.arena_height, s.seed, s.ticks)
    return jax.jit(jax.vmap(one))


def _t_bots(cfg, ts):
    pp, pa = ts.pellet_xy_alive(cfg)
    return TB.bot_decide(cfg.bot_types(), ts.player_centroid(),
                         ts.player_mass(), ts.player_alive(), ts.cell_pos,
                         ts.cell_mass, ts.cell_alive, pp, pa,
                         cfg.arena_width, cfg.arena_height, ts.seed,
                         ts.ticks)


def _key(cfg, x, y):
    """Pellet key of the quantized cell holding (x, y)."""
    q = 32768
    return (int(x * q / cfg.arena_width) << 15) | int(y * q / cfg.arena_height)


def _bot_states(seed, n=12):
    """P=5 roster (types 0-4) around the arena centre: 1-4 live cells of
    mass 25-300 per player, so flee and hunt both fire; envs 0-5 crafted:
    0 flee (bot 2 beside the agent), 1 contested prey (bots 3 and 4 both
    within reach of the agent's small cells), 2 nearest-pellet ties (one
    pellet key in three slots), 3 all pellets within 0.01 of bot 1, 4 no
    live pellet (the floor of the random draw), 5 a dead bot 3."""
    cfg = TCfg(**ROSTER5)
    kw = tuple(sorted(ROSTER5.items()))
    fields = _np(_j_reset(kw)(jnp.arange(n, dtype=jnp.uint32) + seed))
    rng = np.random.default_rng(seed)
    P, Cc = 5, 16
    cnt = rng.integers(1, 5, (n, P))
    alive = np.arange(Cc)[None, None] < cnt[..., None]
    mass = rng.integers(25, 300, (n, P, Cc)) * alive
    pos = (50.0 + rng.uniform(-14, 14, (n, P, Cc, 2))).astype(np.float32)
    ticks = rng.integers(0, 40, n) * 10
    seeds = rng.integers(0, 2**32, n)
    keys = fields["pellet_key"].copy()
    # 0: bot 2 within 25 of the agent, everyone else far
    alive[0] = False
    alive[0, :, 0] = True
    pos[0, :, 0] = [[50, 50], [90, 90], [60, 55], [10, 90], [90, 10]]
    # 1: bots 3 and 4 big, the agent's cells 30-80 near both
    alive[1] = False
    alive[1, 0, :4] = alive[1, 3, 0] = alive[1, 4, 0] = True
    alive[1, 1, 0] = alive[1, 2, 0] = True
    mass[1, 0, :4] = [30, 80, 60, 2000]
    mass[1, 3, 0], mass[1, 4, 0] = 300, 400
    pos[1, 0, :4] = [[50, 50], [52, 49], [49, 53], [70, 70]]
    pos[1, 3, 0], pos[1, 4, 0] = [58, 50], [45, 45]
    pos[1, 1, 0], pos[1, 2, 0] = [10, 10], [90, 90]
    # 2: three slots of one key (exact ties), bot 1 alone
    keys[2] = -1
    keys[2, [3, 7, 11]] = _key(cfg, 20.0, 30.0)
    keys[2, 5] = _key(cfg, 80.0, 80.0)
    # 3: every live pellet at bot 1's (single) cell
    alive[3, 1] = False
    alive[3, 1, 0] = True
    k3 = _key(cfg, 33.3, 66.6)
    keys[3] = np.where(keys[3] >= 0, k3, -1)
    pos[3, 1, 0] = decode_pellet_xy(cfg, torch.tensor(k3))[0].numpy()
    # 4: no live pellet
    keys[4] = -1
    # 5: bot 3 dead
    alive[5, 3] = False
    mass = np.where(alive, mass, 0).astype(np.int32)
    fields.update(cell_alive=alive, cell_mass=mass, cell_pos=pos,
                  ticks=ticks.astype(np.int32),
                  seed=seeds.astype(np.uint32), pellet_key=keys)
    fields["cell_id"] = np.broadcast_to(np.arange(1, Cc + 1, dtype=np.int32),
                                        (n, P, Cc)).copy()
    return cfg, kw, fields


@pytest.mark.parametrize("seed", [0, 1])
def test_bot_decide_bit_equal_to_jax(seed):
    cfg, kw, fields = _bot_states(seed)
    ts = state_from_numpy(fields)
    js = JState(**{f: jnp.asarray(a) for f, a in fields.items()})
    jt, ja, ju = _j_bots(kw)(js)
    tt, ta, tu = _t_bots(cfg, ts)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    t = tt.numpy()
    assert not tu[5, 3] and tu[5, 1]                        # dead bot
    assert (t[4, 1] == np.floor(t[4, 1])).all()             # random floor
    assert (t[3, 1] == 0.0).all()                           # the (0,0) quirk
    np.testing.assert_array_equal(t[0, 2], 2 * fields["cell_pos"][0, 2, 0]
                                  - fields["cell_pos"][0, 0, 0])
    assert not np.allclose(t[1, 3], t[1, 4])                # two hunters


# ------------------------------------------------------------ cross-eat
def _cross_cases():
    """(pos, mass, alive, id) of contested states, P=9: env 0 two eaters
    for one prey (the lower pid wins), env 1 a chain (A eats B while B
    eats C), env 2 an eaten eater beside equal-rank eaters, envs 3-5
    random piles."""
    rng = np.random.default_rng(7)
    n, P, Cc = 6, 9, 16
    alive = np.zeros((n, P, Cc), bool)
    mass = np.zeros((n, P, Cc), np.int32)
    pos = np.zeros((n, P, Cc, 2), np.float32)
    cid = np.broadcast_to(np.arange(1, Cc + 1, dtype=np.int32),
                          (n, P, Cc)).copy()
    alive[0, [1, 2, 3], 0] = True
    mass[0, [1, 2, 3], 0] = [500, 900, 100]
    pos[0, [1, 2, 3], 0] = [[40, 40], [41, 40], [40.5, 40.2]]
    alive[1, [0, 4, 8], 0] = True
    mass[1, [0, 4, 8], 0] = [1000, 400, 100]
    pos[1, [0, 4, 8], 0] = [[30, 30], [45, 30], [55, 30]]
    alive[2, 5, :3] = alive[2, 6, 0] = alive[2, 7, 0] = True
    mass[2, 5, :3], mass[2, 6, 0], mass[2, 7, 0] = [300, 300, 26], 120, 1500
    cid[2, 5, :2] = 4                                   # equal ids
    pos[2, 5, :3] = [[20, 20], [20.2, 20], [20.1, 20.3]]
    pos[2, 6, 0], pos[2, 7, 0] = [20.1, 20.1], [21, 21]
    cnt = rng.integers(0, 6, (3, P))
    alive[3:] = np.arange(Cc)[None, None] < cnt[..., None]
    mass[3:] = rng.integers(20, 600, (3, P, Cc))
    pos[3:] = rng.uniform(10, 30, (3, P, Cc, 2))
    mass = np.where(alive, mass, 0).astype(np.int32)
    return pos, mass, alive, cid


def test_cross_player_eat_exact():
    pos, mass, alive, cid = _cross_cases()
    key = np.where(alive, cid, 2**30)
    rank = (key[..., :, None] > key[..., None, :]).sum(-1).astype(np.int32)
    jout = jax.jit(jax.vmap(JE.cross_player_eat))(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(alive),
        jnp.asarray(rank))
    tout = TE.cross_player_eat(*(torch.from_numpy(a) for a in
                                 (pos, mass, alive, rank)))
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    gain, eaten, cnt = (t.numpy() for t in tout)
    assert eaten[0, 3, 0] and gain[0, 1, 0] == 100 and gain[0, 2, 0] == 500
    assert eaten[1, 4, 0] and eaten[1, 8, 0] and gain[1, 4, 0] == 100
    assert gain[1, 0, 0] == 400
    assert gain[2, 5, 0] == gain[2, 5, 1] == 120 and eaten[2, 5, :3].all()
    assert gain[2, 7, 0] == 600 and gain[2, 6, 0] == 26       # chain
    assert cnt[3:].sum() > 0 and gain.dtype == np.int32


# ---------------------------------------------------------- engine_tick
def _steer(num_agents):
    def steer(rng, js):
        tgt = np.array(js.target)
        act = np.array(js.action)
        c = np.asarray(js.player_centroid())
        for a in range(num_agents):
            tgt[:, a] = c[:, a] + rng.uniform(-15, 15, c[:, a].shape)
            act[:, a] = rng.integers(0, 3, c.shape[0])
        return js.replace(target=jnp.asarray(tgt, jnp.float32),
                          action=jnp.asarray(act, jnp.int32))
    return steer


def _boost_cross_eat(js):
    """A mass-500 agent cell on bot 1's spawn, bot 2 there too when the
    roster has it (tests/test_fused_tick.py:540-560)."""
    bp = js.cell_pos[:, 1, 0]
    cp = js.cell_pos.at[:, 0, 0].set(bp)
    if js.cell_pos.shape[1] > 2:
        cp = cp.at[:, 2, 0].set(bp)
    return js.replace(cell_mass=js.cell_mass.at[:, 0, 0].set(500),
                      cell_pos=cp)


@pytest.mark.parametrize("name,ticks,seed", [
    ("duel10", 15, 10), ("mode0_4bots", 12, 5), ("mode0_8bots", 8, 11),
    ("mode0_2agents", 15, 3)])
def test_engine_tick_per_tick_matches_xla(name, ticks, seed):
    kw = tuple(sorted(ROSTERS[name].items()))
    cfg = TCfg(**ROSTERS[name])
    js = _j_reset(kw)(jnp.arange(N, dtype=jnp.uint32) + seed)
    steer = _steer(cfg.num_agents)
    tick = _j_tick(kw)
    rng = np.random.default_rng(seed)
    bot_moved = eaten_pellets = 0
    for t in range(ticks):
        js = steer(rng, js)
        ts = t_tick(cfg, _to_port(js))
        nxt = tick(js)
        _compare(nxt, ts, f"{name} tick {t}")
        bot_moved += int((np.asarray(nxt.target)[:, cfg.num_agents:]
                          != np.asarray(js.target)[:, cfg.num_agents:]).sum())
        eaten_pellets += int(np.asarray(nxt.food_eaten).sum())
        js = nxt
    assert bot_moved > 0 and eaten_pellets > 0


@pytest.mark.parametrize("name", ["duel10", "mode0_4bots"])
def test_engine_tick_forced_cross_eat_matches_xla(name):
    kw = dict(ROSTERS[name], num_pellets=20, num_viruses=0, arena_size=100)
    cfg = TCfg(**kw)
    kw = tuple(sorted(kw.items()))
    js = _boost_cross_eat(_j_reset(kw)(jnp.arange(N, dtype=jnp.uint32) + 2))
    tick = _j_tick(kw)
    steer = _steer(1)
    rng = np.random.default_rng(2)
    for t in range(3):
        js = steer(rng, js)
        ts = t_tick(cfg, _to_port(js))
        nxt = tick(js)
        _compare(nxt, ts, f"{name} tick {t}")
        js = nxt
    assert int(np.asarray(js.cells_eaten).sum()) >= N


def test_engine_tick_contested_virus_matches_xla():
    """Both duel players reach virus 0, player 1 virus 1 too: player 0's
    claim stands and player 1 gets no event (no fallback to virus 1)."""
    kw = tuple(sorted(ROSTERS["duel10"].items()))
    cfg = TCfg(**dict(kw))
    js = _j_reset(kw)(jnp.arange(N, dtype=jnp.uint32))
    js = js.replace(
        cell_pos=js.cell_pos.at[:, 0, 0].set(jnp.array([50.0, 50.0]))
        .at[:, 1, 0].set(jnp.array([51.0, 50.0])),
        cell_mass=js.cell_mass.at[:, :, 0].set(400),
        virus_pos=js.virus_pos.at[:, 0].set(jnp.array([50.5, 50.0]))
        .at[:, 1].set(jnp.array([53.0, 50.0])),
        virus_alive=js.virus_alive.at[:, :2].set(True))
    nxt = _j_tick(kw)(js)
    _compare(nxt, t_tick(cfg, _to_port(js)), "contested virus")
    ve = np.asarray(nxt.viruses_eaten)
    assert (ve[:, 0] == 1).all() and (ve[:, 1] == 0).all()


# -------------------------------------------------------------- VecEnv
def _acts(n, a, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-1, 1, (n, a, 2)),
                           rng.integers(0, 3, (n, a, 1))], -1).astype(
                               np.float32)


DUEL_SMALL = dict(num_agents=1, ticks_per_step=2, arena_size=60,
                  num_pellets=40, num_viruses=2, num_bots=1, mode=10)


def test_vecenv_duel_screen_matches_xla():
    """A small duel on the screen path: the bot is drawn (G 255) and the
    state, frames, rewards and dones equal the XLA VecEnv's step chain."""
    n, S = 4, 32
    jenv = JVec(JCfg(**DUEL_SMALL), n, obs_type="screen", donate=False,
                obs_config=JS.ScreenObsConfig(S, agent_view=True))
    tenv = TVec(TCfg(**DUEL_SMALL), n, "screen", backend="torch",
                device="cpu", obs_config=TS.ScreenObsConfig(S, agent_view=True))
    js, jo = jenv.reset(3)
    ts, to = tenv.reset(3)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    acts = _acts(n, 1, 0)
    js, jo, jr, jd = xla_step_chain(jenv, js, acts, 3)
    ts, to, tr, td = tenv.multi_step(ts, acts, 3)
    np.testing.assert_array_equal(tr.numpy(), jr)
    np.testing.assert_array_equal(td.numpy(), jd)
    assert_same_state(js, ts)
    np.testing.assert_array_equal(to.numpy(), jo)
    assert (to.numpy()[..., 1] == 255).any()                 # the bot drawn


def test_vecenv_duel_ram_resident_matches_xla():
    """The duel's RAM path on resident state from a forced cross-eat: the
    agent eats the bot in the first step, so done_on_death fires; frames
    (with the bot's per-player row), rewards, dones and state as the XLA
    VecEnv's step chain."""
    n = 4
    kw = dict(DUEL_SMALL, ticks_per_step=4, num_viruses=0, arena_size=100)
    jenv = JVec(JCfg(**kw), n, obs_type="ram", donate=False)
    tenv = TVec(TCfg(**kw), n, "ram", backend="torch", device="cpu")
    js = port_states.to_jax(tenv.reset(1)[0])
    b = _boost_cross_eat(js)
    m = (jnp.arange(n) < 2)[:, None, None]
    js = js.replace(cell_mass=jnp.where(m, b.cell_mass, js.cell_mass),
                    cell_pos=jnp.where(m[..., None], b.cell_pos, js.cell_pos))
    res = tenv.make_resident(_to_port(js))
    acts = _acts(n, 1, 1)
    for k in (2, 1):
        js, jo, jr, jd = xla_step_chain(jenv, js, acts, k)
        res, to, tr, td = tenv.multi_step(res, acts, k)
        np.testing.assert_array_equal(to.numpy(), jo)
        np.testing.assert_array_equal(tr.numpy(), jr)
        np.testing.assert_array_equal(td.numpy(), jd)
    assert td.numpy()[-1, :2, 0].all()                      # bot eaten
    assert (to.numpy()[0, 2:, 0, 0, -4:] != 0).any()        # bot row
    assert_same_state(js, tenv.materialize(res))


def test_vecenv_mode0_respawn_with_bots_matches_xla():
    """Mode 0 with 4 bots: a forced cross-eat kills bots 1 and 2 in the
    first step and respawn_all brings them back."""
    n = 4
    kw = dict(ROSTERS["mode0_4bots"], num_viruses=0, arena_size=100)
    jenv = JVec(JCfg(**kw), n, obs_type="ram", donate=False)
    tenv = TVec(TCfg(**kw), n, "ram", backend="torch", device="cpu")
    js = port_states.to_jax(tenv.reset(2)[0])
    js = _boost_cross_eat(js)
    ts = _to_port(js)
    acts = _acts(n, 1, 2)
    js, jo, jr, jd = xla_step_chain(jenv, js, acts, 2)
    ts, to, tr, td = tenv.multi_step(ts, acts, 2)
    np.testing.assert_array_equal(to.numpy(), jo)
    np.testing.assert_array_equal(tr.numpy(), jr)
    np.testing.assert_array_equal(td.numpy(), jd)
    assert_same_state(js, ts)
    assert int(ts.cells_eaten.sum()) >= n
    assert ts.player_alive().all() and int(ts.next_cell_id.min()) > 6


def test_bridge_round_trip_nine_players():
    """A 9-player JAX state crosses to the port and back field for field
    (dtypes and the P axis included): a reset and one tick of the port's
    plain engine (bit-equal to XLA's, above), in the reset's dtypes."""
    kw = tuple(sorted(ROSTERS["mode0_8bots"].items()))
    js = _j_reset(kw)(jnp.arange(N, dtype=jnp.uint32))
    js = port_states.to_jax(t_tick(TCfg(**dict(kw)), _to_port(js)), like=js)
    back = state_to_numpy(_to_port(js))
    for f, a in _np(js).items():
        assert back[f].dtype == a.dtype and back[f].shape == a.shape, f
        np.testing.assert_array_equal(back[f], a, err_msg=f)
    assert back["cell_mass"].shape == (N, 9, 16)


# -------------------------------------------------------------- guards
def test_supports_matches_jax():
    for mode in range(11):
        for bots in range(10):
            for agents in (1, 2, 3):
                kw = dict(num_agents=agents, num_bots=bots, mode=mode,
                          arena_size=100, num_pellets=20, num_viruses=2)
                jc, tc = JCfg(**kw), TCfg(**kw)
                assert TFT.supports(tc) == JFT.supports(jc), kw
                for obs in ("ram", "none", "screen"):
                    assert (TFS.supports_multi(tc, obs)
                            == JFS.supports_multi(jc, obs, False, False)), kw


def test_above_nine_players_raises():
    cfg = TCfg(num_agents=1, num_bots=9, arena_size=80, num_pellets=10,
               num_viruses=1, mode=0)
    assert cfg.num_players == 10 and not TFT.supports(cfg)
    with pytest.raises(NotImplementedError, match="backend='torch'"):
        TVec(cfg, 2, "ram", backend="cuda")
    planes = TFT.to_kernel_arrays(state_from_numpy(
        _np(_j_reset(tuple(sorted(dict(num_agents=1, num_bots=8,
                                       arena_size=80, num_pellets=10,
                                       num_viruses=1, mode=0).items())))(
            jnp.arange(2, dtype=jnp.uint32)))))
    with pytest.raises(NotImplementedError):
        TFT.multi_step_raw(cfg, planes, torch.zeros(2, 1, 3), 1, None)

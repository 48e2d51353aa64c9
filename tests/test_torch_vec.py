"""VecEnv(backend="torch") of the port against the JAX package's resident
multi-step path (the Pallas kernel in interpret mode, as
tests/test_fused_tick.py::test_resident_multi_step_parity) and its XLA
VecEnv, bit for bit.

The port's multi_step follows JAX's step program, jit(step_b): JAX's
multi_step is one jit of a scan over step_b, which XLA fuses otherwise, a
few ulps away in some envs (ROADMAP.md Queue 3 item 3). So the XLA side
is a chain of VecEnv.step calls (xla_step_chain). The RAM frame's features
0 and 1 (the centroid over the arena size) are formed as in the Pallas
kernel and the reset frame; XLA's step program forms them otherwise with
one player, 1-2 ulps away (assert_ram_equal, Queue 3 item 2)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agarcl_tpu.ops.fused_step as JFS
from agarcl_tpu import EnvConfig as JCfg
from agarcl_tpu.obs.ram import RamObsConfig as JR
from agarcl_tpu.obs.ram import ram_frame as j_ram
from agarcl_tpu.vec import VecEnv as JVec
from agarcl_tpu_torch import EnvConfig as TCfg
from agarcl_tpu_torch.bridge import state_to_numpy
from agarcl_tpu_torch.ops import fused_step
from agarcl_tpu_torch.state import STATE_FIELDS
from agarcl_tpu_torch.vec import VecEnv as TVec

KW = dict(num_agents=1, ticks_per_step=2, arena_size=100, num_pellets=40,
          num_viruses=2, num_bots=0, reward_type=True, mode=4)
N, K = 4, 3
ACTS = np.tile(np.asarray([[0.6, -0.4, 1.0]], np.float32), (N, 1, 1))
INT_FIELDS = ("cell_mass", "cell_alive", "cell_id", "pellet_key",
              "virus_alive", "virus_mass", "food_alive", "food_next",
              "ticks", "next_cell_id", "dones", "seed", "elapsed_ticks")
F32_FIELDS = ("cell_pos", "cell_vel", "virus_pos", "food_pos", "target")


def xla_step_chain(jenv, js, actions, k):
    """k calls of the JAX VecEnv's step, stacked as its multi_step stacks
    them: (states, obs (k, N, ...) or None, rewards (k, N, A), dones)."""
    outs = []
    for _ in range(k):
        js, *out = jenv.step(js, jnp.asarray(actions))
        outs.append(out)
    return js, *(None if x[0] is None else np.stack([np.asarray(y) for y in x])
                 for x in zip(*outs))


def assert_ram_equal(got, want, centroid_ulps=0):
    """RAM frames value for value; features 0 and 1 within
    `centroid_ulps`: XLA's step program forms them as num / (T * W) when
    the centroid feeds the division by the arena size directly (one
    player), the port as (num / T) * (1 / W) (ROADMAP.md Queue 3 item 2)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got[..., 2:], want[..., 2:])
    np.testing.assert_array_max_ulp(got[..., :2], want[..., :2],
                                    maxulp=centroid_ulps)


def assert_same_state(js, ts):
    """Every field of every env bit-equal."""
    t = state_to_numpy(ts)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(t[f], np.asarray(getattr(js, f)),
                                      err_msg=f)


def _compare_step(j, t, centroid_ulps=0):
    (jo, jr, jd), (to, tr, td) = j, t
    assert_ram_equal(to.numpy(), jo, centroid_ulps)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert td.dtype == torch.bool
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def _compare_state(js, ts):
    t = state_to_numpy(ts)
    for f in INT_FIELDS + F32_FIELDS:
        np.testing.assert_array_equal(t[f], np.asarray(getattr(js, f)),
                                      err_msg=f)


def test_resident_multi_step_matches_pallas_interpret():
    cfg_j = JCfg(**KW)
    tenv = TVec(TCfg(**KW), N, "ram", backend="torch", device="cpu")
    jenv = JVec(cfg_j, N, obs_type="ram", backend="xla", donate=False)
    ts, tobs0 = tenv.reset(5)
    js, jobs0 = jenv.reset(5)
    assert_ram_equal(tobs0.numpy(), jobs0)
    res = tenv.make_resident(ts)
    assert isinstance(res, fused_step.ResidentState)
    jres = JFS.to_resident(cfg_j, js)
    obs_fn = functools.partial(j_ram, cfg_j, JR())
    for k in (2, 1):                  # the carrier passes between calls
        res, *t_out = tenv.multi_step(res, ACTS, k)
        jres, *j_out = JFS.fused_env_multi_step_resident(
            cfg_j, jres, jnp.asarray(ACTS), k, obs_fn=obs_fn, block_envs=4,
            interpret=True)
        _compare_step(j_out, t_out)
    _compare_state(JFS.from_resident(cfg_j, js, jres), tenv.materialize(res))


@pytest.mark.parametrize("resident", [False, True])
def test_multi_step_matches_xla_vecenv(resident):
    tenv = TVec(TCfg(**KW), N, "ram", backend="torch", device="cpu")
    jenv = JVec(JCfg(**KW), N, obs_type="ram", backend="xla", donate=False)
    ts, _ = tenv.reset(11)
    js, _ = jenv.reset(11)
    if resident:
        ts = tenv.make_resident(ts)
    for _ in range(2):
        ts, *t_out = tenv.multi_step(ts, ACTS, K)
        js, *j_out = xla_step_chain(jenv, js, ACTS, K)
        _compare_step(j_out, t_out, centroid_ulps=1)
    assert isinstance(ts, fused_step.ResidentState) == resident
    _compare_state(js, tenv.materialize(ts))


# (configuration, ulps of RAM features 0 and 1): bench.py:103-151's game
# (measured: 119 of 512 values 1 ulp off, none more); examples/train_ppo.py's
# task, agarcl_tpu_torch/train_ppo.py::task_config (280 values 1 ulp off and
# 12 values 2 ulps: XLA's form rounds twice, the port's three times); the
# duel of bench/tasks_configs/mode_10.json, whose two players put a slice
# between the centroid and the division, so XLA keeps the reciprocal
RAM_CHAINS = {
    "bench_mode4": (dict(num_agents=1, ticks_per_step=4, arena_size=350,
                         num_pellets=500, num_viruses=10, mode=4), 1),
    "ppo_mode3": (dict(num_agents=1, ticks_per_step=4, arena_size=60,
                       num_pellets=200, num_viruses=0, mode=3), 2),
    "duel_mode10": (dict(num_agents=1, ticks_per_step=4, arena_size=350,
                         num_pellets=500, num_viruses=0, num_bots=1,
                         mode=10), 0),
}


@pytest.mark.parametrize("name", sorted(RAM_CHAINS))
def test_ram_step_chain_matches_xla_step(name):
    """8 steps from reset(0) with seeded random actions: the port's plain
    RAM step chain against the XLA VecEnv's step chain. State, rewards,
    dones and RAM features 2 and up bit-equal; features 0 and 1 within the
    ulps of the configuration (ROADMAP.md Queue 3 item 2)."""
    kw, ulps = RAM_CHAINS[name]
    n = 32
    tenv = TVec(TCfg(**kw), n, "ram", backend="torch", device="cpu")
    jenv = JVec(JCfg(**kw), n, obs_type="ram", backend="xla", donate=False)
    ts, to = tenv.reset(0)
    js, jo = jenv.reset(0)
    assert_ram_equal(to.numpy(), jo)
    rng = np.random.default_rng(0)
    for _ in range(8):
        acts = np.concatenate([rng.uniform(-1, 1, (n, 1, 2)),
                               rng.integers(0, 3, (n, 1, 1))],
                              -1).astype(np.float32)
        ts, *t_out = tenv.step(ts, acts)
        js, *j_out = jenv.step(js, jnp.asarray(acts))
        _compare_step(j_out, t_out, ulps)
        assert_same_state(js, ts)


def test_step_shapes_and_obs_none():
    tenv = TVec(TCfg(**KW), N, "ram", backend="torch", device="cpu")
    s, obs0 = tenv.reset(0)
    assert tuple(obs0.shape) == (N, 1, 231)
    s, obs, r, d = tenv.step(s, ACTS)
    assert tuple(obs.shape) == (N, 1, 1, 231)
    assert tuple(r.shape) == (N, 1) and tuple(d.shape) == (N, 1)
    env0 = TVec(TCfg(**KW), N, "none", backend="torch", device="cpu")
    s, obs0 = env0.reset(0)
    res, obs, r, d = env0.multi_step(env0.make_resident(s), ACTS, 2)
    assert obs0 is None and obs is None and tuple(r.shape) == (2, N, 1)


def test_vecenv_rejects_unported_configurations():
    # "gobigger" is ported now; an unknown observation type still raises
    with pytest.raises(ValueError, match="pixels"):
        TVec(TCfg(**KW), N, "pixels", backend="torch", device="cpu")
    with pytest.raises(NotImplementedError):
        TVec(TCfg(**dict(KW, mode=0, num_bots=9)), N, "ram")

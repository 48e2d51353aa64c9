"""VecEnv(backend="torch") of the port against the JAX package's resident
multi-step path (the Pallas kernel in interpret mode, as
tests/test_fused_tick.py::test_resident_multi_step_parity) and its XLA
VecEnv."""

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
from agarcl_tpu_torch.vec import VecEnv as TVec

KW = dict(num_agents=1, ticks_per_step=2, arena_size=100, num_pellets=40,
          num_viruses=2, num_bots=0, reward_type=True, mode=4)
N, K = 4, 3
ACTS = np.tile(np.asarray([[0.6, -0.4, 1.0]], np.float32), (N, 1, 1))
TOL_OBS = dict(rtol=1e-5, atol=1e-4)
INT_FIELDS = ("cell_mass", "cell_alive", "cell_id", "pellet_key",
              "virus_alive", "virus_mass", "food_alive", "food_next",
              "ticks", "next_cell_id", "dones", "seed", "elapsed_ticks")
F32_FIELDS = ("cell_pos", "cell_vel", "virus_pos", "food_pos", "target")


def _compare_step(j, t):
    (jo, jr, jd), (to, tr, td) = j, t
    assert tuple(to.shape) == jo.shape
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL_OBS)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5,
                               rtol=0)
    assert td.dtype == torch.bool
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def _compare_state(js, ts):
    t = state_to_numpy(ts)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(t[f], np.asarray(getattr(js, f)),
                                      err_msg=f)
    for f in F32_FIELDS:
        np.testing.assert_allclose(t[f], np.asarray(getattr(js, f)),
                                   atol=2e-3, rtol=0, err_msg=f)


def test_resident_multi_step_matches_pallas_interpret():
    cfg_j = JCfg(**KW)
    tenv = TVec(TCfg(**KW), N, "ram", backend="torch", device="cpu")
    jenv = JVec(cfg_j, N, obs_type="ram", backend="xla", donate=False)
    ts, tobs0 = tenv.reset(5)
    js, jobs0 = jenv.reset(5)
    np.testing.assert_allclose(tobs0.numpy(), np.asarray(jobs0), **TOL_OBS)
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
        js, *j_out = jenv.multi_step(js, jnp.asarray(ACTS), K)
        _compare_step(j_out, t_out)
    assert isinstance(ts, fused_step.ResidentState) == resident
    _compare_state(js, tenv.materialize(ts))


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

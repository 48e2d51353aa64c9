"""The port's GoBigger observation against the JAX package:
obs/gobigger.py::gobigger_frame against the JAX gobigger_frame under
jit(vmap) on played states with split cells (moving clones exercise the
direction column, an f32 atan), one agent and two; every array bit-equal.
Then the host rim (to_player_states / batch_player_states) and
VecEnv(obs_type="gobigger", backend="torch") against the XLA VecEnv."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agarcl_tpu import EnvConfig as JCfg
from agarcl_tpu.obs import gobigger as JGB
from agarcl_tpu.state import GameState as JState
from agarcl_tpu.vec import VecEnv as JVec
from agarcl_tpu_torch import EnvConfig as TCfg
from agarcl_tpu_torch.bridge import state_from_numpy, state_to_numpy
from agarcl_tpu_torch.obs import gobigger as TGB
from agarcl_tpu_torch.vec import VecEnv as TVec

torch.set_num_threads(1)
SOLO = dict(num_agents=1, ticks_per_step=2, arena_size=120, num_pellets=80,
            num_viruses=4, mode=4)
TWO = dict(num_agents=2, ticks_per_step=2, arena_size=120, num_pellets=80,
           num_viruses=4, num_bots=1, mode=0)
N = 6


@functools.lru_cache(maxsize=None)
def _played(name):
    """(N,) batched states after 5 steps of the port's plain engine, as a
    JAX GameState; the agents start at mass 400 and split on every other
    step, so several clones move."""
    kw = SOLO if name == "solo" else TWO
    cfg = TCfg(**kw)
    A = cfg.num_agents
    env = TVec(cfg, N, "none", backend="torch", device="cpu")
    s, _ = env.reset(5)
    cm = s.cell_mass.clone()
    cm[:, :A, 0] = 400
    s = s.replace(cell_mass=cm)
    rng = np.random.default_rng(2)
    for t in range(5):
        act = np.full((N, A, 1), 2 if t % 2 == 0 else 0)
        acts = np.concatenate([rng.uniform(-1, 1, (N, A, 2)), act], -1)
        s = env.step(s, torch.from_numpy(acts.astype(np.float32)))[0]
    return JState(**{f: jnp.asarray(a)
                     for f, a in state_to_numpy(s).items()})


def _fields(js):
    return {f: np.asarray(getattr(js, f)) for f in js.__dataclass_fields__}


@pytest.mark.parametrize("name", ["solo", "two"])
def test_gobigger_frame_bit_equal(name):
    kw = SOLO if name == "solo" else TWO
    js = _played(name)
    jf = jax.jit(jax.vmap(functools.partial(
        JGB.gobigger_frame, JCfg(**kw), JGB.GoBiggerObsConfig())))(js)
    tf = TGB.gobigger_frame(TCfg(**kw), TGB.GoBiggerObsConfig(),
                            state_from_numpy(_fields(js)))
    assert set(tf) == set(jf)
    for k in jf:
        want = np.ascontiguousarray(jf[k])
        got = np.ascontiguousarray(tf[k].numpy())
        assert got.shape == want.shape and got.dtype == want.dtype, k
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                      err_msg=k)
    assert int(np.asarray(jf["clones_mask"]).sum()) > 2 * N
    assert np.abs(np.asarray(jf["clones"])[..., 6]).max() > 0   # directions


def test_player_states_rim():
    kw = TWO
    js = _played("two")
    jf = jax.jit(jax.vmap(functools.partial(
        JGB.gobigger_frame, JCfg(**kw), JGB.GoBiggerObsConfig())))(js)
    tf = TGB.gobigger_frame(TCfg(**kw), TGB.GoBiggerObsConfig(),
                            state_from_numpy(_fields(js)))
    for env in (0, N - 1):
        jg, jp = JGB.batch_player_states(JCfg(**kw), JGB.GoBiggerObsConfig(),
                                         jf, env)
        tg, tp = TGB.batch_player_states(TCfg(**kw), TGB.GoBiggerObsConfig(),
                                         tf, env)
        assert vars(tg) == vars(jg)
        assert sorted(tp) == sorted(jp)
        for a in jp:
            assert repr(tp[a]) == repr(jp[a])


def test_vec_env_gobigger_matches_xla():
    """VecEnv(obs_type="gobigger") on the plain engine against the XLA
    VecEnv: reset frame and 2 steps (frames, rewards and dones
    bit-equal)."""
    kw = SOLO
    rng = np.random.default_rng(4)
    acts = np.concatenate([rng.uniform(-1, 1, (N, 1, 2)),
                           rng.integers(0, 3, (N, 1, 1))], -1).astype(
                               np.float32)
    jenv = JVec(JCfg(**kw), N, obs_type="gobigger")
    tenv = TVec(TCfg(**kw), N, "gobigger", backend="torch", device="cpu")
    js, jo = jenv.reset(3)
    ts, to = tenv.reset(3)
    for k in jo:
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]), k)
    for _ in range(2):
        js, jo, jr, jd = jenv.step(js, jnp.asarray(acts))
        ts, to, tr, td = tenv.step(ts, torch.from_numpy(acts))
        for k in jo:
            np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]),
                                          k)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))

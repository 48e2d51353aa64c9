"""Steps that return F frames (num_frames > 1) and K1's partial-step mode.

- The plain F-frame step (VecEnv(backend="torch"), env.py::env_step) against
  the JAX VecEnv's vmapped env_step: the screen at F = 2 and the grid at
  F = 4, frames, rewards and dones bit-equal; F = 6 > the 4 ticks of a
  step pads two zero frames in front, as the XLA env_step.
- `engine_tick_raw_plain` (K1's partial-step mode, plain version) against a
  jitted lax.scan of the JAX engine_tick: every field bit-equal.
- The kernel path's chain (ops/fused_step.py::_framed_step: K1 with the
  actions and ticks_per_step - F + 1 ticks, then F - 1 one-tick calls) run
  on CPU tensors, where every wrapper takes its plain version, against the
  plain backend: the resident multi_step and fused_env_step, exact.
- fused_env_step drawing into a caller's `out` (VecEnv's per-step path on
  the card, each step into its slice of the call's buffer) against its
  fresh-buffer frames stacked, at F = 1, 2 and 3 (a zero frame at 2 ticks a step), exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import port_states
import pytest
import torch

from agarcl_tpu import EnvConfig as JCfg
from agarcl_tpu.engine.tick import engine_tick as j_tick
from agarcl_tpu.env import apply_actions as j_apply
from agarcl_tpu.obs.grid import GridObsConfig as JGrid
from agarcl_tpu.obs.screen import ScreenObsConfig as JScreen
from agarcl_tpu.vec import VecEnv as JVec
from agarcl_tpu_torch import EnvConfig as TCfg
from agarcl_tpu_torch.bridge import state_from_numpy, state_to_numpy
from agarcl_tpu_torch.obs.grid import GridObsConfig as TGrid
from agarcl_tpu_torch.obs.screen import ScreenObsConfig as TScreen
from agarcl_tpu_torch.ops import fused_step
from agarcl_tpu_torch.ops import fused_tick as FT
from agarcl_tpu_torch.vec import VecEnv as TVec

torch.set_num_threads(1)
KW = dict(num_agents=1, ticks_per_step=4, arena_size=120, num_pellets=80,
          num_viruses=4, mode=4)
N = 4
INT_FIELDS = ("cell_mass", "cell_alive", "cell_id", "pellet_key",
              "virus_alive", "virus_mass", "food_alive", "food_eaten",
              "ticks", "next_cell_id", "food_next", "split_cooldown",
              "feed_cooldown", "action")
F32_FIELDS = ("cell_pos", "cell_vel", "cell_split_vel", "virus_pos",
              "food_pos", "food_vel", "target")


def _acts(seed, n=N, agents=1):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-1, 1, (n, agents, 2)),
                           rng.integers(0, 3, (n, agents, 1))],
                          -1).astype(np.float32)


def _vec_pair(kind, F):
    if kind == "screen":
        jo = JScreen(screen_len=32, agent_view=True, num_frames=F)
        to = TScreen(screen_len=32, agent_view=True, num_frames=F)
    else:
        jo = JGrid(num_frames=F, grid_size=32)
        to = TGrid(num_frames=F, grid_size=32)
    return (JVec(JCfg(**KW), N, obs_type=kind, obs_config=jo),
            TVec(TCfg(**KW), N, kind, backend="torch", device="cpu",
                 obs_config=to))


@pytest.mark.parametrize("kind,F", [("screen", 2), ("grid", 4),
                                    ("grid", 6)])
def test_plain_frames_match_xla_vec_env(kind, F):
    jenv, tenv = _vec_pair(kind, F)
    ts, _ = tenv.reset(3)
    js = port_states.to_jax(ts)
    for t in range(3):
        acts = _acts(t)
        js, jo, jr, jd = jenv.step(js, jnp.asarray(acts))
        ts, to, tr, td = tenv.step(ts, torch.from_numpy(acts))
        assert tuple(to.shape) == np.asarray(jo).shape
        assert to.shape[1] == F
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    if F > KW["ticks_per_step"]:
        assert not to[:, :F - KW["ticks_per_step"]].any()
        assert to[:, F - KW["ticks_per_step"]:].any()


@functools.lru_cache(maxsize=None)
def _j_chain():
    """jit(vmap) of optional apply_actions, then a lax.scan of 3 ticks of
    which the first n apply: one compile for every case."""
    cfg = JCfg(**KW)

    def run(state, acts, n, with_actions):
        state = jax.tree.map(functools.partial(jnp.where, with_actions),
                             j_apply(cfg, state, acts), state)

        def body(s, i):
            return jax.tree.map(functools.partial(jnp.where, i < n),
                                j_tick(cfg, s), s), None
        return jax.lax.scan(body, state, jnp.arange(3))[0]
    return jax.jit(jax.vmap(run, in_axes=(0, 0, None, None)))


@functools.lru_cache(maxsize=None)
def _played():
    """A state after 2 steps of the port's plain engine (splits, feeds)."""
    env = TVec(TCfg(**KW), N, "none", backend="torch", device="cpu")
    s, _ = env.reset(9)
    s = s.replace(cell_mass=s.cell_mass.index_fill(2, torch.tensor([0]),
                                                   300))
    return env.multi_step(s, torch.from_numpy(_acts(1)), 2)[0]


@pytest.mark.parametrize("n_ticks,with_actions", [(1, False), (3, True),
                                                  (3, False)])
def test_engine_tick_raw_plain_matches_jax_scan(n_ticks, with_actions):
    ts = _played()
    js = port_states.to_jax(ts)
    want = _j_chain()(js, jnp.asarray(_acts(2)), n_ticks, with_actions)
    planes, obs, info = FT.engine_tick_raw_plain(
        TCfg(**KW), FT.to_kernel_arrays(ts), n_ticks,
        actions=torch.from_numpy(_acts(2)) if with_actions else None)
    assert obs is None and tuple(info.shape) == (N, 2, 1)
    got = state_to_numpy(FT.from_kernel_arrays(ts, planes))
    for f in INT_FIELDS + F32_FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(info[:, 0, 0].numpy(),
                                  got["cell_mass"].sum((1, 2)))


def _same(a, b):
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind,F", [("screen", 2), ("grid", 4),
                                    ("grid", 6)])
def test_kernel_chain_on_cpu_matches_plain(kind, F):
    """multi_step_resident's F-frame chain (the cuda backend's route, whose
    wrappers take their plain versions on CPU tensors) against the plain
    backend over 2 steps, stacked and as a tuple; then fused_env_step (the
    per-step route) for one step."""
    cfg = TCfg(**KW)
    _, tenv = _vec_pair(kind, F)
    s0, _ = tenv.reset(5)
    acts = torch.from_numpy(_acts(3))
    want = tenv.multi_step(s0, acts, 2)
    before = FT.plain_calls
    for stack in (True, False):
        res, obs, r, d = fused_step.multi_step_resident(
            cfg, fused_step.to_resident(cfg, s0), acts, 2, tenv.ocfg,
            stack_obs=stack)
        _same(obs if stack else torch.stack(obs), want[1])
        assert torch.equal(r, want[2]) and torch.equal(d, want[3])
        _same(fused_step.from_resident(cfg, res).cell_pos, want[0].cell_pos)
    Fe = min(F, KW["ticks_per_step"])
    assert FT.plain_calls - before == 2 * 2 * Fe      # K1 calls of the chain
    s1, o1, r1, d1 = fused_step.fused_env_step(cfg, s0, acts, tenv.ocfg, F)
    w1 = tenv.step(s0, acts)
    _same(o1, w1[1])
    assert torch.equal(r1, w1[2]) and torch.equal(d1, w1[3])
    _same(s1.cell_pos, w1[0].cell_pos)


@pytest.mark.parametrize("tps,F", [(1, 1), (2, 2), (2, 3)])
def test_fused_env_step_draws_into_out(tps, F):
    """k = 3 steps of 3 envs on a 32x32 screen drawn into the slices of one
    (k, F, N, A, ...) buffer give the frames, rewards and dones of the
    fresh-buffer steps stacked; the frames are views of the buffer, the
    fresh ones are not, and the zero frames of F > ticks_per_step overwrite
    what the buffer held. (ticks_per_step 1 and 2: the tick is most of the
    test's time.)"""
    cfg, n, k = TCfg(**dict(KW, ticks_per_step=tps)), 3, 3
    ocfg = TScreen(screen_len=32, agent_view=True, num_frames=F)
    env = TVec(cfg, n, "screen", backend="torch", device="cpu",
               obs_config=ocfg)
    s_fresh = s_out = env.reset(5)[0]
    acts = torch.from_numpy(_acts(3, n))
    buf = fused_step.frame_buffer(cfg, ocfg, (k, F), n, "cpu").fill_(7)
    lo, hi = buf.data_ptr(), buf.data_ptr() + buf.nbytes
    fresh = []
    for t in range(k):
        s_fresh, o, r, d = fused_step.fused_env_step(cfg, s_fresh, acts,
                                                     ocfg, F)
        s_out, o_t, r_t, d_t = fused_step.fused_env_step(
            cfg, s_out, acts, ocfg, F, out=buf[t])
        assert not lo <= o.data_ptr() < hi
        assert o_t.data_ptr() == buf[t].data_ptr()
        assert torch.equal(r_t, r) and torch.equal(d_t, d)
        fresh.append(o)
    _same(buf.transpose(1, 2), torch.stack(fresh))
    _same(s_out.cell_pos, s_fresh.cell_pos)
    assert buf[:, F - min(F, tps):].any()
    assert not buf[:, :F - min(F, tps)].any()

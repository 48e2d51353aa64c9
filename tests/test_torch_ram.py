"""The port's RAM frame (obs/ram.py::ram_frame, the plain version of the
RAM-frame kernel) against the JAX package's XLA frame and its Pallas
kernel in interpret mode, on a stepped state (as
tests/test_fused_tick.py::test_fused_ram_obs_parity), bit for bit: the
JAX suite's own bar is rtol 1e-5 / atol 1e-4 (tests/test_fused_tick.py:
263-264)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import port_states
import torch

from agarcl_tpu import EnvConfig as JCfg
from agarcl_tpu.obs.ram import RamObsConfig as JR
from agarcl_tpu.obs.ram import pack_nearest_key as j_pack
from agarcl_tpu.obs.ram import ram_frame as j_ram
from agarcl_tpu.ops.fused_obs import fused_ram_obs as j_fused_ram
from agarcl_tpu_torch import EnvConfig as TCfg
from agarcl_tpu_torch.bridge import state_from_numpy
from agarcl_tpu_torch.obs.ram import RamObsConfig as TR
from agarcl_tpu_torch.obs.ram import pack_nearest_key as t_pack
from agarcl_tpu_torch.obs.ram import ram_frame as t_ram
from agarcl_tpu_torch.obs.ram import ram_size
from agarcl_tpu_torch.ops import fused_obs
from agarcl_tpu_torch.ops.fused_tick import to_kernel_arrays
from agarcl_tpu_torch.vec import VecEnv as TVec

KW = dict(num_agents=1, ticks_per_step=4, arena_size=120, num_pellets=100,
          num_viruses=4, num_bots=0, mode=4)


@functools.lru_cache(maxsize=None)
def _stepped():
    """8 envs of the JAX VecEnv's reset(5) after 3 steps, played by the
    port's plain VecEnv (bit-equal to the XLA VecEnv, test_torch_vec.py)."""
    env = TVec(TCfg(**KW), 8, "none", backend="torch", device="cpu")
    states, _ = env.reset(5)
    acts = np.tile(np.asarray([[0.6, -0.4, 1.0]], np.float32), (8, 1, 1))
    for _ in range(3):
        states = env.step(states, acts)[0]
    return port_states.to_jax(states)


def _port_state(js):
    return state_from_numpy({f: np.asarray(getattr(js, f))
                             for f in js.__dataclass_fields__})


def test_ram_frame_matches_xla_and_pallas_interpret():
    js = _stepped()
    ts = _port_state(js)
    got = t_ram(TCfg(**KW), TR(), ts).numpy()
    assert got.shape == (8, 1, ram_size(TCfg(**KW), TR()))
    ref = np.asarray(jax.jit(jax.vmap(functools.partial(
        j_ram, JCfg(**KW), JR())))(js))
    np.testing.assert_array_equal(got, ref)
    ker = np.asarray(j_fused_ram(JCfg(**KW), JR(), js, block_envs=1,
                                 interpret=True))
    np.testing.assert_array_equal(got, ker)
    assert (got[:, 0, 3 + 16 * 6 + 2::3][:, :32] == 1.0).all()  # 32 found


def test_fused_ram_obs_cpu_planes_take_the_plain_version():
    ts = _port_state(_stepped())
    cfg, ocfg = TCfg(**KW), TR(num_pellets=7, num_viruses=3)
    before = fused_obs.plain_calls, fused_obs.launches
    got = fused_obs.fused_ram_obs(cfg, ocfg, to_kernel_arrays(ts))
    assert (fused_obs.plain_calls, fused_obs.launches) == (
        before[0] + 1, before[1])
    torch.testing.assert_close(got, t_ram(cfg, ocfg, ts), rtol=0, atol=0)


def test_pack_nearest_key_matches():
    rng = np.random.default_rng(3)
    d2 = rng.uniform(0, 5e4, (5, 500)).astype(np.float32)
    d2[:, :10] = d2[:, :1]                                 # exact ties
    idx = np.broadcast_to(np.arange(500, dtype=np.int32), d2.shape)
    alive = rng.random(d2.shape) < 0.9
    j = np.asarray(j_pack(jnp.asarray(d2), jnp.asarray(idx),
                          jnp.asarray(alive), 500))
    t = t_pack(torch.from_numpy(d2), torch.from_numpy(idx.copy()),
               torch.from_numpy(alive), 500).numpy()
    np.testing.assert_array_equal(j, t)
    live = t[alive]
    assert np.unique(live).size == live.size               # unique keys

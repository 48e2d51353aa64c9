"""Game states for the port's tests, played by the port's plain engine on the
CPU and handed to the JAX package as numpy arrays.

A test that needs a played state but holds the port to something else (a
frame, a section build, a bridge) takes it from here, so that it compiles
only the JAX programs it compares against: a jitted and vmapped JAX step
takes seconds to trace and compile in every test process, the port's plain
step a fraction of one. These are the states the JAX package plays from the
same seeds and actions; the tests that hold each configuration's reset and
step bit for bit against JAX's:

- played() in test_torch_screen.py and test_torch_grid.py (SOLO, DUEL, the
  split states at 6 and 64 envs), the oracle's mode-6 player and the resets
  of the screen and grid auto-reset and respawn tests: test_torch_state.py::
  test_port_states_played_bit_equal_to_jax, one case each;
- test_torch_polygon.py's duel: the same test's mode-7 case ("duel");
- test_torch_state.py's ticks: test_torch_engine.py's tick tests (mode 4);
- test_torch_ram.py's and test_torch_vec.py's VecEnv (mode 4):
  test_torch_vec.py::test_ram_step_chain_matches_xla_step[bench_mode4];
- test_torch_frames.py's reset (mode 4): test_torch_state.py::
  test_reset_float_state_bit_equal_to_jax and test_torch_engine.py::
  test_env_reset_bit_equal;
- test_torch_multiplayer.py's mode-10 duel and mode-0 resets and its
  9-player tick: the same file's test_vecenv_duel_screen_matches_xla and
  test_engine_tick_per_tick_matches_xla (duel10, mode0_4bots,
  mode0_8bots)."""

import jax.numpy as jnp
import numpy as np
import torch

from agarcl_tpu.state import GameState as JState
from agarcl_tpu_torch import EnvConfig as TCfg
from agarcl_tpu_torch.bridge import state_to_numpy
from agarcl_tpu_torch.env import env_reset, env_step


def reset(kw, seeds):
    """The port's env_reset of `kw` on (n,) seeds."""
    return env_reset(TCfg(**kw), torch.as_tensor(np.asarray(seeds, np.int64)))


def step(kw, ts, acts):
    """One env_step of the port: (n, A, 3) actions, the next state."""
    return env_step(TCfg(**kw), ts, torch.as_tensor(
        np.asarray(acts, np.float32)))[0]


def to_jax(ts, like=None):
    """The port's state as a JAX GameState: the bridge's numpy fields, or
    with `like` (a JAX state) each field in `like`'s dtype, so that a test
    of the bridge does not take its dtypes from the bridge."""
    fields = state_to_numpy(ts)
    if like is None:
        return JState(**{f: jnp.asarray(a) for f, a in fields.items()})
    return like.replace(**{f: jnp.asarray(a, getattr(like, f).dtype)
                           for f, a in fields.items()})


def played(kw, seed, steps, split=False, n=6):
    """(n,) states after `steps` random steps from seeds seed..seed+n-1
    (splits and feeds); `split` starts the agents at mass 400 and splits
    every step, so each ends with 2-10 cells. A JAX GameState."""
    ts = reset(kw, np.arange(n) + seed)
    if split:
        mass = ts.cell_mass.clone()
        mass[:, 0, 0] = 400
        ts = ts.replace(cell_mass=mass)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        act = (np.full((n, 1, 1), 2) if split
               else rng.integers(0, 3, (n, 1, 1)))
        ts = step(kw, ts, np.concatenate(
            [rng.uniform(-1, 1, (n, 1, 2)), act], -1))
    return to_jax(ts)

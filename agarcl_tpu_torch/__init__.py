"""agarcl_tpu_torch — the PyTorch + CUDA port of agarcl_tpu.

The JAX package `agarcl_tpu` is the reference; this package mirrors its
module names (config, prng, state, engine/*, env, obs/ram, obs/screen,
obs/grid, obs/gobigger, ops/fused_*, vec, io/*, gym_env, tasks) so each
piece has a counterpart to be held against. It imports torch, numpy and
the standard library only, never JAX (gym_env.py adds gymnasium; its
core, gym_core.py, does without).

Plain functions work on batch-first tensors ((N, P, Cc), (N, Np), ...) on
any device. `VecEnv` and the gym wrapper run on the card by default through
four hand-written CUDA C++ kernels for Hopper (csrc/): K1, the tick
(ops/fused_tick.py: whole steps, or n ticks without actions between the
frames of a step that returns several), K2, the RAM frame
(ops/fused_obs.py), K3, the screen frame (ops/fused_screen.py) and K4, the
grid frame (ops/fused_grid.py), built with nvcc at first use.

The engine draws no random numbers from torch: every random draw is the
counter hash of prng.py (SPEC D2), a pure function of (seed, stream, tick,
slot, axis), so no torch.Generator exists anywhere in the port.
"""

from agarcl_tpu_torch.config import EnvConfig, ModeSpec
from agarcl_tpu_torch.env import (apply_actions, env_reset, env_step,
                                  respawn_players)
from agarcl_tpu_torch.state import GameState, zero_state

__all__ = ["EnvConfig", "ModeSpec", "GameState", "zero_state", "env_reset",
           "env_step", "apply_actions", "respawn_players", "VecEnv"]


def __getattr__(name):
    if name == "VecEnv":
        from agarcl_tpu_torch.vec import VecEnv
        return VecEnv
    raise AttributeError(name)

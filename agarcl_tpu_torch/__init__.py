"""agarcl_tpu_torch — the PyTorch + CUDA port of agarcl_tpu.

The JAX package `agarcl_tpu` is the reference; this package mirrors its
module names (config, prng, state, engine/*, env, obs/ram, obs/screen,
ops/fused_*, vec) so each piece has a counterpart to be held against. It
imports torch, numpy and the standard library only, never JAX.

Plain functions work on batch-first tensors ((N, P, Cc), (N, Np), ...) on
any device. `VecEnv` runs on the card by default through three
hand-written CUDA C++ kernels for Hopper (csrc/): the multi-step tick
(ops/fused_tick.py), the RAM frame (ops/fused_obs.py) and the screen frame
(ops/fused_screen.py), built with nvcc at first use.

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

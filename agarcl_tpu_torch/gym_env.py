"""Gymnasium wrapper (counterpart of agarcl_tpu/gym_env.py).

`AgarioEnv` is `gym_core.AgarioCore` as a gym.Env, the API of the
reference's gym_agario.AgarioEnv: obs types "ram", "grid", "screen" and
"gobigger", the action space Tuple(Box(-1, 1, (2,)), Discrete(3)), the
multi-agent list protocol, the episodic cutoff, the difficulty presets,
seed, snapshots and video. It runs on the card unless the caller passes
device="cpu". Importing this module registers the ids
`agarcl_torch/agario-{grid,screen,gobigger,ram}-v0`, in a namespace of
their own, so that they live beside the JAX package's `agario-*-v0` in one
process.
"""

from __future__ import annotations

import gymnasium as gym
import numpy as np
from gymnasium import spaces

from agarcl_tpu_torch.gym_core import AgarioCore

NAMESPACE = "agarcl_torch"


class AgarioEnv(AgarioCore, gym.Env):
    """The gym.Env of the port: `AgarioCore`'s episodes, snapshots and
    video, with the reference's observation and action spaces."""
    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 60}

    def __init__(self, obs_type="grid", render_mode=None, device=None,
                 backend=None, **kwargs):
        AgarioCore.__init__(self, obs_type, render_mode, device, backend,
                            **kwargs)
        shape, dtype = self.observation_shape()
        if obs_type == "grid":
            low, high = -1, np.iinfo(dtype).max
        elif obs_type == "screen":
            low, high = 0, 255
        else:
            low, high = -np.inf, np.inf
        self.observation_space = spaces.Box(low, high, shape, dtype=dtype)
        self.action_space = spaces.Tuple((
            spaces.Box(low=-1, high=1, shape=(2,)),
            spaces.Discrete(3),
        ))


_REGISTERED = False


def register_envs():
    """Register agarcl_torch/agario-{grid,screen,gobigger,ram}-v0."""
    global _REGISTERED
    if _REGISTERED:
        return
    from gymnasium.envs.registration import register
    for obs_type in ("grid", "screen", "gobigger", "ram"):
        register(id=f"{NAMESPACE}/agario-{obs_type}-v0",
                 entry_point="agarcl_tpu_torch.gym_env:AgarioEnv",
                 kwargs={"obs_type": obs_type})
    _REGISTERED = True


register_envs()

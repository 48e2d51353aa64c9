"""The 10-task continual-learning suite (counterpart of tasks.py).

The reference ships 10 task JSONs (bench/tasks_configs/mode_{1..10}.json)
that bind the mode system to full env configs: a shared template (arena
350, 500 pellets, a 128 x 128 agent-view screen, episodic) with per-mode
overrides: modes 1-2 (500 steps), 3-6 (3000 steps), 7-10 (one bot, 10000
steps). `task_config` and `write_task_configs` regenerate them;
`load_task` builds the port's gym AgarioEnv from one, `load_task_core` the
gymnasium-free AgarioCore (gym_core.py). Both run on the card unless
device="cpu" is passed.
"""

from __future__ import annotations

import json
import os
from typing import Optional

_TEMPLATE = {
    "ticks_per_step": 4,
    "num_frames": 1,
    "arena_size": 350,
    "num_pellets": 500,
    "num_viruses": 0,
    "num_bots": 0,
    "pellet_regen": True,
    "grid_size": 128,
    "screen_len": 128,
    "observe_cells": False,
    "observe_others": False,
    "observe_viruses": False,
    "observe_pellets": False,
    "obs_type": "screen",
    "render_mode": "rgb_array",
    "reward_type": 1,
    "c_death": 0,
    "video_path": "screen_video.mp4",
    "agent_view": True,
    "add_noise": True,
    "mode": 1,
    "number_steps": 500,
    "env_type": 0,
    "load_env_snapshot": 0,
}

_OVERRIDES = {
    1: {},
    2: {"mode": 2},
    3: {"mode": 3, "number_steps": 3000},
    4: {"mode": 4, "number_steps": 3000},
    5: {"mode": 5, "number_steps": 3000},
    6: {"mode": 6, "number_steps": 3000},
    7: {"num_bots": 1, "mode": 7, "number_steps": 10000},
    8: {"num_bots": 1, "mode": 8, "number_steps": 10000},
    9: {"num_bots": 1, "mode": 9, "number_steps": 10000},
    10: {"num_bots": 1, "mode": 10, "number_steps": 10000},
}


def task_config(mode: int) -> dict:
    """The full config dict of task `mode` (1..10)."""
    if mode not in _OVERRIDES:
        raise ValueError(f"unknown task mode {mode}")
    cfg = dict(_TEMPLATE)
    cfg.update(_OVERRIDES[mode])
    return cfg


def write_task_configs(directory: str) -> None:
    """Write mode_1.json .. mode_10.json (the reference's schema)."""
    os.makedirs(directory, exist_ok=True)
    for mode in _OVERRIDES:
        with open(os.path.join(directory, f"mode_{mode}.json"), "w") as f:
            json.dump(task_config(mode), f, indent=4)


def _task_kwargs(path_or_mode, obs_type: Optional[str]):
    """(obs_type, render_mode, env kwargs) of a task file or number;
    obs_type overrides the file's (e.g. 'grid' off the same tasks)."""
    if isinstance(path_or_mode, int):
        cfg = task_config(path_or_mode)
    else:
        with open(path_or_mode) as f:
            cfg = json.load(f)
    kwargs = dict(cfg)
    ot = obs_type or kwargs.pop("obs_type", "screen")
    kwargs.pop("obs_type", None)
    kwargs.pop("video_path", None)
    render_mode = kwargs.pop("render_mode", None)
    kwargs.pop("load_env_snapshot", None)
    # every task file sets add_noise true, so the tasks run with action
    # noise on; a file without the key runs without it
    kwargs.setdefault("add_noise", False)
    return ot, render_mode, kwargs


def load_task(path_or_mode, obs_type: Optional[str] = None, device=None):
    """The gym AgarioEnv of a task file path or task number."""
    from agarcl_tpu_torch.gym_env import AgarioEnv
    ot, render_mode, kwargs = _task_kwargs(path_or_mode, obs_type)
    return AgarioEnv(obs_type=ot, render_mode=render_mode, device=device,
                     **kwargs)


def load_task_core(path_or_mode, obs_type: Optional[str] = None,
                   device=None, backend=None):
    """The AgarioCore (no gymnasium) of a task file path or task number."""
    from agarcl_tpu_torch.gym_core import AgarioCore
    ot, render_mode, kwargs = _task_kwargs(path_or_mode, obs_type)
    return AgarioCore(ot, render_mode, device, backend, **kwargs)

"""The single-env Gymnasium step of an AgarCL task, as a frozen rule: the
action protocol with the task's optional action noise, and the episodic
cutoff (AgarioEnv.py; the port's gym_core.py holds the same rules).

Noise: with add_noise, each step adds N(0, 0.1) to dx and dy, drawn two
at a time from one numpy Generator seeded with 0 when the env is built and
never reseeded, then clips to [-1, 1]. Step i of the env's life (counting
every step since it was built, across episodes) takes draws 2i and 2i+1,
so `noise_table(n)[i]` is that step's pair.
"""

from __future__ import annotations

import numpy as np
import torch

NOISE_SEED = 0
NOISE_STD = 0.1


def noise_table(n_steps: int) -> np.ndarray:
    """(n_steps, 2) float64 noise pairs of the first n_steps steps."""
    return np.random.default_rng(NOISE_SEED).normal(0, NOISE_STD,
                                                    size=(n_steps, 2))


def action_row(action, noise=None) -> tuple:
    """((dx, dy), act) -> the (dx, dy, act) row the engine takes, with the
    noise pair added and clipped when given."""
    (dx, dy), act = action
    dx, dy = float(dx), float(dy)
    if noise is not None:
        dx = float(np.clip(dx + noise[0], -1, 1))
        dy = float(np.clip(dy + noise[1], -1, 1))
    return dx, dy, float(act)


def actions_tensor(rows, device) -> torch.Tensor:
    """(N, 1, 3) f32 actions of one-agent envs from (dx, dy, act) rows."""
    return torch.tensor(rows, dtype=torch.float32,
                        device=device).reshape(len(rows), 1, 3)


def episode_done(done: bool, steps_before: int, number_steps: int,
                 env_type: int) -> bool:
    """The step's done: the engine's, or the episodic cutoff once the
    episode has taken number_steps steps before this one."""
    return bool(done) or (env_type == 0 and steps_before >= number_steps)

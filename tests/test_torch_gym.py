"""The port's gym entry point against the JAX package's:
agarcl_tpu_torch.gym_env.AgarioEnv(device="cpu") (the plain engine under
the gymnasium-free core, gym_core.AgarioCore) against
agarcl_tpu.gym_env.AgarioEnv over 5 steps of the same actions, for the ram
(mode 0 with a bot), grid (num_frames 2), screen (num_frames 2, agent view,
the duel of mode 10) and gobigger observations: RAM within rtol 1e-5 /
atol 1e-4, frames and GoBigger tables exact, rewards within 1e-5, dones
equal. Then the task suite (tasks.py) against bench/tasks_configs and the
JAX package's, the gymnasium ids of the port's namespace, and the core's
refusals."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from agarcl_tpu import gym_env as JG
from agarcl_tpu import tasks as JT
from agarcl_tpu_torch import gym_env as TG
from agarcl_tpu_torch import tasks as TT
from agarcl_tpu_torch.gym_core import AgarioCore

torch.set_num_threads(1)
SMALL = dict(arena_size=120, num_pellets=80, num_viruses=4)
CASES = {
    "ram": dict(SMALL, mode=0, num_bots=1),
    "grid": dict(SMALL, mode=4, grid_size=32, num_frames=2),
    "screen": dict(SMALL, num_viruses=0, mode=10, screen_len=32,
                   agent_view=True, num_frames=2),
    "gobigger": dict(SMALL, mode=4),
}
TASKS = Path(__file__).resolve().parent.parent / "bench" / "tasks_configs"


def _same_obs(kind, got, want):
    if kind == "gobigger":
        assert repr(got) == repr(want)
    elif kind == "ram":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    else:
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_agario_env_matches_jax(kind):
    jenv = JG.AgarioEnv(obs_type=kind, **CASES[kind])
    tenv = TG.AgarioEnv(obs_type=kind, device="cpu", **CASES[kind])
    if kind != "gobigger":
        assert tenv.observation_space == jenv.observation_space
    assert tenv.action_space == jenv.action_space
    jo, _ = jenv.reset(seed=7)
    to, _ = tenv.reset(seed=7)
    _same_obs(kind, to, jo)
    rng = np.random.default_rng(3)
    for _ in range(5):
        act = ((float(rng.uniform(-1, 1)), float(rng.uniform(-1, 1))),
               int(rng.integers(0, 3)))
        jo, jr, jd, jt, ji = jenv.step(act)
        to, tr, td, tt, ti = tenv.step(act)
        _same_obs(kind, to, jo)
        assert abs(tr - jr) <= 1e-5 and td == jd and tt == jt
        assert ti["steps"] == ji["steps"]
    if kind == "gobigger":
        assert vars(tenv.global_state) == vars(jenv.global_state)


def test_task_configs_match_files_and_jax(tmp_path):
    TT.write_task_configs(str(tmp_path))
    for mode in range(1, 11):
        want = json.loads((TASKS / f"mode_{mode}.json").read_text())
        assert TT.task_config(mode) == want == JT.task_config(mode)
        assert (tmp_path / f"mode_{mode}.json").read_text() == \
            (TASKS / f"mode_{mode}.json").read_text()
    with pytest.raises(ValueError):
        TT.task_config(11)


def test_load_task_builds_both_wrappers():
    env = TT.load_task(str(TASKS / "mode_10.json"), device="cpu")
    ref = JT.load_task(10)
    assert env.cfg.num_players == 2 and env.obs_type == "screen"
    assert env.observation_space == ref.observation_space
    core = TT.load_task_core(1, obs_type="grid", device="cpu")
    assert isinstance(core, AgarioCore) and core.obs_type == "grid"
    assert core.obs_config.grid_size == 128
    assert core.add_noise is TT.task_config(1)["add_noise"]


def test_gym_ids_in_own_namespace():
    import gymnasium as gym
    for kind in ("grid", "screen", "gobigger", "ram"):
        spec = gym.spec(f"agarcl_torch/agario-{kind}-v0")
        assert spec.entry_point == "agarcl_tpu_torch.gym_env:AgarioEnv"
        assert gym.spec(f"agario-{kind}-v0").entry_point == \
            "agarcl_tpu.gym_env:AgarioEnv"
    env = gym.make("agarcl_torch/agario-ram-v0", device="cpu", **SMALL,
                   mode=4)
    obs, _ = env.reset(seed=1)
    assert obs.shape == env.observation_space.shape


def test_core_refusals():
    with pytest.raises(ValueError):
        AgarioCore("pixels", device="cpu")
    with pytest.raises(ValueError):
        AgarioCore("ram", device="cpu", difficulty="hard")
    core = AgarioCore("ram", device="cpu", **SMALL, mode=4)
    with pytest.raises(RuntimeError):
        core.step(((0.0, 0.0), 0))
    core.reset(seed=1)
    with pytest.raises(ValueError):
        core.step(((2.0, 0.0), 0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            AgarioCore("ram", **SMALL)          # the card by default

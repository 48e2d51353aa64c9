"""The AgarCL full game (mode 0, benchmark/configs/mode0_bots.json: one
agent among 8 bots, every dead player respawned each step) on the CPU at
3 envs and a 32x32 agent-view screen, against the benchmark's frozen plain
reference (benchmark/reference/: plain torch, nothing of the port): the
port's VecEnv on its plain backend, and fused_env_step (the per-step path
VecEnv takes on the card, the kernel wrappers' plain versions standing in
for the kernels), equal in every state field, frame, reward and done
through a planted cross-player eat whose respawn fires in the first step;
the roster holds the four bot types; the per-step path's counters and
the respawn span record."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from agarcl_tpu_torch import profiling
from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.obs.screen import ScreenObsConfig
from agarcl_tpu_torch.ops import fused_step
from agarcl_tpu_torch.state import GameState
from agarcl_tpu_torch.vec import VecEnv
from benchmark import driver, manifest
from benchmark.reference import env as R_env
from benchmark.reference import layout as R_layout
from benchmark.reference.config import EnvConfig as RCfg
from benchmark.reference.obs.frame import frame_plain as r_frame
from benchmark.reference.obs.screen import ScreenObsConfig as RScreen
from benchmark.reference.state import GameState as RState

torch.set_num_threads(1)

N, K, S, SEED = 3, 3, 32, 2**31 + 7
CONFIG = json.loads((manifest.ROOT / "benchmark" / "configs"
                     / "mode0_bots.json").read_text())
KW = driver.env_kwargs(CONFIG)
CFG, RCFG = EnvConfig(**KW), RCfg(**KW)
OBS = dict(screen_len=S, agent_view=True, num_frames=1)
OCFG, ROCFG = ScreenObsConfig(**OBS), RScreen(**OBS)


def _ref_obs(st):
    return r_frame(RCFG, ROCFG, R_layout.to_kernel_arrays(st))


def _to_ref(states: GameState) -> RState:
    return RState(**{f.name: getattr(states, f.name).clone()
                     for f in dataclasses.fields(GameState)})


def _assert_same_state(got: GameState, ref: RState, where: str):
    for f in dataclasses.fields(GameState):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f"{where}: {f.name}"


def _plant(states: GameState) -> GameState:
    """A 500-mass cell of bot 1 on the agent's cell: the bot eats the
    agent in the first tick, and mode 0's respawn brings it back."""
    pos, mass = states.cell_pos.clone(), states.cell_mass.clone()
    pos[:, 1, 0] = pos[:, 0, 0]
    mass[:, 1, 0] = 500
    return states.replace(cell_pos=pos, cell_mass=mass)


def _actions():
    gen = torch.Generator().manual_seed(SEED)
    a = torch.rand((N, CFG.num_agents, 3), generator=gen) * 2.0 - 1.0
    a[..., 2] = torch.tensor([0.0, 1.0, 2.0])[:, None]    # none, feed, split
    return a


def _port_steps(env: VecEnv, states, actions, route: str):
    """K steps of the port: VecEnv.multi_step, or fused_env_step K times
    (obs stacked to (K, N, F, A, ...))."""
    if route == "vecenv":
        return env.multi_step(states, actions, K)
    obs, rs, ds = [], [], []
    for _ in range(K):
        states, o, r, d = fused_step.fused_env_step(CFG, states, actions,
                                                    OCFG)
        obs.append(o)
        rs.append(r)
        ds.append(d)
    return states, torch.stack(obs), torch.stack(rs), torch.stack(ds)


def test_roster_holds_the_four_bot_types():
    types = CFG.bot_types()
    assert CFG.num_players == 9 and types[0] == 0
    assert set(types[1:]) == {1, 2, 3, 4}                 # Hungry .. AggrShy
    assert types == RCFG.bot_types() == (0, 1, 2, 3, 4, 1, 1, 1, 1)
    assert CFG.mode_spec.respawn_all and not fused_step.supports_multi(
        CFG, "screen")


@pytest.mark.parametrize("route", ["vecenv", "fused_env_step"])
def test_full_game_matches_reference(route):
    env = VecEnv(CFG, N, "screen", backend="torch", device="cpu",
                 obs_config=OCFG)
    states, obs0 = env.reset(SEED)
    ref = R_env.env_reset(RCFG, R_env.reset_seeds(N, SEED))
    _assert_same_state(states, ref, "reset")
    assert torch.equal(obs0, _ref_obs(ref))
    states = _plant(states)
    ref = _to_ref(states)
    a = _actions()
    states, obs, r, d = _port_steps(env, states, a, route)
    for k in range(K):
        ref, ro, rr, rd = R_env.env_step(RCFG, ref, a, obs_fn=_ref_obs,
                                         num_frames=1)
        assert torch.equal(obs[k], ro), k
        assert torch.equal(r[k], rr) and torch.equal(d[k], rd), k
        if k == 0:
            # the planted eat: bot 1 ate the agent, and the respawn of
            # every dead player put it back with one 25-mass cell
            assert (ref.cells_eaten[:, 1] >= 1).all()
            assert ref.player_alive().all()
            assert (ref.cell_mass[:, 0, 0] == 25).all()
            assert int(ref.cell_alive[:, 0].sum()) == N
    _assert_same_state(states, ref, "after the call")
    assert obs.shape == (K, N, 1, 1, S, S, 4)


def test_per_step_counters_and_respawn_span():
    from agarcl_tpu_torch import vec
    env = VecEnv(CFG, N, "screen", backend="torch", device="cpu",
                 obs_config=OCFG)
    states, _ = env.reset(SEED)
    states = _plant(states)
    a = _actions()
    profiling.clear()
    env.multi_step(states, a, 1)                  # spans are off by default
    assert profiling.records() == []
    before = profiling.counters()
    prev = profiling.enable(True)
    try:
        env.multi_step(states, a, 2)
        recs = profiling.records()
    finally:
        profiling.enable(*prev)
        profiling.clear()
    after = profiling.counters()
    assert prev == (False, False, False)
    assert after["vec.per_step_steps"] - before["vec.per_step_steps"] == 2
    assert after["vec.resident_steps"] == before["vec.resident_steps"]
    assert "rim.respawn_all" in profiling.SPANS
    spawns = [r for r in recs if r[0] == "rim.respawn_all"]
    assert len(spawns) == 2
    assert recs[0][0] == "vec.multi_step" and recs[0][3] == -1
    assert all(recs[r[4]][0] == "vec.multi_step" for r in spawns)
    # a resident call counts on the other counter
    ram = EnvConfig(num_agents=1, ticks_per_step=2, arena_size=120,
                    num_pellets=40, num_viruses=2, mode=4)
    renv = VecEnv(ram, 2, "ram", backend="torch", device="cpu")
    res = renv.make_resident(renv.reset(1)[0])
    renv.multi_step(res, torch.zeros(2, 1, 3), 3)
    assert vec.resident_steps - after["vec.resident_steps"] == 3
    assert vec.per_step_steps == after["vec.per_step_steps"]

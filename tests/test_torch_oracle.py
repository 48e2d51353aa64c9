"""The port's plain engine against the C++ parity oracle through the port's
own binding (agarcl_tpu_torch/oracle.py), on scenarios of
tests/test_parity.py at that file's bars: integer fields exact, live cell
positions within 2e-2, rewards within 1e-3, dones equal. The port's binding
and the JAX package's (agarcl_tpu/oracle.py) give equal states."""

import numpy as np
import pytest
import torch

from agarcl_tpu import EnvConfig as JCfg
from agarcl_tpu.oracle import OracleEnv as JOracle
from agarcl_tpu_torch import EnvConfig
from agarcl_tpu_torch import oracle as TO
from agarcl_tpu_torch.env import env_reset
from agarcl_tpu_torch.vec import VecEnv

torch.set_num_threads(1)

PCFG = dict(num_agents=1, ticks_per_step=4, arena_size=100, num_pellets=50,
            num_viruses=3, num_bots=0, mode=3)
DUEL = dict(num_agents=1, ticks_per_step=4, arena_size=100, num_pellets=50,
            num_viruses=2, num_bots=0, mode=7)
POS_TOL = 2e-2                    # tests/test_parity.py:22
REWARD_TOL = 1e-3                 # tests/test_parity.py:64


def _walk(t, rng):
    return np.concatenate([rng.uniform(-1, 1, (1, 2)), np.zeros((1, 1))],
                          axis=1)


def _splits_feeds(t, rng):
    act = 2.0 if t % 7 == 3 else (1.0 if t % 7 == 5 else 0.0)
    return np.concatenate([rng.uniform(-1, 1, (1, 2)), np.full((1, 1), act)],
                          axis=1)


def compare_states(s, o, step, pos_tol=POS_TOL):
    """tests/test_parity.py::compare_states for env 0 of a port GameState
    against an oracle state dict."""
    alive = s.cell_alive[0].numpy()
    np.testing.assert_array_equal(alive, o["cell_alive"].astype(bool),
                                  err_msg=f"cell_alive at step {step}")
    np.testing.assert_array_equal(
        s.cell_mass[0].numpy() * alive, o["cell_mass"] * o["cell_alive"],
        err_msg=f"cell_mass at step {step}")
    np.testing.assert_array_equal(s.pellet_alive[0].numpy(),
                                  o["pellet_alive"],
                                  err_msg=f"pellet_alive at step {step}")
    np.testing.assert_array_equal(s.virus_alive[0].numpy(),
                                  o["virus_alive"].astype(bool),
                                  err_msg=f"virus_alive at step {step}")
    np.testing.assert_array_equal(s.food_eaten[0].numpy(), o["food_eaten"],
                                  err_msg=f"food_eaten at step {step}")
    if alive.any():
        err = np.abs(s.cell_pos[0].numpy()[alive]
                     - o["cell_pos"][alive]).max()
        assert err < pos_tol, f"cell_pos err {err} at step {step}"


def run_parity(cfg, seed, n_steps, policy):
    env = VecEnv(cfg, 1, "none", backend="torch", device="cpu")
    s = env_reset(cfg, torch.tensor([seed]))
    oe = TO.OracleEnv(cfg)
    oe.reset(seed)
    compare_states(s, oe.get_state(), -1)
    rng = np.random.default_rng(seed)
    for t in range(n_steps):
        acts = policy(t, rng)
        s, _, r, d = env.step(s, torch.tensor(acts[None], dtype=torch.float32))
        orew, od = oe.step(acts)
        compare_states(s, oe.get_state(), t)
        np.testing.assert_allclose(r[0].numpy(), orew, atol=REWARD_TOL,
                                   err_msg=f"rewards at step {t}")
        np.testing.assert_array_equal(d[0].numpy(), od,
                                      err_msg=f"dones at step {t}")


def test_oracle_reset_equals_plain_engine():
    cfg = EnvConfig(**PCFG)
    s = env_reset(cfg, torch.tensor([123]))
    oe = TO.OracleEnv(cfg)
    oe.reset(123)
    o = oe.get_state()
    np.testing.assert_array_equal(s.pellet_key[0].numpy(), o["pellet_key"])
    np.testing.assert_allclose(s.cell_pos[0].numpy(), o["cell_pos"],
                               atol=1e-5)
    np.testing.assert_array_equal(s.cell_mass[0].numpy(), o["cell_mass"])


@pytest.mark.parametrize("cfg,seed,steps,policy", [
    (PCFG, 0, 25, _walk),
    (PCFG, 7, 25, _splits_feeds),
    (DUEL, 11, 20, _walk),
], ids=["random_walk_seed0", "splits_and_feeds", "duel_with_bot"])
def test_plain_engine_matches_oracle(cfg, seed, steps, policy):
    run_parity(EnvConfig(**cfg), seed, steps, policy)


def test_port_binding_equals_jax_binding():
    """Both bindings of one oracle source give equal states after the same
    reset and steps (the port's library is its own build of
    oracle/oracle.cpp)."""
    t_env, j_env = TO.OracleEnv(EnvConfig(**DUEL)), JOracle(JCfg(**DUEL))
    t_env.reset(5)
    j_env.reset(5)
    rng = np.random.default_rng(5)
    for t in range(8):
        acts = _splits_feeds(t, rng)
        tr, td = t_env.step(acts)
        jr, jd = j_env.step(acts)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(td, jd)
    t_env.tick()
    j_env.tick()
    ts, js = t_env.get_state(), j_env.get_state()
    assert ts.keys() == js.keys()
    for k in ts:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def test_oracle_missing_source_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(TO, "ORACLE_DIR", str(tmp_path))
    monkeypatch.setattr(TO, "LIB_PATH", tmp_path / "lib" / "liboracle.so")
    with pytest.raises(FileNotFoundError, match="oracle.cpp"):
        TO.build()


def test_oracle_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(TO, "LIB_PATH", tmp_path / "liboracle.so")
    monkeypatch.setenv("CXX", "no-such-c++-compiler")
    with pytest.raises(RuntimeError, match="no-such-c\\+\\+-compiler"):
        TO.build()

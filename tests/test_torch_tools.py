"""The port's rim tools on the CPU: the benchmark entry
(agarcl_tpu_torch/bench.py) prints bench.py's one-line JSON with its
metric name; the bot evaluator's final masses equal the JAX vmapped
env_step run's (bench/bot_evaluator.py); the client's state, targets,
leaderboard and frames equal agarcl_tpu.client.Client's; profiling's
timers return sane values."""

import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agarcl_tpu import EnvConfig as JCfg
from agarcl_tpu import env_reset as j_reset
from agarcl_tpu import env_step as j_step
from agarcl_tpu.client import Client as JClient
from agarcl_tpu_torch import bench, bot_evaluator, profiling, random_walk
from agarcl_tpu_torch.bridge import state_to_numpy
from agarcl_tpu_torch.client import Client as TClient
from agarcl_tpu_torch.state import STATE_FIELDS

torch.set_num_threads(1)


@pytest.mark.parametrize("flags,metric", [
    ([], "env_steps_per_sec_per_chip_8envs_ram"),
    (["--obs", "screen", "--size", "24", "--poly"],
     "env_steps_per_sec_per_chip_8envs_screen_poly"),
    (["--obs", "grid", "--size", "16", "--grid-dtype", "int8", "--mode",
      "10"], "env_steps_per_sec_per_chip_8envs_grid_mode10_int8"),
    (["--obs", "none", "--mode", "0", "--bots", "2", "--agents", "2"],
     "env_steps_per_sec_per_chip_8envs_none_mode0_2bots_2ag"),
])
def test_bench_prints_bench_py_json_line(capsys, flags, metric):
    """One parseable JSON line with bench.py's keys and metric name for
    the same flags (bench.py:189-208), the runs it took the median of,
    the backend and the device."""
    out = bench.main(["--device", "cpu", "--envs", "8", "--steps", "2",
                      "--iters", "1"] + flags)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == out and line["metric"] == metric
    assert line["unit"] == "steps/s" and len(line["runs"]) == 3
    assert line["value"] == sorted(line["runs"])[1] > 0
    assert line["vs_baseline"] == round(line["value"] / 1e6, 4)
    assert (line["backend"], line["device"]) == ("torch", "cpu")


@pytest.mark.parametrize("flags,metric", [
    ([], "env_steps_per_sec_per_chip_8192envs_ram"),
    (["--envs", "64", "--obs", "none"],
     "env_steps_per_sec_per_chip_64envs_none"),
    (["--mode", "1", "--obs", "gobigger"],
     "env_steps_per_sec_per_chip_8192envs_gobigger_mode1"),
    (["--mode", "7", "--bots", "3"],
     "env_steps_per_sec_per_chip_8192envs_ram_mode7"),
    (["--mode", "0"], "env_steps_per_sec_per_chip_8192envs_ram_mode0_4bots"),
    (["--mode", "0", "--bots", "0"],
     "env_steps_per_sec_per_chip_8192envs_ram_mode0_0bots"),
    (["--mode", "0", "--bots", "11", "--agents", "3"],
     "env_steps_per_sec_per_chip_8192envs_ram_mode0_11bots_3ag"),
    (["--obs", "grid"], "env_steps_per_sec_per_chip_8192envs_grid"),
    (["--obs", "grid", "--grid-dtype", "int32", "--poly"],
     "env_steps_per_sec_per_chip_8192envs_grid_int32"),
    (["--obs", "screen", "--grid-dtype", "int8", "--size", "128"],
     "env_steps_per_sec_per_chip_8192envs_screen"),
    (["--obs", "ram", "--poly", "--mode", "9", "--agents", "2"],
     "env_steps_per_sec_per_chip_8192envs_ram_mode9_2ag"),
])
def test_bench_metric_name_follows_bench_py(flags, metric):
    """The metric name for flags bench.py takes, by bench.py's rule
    (bench.py:192-203): the mode unless 4, mode 0's bot count (default 4),
    agents unless 1, a grid dtype other than int16, --poly on screens
    only; --size, --steps and --iters leave it alone."""
    assert bench.metric_name(bench.parse_args(flags)) == metric


@pytest.mark.parametrize("flags,backend", [
    ([], "cuda"),
    (["--mode", "0", "--bots", "8", "--obs", "screen"], "cuda"),
    (["--mode", "0", "--bots", "9"], "torch"),
])
def test_bench_on_the_card_names_a_plain_engine_run(monkeypatch, capsys,
                                                    flags, backend):
    """On the card the bench takes the kernels where K1 takes the
    configuration; where it does not (10 players) it runs the plain
    engine on the card and says so on stderr, naming K1's limit (a CUDA
    device is feigned: the constructor allocates nothing)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    env = bench.make_env(bench.parse_args(["--envs", "8"] + flags))
    err = capsys.readouterr().err
    assert env.backend == backend and env.device.type == "cuda"
    if backend == "cuda":
        assert err == ""
    else:
        assert "9 players" in err and "backend='torch'" in err


def test_bot_evaluator_matches_jax_vmapped_env_step(capsys):
    """8 games x 3 steps (9 players): the final masses equal the JAX
    evaluator's loop (vmapped env_step from seeds arange(games) + seed,
    the same numpy actions), and the report has its rows."""
    games, steps, kw = 8, 3, dict(arena=100, pellets=60, seed=4)
    out = bot_evaluator.main(["--games", str(games), "--steps", str(steps),
                              "--arena", "100", "--pellets", "60",
                              "--seed", "4", "--device", "cpu"])
    cfg = JCfg(num_agents=1, ticks_per_step=4, arena_size=kw["arena"],
               num_pellets=kw["pellets"], num_viruses=10, num_bots=8,
               mode=0)
    step_b = jax.jit(jax.vmap(functools.partial(j_step, cfg)))
    states = jax.jit(jax.vmap(functools.partial(j_reset, cfg)))(
        jnp.arange(games, dtype=jnp.uint32) + jnp.uint32(kw["seed"]))
    rng = np.random.default_rng(kw["seed"])
    for _ in range(steps):
        acts = np.zeros((games, 1, 3), np.float32)
        acts[..., :2] = rng.uniform(-1, 1, (games, 1, 2))
        states, _, _ = step_b(states, jnp.asarray(acts))
    np.testing.assert_array_equal(out["masses"],
                                  np.asarray(states.player_mass()))
    assert out["masses"].shape == (games, 9) and out["backend"] == "torch"
    text = capsys.readouterr().out
    for name in ("agent (random)", "HungryBot", "AggressiveShyBot"):
        assert name in text


def test_random_walk_matches_jax_driver(monkeypatch, capsys, tmp_path):
    """The port's random-walk driver on the CPU (task 1, RAM, 2 episodes of
    5 steps) prints bench/random_walk_example.py's episode lines with the
    same rewards and steps, writes its CSV with the same rewards, and
    saves a snapshot."""
    from bench import random_walk_example
    argv = ["--task", "1", "--episodes", "2", "--obs", "ram",
            "--max-steps", "4", "--seed", "3"]
    monkeypatch.setattr(sys, "argv", ["random_walk_example.py", *argv,
                                      "--csv", str(tmp_path / "j.csv")])
    random_walk_example.main()
    want = capsys.readouterr().out.strip().splitlines()
    rows = random_walk.main(argv + ["--device", "cpu", "--csv",
                                    str(tmp_path / "t.csv"), "--snapshot",
                                    str(tmp_path / "snap.json")])
    got = capsys.readouterr().out.strip().splitlines()
    assert [ln.rsplit(" ", 1)[0] for ln in got] == \
        [ln.rsplit(" ", 1)[0] for ln in want]
    assert len(got) == 2 and "steps=5" in got[0] and len(rows) == 2

    def rewards(path):
        lines = path.read_text().strip().splitlines()
        assert lines[0] == "episode,reward,sps"
        return [float(ln.split(",")[1]) for ln in lines[1:]]
    assert rewards(tmp_path / "t.csv") == rewards(tmp_path / "j.csv")
    assert (tmp_path / "snap.json").stat().st_size > 0


def test_client_matches_jax_client(capsys):
    """5 steps at arena 100, 2 bots, S=64, steering by mouse, a split on
    the third: the state after each step, to_target and the leaderboard
    equal the JAX client's; the frames equal its class map's (0
    pixels)."""
    kw = dict(arena_size=100, num_pellets=80, num_viruses=3, num_bots=2,
              screen=64, seed=3)
    jc, tc = JClient(**kw), TClient(device="cpu", **kw)
    for t in range(5):
        for c in (jc, tc):
            c.set_mouse(10 + 9 * t, 50 - 6 * t)
            c.action = 2 if t == 2 else 0
        assert np.allclose(tc.to_target(5, 60), jc.to_target(5, 60),
                           rtol=0, atol=0)
        jf, tf = jc.step(), tc.step()
        np.testing.assert_array_equal(tf, jf)
        got = state_to_numpy(tc.state)
        for f in STATE_FIELDS:
            np.testing.assert_array_equal(got[f][0],
                                          np.asarray(getattr(jc.state, f)),
                                          err_msg=f)
        assert tc.leaderboard() == jc.leaderboard()
    assert tf.shape == (64, 64, 3) and len(np.unique(tf.reshape(-1, 3),
                                                     axis=0)) > 3
    capsys.readouterr()
    tc.play_ascii(steps=2, size=12, fps=1000.0)
    assert "you:" in capsys.readouterr().out


def test_profiling_timers_on_the_cpu(tmp_path):
    x = torch.arange(1000.0)
    sec = profiling.device_time_of(lambda: (x * 2).sum(), iters=5)
    assert 0 < sec < 1
    timer = profiling.StepTimer()
    timer.start()
    for _ in range(3):
        timer.tick(8, {"r": x + 1})
    out = timer.stop()
    assert (out["calls"], out["env_steps"]) == (3, 24)
    assert out["env_steps_per_sec"] > 0 and timer.history == [out]
    with profiling.trace(str(tmp_path)) as prof:
        (x * 3).sum()
    assert prof.key_averages() and list(tmp_path.glob("trace_*.json"))

"""The port's rim tools on the CPU: the benchmark entry
(agarcl_tpu_torch/bench.py) prints bench.py's one-line JSON with its
metric name; the bot evaluator's final masses equal the JAX vmapped
env_step run's (bench/bot_evaluator.py); the client's state, targets,
leaderboard and frames equal agarcl_tpu.client.Client's; profiling's
timer returns sane values and its spans nest, annotate and name the gym
core's and VecEnv's layers."""

import contextlib
import functools
import json
import sys
import time

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
    with spans_on():
        for _ in range(3):
            with profiling.span("vec.multi_step"):
                x + 1
        got = profiling.summary()["spans"]["vec.multi_step"]
    assert got["count"] == 3 and got["host_ms"] > 0
    assert got["device_ms"] is None        # no launch on the CPU
    with profiling.trace(str(tmp_path)) as prof:
        (x * 3).sum()
    assert prof.key_averages() and list(tmp_path.glob("trace_*.json"))


@contextlib.contextmanager
def spans_on(annotate=False):
    """Spans on (and empty) for the block; off and cleared after it."""
    profiling.clear()
    profiling.enable(True, annotate)
    try:
        yield
    finally:
        profiling.enable(False)
        profiling.clear()


def _tree(recs):
    """(name, parent name) of each record, in order."""
    return [(r[0], recs[r[3]][0] if r[3] >= 0 else None) for r in recs]


def test_span_off_records_nothing():
    assert profiling.enable(False) == (False, False, False)
    profiling.clear()
    a, b = profiling.span("gym.step"), profiling.span("k1.launch")
    assert a is b                          # one shared no-op context
    with a as sp, sp.device("cpu"):
        with profiling.span("gym.fetch"):
            pass
    assert profiling.records() == []
    assert profiling.summary()["spans"] == {}
    # on, device ms not asked for: a launch span times nothing
    with spans_on():
        with profiling.span("k1.launch") as sp:
            assert sp.device("cpu") is a
        assert profiling.summary()["spans"]["k1.launch"]["device_ms"] is None
    assert profiling.enable(True, device_ms=True) == (False, False, False)
    assert profiling.enable(False) == (True, False, True)


def test_span_parents_roots_and_self_time():
    with spans_on():
        with profiling.span("gym.step"):
            with profiling.span("gym.actions"):
                pass
            with profiling.span("vec.multi_step"):
                with profiling.span("layout.to_kernel"):
                    time.sleep(0.002)
            time.sleep(0.001)
        with profiling.span("vec.reset"):
            with profiling.span("reset.engine"):
                pass
        recs = profiling.records()
        whole = profiling.summary()["spans"]
        by_root = profiling.summary(root="vec.reset")["spans"]
    assert [(r[0], r[3], r[4]) for r in recs] == [
        ("gym.step", -1, 0), ("gym.actions", 0, 0),
        ("vec.multi_step", 0, 0), ("layout.to_kernel", 2, 0),
        ("vec.reset", -1, 4), ("reset.engine", 4, 4)]
    assert all(r[1] <= r[2] for r in recs)
    ms = {r[0]: (r[2] - r[1]) / 1e6 for r in recs}
    step = whole["gym.step"]
    assert step["count"] == 1 and step["host_ms"] == pytest.approx(
        ms["gym.step"])
    assert step["self_ms"] == pytest.approx(
        ms["gym.step"] - ms["gym.actions"] - ms["vec.multi_step"])
    assert step["self_ms"] >= 1.0          # the sleep outside its children
    assert whole["vec.multi_step"]["self_ms"] == pytest.approx(
        ms["vec.multi_step"] - ms["layout.to_kernel"])
    assert set(by_root) == {"vec.reset", "reset.engine"}
    assert set(profiling.summary()["counters"]) >= {
        "fused_tick.launches", "fused_tick.tick_launches",
        "fused_tick.plain_calls", "fused_screen.launches",
        "fused_grid.plain_calls", "fused_obs.launches",
        "screen.class_map_calls"}


def test_span_annotations_under_the_cpu_profiler(tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with spans_on(annotate=True):
        with torch.profiler.profile(activities=acts) as prof:
            with profiling.span("gym.step"):
                with profiling.span("vec.multi_step"):
                    with profiling.span("k1.launch"):
                        torch.arange(10.0).sum()
                with profiling.span("gym.fetch"):
                    pass
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    ann = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("cat") == "user_annotation"),
                 key=lambda e: e["ts"])
    assert [e["name"] for e in ann] == ["gym.step", "vec.multi_step",
                                        "k1.launch", "gym.fetch"]
    end = [e["ts"] + e["dur"] for e in ann]
    assert ann[0]["ts"] <= ann[1]["ts"] <= ann[2]["ts"]
    assert end[2] <= end[1] <= ann[3]["ts"] <= end[3] <= end[0]


def test_gym_core_span_tree():
    from agarcl_tpu_torch.gym_core import AgarioCore
    core = AgarioCore("screen", None, "cpu", None, ticks_per_step=4,
                      arena_size=120, num_pellets=50, num_viruses=0,
                      num_bots=1, mode=10, screen_len=16, agent_view=True)
    with spans_on():
        core.reset(seed=3)
        reset_recs = profiling.records()
        profiling.clear()
        core.step(((0.5, 0.2), 0))
        recs = profiling.records()
        steps = profiling.summary(root="gym.step")["spans"]
    assert _tree(reset_recs) == [
        ("gym.reset", None), ("reset.engine", "gym.reset"),
        ("layout.to_kernel", "gym.reset"), ("gym.fetch", "gym.reset")]
    # the plain backend's step (env_step) converts for its plain frame
    assert _tree(recs) == [
        ("gym.step", None), ("gym.actions", "gym.step"),
        ("vec.multi_step", "gym.step"),
        ("layout.to_kernel", "vec.multi_step"),
        ("gym.fetch", "gym.step"), ("gym.fetch", "gym.step"),
        ("gym.fetch", "gym.step")]
    assert {r[4] for r in recs} == {0}
    assert steps["gym.fetch"]["count"] == 3          # the step's host syncs
    assert not any(n.endswith(".launch") for n in steps)


def test_vecenv_span_tree():
    from agarcl_tpu_torch import EnvConfig
    from agarcl_tpu_torch.obs.screen import ScreenObsConfig
    from agarcl_tpu_torch.ops import fused_step
    from agarcl_tpu_torch.vec import VecEnv
    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=120,
                    num_pellets=60, num_viruses=2, mode=4)
    env = VecEnv(cfg, 3, "ram", backend="torch", device="cpu")
    scr = ScreenObsConfig(16, agent_view=True)
    with spans_on():
        states, _ = env.reset(5)
        reset_recs = profiling.records()
        res = env.make_resident(states)
        profiling.clear()
        env.multi_step(res, torch.zeros(3, 1, 3), 2)
        resident = profiling.records()
        profiling.clear()
        env.multi_step(states, torch.zeros(3, 1, 3), 2)
        plain = profiling.records()
        profiling.clear()
        # the kernel route's step on CPU planes (the wrappers' plain
        # versions stand in for the kernels): conversions and the rim
        fused_step.fused_env_step(cfg, states, torch.zeros(3, 1, 3), scr,
                                  1, True, True)
        fused = profiling.records()
    assert _tree(reset_recs) == [("vec.reset", None),
                                 ("reset.engine", "vec.reset")]
    tree = _tree(resident)
    assert tree[0] == ("vec.multi_step", None)
    assert tree[-1] == ("rim.rewards", "vec.multi_step")
    assert {p for _, p in tree[1:]} == {"vec.multi_step"}
    assert _tree(plain) == [("vec.multi_step", None)]
    names = [n for n, _ in _tree(fused)]
    assert names[0] == "layout.to_kernel" and names[-1] == "rim.finish"
    assert names[-2] == "layout.from_kernel"
    assert not any(n.endswith(".launch") for n in names)


def test_trace_restores_the_span_state(tmp_path):
    profiling.clear()
    for before in ((False, False, False), (True, False, True)):
        profiling.enable(*before)
        try:
            with profiling.trace(str(tmp_path)):
                with profiling.span("vec.reset"):
                    # the state inside the block, set again unchanged
                    assert profiling.enable(True, True) == (True, True,
                                                            False)
            assert profiling.enable(*before) == before
            assert [r[0] for r in profiling.records()] == ["vec.reset"]
        finally:
            profiling.enable(False)
            profiling.clear()

"""The full-game cell (mode0_bots.chained) through the harness on the
CPU, at 4 envs and k=2, with the port's plain backend in the kernels'
place: it runs correct, and a call that leaves the state as it was, steps
half of the batch or alters the rewards comes out not correct."""

from __future__ import annotations

import time

import pytest

from benchmark import run

import bench_tiny
from test_bench_harness import _altered, _half, _unchanged

CELL = "mode0_bots.chained"
TINY_FULL = {"chained_walk_full": {
    "entry": "gamestate", "envs": 4, "k": 2, "buttons": [0, 1, 2],
    "in_flight": 2, "checkpoints": 2, "checked_envs": 4,
    "reference_block": 4}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_tiny.make_root(tmp_path_factory.mktemp("bench_mode0"),
                                TINY_FULL)


def _run(root):
    return run.main(["--workload", CELL, "--seed", str(2**31 + 11),
                     "--seconds", "1", "--trace", "0"], root=root,
                    device="cpu", t_start=time.perf_counter())


def test_full_game_cell_runs_correct(root, capsys):
    from agarcl_tpu_torch import profiling, vec  # noqa: F401 (its counters)
    before = profiling.counters()
    assert _run(root) == 0
    res = bench_tiny.last_json(capsys.readouterr().out)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert {"setup_s", "screen_env_steps_per_s",
            "peak_mem_gib"} <= set(res["metrics"])
    after = profiling.counters()
    assert after["vec.per_step_steps"] > before["vec.per_step_steps"]
    assert after["vec.resident_steps"] == before["vec.resident_steps"]


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_full_game_faults_come_out_not_correct(root, fault, monkeypatch,
                                               capsys):
    from agarcl_tpu_torch.vec import VecEnv
    monkeypatch.setattr(VecEnv, "multi_step", fault(VecEnv.multi_step))
    assert _run(root) == 0
    res = bench_tiny.last_json(capsys.readouterr().out)
    assert res["correct"] is False and res["failed"] > 0

"""The harness end to end on the CPU, at a few envs, with the port's plain
backend in the kernels' place: every cell proves correct; a cell added as
files and entries alone runs; each fault of the timed path that a cell can
have, and the control, come out as not correct; a directory holding only
BENCHMARK.json and the benchmark's files fails without a result; nothing
loads JAX or the JAX package, and the reference loads nothing of the
port."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import control, run

import bench_tiny

CELLS = ("bench_ram.chained", "task10_duel.chained", "task10_duel.gym")


def _run(root, workload, seed=2**31 + 5, seconds=1):
    out = run.main(["--workload", workload, "--seed", str(seed),
                    "--seconds", str(seconds), "--trace", "0"],
                   root=root, device="cpu", t_start=time.perf_counter())
    return out


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct(root, workload, capsys):
    assert _run(root, workload) == 0
    res = bench_tiny.last_json(capsys.readouterr().out)
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    assert res["attempted"] > 0


def test_added_cell_needs_no_edit(tmp_path, capsys):
    """A new configuration, traffic mix and cell are data files and
    manifest entries; its episodes of 6 steps reset every env twice a
    second call, and each reset is checked."""
    extra = {"chained_walk_tiny": {
        "entry": "resident", "envs": 5, "k": 3, "buttons": [0, 1, 2],
        "in_flight": 1, "checkpoints": 2, "checked_envs": 2,
        "reference_block": 4}}
    cfg = json.loads((run.manifest.ROOT / "benchmark" / "configs"
                      / "bench_ram.json").read_text())
    short = {"bench_ram_short": (dict(cfg, number_steps=6), {
        "source": "a throwaway configuration of the test", "reduced": [],
        "why": "episodes of six steps"})}
    cell = {"name": "bench_ram_short.walk", "config": "bench_ram_short",
            "traffic": "chained_walk_tiny", "chips": 1,
            "why": "a throwaway cell of the test"}
    root = bench_tiny.make_root(tmp_path, extra, [cell], short)
    assert _run(root, "bench_ram_short.walk") == 0
    out, err = capsys.readouterr()
    res = bench_tiny.last_json(out)
    assert res["correct"] is True
    assert res["attempted"] % 15 == 0
    calls = res["attempted"] // 15 + 2
    assert f"{calls // 2 + 1} resets" in err


def test_gamestate_step_cell(tmp_path, capsys):
    """A GameState traffic of one step a call drives VecEnv.step."""
    extra = {"step_walk_tiny": {
        "entry": "gamestate", "envs": 4, "buttons": [0, 1, 2],
        "in_flight": 2, "checkpoints": 2, "checked_envs": 2,
        "reference_block": 3}}
    cell = {"name": "task10_duel.step", "config": "task10_duel",
            "traffic": "step_walk_tiny", "chips": 1,
            "why": "a throwaway cell of the test"}
    root = bench_tiny.make_root(tmp_path, extra, [cell])
    assert _run(root, "task10_duel.step") == 0
    assert bench_tiny.last_json(capsys.readouterr().out)["correct"] is True


def _unchanged(orig):
    def step(self, states, actions, k, stack_obs=True):
        _, obs, r, d = orig(self, states, actions, k, stack_obs)
        return states, obs, r, d
    return step


def _half(orig):
    """Steps only the first half of the batch: the other half keeps its
    state."""
    def step(self, states, actions, k, stack_obs=True):
        new, obs, r, d = orig(self, states, actions, k, stack_obs)
        h = self.num_envs // 2
        if hasattr(new, "raw"):
            for p, q in zip(new.raw, states.raw):
                p[:, h:] = q[:, h:]
        else:
            for f in new.__dataclass_fields__:
                getattr(new, f)[h:] = getattr(states, f)[h:]
        return new, obs, r, d
    return step


def _altered(orig):
    def step(self, states, actions, k, stack_obs=True):
        new, obs, r, d = orig(self, states, actions, k, stack_obs)
        return new, obs, r + 1.0, d
    return step


# a one-env batch (the gym) has no half to leave out
FAULTS = [(w, f) for w in CELLS for f in (_unchanged, _half, _altered)
          if not (f is _half and w.endswith(".gym"))]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_faults_come_out_not_correct(root, workload, fault, monkeypatch,
                                     capsys):
    from agarcl_tpu_torch.vec import VecEnv
    monkeypatch.setattr(VecEnv, "multi_step", fault(VecEnv.multi_step))
    assert _run(root, workload) == 0
    res = bench_tiny.last_json(capsys.readouterr().out)
    assert res["correct"] is False and res["failed"] > 0


@pytest.mark.parametrize("workload", ["bench_ram.chained",
                                      "task10_duel.chained"])
def test_control_comes_out_not_correct(root, workload):
    from benchmark import check, manifest
    cell = manifest.cell(manifest.load(root), workload, root)
    for seed in (1, 2**31 + 3, 77):
        prog, ctrl = control.readings(cell, seed, 0.5, "cpu")
        assert all(prog[n] <= lim for n, lim in check.LIMITS.items())
        assert any(ctrl[n] > lim for n, lim in check.LIMITS.items())


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_card_cell_runs_correct(root, workload, card, capsys):
    assert run.main(["--workload", workload, "--seed", "12345", "--seconds",
                     "1", "--trace", "1"], root=root, device=card,
                    t_start=time.perf_counter()) == 0
    res = bench_tiny.last_json(capsys.readouterr().out)
    assert res["correct"] is True
    assert res["device"]["busy_s"] > 0


def test_checkout_without_the_port_fails(tmp_path):
    shutil.copy(run.manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.manifest.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys, time; from benchmark import run; sys.exit(run.main("
            "['--workload', 'bench_ram.chained', '--seed', '1', "
            "'--seconds', '1', '--trace', '0'], device='cpu', "
            "t_start=time.perf_counter()))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def _tops(code: str, cwd) -> set:
    proc = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json; print(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=cwd, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax(root):
    tops = _tops(
        "import time; from benchmark import run; run.main(['--workload', "
        "'task10_duel.gym', '--seed', '3', '--seconds', '1', '--trace', "
        f"'0'], root={str(root)!r}, device='cpu', "
        "t_start=time.perf_counter())", run.manifest.ROOT)
    assert "agarcl_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "agarcl_tpu"}


def test_reference_loads_nothing_of_the_port():
    tops = _tops(
        "import torch\nfrom benchmark import check, manifest, work\n"
        "from benchmark.reference import env, gym, layout\n"
        "cell = manifest.cell(manifest.load(), 'task10_duel.chained')\n"
        "sp = check.spec(cell.config, cell.traffic)\n"
        "st = env.env_reset(sp.cfg, env.reset_seeds(2, 5))\n"
        "check.replay(sp, st, torch.zeros((2, 1, 3)))\n"
        "work.k1_per_call(cell, 2)", run.manifest.ROOT)
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "agarcl_tpu",
                       "agarcl_tpu_torch"}


def test_forbidden_names_compare_whole():
    assert run.forbidden_modules(["agarcl_tpu_torch", "agarcl_tpu_torch.vec",
                                  "jax_probe", "numpy"]) == []
    assert run.forbidden_modules(["agarcl_tpu.env", "jaxlib.xla", "jax",
                                  "flax.linen"]) == ["agarcl_tpu", "flax",
                                                     "jax", "jaxlib"]

"""End-to-end rates of the PyTorch + CUDA port's paths on one GPU, timed
as chip_smoke.py phases 5, 9, 12 and 15 time them (8192 envs, one warm
call, then the median of 3 runs of 4 calls, each run ending with a
synchronize and a host fetch of the rewards): the RAM path (resident,
k=40), the screen path (128 x 128 agent view, k=10) and the grid path
(64 x 64 int16, k=10) of the bench.py game, and the duel task's screen
path (mode 10, k=10). On a tree that has them it also times the screen
path with num_frames 4 (every tick of a step framed, k=10) and the gym
core (gym_core.AgarioCore) at one env: the RAM step in the bench.py world
and the screen step of task 1 (median of 3 runs of 50 steps after 10 warm
ones, ms per step on the host clock); an older tree prints "n/a".

Times the agarcl_tpu_torch package of the current directory, so one copy
of the script can time two trees unpacked with `git archive`, in turns
on one card (parent, change, change, parent, ...):

    cd parent && python3 ../torch_rates.py parent

Prints one line: the label, then ms per call of each path. Exits non-zero
without a CUDA device.
"""

import os
import statistics
import sys
import time

import numpy as np
import torch

N = 8192


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_rates: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    from agarcl_tpu_torch import EnvConfig
    from agarcl_tpu_torch.obs.grid import GridObsConfig
    from agarcl_tpu_torch.obs.screen import ScreenObsConfig
    from agarcl_tpu_torch.ops import _build
    from agarcl_tpu_torch.vec import VecEnv

    dev = torch.device("cuda", 0)
    _build.load()
    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=350,
                    num_pellets=500, num_viruses=10, reward_type=True,
                    mode=4)
    duel = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=350,
                     num_pellets=500, num_viruses=0, num_bots=1,
                     reward_type=True, mode=10)
    rng = np.random.default_rng(0)
    acts = torch.from_numpy(np.concatenate(
        [rng.uniform(-1, 1, (N, 1, 2)), rng.integers(0, 3, (N, 1, 1))],
        -1).astype(np.float32)).to(dev)

    def ms_per_call(env, k, resident):
        s, _ = env.reset(0)
        if resident:
            s = env.make_resident(s)
        s, o, rw, _ = env.multi_step(s, acts, k)
        rw.sum().item()
        times = []
        for _ in range(3):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(4):
                del o
                s, o, rw, _ = env.multi_step(s, acts, k)
            torch.cuda.synchronize(dev)
            rw.sum().item()
            times.append((time.perf_counter() - t0) / 4)
        return 1e3 * statistics.median(times)

    scr = ScreenObsConfig(128, agent_view=True)
    grid = GridObsConfig(grid_size=64, out_dtype="int16")
    out = [("ram k=40", ms_per_call(VecEnv(cfg, N, "ram"), 40, True)),
           ("screen k=10", ms_per_call(
               VecEnv(cfg, N, "screen", obs_config=scr), 10, False)),
           ("grid k=10", ms_per_call(
               VecEnv(cfg, N, "grid", obs_config=grid), 10, False)),
           ("duel screen k=10", ms_per_call(
               VecEnv(duel, N, "screen", obs_config=scr), 10, False))]
    try:
        from agarcl_tpu_torch.gym_core import AgarioCore
        from agarcl_tpu_torch.tasks import load_task_core
    except ImportError:
        AgarioCore = None

    def ms_per_gym_step(core):
        steps = [((float(np.cos(t)), float(np.sin(t))), 0)
                 for t in range(160)]
        core.reset(seed=0)
        for a in steps[:10]:
            core.step(a)
        times = []
        for r in range(3):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for a in steps[10 + 50 * r:60 + 50 * r]:
                core.step(a)
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) / 50)
        return 1e3 * statistics.median(times)

    if AgarioCore is not None:
        scr4 = ScreenObsConfig(128, agent_view=True, num_frames=4)
        world = dict(arena_size=350, num_pellets=500, num_viruses=10, mode=4)
        out += [("screen F=4 k=10", ms_per_call(
                    VecEnv(cfg, N, "screen", obs_config=scr4), 10, False)),
                ("gym ram step", ms_per_gym_step(
                    AgarioCore("ram", device=dev, **world))),
                ("gym screen step", ms_per_gym_step(
                    load_task_core(1, device=dev)))]
    else:
        out += [(name, None) for name in ("screen F=4 k=10", "gym ram step",
                                          "gym screen step")]
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    print(label, " | ".join(f"{k} {v:.2f} ms" if v is not None
                            else f"{k} n/a" for k, v in out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

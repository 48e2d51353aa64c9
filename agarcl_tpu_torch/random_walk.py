"""Random-walk task driver (counterpart of bench/random_walk_example.py):
runs a task of the 10-task suite with random actions through the
gymnasium-free core (`tasks.load_task_core`), printing steps/s and each
episode's reward, and optionally writing the rewards to a CSV, recording
episode 0 to a video and saving an env snapshot after it.

    python -m agarcl_tpu_torch.random_walk --task 1 --episodes 3 --obs grid
    python -m agarcl_tpu_torch.random_walk --task 7 --video out.avi
    python -m agarcl_tpu_torch.random_walk --device cpu --max-steps 5

It runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np

from agarcl_tpu_torch.tasks import load_task_core


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", type=int, default=1, help="task mode 1..10")
    ap.add_argument("--episodes", type=int, default=2)
    ap.add_argument("--obs", default=None,
                    help="override obs type (ram/grid/screen/gobigger)")
    ap.add_argument("--video", default=None, help="record episode 0 to file")
    ap.add_argument("--snapshot", default=None, help="save env snapshot here")
    ap.add_argument("--csv", default=None, help="episodic rewards CSV")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    env = load_task_core(args.task, obs_type=args.obs, device=args.device)
    if args.max_steps:
        env.number_of_steps = args.max_steps
    rng = np.random.default_rng(args.seed)

    rows = []
    for ep in range(args.episodes):
        env.reset(seed=args.seed + ep)
        if args.video and ep == 0:
            env.enable_video_recorder()
        total, steps, t0 = 0.0, 0, time.perf_counter()
        done = False
        while not done:
            action = ((float(rng.uniform(-1, 1)), float(rng.uniform(-1, 1))),
                      int(rng.integers(0, 3)))
            _, r, done, _, _ = env.step(action)
            total += r
            steps += 1
        sps = steps / (time.perf_counter() - t0)
        print(f"episode {ep}: reward={total:.1f} steps={steps} "
              f"steps/s={sps:.1f}")
        rows.append((ep, total, sps))
        if args.video and ep == 0:
            d, f = os.path.split(args.video)
            env.generate_video(d or ".", f)
            env.disable_video_recorder()
        if args.snapshot and ep == 0:
            env.save_env_state(args.snapshot)

    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["episode", "reward", "sps"])
            w.writerows(rows)
    return rows


if __name__ == "__main__":
    main()

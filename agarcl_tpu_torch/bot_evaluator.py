"""Bot evaluator (counterpart of bench/bot_evaluator.py): many headless
mode-0 games in lockstep on the card, the agent random-walking and the
bots following their scripted policies in the engine; the report gives
the final mass per bot type (avg / max / min over all games) and the
env-steps per second.

    python -m agarcl_tpu_torch.bot_evaluator --games 2048 --steps 250
    python -m agarcl_tpu_torch.bot_evaluator --games 64 --device cpu

The games run through VecEnv (obs_type "none"): the tick kernel K1 on the
card for rosters of up to 9 players (--bots 8, the default); a larger
roster runs the plain engine on the same device (backend "torch"), and
the script says so. Game g starts from seed g + --seed, as the JAX tool
seeds it.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

BOT_NAMES = {1: "HungryBot", 2: "HungryShyBot", 3: "AggressiveBot",
             4: "AggressiveShyBot"}


def run(games: int, steps: int, bots: int = 8, arena: int = 250,
        pellets: int = 500, seed: int = 0, device: str = "cuda") -> dict:
    """Play `games` games of `steps` steps; returns the final player
    masses (games, players) as numpy, the bot types, the backend and the
    env-steps per second (host clock around the steps, synchronised)."""
    from agarcl_tpu_torch import EnvConfig
    from agarcl_tpu_torch.env import env_reset
    from agarcl_tpu_torch.ops import fused_tick as FT
    from agarcl_tpu_torch.profiling import synchronize
    from agarcl_tpu_torch.vec import VecEnv

    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=arena,
                    num_pellets=pellets, num_viruses=10, num_bots=bots,
                    mode=0)
    dev = torch.device(device)
    backend = "cuda" if dev.type == "cuda" else "torch"
    if backend == "cuda" and not FT.supports(cfg):
        backend = "torch"
        print(f"# {FT.refusal(cfg)}: the games run on the plain engine "
              f"(backend='torch') on {dev}", flush=True)
    env = VecEnv(cfg, games, "none", backend=backend, device=dev)
    states = env_reset(cfg, torch.arange(games, dtype=torch.int64,
                                         device=dev) + seed)
    rng = np.random.default_rng(seed)
    synchronize(states)
    t0 = time.perf_counter()
    for _ in range(steps):
        acts = np.zeros((games, 1, 3), np.float32)
        acts[..., :2] = rng.uniform(-1, 1, (games, 1, 2))
        states, _, _, _ = env.step(states, torch.from_numpy(acts).to(dev))
    synchronize(states)
    dt = time.perf_counter() - t0
    return dict(masses=states.player_mass().cpu().numpy(),
                bot_types=cfg.bot_types(), backend=backend,
                env_steps_per_sec=games * steps / dt)


def report(out: dict, games: int, steps: int) -> str:
    """bench/bot_evaluator.py's table."""
    masses, bot_types = out["masses"], out["bot_types"]
    lines = [f"{games} games x {steps} steps "
             f"({out['env_steps_per_sec']:,.0f} env-steps/s)",
             f"{'player':18s} {'avg':>8s} {'max':>8s} {'min':>8s}"]
    agent = masses[:, 0]
    lines.append(f"{'agent (random)':18s} {agent.mean():8.1f} "
                 f"{agent.max():8d} {agent.min():8d}")
    for bt in sorted(set(bot_types) - {0}):
        cols = [i for i, b in enumerate(bot_types) if b == bt]
        m = masses[:, cols].ravel()
        lines.append(f"{BOT_NAMES[bt]:18s} {m.mean():8.1f} {m.max():8d} "
                     f"{m.min():8d}")
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--games", type=int, default=64)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--bots", type=int, default=8)
    ap.add_argument("--arena", type=int, default=250)
    ap.add_argument("--pellets", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the evaluator runs on a CUDA device and none "
                           "is available (pass --device cpu)")
    out = run(args.games, args.steps, args.bots, args.arena, args.pellets,
              args.seed, args.device)
    print(report(out, args.games, args.steps), flush=True)
    return out


if __name__ == "__main__":
    main()

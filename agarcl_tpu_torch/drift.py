"""Reference-drift harness on the port (counterpart of drift/harness.py,
drift/recombine_probe.py and drift/report.py).

The real reference engine, compiled headless behind a C shim, is the
committed library drift/libref.so; this module loads it as it is, through
ctypes, and never compiles it ($AGARCL_DRIFT_LIB names another copy). The
port runs the same configurations under the same scripted policies
(`run_ours`: each step a `VecEnv.step` on a GameState, K1 on the card, the
plain engine with device="cpu"), and `compare` sets the behaviour
distributions side by side: mass trajectories, the final-mass KS
statistic, eat counts, live pellet, food and virus counts. Exact
trajectories cannot match: the reference seeds std::srand with wall-clock
time (Engine.hpp:49) and its bots draw from std::rand.

    python -m agarcl_tpu_torch.drift --policy chase --seeds 12 --steps 120
    python -m agarcl_tpu_torch.drift --report out.md --quick
    python -m agarcl_tpu_torch.drift --device cpu --seeds 4 --steps 30
"""

from __future__ import annotations

import argparse
import ctypes
import os
import time
from pathlib import Path

import numpy as np
import torch

from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.env import env_reset, respawn_players
from agarcl_tpu_torch.ops import fused_tick as FT
from agarcl_tpu_torch.state import zero_state
from agarcl_tpu_torch.vec import VecEnv

REF_LIB = os.environ.get("AGARCL_DRIFT_LIB") or str(
    Path(__file__).resolve().parent.parent / "drift" / "libref.so")

_ref_lib = None


def _load_ref():
    global _ref_lib
    if _ref_lib is not None:
        return _ref_lib
    if not os.path.exists(REF_LIB):
        raise FileNotFoundError(
            f"reference engine library not found: {REF_LIB} (the committed "
            "drift/libref.so, or set AGARCL_DRIFT_LIB)")
    lib = ctypes.CDLL(REF_LIB)
    lib.ref_create.restype = ctypes.c_void_p
    lib.ref_create.argtypes = [ctypes.c_int] * 7
    lib.ref_destroy.argtypes = [ctypes.c_void_p]
    lib.ref_step.argtypes = [ctypes.c_void_p, ctypes.c_float,
                             ctypes.c_float, ctypes.c_int, ctypes.c_int,
                             ctypes.c_float]
    for f, ret in (("ref_agent_mass", ctypes.c_double),
                   ("ref_agent_cells", ctypes.c_int),
                   ("ref_pellets_alive", ctypes.c_int),
                   ("ref_viruses_alive", ctypes.c_int),
                   ("ref_foods_alive", ctypes.c_int),
                   ("ref_agent_x", ctypes.c_double),
                   ("ref_agent_y", ctypes.c_double),
                   ("ref_agent_food_eaten", ctypes.c_int),
                   ("ref_bot_mass", ctypes.c_double)):
        getattr(lib, f).restype = ret
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.ref_respawn_if_dead.argtypes = [ctypes.c_void_p]
    for f in ("ref_nearest_pellet_dir", "ref_nearest_virus_dir"):
        getattr(lib, f).argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float)]
    _ref_lib = lib
    return lib


class RefEnv:
    """The reference engine, headless, one env (drift/harness.py:52)."""

    def __init__(self, arena=100, num_pellets=200, num_viruses=2, mode=4,
                 num_agents=1, num_bots=0, seed=0):
        self._lib = _load_ref()
        self._h = self._lib.ref_create(arena, num_pellets, num_viruses, mode,
                                       num_agents, num_bots, seed)

    def step(self, dx, dy, act=0, ticks=4, dt=1.0 / 30.0):
        self._lib.ref_step(self._h, float(dx), float(dy), int(act),
                           int(ticks), float(dt))
        self._lib.ref_respawn_if_dead(self._h)

    def metrics(self):
        lib, h = self._lib, self._h
        return dict(mass=lib.ref_agent_mass(h), cells=lib.ref_agent_cells(h),
                    pellets=lib.ref_pellets_alive(h),
                    viruses=lib.ref_viruses_alive(h),
                    foods=lib.ref_foods_alive(h),
                    food_eaten=lib.ref_agent_food_eaten(h),
                    bot_mass=lib.ref_bot_mass(h))

    def _dir(self, fn):
        dx, dy = ctypes.c_float(), ctypes.c_float()
        fn(self._h, ctypes.byref(dx), ctypes.byref(dy))
        return dx.value, dy.value

    def nearest_pellet_dir(self):
        return self._dir(self._lib.ref_nearest_pellet_dir)

    def nearest_virus_dir(self):
        return self._dir(self._lib.ref_nearest_virus_dir)

    def close(self):
        if self._h:
            self._lib.ref_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


def scripted_actions(seed: int, steps: int):
    """The shared per-seed action script: random directions and periodic
    split / feed (drift/harness.py:126)."""
    rng = np.random.default_rng(seed * 7919 + 13)
    dirs = rng.uniform(-1.0, 1.0, (steps, 2)).astype(np.float32)
    acts = np.zeros((steps,), np.int32)
    acts[::40] = 2   # split (action enum: 2=split, types.hpp:59-61)
    acts[::25] = np.where(acts[::25] == 0, 1, acts[::25])  # feed
    acts[0] = 0
    return dirs, acts


def run_reference(seeds, steps, policy="script", **cfg):
    """Per-seed metric trajectories of the reference engine under one of
    the policies script, chase, virusfeed, selffeed (drift/harness.py:
    138-185; `run_ours` mirrors them)."""
    out = []
    for s in seeds:
        env = RefEnv(seed=int(s), **cfg)
        dirs, acts = scripted_actions(int(s), steps)
        masses = np.zeros(steps)
        viruses = np.zeros(steps)
        foods = np.zeros(steps)
        for t in range(steps):
            if policy == "chase":
                dx, dy = env.nearest_pellet_dir()
                env.step(dx, dy, acts[t])
            elif policy == "virusfeed":
                if env.metrics()["mass"] >= 60:
                    dx, dy = env.nearest_virus_dir()
                    env.step(dx, dy, 1)
                else:
                    dx, dy = env.nearest_pellet_dir()
                    env.step(dx, dy, 0)
            elif policy == "selffeed":
                if env.metrics()["mass"] < 80:
                    dx, dy = env.nearest_pellet_dir()
                    env.step(dx, dy, 0)
                else:
                    flip = 1.0 if (t % 2 == 0) else -1.0
                    env.step(flip * dirs[t, 0], flip * dirs[t, 1], 1)
            else:
                env.step(dirs[t, 0], dirs[t, 1], acts[t])
            m = env.metrics()
            masses[t] = m["mass"]
            viruses[t] = m["viruses"]
            foods[t] = m["foods"]
        m = env.metrics()
        m["masses"] = masses
        m["virus_traj"] = viruses
        m["food_traj"] = foods
        env.close()
        out.append(m)
    return out


def _nearest_dir(pos, alive, cen):
    """Unit direction (n, 2) toward each env's nearest live entity, and
    whether there is one (n, 1)."""
    n = pos.shape[0]
    rel = pos - cen[:, None, :]
    d2 = (rel * rel).sum(-1)
    d2 = np.where(alive & (d2 > 1e-4), d2, 1e30)
    sel = rel[np.arange(n), d2.argmin(1)]
    nn = np.maximum(np.linalg.norm(sel, axis=1, keepdims=True), 1e-6)
    return (sel / nn).astype(np.float32), (d2.min(1) < 1e29)[:, None]


def _np(x):
    return x.cpu().numpy()


def scenario_config(arena=100, num_pellets=200, num_viruses=2, mode=4,
                    num_agents=1, num_bots=0) -> EnvConfig:
    """The EnvConfig run_ours steps for a scenario's keywords (4 ticks a
    step, as the reference shim)."""
    return EnvConfig(num_agents=num_agents, ticks_per_step=4,
                     arena_size=arena, num_pellets=num_pellets,
                     num_viruses=num_viruses, num_bots=num_bots, mode=mode)


def run_ours(seeds, steps, policy="script", arena=100, num_pellets=200,
             num_viruses=2, mode=4, num_agents=1, num_bots=0,
             device="cuda"):
    """Per-seed metric trajectories of the port under the policies of
    run_reference (drift/harness.py:188-287): one env per seed, reset on
    exactly `seeds`; each step a VecEnv.step of the GameState (K1 on the
    card, the plain engine with device="cpu"), then a respawn of the
    agent alone when it died, as the shim's ref_respawn_if_dead."""
    dev = torch.device(device)
    cfg = scenario_config(arena, num_pellets, num_viruses, mode, num_agents,
                          num_bots)
    n = len(seeds)
    venv = VecEnv(cfg, n, "none", backend="cuda" if dev.type == "cuda"
                  else "torch", device=dev)
    states = env_reset(cfg, torch.tensor([int(s) for s in seeds],
                                         dtype=torch.int64, device=dev))
    dirs = np.stack([scripted_actions(int(s), steps)[0] for s in seeds])
    acts = np.stack([scripted_actions(int(s), steps)[1] for s in seeds])
    masses = np.zeros((n, steps))
    virus_traj = np.zeros((n, steps))
    food_traj = np.zeros((n, steps))
    for t in range(steps):
        if policy in ("chase", "virusfeed", "selffeed"):
            cen = _np(states.player_centroid()[:, 0])
            pp, pa = states.pellet_xy_alive(cfg)
            dchase, has = _nearest_dir(_np(pp), _np(pa), cen)
            pdir = np.where(has, dchase, 0.0)
            mass = _np(states.player_mass()[:, 0])
        if policy == "chase":
            d, act = pdir, acts[:, t]
        elif policy == "virusfeed":
            vdir, vhas = _nearest_dir(_np(states.virus_pos),
                                      _np(states.virus_alive), cen)
            hungry = mass < 60
            d = np.where(hungry[:, None], pdir, np.where(vhas, vdir, 0.0))
            act = np.where(hungry, 0, 1)
        elif policy == "selffeed":
            flip = 1.0 if (t % 2 == 0) else -1.0
            hungry = mass < 80
            d = np.where(hungry[:, None], pdir, flip * dirs[:, t])
            act = np.where(hungry, 0, 1)
        else:
            d, act = dirs[:, t], acts[:, t]
        a = np.concatenate([d, act[:, None]], axis=1)[:, None, :]
        states = venv.step(states, torch.from_numpy(
            a.astype(np.float32)).to(dev))[0]
        dead = ~states.player_alive()[:, 0]
        if bool(dead.any()):
            mask = torch.zeros((n, cfg.num_players), dtype=torch.bool,
                               device=dev)
            mask[:, 0] = dead
            states = respawn_players(cfg, states, mask)
        masses[:, t] = _np(states.player_mass()[:, 0])
        virus_traj[:, t] = _np(states.virus_alive.sum(1))
        food_traj[:, t] = _np(states.food_alive.sum(1))
    pa = _np(states.pellet_xy_alive(cfg)[1])
    pm_all = _np(states.player_mass())
    pal_all = _np(states.player_alive())
    cells = _np(states.cell_alive[:, 0].sum(-1))
    viruses = _np(states.virus_alive.sum(1))
    foods = _np(states.food_alive.sum(1))
    food_eaten = _np(states.food_eaten[:, 0])
    out = []
    for i in range(n):
        bot_mass = (float(pm_all[i, 1] * pal_all[i, 1])
                    if cfg.num_players > 1 else 0.0)
        out.append(dict(
            mass=float(masses[i, -1]), bot_mass=bot_mass,
            cells=int(cells[i]), pellets=int(pa[i].sum()),
            viruses=int(viruses[i]), foods=int(foods[i]),
            food_eaten=int(food_eaten[i]), masses=masses[i],
            virus_traj=virus_traj[i], food_traj=food_traj[i]))
    return out


def ks_stat(a, b):
    """Two-sample Kolmogorov-Smirnov statistic."""
    a, b = np.sort(a), np.sort(b)
    allv = np.concatenate([a, b])
    ca = np.searchsorted(a, allv, side="right") / len(a)
    cb = np.searchsorted(b, allv, side="right") / len(b)
    return float(np.abs(ca - cb).max())


def compare(ref, ours, steps):
    """Summary dict of distribution deltas: name -> (reference, port), or
    the final-mass KS statistic (drift/harness.py:298-323)."""
    checkpoints = [steps // 4, steps // 2, steps - 1]
    rm = np.stack([r["masses"] for r in ref])
    om = np.stack([o["masses"] for o in ours])
    rows = {}
    for cp in checkpoints:
        rows[f"mean_mass@{cp + 1}"] = (float(rm[:, cp].mean()),
                                       float(om[:, cp].mean()))
    rows["final_mass_ks"] = ks_stat(rm[:, -1], om[:, -1])
    for k in ("food_eaten", "pellets", "foods", "cells"):
        rows[f"mean_{k}"] = (float(np.mean([r[k] for r in ref])),
                             float(np.mean([o[k] for o in ours])))
    if any(r.get("bot_mass", 0.0) > 0 for r in ref + ours):
        rows["mean_bot_mass"] = (
            float(np.mean([r["bot_mass"] for r in ref])),
            float(np.mean([o["bot_mass"] for o in ours])))
        rows["bot_dead_frac"] = (
            float(np.mean([r["bot_mass"] == 0.0 for r in ref])),
            float(np.mean([o["bot_mass"] == 0.0 for o in ours])))
    for k in ("virus_traj", "food_traj"):
        rv = np.stack([r[k] for r in ref])
        ov = np.stack([o[k] for o in ours])
        rows[f"mean_{k}"] = (float(rv.mean()), float(ov.mean()))
        rows[f"max_{k}"] = (float(rv.max()), float(ov.max()))
    return rows


# --------------------------------------------------------- recombine probe

MERGE_CFG = EnvConfig(num_agents=1, ticks_per_step=1, arena_size=100,
                      num_pellets=50, num_viruses=0, num_bots=0, mode=4)


def merge_ticks(max_steps: int = 3000, device="cuda"):
    """Ticks from a forced split to the merge in the port (the counterpart
    of drift/recombine_probe.py::ours_merge_ticks): chase pellets from seed
    3 until the mass reaches 60, split, then tick with a fixed target
    until one cell is left. Every tick is K1 with a tick count
    (engine_tick_raw) on the card, its plain version on the CPU. Returns
    None when the cells have not merged after max_steps ticks."""
    cfg = MERGE_CFG
    dev = torch.device(device)
    template = zero_state(cfg, 1, dev)
    planes = FT.to_kernel_arrays(env_reset(cfg, torch.tensor(
        [3], dtype=torch.int64, device=dev)))
    alive = FT.PLANE_INDEX["cell_alive"][0]

    def tick(act=None):
        a = None if act is None else torch.tensor(
            [[act]], dtype=torch.float32, device=dev)
        return FT.engine_tick_raw(cfg, planes, 1, None, a)[0]

    for _ in range(800):                    # grow by chasing pellets
        s = FT.from_kernel_arrays(template, planes)
        pp, pa = s.pellet_xy_alive(cfg)
        v, _ = _nearest_dir(_np(pp), _np(pa), _np(s.player_centroid()[:, 0]))
        planes = tick([v[0, 0], v[0, 1], 0.0])
        if int(planes[FT.PLANE_INDEX["cell_mass"][0]][:, 0][
                planes[alive][:, 0]].sum()) >= 60:
            break
    planes = tick([0.5, 0.0, 2.0])          # split
    if int(planes[alive].sum()) < 2:
        raise RuntimeError("the forced split did not split the cell")
    planes = tick([0.0, 0.0, 0.0])          # fixed target, first tick
    for t in range(max_steps):
        if t:
            planes = tick()
        if int(planes[alive].sum()) == 1:
            return t + 1
    return None


def ref_merge_ticks(max_steps: int = 3000):
    """Ticks from a forced split to the merge in the reference at fast
    headless pacing (drift/recombine_probe.py::ref_merge_ticks with no
    sleep), or None when its wall-clock timer never fired."""
    env = RefEnv(arena=100, num_pellets=50, num_viruses=0, mode=4, seed=3)
    for _ in range(200):
        dx, dy = env.nearest_pellet_dir()
        env.step(dx, dy, 0, ticks=4)
        if env.metrics()["mass"] >= 60:
            break
    env.step(0.5, 0.0, 2, ticks=1)
    for t in range(max_steps):
        env.step(0.0, 0.0, 0, ticks=1)
        if env.metrics()["cells"] == 1:
            return t + 1
    return None


# ------------------------------------------------------------------ report

# drift/report.py:56-93: (title, policy, cfg kwargs, deviations exercised,
# seeds of a full run where it is not the default 48)
SCENARIOS = [
    ("mode-4 scripted random walk (splits + feeds)", "script",
     dict(mode=4, num_pellets=200, num_viruses=2, arena=100),
     "baseline: pinned RNG + order pins (SPEC D1-D4, M1-M9)", None),
    ("mode-4 greedy pellet chase", "chase",
     dict(mode=4, num_pellets=200, num_viruses=2, arena=100),
     "eating-heavy: pellet arbitration (M1), eat-order pins (M5)", 200),
    ("duel mode-7 vs HungryBot, pellet chase", "chase",
     dict(mode=7, num_pellets=200, num_viruses=2, arena=100, num_bots=1),
     "bot policy + cross-player eating (M3) + bot RNG (D2)", 200),
    ("virus-feed: aim at nearest virus and feed", "virusfeed",
     dict(mode=4, num_pellets=300, num_viruses=6, arena=80),
     "food→virus 7-hit reset/spawn (M4) + one-spawn-per-tick cap", None),
    ("self-feed: continuous ejections with direction flips", "selffeed",
     dict(mode=4, num_pellets=200, num_viruses=2, arena=100),
     "same-tick food edibility (tick.py:24-26 vs Engine.hpp:1011-1025)",
     None),
    ("mode-0 full game vs 4 bots, pellet chase", "chase",
     dict(mode=0, num_pellets=200, num_viruses=2, arena=100, num_bots=4),
     "5-player roster: mode-0 respawn_all + all four bot types (M3, Q5)",
     200),
]


def _pct(ref, ours):
    if abs(ref) < 1e-9:
        return "—" if abs(ours) < 1e-9 else "inf"
    return f"{100.0 * (ours - ref) / abs(ref):+.1f}%"


def _fmt_rows(rows):
    out = ["| metric | reference | port | Δ |", "|---|---|---|---|"]
    for k, v in rows.items():
        if isinstance(v, tuple):
            out.append(f"| {k} | {v[0]:.3f} | {v[1]:.3f} | "
                       f"{_pct(v[0], v[1])} |")
        else:
            out.append(f"| {k} | — | — | KS={v:.3f} |")
    return "\n".join(out)


def report(path, quick: bool = False, device="cuda") -> list:
    """Run drift/report.py's scenario matrix through the port (12 seeds x
    120 steps with quick, else 48 or the scenario's seeds x 300) and the
    recombine probe at fast headless pacing, and write a Markdown report
    (reference | port | Δ per metric, then a KS summary) to `path`.
    Returns the summary rows (title, seeds, final-mass Δ, KS, KS crit)."""
    seeds_n, steps = (12, 120) if quick else (48, 300)
    dev = torch.device(device)
    parts = [
        "# Drift of the port against the reference engine", "",
        f"Port device: {dev}"
        + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
           else "") + f"; {steps} env-steps of 4 ticks per seed.", ""]
    summary = []
    for title, policy, kw, note, n_over in SCENARIOS:
        n = seeds_n if (quick or n_over is None) else n_over
        seeds = list(range(1, n + 1))
        t0 = time.perf_counter()
        rows = compare(run_reference(seeds, steps, policy=policy, **kw),
                       run_ours(seeds, steps, policy=policy, device=dev,
                                **kw), steps)
        fm = rows[f"mean_mass@{steps}"]
        crit = 1.63 * np.sqrt(2 / n)     # two-sample KS, alpha = 0.01
        summary.append((title, n, _pct(fm[0], fm[1]), rows["final_mass_ks"],
                        crit))
        parts += [f"## {title} (n={n})", "",
                  f"*Deviations exercised: {note}.* "
                  f"({time.perf_counter() - t0:.1f} s)", "",
                  _fmt_rows(rows), ""]
    ours, ref = merge_ticks(device=dev), ref_merge_ticks()
    parts += ["## Recombine timer (SPEC D3 + M7 touch slack)", "",
              "| engine | pacing | ticks from the split to the merge |",
              "|---|---|---|",
              "| reference | fast headless (wall-clock timer) | "
              f"{ref if ref is not None else '>3000 (never merged)'} |",
              f"| port | tick-based | {ours} |", "",
              "## Summary", "",
              "| scenario | n | final-mass Δ | final-mass KS | "
              "KS crit (α=0.01) |", "|---|---|---|---|---|"]
    for title, n, d, ks, crit in summary:
        flag = "" if ks < crit else " **REJECTS**"
        parts.append(f"| {title} | {n} | {d} | {ks:.3f}{flag} | "
                     f"{crit:.3f} |")
    parts.append("")
    with open(path, "w") as f:
        f.write("\n".join(parts))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seeds", type=int, default=48)
    ap.add_argument("--mode", type=int, default=4)
    ap.add_argument("--pellets", type=int, default=200)
    ap.add_argument("--viruses", type=int, default=2)
    ap.add_argument("--arena", type=int, default=100)
    ap.add_argument("--policy", default="script",
                    choices=["script", "chase", "virusfeed", "selffeed"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="run the scenario matrix and write a Markdown "
                    "report to PATH")
    ap.add_argument("--quick", action="store_true",
                    help="with --report: 12 seeds x 120 steps")
    args = ap.parse_args(argv)
    if args.report:
        t0 = time.perf_counter()
        for title, n, d, ks, crit in report(args.report, args.quick,
                                            args.device):
            print(f"  {title} (n={n}): final mass {d}, KS {ks:.3f} "
                  f"(crit {crit:.3f})")
        print(f"wrote {args.report} in {time.perf_counter() - t0:.1f} s")
        return None
    seeds = list(range(1, args.seeds + 1))
    kw = dict(arena=args.arena, num_pellets=args.pellets,
              num_viruses=args.viruses, mode=args.mode)
    print(f"reference engine x{args.seeds} seeds, {args.steps} steps, "
          f"policy={args.policy} ...")
    ref = run_reference(seeds, args.steps, policy=args.policy, **kw)
    print(f"agarcl_tpu_torch on {args.device} ...")
    ours = run_ours(seeds, args.steps, policy=args.policy,
                    device=args.device, **kw)
    rows = compare(ref, ours, args.steps)
    for k, v in rows.items():
        print(f"  {k}: {v}")
    return rows


if __name__ == "__main__":
    main()

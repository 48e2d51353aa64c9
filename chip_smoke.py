"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's main paths (agarcl_tpu_torch) at full size, in
the bench.py game (mode 4, arena 350, 500 pellets, 10 viruses, 4 ticks per
step, delta-mass reward) at 8192 envs through VecEnv on the card: the RAM
path (RAM frame every step; reset, make_resident, multi_step(k=40)), the
screen path (the task suite's 128 x 128 agent-view screen every step;
reset, multi_step(k=10)) and the grid path (bench.py --obs grid: a 64 x 64
int16 grid of 8 channels every step; reset, multi_step(k=10)); then the
task suite's duel (mode 10: one agent against an AggressiveShy bot) on the
screen path, its RAM path and mode 0 with bots; then polygon screens and
two agents' frames; then the rim: a 12-player roster on the plain engine,
the frame routes by size, ShardedVecEnv, the port's bench, the bot
evaluator, the client and profiling; then the trainer (PPO on K1) and
the witnesses (K1 against the C++ oracle, the port against the reference
engine). Phases, one line each:

  1. toolchain: GPU name and power limit, torch and CUDA versions, nvcc,
     kernel build time, ptxas registers, stack and spills per kernel;
  2. K2 (RAM-frame kernel) against obs/ram.py::ram_frame on the card;
  3. K1 (multi-step tick kernel) against its plain version on the card,
     from reset(0) with random actions: obs, rewards, dones and state
     after 1 step, after 8 steps and after one k=40 call, the main path's
     launch;
  4. launch counters over the main path: both kernels launched, the plain
     version never called; outputs finite and of the expected shapes;
  5. throughput in env-steps/s for the kernel path and the plain "torch"
     backend on the same card;
  6. K1's launch shape at 1, 2 and 9 players (blocks, envs a block,
     dynamic shared memory, resident blocks per SM from the occupancy
     API; at least 2 at 1 player); K1 alone, timed with CUDA events, with
     and without the RAM frame at 1, 64 and 4096 to 32768 envs: the
     frame's share and the scaling;
  7. K3 (screen kernel) against its plain version on the card, 0 differing
     pixels: 8192 envs after 3 steps at S=128 agent view and S=84 natural
     RGB, a heavy-cell state (mass 400+ beside viruses) and a two-player
     state (other players drawn); S=512 natural RGB at 1024 envs (above
     the 448 pixels of the first K3's byte class map);
  8. the screen main path: reset + multi_step(k=10) launches K1 10 times
     and K3 11 times and no plain version, (10, 8192, 1, 1, 128, 128, 4)
     uint8 frames, finite rewards; one k=10 call of the plain "torch"
     backend from the same state gives the same rewards, dones and frames;
     then the per-step composition (auto_reset, respawn_main_during_obs,
     64 dead main players) for 2 steps against the torch backend;
  9. times: screen-path env-steps/s for both backends, K3 alone per frame
     (CUDA events) against its bound at S=128 agent view and S=84 natural
     RGB, K1 at k=1 per step; K3's launch shape (blocks, threads, dynamic
     shared memory, resident blocks per SM from the occupancy API); the
     device's busy share of a screen call from CUDA events (the port's
     kernel times over the call's wall time) beside torch.profiler's;
 10. K4 (grid kernel) against its plain version on the card, 0 differing
     values: 8192 envs after 3 steps at G=64 int16, G=128 int32 and G=32
     int8, a heavy-cell state, a two-player state (others' min and max),
     two viruses in one bin (max below the total), an own cell above 32767
     (int16 saturation) and one case with channels switched off;
 11. the grid main path: reset + multi_step(k=10) launches K1 10 times and
     K4 11 times and no plain version, (10, 8192, 1, 1, 8, 64, 64) int16
     frames; the plain "torch" backend from the same state gives the same
     rewards, dones and frames; then the per-step composition as in 8;
 12. times: grid-path env-steps/s for both backends, K4 alone per frame
     (CUDA events) against its bound at G=64 int16 and G=128 int32, the
     plain section build, the device's busy share of one profiled call, K1
     at k=1 per step against its plain version; K4's launch shapes and the
     busy share from CUDA events, as in 9;
 13. K1 with bots and cross-player eating against its plain version: the
     duel task configurations (bench/tasks_configs/mode_7.json to
     mode_10.json: one agent against one scripted bot, arena 350, 500
     pellets, no viruses) at 8192 envs after 1 step, after 8 steps and
     after one k=10 call, mode 0 with 8 bots (9 players) at 2048 envs, and
     a forced cross-eat; the bot pass and the cross-eat must have fired;
 14. the duel main paths: the screen path (reset + multi_step(k=10), K1 10
     launches, K3 11, plain 0, equal to the torch backend) in modes 10, 7,
     8 and 9; the duel's RAM path on resident state (multi_step(k=40));
     mode 0 with 8 bots (2048 envs) and mode 0 with 2 agents and 1 bot
     through the per-step composition (mode 0 respawns) against the torch
     backend; K2 at 2 players against ram_frame;
 15. times: duel screen-path env-steps/s for both backends, K1 per k=1
     step at 1, 2 and 9 players against its bound and from phase 7's heavy
     state, the single-player RAM path again beside phase 5;
 16. K3 in poly mode (ScreenObsConfig(polygon_edges=True,
     polygon_virus="circle"): 5-gon pellets, 7-gon foods, 50-gon cells)
     against its plain version on phase 7's states at S=128 agent view and
     S=84 natural RGB, 0 differing pixels, and the fans differ from
     circle mode;
 17. the polygon screen path (reset + multi_step(k=10): K1 10, K3 11,
     plain 0, the GameState route 0; equal to the torch backend) in the
     bench.py game and the duel (mode 10); the wavy virus rim at 1024 envs
     through obs/screen.py::screen_frame on the card (its class_map_calls
     counter 3, K3 0, plain 0; equal to the torch backend); mode 0 with 2
     agents and 1 bot on the screen (128 x 128 agent view) and the grid
     (64 x 64 int16) through the per-step composition: K3 and K4 once per
     step over N*A frames, reset frames equal to the plain version's, the
     steps equal to the torch backend's;
 18. times: polygon screen-path env-steps/s for both backends, K3 poly
     per frame against its bound and against circle mode on the same
     state, the wavy route per step, K3 and K4 per step at 2 agents
     against their bounds; the launch shapes of K3 in poly mode and of K3
     and K4 at 2 agents;
 19. K1 with a tick count (fused_tick.engine_tick_raw: n ticks with no
     action phase, or with one, then the RAM frame and info rows) against
     engine_tick_raw_plain on a played and a heavy state of the bench.py
     game at 8192 envs, the duel (2 players) at 8192 and mode 0 with 8
     bots (9 players) at 2048: 1 and 3 ticks, with and without
     actions;
 20. the multi-frame paths (num_frames 4: every tick of a 4-tick step
     framed) at 8192 envs: reset + multi_step(k=10) of the 128 x 128 agent
     view screen in the bench.py game and the duel (mode 10) and of the
     64 x 64 int16 grid: K1 through engine_tick_raw 4 times a step, K3 / K4 4
     times a step and once at reset, plain 0; frames (10, 8192, 4, 1, ...);
     2 steps from the same state equal to the torch backend; num_frames 6
     (two zero frames first);
 21. the gym core (gym_core.AgarioCore, no gymnasium) on the card against
     the same core with the plain backend on the card: tasks 10 and 1
     (load_task_core) for 300 steps, the default gym world (arena 1000,
     1000 pellets) with the grid at num_frames 4, RAM and GoBigger for 100
     steps; obs, rewards and dones equal; a checkpoint and a JSON snapshot
     saved on the card and reloaded give the same next step;
 22. VecEnv(obs_type="gobigger") at 8192 envs: K1, then the plain
     gobigger_frame on the card, equal to the torch backend;
 23. times: num_frames-4 screen and grid env-steps/s, K1 per one-tick
     partial-step call (CUDA events, and the kernel's own device time from
     torch.profiler) against its bound, gym steps per second at 1 env per
     obs type with the share of a step that is host time;
 24. a roster above 9 players (mode 0 with 11 bots) on backend="torch" on
     the card at 1024 envs, RAM and the 64 x 64 int16 grid, 8 steps, no
     kernel launched, against the same plain engine on the CPU at 64
     envs; backend="cuda" raises NotImplementedError naming the 9-player
     limit and backend="torch";
 25. the frame routes by size at 256 envs, reset + multi_step(k=2): circle
     S=640 through obs/screen.py::screen_frame (class_map_calls 3, K3 0)
     and a G=256 int32 grid through fused_grid.frame_plain (plain_calls 3,
     K4 0), each frame equal to the CPU's route on the first 16 envs of the
     same state; S=544 and G=238 still launch K3 / K4 (3 each), equal to
     their plain versions;
 26. sharding: distributed.initialize with one NCCL rank (tcp://localhost),
     ShardedVecEnv over the card's devices at 8192 envs, RAM, resident
     k=40: K1 and K2 once a shard; reset frames, frames, rewards, dones and
     state bit-equal to VecEnv; mean_reward (one all_reduce) the global
     mean; both timed; with more than one card, 2 shards in one process;
 27. the port's bench, agarcl_tpu_torch.bench.main in process for --obs
     ram, --obs screen --size 128, --obs grid and --mode 10 --obs screen
     --size 128: bench.py's JSON line each (printed), kernels only; and
     --mode 0 --bots 9 at 256 envs, which K1 refuses: the plain engine on
     the card, its JSON line saying backend "torch", a note on stderr;
 28. the bot evaluator, 2048 games x 25 steps (9 players, K1 once a step):
     its table and env-steps/s;
 29. the client at its defaults (9 players, S=512 natural RGB), 30 steps
     steered by the mouse: K1 and K3 once a step; each frame of a step
     without a cross-player eat equal to K3's plain version on the planes
     of the state after the step;
 30. profiling: device_time_of on one K3 call against CUDA events,
     StepTimer, and trace() (the screen kernel's device time);
 31. PPO (agarcl_tpu_torch/train_ppo.py) in examples/train_ppo.py's task
     (mode 3, arena 60, 200 pellets) at 8192 envs x 16 steps x 200
     iterations: K1 once a rollout step, K2 once at reset; K1's first
     rollout step and a step after the run bit-equal to its plain version
     (planes, RAM frame, info rows); a finite loss every iteration; it
     learns: the mean reward per step over the 200 iterations above the
     same run's with lr 0 (the example's first 5 / last 5 iterations line
     is printed, not held: it falls for the example itself at this
     length); one iteration from the same parameters, states and noise on
     the card and on the CPU at 64 envs (loss within rtol 1e-4,
     parameters within 0.1 lr, mean reward equal); the training rate, the
     split of an iteration between rollout and update (CUDA events), K1's
     share of the rollout, the device busy share; the CLI for 10
     iterations;
 32. each oracle configuration's first 5 steps on K1 bit-equal to the
     plain engine on the card; then K1 against the C++ oracle
     (agarcl_tpu_torch/oracle.py, built from oracle/oracle.cpp) on
     tests/test_parity.py's scenarios and seeds (PCFG random walk seeds
     0-2 and splits/feeds seed 7, DUEL seed 11, mode 0 with 4 bots seed 5)
     at its bars, every step;
 33. each drift scenario's configuration (5 steps of 12 envs) and the
     recombine probe's one-tick calls (8 ticks) on K1 bit-equal to the
     plain engine on the card; then tests/test_drift.py's three scenarios
     (chase, virusfeed, selffeed; 12 seeds x 120 steps) with the port's
     run_ours on the card against the reference engine (drift/libref.so)
     at that file's bars; then
     `python -m agarcl_tpu_torch.drift --report chiprun_out/DRIFT_torch.md
     --quick` in process, timed.

Then a JSON line of the rim's own figures ("rim": the 12-player plain
step, sharded and unsharded call times, the bot evaluator's rate and the
client's step, none of them a kernel's), a JSON line of the trainer's
figures ("trainer": phase 31's rate, split and shares, and the drift
report's wall time), a JSON line describing each kernel (its launches by
path include phases 24-33's), the GPU line and,
last, the device JSON line. Every screen and grid step runs K1 through
engine_tick_raw, so the JSON line lists those launches under
"engine_tick" and the RAM and GoBigger paths' under "multi_step_tick".
Every comparison of a kernel path with its plain version (or of the
card's plain engine with the CPU's) is bit for bit: every field of every
env's state, every frame value, reward and done equal (torch.equal, which
counts -0.0 equal to 0.0). Any failure raises and exits non-zero.
Without a CUDA device the script exits non-zero before printing any
result; it never falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_ENVS = 8192
K_STEPS = 40
PROBE_ENVS = (1, 64, 4096, 8192, 16384, 32768)
S_SCREEN = 128                           # bench/tasks_configs/mode_*.json
K_SCREEN = 10                            # bench.py:76-77, non-RAM obs
G_GRID = 64                              # bench.py:108-111, --obs grid
HBM_BYTES_PER_S = 3.35e12                # H100 SXM data sheet
F32_OPS_PER_S = 67e12                    # f32 outside the tensor cores


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _timed(fn, dev, reps: int) -> float:
    """Seconds per call over `reps` calls, synchronized."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / reps


def _random_actions(n: int, dev, agents: int = 1) -> torch.Tensor:
    """(n, agents, 3) per-env targets in [-1, 1]^2 and actions in
    {0, 1, 2}."""
    rng = np.random.default_rng(0)
    acts = np.concatenate([rng.uniform(-1.0, 1.0, (n, agents, 2)),
                           rng.integers(0, 3, (n, agents, 1))], axis=-1)
    return torch.from_numpy(acts.astype(np.float32)).to(dev)


def _same(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Equal shapes, dtypes and values (torch.equal: -0.0 equals 0.0)."""
    return (x.shape == y.shape and x.dtype == y.dtype
            and bool(torch.equal(x, y)))


def _max_err(x: torch.Tensor, y: torch.Tensor) -> float:
    """Largest |x - y| over the values that differ (0 when none does)."""
    m = x != y
    if not bool(m.any()):
        return 0.0
    return (x[m].double() - y[m].double()).abs().max().item()


def _differing_envs(a, b) -> torch.Tensor:
    """(N,) bool: envs in which any value of two GameStates differs."""
    from agarcl_tpu_torch.state import STATE_FIELDS
    bad = torch.zeros(a.num_envs, dtype=torch.bool, device=a.device)
    for f in STATE_FIELDS:
        bad |= (getattr(a, f) != getattr(b, f)).reshape(a.num_envs,
                                                        -1).any(1)
    return bad


def _check_same_states(a, b, label: str) -> None:
    """Every field of every env bit-equal; else fail naming how many envs
    differ and the largest difference."""
    from agarcl_tpu_torch.state import STATE_FIELDS
    n_bad = int(_differing_envs(a, b).sum())
    if n_bad:
        err = max(_max_err(getattr(a, f), getattr(b, f))
                  for f in STATE_FIELDS)
        _check(False, f"{label}: state bit-equal in every env ({n_bad} of "
               f"{a.num_envs} envs differ, largest difference {err})")


def _check_same(pairs, label: str) -> None:
    """Each (name, got, want) bit-equal; else fail naming the largest
    difference."""
    for name, x, y in pairs:
        if not _same(x, y):
            err = (_max_err(x, y) if x.shape == y.shape
                   else f"shapes {tuple(x.shape)} / {tuple(y.shape)}")
            _check(False, f"{label}: {name} bit-equal (largest difference "
                   f"{err})")


def _compare_runs(cfg, out_k, out_p, label: str) -> float:
    """Hold K1's (resident, obs, rewards, dones) bit-equal to the plain
    version's: every state field of every env, RAM frame, reward and done.
    Returns the largest |K1 - plain| over the RAM frames and rewards."""
    from agarcl_tpu_torch.ops import fused_step
    res_k, obs_k, rew_k, done_k = out_k
    res_p, obs_p, rew_p, done_p = out_p
    _check_same_states(fused_step.from_resident(cfg, res_k),
                       fused_step.from_resident(cfg, res_p), label)
    _check_same([("RAM frames", obs_k, obs_p), ("rewards", rew_k, rew_p),
                 ("dones", done_k, done_p)], label)
    return max(_max_err(obs_k, obs_p), _max_err(rew_k, rew_p))


BIT_EQUAL = ("bit-equal (every state field of every env, RAM frames, "
             "rewards, dones)")


def _event_ms(fn, reps: int) -> float:
    """Mean CUDA-event ms of fn over `reps` calls, after one warm call."""
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _bound_ms(nbytes: float, ops: float):
    """(least ms the card could take, what binds): bytes over the HBM rate
    against f32 operations over the f32 peak."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def _tick_work(cfg, ocfg, n: int, k: int):
    """Bytes and f32 operations of one K1 call of k steps: every state
    plane read and written once, the actions read, the RAM frames (with a
    RamObsConfig, one per agent) and (mass, alive) rows written; counted
    operations are the pellet-eat distance tests of one cell per player
    and tick (6 each) and one key evaluation (8 operations) per live pellet
    and virus (the counts the regen keeps) per frame — the least work of
    the function, whatever selection finds the nearest keys."""
    from agarcl_tpu_torch.obs.ram import ram_size
    from agarcl_tpu_torch.ops import fused_tick as FT
    A = cfg.num_agents
    state = sum(r * (1 if dt == torch.bool else 4)
                for _, r, dt in FT._plane_specs(cfg))
    frame = 4 * A * ram_size(cfg, ocfg) if ocfg is not None else 0
    nbytes = n * (2 * state + 12 * A + k * (frame + 8 * cfg.num_players))
    per_step = cfg.ticks_per_step * cfg.pellet_capacity * 6 * cfg.num_players
    if ocfg is not None:
        per_step += 8 * A * (cfg.num_pellets + cfg.num_viruses)
    return nbytes, n * k * per_step


def _ram_work(cfg, ocfg, n: int):
    """Bytes and f32 operations of one K2 frame: the cell, pellet and virus
    planes it reads once, the frame written, one key evaluation (8
    operations) per live pellet and virus (the counts the regen keeps) per
    agent."""
    from agarcl_tpu_torch.obs.ram import ram_size
    cells = cfg.num_players * cfg.max_cells * (5 * 4 + 1)
    per_env = (cells + 4 * cfg.pellet_capacity + 13 * cfg.virus_capacity
               + 4 * cfg.num_agents * ram_size(cfg, ocfg))
    ops = 8 * cfg.num_agents * (cfg.num_pellets + cfg.num_viruses)
    return n * per_env, n * ops


def _screen_work(cfg, ocfg, planes):
    """Bytes and f32 operations of one K3 call on these planes: the cell,
    pellet, food and virus planes read once and the frames (one per agent)
    written once; per frame 22 operations per pixel row or column for the
    pixel-centre tables and grid flags, one per pixel for the grid, and per
    live entity 5 per pixel test over its bounding box (3 for a fan: a
    subtraction and two compares), plus 4 per half-plane line in each row
    of a fan's box (what this state's entities need)."""
    from agarcl_tpu_torch.obs import screen as TS
    from agarcl_tpu_torch.ops import fused_screen as FS
    n, A = planes[0].shape[-1], cfg.num_agents
    S, ch = ocfg.screen_len, 4 if ocfg.agent_view else 3
    poly = ocfg.polygon_edges
    read = (cfg.num_players * cfg.max_cells * 13 + 4 * cfg.pellet_capacity
            + 9 * cfg.food_capacity + 13 * cfg.virus_capacity)
    nbytes = n * (read + A * S * S * ch)
    sides = dict(p=TS.SIDES_PELLET, f=TS.SIDES_FOOD, m=TS.SIDES_CELL,
                 o=TS.SIDES_CELL)
    ops = float(n * A * (22 * S + S * S))
    for a in range(A):
        sec = FS.screen_sections(cfg, planes, a)
        half = sec["params"][:, 2:3]
        pitch = 2.0 * half / S
        for c in ("p", "f", "m", "o", "v"):
            r2 = sec[c + "r2"]
            live = r2 >= 0
            r = torch.sqrt(r2.clamp(min=0))
            cam = sec["params"][:, 0:2]
            side = []
            for ax, j in (("x", 0), ("y", 1)):
                w0 = cam[:, j:j + 1] - half + pitch / 2
                lo = torch.ceil((sec[c + ax] - r - w0) / pitch).clamp(0, S)
                hi = torch.floor((sec[c + ax] + r - w0) / pitch).clamp(
                    -1, S - 1)
                side.append((hi - lo + 1).clamp(min=0))
            tests = (side[0] * side[1] * live).double().sum().item()
            fan = poly and c != "v"
            ops += (3 if fan else 5) * tests
            if fan:
                rows = (side[1] * live).double().sum().item()
                ops += 4 * sides[c] * rows
    return nbytes, ops


def _grid_work(cfg, ocfg, n: int):
    """Bytes and f32 operations of one K4 call: the cell, pellet and virus
    planes it reads once and the frames (one per agent) written once; per
    frame 10 operations per entity bin and 4 per output pixel (a lower
    bound)."""
    G, C, A = ocfg.grid_size, ocfg.channels_per_frame, cfg.num_agents
    elem = torch.empty((), dtype=ocfg.torch_dtype).element_size()
    read = (cfg.num_players * cfg.max_cells * 13 + 4 * cfg.pellet_capacity
            + 13 * cfg.virus_capacity)
    ents = cfg.pellet_capacity + cfg.virus_capacity + (
        cfg.num_players * cfg.max_cells)
    return (n * (read + A * C * G * G * elem),
            n * A * (10 * ents + 4 * G * G))


def _grid_cases(cfg, duel, played, heavy):
    """(label, cfg, state) of the phase-10 states beyond the played one:
    the heavy state; two players whose second player stacks two cells of
    different mass in one bin; two viruses in one bin (masses 100 and
    150); an own cell of mass 40000."""
    dev = played.device
    two = _two_player_state(duel, heavy)
    cp, cm, ca = two.cell_pos.clone(), two.cell_mass.clone(), \
        two.cell_alive.clone()
    cp[:, 1, 1] = cp[:, 1, 0] + torch.tensor([0.01, 0.01], device=dev)
    cm[:, 1, 1], ca[:, 1, 1] = 40, True
    two = two.replace(cell_pos=cp, cell_mass=cm, cell_alive=ca)
    vp, vm = played.virus_pos.clone(), played.virus_mass.clone()
    vp[:, 1] = vp[:, 0] + torch.tensor([0.01, 0.01], device=dev)
    vm[:, 1] = 150
    vir = played.replace(virus_pos=vp, virus_mass=vm)
    cm = played.cell_mass.clone()
    cm[:, 0, 0] = 40000
    big = played.replace(cell_mass=cm)
    return [("heavy", cfg, heavy), ("two players", duel, two),
            ("two viruses in a bin", cfg, vir),
            ("own mass 40000", cfg, big)]


def _heavy_state(cfg, n: int, dev):
    """Cells of mass 400-2500 beside viruses, then 4 plain steps of splits
    and pops."""
    from agarcl_tpu_torch.env import env_reset, reset_seeds
    from agarcl_tpu_torch.vec import VecEnv
    s = env_reset(cfg, reset_seeds(n, 3, dev))
    cm = s.cell_mass.clone()
    cm[:, 0, 0] = 400 + 300 * (torch.arange(n, device=dev) % 8)
    cp = s.cell_pos.clone()
    cp[:, 0, 0] = 175.0
    vp = s.virus_pos.clone()
    vp[: n // 2, 0] = 178.0
    s = s.replace(cell_mass=cm, cell_pos=cp, virus_pos=vp)
    env = VecEnv(cfg, n, "none", backend="torch", device=dev)
    s, _, _, _ = env.multi_step(s, _random_actions(n, dev), 4)
    return s


def _two_player_state(duel, s):
    """A two-player (mode 7 layout) state: player 0 as in s, player 1 its
    copy shifted by (12, -7) at half the mass; the world of s."""
    from agarcl_tpu_torch.state import zero_state
    z = zero_state(duel, s.num_envs, s.device)
    cp, cm, ca = z.cell_pos.clone(), z.cell_mass.clone(), z.cell_alive.clone()
    shift = torch.tensor([12.0, -7.0], device=s.device)
    cp[:, 0], cp[:, 1] = s.cell_pos[:, 0], s.cell_pos[:, 0] + shift
    cm[:, 0], cm[:, 1] = s.cell_mass[:, 0], s.cell_mass[:, 0] // 2
    ca[:, 0], ca[:, 1] = s.cell_alive[:, 0], s.cell_alive[:, 0]
    world = {f: getattr(s, f) for f in (
        "pellet_key", "virus_pos", "virus_mass", "virus_alive", "food_pos",
        "food_alive")}
    return z.replace(cell_pos=cp, cell_mass=cm, cell_alive=ca, **world)


def _device_profile(fn, dev):
    """(device-busy share of fn's wall time, [(name, ms)] of the three
    largest device-time entries) from torch.profiler, or None when the
    profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0))
            for e in prof.key_averages()]
    busy = sum(t for _, t in rows)
    if busy <= 0:
        return None
    top = sorted(rows, key=lambda r: -r[1])[:3]
    return busy / wall_us, [(k[:40], t / 1e3) for k, t in top]


def _kernel_device_ms(fn, name: str, calls: int, dev):
    """Device ms per call of the kernels whose name holds `name` over
    `calls` calls of fn (torch.profiler), or None when the profiler sees
    no device time: the kernel's own time where a call is host-bound."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(dev)
    for _ in range(3):          # a window whose device records are lost
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize(dev)
        t = sum(getattr(e, "self_device_time_total", 0.0)
                for e in prof.key_averages() if name in e.key)
        if t > 0:
            return t / 1e3 / calls
    return None


def _ptxas_summary(log: str) -> str:
    """'kernel: N registers, ...; S bytes stack, spills st/ld' for each
    kernel in a ptxas -v report."""
    out, name, frame = [], None, ""
    for line in log.splitlines():
        if "bytes stack frame" in line and name:
            nums = re.findall(r"(\d+) bytes", line)
            frame = (f"; {nums[0]} bytes stack, spills {nums[1]}/{nums[2]}"
                     if len(nums) == 3 else "")
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            for short in ("multi_step_kernel", "ram_frame_kernel",
                          "screen_kernel", "grid_kernel"):
                if short in name:
                    cap = name.split("multi_step_kernelILi")[-1]
                    name = (f"{short}<{cap.split('E')[0]}>"
                            if short == "multi_step_kernel" else short)
                    flags = re.findall(r"Lb([01])E", line)
                    if short == "screen_kernel":
                        name += "<{},{}>".format(
                            "poly" if flags[0] == "1" else "circle",
                            "agents" if flags[1] == "1" else "one")
                    elif short == "grid_kernel":
                        elem = re.findall(r"Li([124])E", line)
                        name += "<{},{}>".format(
                            "agents" if flags[0] == "1" else "one",
                            f"int{8 * int(elem[0])}" if elem else "?")
        elif "Used" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}{frame}")
            name, frame = None, ""
    return "; ".join(out) or "no ptxas report (cached build)"


def _shape_text(shape: dict) -> str:
    """One kernel's launch shape (FS / FG.launch_shape) as text."""
    return (f"{shape['blocks']} blocks of {shape['threads']} threads, "
            f"{shape['smem_bytes']} bytes of dynamic shared memory, "
            f"{shape['blocks_per_sm']} resident blocks per SM")


def _busy_text(parts, wall_s: float, prof) -> str:
    """The device's busy share of a call: the sum of its kernels' CUDA-event
    times (parts: (launches, ms per launch)) over the call's wall time,
    beside torch.profiler's busy share (prof, _device_profile's)."""
    busy = sum(n * ms for n, ms in parts) / (1e3 * wall_s)
    pt = ("not measured (the profiler saw no device time)" if prof is None
          else f"{100 * prof[0]:.1f}%")
    return (f"device busy {100 * busy:.1f}% of the call's wall time by CUDA "
            f"events (the port's kernels: "
            + " + ".join(f"{n} x {ms:.3f} ms" for n, ms in parts)
            + f"), {pt} by torch.profiler (which slows the host)")


def _k1_event_ms(cfg, n: int, ocfg, k: int, dev, reps: int = 3) -> float:
    """Median CUDA-event ms of one K1 call of k steps at n envs, after one
    warm call from reset(0)."""
    from agarcl_tpu_torch.env import env_reset, reset_seeds
    from agarcl_tpu_torch.ops import fused_tick as FT
    planes = FT.to_kernel_arrays(env_reset(cfg, reset_seeds(n, 0, dev)))
    acts = _random_actions(n, dev)
    FT.multi_step_raw(cfg, planes, acts, k, ocfg)
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        FT.multi_step_raw(cfg, planes, acts, k, ocfg)
        e1.record()
        torch.cuda.synchronize(dev)
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


DUEL_TASK = dict(num_agents=1, ticks_per_step=4, arena_size=350,
                 num_pellets=500, num_viruses=0, num_bots=1,
                 reward_type=True)       # bench/tasks_configs/mode_7..10.json
N_ROSTER = 2048                          # envs of the mode-0 rosters
N_WAVY = 1024                            # envs of the wavy route (memory)


def _kernel_modules():
    from agarcl_tpu_torch.ops import fused_grid as FG
    from agarcl_tpu_torch.ops import fused_obs
    from agarcl_tpu_torch.ops import fused_screen as FS
    from agarcl_tpu_torch.ops import fused_tick as FT
    return FT, fused_obs, FS, FG


def _zero_counts() -> None:
    from agarcl_tpu_torch.obs import screen as TS
    for m in _kernel_modules():
        m.launches = m.plain_calls = 0
    _kernel_modules()[0].tick_launches = 0
    TS.class_map_calls = 0


def _plain_count() -> int:
    return sum(m.plain_calls for m in _kernel_modules())


def _rosters():
    """(label, cfg, envs) of phase 13: the four duel task configurations
    and mode 0 with 8 bots in the bench.py world."""
    from agarcl_tpu_torch import EnvConfig
    out = [(f"mode {m}", EnvConfig(mode=m, **DUEL_TASK), N_ENVS)
           for m in (7, 8, 9, 10)]
    out.append(("mode 0 with 8 bots", EnvConfig(
        num_agents=1, ticks_per_step=4, arena_size=350, num_pellets=500,
        num_viruses=10, num_bots=8, mode=0), N_ROSTER))
    return out


def _phase13(dev, ocfg) -> float:
    """K1 with bots and cross-player eating against its plain version, bit
    for bit; returns the largest error seen."""
    from agarcl_tpu_torch.env import env_reset, reset_seeds
    from agarcl_tpu_torch.ops import fused_step
    from agarcl_tpu_torch.ops import fused_tick as FT

    def both(cfg, rk, rp, k, a):
        return (fused_step.multi_step_resident(cfg, rk, a, k, ocfg),
                fused_step.multi_step_resident(
                    cfg, rp, a, k, ocfg, plain=True))

    err = 0.0
    acts = _random_actions(N_ENVS, dev)
    for label, cfg, n in _rosters():
        a = acts[:n]
        s0 = env_reset(cfg, reset_seeds(n, 0, dev))
        res = lambda: fused_step.to_resident(cfg, s0)  # noqa: E731
        o1k, o1p = both(cfg, res(), res(), 1, a)
        e1 = _compare_runs(cfg, o1k, o1p, f"{label}: after 1 step")
        o8k, o8p = both(cfg, o1k[0], o1p[0], 7, a)
        e8 = _compare_runs(cfg, o8k, o8p, f"{label}: after 8 steps")
        s8 = fused_step.from_resident(cfg, o8k[0])
        bots = slice(cfg.num_agents, None)
        moved = int((s8.target[:, bots] != s0.target[:, bots]).flatten(1)
                    .any(1).sum())
        eaten = int((s8.cells_eaten > 0).any(1).sum())
        _check(moved > 0, f"{label}: bot targets changed")
        del o1k, o1p, o8k, o8p, s8
        o10k, o10p = both(cfg, res(), res(), 10, a)
        e10 = _compare_runs(cfg, o10k, o10p, f"{label}: after one k=10 call")
        del o10k, o10p
        err = max(err, e1, e8, e10)
        print(f"[13 K1 with bots] {label} ({cfg.num_players} players), {n} "
              f"envs, reset(0), random agent actions: after 1 step, after 8 "
              f"steps and after one k=10 call {BIT_EQUAL}; after 8 steps bot "
              f"targets moved in {moved} envs, a cell was eaten across "
              f"players in {eaten}", flush=True)
    # a forced cross-eat: a 500-mass agent cell on the bot's spawn
    cfg = _rosters()[3][1]
    s0 = env_reset(cfg, reset_seeds(N_ENVS, 0, dev))
    cp, cm = s0.cell_pos.clone(), s0.cell_mass.clone()
    cp[:, 0, 0], cm[:, 0, 0] = cp[:, 1, 0], 500
    s0 = s0.replace(cell_pos=cp, cell_mass=cm)
    ok, op = both(cfg, fused_step.to_resident(cfg, s0),
                  fused_step.to_resident(cfg, s0), 1, acts)
    e = _compare_runs(cfg, ok, op, "forced cross-eat: after 1 step")
    sk = fused_step.from_resident(cfg, ok[0])
    eaten = int((sk.cells_eaten[:, 0] > 0).sum())
    _check(eaten > N_ENVS // 2, f"forced cross-eat: the agent ate the bot "
           f"in most envs ({eaten})")
    dones = int(ok[3][0, :, 0].sum())
    _check(dones >= eaten, f"forced cross-eat: done on death ({dones})")
    err = max(err, e)
    print(f"[13 K1 with bots] forced cross-eat (mode 10, agent cell of 500 "
          f"on the bot), {N_ENVS} envs, 1 step: {BIT_EQUAL}; the agent ate "
          f"the bot in {eaten} envs, {dones} envs done", flush=True)
    return err


def _screen_path(cfg, dev, acts, scr, label, phase="14 duel screen path"):
    """A screen path: reset + multi_step(k=10) on the card (counts from
    zero; K3 in poly mode for a polygon `scr`, never the GameState route),
    then the torch backend from the same state; with a bot, the bot must be
    drawn. Returns (K1 launches, K3 launches, plain seconds, the card's
    VecEnv)."""
    from agarcl_tpu_torch.obs import screen as TS
    from agarcl_tpu_torch.vec import VecEnv
    FT, _, FS, _ = _kernel_modules()
    senv = VecEnv(cfg, N_ENVS, "screen", obs_config=scr)
    penv = VecEnv(cfg, N_ENVS, "screen", backend="torch", device=dev,
                  obs_config=scr)
    _zero_counts()
    st0, sobs0 = senv.reset(0)
    st, sobs, srew, sdone = senv.multi_step(st0, acts, K_SCREEN)
    torch.cuda.synchronize(dev)
    k1, k3, plain = FT.tick_launches, FS.launches, _plain_count()
    routed = TS.class_map_calls
    _check(k1 == FT.launches == K_SCREEN and k3 == K_SCREEN + 1
           and plain == 0 and routed == 0,
           f"{label} screen path launches K1 {K_SCREEN}x through "
           f"engine_tick_raw, K3 {K_SCREEN + 1}x, plain 0x, class map 0x "
           f"(K1 {FT.launches}, through engine_tick_raw {k1}, K3 {k3}, "
           f"plain {plain}, class map {routed})")
    _check(tuple(sobs.shape) == (K_SCREEN, N_ENVS, 1, 1, S_SCREEN, S_SCREEN,
                                 4) and sobs.dtype == torch.uint8,
           f"{label} screen obs shape")
    _check(bool(torch.isfinite(srew).all()), f"{label} finite rewards")
    drawn = int((sobs[-1, :, 0, 0, :, :, 1] == 255).flatten(1).any(1).sum())
    _check(drawn > 0 or cfg.num_players == 1,
           f"{label}: the bot drawn (G 255) in some frame")
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    pst, pobs, prew, pdone = penv.multi_step(st0, acts, K_SCREEN)
    torch.cuda.synchronize(dev)
    prew.sum().item()
    t_plain = time.perf_counter() - t0
    _check_same_states(st, pst, f"{label} screen path")
    _check_same([("frames", sobs, pobs), ("rewards", srew, prew),
                 ("dones", sdone, pdone)], f"{label} screen path")
    mode = "polygon fans" if scr.polygon_edges else "circles"
    print(f"[{phase}] {label}, reset + multi_step(k={K_SCREEN}) at {N_ENVS} "
          f"envs, S={S_SCREEN} agent view, {mode}: K1 launches {k1}, K3 "
          f"launches {k3}, plain calls {plain}, class map calls {routed}; "
          f"the bot drawn in {drawn} last frames; against the torch backend "
          f"state, frames, rewards and dones bit-equal "
          f"({int(sdone.sum())} done agent-steps)", flush=True)
    return k1, k3, t_plain, senv


def _per_step_ram(cfg, n, dev, k, label):
    """A mode-0 roster's RAM path on the card (per step: mode 0 respawns)
    against the torch backend; returns K1's launches."""
    from agarcl_tpu_torch.vec import VecEnv
    FT = _kernel_modules()[0]
    a = _random_actions(n, dev, cfg.num_agents)
    env = VecEnv(cfg, n, "ram")
    penv = VecEnv(cfg, n, "ram", backend="torch", device=dev)
    _zero_counts()
    s0, _ = env.reset(0)
    st, obs, rew, done = env.multi_step(s0, a, k)
    torch.cuda.synchronize(dev)
    k1, plain = FT.launches, _plain_count()
    _check(k1 == k and plain == 0, f"{label}: K1 {k}x, plain 0x (K1 {k1}, "
           f"plain {plain})")
    pst, pobs, prew, pdone = penv.multi_step(s0, a, k)
    _check(obs.shape == pobs.shape and obs.shape[3] == cfg.num_agents,
           f"{label}: one RAM frame per agent {tuple(obs.shape)}")
    _check_same_states(st, pst, label)
    _check_same([("RAM frames", obs, pobs), ("rewards", rew, prew),
                 ("dones", done, pdone)], label)
    _check(bool(st.player_alive().all()), f"{label}: mode 0 respawned "
           "every dead player")
    print(f"[14 {label}] {n} envs, multi_step(k={k}) per step on the card: "
          f"K1 launches {k1}, plain calls {plain}; obs {tuple(obs.shape)}; "
          f"against the torch backend {BIT_EQUAL}; cells eaten across "
          f"players {int(st.cells_eaten.sum())}", flush=True)
    return k1


F_FRAMES = 4                             # every tick of a 4-tick step
GYM_STEPS = 300                          # steps of each task on the core
GYM_WORLD_STEPS = 100                    # steps of the default gym world


def _partial_work(cfg, n: int, n_ticks: int):
    """Bytes and f32 operations of one K1 call in partial-step mode with no
    actions and no frame: every state plane read and written once, the
    (mass, alive) rows written; the pellet-eat distance tests of one cell
    per player and tick (6 each) as the operations (a lower bound)."""
    from agarcl_tpu_torch.ops import fused_tick as FT
    state = sum(r * (1 if dt == torch.bool else 4)
                for _, r, dt in FT._plane_specs(cfg))
    nbytes = n * (2 * state + 8 * cfg.num_players)
    return nbytes, n * n_ticks * cfg.pellet_capacity * 6 * cfg.num_players


def _phase19(cfg, duel, m0_8, played, heavy, ocfg, dev) -> float:
    """K1's partial-step mode against engine_tick_raw_plain: n = 1 and 3
    ticks, with and without actions, at 1, 2 and 9 players; state, RAM
    frames and info rows bit-equal. Returns the largest error."""
    from agarcl_tpu_torch.env import env_reset, reset_seeds
    from agarcl_tpu_torch.vec import VecEnv
    FT = _kernel_modules()[0]
    err = 0.0
    sd, _, _, _ = VecEnv(duel, N_ENVS, "none", backend="torch",
                         device=dev).multi_step(
        env_reset(duel, reset_seeds(N_ENVS, 0, dev)),
        _random_actions(N_ENVS, dev), 3)
    s9 = env_reset(m0_8, reset_seeds(N_ROSTER, 0, dev))
    cases = [("bench.py game, played", cfg, played),
             ("bench.py game, heavy", cfg, heavy),
             ("duel (mode 7), 2 players", duel, sd),
             ("mode 0 with 8 bots, 9 players", m0_8, s9)]
    for label, c, s in cases:
        n = s.num_envs
        for n_ticks, with_actions in ((1, False), (3, True), (1, True),
                                      (3, False)):
            a = _random_actions(n, dev, c.num_agents) if with_actions \
                else None
            before = FT.tick_launches
            pk, ok, ik = FT.engine_tick_raw(c, FT.to_kernel_arrays(s),
                                            n_ticks, ocfg, a)
            pp, op, ip = FT.engine_tick_raw_plain(c, FT.to_kernel_arrays(s),
                                                  n_ticks, ocfg, a)
            torch.cuda.synchronize(dev)
            _check(FT.tick_launches == before + 1, "one partial-step launch")
            what = (f"partial step {label}, {n_ticks} ticks "
                    f"{'with' if with_actions else 'without'} actions")
            _check_same_states(FT.from_kernel_arrays(s, pk),
                               FT.from_kernel_arrays(s, pp), what)
            _check_same([("RAM frames", ok, op), ("info rows", ik, ip)],
                        what)
            err = max(err, _max_err(ok, op))
        print(f"[19 K1 partial step] {label}, {n} envs: 1 and 3 ticks, with "
              f"and without actions, each 1 launch: state of every env, RAM "
              f"frames and info rows bit-equal to engine_tick_raw_plain",
              flush=True)
    return err


def _frames_path(cfg, dev, acts, ocfg, label, k=K_SCREEN):
    """A multi-frame path (num_frames F): reset + multi_step(k) on the card
    (counts from zero: K1 in partial-step mode F times a step, the frame
    kernel F times a step and once at reset, plain 0), then 2 steps
    against the torch backend from the same state. Returns (K1 launches,
    frame-kernel launches)."""
    from agarcl_tpu_torch.obs.grid import GridObsConfig
    from agarcl_tpu_torch.vec import VecEnv
    FT, _, FS, FG = _kernel_modules()
    kind = "grid" if isinstance(ocfg, GridObsConfig) else "screen"
    mod = FG if kind == "grid" else FS
    F = ocfg.num_frames
    Fe = min(F, cfg.ticks_per_step)
    env = VecEnv(cfg, N_ENVS, kind, obs_config=ocfg)
    penv = VecEnv(cfg, N_ENVS, kind, backend="torch", device=dev,
                  obs_config=ocfg)
    _zero_counts()
    st0, _ = env.reset(0)
    st, obs, rew, done = env.multi_step(st0, acts, k)
    torch.cuda.synchronize(dev)
    k1, k1t, kf, plain = (FT.launches, FT.tick_launches, mod.launches,
                          _plain_count())
    _check(k1 == k1t == k * Fe and kf == k * Fe + 1 and plain == 0,
           f"{label}: K1 {k * Fe}x through engine_tick_raw, the frame "
           f"kernel {k * Fe + 1}x, plain 0x (K1 {k1}, through "
           f"engine_tick_raw {k1t}, frame {kf}, plain {plain})")
    _check(tuple(obs.shape[:4]) == (k, N_ENVS, F, 1),
           f"{label}: frames {tuple(obs.shape)}")
    _check(bool(torch.isfinite(rew).all()), f"{label}: finite rewards")
    if F > cfg.ticks_per_step:
        _check(not bool(obs[:, :, :F - Fe].any())
               and bool(obs[:, :, F - Fe:].any()),
               f"{label}: {F - Fe} zero frames first, then drawn ones")
    shape = tuple(obs.shape)
    del obs
    got = env.multi_step(st0, acts, 2)
    want = penv.multi_step(st0, acts, 2)
    _check_same_states(got[0], want[0], label)
    _check_same([("frames", got[1], want[1]), ("rewards", got[2], want[2]),
                 ("dones", got[3], want[3])], label)
    print(f"[20 multi-frame path] {label}, {N_ENVS} envs, reset + "
          f"multi_step(k={k}), num_frames {F}: K1 launches {k1} (through "
          f"engine_tick_raw {k1t}), {kind} kernel launches {kf}, plain calls "
          f"{plain}; frames {shape}; against the torch backend over 2 "
          f"steps state, frames, rewards and dones bit-equal", flush=True)
    del got, want
    return k1t, kf


def _obs_equal(kind, a, b) -> bool:
    """Gym observations equal value for value (GoBigger's dicts by their
    repr)."""
    if kind == "gobigger":
        return repr(a) == repr(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and bool(np.array_equal(a, b)))


def _obs_err(kind, a, b) -> str:
    """The largest difference of two gym observations, for a failure."""
    if kind == "gobigger" or a.shape != b.shape:
        return "n/a"
    return str(_max_err(torch.from_numpy(np.asarray(a)),
                        torch.from_numpy(np.asarray(b))))


def _gym_pair(make, steps, label, dev):
    """The gym core on the card (kernels) against the same core with the
    plain backend on the card: reset(seed=3) and `steps` steps of the same
    random actions; obs, rewards and dones equal. Returns (the kernel core,
    {counter: launches on the kernel core's steps}, kernel seconds per
    step, host clock)."""
    kc, pc = make("cuda"), make("torch")
    ko, _ = kc.reset(seed=3)
    po, _ = pc.reset(seed=3)
    kind = kc.obs_type
    _check(_obs_equal(kind, ko, po), f"{label}: reset obs equal (largest "
           f"difference {_obs_err(kind, ko, po)})")
    FT, K2, FS, FG = _kernel_modules()
    counts = dict(k1=0, k1_tick=0, k2=0, k3=0, k4=0, plain=0)
    rng = np.random.default_rng(4)
    t_k, done_steps = 0.0, 0
    for t in range(steps):
        act = ((float(rng.uniform(-1, 1)), float(rng.uniform(-1, 1))),
               int(rng.integers(0, 3)))
        c0 = (FT.launches, FT.tick_launches, K2.launches, FS.launches,
              FG.launches, _plain_count())
        t0 = time.perf_counter()
        ko, kr, kd, _, _ = kc.step(act)
        t_k += time.perf_counter() - t0
        c1 = (FT.launches, FT.tick_launches, K2.launches, FS.launches,
              FG.launches, _plain_count())
        for key, a, b in zip(counts, c0, c1):
            counts[key] += b - a
        po, pr, pd, _, _ = pc.step(act)
        _check(_obs_equal(kind, ko, po) and kr == pr
               and kd == pd, f"{label}: step {t} equal to the plain backend "
               f"(obs difference {_obs_err(kind, ko, po)}, reward {kr} / "
               f"{pr}, done {kd} / {pd})")
        done_steps += int(kd)
    F = getattr(kc.obs_config, "num_frames", 1)
    frames = {"screen": "k3", "grid": "k4"}.get(kind)
    via_tick = steps * F if frames else 0
    _check(counts["plain"] == 0 and counts["k1"] == steps * F
           and counts["k1_tick"] == via_tick
           and (frames is None or counts[frames] == steps * F),
           f"{label}: K1 {steps * F}x ({via_tick} through engine_tick_raw), "
           f"the frame kernel {steps * F}x, plain 0x ({counts})")
    return kc, pc, counts, t_k / steps, done_steps


def _gym_phase(dev):
    """Phase 21: the gym core on the card. Returns (launches by path,
    per-obs-type kernel cores)."""
    import os
    import tempfile

    from agarcl_tpu_torch.gym_core import AgarioCore
    from agarcl_tpu_torch.io import checkpoint as TC
    from agarcl_tpu_torch.tasks import load_task_core
    FT = _kernel_modules()[0]
    by_path, cores = {}, {}
    paths = [("task 10 (duel, 128 screen)",
              lambda b: load_task_core(10, device=dev, backend=b), GYM_STEPS),
             ("task 1 (128 screen)",
              lambda b: load_task_core(1, device=dev, backend=b), GYM_STEPS),
             ("default world, grid num_frames 4",
              lambda b: AgarioCore("grid", device=dev, backend=b,
                                   num_frames=F_FRAMES), GYM_WORLD_STEPS),
             ("default world, ram",
              lambda b: AgarioCore("ram", device=dev, backend=b),
              GYM_WORLD_STEPS),
             ("default world, gobigger",
              lambda b: AgarioCore("gobigger", device=dev, backend=b),
              GYM_WORLD_STEPS)]
    for label, make, steps in paths:
        kc, pc, counts, t_step, dones = _gym_pair(make, steps, label, dev)
        by_path[label] = counts
        cores.setdefault(kc.obs_type, kc)
        print(f"[21 gym core] {label}, {kc.cfg.num_players} players, arena "
              f"{kc.cfg.arena_size}, {kc.cfg.num_pellets} pellets, "
              f"{steps} steps on the card: equal to the plain backend's core "
              f"(obs, rewards, dones; {dones} done steps); launches on the "
              f"kernel core {counts}; {1e3 * t_step:.2f} ms per step "
              f"(host clock, with the plain core's steps between)",
              flush=True)
        if label.startswith("task 10"):
            snap_core = (kc, pc)
    # a snapshot and a checkpoint saved on the card and reloaded (without
    # action noise, whose generator would move on between the steps)
    kc, pc = snap_core
    kc.add_noise = pc.add_noise = False
    act = ((0.3, -0.6), 0)
    with tempfile.TemporaryDirectory() as d:
        snap, ckpt = os.path.join(d, "s.json"), os.path.join(d, "c.npz")
        kc.save_env_state(snap)
        TC.save_checkpoint(ckpt, kc.cfg, kc.state)
        r1 = kc.step(act)
        _, kc.state = TC.load_checkpoint(ckpt, kc.cfg, dev)
        r2 = kc.step(act)
        kc.load_env_state(snap)
        pc.load_env_state(snap)
        r3, r4 = kc.step(act), pc.step(act)
        kc.load_env_state(snap)
        r5 = kc.step(act)
    for (a, b), what in (((r1, r2), "checkpoint"), ((r3, r4), "snapshot vs "
                         "the plain core"), ((r3, r5), "snapshot twice")):
        _check(_obs_equal("screen", a[0], b[0]) and a[1] == b[1]
               and a[2] == b[2], f"gym {what}: the next step is the same")
    print(f"[21 gym snapshots] task 10 on the card: a checkpoint reloaded "
          f"gives the same next step as the run it came from (reward "
          f"{r1[1]:.4g}); a JSON snapshot reloaded gives the same next step "
          f"on the kernel core twice and on the plain core (reward "
          f"{r3[1]:.4g})", flush=True)
    return by_path, cores


def _gobigger_phase(cfg, dev, acts):
    """Phase 22: VecEnv(obs_type="gobigger") at 8192 envs on the card
    against the torch backend, reset and 2 steps."""
    from agarcl_tpu_torch.vec import VecEnv
    FT = _kernel_modules()[0]
    env = VecEnv(cfg, N_ENVS, "gobigger")
    penv = VecEnv(cfg, N_ENVS, "gobigger", backend="torch", device=dev)
    _zero_counts()
    s0, o0 = env.reset(0)
    s, o, r, d = env.multi_step(s0, acts, 2)
    torch.cuda.synchronize(dev)
    k1, plain = FT.launches, _plain_count()
    _check(k1 == 2 and plain == 0, f"gobigger path: K1 2x, plain 0x (K1 "
           f"{k1}, plain {plain})")
    ps, po, pr, pd = penv.multi_step(s0, acts, 2)
    _check_same_states(s, ps, "gobigger path")
    _check_same([(key, o[key], po[key]) for key in o]
                + [("rewards", r, pr), ("dones", d, pd)], "gobigger path")
    n_foods = int(o["foods_mask"][-1].sum())
    print(f"[22 gobigger path] {N_ENVS} envs, reset + multi_step(k=2): K1 "
          f"launches {k1}, plain calls {plain}; foods table "
          f"{tuple(o['foods'].shape)}, clones {tuple(o['clones'].shape)}; "
          f"against the torch backend the state, every table and mask, "
          f"rewards and dones bit-equal; {n_foods} foods in view in the "
          f"last frames", flush=True)


def _frames_rate(env, acts, dev) -> float:
    """Seconds per multi_step(k=10) call of a multi-frame VecEnv (bench.py
    method: one warm call, median of 3 runs x 4 calls)."""
    s, _ = env.reset(0)
    s, o, rw, _ = env.multi_step(s, acts, K_SCREEN)
    rw.sum().item()
    times = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(4):
            del o
            s, o, rw, _ = env.multi_step(s, acts, K_SCREEN)
        torch.cuda.synchronize(dev)
        rw.sum().item()
        times.append((time.perf_counter() - t0) / 4)
    del o
    return statistics.median(times)


def _gym_rate(core, dev, steps: int = 50):
    """(ms per gym step, host clock; device-busy ms per step, profiler, or
    None) of a kernel core at 1 env."""
    rng = np.random.default_rng(5)
    acts = [((float(rng.uniform(-1, 1)), float(rng.uniform(-1, 1))), 0)
            for _ in range(steps)]
    core.reset(seed=1)
    for a in acts[:5]:
        core.step(a)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for a in acts:
        core.step(a)
    torch.cuda.synchronize(dev)
    wall = 1e3 * (time.perf_counter() - t0) / steps
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for a in acts[:10]:
            core.step(a)
        torch.cuda.synchronize(dev)
    busy = sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()) / 1e3 / 10
    return wall, (busy if busy > 0 else None)


# ----------------------------------------------------------- the rim (24-30)
N_ROUTE = 256                            # envs of the large-frame routes
N_ROUTE_CPU = 16                         # envs of their CPU comparison
N_ROSTER12 = 1024                        # envs of the 12-player roster
N_ROSTER12_CPU = 64                      # envs of its CPU comparison
ROSTER12 = dict(num_agents=1, ticks_per_step=4, arena_size=350,
                num_pellets=500, num_viruses=10, num_bots=11, mode=0)


def _head(s, n: int, device="cpu"):
    """The first n envs of a GameState, on `device`."""
    from agarcl_tpu_torch.state import STATE_FIELDS
    return s.replace(**{f: getattr(s, f)[:n].to(device)
                        for f in STATE_FIELDS})


def _counts() -> dict:
    """The kernels' launch counts and the plain routes' call counts."""
    from agarcl_tpu_torch.obs import screen as TS
    FT, K2, FS, FG = _kernel_modules()
    return {"k1": FT.launches, "k1_tick": FT.tick_launches,
            "k2": K2.launches, "k3": FS.launches, "k4": FG.launches,
            "plain": FT.plain_calls + K2.plain_calls + FS.plain_calls,
            "class_map": TS.class_map_calls, "grid_plain": FG.plain_calls}


def _phase24(dev, gpu) -> float:
    """Rosters above 9 players on the torch backend on the card, against
    the same plain engine on the CPU; the cuda backend's refusal. Returns
    ms per step of the 12-player RAM path on the card."""
    from agarcl_tpu_torch import EnvConfig
    from agarcl_tpu_torch.obs.grid import GridObsConfig
    from agarcl_tpu_torch.vec import VecEnv
    cfg = EnvConfig(**ROSTER12)
    n, nc, steps = N_ROSTER12, N_ROSTER12_CPU, 8
    acts = _random_actions(n, dev)
    try:
        VecEnv(cfg, n, "ram")
        raise RuntimeError("check failed: backend='cuda' took 12 players")
    except NotImplementedError as e:
        msg = str(e)
    _check("9 players" in msg and "backend='torch'" in msg,
           f"the cuda backend's refusal names the limit ({msg})")
    out = {}
    for kind, ocfg in (("ram", None), ("grid", GridObsConfig(grid_size=64))):
        env = VecEnv(cfg, n, kind, backend="torch", device=dev,
                     obs_config=ocfg)
        _zero_counts()
        s, _ = env.reset(0)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        s, o, r, d = env.multi_step(s, acts, steps)
        torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0) / steps
        c = _counts()
        _check(c["k1"] == c["k2"] == c["k3"] == c["k4"] == c["plain"] == 0,
               f"12 players {kind}: no kernel launched ({c})")
        _check(bool(torch.isfinite(r).all()) and s.cell_mass.shape[1] == 12,
               f"12 players {kind}: finite rewards, 12 players")
        cpu = VecEnv(cfg, nc, kind, backend="torch", device="cpu",
                     obs_config=ocfg)
        cs, _ = cpu.reset(0)
        cs, co, cr, cd = cpu.multi_step(cs, acts[:nc].cpu(), steps)
        what = f"12 players {kind}, the card against the CPU"
        _check_same_states(_head(s, nc), cs, what)
        pairs = [("rewards", r[:, :nc].cpu(), cr)]
        if kind == "grid":
            pairs.append(("frames", o[:, :nc].cpu(), co))
        _check_same(pairs, what)
        out[kind] = ms
        del env, s, o, r, d
    print(f"[24 rosters] mode 0 with 11 bots (12 players), backend='torch' "
          f"on the card, {n} envs, reset(0) + multi_step(k={steps}): RAM "
          f"{out['ram']:.1f} ms per step, 64 int16 grid "
          f"{out['grid']:.1f} ms per step (host clock, synchronized); "
          f"no kernel launched; against the plain engine on the CPU at "
          f"{nc} envs: state, rewards and grid frames bit-equal; "
          f"backend='cuda' raises NotImplementedError: {msg} | {gpu}",
          flush=True)
    return out["ram"]


def _phase25(cfg, dev, gpu) -> dict:
    """The frame routes by size on the card: circle S=640 through the
    class map, G=256 int32 through the plain grid frame, each equal to the
    CPU's route on the same states; S=544 and G=238 still launch K3 / K4
    and equal their plain versions. Returns {label: (ms per step, counts)}."""
    from agarcl_tpu_torch.obs.grid import GridObsConfig
    from agarcl_tpu_torch.obs.screen import ScreenObsConfig
    from agarcl_tpu_torch.ops import fused_tick as FT
    from agarcl_tpu_torch.vec import VecEnv
    _, _, FS, FG = _kernel_modules()
    n, nc, k = N_ROUTE, N_ROUTE_CPU, 2
    acts = _random_actions(n, dev)
    cases = (
        ("screen S=640", "screen", ScreenObsConfig(640), "class_map"),
        ("grid G=256 int32", "grid",
         GridObsConfig(grid_size=256, out_dtype="int32"), "grid_plain"),
        ("screen S=544", "screen", ScreenObsConfig(544), "k3"),
        ("grid G=238 int32", "grid",
         GridObsConfig(grid_size=238, out_dtype="int32"), "k4"))
    out, text = {}, []
    for label, kind, ocfg, route in cases:
        env = VecEnv(cfg, n, kind, obs_config=ocfg)
        _zero_counts()
        s, o0 = env.reset(0)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        s, o, r, d = env.multi_step(s, acts, k, stack_obs=False)
        torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0) / k
        c = _counts()
        others = {"class_map", "grid_plain", "k3", "k4"} - {route}
        _check(c[route] == k + 1 and all(c[x] == 0 for x in others)
               and c["k1_tick"] == c["k1"] == k and c["plain"] == 0,
               f"{label}: route {route} {k + 1}x, K1 {k}x, nothing else "
               f"({c})")
        last = o[-1][:, -1]
        if route in ("class_map", "grid_plain"):
            cpu = VecEnv(cfg, nc, kind, backend="torch", device="cpu",
                         obs_config=ocfg)
            want = cpu.observe(_head(s, nc))
        else:
            plain = FS.frame_plain if kind == "screen" else FG.frame_plain
            want = plain(cfg, ocfg, FT.to_kernel_arrays(_head(s, nc, dev)))
        diff = int((last[:nc].to(want.device) != want).sum())
        ref = ("the CPU route" if route in ("class_map", "grid_plain")
               else "the plain version on the card")
        _check(diff == 0, f"{label}: {diff} values differ from {ref}")
        out[label] = (ms, c)
        text.append(f"{label}: {route} {c[route]}x, K1 {c['k1_tick']}x, "
                    f"{ms:.2f} ms per step, 0 values differ from {ref} "
                    f"({nc} envs)")
        del env, s, o, o0, last, want
    print(f"[25 frame routes] bench.py game, {n} envs, reset(0) + "
          f"multi_step(k={k}): " + "; ".join(text) + f" | {gpu}", flush=True)
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _call_ms(fn, dev) -> float:
    """ms per call of fn (bench.py method: one warm call, median of 3 runs
    x 4 calls, each run ended by a synchronisation)."""
    fn()
    times = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(4):
            fn()
        torch.cuda.synchronize(dev)
        times.append(1e3 * (time.perf_counter() - t0) / 4)
    return statistics.median(times)


def _phase26(cfg, ocfg, dev, acts, gpu) -> dict:
    """ShardedVecEnv over the card's devices in an NCCL group of one rank,
    bit-equal to VecEnv; both timed. Returns the sharded path's counts and
    times."""
    import torch.distributed as dist
    from agarcl_tpu_torch.ops import fused_step
    from agarcl_tpu_torch.parallel import ShardedVecEnv, make_env_mesh
    from agarcl_tpu_torch.parallel import distributed as D
    from agarcl_tpu_torch.state import STATE_FIELDS
    from agarcl_tpu_torch.vec import VecEnv
    N, k = N_ENVS, K_STEPS
    D.initialize(f"localhost:{_free_port()}", 1, 0)
    _check(dist.is_initialized() and dist.get_backend() == "nccl",
           "one NCCL rank")
    n_dev = torch.cuda.device_count()
    mesh = make_env_mesh()
    _check(D.global_env_count(N // mesh.size, mesh) == N, "global env count")
    sh = ShardedVecEnv(cfg, N, mesh, "ram", obs_config=ocfg)
    ve = VecEnv(cfg, N, "ram", obs_config=ocfg)
    _zero_counts()
    ss, so0 = sh.reset(0)
    rs = sh.make_resident(ss)
    rs, so, sr, sd = sh.multi_step(rs, acts, k)
    for d in mesh.devices:
        torch.cuda.synchronize(d)
    c = _counts()
    _check(c["k1"] == len(mesh.devices) and c["k2"] == len(mesh.devices)
           and c["plain"] == 0, f"sharded RAM path: K1 and K2 once a shard "
           f"({c})")
    vs, vo0 = ve.reset(0)
    rv = ve.make_resident(vs)
    rv, vo, vr, vd = ve.multi_step(rv, acts, k)
    cat = (lambda xs, axis=0: torch.cat([x.to(dev) for x in xs], axis))
    for label, a, b in (("reset frames", cat(so0), vo0),
                        ("frames", cat(so, 1), vo), ("rewards", cat(sr, 1), vr),
                        ("dones", cat(sd, 1), vd)):
        _check(bool(torch.equal(a, b)), f"sharded {label} equal VecEnv's")
    ms_, mv = sh.materialize(rs), ve.materialize(rv)
    for f in STATE_FIELDS:
        _check(bool(torch.equal(cat([getattr(s, f) for s in ms_]),
                                getattr(mv, f))), f"sharded state {f} equal")
    mean = sh.mean_reward(sr)
    _check(mean == vr.to(torch.float64).mean().item(),
           f"mean_reward over the group ({mean}) is the global mean")
    t_sh = _call_ms(lambda: sh.multi_step(rs, acts, k), dev)
    t_ve = _call_ms(lambda: ve.multi_step(rv, acts, k), dev)
    two = "one card: no two-shard run"
    if n_dev > 1:
        sh2 = ShardedVecEnv(cfg, N, make_env_mesh(
            [torch.device("cuda", i) for i in range(2)]), "ram",
            obs_config=ocfg)
        s2, _ = sh2.reset(0)
        r2 = sh2.make_resident(s2)
        r2, o2, rr2, _ = sh2.multi_step(r2, acts, k)
        _check(bool(torch.equal(cat(rr2, 1), vr)),
               "two shards in one process equal VecEnv")
        t2 = _call_ms(lambda: sh2.multi_step(r2, acts, k), dev)
        two = f"2 shards on 2 cards {t2:.2f} ms per call, equal"
    dist.destroy_process_group()
    print(f"[26 sharding] torch.cuda.device_count() = {n_dev}; one NCCL rank "
          f"(tcp://localhost); ShardedVecEnv over {len(mesh.devices)} "
          f"device(s), {N} envs, RAM, resident multi_step(k={k}): K1 "
          f"{c['k1']}x, K2 {c['k2']}x; reset frames, frames, rewards, dones "
          f"and state bit-equal to VecEnv; mean_reward {mean:.6f} (one "
          f"all_reduce); {t_sh:.2f} ms per call sharded, {t_ve:.2f} unsharded "
          f"(median of 3 x 4 calls); {two} | {gpu}", flush=True)
    return {"counts": c, "ms": t_sh, "vecenv_ms": t_ve}


BENCH_RUNS = (["--obs", "ram"], ["--obs", "screen", "--size", "128"],
              ["--obs", "grid"], ["--mode", "10", "--obs", "screen",
                                  "--size", "128"])


def _phase27(gpu) -> dict:
    """The port's bench entry in process, one JSON line each; returns
    {flags: counts}."""
    from agarcl_tpu_torch import bench
    out = {}
    for argv in BENCH_RUNS:
        _zero_counts()
        line = bench.main(list(argv))
        c = _counts()
        _check(line["backend"] == "cuda" and c["plain"] == 0
               and c["class_map"] == 0 and c["k1"] > 0,
               f"bench {' '.join(argv)}: kernels only ({c})")
        _check(line["value"] > 0 and line["device"] == gpu,
               f"bench {' '.join(argv)}: a rate and the card's line")
        out[" ".join(argv)] = c
    # a roster K1 refuses: the plain engine on the card, said on stderr
    # and in the JSON line's backend, under bench.py's metric name
    note = io.StringIO()
    with contextlib.redirect_stderr(note):
        line = bench.main(["--mode", "0", "--bots", "9", "--envs", "256",
                           "--steps", "2", "--iters", "1"])
    _check(line["backend"] == "torch" and line["metric"]
           == "env_steps_per_sec_per_chip_256envs_ram_mode0_9bots"
           and "10" in note.getvalue() and "backend='torch'"
           in note.getvalue(), f"bench at 10 players: the plain engine, "
           f"named ({line}, {note.getvalue()!r})")
    print(f"[27 bench] python -m agarcl_tpu_torch.bench with "
          + "; ".join(f"{a}: K1 {c['k1']}x, K2 {c['k2']}x, K3 {c['k3']}x, "
                      f"K4 {c['k4']}x" for a, c in out.items())
          + " (the JSON lines above); --mode 0 --bots 9 on the plain "
          f"engine, noted: {note.getvalue().strip()}", flush=True)
    return out


def _phase28(gpu) -> dict:
    """The bot evaluator at 2048 games x 25 steps on the card."""
    from agarcl_tpu_torch import bot_evaluator
    _zero_counts()
    out = bot_evaluator.run(2048, 25, device="cuda")
    c = _counts()
    _check(out["backend"] == "cuda" and c["k1"] == 25 and c["plain"] == 0,
           f"bot evaluator: K1 once a step, no plain version ({c})")
    _check(bool((out["masses"] >= 0).all()) and out["masses"].shape
           == (2048, 9), "bot evaluator: masses of 9 players")
    print("[28 bot evaluator] " + bot_evaluator.report(out, 2048, 25)
          .replace("\n", " | ") + f" | {gpu}", flush=True)
    return {"counts": c, "rate": out["env_steps_per_sec"]}


def _phase29(dev, gpu) -> dict:
    """The client at its defaults (9 players, S=512 natural RGB), 30
    headless steps; each frame held against K3's plain version on the
    planes of the state after the step (in steps where no cell was eaten
    across players, so mode 0's respawn changed nothing after the frame was
    drawn)."""
    from agarcl_tpu_torch.client import Client
    from agarcl_tpu_torch.ops import fused_screen as FS
    from agarcl_tpu_torch.ops import fused_tick as FT
    client = Client()
    _zero_counts()
    frames, planes, t_steps = [], [], []
    for t in range(30):
        client.set_mouse(256 + 200 * math.cos(t / 5), 256 + 200 * math.sin(
            t / 5))
        eaten = int(client.state.cells_eaten.sum())
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        frame = client.step()
        torch.cuda.synchronize(dev)
        t_steps.append(1e3 * (time.perf_counter() - t0))
        if int(client.state.cells_eaten.sum()) == eaten:
            frames.append((t, frame))
            planes.append(FT.to_kernel_arrays(client.state))
    c = _counts()
    _check(c["k3"] == 30 and c["k1"] == 30 and c["plain"] == 0,
           f"client: K1 and K3 once a step ({c})")
    _check(len(frames) >= 25, f"client: at least 25 steps without a "
           f"cross-player eat ({len(frames)})")
    for (t, frame), p in zip(frames, planes):
        want = FS.frame_plain(client.cfg, client.ocfg, p)[0, 0]
        diff = int((frame != want.cpu().numpy()[::-1]).any(-1).sum())
        _check(diff == 0, f"client step {t}: {diff} pixels differ from "
               f"K3's plain version")
    held = len(frames)
    lb = client.leaderboard()
    print(f"[29 client] Client() (9 players, S=512 natural RGB, 1 tick a "
          f"step), 30 steps steered by a circling mouse: K1 {c['k1']}x, K3 "
          f"{c['k3']}x; {held} frames equal K3's plain version (0 pixels); "
          f"{statistics.median(t_steps):.2f} ms per step (median, host "
          f"clock); leaderboard top 3 {lb[:3]} | {gpu}", flush=True)
    return {"counts": c, "ms": statistics.median(t_steps)}


def _phase30(cfg, dev, s2, gpu) -> None:
    """profiling.device_time_of on one K3 call against CUDA events;
    StepTimer and trace on the card."""
    from agarcl_tpu_torch import profiling
    from agarcl_tpu_torch.obs.screen import ScreenObsConfig
    from agarcl_tpu_torch.ops import fused_screen as FS
    from agarcl_tpu_torch.ops import fused_tick as FT
    scr = ScreenObsConfig(S_SCREEN, agent_view=True)
    planes = FT.to_kernel_arrays(s2)
    call = (lambda: FS.fused_screen_frame(cfg, scr, planes))
    dt_ms = 1e3 * profiling.device_time_of(call, iters=20)
    ev_ms = _event_ms(call, 20)
    _check(0.5 < dt_ms / ev_ms < 2.0, f"device_time_of ({dt_ms} ms) near "
           f"the CUDA-event time ({ev_ms} ms)")
    timer = profiling.StepTimer()
    timer.start()
    for _ in range(5):
        timer.tick(N_ENVS, call())
    rate = timer.stop()["env_steps_per_sec"]
    with profiling.trace() as prof:
        call()
        torch.cuda.synchronize(dev)
    dev_us = sum(getattr(e, "self_device_time_total", 0.0)
                 for e in prof.key_averages() if "screen" in e.key)
    print(f"[30 profiling] K3 at {N_ENVS} envs, S={S_SCREEN} agent view: "
          f"device_time_of {dt_ms:.4f} ms (median of 20, CUDA events around "
          f"each call), CUDA events over 20 calls {ev_ms:.4f} ms per call; "
          f"StepTimer {rate:,.0f} frames/s over 5 calls; trace(): the "
          f"screen kernel's device time "
          + (f"{dev_us / 1e3:.4f} ms" if dev_us > 0 else "not measured")
          + f" | {gpu}", flush=True)


# ------------------------------------------- the trainer and the witnesses
N_PPO, T_PPO, ITERS_PPO = 8192, 16, 200  # README.md:124-127's size
N_PPO_CPU = 64                           # envs of the card-vs-CPU iteration
LR_PPO = 3e-4                            # examples/train_ppo.py's --lr
PPO_LOSS_RTOL = 1e-4
PPO_PARAM_ATOL = 0.1 * LR_PPO            # tests/test_torch_ppo.py's bar
ORACLE_POS_TOL = 2e-2                    # tests/test_parity.py:22-67
DRIFT_SEEDS, DRIFT_STEPS = list(range(1, 13)), 120   # tests/test_drift.py


def _k1_plain_step(cfg, planes, actions, ocfg, label) -> None:
    """One K1 step (multi_step_raw) and its plain version on the card, from
    copies of the same planes and actions: every plane, the RAM frame and
    the (mass, alive) rows bit-equal."""
    from agarcl_tpu_torch.ops import fused_tick as FT
    names = {i: f for f, idx in FT.PLANE_INDEX.items() for i in idx}
    pk, ok, ik = FT.multi_step_raw(cfg, [p.clone() for p in planes],
                                   actions, 1, ocfg)
    pp, op, ip = FT.multi_step_raw_plain(cfg, [p.clone() for p in planes],
                                         actions, 1, ocfg)
    bad = sorted({names[i] for i, (a, b) in enumerate(zip(pk, pp))
                  if not torch.equal(a, b)})
    _check(not bad, f"{label}: K1's planes bit-equal to its plain "
           f"version's (differ: {bad})")
    _check(torch.equal(ok, op) and torch.equal(ik, ip), f"{label}: K1's "
           f"RAM frame and info rows bit-equal to its plain version's")


def _k1_plain_env_steps(cfg, seeds, dev, label) -> None:
    """5 VecEnv.step calls from env_reset(seeds) on K1 (backend
    "cuda") and on the plain engine on the card (backend "torch"), with
    random actions (splits and feeds among them): every state field, the
    rewards and the dones bit-equal after each step."""
    from agarcl_tpu_torch.env import env_reset
    from agarcl_tpu_torch.state import STATE_FIELDS
    from agarcl_tpu_torch.vec import VecEnv
    n = len(seeds)
    sk = sp = env_reset(cfg, torch.tensor(seeds, dtype=torch.int64,
                                          device=dev))
    acts = _random_actions(n, dev, cfg.num_agents)
    env_k, env_p = (VecEnv(cfg, n, "none", backend=b, device=dev)
                    for b in ("cuda", "torch"))
    for t in range(5):
        sk, _, rk, dk = env_k.step(sk, acts)
        sp, _, rp, dp = env_p.step(sp, acts)
        bad = [f for f in STATE_FIELDS
               if not torch.equal(getattr(sk, f), getattr(sp, f))]
        _check(not bad and torch.equal(rk, rp) and torch.equal(dk, dp),
               f"{label}: step {t + 1} on K1 bit-equal to the plain engine "
               f"(fields differ: {bad})")


def _ppo_actions(TP, policy, obs, generator):
    """The rollout's actions for obs (N, A, R) (train_ppo.make_train):
    sample_action on agent 0 with the generator's next noise draw, act
    0."""
    n = obs.shape[0]
    noise = torch.randn((n, 2), generator=generator, device=obs.device)
    with torch.no_grad():
        act = TP.sample_action(policy, obs[:, 0], noise)[0]
    zeros = torch.zeros((n, 1), device=obs.device)
    return torch.cat([act, zeros], dim=-1)[:, None, :]


def _ppo_card_vs_cpu(TP, dev):
    """One train_iter from the same parameters, states and noise on the
    card (K1) and on the CPU (the plain engine) at N_PPO_CPU envs. Returns
    (loss, |loss diff| / |loss|, max |param diff|)."""
    from agarcl_tpu_torch.obs.ram import RamObsConfig
    cfg, n = TP.task_config(), N_PPO_CPU
    init_c, train_c, reset_c = TP.make_train(
        cfg, RamObsConfig(), n, T_PPO, LR_PPO, device=dev,
        generator=torch.Generator(dev).manual_seed(0))
    init_p, train_p, reset_p = TP.make_train(
        cfg, RamObsConfig(), n, T_PPO, LR_PPO, device="cpu")
    pol_c, opt_c = init_c()
    pol_p, opt_p = init_p()
    pol_p.load_state_dict({k: v.cpu() for k, v in
                           pol_c.state_dict().items()})
    noise = torch.randn((T_PPO, n, 2),
                        generator=torch.Generator().manual_seed(1))
    res_c, obs_c = reset_c(torch.arange(n))
    res_p, obs_p = reset_p(torch.arange(n))
    _, _, loss_c, mr_c = train_c(pol_c, opt_c, res_c, obs_c, noise)
    _, _, loss_p, mr_p = train_p(pol_p, opt_p, res_p, obs_p, noise)
    loss_c, loss_p = loss_c.item(), loss_p.item()
    rel = abs(loss_c - loss_p) / abs(loss_p)
    _check(rel <= PPO_LOSS_RTOL, f"PPO card vs CPU: loss {loss_c} vs "
           f"{loss_p} within rtol {PPO_LOSS_RTOL}")
    _check(mr_c.item() == mr_p.item(), f"PPO card vs CPU: mean reward "
           f"{mr_c.item()} vs {mr_p.item()}")
    perr = max((a.detach().cpu() - b.detach()).abs().max().item()
               for a, b in zip(pol_c.parameters(), pol_p.parameters()))
    _check(perr <= PPO_PARAM_ATOL, f"PPO card vs CPU: parameters within "
           f"{PPO_PARAM_ATOL} ({perr})")
    return loss_p, rel, perr


def _ppo_run(TP, dev, lr: float):
    """ITERS_PPO train_iter calls at N_PPO envs from per-env seeds
    0..N-1 and a device generator seeded 0. Returns (policy, optimizer,
    train_iter, resident state, obs, losses (iters,), mean rewards
    (iters,), per-iteration CUDA events (start, update start, end), host
    seconds of iterations 5 on, host ms to issue each iteration)."""
    from agarcl_tpu_torch.obs.ram import RamObsConfig
    init, train_iter, reset = TP.make_train(
        TP.task_config(), RamObsConfig(), N_PPO, T_PPO, lr, device=dev,
        generator=torch.Generator(dev).manual_seed(0))
    policy, opt = init()
    res, obs = reset(torch.arange(N_PPO))
    marks, orig = [], TP.ppo_loss

    def marked(*a, **kw):               # the update starts here
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        return orig(*a, **kw)

    losses, rewards, spans, issue = [], [], [], []
    TP.ppo_loss = marked
    try:
        for it in range(ITERS_PPO):
            if it == 5:
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
            e0, e1 = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            e0.record()
            h0 = time.perf_counter()
            res, obs, loss, mr = train_iter(policy, opt, res, obs)
            issue.append(1e3 * (time.perf_counter() - h0))
            e1.record()
            _check(len(marks) == it + 1, "PPO: the update's event recorded "
                   "once an iteration (train_iter calls ppo_loss)")
            spans.append((e0, marks[-1], e1))
            losses.append(loss)
            rewards.append(mr)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        TP.ppo_loss = orig
    return (policy, opt, train_iter, res, obs, torch.stack(losses).cpu(),
            torch.stack(rewards).cpu(), spans, wall, issue)


def _phase31(dev, gpu) -> dict:
    """PPO (agarcl_tpu_torch/train_ppo.py) at 8192 envs x 16 steps x 200
    iterations in the example's task: K1 once a rollout step, K2 once at
    reset; finite losses; it learns: its mean reward per step over the 200
    iterations above that of the same run with lr 0 (the initial policy,
    same seeds and noise). The example's closing line (first 5 against
    last 5 iterations) is printed, not held: the envs are never reset, the
    agents grow and slow down, and the reward per step falls late in the
    run for the example itself too. One iteration equal on the card and
    the CPU at 64 envs; the rate, the split of an iteration between
    rollout and update (CUDA events), K1's share of the rollout and the
    device busy share; the CLI on the card."""
    from agarcl_tpu_torch import train_ppo as TP
    from agarcl_tpu_torch.obs.ram import RamObsConfig
    from agarcl_tpu_torch.ops import fused_tick as FT
    _check(not torch.backends.cuda.matmul.allow_tf32,
           "TF32 off for the policy's products")
    loss_ref, loss_rel, perr = _ppo_card_vs_cpu(TP, dev)
    cfg, n = TP.task_config(), N_PPO
    # the main path's first K1 launch (its policy, reset and noise draw)
    # against the plain version
    gen = torch.Generator(dev).manual_seed(0)
    init, _, reset = TP.make_train(cfg, RamObsConfig(), n, T_PPO, LR_PPO,
                                   device=dev, generator=gen)
    pol0, _ = init()
    res0, obs0 = reset(torch.arange(n))
    _k1_plain_step(cfg, res0.raw, _ppo_actions(TP, pol0, obs0, gen),
                   RamObsConfig(), "PPO: the first rollout step")
    del pol0, res0, obs0
    _zero_counts()
    (policy, opt, train_iter, res, obs, losses, rewards, spans, wall,
     issue) = _ppo_run(TP, dev, LR_PPO)
    c = _counts()
    _check(c["k1"] == ITERS_PPO * T_PPO and c["k2"] == 1
           and c["plain"] == 0, f"PPO: K1 once a rollout step, K2 once at "
           f"reset, no plain version ({c})")
    _check(bool(torch.isfinite(losses).all()), "PPO: a finite loss every "
           "iteration")
    _k1_plain_step(cfg, res.raw, _ppo_actions(
        TP, policy, obs, torch.Generator(dev).manual_seed(2)),
        RamObsConfig(), f"PPO: a rollout step after {ITERS_PPO} iterations")
    frozen = _ppo_run(TP, dev, 0.0)[6]
    trained_mean, frozen_mean = rewards.mean().item(), frozen.mean().item()
    _check(trained_mean > frozen_mean, f"PPO learns: mean reward per step "
           f"over {ITERS_PPO} iterations ({trained_mean}) above the "
           f"initial policy's ({frozen_mean})")
    early, late = rewards[:5].mean().item(), rewards[-5:].mean().item()
    peak = max(rewards[i:i + 5].mean().item()
               for i in range(ITERS_PPO - 4))
    rate = (ITERS_PPO - 5) * n * T_PPO / wall
    roll = statistics.median(a.elapsed_time(b) for a, b, _ in spans[5:])
    upd = statistics.median(b.elapsed_time(e) for _, b, e in spans[5:])
    host = statistics.median(issue[5:])
    # K1 alone at one rollout step of this config and size (CUDA events)
    planes = [p.clone() for p in res.raw]
    acts = _random_actions(n, dev)
    acts[..., 2] = 0                    # the policy never splits or feeds
    k1_ms = _event_ms(lambda: FT.multi_step_raw(cfg, planes, acts, 1,
                                                RamObsConfig()), 20)
    prof = _device_profile(lambda: train_iter(policy, opt, res, obs), dev)
    busy = ("not measured (the profiler saw no device time)" if prof is None
            else f"{100 * prof[0]:.1f}%")
    with contextlib.redirect_stdout(io.StringIO()) as cli:
        cli_early, cli_late = TP.main(["--envs", str(n), "--iters", "10"])
    _check(cli.getvalue().splitlines()[-1].startswith(
        "reward/step improved:") and math.isfinite(cli_late),
           "python -m agarcl_tpu_torch.train_ppo on the card")
    print(f"[31 PPO] train_ppo at {n} envs x {T_PPO} steps x {ITERS_PPO} "
          f"iterations (mode 3, arena 60, 200 pellets): K1 {c['k1']}x, K2 "
          f"{c['k2']}x, plain 0; K1 bit-equal to its plain version on the "
          f"first rollout step and on a step after the run (planes, RAM "
          f"frame, info rows); losses finite; mean reward per step over "
          f"the run {trained_mean:.4f} against {frozen_mean:.4f} with lr 0; "
          f"{early:.4f} (first 5) -> {late:.4f} (last 5), best 5 "
          f"{peak:.4f}; "
          f"{rate:,.0f} env-steps/s over iterations 5-{ITERS_PPO - 1} (host "
          f"clock, synchronized); an iteration {roll + upd:.3f} ms = rollout "
          f"{roll:.3f} + update {upd:.3f} (CUDA events, medians), the host "
          f"{host:.3f} ms to issue it (no synchronisation inside); K1 "
          f"{k1_ms:.4f} ms per step alone, {100 * T_PPO * k1_ms / roll:.1f}% "
          f"of the rollout; device busy {busy} of one iteration by "
          f"torch.profiler; at {N_PPO_CPU} envs one iteration on the card "
          f"and on the CPU: loss {loss_ref:.6f}, relative diff "
          f"{loss_rel:.3g} (rtol {PPO_LOSS_RTOL}), max |param diff| "
          f"{perr:.3g} (bar {PPO_PARAM_ATOL:.1e} = 0.1 lr), mean reward "
          f"equal; the CLI at {n} envs x 10 iterations: {cli_early:.4f} -> "
          f"{cli_late:.4f} | {gpu}", flush=True)
    return {"counts": c, "env_steps_per_s": rate, "rollout_ms": roll,
            "update_ms": upd, "issue_ms": host, "k1_step_ms": k1_ms,
            "k1_share_of_rollout": T_PPO * k1_ms / roll,
            "busy_share": None if prof is None else prof[0],
            "mean_reward": trained_mean, "mean_reward_lr0": frozen_mean,
            "early": early, "late": late, "best5": peak}


def _oracle_state_err(s, i, o, label, pos_tol) -> float:
    """tests/test_parity.py::compare_states for env i of a GameState on the
    card against an OracleEnv state; returns the max live cell position
    error."""
    alive = s.cell_alive[i].cpu().numpy()
    eq = np.array_equal
    _check(eq(alive, o["cell_alive"].astype(bool))
           and eq(s.cell_mass[i].cpu().numpy() * alive,
                  o["cell_mass"] * o["cell_alive"])
           and eq(s.pellet_alive[i].cpu().numpy(), o["pellet_alive"])
           and eq(s.virus_alive[i].cpu().numpy(),
                  o["virus_alive"].astype(bool))
           and eq(s.food_eaten[i].cpu().numpy(), o["food_eaten"]),
           f"{label}: integer fields equal the oracle's")
    if not alive.any():
        return 0.0
    err = float(np.abs(s.cell_pos[i].cpu().numpy()[alive]
                       - o["cell_pos"][alive]).max())
    _check(err < pos_tol, f"{label}: cell_pos within {pos_tol} ({err})")
    return err


ORACLE_RUNS = (  # (label, EnvConfig kwargs, seeds, steps, policy, pos_tol)
    ("PCFG random walk", dict(num_agents=1, ticks_per_step=4, arena_size=100,
                              num_pellets=50, num_viruses=3, mode=3),
     (0, 1, 2), 25, "walk", 2e-2),
    ("PCFG splits and feeds", dict(num_agents=1, ticks_per_step=4,
                                   arena_size=100, num_pellets=50,
                                   num_viruses=3, mode=3),
     (7,), 25, "splits_feeds", 2e-2),
    ("DUEL", dict(num_agents=1, ticks_per_step=4, arena_size=100,
                  num_pellets=50, num_viruses=2, mode=7), (11,), 20, "walk",
     2e-2),
    ("mode 0 full game", dict(num_agents=1, ticks_per_step=4, arena_size=100,
                              num_pellets=50, num_viruses=2, num_bots=4,
                              mode=0), (5,), 20, "walk", 5e-2),
)


def _phase32(dev, gpu) -> dict:
    """K1 (VecEnv(backend="cuda"), one env per seed) against the C++
    oracle through the port's binding (agarcl_tpu_torch/oracle.py) on
    tests/test_parity.py's scenarios and seeds, at its bars: integer
    fields exact, cell_pos within 2e-2 (5e-2 in mode 0), rewards within
    1e-3, dones equal, every step."""
    from agarcl_tpu_torch import EnvConfig
    from agarcl_tpu_torch import oracle as TO
    from agarcl_tpu_torch.env import env_reset
    from agarcl_tpu_torch.vec import VecEnv
    t0 = time.perf_counter()
    TO.build()
    build_s = time.perf_counter() - t0
    for label, kw, seeds, *_ in ORACLE_RUNS:
        _k1_plain_env_steps(EnvConfig(**kw), list(seeds), dev, label)
    _zero_counts()
    out = []
    for label, kw, seeds, steps, policy, tol in ORACLE_RUNS:
        cfg = EnvConfig(**kw)
        env = VecEnv(cfg, len(seeds), "none", device=dev)
        s = env_reset(cfg, torch.tensor(seeds, dtype=torch.int64,
                                        device=dev))
        oes = [TO.OracleEnv(cfg) for _ in seeds]
        for oe, seed in zip(oes, seeds):
            oe.reset(seed)
        rngs = [np.random.default_rng(seed) for seed in seeds]
        err = max(_oracle_state_err(s, i, oe.get_state(), f"{label} reset",
                                    tol) for i, oe in enumerate(oes))
        for t in range(steps):
            acts = []
            for rng in rngs:
                act = 0.0
                if policy == "splits_feeds":
                    act = 2.0 if t % 7 == 3 else (1.0 if t % 7 == 5 else 0.0)
                acts.append(np.concatenate([rng.uniform(-1, 1, (1, 2)),
                                            np.full((1, 1), act)], axis=1))
            acts = np.stack(acts).astype(np.float32)
            s, _, r, d = env.step(s, torch.from_numpy(acts).to(dev))
            r, d = r.cpu().numpy(), d.cpu().numpy()
            for i, oe in enumerate(oes):
                orew, od = oe.step(acts[i])
                lb = f"{label} seed {seeds[i]} step {t}"
                err = max(err, _oracle_state_err(s, i, oe.get_state(), lb,
                                                 tol))
                _check(np.abs(r[i] - orew).max() <= 1e-3,
                       f"{lb}: rewards within 1e-3 ({r[i]} vs {orew})")
                _check(np.array_equal(d[i], od), f"{lb}: dones equal")
        out.append(f"{label} seeds {list(seeds)} x {steps} steps: max "
                   f"cell_pos err {err:.3g}")
    c = _counts()
    n_steps = sum(r[3] for r in ORACLE_RUNS)
    _check(c["k1"] == n_steps and c["plain"] == 0, f"oracle runs: K1 once "
           f"a step, no plain version ({c})")
    print(f"[32 oracle] each configuration's first 5 steps on K1 bit-equal "
          f"to the plain engine on the card; K1 against the C++ oracle "
          f"(agarcl_tpu_torch/oracle.py, built in {build_s:.2f} s): "
          + "; ".join(out)
          + f"; integer fields, rewards (1e-3) and dones equal every step; "
          f"K1 {c['k1']}x | {gpu}", flush=True)
    return {"counts": c}


def _phase33(dev, gpu) -> dict:
    """tests/test_drift.py's three scenarios with the port's run_ours on
    the card (K1) against the reference engine (drift/libref.so) at that
    file's bars; then the quick scenario report through the port's CLI
    into chiprun_out/DRIFT_torch.md, timed."""
    from agarcl_tpu_torch import drift as TD
    from agarcl_tpu_torch.env import env_reset
    from agarcl_tpu_torch.ops import fused_tick as FT
    crit = 1.63 * np.sqrt(2 / len(DRIFT_SEEDS))
    seeds, steps = DRIFT_SEEDS, DRIFT_STEPS
    for title, _, kw, _, _ in TD.SCENARIOS:
        _k1_plain_env_steps(TD.scenario_config(**kw), seeds, dev, title)
    # the recombine probe's one-tick calls: a split, then ticks without
    # actions, K1 against its plain version
    mcfg = TD.MERGE_CFG
    planes = FT.to_kernel_arrays(env_reset(mcfg, torch.tensor(
        [3], dtype=torch.int64, device=dev)))
    split = torch.tensor([[[0.5, 0.0, 2.0]]], device=dev)
    for t in range(8):
        a = split if t == 0 else None
        pk = FT.engine_tick_raw(mcfg, [p.clone() for p in planes], 1, None,
                                a)[0]
        planes = FT.engine_tick_raw_plain(mcfg, planes, 1, None, a)[0]
        _check(all(torch.equal(x, y) for x, y in zip(pk, planes)),
               f"recombine probe tick {t + 1}: K1 bit-equal to its plain "
               f"version")
    _zero_counts()
    t0 = time.perf_counter()
    rows = {}
    for policy, kw in (
            ("chase", dict(mode=4, num_pellets=200, num_viruses=2,
                           arena=100)),
            ("virusfeed", dict(mode=4, num_pellets=300, num_viruses=6,
                               arena=80)),
            ("selffeed", dict(mode=4, num_pellets=200, num_viruses=2,
                              arena=100))):
        ref = TD.run_reference(seeds, steps, policy=policy, **kw)
        ours = TD.run_ours(seeds, steps, policy=policy, device=dev, **kw)
        rows[policy] = TD.compare(ref, ours, steps)
    t_runs = time.perf_counter() - t0
    c = _counts()
    _check(c["k1"] == 3 * steps and c["plain"] == 0,
           f"drift runs: K1 once a step, no plain version ({c})")
    ch = rows["chase"]
    for cp in (steps // 4 + 1, steps // 2 + 1, steps):
        r, o = ch[f"mean_mass@{cp}"]
        _check(abs(o - r) / r < 0.10, f"chase mean mass @{cp}: {o} vs {r}")
    _check(ch["final_mass_ks"] < crit, f"chase final-mass KS "
           f"{ch['final_mass_ks']} < {crit}")
    r, o = ch["mean_food_eaten"]
    _check(abs(o - r) / r < 0.10, f"chase food eaten {o} vs {r}")
    r, o = ch["mean_pellets"]
    _check(abs(o - r) / r < 0.05, f"chase pellets {o} vs {r}")
    r, o = rows["virusfeed"]["mean_virus_traj"]
    _check(abs(o - r) / r < 0.05, f"virusfeed mean viruses {o} vs {r}")
    r, o = rows["virusfeed"]["max_virus_traj"]
    _check(abs(o - r) <= 1, f"virusfeed max viruses {o} vs {r}")
    r, o = rows["selffeed"][f"mean_mass@{steps}"]
    _check(abs(o - r) / r < 0.10, f"selffeed mean mass {o} vs {r}")
    r, o = rows["selffeed"]["mean_food_traj"]
    _check(abs(o - r) < 1.0, f"selffeed mean foods {o} vs {r}")
    path = Path(__file__).resolve().parent / "chiprun_out" / "DRIFT_torch.md"
    path.parent.mkdir(exist_ok=True)
    _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as cli:
        TD.main(["--report", str(path), "--quick"])
    t_report = time.perf_counter() - t0
    rc = _counts()
    _check(path.stat().st_size > 0 and rc["k1"] > 0 and rc["plain"] == 0,
           f"drift report written through K1 ({rc})")
    summ = "; ".join(ln.strip() for ln in cli.getvalue().splitlines()
                     if "KS" in ln)
    print(f"[33 drift] the {len(TD.SCENARIOS)} scenarios' configurations "
          f"(5 steps of {len(seeds)} envs) and the recombine probe (8 "
          f"one-tick calls) on K1 bit-equal to the plain engine on the card;"
          f" {len(seeds)} seeds x {steps} steps, run_ours on the "
          f"card against the reference engine (drift/libref.so) in "
          f"{t_runs:.1f} s: chase mean mass @{steps} "
          f"{ch[f'mean_mass@{steps}'][1]:.2f} vs "
          f"{ch[f'mean_mass@{steps}'][0]:.2f}, KS {ch['final_mass_ks']:.3f} "
          f"(crit {crit:.3f}); virusfeed mean viruses "
          f"{rows['virusfeed']['mean_virus_traj'][1]:.3f} vs "
          f"{rows['virusfeed']['mean_virus_traj'][0]:.3f}; selffeed mean "
          f"foods {rows['selffeed']['mean_food_traj'][1]:.3f} vs "
          f"{rows['selffeed']['mean_food_traj'][0]:.3f}: tests/test_drift.py"
          f"'s bars hold; K1 {c['k1']}x. python -m agarcl_tpu_torch.drift "
          f"--report {path.name} --quick in {t_report:.1f} s (K1 "
          f"{rc['k1']}x, {rc['k1_tick']} of them one-tick calls): {summ} "
          f"| {gpu}", flush=True)
    return {"counts": c, "report_counts": rc, "report_s": t_report}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 2
    from agarcl_tpu_torch import EnvConfig
    from agarcl_tpu_torch.env import env_reset, reset_seeds
    from agarcl_tpu_torch.obs.grid import GridObsConfig
    from agarcl_tpu_torch.obs.ram import RamObsConfig, ram_frame
    from agarcl_tpu_torch.obs.screen import ScreenObsConfig
    from agarcl_tpu_torch.ops import _build, fused_obs, fused_step
    from agarcl_tpu_torch.ops import fused_grid as FG
    from agarcl_tpu_torch.ops import fused_screen as FS
    from agarcl_tpu_torch.ops import fused_tick as FT
    from agarcl_tpu_torch.vec import VecEnv

    dev = torch.device("cuda", 0)
    gpu = _gpu_line()
    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=350,
                    num_pellets=500, num_viruses=10, reward_type=True,
                    mode=4)
    ocfg = RamObsConfig(num_pellets=32, num_viruses=8)
    DUEL = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=350,
                     num_pellets=500, num_viruses=10, mode=7)
    N, k = N_ENVS, K_STEPS

    # --- 1. toolchain ------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    load_s = time.perf_counter() - t0
    built = (f"built in {_build.build_seconds:.2f} s"
             if _build.build_seconds is not None
             else f"loaded a cached build in {load_s:.2f} s")
    nvcc = _build.nvcc_version(_build._nvcc()).splitlines()[-1]
    print(f"[1 toolchain] gpu: {gpu} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {nvcc} | kernels {built} | ptxas: "
          f"{_ptxas_summary(_build.build_log)}", flush=True)

    acts = _random_actions(N, dev)

    # --- 2. K2 against ram_frame --------------------------------------------
    plain_env = VecEnv(cfg, N, "ram", backend="torch", device=dev)
    s0, _ = plain_env.reset(0)
    s2, _, _, _ = plain_env.multi_step(s0, acts, 3)
    planes2 = FT.to_kernel_arrays(s2)
    got = fused_obs.fused_ram_obs(cfg, ocfg, planes2)
    ref = ram_frame(cfg, ocfg, s2)
    torch.cuda.synchronize(dev)
    k2_err = _max_err(got, ref)
    _check_same([("K2 against ram_frame", got, ref)], "phase 2")
    k2_ms = 1e3 * _timed(lambda: fused_obs.fused_ram_obs(cfg, ocfg, planes2),
                         dev, 20)
    k2_plain_ms = 1e3 * _timed(lambda: ram_frame(cfg, ocfg, s2), dev, 5)
    print(f"[2 K2 ram_frame] {N} envs after 3 plain steps: K2 bit-equal to "
          f"ram_frame (max |K2 - ram_frame| = {k2_err:.3g}) | K2 "
          f"{k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms | {gpu}", flush=True)

    # --- 3. K1 against its plain version ------------------------------------
    cuda_env = VecEnv(cfg, N, "ram", backend="cuda", device=dev)

    def both(res_k, res_p, n_steps):
        out_k = fused_step.multi_step_resident(cfg, res_k, acts, n_steps,
                                               ocfg)
        out_p = fused_step.multi_step_resident(
            cfg, res_p, acts, n_steps, ocfg, plain=True)
        return out_k, out_p

    s0, _ = cuda_env.reset(0)
    out1_k, out1_p = both(fused_step.to_resident(cfg, s0),
                          fused_step.to_resident(cfg, s0), 1)
    e1 = _compare_runs(cfg, out1_k, out1_p, "after 1 step")
    out8_k, out8_p = both(out1_k[0], out1_p[0], 7)
    e8 = _compare_runs(cfg, out8_k, out8_p, "after 8 steps")
    del out1_k, out1_p, out8_k, out8_p
    # the main path's launch: one k=40 call from reset(0); its plain call
    # is also phase 5's plain timing (warm from the calls above)
    s0, _ = cuda_env.reset(0)
    res_k, res_p = (fused_step.to_resident(cfg, s0),
                    fused_step.to_resident(cfg, s0))
    out40_k = fused_step.multi_step_resident(cfg, res_k, acts, k, ocfg)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out40_p = fused_step.multi_step_resident(cfg, res_p, acts, k, ocfg,
                                             plain=True)
    torch.cuda.synchronize(dev)
    out40_p[2].sum().item()
    t_plain = time.perf_counter() - t0
    e40 = _compare_runs(cfg, out40_k, out40_p, f"after {k} steps")
    del out40_k, out40_p
    k1_err = max(e1, e8, e40)

    print(f"[3 K1 multi-step tick] {N} envs, reset(0), random actions: "
          f"after 1 step, after 8 steps and after one k={k} call "
          f"{BIT_EQUAL}", flush=True)

    # --- 4. the main path goes through the kernels ---------------------------
    FT.launches = FT.plain_calls = 0
    fused_obs.launches = fused_obs.plain_calls = 0
    states, obs0 = cuda_env.reset(0)
    res = cuda_env.make_resident(states)
    res, obs, rew, done = cuda_env.multi_step(res, acts, k)
    torch.cuda.synchronize(dev)
    k1_launches, k2_launches = FT.launches, fused_obs.launches
    plain_used = FT.plain_calls + fused_obs.plain_calls
    _check(k1_launches > 0 and k2_launches > 0,
           f"both kernels launched (K1 {k1_launches}, K2 {k2_launches})")
    _check(plain_used == 0, f"plain version not called ({plain_used})")
    R = obs.shape[-1]
    _check(tuple(obs0.shape) == (N, 1, R) and R == 231, "reset obs shape")
    _check(tuple(obs.shape) == (k, N, 1, 1, R), "multi_step obs shape")
    _check(tuple(rew.shape) == (k, N, 1) and tuple(done.shape) == (k, N, 1),
           "rewards / dones shapes")
    _check(bool(torch.isfinite(obs).all()) and bool(torch.isfinite(rew).all()),
           "finite obs and rewards")
    final = cuda_env.materialize(res)
    mass = final.player_mass()
    _check(bool((mass >= 25).all()) and bool((final.ticks == 4 * k).all()),
           "every env alive at >= 25 mass after 160 ticks")
    print(f"[4 main path] reset + make_resident + multi_step(k={k}): K1 "
          f"launches {k1_launches}, K2 launches {k2_launches}, plain calls "
          f"{plain_used}; obs {tuple(obs.shape)} finite, mean reward per "
          f"step {rew.mean().item():.4f}, mean final mass "
          f"{mass.float().mean().item():.2f}", flush=True)
    del obs, rew, done, res

    # --- 5. throughput (bench.py method) -------------------------------------
    s, _ = cuda_env.reset(0)
    r = cuda_env.make_resident(s)
    r, _, rw, _ = cuda_env.multi_step(r, acts, k)          # warm
    rw.sum().item()
    times = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(4):
            r, _, rw, _ = cuda_env.multi_step(r, acts, k)
        torch.cuda.synchronize(dev)
        rw.sum().item()
        times.append((time.perf_counter() - t0) / 4)
    t_kernel = statistics.median(times)
    sps_k = N * k / t_kernel
    sps_p = N * k / t_plain
    print(f"[5 throughput] {N} envs, multi_step(k={k}): kernel "
          f"{sps_k:,.0f} env-steps/s ({1e3 * t_kernel:.2f} ms/call, median "
          f"of 3 runs x 4 calls); plain torch backend {sps_p:,.0f} "
          f"env-steps/s ({1e3 * t_plain:.2f} ms/call, 1 call: phase 3's "
          f"k={k} call, after warm calls) | {gpu}", flush=True)
    del r, rw

    # --- 6. K1 alone: frame share and launch-shape scaling ------------------
    shapes = {}
    for label, c in (("1 player", cfg), ("2 players", _rosters()[3][1]),
                     ("9 players", _rosters()[4][1])):
        shapes[label] = FT.launch_shape(c, N)
    print(f"[6 K1 launch shape] {N} envs, a warp per env: "
          + "; ".join(f"{label}: {sh['blocks']} blocks of "
                      f"{sh['envs_per_block']} envs ({32 * sh['envs_per_block']}"
                      f" threads), {sh['smem_bytes']} bytes of dynamic shared "
                      f"memory ({sh['env_bytes']} an env), "
                      f"{sh['blocks_per_sm']} resident blocks per SM "
                      f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)"
                      for label, sh in shapes.items())
          + f" | {gpu}", flush=True)
    _check(shapes["1 player"]["blocks_per_sm"] >= 2,
           "at least 2 resident K1 blocks per SM at 1 player")
    for n in PROBE_ENVS:
        with_ms = _k1_event_ms(cfg, n, ocfg, k, dev)
        without_ms = _k1_event_ms(cfg, n, None, k, dev)
        print(f"[6 K1 alone] {n} envs, k={k}, CUDA events, median of 3 "
              f"calls after 1 warm: with frame {with_ms:.2f} ms "
              f"({n * k / with_ms * 1e3:,.0f} env-steps/s), without frame "
              f"{without_ms:.2f} ms, frame share "
              f"{100.0 * (1 - without_ms / with_ms):.1f}% | {gpu}",
              flush=True)

    # --- 7. K3 against its plain version ----------------------------------
    scr = ScreenObsConfig(S_SCREEN, agent_view=True)
    k3_states = [("played", cfg, s2),
                 ("heavy", cfg, _heavy_state(cfg, N, dev)),
                 ("two players", DUEL, _two_player_state(DUEL, s2))]
    k3_err = 0
    for label, c, st in k3_states:
        planes = FT.to_kernel_arrays(st)
        for oc in (scr, ScreenObsConfig(84, agent_view=False)):
            got = FS.fused_screen_frame(c, oc, planes)
            ref = FS.frame_plain(c, oc, planes)
            bad = int((got != ref).any(-1).sum())
            k3_err = max(k3_err, (got.int() - ref.int()).abs().max().item())
            colours = torch.unique(ref.reshape(-1, ref.shape[-1]),
                                   dim=0).shape[0]
            _check(bad == 0, f"K3 vs plain, {label}, S={oc.screen_len}: "
                   f"{bad} pixels differ")
            print(f"[7 K3 screen] {label}, {N} envs, S={oc.screen_len} "
                  f"{'agent view' if oc.agent_view else 'natural RGB'}: 0 "
                  f"of {N * oc.screen_len ** 2} pixels differ from the "
                  f"plain frame ({colours} colours drawn)", flush=True)
        if label == "two players":
            _check(bool((ref[..., 1] == 255).any()), "other player drawn")
    big = ScreenObsConfig(512, agent_view=False)
    sub = [p[:, :1024].contiguous() for p in FT.to_kernel_arrays(s2)]
    got, ref = FS.fused_screen_frame(cfg, big, sub), FS.frame_plain(cfg, big,
                                                                     sub)
    bad = int((got != ref).any(-1).sum())
    _check(bad == 0, f"K3 vs plain at S=512: {bad} pixels differ")
    print(f"[7 K3 screen] played, 1024 envs, S=512 natural RGB (above the "
          f"448 of the byte class map; MAX_SCREEN {FS.MAX_SCREEN}): 0 of "
          f"{1024 * 512 ** 2} pixels differ from the plain frame", flush=True)
    del got, ref, sub
    planes2 = FT.to_kernel_arrays(s2)
    k3_ms = _event_ms(lambda: FS.fused_screen_frame(cfg, scr, planes2), 10)
    k3_plain_ms = 1e3 * _timed(lambda: FS.frame_plain(cfg, scr, planes2),
                               dev, 2)
    k3_bytes, k3_ops = _screen_work(cfg, scr, planes2)
    k3_bound = _bound_ms(k3_bytes, k3_ops)

    # --- 8. the screen main path ---------------------------------------------
    senv = VecEnv(cfg, N, "screen", obs_config=scr)
    penv = VecEnv(cfg, N, "screen", backend="torch", device=dev,
                  obs_config=scr)
    _zero_counts()
    st0, sobs0 = senv.reset(0)
    st, sobs, srew, sdone = senv.multi_step(st0, acts, K_SCREEN)
    torch.cuda.synchronize(dev)
    s_k1, s_k3, s_plain = FT.tick_launches, FS.launches, _plain_count()
    _check(s_k1 == FT.launches == K_SCREEN and s_k3 == K_SCREEN + 1
           and s_plain == 0,
           f"screen path launches K1 {K_SCREEN}x through engine_tick_raw, "
           f"K3 {K_SCREEN + 1}x, plain 0x (K1 {FT.launches}, through "
           f"engine_tick_raw {s_k1}, K3 {s_k3}, plain {s_plain})")
    _check(tuple(sobs0.shape) == (N, 1, S_SCREEN, S_SCREEN, 4),
           "screen reset obs shape")
    _check(tuple(sobs.shape) == (K_SCREEN, N, 1, 1, S_SCREEN, S_SCREEN, 4)
           and sobs.dtype == torch.uint8, "screen multi_step obs shape")
    _check(bool(torch.isfinite(srew).all()), "finite screen rewards")
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    pst, pobs, prew, pdone = penv.multi_step(st0, acts, K_SCREEN)
    torch.cuda.synchronize(dev)
    prew.sum().item()
    t_splain = time.perf_counter() - t0
    _check_same_states(st, pst, "screen path")
    _check_same([("frames", sobs, pobs), ("rewards", srew, prew),
                 ("dones", sdone, pdone)], "screen path")
    print(f"[8 screen path] reset + multi_step(k={K_SCREEN}) at {N} envs, "
          f"S={S_SCREEN} agent view: K1 launches {s_k1}, K3 launches "
          f"{s_k3}, plain calls {s_plain}; obs {tuple(sobs.shape)} uint8; "
          f"against the torch backend from the same state: state, frames, "
          f"rewards and dones bit-equal; mean reward per step "
          f"{srew.mean().item():.4f}", flush=True)
    del sobs, pobs, st, pst, srew, prew, sdone, pdone
    # the per-step composition (fused_env_step), with 64 dead main players
    flags = dict(obs_config=scr, auto_reset=True,
                 respawn_main_during_obs=True)
    fenv = VecEnv(cfg, N, "screen", **flags)
    fpenv = VecEnv(cfg, N, "screen", backend="torch", device=dev, **flags)
    ca = st0.cell_alive.clone()
    ca[:64] = False
    st0 = st0.replace(cell_alive=ca)
    k1_0, k3_0 = FT.launches, FS.launches
    fst, fobs, frew, fdone = fenv.multi_step(st0, acts, 2)
    _check((FT.launches - k1_0, FS.launches - k3_0) == (2, 2),
           "per-step path launches K1 and K3 once a step")
    pst, pobs, prew, pdone = fpenv.multi_step(st0, acts, 2)
    _check_same_states(fst, pst, "per-step path")
    _check_same([("frames", fobs, pobs), ("rewards", frew, prew),
                 ("dones", fdone, pdone)], "per-step path")
    _check(bool((frew[0, :64] >= 25).all()),
           "dead main players respawned in the first step (reward >= 25)")
    print(f"[8 per-step path] auto_reset + respawn_main_during_obs, 64 dead "
          f"main players, multi_step(k=2) at {N} envs: K1 and K3 once a "
          f"step; against the torch backend state, frames, rewards and "
          f"dones bit-equal", flush=True)
    del fobs, pobs, fst, pst, st0

    # --- 9. screen-path times -----------------------------------------------
    s, _ = senv.reset(0)
    s, o, rw, _ = senv.multi_step(s, acts, K_SCREEN)             # warm
    rw.sum().item()
    times = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(4):
            del o
            s, o, rw, _ = senv.multi_step(s, acts, K_SCREEN)
        torch.cuda.synchronize(dev)
        rw.sum().item()
        times.append((time.perf_counter() - t0) / 4)
    del o
    t_screen = statistics.median(times)
    nat = ScreenObsConfig(84, agent_view=False)
    k3_nat_ms = _event_ms(lambda: FS.fused_screen_frame(cfg, nat, planes2),
                          10)
    k3_nat_bound = _bound_ms(*_screen_work(cfg, nat, planes2))
    prof = _device_profile(lambda: senv.multi_step(s, acts, K_SCREEN), dev)
    k1_step_ms = _event_ms(lambda: FT.multi_step_raw(cfg, planes2, acts, 1,
                                                     None), 10)
    pl = [p.clone() for p in planes2]
    k1_tick4_ms = _event_ms(lambda: FT.engine_tick_raw(
        cfg, pl, cfg.ticks_per_step, actions=acts), 10)
    del pl
    k3_shape = FS.launch_shape(cfg, scr, N)
    k3_nat_shape = FS.launch_shape(cfg, nat, N)
    k1_step_bound = _bound_ms(*_tick_work(cfg, None, N, 1))
    print(f"[9 screen times] {N} envs, multi_step(k={K_SCREEN}), S="
          f"{S_SCREEN}: kernel {N * K_SCREEN / t_screen:,.0f} env-steps/s "
          f"({1e3 * t_screen:.2f} ms/call, median of 3 runs x 4 calls); "
          f"plain torch backend {N * K_SCREEN / t_splain:,.0f} env-steps/s "
          f"({1e3 * t_splain:.2f} ms/call, 1 call: phase 8's); K3 "
          f"{k3_ms:.3f} ms/frame (CUDA events, mean of 10), bound "
          f"{k3_bound[0]:.3f} ms by {k3_bound[1]} ({k3_bytes / 1e6:.1f} MB, "
          f"{k3_ops / 1e9:.3f} G f32 ops), {100 * k3_bound[0] / k3_ms:.1f}% "
          f"of bound; plain frame {k3_plain_ms:.2f} ms; K3 at S=84 natural "
          f"RGB {k3_nat_ms:.3f} ms/frame, bound {k3_nat_bound[0]:.3f} ms by "
          f"{k3_nat_bound[1]}, {100 * k3_nat_bound[0] / k3_nat_ms:.1f}% of "
          f"bound; K1 k=1 {k1_step_ms:.3f} ms/step, bound "
          f"{k1_step_bound[0]:.3f} ms by {k1_step_bound[1]} | {gpu}",
          flush=True)
    busy = ("not measured (the profiler saw no device time)" if prof is None
            else f"{100 * prof[0]:.1f}% of the call's wall time; largest: "
            + ", ".join(f"{k} {t:.2f} ms" for k, t in prof[1]))
    print(f"[9 screen profile] one multi_step(k={K_SCREEN}) under "
          f"torch.profiler: device busy {busy}", flush=True)
    print(f"[9 screen shape] K3 at S={S_SCREEN} agent view: "
          f"{_shape_text(k3_shape)}; at S=84 natural RGB: "
          f"{_shape_text(k3_nat_shape)}; screen call "
          + _busy_text([(K_SCREEN, k1_tick4_ms), (K_SCREEN, k3_ms)], t_screen,
                       prof)
          + f" (K1 with actions and {cfg.ticks_per_step} ticks per step, "
          f"CUDA events)", flush=True)

    # --- 10. K4 against its plain version ------------------------------------
    gcfg = GridObsConfig(grid_size=G_GRID, out_dtype="int16")
    g_cases = [("played", cfg, s2, gcfg),
               ("played", cfg, s2, GridObsConfig(grid_size=128,
                                                 out_dtype="int32")),
               ("played", cfg, s2, GridObsConfig(grid_size=32,
                                                 out_dtype="int8")),
               ("played", cfg, s2, GridObsConfig(
                   grid_size=G_GRID, out_dtype="int16", observe_pellets=False,
                   observe_others=False))]
    g_cases += [(lb, c, st, gcfg) for lb, c, st in _grid_cases(
        cfg, DUEL, s2, k3_states[1][2])]
    k4_err = 0
    for label, c, st, oc in g_cases:
        planes = FT.to_kernel_arrays(st)
        got = FG.fused_grid_frame(c, oc, planes)
        ref = FG.frame_plain(c, oc, planes)
        bad = int((got != ref).sum())
        k4_err = max(k4_err, (got.int() - ref.int()).abs().max().item())
        _check(got.dtype == ref.dtype and bad == 0,
               f"K4 vs plain, {label}, G={oc.grid_size} {oc.out_dtype}: "
               f"{bad} values differ")
        ch = ref[:, 0].int()
        note = f"max per channel {ch.amax(dim=(0, 2, 3)).tolist()}"
        if label == "two players":
            _check(bool((ch[:, 6] != ch[:, 7]).any()), "others' min < max")
        if label == "two viruses in a bin":
            _check(bool((ch[:, 3] != ch[:, 4]).any()), "virus max < total")
        if label == "own mass 40000":
            _check(int(ch[:, 5].max()) == 32767, "own mass saturates")
        print(f"[10 K4 grid] {label}, {N} envs, G={oc.grid_size} "
              f"{oc.out_dtype}, {oc.channels_per_frame} channels: 0 of "
              f"{ref.numel()} values differ from the plain frame ({note})",
              flush=True)
    del got, ref

    # --- 11. the grid main path ---------------------------------------------
    genv = VecEnv(cfg, N, "grid", obs_config=gcfg)
    gpenv = VecEnv(cfg, N, "grid", backend="torch", device=dev,
                   obs_config=gcfg)
    _zero_counts()
    st0, gobs0 = genv.reset(0)
    st, gobs, grew, gdone = genv.multi_step(st0, acts, K_SCREEN)
    torch.cuda.synchronize(dev)
    g_k1, g_k4, g_plain = FT.tick_launches, FG.launches, _plain_count()
    _check(g_k1 == FT.launches == K_SCREEN and g_k4 == K_SCREEN + 1
           and g_plain == 0,
           f"grid path launches K1 {K_SCREEN}x through engine_tick_raw, K4 "
           f"{K_SCREEN + 1}x, plain 0x (K1 {FT.launches}, through "
           f"engine_tick_raw {g_k1}, K4 {g_k4}, plain {g_plain})")
    _check(tuple(gobs0.shape) == (N, 1, 8, G_GRID, G_GRID)
           and gobs0.dtype == torch.int16, "grid reset obs shape")
    _check(tuple(gobs.shape) == (K_SCREEN, N, 1, 1, 8, G_GRID, G_GRID)
           and gobs.dtype == torch.int16, "grid multi_step obs shape")
    _check(bool(torch.isfinite(grew).all()), "finite grid rewards")
    _check(bool((gobs[:, :, 0, 0, 0] == 0).any()) and bool(
        (gobs[:, :, 0, 0, 2] > 0).any()), "grid frames see the arena and "
           "pellets")
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    pst, pobs, prew, pdone = gpenv.multi_step(st0, acts, K_SCREEN)
    torch.cuda.synchronize(dev)
    prew.sum().item()
    t_gplain = time.perf_counter() - t0
    _check_same_states(st, pst, "grid path")
    _check_same([("frames", gobs, pobs), ("rewards", grew, prew),
                 ("dones", gdone, pdone)], "grid path")
    print(f"[11 grid path] reset + multi_step(k={K_SCREEN}) at {N} envs, "
          f"G={G_GRID} int16: K1 launches {g_k1}, K4 launches {g_k4}, plain "
          f"calls {g_plain}; obs {tuple(gobs.shape)} int16; against the "
          f"torch backend from the same state: state, frames, rewards and "
          f"dones bit-equal; mean reward per step {grew.mean().item():.4f}",
          flush=True)
    del gobs, pobs, st, pst, grew, prew, gdone, pdone
    flags = dict(obs_config=gcfg, auto_reset=True,
                 respawn_main_during_obs=True)
    fenv = VecEnv(cfg, N, "grid", **flags)
    fpenv = VecEnv(cfg, N, "grid", backend="torch", device=dev, **flags)
    ca = st0.cell_alive.clone()
    ca[:64] = False
    st0 = st0.replace(cell_alive=ca)
    k1_0, k4_0 = FT.launches, FG.launches
    fst, fobs, frew, fdone = fenv.multi_step(st0, acts, 2)
    _check((FT.launches - k1_0, FG.launches - k4_0) == (2, 2),
           "per-step grid path launches K1 and K4 once a step")
    pst, pobs, prew, pdone = fpenv.multi_step(st0, acts, 2)
    _check_same_states(fst, pst, "per-step grid path")
    _check_same([("frames", fobs, pobs), ("rewards", frew, prew),
                 ("dones", fdone, pdone)], "per-step grid path")
    _check(bool((frew[0, :64] >= 25).all()),
           "dead main players respawned in the first step (reward >= 25)")
    print(f"[11 per-step grid path] auto_reset + respawn_main_during_obs, 64 "
          f"dead main players, multi_step(k=2) at {N} envs: K1 and K4 once a "
          f"step; against the torch backend state, frames, rewards and "
          f"dones bit-equal", flush=True)
    del fobs, pobs, fst, pst, st0

    # --- 12. grid-path times ----------------------------------------------
    s, _ = genv.reset(0)
    s, o, rw, _ = genv.multi_step(s, acts, K_SCREEN)             # warm
    rw.sum().item()
    times = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(4):
            del o
            s, o, rw, _ = genv.multi_step(s, acts, K_SCREEN)
        torch.cuda.synchronize(dev)
        rw.sum().item()
        times.append((time.perf_counter() - t0) / 4)
    del o
    t_grid = statistics.median(times)
    big_g = GridObsConfig(grid_size=128, out_dtype="int32")
    k4_ms = _event_ms(lambda: FG.fused_grid_frame(cfg, gcfg, planes2), 10)
    k4_big_ms = _event_ms(lambda: FG.fused_grid_frame(cfg, big_g, planes2),
                          10)
    k4_bytes, k4_ops = _grid_work(cfg, gcfg, N)
    k4_bound = _bound_ms(k4_bytes, k4_ops)
    k4_big_bound = _bound_ms(*_grid_work(cfg, big_g, N))
    k4_shape = FG.launch_shape(cfg, gcfg, N)
    k4_big_shape = FG.launch_shape(cfg, big_g, N)
    k4_plain_ms = 1e3 * _timed(lambda: FG.frame_plain(cfg, gcfg, planes2),
                               dev, 3)
    sec_plain_ms = 1e3 * _timed(lambda: FG.grid_sections(cfg, planes2), dev,
                                3)
    genv.multi_step(s, acts, K_SCREEN)[2].sum().item()   # warm allocator
    gprof = _device_profile(lambda: genv.multi_step(s, acts, K_SCREEN), dev)
    k1_plain_step_ms = 1e3 * _timed(lambda: FT.multi_step_raw_plain(
        cfg, [p.clone() for p in planes2], acts, 1, None), dev, 1)
    print(f"[12 grid times] {N} envs, multi_step(k={K_SCREEN}), G={G_GRID} "
          f"int16: kernel {N * K_SCREEN / t_grid:,.0f} env-steps/s "
          f"({1e3 * t_grid:.2f} ms/call, median of 3 runs x 4 calls); plain "
          f"torch backend {N * K_SCREEN / t_gplain:,.0f} env-steps/s "
          f"({1e3 * t_gplain:.2f} ms/call, 1 call: phase 11's); K4 "
          f"{k4_ms:.3f} ms/frame (CUDA events, mean of 10), bound "
          f"{k4_bound[0]:.3f} ms by {k4_bound[1]} ({k4_bytes / 1e6:.1f} MB), "
          f"{100 * k4_bound[0] / k4_ms:.1f}% of bound; K4 at G=128 int32 "
          f"{k4_big_ms:.3f} ms/frame, bound {k4_big_bound[0]:.3f} ms by "
          f"{k4_big_bound[1]}, {100 * k4_big_bound[0] / k4_big_ms:.1f}% of "
          f"bound; plain frame {k4_plain_ms:.2f} ms, of it the plain section "
          f"build {sec_plain_ms:.2f} ms; K1 k=1 plain version "
          f"{k1_plain_step_ms:.2f} ms/step | {gpu}", flush=True)
    gbusy = ("not measured (the profiler saw no device time)" if gprof is None
             else f"{100 * gprof[0]:.1f}% of the call's wall time; largest: "
             + ", ".join(f"{k} {t:.2f} ms" for k, t in gprof[1]))
    print(f"[12 grid profile] one multi_step(k={K_SCREEN}) under "
          f"torch.profiler: device busy {gbusy}", flush=True)
    print(f"[12 grid shape] K4 at G={G_GRID} int16: {_shape_text(k4_shape)}; "
          f"at G=128 int32: {_shape_text(k4_big_shape)}; grid call "
          + _busy_text([(K_SCREEN, k1_tick4_ms), (K_SCREEN, k4_ms)], t_grid,
                       gprof)
          + " (K1 as in phase 9)", flush=True)

    # --- 13. K1 with bots against its plain version ----------------------
    k1_mp_err = _phase13(dev, ocfg)
    k1_err = max(k1_err, k1_mp_err)

    # --- 14. the duel main paths ------------------------------------------
    rosters = _rosters()
    duel10 = rosters[3][1]
    d_k1, d_k3, t_dplain, denv = _screen_path(duel10, dev, acts, scr,
                                              "mode 10")
    for label, c, _ in rosters[:3]:
        _screen_path(c, dev, acts, scr, label)
    renv = VecEnv(duel10, N, "ram")
    _zero_counts()
    s, _ = renv.reset(0)
    r = renv.make_resident(s)
    r, robs, rrew, rdone = renv.multi_step(r, acts, k)
    torch.cuda.synchronize(dev)
    dr_k1, dr_k2, dr_plain = FT.launches, fused_obs.launches, _plain_count()
    _check(dr_k1 == 1 and dr_k2 == 1 and dr_plain == 0,
           f"duel RAM path launches K1 once, K2 once (reset), plain 0x (K1 "
           f"{dr_k1}, K2 {dr_k2}, plain {dr_plain})")
    _check(tuple(robs.shape) == (k, N, 1, 1, R + 4)
           and bool(torch.isfinite(robs).all()), "duel RAM obs shape")
    out_p = fused_step.multi_step_resident(
        duel10, fused_step.to_resident(duel10, s), acts, k, ocfg,
        plain=True)
    e_dr = _compare_runs(duel10, (r, robs, rrew, rdone), out_p,
                         f"duel RAM path after {k} steps")
    k1_err = max(k1_err, e_dr)
    print(f"[14 duel RAM path] mode 10, reset + make_resident + "
          f"multi_step(k={k}) at {N} envs: K1 launches {dr_k1}, K2 launches "
          f"{dr_k2}, plain calls {dr_plain}; obs {tuple(robs.shape)}; "
          f"against the plain version {BIT_EQUAL}; "
          f"{int(rdone.any(0).sum())} envs done within {k} steps",
          flush=True)
    del r, robs, rrew, rdone, out_p
    m0_8 = rosters[4][1]
    m8_k1 = _per_step_ram(m0_8, N_ROSTER, dev, 2, "mode 0 with 8 bots")
    m0_2a = EnvConfig(num_agents=2, ticks_per_step=4, arena_size=350,
                      num_pellets=500, num_viruses=10, num_bots=1, mode=0)
    m2_k1 = _per_step_ram(m0_2a, N_ROSTER, dev, 4,
                          "mode 0, 2 agents and 1 bot")
    sd, _, _, _ = VecEnv(duel10, N, "none", backend="torch",
                         device=dev).multi_step(s, acts, 3)
    k2_before = fused_obs.launches
    got = fused_obs.fused_ram_obs(duel10, ocfg, FT.to_kernel_arrays(sd))
    ref = ram_frame(duel10, ocfg, sd)
    k2p_err = _max_err(got, ref)
    _check(fused_obs.launches == k2_before + 1, "K2 at 2 players: 1 launch")
    _check_same([("K2 against ram_frame", got, ref)], "K2 at 2 players")
    _check(bool((ref[:, 0, -4:] != 0).any()), "the bot's row is filled")
    k2_err = max(k2_err, k2p_err)
    print(f"[14 K2 at 2 players] mode 10, {N} envs after 3 plain steps: K2 "
          f"bit-equal to ram_frame (max |K2 - ram_frame| = {k2p_err:.3g}), "
          f"the bot's per-player row filled", flush=True)
    del got, ref, sd

    # --- 15. times ---------------------------------------------------------
    s, _ = denv.reset(0)
    s, o, rw, _ = denv.multi_step(s, acts, K_SCREEN)             # warm
    rw.sum().item()
    times = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(4):
            del o
            s, o, rw, _ = denv.multi_step(s, acts, K_SCREEN)
        torch.cuda.synchronize(dev)
        rw.sum().item()
        times.append((time.perf_counter() - t0) / 4)
    del o, s
    t_duel = statistics.median(times)
    step_ms, step_bound = {}, {}
    for c in (cfg, duel10, m0_8):
        P = str(c.num_players)
        planes = FT.to_kernel_arrays(env_reset(c, reset_seeds(N, 0, dev)))
        step_ms[P] = _event_ms(lambda: FT.multi_step_raw(c, planes, acts, 1,
                                                         None), 10)
        step_bound[P] = _bound_ms(*_tick_work(c, None, N, 1))
    # phase 7's heavy, late-game state (cells of mass 400-2500 split and
    # popped beside viruses; the calls go on from it, as above)
    heavy_cells = int(k3_states[1][2].cell_alive.sum()) / N
    planes = FT.to_kernel_arrays(k3_states[1][2])
    heavy_ms = _event_ms(lambda: FT.multi_step_raw(cfg, planes, acts, 1,
                                                   None), 10)
    del planes
    s, _ = cuda_env.reset(0)
    r = cuda_env.make_resident(s)
    r, _, rw, _ = cuda_env.multi_step(r, acts, k)          # warm
    rw.sum().item()
    times = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(4):
            r, _, rw, _ = cuda_env.multi_step(r, acts, k)
        torch.cuda.synchronize(dev)
        rw.sum().item()
        times.append((time.perf_counter() - t0) / 4)
    t_ram_again = statistics.median(times)
    del r, rw
    print(f"[15 times] duel screen path (mode 10), {N} envs, "
          f"multi_step(k={K_SCREEN}), S={S_SCREEN}: kernel "
          f"{N * K_SCREEN / t_duel:,.0f} env-steps/s ({1e3 * t_duel:.2f} "
          f"ms/call, median of 3 runs x 4 calls); plain torch backend "
          f"{N * K_SCREEN / t_dplain:,.0f} env-steps/s "
          f"({1e3 * t_dplain:.2f} ms/call, 1 call: phase 14's); K1 k=1 per "
          f"step at {N} envs from reset(0) (CUDA events, mean of 10 after 1 "
          f"warm, as phase 9): "
          + "; ".join(f"{P} players {step_ms[P]:.3f} ms, bound "
                      f"{step_bound[P][0]:.4f} ms by {step_bound[P][1]}"
                      for P in step_ms)
          + f"; K1 k=1 from phase 7's heavy state ({heavy_cells:.2f} live "
          f"cells an env) {heavy_ms:.3f} ms per step"
          + f"; single-player RAM path again {1e3 * t_ram_again:.2f} ms per "
          f"k={k} call ({N * k / t_ram_again:,.0f} env-steps/s; phase 5: "
          f"{1e3 * t_kernel:.2f} ms) | {gpu}", flush=True)

    # --- 16. K3 in poly mode against its plain version --------------------
    poly = ScreenObsConfig(S_SCREEN, agent_view=True, polygon_edges=True,
                           polygon_virus="circle")
    poly84 = ScreenObsConfig(84, agent_view=False, polygon_edges=True,
                             polygon_virus="circle")
    for label, c, st in k3_states:
        planes = FT.to_kernel_arrays(st)
        for oc in (poly, poly84):
            got = FS.fused_screen_frame(c, oc, planes)
            ref = FS.frame_plain(c, oc, planes)
            bad = int((got != ref).any(-1).sum())
            k3_err = max(k3_err, (got.int() - ref.int()).abs().max().item())
            circle = FS.fused_screen_frame(c, ScreenObsConfig(
                oc.screen_len, agent_view=oc.agent_view), planes)
            fans = int((circle != ref).any(-1).sum())
            _check(bad == 0, f"K3 poly vs plain, {label}, S={oc.screen_len}"
                   f": {bad} pixels differ")
            _check(fans > 0, f"K3 poly, {label}: the fans differ from the "
                   "circles")
            print(f"[16 K3 poly] {label}, {N} envs, S={oc.screen_len} "
                  f"{'agent view' if oc.agent_view else 'natural RGB'}: 0 "
                  f"of {N * oc.screen_len ** 2} pixels differ from the "
                  f"plain frame; {fans} pixels differ from circle mode",
                  flush=True)
    del got, ref, circle, planes

    # --- 17. the polygon and two-agent paths ------------------------------
    # the polygon screen main path: K1 and K3 (poly), nothing else
    p_k1, p_k3, t_pplain, penv = _screen_path(
        cfg, dev, acts, poly, "bench.py game", "17 polygon screen path")
    pd_k1, pd_k3, _, _ = _screen_path(duel10, dev, acts, poly, "mode 10",
                                      "17 polygon screen path")
    # the wavy virus rim: obs/screen.py::screen_frame on the card
    from agarcl_tpu_torch.obs import screen as TS
    wavy = ScreenObsConfig(S_SCREEN, agent_view=True, polygon_edges=True)
    wenv = VecEnv(cfg, N_WAVY, "screen", obs_config=wavy)
    wpenv = VecEnv(cfg, N_WAVY, "screen", backend="torch", device=dev,
                   obs_config=wavy)
    wacts = acts[:N_WAVY]
    _zero_counts()
    ws0, wo0 = wenv.reset(0)
    ws, wo, wr, wd = wenv.multi_step(ws0, wacts, 2)
    torch.cuda.synchronize(dev)
    w_k1, w_k3, w_plain, w_cm = (FT.tick_launches, FS.launches,
                                 _plain_count(), TS.class_map_calls)
    _check((FT.launches, w_k1, w_k3, w_plain, w_cm) == (2, 2, 0, 0, 3),
           f"wavy route: K1 2x through engine_tick_raw, K3 0x, plain 0x, "
           f"class map 3x (K1 {FT.launches}, through engine_tick_raw {w_k1}, "
           f"K3 {w_k3}, plain {w_plain}, class map {w_cm})")
    _check(tuple(wo.shape) == (2, N_WAVY, 1, 1, S_SCREEN, S_SCREEN, 4),
           "wavy route obs shape")
    wps, wpo, wpr, wpd = wpenv.multi_step(ws0, wacts, 2)
    _check_same_states(ws, wps, "wavy route")
    _check_same([("frames", wo, wpo), ("rewards", wr, wpr),
                 ("dones", wd, wpd)], "wavy route")
    wvir = int((wo[..., 2] == 255).sum())
    _check(wvir > 0, "wavy route draws viruses")
    print(f"[17 wavy route] {N_WAVY} envs, S={S_SCREEN} agent view, "
          f"polygon_virus='wavy', reset + multi_step(k=2): K1 launches "
          f"{w_k1}, K3 launches {w_k3}, plain calls {w_plain}, class map "
          f"calls {w_cm}; against the torch backend on the card state, "
          f"frames, rewards and dones bit-equal; {wvir} virus pixels",
          flush=True)
    del wo, wpo, wps, wpd
    # mode 0 with 2 agents and a bot: one frame per (env, agent)
    a2 = _random_actions(N, dev, 2)
    a2_launch = {}
    a2_planes = None
    for kind, oc, mod in (("screen", scr, FS), ("grid", gcfg, FG)):
        env = VecEnv(m0_2a, N, kind, obs_config=oc)
        pe = VecEnv(m0_2a, N, kind, backend="torch", device=dev,
                    obs_config=oc)
        _zero_counts()
        s0a, o0 = env.reset(0)
        sa, oa, ra, da = env.multi_step(s0a, a2, 2)
        torch.cuda.synchronize(dev)
        launched = (FT.launches, FT.tick_launches, mod.launches,
                    _plain_count())
        _check(launched == (2, 2, 3, 0), f"2 agents, {kind}: K1 2x through "
               f"engine_tick_raw, frame kernel 3x (reset + 2 steps), plain "
               f"0x {launched}")
        a2_launch[kind] = mod.launches
        a2_launch["k1_" + kind] = FT.tick_launches
        want0 = mod.frame_plain(m0_2a, oc, FT.to_kernel_arrays(s0a))
        _check(tuple(o0.shape[:2]) == (N, 2) and torch.equal(o0, want0),
               f"2 agents, {kind}: reset frames (N, 2, ...) equal the "
               "plain version's")
        ps, po, pr, pd = pe.multi_step(s0a, a2, 2)
        _check_same_states(sa, ps, f"2 agents, {kind}")
        _check_same([("frames", oa, po), ("rewards", ra, pr),
                     ("dones", da, pd)], f"2 agents, {kind}")
        _check(tuple(oa.shape[:4]) == (2, N, 1, 2)
               and not torch.equal(oa[:, :, :, 0], oa[:, :, :, 1]),
               f"2 agents, {kind}: two different frames per env")
        print(f"[17 two agents] mode 0, 2 agents + 1 bot, {kind} "
              f"{tuple(oa.shape[4:])}, {N} envs, reset + multi_step(k=2) "
              f"per step: K1 launches {FT.launches}, {kind} kernel launches "
              f"{mod.launches} over {2 * N} frames each, plain calls 0; "
              f"reset frames equal the plain version's; against the torch "
              f"backend state, frames, rewards and dones bit-equal",
              flush=True)
        a2_planes = FT.to_kernel_arrays(sa)
        del oa, po, ps, o0, want0

    # --- 18. times --------------------------------------------------------
    s, _ = penv.reset(0)
    s, o, rw, _ = penv.multi_step(s, acts, K_SCREEN)             # warm
    rw.sum().item()
    times = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(4):
            del o
            s, o, rw, _ = penv.multi_step(s, acts, K_SCREEN)
        torch.cuda.synchronize(dev)
        rw.sum().item()
        times.append((time.perf_counter() - t0) / 4)
    del o, s
    t_poly = statistics.median(times)
    k3p_ms = _event_ms(lambda: FS.fused_screen_frame(cfg, poly, planes2), 10)
    k3c_ms = _event_ms(lambda: FS.fused_screen_frame(cfg, scr, planes2), 10)
    k3p_bound = _bound_ms(*_screen_work(cfg, poly, planes2))
    k3p_plain_ms = 1e3 * _timed(lambda: FS.frame_plain(cfg, poly, planes2),
                                dev, 2)
    wenv.multi_step(ws, wacts, 2)[2].sum().item()                  # warm
    t_w = _timed(lambda: wenv.multi_step(ws, wacts, 2)[2].sum().item(), dev,
                 1) / 2
    k3a_ms = _event_ms(lambda: FS.fused_screen_frame(m0_2a, scr, a2_planes),
                       10)
    k3a_bound = _bound_ms(*_screen_work(m0_2a, scr, a2_planes))
    k3p_shape = FS.launch_shape(cfg, poly, N)
    k3a_shape = FS.launch_shape(m0_2a, scr, N)
    k4a_shape = FG.launch_shape(m0_2a, gcfg, N)
    k4a_ms = _event_ms(lambda: FG.fused_grid_frame(m0_2a, gcfg, a2_planes),
                       10)
    k4a_bound = _bound_ms(*_grid_work(m0_2a, gcfg, N))
    print(f"[18 times] polygon screen path (bench.py game), {N} envs, "
          f"multi_step(k={K_SCREEN}), S={S_SCREEN}: kernel "
          f"{N * K_SCREEN / t_poly:,.0f} env-steps/s ({1e3 * t_poly:.2f} "
          f"ms/call, median of 3 runs x 4 calls); plain torch backend "
          f"{N * K_SCREEN / t_pplain:,.0f} env-steps/s "
          f"({1e3 * t_pplain:.2f} ms/call, 1 call: phase 17's); K3 poly "
          f"{k3p_ms:.3f} ms/frame, bound {k3p_bound[0]:.3f} ms by "
          f"{k3p_bound[1]}, {100 * k3p_bound[0] / k3p_ms:.1f}% of bound; K3 "
          f"circle mode on the same state {k3c_ms:.3f} ms/frame; plain poly "
          f"frame {k3p_plain_ms:.2f} ms; wavy route {1e3 * t_w:.2f} ms per "
          f"step at {N_WAVY} envs (K1 + class map, host clock); 2 agents "
          f"(mode 0, {2 * N} frames per call): K3 {k3a_ms:.3f} ms per step, "
          f"bound {k3a_bound[0]:.3f} ms by {k3a_bound[1]}, "
          f"{100 * k3a_bound[0] / k3a_ms:.1f}% of bound; K4 G={G_GRID} "
          f"int16 {k4a_ms:.3f} ms per step, bound {k4a_bound[0]:.3f} ms by "
          f"{k4a_bound[1]}, {100 * k4a_bound[0] / k4a_ms:.1f}% of bound "
          f"| {gpu}", flush=True)
    print(f"[18 shapes] K3 poly: {_shape_text(k3p_shape)}; K3 at 2 agents: "
          f"{_shape_text(k3a_shape)}; K4 at 2 agents: "
          f"{_shape_text(k4a_shape)}", flush=True)

    # --- 19. K1's partial-step mode against its plain version -------------
    k1p_err = _phase19(cfg, rosters[0][1], rosters[4][1], s2,
                       k3_states[1][2], ocfg, dev)

    # --- 20. the multi-frame paths ------------------------------------------
    scr4 = ScreenObsConfig(S_SCREEN, agent_view=True, num_frames=F_FRAMES)
    g4 = GridObsConfig(num_frames=F_FRAMES, grid_size=G_GRID,
                       out_dtype="int16")
    g6 = GridObsConfig(num_frames=6, grid_size=G_GRID, out_dtype="int16")
    f_launch = {}
    f_launch["screen_f4"] = _frames_path(cfg, dev, acts, scr4,
                                         "bench.py game, 128 screen")
    f_launch["duel_screen_f4"] = _frames_path(duel10, dev, acts, scr4,
                                              "duel (mode 10), 128 screen")
    f_launch["grid_f4"] = _frames_path(cfg, dev, acts, g4,
                                       "bench.py game, 64 int16 grid")
    f_launch["grid_f6"] = _frames_path(cfg, dev, acts, g6,
                                       "bench.py game, 64 int16 grid, "
                                       "num_frames 6 > 4 ticks", k=1)

    # --- 21. the gym core on the card -------------------------------------
    gym_launch, gym_cores = _gym_phase(dev)

    # --- 22. GoBigger on the card -----------------------------------------
    _gobigger_phase(cfg, dev, acts)

    # --- 23. times --------------------------------------------------------
    t_f4s = _frames_rate(VecEnv(cfg, N, "screen", obs_config=scr4), acts,
                         dev)
    t_f4g = _frames_rate(VecEnv(cfg, N, "grid", obs_config=g4), acts, dev)
    planes = FT.to_kernel_arrays(s2)
    k1p_ms = _event_ms(lambda: FT.engine_tick_raw(cfg, planes, 1), 10)
    k1p_dev_ms = _kernel_device_ms(lambda: FT.engine_tick_raw(cfg, planes, 1),
                                   "multi_step_kernel", 10, dev)
    k1p_bound = _bound_ms(*_partial_work(cfg, N, 1))
    k1p_plain_ms = 1e3 * _timed(lambda: FT.engine_tick_raw_plain(
        cfg, FT.to_kernel_arrays(s2), 1), dev, 2)
    del planes
    gym_rates = {kind: _gym_rate(core, dev)
                 for kind, core in sorted(gym_cores.items())}
    print(f"[23 times] num_frames {F_FRAMES}, {N} envs, multi_step(k="
          f"{K_SCREEN}) (one warm call, median of 3 runs x 4 calls): 128 "
          f"screen {N * K_SCREEN / t_f4s:,.0f} env-steps/s "
          f"({1e3 * t_f4s:.2f} ms/call), 64 int16 grid "
          f"{N * K_SCREEN / t_f4g:,.0f} env-steps/s ({1e3 * t_f4g:.2f} "
          f"ms/call); K1 partial-step mode, one tick without actions, "
          f"{k1p_ms:.3f} ms per call (CUDA events, mean of 10 after 1 warm), "
          f"of it the kernel "
          + (f"{k1p_dev_ms:.4f} ms" if k1p_dev_ms is not None
             else "not measured")
          + f" (torch.profiler device time, mean of 10), "
          f"bound {k1p_bound[0]:.4f} ms by {k1p_bound[1]}, plain "
          f"{k1p_plain_ms:.2f} ms; gym core at 1 env, ms per step (host "
          f"clock, mean of 50) / device-busy ms per step (torch.profiler, "
          f"10 steps) / host share: "
          + "; ".join(f"{kind} {w:.3f} / "
                      + (f"{b:.3f} / {100 * (1 - b / w):.1f}%"
                         if b is not None else "not measured")
                      for kind, (w, b) in gym_rates.items())
          + f" | {gpu}", flush=True)

    # --- 24-30. the rim: rosters, frame routes, sharding, tools -------------
    rim = {}
    t_rim = time.perf_counter()
    t_roster12 = _phase24(dev, gpu)
    rim.update({f"route {lb}": c for lb, (_, c) in
                _phase25(cfg, dev, gpu).items()})
    shard = _phase26(cfg, ocfg, dev, acts, gpu)
    rim["sharded ram"] = shard["counts"]
    rim.update({f"bench {a}": c for a, c in _phase27(gpu).items()})
    evaluator = _phase28(gpu)
    rim["bot evaluator"] = evaluator["counts"]
    client = _phase29(dev, gpu)
    rim["client"] = client["counts"]
    _phase30(cfg, dev, s2, gpu)
    print(f"[24-30 rim] {time.perf_counter() - t_rim:.1f} s for phases "
          f"24-30", flush=True)

    # --- 31-33. the trainer and the witnesses -------------------------------
    t_new = time.perf_counter()
    ppo = _phase31(dev, gpu)
    rim["ppo"] = ppo.pop("counts")
    rim["oracle"] = _phase32(dev, gpu)["counts"]
    drift = _phase33(dev, gpu)
    rim["drift"], rim["drift report"] = (drift["counts"],
                                         drift["report_counts"])
    print(f"[31-33 trainer and witnesses] {time.perf_counter() - t_new:.1f} "
          f"s for phases 31-33", flush=True)

    k1_bytes, k1_ops = _tick_work(cfg, ocfg, N, k)
    k2_bytes, k2_ops = _ram_work(cfg, ocfg, N)
    k1_bound, k2_bound = _bound_ms(k1_bytes, k1_ops), _bound_ms(k2_bytes,
                                                                 k2_ops)
    kernels = [
        {"name": "multi_step_tick", "route": "cuda",
         "source": "agarcl_tpu_torch/csrc/tick.cu",
         "replaces": "agarcl_tpu/ops/fused_tick.py:163",
         "launches": k1_launches + dr_k1 + m8_k1 + m2_k1
         + sum(c["k1"] - c["k1_tick"] for c in gym_launch.values()),
         "launches_by_path": dict(
             {"ram": k1_launches, "duel_ram": dr_k1, "mode0_8bots": m8_k1,
              "mode0_2agents": m2_k1},
             **{f"gym {p}": c["k1"] - c["k1_tick"]
                for p, c in gym_launch.items()
                if c["k1"] > c["k1_tick"]}),
         "step_ms_by_players": step_ms, "heavy_step_ms": heavy_ms,
         "launch_shape": shapes,
         "step_bound_ms_by_players": {P: b[0] for P, b in step_bound.items()},
         "max_abs_err": k1_err,
         "ms": 1e3 * t_kernel, "plain_ms": 1e3 * t_plain,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": None},
        {"name": "engine_tick", "route": "cuda",
         "source": "agarcl_tpu_torch/csrc/tick.cu",
         "replaces": "agarcl_tpu/ops/fused_tick.py:2700",
         "launches": s_k1 + g_k1 + d_k1 + p_k1 + pd_k1 + w_k1
         + a2_launch["k1_screen"] + a2_launch["k1_grid"]
         + sum(v[0] for v in f_launch.values())
         + sum(c["k1_tick"] for c in gym_launch.values()),
         "launches_by_path": dict(
             {"screen": s_k1, "grid": g_k1, "duel_screen": d_k1,
              "poly_screen": p_k1, "poly_duel_screen": pd_k1,
              "wavy_screen": w_k1,
              "agents2_screen": a2_launch["k1_screen"],
              "agents2_grid": a2_launch["k1_grid"]},
             **{p: v[0] for p, v in f_launch.items()},
             **{f"gym {p}": c["k1_tick"] for p, c in gym_launch.items()
                if c["k1_tick"]}),
         "max_abs_err": k1p_err,
         "ms": k1p_ms, "device_ms": k1p_dev_ms, "plain_ms": k1p_plain_ms,
         "bound_ms": k1p_bound[0], "bound_by": k1p_bound[1],
         "library_ms": None},
        {"name": "ram_frame", "route": "cuda",
         "source": "agarcl_tpu_torch/csrc/ram_frame.cu",
         "replaces": "agarcl_tpu/ops/fused_obs.py:190",
         "launches": k2_launches, "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": None},
        {"name": "screen_frame", "route": "cuda",
         "source": "agarcl_tpu_torch/csrc/screen.cu",
         "replaces": "agarcl_tpu/ops/fused_screen.py:196",
         "launches": s_k3 + d_k3 + p_k3 + pd_k3 + a2_launch["screen"]
         + f_launch["screen_f4"][1] + f_launch["duel_screen_f4"][1]
         + sum(c["k3"] for c in gym_launch.values()),
         "launches_by_path": dict(
             {"screen": s_k3, "duel_screen": d_k3, "poly_screen": p_k3,
              "poly_duel_screen": pd_k3,
              "agents2_screen": a2_launch["screen"],
              "screen_f4": f_launch["screen_f4"][1],
              "duel_screen_f4": f_launch["duel_screen_f4"][1]},
             **{f"gym {p}": c["k3"] for p, c in gym_launch.items()
                if c["k3"]}),
         "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "poly_ms": k3p_ms, "poly_circle_ms": k3c_ms,
         "poly_plain_ms": k3p_plain_ms, "poly_bound_ms": k3p_bound[0],
         "agents2_ms": k3a_ms, "agents2_bound_ms": k3a_bound[0],
         "nat84_ms": k3_nat_ms, "nat84_bound_ms": k3_nat_bound[0],
         "launch_shape": {"agent_view": k3_shape, "nat84": k3_nat_shape,
                          "poly": k3p_shape, "agents2": k3a_shape},
         "library_ms": None},
        {"name": "grid_frame", "route": "cuda",
         "source": "agarcl_tpu_torch/csrc/grid.cu",
         "replaces": "agarcl_tpu/ops/fused_grid.py:107",
         "launches": g_k4 + a2_launch["grid"] + f_launch["grid_f4"][1]
         + f_launch["grid_f6"][1] + sum(c["k4"] for c in gym_launch.values()),
         "launches_by_path": dict(
             {"grid": g_k4, "agents2_grid": a2_launch["grid"],
              "grid_f4": f_launch["grid_f4"][1],
              "grid_f6": f_launch["grid_f6"][1]},
             **{f"gym {p}": c["k4"] for p, c in gym_launch.items()
                if c["k4"]}),
         "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain_ms,
         "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
         "agents2_ms": k4a_ms, "agents2_bound_ms": k4a_bound[0],
         "g128_int32_ms": k4_big_ms, "g128_int32_bound_ms": k4_big_bound[0],
         "launch_shape": {"g64_int16": k4_shape, "g128_int32": k4_big_shape,
                          "agents2": k4a_shape},
         "library_ms": None},
    ]
    rim_launches = {"multi_step_tick": lambda c: c["k1"] - c["k1_tick"],
                    "engine_tick": lambda c: c["k1_tick"],
                    "ram_frame": lambda c: c["k2"],
                    "screen_frame": lambda c: c["k3"],
                    "grid_frame": lambda c: c["k4"]}
    for entry in kernels:
        for path, c in rim.items():
            n_path = rim_launches[entry["name"]](c)
            if n_path:
                entry["launches"] += n_path
                entry.setdefault("launches_by_path", {})[path] = n_path
    print(json.dumps({"rim": {
        "roster12_plain_step_ms": t_roster12,
        "sharded_ram_ms": shard["ms"], "unsharded_ram_ms": shard["vecenv_ms"],
        "bot_evaluator_env_steps_per_s": evaluator["rate"],
        "client_step_ms": client["ms"]}}))
    print(json.dumps({"trainer": dict(ppo, drift_report_s=drift[
        "report_s"])}))
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

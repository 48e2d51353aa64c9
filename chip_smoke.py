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
two agents' frames. Phases, one line each:

  1. toolchain: GPU name and power limit, torch and CUDA versions, nvcc,
     kernel build time;
  2. K2 (RAM-frame kernel) against obs/ram.py::ram_frame on the card;
  3. K1 (multi-step tick kernel) against its plain version on the card,
     from reset(0) with random actions: obs, rewards, dones and state
     after 1 step (all integer state equal in every env), after 8 steps
     and after one k=40 call, the main path's launch (at most 0.5% of envs
     may diverge; the outputs are compared in every other env);
  4. launch counters over the main path: both kernels launched, the plain
     version never called; outputs finite and of the expected shapes;
  5. throughput in env-steps/s for the kernel path and the plain "torch"
     backend on the same card;
  6. K1 alone, timed with CUDA events, with and without the RAM frame at
     4096 to 32768 envs: the frame's share and the launch-shape scaling;
  7. K3 (screen kernel) against its plain version on the card, 0 differing
     pixels: 8192 envs after 3 steps at S=128 agent view and S=84 natural
     RGB, a heavy-cell state (mass 400+ beside viruses) and a two-player
     state (other players drawn);
  8. the screen main path: reset + multi_step(k=10) launches K1 10 times
     and K3 11 times and no plain version, (10, 8192, 1, 1, 128, 128, 4)
     uint8 frames, finite rewards; one k=10 call of the plain "torch"
     backend from the same state gives the same rewards, dones and frames;
     then the per-step composition (auto_reset, respawn_main_during_obs,
     64 dead main players) for 2 steps against the torch backend;
  9. times: screen-path env-steps/s for both backends, K3 alone per frame
     (CUDA events) against its bound, K1 at k=1 per step;
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
     at k=1 per step against its plain version;
 13. K1 with bots and cross-player eating against its plain version: the
     duel task configurations (bench/tasks_configs/mode_7.json to
     mode_10.json: one agent against one scripted bot, arena 350, 500
     pellets, no viruses) at 8192 envs after 1 step (integer state equal in
     every env), after 8 steps and after one k=10 call (at most 0.5% of
     envs diverge), mode 0 with 8 bots (9 players) at 2048 envs, and a
     forced cross-eat; the bot pass and the cross-eat must have fired;
 14. the duel main paths: the screen path (reset + multi_step(k=10), K1 10
     launches, K3 11, plain 0, equal to the torch backend) in modes 10, 7,
     8 and 9; the duel's RAM path on resident state (multi_step(k=40));
     mode 0 with 8 bots (2048 envs) and mode 0 with 2 agents and 1 bot
     through the per-step composition (mode 0 respawns) against the torch
     backend; K2 at 2 players against ram_frame;
 15. times: duel screen-path env-steps/s for both backends, K1 per k=1
     step at 1, 2 and 9 players against its bound, the single-player RAM
     path again beside phase 5;
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
     against their bounds;
 19. K1 with a tick count (fused_tick.engine_tick_raw: n ticks with no
     action phase, or with one, then the RAM frame and info rows) against
     engine_tick_raw_plain on a played and a heavy state of the bench.py
     game at 8192 envs, the duel (2 players) at 8192 and mode 0 with 8
     bots (9 players) at 2048: 1 and 3 ticks, with and without actions;
     integer state equal in every env, f32 within 2e-3;
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
     partial-step call against its bound, gym steps per second at 1 env
     per obs type with the share of a step that is host time.

Then a JSON line describing each kernel, the GPU line and, last, the
device JSON line. Every screen and grid step runs K1 through
engine_tick_raw, so the JSON line lists those launches under
"engine_tick" and the RAM and GoBigger paths' under "multi_step_tick".
Any failure raises and exits non-zero. Without a CUDA device the script
exits non-zero before printing any result; it never falls back to the CPU.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_ENVS = 8192
K_STEPS = 40
TOL_RAM = dict(rtol=1e-5, atol=1e-4)     # tests/test_fused_tick.py:263-264
TOL_F32_STATE = 2e-3                     # tests/test_fused_tick.py:30-38
TOL_REWARD = 1e-5
MAX_DIVERGED_SHARE = 0.005               # of envs after 8 and 40 steps
PROBE_ENVS = (4096, 8192, 16384, 32768)
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


def _int_mismatch_envs(a, b) -> torch.Tensor:
    """(N,) bool: envs whose integer or bool state differs."""
    from agarcl_tpu_torch.state import STATE_FIELDS
    bad = torch.zeros(a.num_envs, dtype=torch.bool, device=a.device)
    for f in STATE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype.is_floating_point:
            continue
        bad |= (x != y).reshape(a.num_envs, -1).any(1)
    return bad


def _compare_runs(cfg, out_k, out_p, max_bad: int, label: str):
    """Hold K1's (resident, obs, rewards, dones) against the plain
    version's. At most `max_bad` envs may differ in integer state; in every
    other env the f32 state, obs and rewards must be within tolerance and
    the dones equal. Returns (diverged envs, f32 state, obs, reward err)."""
    from agarcl_tpu_torch.ops import fused_step
    from agarcl_tpu_torch.state import STATE_FIELDS
    res_k, obs_k, rew_k, done_k = out_k
    res_p, obs_p, rew_p, done_p = out_p
    sk = fused_step.from_resident(cfg, res_k)
    sp = fused_step.from_resident(cfg, res_p)
    bad = _int_mismatch_envs(sk, sp)
    n_bad = int(bad.sum())
    _check(n_bad <= max_bad, f"{label}: at most {max_bad} envs with integer "
           f"differences ({n_bad})")
    keep = ~bad
    f32_err = 0.0
    for f in STATE_FIELDS:
        x, y = getattr(sk, f), getattr(sp, f)
        if x.dtype.is_floating_point and x.numel():
            f32_err = max(f32_err, (x[keep] - y[keep]).abs().max().item())
    ok, op = obs_k[:, keep], obs_p[:, keep]
    obs_err = (ok - op).abs().max().item()
    rew_err = (rew_k[:, keep] - rew_p[:, keep]).abs().max().item()
    _check(f32_err <= TOL_F32_STATE, f"{label}: f32 state within 2e-3 "
           f"({f32_err})")
    _check(bool(torch.allclose(ok, op, **TOL_RAM)),
           f"{label}: obs within rtol/atol 1e-5/1e-4 ({obs_err})")
    _check(rew_err <= TOL_REWARD, f"{label}: rewards within 1e-5 "
           f"({rew_err})")
    _check(bool(torch.equal(done_k[:, keep], done_p[:, keep])),
           f"{label}: dones equal")
    return n_bad, f32_err, obs_err, rew_err


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
    and tick (6 each) and the frames' nearest-key scans (8 per pellet or
    virus key and pick) — a lower bound of the work."""
    from agarcl_tpu_torch.obs.ram import ram_size
    from agarcl_tpu_torch.ops import fused_tick as FT
    A = cfg.num_agents
    state = sum(r * (1 if dt == torch.bool else 4)
                for _, r, dt in FT._plane_specs(cfg))
    frame = 4 * A * ram_size(cfg, ocfg) if ocfg is not None else 0
    nbytes = n * (2 * state + 12 * A + k * (frame + 8 * cfg.num_players))
    per_step = cfg.ticks_per_step * cfg.pellet_capacity * 6 * cfg.num_players
    if ocfg is not None:
        per_step += 8 * A * (ocfg.num_pellets * cfg.pellet_capacity
                             + ocfg.num_viruses * cfg.virus_capacity)
    return nbytes, n * k * per_step


def _ram_work(cfg, ocfg, n: int):
    """Bytes and f32 operations of one K2 frame: the cell, pellet and virus
    planes it reads once, the frame written, 8 operations per key of the
    nearest-pellet and nearest-virus scans."""
    from agarcl_tpu_torch.obs.ram import ram_size
    cells = cfg.num_players * cfg.max_cells * (5 * 4 + 1)
    per_env = (cells + 4 * cfg.pellet_capacity + 13 * cfg.virus_capacity
               + 4 * cfg.num_agents * ram_size(cfg, ocfg))
    ops = 8 * (ocfg.num_pellets * cfg.pellet_capacity
               + ocfg.num_viruses * cfg.virus_capacity)
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


def _ptxas_summary(log: str) -> str:
    """'kernel: N registers, M bytes smem' for each kernel in a ptxas -v
    report."""
    out, name = [], None
    for line in log.splitlines():
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
                        name += "<agents>" if flags[0] == "1" else "<one>"
        elif "Used" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}")
            name = None
    return "; ".join(out) or "no ptxas report (cached build)"


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


def _fmt(e, n: int) -> str:
    return (f"{e[0]} envs ({100.0 * e[0] / n:.3f}%) differ in integer "
            f"state; in the rest max f32 state err {e[1]:.3g}, obs err "
            f"{e[2]:.3g}, reward err {e[3]:.3g}, dones equal")


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
    """K1 with bots and cross-player eating against its plain version;
    returns the largest error seen."""
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
        a, max_bad = acts[:n], int(MAX_DIVERGED_SHARE * n)
        s0 = env_reset(cfg, reset_seeds(n, 0, dev))
        res = lambda: fused_step.to_resident(cfg, s0)  # noqa: E731
        o1k, o1p = both(cfg, res(), res(), 1, a)
        e1 = _compare_runs(cfg, o1k, o1p, 0, f"{label}: after 1 step")
        o8k, o8p = both(cfg, o1k[0], o1p[0], 7, a)
        e8 = _compare_runs(cfg, o8k, o8p, max_bad, f"{label}: after 8 steps")
        s8 = fused_step.from_resident(cfg, o8k[0])
        bots = slice(cfg.num_agents, None)
        moved = int((s8.target[:, bots] != s0.target[:, bots]).flatten(1)
                    .any(1).sum())
        eaten = int((s8.cells_eaten > 0).any(1).sum())
        _check(moved > 0, f"{label}: bot targets changed")
        del o1k, o1p, o8k, o8p, s8
        o10k, o10p = both(cfg, res(), res(), 10, a)
        e10 = _compare_runs(cfg, o10k, o10p, max_bad,
                            f"{label}: after one k=10 call")
        del o10k, o10p
        err = max(err, *e1[1:], *e8[1:], *e10[1:])
        print(f"[13 K1 with bots] {label} ({cfg.num_players} players), {n} "
              f"envs, reset(0), random agent actions: after 1 step "
              f"{_fmt(e1, n)}; after 8 steps {_fmt(e8, n)}; after one k=10 "
              f"call {_fmt(e10, n)}; after 8 steps bot targets moved in "
              f"{moved} envs, a cell was eaten across players in {eaten}",
              flush=True)
    # a forced cross-eat: a 500-mass agent cell on the bot's spawn
    cfg = _rosters()[3][1]
    s0 = env_reset(cfg, reset_seeds(N_ENVS, 0, dev))
    cp, cm = s0.cell_pos.clone(), s0.cell_mass.clone()
    cp[:, 0, 0], cm[:, 0, 0] = cp[:, 1, 0], 500
    s0 = s0.replace(cell_pos=cp, cell_mass=cm)
    ok, op = both(cfg, fused_step.to_resident(cfg, s0),
                  fused_step.to_resident(cfg, s0), 1, acts)
    e = _compare_runs(cfg, ok, op, 0, "forced cross-eat: after 1 step")
    sk = fused_step.from_resident(cfg, ok[0])
    eaten = int((sk.cells_eaten[:, 0] > 0).sum())
    _check(eaten > N_ENVS // 2, f"forced cross-eat: the agent ate the bot "
           f"in most envs ({eaten})")
    dones = int(ok[3][0, :, 0].sum())
    _check(dones >= eaten, f"forced cross-eat: done on death ({dones})")
    err = max(err, *e[1:])
    print(f"[13 K1 with bots] forced cross-eat (mode 10, agent cell of 500 "
          f"on the bot), {N_ENVS} envs, 1 step: {_fmt(e, N_ENVS)}; the agent "
          f"ate the bot in {eaten} envs, {dones} envs done", flush=True)
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
    max_bad = int(MAX_DIVERGED_SHARE * N_ENVS)
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
    same = ~_int_mismatch_envs(st, pst)
    n_div = int((~same).sum())
    _check(n_div <= max_bad, f"{label} screen path: at most {max_bad} envs "
           f"diverge ({n_div})")
    rew_err = (srew[:, same] - prew[:, same]).abs().max().item()
    _check(rew_err <= TOL_REWARD and bool(torch.equal(sdone[:, same],
                                                      pdone[:, same])),
           f"{label} screen rewards within 1e-5 ({rew_err}), dones equal")
    bad_px = int((sobs[:, same] != pobs[:, same]).any(-1).sum())
    _check(bad_px == 0, f"{label} screen frames equal ({bad_px} pixels)")
    mode = "polygon fans" if scr.polygon_edges else "circles"
    print(f"[{phase}] {label}, reset + multi_step(k={K_SCREEN}) at {N_ENVS} "
          f"envs, S={S_SCREEN} agent view, {mode}: K1 launches {k1}, K3 "
          f"launches {k3}, plain calls {plain}, class map calls {routed}; "
          f"the bot drawn in {drawn} last frames; against the torch backend "
          f"{n_div} envs diverge, in the rest max reward err {rew_err:.3g}, "
          f"dones equal ({int(sdone.sum())} done agent-steps), 0 pixels "
          f"differ", flush=True)
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
    same = ~_int_mismatch_envs(st, pst)
    n_div, max_bad = int((~same).sum()), int(MAX_DIVERGED_SHARE * n)
    _check(n_div <= max_bad, f"{label}: at most {max_bad} envs diverge "
           f"({n_div})")
    obs_err = (obs[:, same] - pobs[:, same]).abs().max().item()
    rew_err = (rew[:, same] - prew[:, same]).abs().max().item()
    _check(bool(torch.allclose(obs[:, same], pobs[:, same], **TOL_RAM))
           and rew_err <= TOL_REWARD
           and bool(torch.equal(done[:, same], pdone[:, same])),
           f"{label}: obs within 1e-5/1e-4 ({obs_err}), rewards within 1e-5 "
           f"({rew_err}), dones equal")
    _check(bool(st.player_alive().all()), f"{label}: mode 0 respawned "
           "every dead player")
    print(f"[14 {label}] {n} envs, multi_step(k={k}) per step on the card: "
          f"K1 launches {k1}, plain calls {plain}; obs {tuple(obs.shape)}; "
          f"against the torch backend {n_div} envs diverge, in the rest max "
          f"obs err {obs_err:.3g}, reward err {rew_err:.3g}, dones equal; "
          f"cells eaten across players {int(st.cells_eaten.sum())}",
          flush=True)
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
    ticks, with and without actions, at 1, 2 and 9 players; integer state
    equal in every env, f32 within 2e-3, RAM frames within 1e-5 / 1e-4,
    info rows equal. Returns the largest error."""
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
            sk, sp = FT.from_kernel_arrays(s, pk), FT.from_kernel_arrays(s,
                                                                         pp)
            n_bad = int(_int_mismatch_envs(sk, sp).sum())
            what = (f"{label}, {n_ticks} ticks "
                    f"{'with' if with_actions else 'without'} actions")
            _check(n_bad == 0, f"partial step {what}: integer state equal in "
                   f"every env ({n_bad} differ)")
            f32 = max((getattr(sk, f) - getattr(sp, f)).abs().max().item()
                      for f in ("cell_pos", "cell_vel", "cell_split_vel",
                                "virus_pos", "food_pos", "food_vel",
                                "target", "anti_team_decay"))
            obs_err = (ok - op).abs().max().item()
            _check(f32 <= TOL_F32_STATE
                   and bool(torch.allclose(ok, op, **TOL_RAM))
                   and bool(torch.equal(ik, ip)),
                   f"partial step {what}: f32 within 2e-3 ({f32}), RAM "
                   f"frames within 1e-5 / 1e-4 ({obs_err}), info equal")
            err = max(err, f32, obs_err)
        print(f"[19 K1 partial step] {label}, {n} envs: 1 and 3 ticks, with "
              f"and without actions, each 1 launch: integer state equal in "
              f"every env, max f32 err {err:.3g} (2e-3), RAM frames and info "
              f"rows equal to engine_tick_raw_plain", flush=True)
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
    same = ~_int_mismatch_envs(got[0], want[0])
    n_div, max_bad = int((~same).sum()), int(MAX_DIVERGED_SHARE * N_ENVS)
    _check(n_div <= max_bad, f"{label}: at most {max_bad} envs diverge "
           f"({n_div})")
    bad = int((got[1][:, same] != want[1][:, same]).sum())
    rew_err = (got[2][:, same] - want[2][:, same]).abs().max().item()
    _check(bad == 0 and rew_err <= TOL_REWARD
           and bool(torch.equal(got[3][:, same], want[3][:, same])),
           f"{label}: {bad} frame values differ, reward err {rew_err}, "
           f"dones equal")
    print(f"[20 multi-frame path] {label}, {N_ENVS} envs, reset + "
          f"multi_step(k={k}), num_frames {F}: K1 launches {k1} (through "
          f"engine_tick_raw {k1t}), {kind} kernel launches {kf}, plain calls "
          f"{plain}; frames {shape}; against the torch backend over 2 "
          f"steps {n_div} envs diverge, in the rest 0 frame values differ, "
          f"max reward err {rew_err:.3g}, dones equal", flush=True)
    del got, want
    return k1t, kf


def _obs_equal(kind, a, b) -> bool:
    if kind == "gobigger":
        return repr(a) == repr(b)
    if kind == "ram":
        return bool(np.allclose(a, b, rtol=1e-5, atol=1e-4))
    return a.shape == b.shape and bool((a == b).all())


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
    _check(_obs_equal(kind, ko, po), f"{label}: reset obs equal")
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
        _check(_obs_equal(kind, ko, po) and abs(kr - pr) <= TOL_REWARD
               and kd == pd, f"{label}: step {t} equal to the plain backend "
               f"(reward {kr} / {pr}, done {kd} / {pd})")
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
    same = ~_int_mismatch_envs(s, ps)
    n_div, max_bad = int((~same).sum()), int(MAX_DIVERGED_SHARE * N_ENVS)
    _check(n_div <= max_bad, f"gobigger path: at most {max_bad} envs "
           f"diverge ({n_div})")
    for key in o:
        _check(bool(torch.equal(o[key][:, same], po[key][:, same])),
               f"gobigger path: {key} equal")
    _check(bool(torch.equal(r[:, same], pr[:, same]))
           and bool(torch.equal(d[:, same], pd[:, same])),
           "gobigger path: rewards and dones equal")
    n_foods = int(o["foods_mask"][-1].sum())
    print(f"[22 gobigger path] {N_ENVS} envs, reset + multi_step(k=2): K1 "
          f"launches {k1}, plain calls {plain}; foods table "
          f"{tuple(o['foods'].shape)}, clones {tuple(o['clones'].shape)}; "
          f"against the torch backend {n_div} envs diverge, in the rest "
          f"every table, mask, reward and done equal; {n_foods} foods in "
          f"view in the last frames", flush=True)


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
    k2_err = (got - ref).abs().max().item()
    _check(bool(torch.allclose(got, ref, **TOL_RAM)),
           f"K2 vs ram_frame within rtol/atol 1e-5/1e-4 (max {k2_err})")
    k2_ms = 1e3 * _timed(lambda: fused_obs.fused_ram_obs(cfg, ocfg, planes2),
                         dev, 20)
    k2_plain_ms = 1e3 * _timed(lambda: ram_frame(cfg, ocfg, s2), dev, 5)
    print(f"[2 K2 ram_frame] {N} envs after 3 plain steps: max |K2 - "
          f"ram_frame| = {k2_err:.3g} (rtol 1e-5, atol 1e-4) | K2 "
          f"{k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms | {gpu}", flush=True)

    # --- 3. K1 against its plain version ------------------------------------
    cuda_env = VecEnv(cfg, N, "ram", backend="cuda", device=dev)
    max_bad = int(MAX_DIVERGED_SHARE * N)

    def both(res_k, res_p, n_steps):
        out_k = fused_step.multi_step_resident(cfg, res_k, acts, n_steps,
                                               ocfg)
        out_p = fused_step.multi_step_resident(
            cfg, res_p, acts, n_steps, ocfg, plain=True)
        return out_k, out_p

    s0, _ = cuda_env.reset(0)
    out1_k, out1_p = both(fused_step.to_resident(cfg, s0),
                          fused_step.to_resident(cfg, s0), 1)
    e1 = _compare_runs(cfg, out1_k, out1_p, 0, "after 1 step")
    out8_k, out8_p = both(out1_k[0], out1_p[0], 7)
    e8 = _compare_runs(cfg, out8_k, out8_p, max_bad, "after 8 steps")
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
    e40 = _compare_runs(cfg, out40_k, out40_p, max_bad, f"after {k} steps")
    del out40_k, out40_p
    k1_err = max(max(e[1:]) for e in (e1, e8, e40))

    print(f"[3 K1 multi-step tick] {N} envs, reset(0), random actions: "
          f"after 1 step {_fmt(e1, N)}; after 8 steps {_fmt(e8, N)}; after "
          f"one k={k} call {_fmt(e40, N)}", flush=True)

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
    same = ~_int_mismatch_envs(st, pst)
    n_div = int((~same).sum())
    _check(n_div <= max_bad, f"screen path: at most {max_bad} envs diverge "
           f"({n_div})")
    s_rew_err = (srew[:, same] - prew[:, same]).abs().max().item()
    _check(s_rew_err <= TOL_REWARD, f"screen rewards within 1e-5 "
           f"({s_rew_err})")
    _check(bool(torch.equal(sdone[:, same], pdone[:, same])),
           "screen dones equal")
    s_obs_bad = int((sobs[:, same] != pobs[:, same]).any(-1).sum())
    _check(s_obs_bad == 0, f"screen frames equal ({s_obs_bad} pixels)")
    print(f"[8 screen path] reset + multi_step(k={K_SCREEN}) at {N} envs, "
          f"S={S_SCREEN} agent view: K1 launches {s_k1}, K3 launches "
          f"{s_k3}, plain calls {s_plain}; obs {tuple(sobs.shape)} uint8; "
          f"against the torch backend from the same state: {n_div} envs "
          f"diverge, in the rest max reward err {s_rew_err:.3g}, dones "
          f"equal, 0 pixels differ; mean reward per step "
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
    same = ~_int_mismatch_envs(fst, pst)
    f_div = int((~same).sum())
    _check(f_div <= max_bad, f"per-step path: at most {max_bad} envs diverge "
           f"({f_div})")
    f_rew_err = (frew[:, same] - prew[:, same]).abs().max().item()
    _check(f_rew_err <= TOL_REWARD and bool(torch.equal(fdone[:, same],
                                                        pdone[:, same])),
           f"per-step path rewards within 1e-5 ({f_rew_err}), dones equal")
    f_obs_bad = int((fobs[:, same] != pobs[:, same]).any(-1).sum())
    _check(f_obs_bad == 0, f"per-step path frames equal ({f_obs_bad} pixels)")
    _check(bool((frew[0, :64] >= 25).all()),
           "dead main players respawned in the first step (reward >= 25)")
    print(f"[8 per-step path] auto_reset + respawn_main_during_obs, 64 dead "
          f"main players, multi_step(k=2) at {N} envs: K1 and K3 once a "
          f"step; against the torch backend {f_div} envs diverge, in the "
          f"rest max reward err {f_rew_err:.3g}, dones equal, 0 pixels "
          f"differ", flush=True)
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
          f"{k3_nat_bound[1]}; K1 k=1 {k1_step_ms:.3f} ms/step, bound "
          f"{k1_step_bound[0]:.3f} ms by {k1_step_bound[1]} | {gpu}",
          flush=True)
    busy = ("not measured (the profiler saw no device time)" if prof is None
            else f"{100 * prof[0]:.1f}% of the call's wall time; largest: "
            + ", ".join(f"{k} {t:.2f} ms" for k, t in prof[1]))
    print(f"[9 screen profile] one multi_step(k={K_SCREEN}) under "
          f"torch.profiler: device busy {busy}", flush=True)

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
    same = ~_int_mismatch_envs(st, pst)
    g_div = int((~same).sum())
    _check(g_div <= max_bad, f"grid path: at most {max_bad} envs diverge "
           f"({g_div})")
    g_rew_err = (grew[:, same] - prew[:, same]).abs().max().item()
    _check(g_rew_err <= TOL_REWARD and bool(torch.equal(gdone[:, same],
                                                        pdone[:, same])),
           f"grid rewards within 1e-5 ({g_rew_err}), dones equal")
    g_obs_bad = int((gobs[:, same] != pobs[:, same]).sum())
    _check(g_obs_bad == 0, f"grid frames equal ({g_obs_bad} values)")
    print(f"[11 grid path] reset + multi_step(k={K_SCREEN}) at {N} envs, "
          f"G={G_GRID} int16: K1 launches {g_k1}, K4 launches {g_k4}, plain "
          f"calls {g_plain}; obs {tuple(gobs.shape)} int16; against the "
          f"torch backend from the same state: {g_div} envs diverge, in the "
          f"rest max reward err {g_rew_err:.3g}, dones equal, 0 values "
          f"differ; mean reward per step {grew.mean().item():.4f}",
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
    same = ~_int_mismatch_envs(fst, pst)
    fg_div = int((~same).sum())
    _check(fg_div <= max_bad, f"per-step grid path: at most {max_bad} envs "
           f"diverge ({fg_div})")
    fg_rew_err = (frew[:, same] - prew[:, same]).abs().max().item()
    _check(fg_rew_err <= TOL_REWARD and bool(torch.equal(fdone[:, same],
                                                         pdone[:, same])),
           f"per-step grid rewards within 1e-5 ({fg_rew_err}), dones equal")
    fg_obs_bad = int((fobs[:, same] != pobs[:, same]).sum())
    _check(fg_obs_bad == 0, f"per-step grid frames equal ({fg_obs_bad})")
    _check(bool((frew[0, :64] >= 25).all()),
           "dead main players respawned in the first step (reward >= 25)")
    print(f"[11 per-step grid path] auto_reset + respawn_main_during_obs, 64 "
          f"dead main players, multi_step(k=2) at {N} envs: K1 and K4 once a "
          f"step; against the torch backend {fg_div} envs diverge, in the "
          f"rest max reward err {fg_rew_err:.3g}, dones equal, 0 values "
          f"differ", flush=True)
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
    e_dr = _compare_runs(duel10, (r, robs, rrew, rdone), out_p, max_bad,
                         f"duel RAM path after {k} steps")
    k1_err = max(k1_err, *e_dr[1:])
    print(f"[14 duel RAM path] mode 10, reset + make_resident + "
          f"multi_step(k={k}) at {N} envs: K1 launches {dr_k1}, K2 launches "
          f"{dr_k2}, plain calls {dr_plain}; obs {tuple(robs.shape)}; "
          f"against the plain version {_fmt(e_dr, N)}; "
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
    k2p_err = (got - ref).abs().max().item()
    _check(fused_obs.launches == k2_before + 1
           and bool(torch.allclose(got, ref, **TOL_RAM)),
           f"K2 at 2 players vs ram_frame within 1e-5/1e-4 ({k2p_err})")
    _check(bool((ref[:, 0, -4:] != 0).any()), "the bot's row is filled")
    k2_err = max(k2_err, k2p_err)
    print(f"[14 K2 at 2 players] mode 10, {N} envs after 3 plain steps: max "
          f"|K2 - ram_frame| = {k2p_err:.3g}, the bot's per-player row "
          f"filled", flush=True)
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
    same = ~_int_mismatch_envs(ws, wps)
    w_div = int((~same).sum())
    w_bad = int((wo[:, same] != wpo[:, same]).any(-1).sum())
    _check(w_div <= int(MAX_DIVERGED_SHARE * N_WAVY) and w_bad == 0
           and bool(torch.equal(wd[:, same], wpd[:, same])),
           f"wavy route equals the torch backend ({w_div} envs diverge, "
           f"{w_bad} pixels differ)")
    wvir = int((wo[..., 2] == 255).sum())
    _check(wvir > 0, "wavy route draws viruses")
    print(f"[17 wavy route] {N_WAVY} envs, S={S_SCREEN} agent view, "
          f"polygon_virus='wavy', reset + multi_step(k=2): K1 launches "
          f"{w_k1}, K3 launches {w_k3}, plain calls {w_plain}, class map "
          f"calls {w_cm}; against the torch backend on the card {w_div} "
          f"envs diverge, 0 pixels differ; {wvir} virus pixels", flush=True)
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
        same = ~_int_mismatch_envs(sa, ps)
        a_div = int((~same).sum())
        a_bad = int((oa[:, same] != po[:, same]).sum())
        a_rew = (ra[:, same] - pr[:, same]).abs().max().item()
        _check(a_div <= max_bad and a_bad == 0 and a_rew <= TOL_REWARD
               and bool(torch.equal(da[:, same], pd[:, same])),
               f"2 agents, {kind}: equal to the torch backend ({a_div} "
               f"envs diverge, {a_bad} values differ, reward err {a_rew})")
        _check(tuple(oa.shape[:4]) == (2, N, 1, 2)
               and not torch.equal(oa[:, :, :, 0], oa[:, :, :, 1]),
               f"2 agents, {kind}: two different frames per env")
        print(f"[17 two agents] mode 0, 2 agents + 1 bot, {kind} "
              f"{tuple(oa.shape[4:])}, {N} envs, reset + multi_step(k=2) "
              f"per step: K1 launches {FT.launches}, {kind} kernel launches "
              f"{mod.launches} over {2 * N} frames each, plain calls 0; "
              f"reset frames equal the plain version's; against the torch "
              f"backend {a_div} envs diverge, in the rest 0 values differ, "
              f"max reward err {a_rew:.3g}", flush=True)
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
          f"bound {k3a_bound[0]:.3f} ms by {k3a_bound[1]}; K4 G={G_GRID} "
          f"int16 {k4a_ms:.3f} ms per step, bound {k4a_bound[0]:.3f} ms by "
          f"{k4a_bound[1]} | {gpu}", flush=True)

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
          f"bound {k1p_bound[0]:.4f} ms by {k1p_bound[1]}, plain "
          f"{k1p_plain_ms:.2f} ms; gym core at 1 env, ms per step (host "
          f"clock, mean of 50) / device-busy ms per step (torch.profiler, "
          f"10 steps) / host share: "
          + "; ".join(f"{kind} {w:.3f} / "
                      + (f"{b:.3f} / {100 * (1 - b / w):.1f}%"
                         if b is not None else "not measured")
                      for kind, (w, b) in gym_rates.items())
          + f" | {gpu}", flush=True)

    k1_bytes, k1_ops = _tick_work(cfg, ocfg, N, k)
    k2_bytes, k2_ops = _ram_work(cfg, ocfg, N)
    k1_bound, k2_bound = _bound_ms(k1_bytes, k1_ops), _bound_ms(k2_bytes,
                                                                 k2_ops)
    print(json.dumps({"kernels": [
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
         "step_ms_by_players": step_ms,
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
         "ms": k1p_ms, "plain_ms": k1p_plain_ms,
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
         "library_ms": None},
    ]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

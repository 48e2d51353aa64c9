"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's main path (agarcl_tpu_torch) at full size: the
bench.py default configuration (mode 4, arena 350, 500 pellets, 10
viruses, 4 ticks per step, delta-mass reward) at 8192 envs with a RAM
frame every step, through VecEnv(backend="cuda"): reset, make_resident,
multi_step(k=40). Phases, one line each:

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
     4096 to 32768 envs: the frame's share and the launch-shape scaling.

Then a JSON line describing each kernel and, last, the device JSON line.
Any failure raises and exits non-zero. Without a CUDA device the script
exits non-zero before printing any result; it never falls back to the CPU.
"""

from __future__ import annotations

import json
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


def _random_actions(n: int, dev) -> torch.Tensor:
    """(n, 1, 3) per-env targets in [-1, 1]^2 and actions in {0, 1, 2}."""
    rng = np.random.default_rng(0)
    acts = np.concatenate([rng.uniform(-1.0, 1.0, (n, 1, 2)),
                           rng.integers(0, 3, (n, 1, 1))], axis=-1)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 2
    from agarcl_tpu_torch import EnvConfig
    from agarcl_tpu_torch.obs.ram import RamObsConfig, ram_frame
    from agarcl_tpu_torch.ops import _build, fused_obs, fused_step
    from agarcl_tpu_torch.ops import fused_tick as FT
    from agarcl_tpu_torch.vec import VecEnv

    dev = torch.device("cuda", 0)
    gpu = _gpu_line()
    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=350,
                    num_pellets=500, num_viruses=10, reward_type=True,
                    mode=4)
    ocfg = RamObsConfig(num_pellets=32, num_viruses=8)
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
          f"{torch.version.cuda} | {nvcc} | kernels {built}", flush=True)

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
            cfg, res_p, acts, n_steps, ocfg, step=FT.multi_step_raw_plain)
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
                                             step=FT.multi_step_raw_plain)
    torch.cuda.synchronize(dev)
    out40_p[2].sum().item()
    t_plain = time.perf_counter() - t0
    e40 = _compare_runs(cfg, out40_k, out40_p, max_bad, f"after {k} steps")
    del out40_k, out40_p
    k1_err = max(max(e[1:]) for e in (e1, e8, e40))

    def fmt(e):
        return (f"{e[0]} envs ({100.0 * e[0] / N:.3f}%) differ in integer "
                f"state; in the rest max f32 state err {e[1]:.3g}, obs err "
                f"{e[2]:.3g}, reward err {e[3]:.3g}, dones equal")

    print(f"[3 K1 multi-step tick] {N} envs, reset(0), random actions: "
          f"after 1 step {fmt(e1)}; after 8 steps {fmt(e8)}; after one "
          f"k={k} call {fmt(e40)}", flush=True)

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

    print(json.dumps({"kernels": [
        {"name": "multi_step_tick", "route": "cuda",
         "source": "agarcl_tpu_torch/csrc/tick.cu",
         "replaces": "agarcl_tpu/ops/fused_tick.py:163",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": 1e3 * t_kernel, "plain_ms": 1e3 * t_plain},
        {"name": "ram_frame", "route": "cuda",
         "source": "agarcl_tpu_torch/csrc/ram_frame.cu",
         "replaces": "agarcl_tpu/ops/fused_obs.py:190",
         "launches": k2_launches, "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

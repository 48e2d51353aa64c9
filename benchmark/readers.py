"""The arithmetic of the per-layer readers. A quantity that cells with
different end-to-end metrics report is split into one metric per
end-to-end metric (k1.ms_per_step.ram moves ram_env_steps_per_s,
k1.ms_per_step.screen moves screen_env_steps_per_s); each metric's file
in benchmark/metrics/ names the function here that reads it. Each takes
trace.Readings and returns a number, or None where it finds nothing to
read.

At one env (the gym) the CUDA events around a launch time its launch
latency more than the kernel (K3: 0.020-0.023 ms on events against
3.8 us of kernel in the profiler), so the kernel readers read nothing
there.
"""

from __future__ import annotations

from benchmark import work

BATCHED = ("resident", "gamestate")


def k1_ms_per_step(r):
    """K1's device ms per env step of the whole batch: all its launches
    in the traced window over the window's steps."""
    if r.entry not in BATCHED or not r.layer_launches.get("k1"):
        return None
    return r.layer_ms["k1"] / (r.calls * r.k)


def k1_roofline_pct(r):
    """The least time of the window's K1 calls (work.k1_per_call, from
    the cell's shapes) over their device time, in %."""
    if r.entry not in BATCHED or not r.layer_launches.get("k1"):
        return None
    least = work.k1_per_call(r.cell, r.envs) * r.calls
    return 100.0 * least / (r.layer_ms["k1"] / 1e3)


def k3_ms_per_frame(r):
    """K3's device ms per frame of the whole batch (one launch draws every
    env's frame)."""
    if r.entry not in BATCHED or not r.layer_launches.get("k3"):
        return None
    return r.layer_ms["k3"] / (r.calls * r.k * r.frames)


def k3_roofline_pct(r):
    """The least time of the window's frames (work.k3_per_call) over K3's
    device time, in %."""
    if r.entry not in BATCHED or not r.layer_launches.get("k3"):
        return None
    least = work.k3_per_call(r.cell, r.envs) * r.calls
    return 100.0 * least / (r.layer_ms["k3"] / 1e3)


def vecenv_host_ms_per_step(r):
    """Host ms per env step of the batch inside the VecEnv call (host
    clock around the call, no synchronise), over the traced window."""
    if r.entry not in BATCHED or not r.call_s:
        return None
    return 1e3 * sum(r.call_s) / (len(r.call_s) * r.k)


def gym_host_ms_per_step(r):
    """Host ms of an AgarioCore.step beyond the device time of the
    kernels it launched: host clock around the call (it returns numpy, so
    it waits for the device) minus the call's kernel ms on CUDA events,
    averaged over the window's steps."""
    if r.entry != "gym" or not r.call_s:
        return None
    host = [1e3 * s - k for s, k in zip(r.call_s, r.call_kernel_ms)]
    return sum(host) / len(host)


def device_idle_pct(r):
    """100 minus the share of the traced window that the kernel library's
    launches cover on CUDA events (the port's hand-written kernels;
    PyTorch's own kernels, the rim's, count as idle)."""
    if r.window_s <= 0 or not r.layer_launches:
        return None
    return 100.0 - 100.0 * (r.kernel_ms / 1e3) / r.window_s

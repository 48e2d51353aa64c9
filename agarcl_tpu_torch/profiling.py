"""Tracing and timing utilities (counterpart of profiling.py).

- `trace(log_dir)`: a torch.profiler trace of the enclosed block, with
  CUDA activity when a CUDA device is present (Chrome-trace JSON, viewed
  with Perfetto or chrome://tracing);
- `StepTimer`: env-steps per second of a loop, synchronising the device
  of each step's result before it counts the step;
- `device_time_of`: the median time of a call, on CUDA events when its
  result lies on a CUDA device, else on the host clock after the call
  returned (a CPU tensor is ready when the call returns).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import torch


def _default_trace_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "agarcl_torch_trace")


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a torch.profiler trace of the enclosed block into
    `log_dir` (default: agarcl_torch_trace under the temp directory):
    CPU activity always, CUDA activity when a CUDA device is present.
    Yields the profiler; its key_averages() is there after the block."""
    log_dir = log_dir or _default_trace_dir()
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _devices_of(result) -> set:
    """The CUDA devices of the tensors in a (nested) result."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.is_cuda else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        return set().union(*map(_devices_of, result))
    if hasattr(result, "__dataclass_fields__"):
        return _devices_of([getattr(result, f)
                            for f in result.__dataclass_fields__])
    return set()


def synchronize(result) -> None:
    """Wait until every CUDA tensor of `result` is computed."""
    for dev in _devices_of(result):
        torch.cuda.synchronize(dev)


class StepTimer:
    """Env-steps per second of a loop: start(), tick(num_envs, result)
    after each call (the result's CUDA devices are synchronised first, so
    the count covers finished work), stop() -> dict."""

    def __init__(self):
        self.steps = 0
        self.envs = 0
        self._t0 = None
        self.history = []

    def start(self):
        self._t0 = time.perf_counter()
        self.steps = 0
        self.envs = 0

    def tick(self, num_envs: int, result=None):
        if result is not None:
            synchronize(result)
        self.steps += 1
        self.envs += num_envs

    def stop(self) -> dict:
        dt = time.perf_counter() - self._t0
        out = dict(seconds=dt, calls=self.steps, env_steps=self.envs,
                   env_steps_per_sec=self.envs / dt if dt > 0 else 0.0)
        self.history.append(out)
        return out


def device_time_of(fn: Callable, *args, iters: int = 10, warmup: int = 2,
                   **kw) -> float:
    """Median seconds per call of fn(*args, **kw). When the warm calls'
    result lies on a CUDA device, each call is timed with CUDA events
    recorded on that device's current stream around it; otherwise with
    the host clock around the call and a synchronisation of its result."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    devs = _devices_of(out) if warmup else set()
    times = []
    if devs:
        dev = sorted(devs, key=str)[0]
        with torch.cuda.device(dev):
            for _ in range(iters):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*args, **kw)
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            synchronize(out)
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]

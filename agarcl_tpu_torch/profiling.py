"""The port's span recorder, tracing and timing.

- `span(name)`: a host-clock span at one of the port's layer boundaries
  (the names in `SPANS`). Spans are off by default: a span then costs one
  flag test, returns a shared no-op context and records nothing.
  `enable(True)` records each span's name, start and end
  (time.perf_counter_ns), the index of its parent span and its root (the
  outermost span open when it began: one gym step, one VecEnv call, one
  reset) in an in-memory list until `clear()`. With `device_ms=True` a
  kernel-launch span (`kN.launch`) also records a CUDA event pair around
  its C call (`span(...).device(dev)`); the pairs cost a device-bound
  chain 1-3.5% of its rate, so they are off unless a caller asks for
  device ms. `enable(True, annotate=True)` also opens a
  torch.profiler.record_function per span, so under a profiler the spans
  land in its Chrome trace as user_annotation events, on the clock of the
  device's kernels.
- `summary()`: per span name its count, host ms, self host ms (minus its
  direct children) and, for launch spans, device ms on the CUDA events;
  with the counters the kernel wrapper modules register
  (`register_counters`, read by `counters()`).
- `trace(log_dir)`: a torch.profiler trace of the enclosed block, with
  CUDA activity when a CUDA device is present and the spans on and
  annotated (Chrome-trace JSON, viewed with Perfetto or
  chrome://tracing).
- `device_time_of`: the median time of a call, on CUDA events when its
  result lies on a CUDA device, else on the host clock after the call
  returned (a CPU tensor is ready when the call returns).
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
from typing import Callable

import torch

# name: where the span is
SPANS = {
    "gym.step": "gym_core.AgarioCore.step",
    "gym.reset": "gym_core.AgarioCore.reset",
    "gym.actions": "gym_core.AgarioCore._sanitize_actions",
    "gym.fetch": "each device-to-host copy of a gym step or reset",
    "gym.graph": "ops/fused_step.py::StepGraphs.step, each graph replay",
    "vec.multi_step": "vec.VecEnv.multi_step (and so VecEnv.step)",
    "vec.reset": "vec.VecEnv.reset",
    "reset.engine": "env.env_reset",
    "layout.to_kernel": "ops/fused_tick.py::to_kernel_arrays",
    "layout.from_kernel": "ops/fused_tick.py::from_kernel_arrays",
    "rim.finish": "ops/fused_step.py::_finish_step",
    "rim.respawn_all": "env.finish_step, mode 0's respawn of every dead "
                       "player",
    "rim.rewards": "ops/fused_step.py::multi_step_resident's rewards and "
                   "dones",
    "k1.launch": "ops/fused_tick.py::_launch",
    "k2.launch": "ops/fused_obs.py::fused_ram_obs, CUDA branch",
    "k3.launch": "ops/fused_screen.py::fused_screen_frame, CUDA branch",
    "k4.launch": "ops/fused_grid.py::fused_grid_frame, CUDA branch",
}
# the spans that open a root: a gym step or reset, a VecEnv call or reset
ROOTS = ("gym.step", "gym.reset", "vec.multi_step", "vec.reset")

_on = False           # spans are recorded
_annotate = False     # each span is also a record_function range
_time_launches = False  # launch spans time their C call on CUDA events
# [name, start ns, end ns (None while open), parent index (-1: none),
#  root index, CUDA event pair | device ms | None]
_records: list = []
_open: list = []      # indices of the open spans, innermost last
_counted: dict = {}   # module name -> (prefix, names of its counters)


class _Off:
    """The shared no-op context a span is while spans are off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def device(self, dev):
        return self


_OFF = _Off()


class _Events:
    """A CUDA event pair on `dev`'s current stream around the block,
    stored in its span's record."""
    __slots__ = ("rec", "stream", "e0")

    def __init__(self, rec, dev):
        self.rec = rec
        self.stream = torch.cuda.current_stream(dev)

    def __enter__(self):
        self.e0 = torch.cuda.Event(enable_timing=True)
        self.e0.record(self.stream)
        return self

    def __exit__(self, *exc):
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record(self.stream)
        self.rec[5] = (self.e0, e1)
        return False


class _Span:
    __slots__ = ("name", "rec", "index", "rf")

    def __init__(self, name: str):
        self.name = name
        self.rf = None

    def __enter__(self):
        if _annotate:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.index = len(_records)
        self.rec = [self.name, 0, None, _open[-1] if _open else -1,
                    _open[0] if _open else self.index, None]
        _records.append(self.rec)
        _open.append(self.index)
        self.rec[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        _open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False

    def device(self, dev):
        """A context that times its block on CUDA events on `dev`'s
        current stream, as this span's device time (while device ms are
        asked for; a no-op otherwise)."""
        return _Events(self.rec, dev) if _time_launches else _OFF


def span(name: str):
    """A context manager that records the span `name` while spans are on
    (`enable`); the shared no-op context otherwise."""
    return _Span(name) if _on else _OFF


def enable(on: bool, annotate: bool = False,
           device_ms: bool = False) -> tuple:
    """Turn span recording on or off. With annotate, each span is also a
    torch.profiler.record_function range; with device_ms, each launch
    span times its C call on a CUDA event pair. Returns the earlier
    (on, annotate, device_ms)."""
    global _on, _annotate, _time_launches
    prev = (_on, _annotate, _time_launches)
    _on = bool(on)
    _annotate = _on and bool(annotate)
    _time_launches = _on and bool(device_ms)
    return prev


def clear() -> None:
    """Drop the recorded spans (none may be open)."""
    if _open:
        raise RuntimeError("clear() while spans are open")
    _records.clear()


def records() -> list:
    """The recorded spans as (name, start ns, end ns (None while open),
    parent index (-1 for a root), root index); indices are positions in
    this list."""
    return [tuple(r[:5]) for r in _records]


def register_counters(module: str, prefix: str, names) -> None:
    """Name module-level int counters of `module` (a module name) for
    `counters()`, as `prefix.name`; a kernel wrapper module registers its
    own when it is imported."""
    _counted[module] = (prefix, tuple(names))


def counters() -> dict:
    """The registered counters' current values, by prefix.name."""
    return {f"{prefix}.{n}": getattr(sys.modules[module], n)
            for module, (prefix, names) in _counted.items() for n in names}


def _device_ms(rec):
    """The record's device ms, resolving its CUDA event pair once (the
    end event is waited for)."""
    ev = rec[5]
    if isinstance(ev, tuple):
        ev[1].synchronize()
        rec[5] = ev[0].elapsed_time(ev[1])
    return rec[5]


def summary(root: str | None = None) -> dict:
    """{"spans": {name: {"count", "host_ms", "self_ms", "device_ms"}},
    "counters": counters()} over the finished spans; with `root`, only
    the spans whose root span has that name. self_ms is host_ms less the
    time of the span's direct children; device_ms is None for spans that
    timed no launch."""
    child_ns = [0] * len(_records)
    for r in _records:
        if r[2] is not None and r[3] >= 0:
            child_ns[r[3]] += r[2] - r[1]
    out = {}
    for i, r in enumerate(_records):
        if r[2] is None or (root is not None and _records[r[4]][0] != root):
            continue
        s = out.setdefault(r[0], {"count": 0, "host_ms": 0.0,
                                  "self_ms": 0.0, "device_ms": None})
        s["count"] += 1
        s["host_ms"] += (r[2] - r[1]) / 1e6
        s["self_ms"] += (r[2] - r[1] - child_ns[i]) / 1e6
        if r[5] is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + _device_ms(r)
    return {"spans": out, "counters": counters()}


def _default_trace_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "agarcl_torch_trace")


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a torch.profiler trace of the enclosed block into
    `log_dir` (default: agarcl_torch_trace under the temp directory):
    CPU activity always, CUDA activity when a CUDA device is present, the
    port's spans on and annotated for the block (the earlier state comes
    back afterwards; the spans stay in `summary()` until `clear()`).
    Yields the profiler; its key_averages() is there after the block."""
    log_dir = log_dir or _default_trace_dir()
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prev = enable(True, annotate=True)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        enable(*prev)
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

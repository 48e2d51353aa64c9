"""What the traced run (--trace 1) reads, from the benchmark's own side of
the program's boundary:

- `KernelEvents`: a CUDA event before and after every launch through the
  kernel library's C entry points that the layer files name
  (benchmark/layers/*.json "entries"), installed by replacing those
  functions on the loaded library for the traced window only. The stream
  is in order, so the time between a launch's two events is that kernel's
  device time.
- `profile`: torch.profiler over a short second window after it, for the
  device's busy seconds, the device operations by name and the idle gaps
  by the harness span the host was in (the profiler slows the host, so
  the per-layer metrics do not read it). Its Chrome trace goes to
  benchmark/out/ and is read back.
- `Readings`: what the per-layer readers (benchmark/metrics/*.py) read.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import time
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160     # a device operation's name as reported (C++ signatures)


class KernelEvents:
    """CUDA events around each launch of the named C entry points of a
    ctypes library; `records` holds (layer key, start, end) per launch."""

    def __init__(self, lib, layers: dict):
        self.lib = lib
        self.records = []
        self._orig = {}
        for key, layer in layers.items():
            for name in layer.get("entries", ()):
                if hasattr(lib, name):
                    self._orig[name] = getattr(lib, name)
                    setattr(lib, name, self._wrap(key, self._orig[name]))

    def _wrap(self, key, fn):
        def launch(*args):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            status = fn(*args)
            e1.record()
            self.records.append((key, e0, e1))
            return status
        return launch

    def remove(self) -> None:
        for name, fn in self._orig.items():
            setattr(self.lib, name, fn)
        self._orig = {}

    def times_ms(self):
        """[(layer key, ms)] of the recorded launches (synchronise
        first)."""
        return [(k, e0.elapsed_time(e1)) for k, e0, e1 in self.records]


@dataclasses.dataclass
class Readings:
    """What a per-layer reader reads. `cell` is the manifest.Cell; `k`,
    `envs`, `frames` its shapes; `entry` its traffic's entry; `calls` and
    `window_s` the traced window's calls and host seconds (first issue to
    the final synchronise); `layer_ms` / `layer_launches` the kernel
    library's device ms and launches by layer file stem; `call_s` each
    call's host seconds; `call_kernel_ms` the kernel ms each call
    launched; `spans` the harness's host spans in seconds by name."""
    cell: object
    entry: str
    envs: int
    k: int
    frames: int
    calls: int
    window_s: float
    layer_ms: dict
    layer_launches: dict
    call_s: list
    call_kernel_ms: list
    spans: dict

    @property
    def kernel_ms(self) -> float:
        return sum(self.layer_ms.values())


def readings(cell, entry: str, envs: int, k: int, frames: int, window,
             events: KernelEvents, call_marks: list, spans) -> Readings:
    """Reduce a traced window's events: per layer, and per call
    (call_marks[i] is the record count after call i)."""
    times = events.times_ms()
    layer_ms = collections.defaultdict(float)
    layer_n = collections.defaultdict(int)
    for key, ms in times:
        layer_ms[key] += ms
        layer_n[key] += 1
    per_call, prev = [], 0
    for mark in call_marks:
        per_call.append(sum(ms for _, ms in times[prev:mark]))
        prev = mark
    return Readings(cell=cell, entry=entry, envs=envs, k=k, frames=frames,
                    calls=window.calls, window_s=window.seconds,
                    layer_ms=dict(layer_ms), layer_launches=dict(layer_n),
                    call_s=list(window.call_s), call_kernel_ms=per_call,
                    spans={n: list(v) for n, v in spans.times.items()})


def profile(drive, out_path: Path, layers: dict) -> dict:
    """Run drive() under torch.profiler (CPU and CUDA), write the Chrome
    trace to out_path and reduce it: busy_s (the union of device
    operations), window_s (host seconds of the profiled block, ending in a
    synchronise), device_ops (the 10 device operations that took the most
    time, by name), idle_gaps (device idle seconds by the harness span the
    host was in when each gap began, the 10 largest), layer_s (device
    seconds by layer file stem, with what no layer claims under
    "other")."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        drive()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    prof.export_chrome_trace(str(out_path))
    with open(out_path) as f:
        events = json.load(f)["traceEvents"]
    return dict(reduce_trace(events, layers), window_s=window_s)


def reduce_trace(events: list, layers: dict) -> dict:
    """The profile() reductions of Chrome-trace events (ts, dur in us)."""
    dev = sorted((e for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                 key=lambda e: e["ts"])
    spans = sorted(((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                    for e in events
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"),
                   key=lambda s: s[0])
    by_name = collections.defaultdict(float)
    layer_s = collections.defaultdict(float)
    for e in dev:
        s = e.get("dur", 0) / 1e6
        by_name[e["name"]] += s
        layer_s[_layer_of(e["name"], layers)] += s
    busy, gaps = 0.0, collections.defaultdict(float)
    end = None
    starts = [s[0] for s in spans]
    for e in dev:
        t0, t1 = e["ts"], e["ts"] + e.get("dur", 0)
        if end is not None and t0 > end:
            gaps[_span_at(spans, starts, end)] += (t0 - end) / 1e6
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top = [(n[:NAME_CHARS], s) for n, s in top]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy / 1e6, device_ops=[[n, s] for n, s in top],
                idle_gaps=[[n, s] for n, s in top_gaps],
                layer_s=dict(layer_s), device_op_count=len(dev))


def _layer_of(name: str, layers: dict) -> str:
    for key, layer in layers.items():
        if any(k in name for k in layer.get("kernels", ())):
            return key
    return "other"


def _span_at(spans, starts, t) -> str:
    """The innermost harness span open at host time t, or "none"."""
    i = bisect.bisect_right(starts, t)
    best = "none"
    for s0, s1, name in reversed(spans[max(0, i - 64):i]):
        if s0 <= t <= s1:
            best = name
            break
    return best

"""The program's own spans in a cell, beside the traced run's CUDA events
(an operator's tool: the benchmark's command does not run it yet).

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>
        [--rates <s>]

Sets the cell up as benchmark/run.py does and runs its events window
(--seconds; CUDA events around the kernel library's launches; the cell's
per-layer readers). Then, with the events removed:

1. a spans window of SPANS_S seconds with the program's spans on
   (agarcl_tpu_torch.profiling) and the launch spans' device ms, no
   events and no profiler: its summary per span name, overall and by
   root span;
2. run.TRACE_PROFILE_S seconds under trace.profile with the spans on and
   annotated (on a card): runtime launches (`is_launch`) by the innermost
   port span open at their host timestamp, device ms by launching port span
   (each device operation tied to its launch through args.correlation),
   and the idle gaps by innermost span (trace.reduce_trace);
3. with --rates, four windows of that many seconds: spans off, on, on
   with the launch spans' CUDA event pairs, off.

Prints one JSON line: the cell's per-layer readers on the events window
("events") and on Readings built from the spans window's spans
("spans"), the metrics of METRICS, the profiled second's idle gaps and
launches, the span cost and the rates; writes the spans window's summary
to benchmark/out/spans_<cell>.json beside the Chrome trace. No check runs
(benchmark/run.py decides `correct`).

The readers of METRICS take an object with `program` (the spans window:
{"summary", "by_root", "calls", "window_s"}), `profile` (reduce_port of
the profiled second, with its "calls") and `k`.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
import time
from pathlib import Path

from agarcl_tpu_torch import profiling
from benchmark import manifest, run

SPANS_S = 2.0       # the spans window: about three RAM-chain resets
# The port's spans; the harness's own (draw, call, post, wait, capture,
# sync) are not among them.
PORT_SPANS = tuple(profiling.SPANS)
# kN.launch -> the layer file stem kN
LAUNCH_LAYER = {n: n.split(".")[0] for n in PORT_SPANS
                if n.endswith(".launch")}
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def is_launch(name: str) -> bool:
    """A runtime call that puts work on a stream: cudaLaunchKernel*,
    cuLaunchKernel*, cudaMemcpy*Async, cudaMemsetAsync."""
    return (name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
            or (name.startswith("cudaMemcpy") and name.endswith("Async"))
            or name == "cudaMemsetAsync")


def _enclosing(spans, times):
    """For each host time in `times` (sorted), the names of the port spans
    open at it, outermost first. `spans` are (start, end, name) sorted by
    start, properly nested (one thread)."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(tuple(s[2] for s in stack))
    return out


def reduce_port(events: list, layers: dict) -> dict:
    """Chrome-trace events (ts, dur in us) -> {"launches": runtime launches
    by innermost port span ("none" outside every one), "device_ms": device
    ms by the innermost port span of the operation's launch, "within":
    {port span name: {"spans": how many, "launches", "device_ms",
    "other_ms"}} over everything launched inside a span of that name at
    any depth ("other_ms": the operations no layer file claims, PyTorch's
    own)}."""
    from benchmark.trace import DEVICE_CATS, _layer_of
    spans = sorted(((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                    for e in events
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e["name"] in PORT_SPANS),
                   key=lambda s: (s[0], -s[1]))
    runtime = sorted(((e["ts"], e.get("args", {}).get("correlation"))
                      for e in events
                      if e.get("ph") == "X" and e.get("cat") in RUNTIME_CATS
                      and is_launch(e["name"])), key=lambda x: x[0])
    chains = _enclosing(spans, [t for t, _ in runtime])
    chain_of = {c: ch for (_, c), ch in zip(runtime, chains)
                if c is not None}
    launches = collections.Counter(ch[-1] if ch else "none"
                                   for ch in chains)
    within = {n: {"spans": 0, "launches": 0, "device_ms": 0.0,
                  "other_ms": 0.0} for n in PORT_SPANS}
    for _, _, name in spans:
        within[name]["spans"] += 1
    for ch in chains:
        for name in set(ch):
            within[name]["launches"] += 1
    device_ms = collections.defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        ch = chain_of.get(e.get("args", {}).get("correlation"), ())
        ms = e.get("dur", 0) / 1e3
        device_ms[ch[-1] if ch else "none"] += ms
        other = _layer_of(e["name"], layers) == "other"
        for name in set(ch):
            within[name]["device_ms"] += ms
            if other:
                within[name]["other_ms"] += ms
    return {"launches": dict(launches), "device_ms": dict(device_ms),
            "within": {n: w for n, w in within.items() if w["spans"]}}


# --------------------------------------------------------------- readers
def _per(r, root: str):
    """(the spans window's spans with root `root`, how many roots), or
    (None, 0) where the window has none."""
    spans = r.program["by_root"].get(root, {})
    n = spans.get(root, {}).get("count", 0)
    return (spans, n) if n else (None, 0)


def _ms(spans: dict, name: str, key: str = "host_ms") -> float:
    return spans.get(name, {}).get(key, 0.0)


def gym_wait_ms_per_step(r):
    """Host ms a gym step waits in its device-to-host copies (gym.fetch:
    the frame, rewards, dones) per gym.step, spans window."""
    spans, n = _per(r, "gym.step")
    return None if not n else _ms(spans, "gym.fetch") / n


def gym_layout_ms_per_step(r):
    """Host ms of the GameState <-> kernel-plane conversions
    (layout.to_kernel + layout.from_kernel) per gym.step."""
    spans, n = _per(r, "gym.step")
    if not n:
        return None
    return (_ms(spans, "layout.to_kernel")
            + _ms(spans, "layout.from_kernel")) / n


def gym_rim_ms_per_step(r):
    """Self host ms of rim.finish (main respawn, mode rules, rewards,
    auto-reset; no child span) per gym.step."""
    spans, n = _per(r, "gym.step")
    return None if not n else _ms(spans, "rim.finish", "self_ms") / n


def gym_launches_per_step(r):
    """Runtime launches inside gym.step spans per gym.step, profiled
    second."""
    w = r.profile["within"].get("gym.step")
    return None if not w else w["launches"] / w["spans"]


def reset_host_ms(r):
    """Host ms per VecEnv.reset (vec.reset), spans window."""
    spans, n = _per(r, "vec.reset")
    return None if not n else _ms(spans, "vec.reset") / n


def vecenv_torch_kernel_ms_per_step(r):
    """Device ms of the operations launched inside vec.multi_step that no
    layer file claims (PyTorch's own), per env step of the batch, profiled
    second."""
    w = r.profile["within"].get("vec.multi_step")
    if not w or not r.profile.get("calls"):
        return None
    return w["other_ms"] / (r.profile["calls"] * r.k)


METRICS = {
    "gym.wait_ms_per_step": gym_wait_ms_per_step,
    "gym.layout_ms_per_step": gym_layout_ms_per_step,
    "gym.rim_ms_per_step": gym_rim_ms_per_step,
    "gym.launches_per_step": gym_launches_per_step,
    "reset.host_ms.ram": reset_host_ms,
    "vecenv.torch_kernel_ms_per_step.screen":
        vecenv_torch_kernel_ms_per_step,
}


@dataclasses.dataclass
class ProgramReadings:
    """What the readers of METRICS read."""
    k: int
    program: dict
    profile: dict


def readings_of_spans(cell, entry: str, envs: int, k: int, frames: int,
                      program: dict):
    """trace.Readings with the spans window's numbers in the events
    window's places: kernel ms and launches from the kN.launch spans'
    CUDA events, each call's host seconds from its root span (gym.step or
    vec.multi_step), the kernel ms of the calls from the spans under that
    root."""
    from benchmark import trace
    whole = program["summary"]["spans"]
    root = "gym.step" if entry == "gym" else "vec.multi_step"
    under = program["by_root"].get(root, {})
    layer_ms, layer_n = {}, {}
    for name, key in LAUNCH_LAYER.items():
        if whole.get(name, {}).get("device_ms") is not None:
            layer_ms[key] = whole[name]["device_ms"]
            layer_n[key] = whole[name]["count"]
    n = under.get(root, {}).get("count", 0)
    call_ms = under.get(root, {}).get("host_ms", 0.0) / max(n, 1)
    kern_ms = sum(under.get(name, {}).get("device_ms") or 0.0
                  for name in LAUNCH_LAYER) / max(n, 1)
    return trace.Readings(cell=cell, entry=entry, envs=envs, k=k,
                          frames=frames, calls=program["calls"],
                          window_s=program["window_s"], layer_ms=layer_ms,
                          layer_launches=layer_n,
                          call_s=[call_ms / 1e3] * n,
                          call_kernel_ms=[kern_ms] * n, spans={})


def span_cost_ns(n: int = 20_000) -> dict:
    """Host ns per `with span(...)`: spans off, on, on and annotated (no
    profiler running), less an empty loop's ns; the best of three."""
    def loop(on, annotate):
        prev = profiling.enable(on, annotate)
        best = None
        try:
            for _ in range(3):
                profiling.clear()
                t0 = time.perf_counter_ns()
                for _ in range(n):
                    with profiling.span("gym.step"):
                        pass
                dt = (time.perf_counter_ns() - t0) / n
                best = dt if best is None else min(best, dt)
        finally:
            profiling.enable(*prev)
            profiling.clear()
        return best

    t0 = time.perf_counter_ns()
    for _ in range(n):
        pass
    empty = (time.perf_counter_ns() - t0) / n
    return {k: loop(*v) - empty for k, v in (
        ("off", (False, False)), ("on", (True, False)),
        ("annotated", (True, True)))}


def _program_window(entry, seconds: float) -> dict:
    from benchmark import driver
    profiling.clear()
    prev = profiling.enable(True, device_ms=True)
    try:
        win = driver.run_window(entry, seconds, driver.Spans())
    finally:
        profiling.enable(*prev)
    out = {"summary": profiling.summary(),
           "by_root": {r: profiling.summary(root=r)["spans"]
                       for r in profiling.ROOTS},
           "calls": win.calls, "window_s": win.seconds}
    profiling.clear()
    return out


def _profiled_window(entry, layers: dict, out_path: Path):
    """run.TRACE_PROFILE_S seconds under trace.profile with the spans on
    and annotated: (reduce_port of the Chrome trace it writes, with the
    window's calls; trace.profile's own reduction)."""
    from benchmark import driver, trace
    wins = []
    profiling.clear()
    prev = profiling.enable(True, annotate=True)
    try:
        base = trace.profile(lambda: wins.append(driver.run_window(
            entry, run.TRACE_PROFILE_S, driver.Spans(profiled=True))),
            out_path, layers)
    finally:
        profiling.enable(*prev)
        profiling.clear()
    with open(out_path) as f:
        events = json.load(f)["traceEvents"]
    return dict(reduce_port(events, layers), calls=wins[0].calls), base


def _rates(entry, seconds: float) -> dict:
    """Env-steps per second of four windows: spans off, on, on with the
    launch spans' CUDA event pairs, off."""
    from benchmark import driver
    out = {}
    for label, on, dev in (("off", False, False), ("on", True, False),
                           ("on_device_ms", True, True),
                           ("off_again", False, False)):
        prev = profiling.enable(on, device_ms=dev)
        try:
            win = driver.run_window(entry, seconds, driver.Spans())
        finally:
            profiling.enable(*prev)
            profiling.clear()
        out[label] = win.calls * entry.k * entry.envs / win.seconds
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, default=0.0)
    return ap.parse_args(argv)


def main(argv=None, root: Path = manifest.ROOT,
         device: str = "cuda") -> int:
    """Run the tool; returns the exit code. `device` is "cuda" unless a
    test runs it on the CPU: then the port's plain backend stands in for
    the kernels, and there are no events and no profiled second."""
    args = parse_args(argv)
    root = Path(root)
    cell = manifest.cell(manifest.load(root), args.workload, root)
    run.cache_dirs(root)
    import torch

    from benchmark import driver, trace
    cuda = device == "cuda"
    if cuda:
        if not run.cuda_ready(torch, cell.chips):
            return 2
        torch.set_num_threads(1)
    lib, _ = run.load_kernels(device)
    layers = manifest.layers(root)
    tr = cell.traffic
    d = run.drive(cell, args.seed, args.seconds, device, lib,
                  layers if cuda else None)
    entry, k = d.entry, d.entry.k
    frames = driver.frames_per_step(cell.config)
    readers = {m["name"]: manifest.reader(m["name"], root)
               for m in cell.per_layer}
    events = {}
    if d.events is not None:
        reads = trace.readings(cell, tr["entry"], entry.envs, k, frames,
                               d.window, d.events, d.marks, d.spans)
        d.events.remove()
        events = {n: f(reads) for n, f in readers.items()}
    program = _program_window(entry, SPANS_S)
    out_dir = root / run.OUT
    profile = {"launches": {}, "device_ms": {}, "within": {}, "calls": 0}
    profiled = None
    if cuda:
        profile, base = _profiled_window(
            entry, layers, out_dir / f"trace_spans_{cell.name}.json")
        profiled = dict(profile, window_s=base["window_s"],
                        busy_s=base["busy_s"], idle_gaps=base["idle_gaps"])
    pr = ProgramReadings(k=k, program=program, profile=profile)
    sr = readings_of_spans(cell, tr["entry"], entry.envs, k, frames,
                           program)
    result = {
        "workload": cell.name, "seed": args.seed,
        "device": (torch.cuda.get_device_name(0) if cuda else "cpu"),
        "card": run._card_line() if cuda else "cpu",
        "events": events,
        "spans": {n: f(sr) for n, f in readers.items()},
        "metrics": {n: f(pr) for n, f in METRICS.items()},
        "spans_window": {"calls": program["calls"],
                         "window_s": program["window_s"]},
        "profiled": profiled,
        "span_cost_ns": span_cost_ns(),
    }
    if args.rates > 0:
        result["rates"] = _rates(entry, args.rates)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"spans_{cell.name}.json").write_text(json.dumps(
        dict(program, workload=cell.name, seed=args.seed), indent=1))
    entry.release()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

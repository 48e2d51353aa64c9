"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (import and CUDA init, the kernel library's load, which builds it
on a checkout's first run, the reset and the warm calls) is timed from the
process's start; then the cell's traffic drives the port for --seconds on
the host clock and the device is synchronised. With --trace 0 the result
holds the cell's end-to-end metrics, with --trace 1 its per-layer metrics
(benchmark/trace.py). Either way the window's captured calls are then
replayed by the frozen reference and compared (benchmark/check.py), once
the peak memory has been read and the port's state is freed.

The last line of standard output is the result's JSON object; earlier
lines on standard error give the set-up's split, the counts and the
device's name and power limit, and the last ones each compared number
beside its limit. Without a CUDA device, or with fewer than the cell asks
for, it exits with 2 and prints no result; so it does if the process has
loaded JAX, jaxlib, flax or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "agarcl_tpu")
TRACE_PROFILE_S = 1.0     # the traced run's profiled second window
OUT = "benchmark/out"     # traces, inside the checkout


def forbidden_modules(names=None) -> list:
    """Forbidden top-level names among the loaded modules (or `names`),
    compared whole: agarcl_tpu_torch is not agarcl_tpu."""
    tops = {name.split(".")[0]
            for name in (list(sys.modules) if names is None else names)}
    return sorted(tops & set(FORBIDDEN))


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _percentile(values, q: float) -> float:
    """The q-th percentile of values (linear between closest ranks)."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


@dataclasses.dataclass
class Drive:
    """One set-up and window of a cell (see `drive`)."""
    entry: object
    split: dict
    setup_s: float
    window: object
    records: list
    spans: object
    events: object
    marks: list


def drive(cell, seed: int, seconds: float, device: str, lib=None,
          layers=None, t_start: float | None = None) -> Drive:
    """Build the cell's system on `device`, reset it, warm it (two calls,
    the second captured for the check), then drive it for `seconds` with
    captures at times drawn from the seed. With `layers` (the traced run)
    the kernel library's launches are timed on CUDA events from the first
    warm call on, and the window's records are kept."""
    import torch

    from benchmark import driver, trace
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device == "cuda"
    split = {}
    t = time.perf_counter()
    entry = driver.make_entry(cell.config, cell.traffic, seed, device)
    tr = cell.traffic
    pick = torch.Generator().manual_seed(seed)
    n_rows = int(tr["checked_envs"])

    def rows_of():
        return driver.sample_rows(pick, entry.envs, n_rows).to(device)

    entry.setup(rows_of)
    split["reset"] = time.perf_counter() - t
    events = (trace.KernelEvents(lib, layers)
              if layers is not None and cuda else None)
    t = time.perf_counter()
    warm_spans = driver.Spans()
    driver.run_window(entry, 0.0, warm_spans)
    warm = driver.run_window(entry, 0.0, warm_spans, checkpoint_at=[0.0],
                             rows_of=rows_of)
    if cuda:
        torch.cuda.synchronize()
    split["warm"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    if events is not None:
        events.records.clear()
    at = (torch.rand(int(tr["checkpoints"]), generator=pick)
          * seconds).tolist()
    spans = driver.Spans()
    marks = []
    on_call = ((lambda i: marks.append(len(events.records)))
               if events is not None else None)
    win = driver.run_window(entry, seconds, spans, checkpoint_at=at,
                            rows_of=rows_of, on_call=on_call)
    return Drive(entry=entry, split=split, setup_s=setup_s, window=win,
                 records=warm.records + win.records, spans=spans,
                 events=events, marks=marks)


def load_kernels(device: str):
    """(library, seconds this process spent building it, or None)."""
    if device != "cuda":
        return None, None
    from agarcl_tpu_torch.ops import _build
    lib = _build.load()
    return lib, _build.build_seconds


def cuda_ready(torch, chips: int) -> bool:
    if not torch.cuda.is_available():
        _log("no CUDA device: the benchmark runs on the card only")
        return False
    if torch.cuda.device_count() < chips:
        _log(f"the cell needs {chips} CUDA devices, "
             f"{torch.cuda.device_count()} present")
        return False
    torch.cuda.init()
    torch.zeros(1, device="cuda")
    return True


def cache_dirs(root: Path) -> None:
    """Build and kernel caches a library may keep, at fixed paths inside
    the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(root / ".kernel_build" / sub))


def main(argv=None, root: Path = manifest.ROOT, device: str | None = None,
         t_start: float | None = None) -> int:
    """Run the cell; returns the exit code. `device` is "cuda" unless a
    test drives the harness on the CPU (then nothing is traced and the
    port's plain backend stands in for the kernels)."""
    t_start = T_START if t_start is None else t_start
    args = parse_args(argv)
    root = Path(root)
    bench = manifest.load(root)
    cell = manifest.cell(bench, args.workload, root)
    cache_dirs(root)
    import torch
    if device is None:
        if not cuda_ready(torch, cell.chips):
            return 2
        device = "cuda"
        # one host thread: the window issues work, and idle intra-op
        # threads would only contend with it for the host's cores
        torch.set_num_threads(1)
    cuda = device == "cuda"
    split = {"import_and_init": time.perf_counter() - t_start}

    from benchmark import check, driver, trace
    t = time.perf_counter()
    lib, built = load_kernels(device)
    split["kernel_load"] = time.perf_counter() - t
    layers = manifest.layers(root)
    if args.trace and not cuda:
        _log("the traced run reads CUDA events: no card, no trace")
        return 2
    run = drive(cell, args.seed, args.seconds, device, lib,
                layers if args.trace else None, t_start)
    split.update(run.split)
    entry, win, spans, events = run.entry, run.window, run.spans, run.events
    setup_s, records, marks, tr = (run.setup_s, run.records, run.marks,
                                   cell.traffic)
    found = forbidden_modules()
    if found:
        _log(f"forbidden modules loaded: {', '.join(found)}")
        return 2
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    k, frames = entry.k, driver.frames_per_step(cell.config)
    steps = win.calls * k * entry.envs
    metrics, device_info, breakdown = {}, {}, None
    if args.trace:
        reads = trace.readings(cell, tr["entry"], entry.envs, k, frames, win,
                               events, marks, spans)
        events.remove()
        for m in cell.per_layer:
            v = manifest.reader(m["name"], root)(reads)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        prof_spans = driver.Spans(profiled=True)
        prof = trace.profile(
            lambda: driver.run_window(entry, TRACE_PROFILE_S, prof_spans),
            root / OUT / f"trace_{cell.name}.json", layers)
        device_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        breakdown = {"device_ops": prof["device_ops"],
                     "idle_gaps": prof["idle_gaps"]}
        _log(f"trace: events window {win.seconds} s, {win.calls} calls, "
             f"kernel ms by layer {reads.layer_ms}, launches "
             f"{reads.layer_launches}")
        _log(f"trace: profiler window {prof['window_s']} s, busy "
             f"{prof['busy_s']} s, {prof['device_op_count']} device ops, "
             f"device s by layer (other: no layer claims it) "
             f"{prof['layer_s']}")
        _log("trace: host spans in the events window (s): " + json.dumps(
            {n: sum(v) for n, v in spans.times.items()}))
    else:
        # every "*steps_per_s" metric is the window's rate, named by its
        # users (RAM-frame, screen-frame and Gymnasium callers)
        e2e = {"setup_s": setup_s,
               "peak_mem_gib": peak / 2**30,
               "step_ms_p95": (_percentile([1e3 * s for s in win.call_s], 95)
                               if win.call_s else None)}
        for m in cell.end_to_end:
            v = (steps / win.seconds if m["name"].endswith("steps_per_s")
                 else e2e.get(m["name"]))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    _log(f"setup: {json.dumps(split)}; total {setup_s} s; kernel library "
         f"built in this run: {'no' if built is None else f'{built} s'}")
    _log(f"window: {win.calls} calls x {k} steps x {entry.envs} envs = "
         f"{steps} env-steps in {win.seconds} s; call host ms median "
         f"{1e3 * statistics.median(win.call_s)}, p95 "
         f"{_percentile([1e3 * s for s in win.call_s], 95)} over "
         f"{len(win.call_s)} calls")
    card = _card_line() if cuda else "cpu"
    _log(f"device: {card}; peak allocated {peak} bytes")

    # the check, once the port's state is freed
    reset_records = entry.reset_records
    entry.release()
    del entry
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    sp = check.spec(cell.config, tr)
    numbers = check.judge(sp, reset_records, records, device)
    _log(f"check: {numbers['checked']} env-steps and reset rows checked "
         f"({len(reset_records)} resets) in {time.perf_counter() - t} s, "
         f"{numbers['failed']} failed")
    checks = {name: {"value": numbers[name], "limit": lim}
              for name, lim in check.LIMITS.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    found = forbidden_modules()
    if found:
        _log(f"forbidden modules loaded: {', '.join(found)}")
        return 2
    for name, c in checks.items():
        _log(f"{name} {c['value']} limit {c['limit']}")
    result = {"correct": correct, "attempted": steps,
              "failed": numbers["failed"], "metrics": metrics,
              "device": dict({"platform": "gpu" if cuda else "cpu",
                              "kind": (torch.cuda.get_device_name(0)
                                       if cuda else "cpu"),
                              "count": cell.chips,
                              "memory_peak_bytes": peak}, **device_info)}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

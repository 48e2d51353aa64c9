"""BENCHMARK.json and the data files it names.

Everything that belongs to one configuration, traffic mix, per-layer metric
or kernel layer is a file of its own, found by name under the benchmark's
root, so a later change adds a cell, a metric or a kernel by adding files
and entries and edits none:

- `file` of a configuration (configs/<name>.json): the deployment's
  settings as run;
- benchmark/traffic/<traffic>.json: the parameters the one driver
  (benchmark/driver.py) reads;
- benchmark/metrics/<metric name>.py: a reader with `read(readings)`
  (benchmark/trace.py::Readings) that returns a number or None (the
  arithmetic the readers share is in benchmark/readers.py);
- benchmark/layers/*.json: one kernel layer each, {"layer", "kernels",
  "entries"}: the kernel names the profiler shows and the C entry points
  of the kernel library whose launches the traced run times.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DATA = "benchmark"


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents
    end_to_end: tuple     # metric entries this cell reports untraced
    per_layer: tuple      # metric entries this cell reports traced


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of the manifest, with its data files read."""
    root = Path(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = found[0]
    cfg = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    with open(root / cfg["file"]) as f:
        config = json.load(f)
    with open(root / DATA / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name=name, chips=int(w["chips"]),
                config=config, traffic=traffic,
                end_to_end=tuple(m for m in bench["end_to_end"]
                                 if _applies(m, name)),
                per_layer=tuple(m for m in bench["per_layer"]
                                if _applies(m, name)))


def reader(name: str, root: Path = ROOT):
    """The `read` function of benchmark/metrics/<name>.py."""
    path = Path(root) / DATA / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def layers(root: Path = ROOT) -> dict:
    """{file stem: {"layer", "kernels", "entries"}} of every layer file."""
    out = {}
    for path in sorted((Path(root) / DATA / "layers").glob("*.json")):
        with open(path) as f:
            out[path.stem] = json.load(f)
    return out

"""A throwaway benchmark root for the CPU tests: the repository's
BENCHMARK.json, configurations, metric readers and layer files, with
traffic files cut to a few envs so the port's plain backend and the
reference run in seconds. The check samples every env of these batches,
so a fault in half of a batch shows whatever the window's timing draws."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import manifest

TINY = {
    "chained_move": {"entry": "resident", "envs": 6, "k": 2,
                     "buttons": [0], "in_flight": 2, "checkpoints": 1,
                     "checked_envs": 6, "reference_block": 8},
    "chained_walk": {"entry": "gamestate", "envs": 4, "k": 2,
                     "buttons": [0, 1, 2], "in_flight": 2, "checkpoints": 2,
                     "checked_envs": 4, "reference_block": 3},
    "gym_walk": {"entry": "gym", "envs": 1, "buttons": [0, 1, 2],
                 "in_flight": 0, "checkpoints": 2, "checked_envs": 1,
                 "reference_block": 8},
}


def make_root(tmp: Path, extra_traffic: dict | None = None,
              extra_workloads: list | None = None,
              extra_configs: dict | None = None) -> Path:
    """A copy of the benchmark's data under tmp with TINY traffic, plus
    any extra traffic files, workloads and configurations ({name: (file
    contents, manifest entry)})."""
    root = Path(tmp)
    src = manifest.ROOT
    data = root / "benchmark"
    for sub in ("configs", "metrics", "layers"):
        shutil.copytree(src / "benchmark" / sub, data / sub)
    (data / "traffic").mkdir(parents=True)
    for name, body in dict(TINY, **(extra_traffic or {})).items():
        (data / "traffic" / f"{name}.json").write_text(json.dumps(body))
    bench = manifest.load(src)
    bench["workloads"] = bench["workloads"] + list(extra_workloads or [])
    for name, (body, entry) in (extra_configs or {}).items():
        (data / "configs" / f"{name}.json").write_text(json.dumps(body))
        bench["configs"].append(dict(entry, name=name,
                                     file=f"benchmark/configs/{name}.json"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])

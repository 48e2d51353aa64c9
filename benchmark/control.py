"""Readings that set the check's limits: for each seed, the numbers that
sound runs of the program give (its captured calls against the frozen
reference) and the numbers the control gives (the reference computed in
bfloat16, put in the program's place on the same captured calls). The
benchmark's own runs never run the control.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3
        --seconds <s>

One process sets the kernels up once and runs, for each seed, the cell's
set-up and a window of --seconds at the cell's own size and traffic. Each
seed prints one JSON line {"seed", "program", "control",
"control_fails"}; the last line
gives, per number, the largest program reading and the smallest control
reading, beside the limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

from benchmark import manifest, run


def readings(cell, seed: int, seconds: float, device: str, lib=None):
    """(program numbers, control numbers) of one seed's window."""
    import torch

    from benchmark import check
    d = run.drive(cell, seed, seconds, device, lib)
    resets = d.entry.reset_records
    d.entry.release()
    del d.entry
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    sp = check.spec(cell.config, cell.traffic)
    return (check.judge(sp, resets, d.records, device),
            check.judge(sp, resets, d.records, device, control=True))


def main(argv=None, root: Path = manifest.ROOT, device: str | None = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = manifest.cell(manifest.load(root), args.workload, root)
    run.cache_dirs(Path(root))
    import torch

    from benchmark import check
    if device is None:
        if not run.cuda_ready(torch, cell.chips):
            return 2
        device = "cuda"
    lib, _ = run.load_kernels(device)
    worst_program, least_control = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        prog, ctrl = readings(cell, seed, args.seconds, device, lib)
        fails = any(ctrl[n] > lim for n, lim in check.LIMITS.items())
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl,
                          "control_fails": fails}), flush=True)
        for name in check.LIMITS:
            worst_program[name] = max(worst_program.get(name, 0),
                                      prog[name])
            least_control[name] = min(least_control.get(name, ctrl[name]),
                                      ctrl[name])
    print(json.dumps({name: {"program_max": worst_program[name],
                             "control_min": least_control[name],
                             "limit": lim}
                      for name, lim in check.LIMITS.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

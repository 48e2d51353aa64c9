"""The share of VecEnv.multi_step's batch steps that took the per-step
path (fused_env_step, a GameState each step) rather than the resident
multi-step tick, in %: the port's counters vec.per_step_steps and
vec.resident_steps since the process started (set-up's calls included).
None where the program has no such counters or ran no VecEnv step."""

from agarcl_tpu_torch import profiling


def read(readings):
    counts = profiling.counters()
    per_step = counts.get("vec.per_step_steps")
    resident = counts.get("vec.resident_steps")
    if per_step is None or resident is None or per_step + resident == 0:
        return None
    return 100.0 * per_step / (per_step + resident)

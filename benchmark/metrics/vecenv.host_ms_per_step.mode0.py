"""Host ms per step inside the VecEnv call, in the full-game cell: the
per-step path's conversions, launches and rim
(benchmark/readers.py::vecenv_host_ms_per_step)."""

from benchmark.readers import vecenv_host_ms_per_step as read  # noqa: F401

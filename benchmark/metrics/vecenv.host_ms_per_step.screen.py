"""Host ms per step inside the VecEnv call, in the screen cells
(benchmark/readers.py::vecenv_host_ms_per_step)."""

from benchmark.readers import vecenv_host_ms_per_step as read  # noqa: F401

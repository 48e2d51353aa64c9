"""The gym core's host ms per step beyond its kernels
(benchmark/readers.py::gym_host_ms_per_step)."""

from benchmark.readers import gym_host_ms_per_step as read  # noqa: F401

"""The device's idle share, in the gym cell
(benchmark/readers.py::device_idle_pct)."""

from benchmark.readers import device_idle_pct as read  # noqa: F401

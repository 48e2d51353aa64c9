"""The device's idle share, in the screen cells
(benchmark/readers.py::device_idle_pct)."""

from benchmark.readers import device_idle_pct as read  # noqa: F401

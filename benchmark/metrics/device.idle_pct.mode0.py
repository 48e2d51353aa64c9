"""The device's idle share, in the full-game cell; the per-step path's
PyTorch kernels (conversions, the respawn) count as idle
(benchmark/readers.py::device_idle_pct)."""

from benchmark.readers import device_idle_pct as read  # noqa: F401

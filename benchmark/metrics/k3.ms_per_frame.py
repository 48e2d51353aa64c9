"""K3's device ms per frame of the batch
(benchmark/readers.py::k3_ms_per_frame)."""

from benchmark.readers import k3_ms_per_frame as read  # noqa: F401

"""K3's share of its roofline
(benchmark/readers.py::k3_roofline_pct)."""

from benchmark.readers import k3_roofline_pct as read  # noqa: F401

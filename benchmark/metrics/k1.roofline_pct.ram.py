"""K1's share of its roofline, in the RAM cells
(benchmark/readers.py::k1_roofline_pct)."""

from benchmark.readers import k1_roofline_pct as read  # noqa: F401

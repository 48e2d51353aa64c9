"""K1's share of its roofline, in the full-game cell
(benchmark/readers.py::k1_roofline_pct). The least time counts the
state's bytes and the per-player work of benchmark/roofline.py, not the
cross-player eat tests or the bots' scans, so it is a share of a lower
bound."""

from benchmark.readers import k1_roofline_pct as read  # noqa: F401

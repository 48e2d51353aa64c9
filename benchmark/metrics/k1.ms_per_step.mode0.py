"""K1's device ms per env step, in the full-game cell
(benchmark/readers.py::k1_ms_per_step)."""

from benchmark.readers import k1_ms_per_step as read  # noqa: F401

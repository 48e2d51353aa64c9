"""Part of the benchmark's frozen reference; see the package docstring."""

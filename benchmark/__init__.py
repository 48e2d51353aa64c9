"""The benchmark of agarcl_tpu_torch, the PyTorch and CUDA port (never of
the JAX package): BENCHMARK.json at the repository's root names its
configurations, cells and metrics, and this package runs them.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>
    python3 -m benchmark.control --workload <cell> --seeds 1,2,3
        --seconds <s>
    python3 -m pytest benchmark/tests          (card cases: -m gpu)

run.py sets a cell up, drives it (driver.py) and checks it (check.py,
against the frozen reference in reference/); trace.py, readers.py and
metrics/ give the traced run's per-layer metrics; roofline.py and work.py
the least time of a kernel's work from a cell's shapes. Nothing here
imports JAX or the JAX package, and nothing in reference/ imports the
port.
"""

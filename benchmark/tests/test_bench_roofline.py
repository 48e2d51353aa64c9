"""The roofline counts on known shapes."""

from __future__ import annotations

import pytest

from benchmark import manifest, roofline, work


def test_bound_takes_the_larger_side():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_k1_call_counts_by_hand():
    nbytes, ops = roofline.k1_call(
        n=2, k=3, n_ticks=4, state_bytes=100, agents=1, players=2,
        pellet_capacity=10, actions=True, ram_floats=5, live_pellets=7,
        live_viruses=1)
    # per env: state read and written, 12 action bytes, per step a
    # 5-float frame and two (mass, alive) rows
    assert nbytes == 2 * (200 + 12 + 3 * (20 + 16))
    assert ops == 2 * 3 * (4 * 10 * 6 * 2 + 8 * 1 * (7 + 1))


def test_k3_call_counts_by_hand():
    nbytes, ops = roofline.k3_call(
        n=3, agents=1, players=2, max_cells=16, pellet_capacity=10,
        food_capacity=4, virus_capacity=2, screen_len=8, channels=4)
    assert nbytes == 3 * (2 * 16 * 13 + 40 + 36 + 26 + 8 * 8 * 4)
    assert ops == 3 * (22 * 8 + 64)


@pytest.mark.parametrize("workload,k1_ms,k3_ms", [
    # the port's chip_smoke.py bounds for the same shapes (PERF.md's
    # kernel table): 0.118 ms per k=40 RAM call, K3 0.169 ms per frame
    ("bench_ram.chained", 0.1183, None),
    # task10_duel.chained: k=10 steps a call, 0.02945 and 0.1695 ms a step
    ("task10_duel.chained", 0.2945, 1.695),
])
def test_cell_bounds_match_the_kernel_table(workload, k1_ms, k3_ms):
    cell = manifest.cell(manifest.load(), workload)
    n = 8192            # the kernel table's envs, whatever the cell runs
    assert 1e3 * work.k1_per_call(cell, n) == pytest.approx(k1_ms,
                                                            rel=1e-3)
    if k3_ms is not None:
        assert 1e3 * work.k3_per_call(cell, n) == pytest.approx(k3_ms,
                                                                rel=1e-3)

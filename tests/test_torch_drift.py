"""The port's side of the reference-drift harness (agarcl_tpu_torch/
drift.py) on the CPU: its run_ours equals drift/harness.py::run_ours
(the JAX engine) metric for metric, its recombine probe equals
drift/recombine_probe.py::ours_merge_ticks, and the greedy-chase
scenario holds tests/test_drift.py's bars against the reference engine
(the committed drift/libref.so, loaded as it is)."""

import numpy as np
import pytest
import torch

from agarcl_tpu_torch import drift as TD
from drift import harness
from drift.recombine_probe import ours_merge_ticks

torch.set_num_threads(1)

SEEDS = list(range(1, 13))              # tests/test_drift.py:30-32
STEPS = 120
KS_CRIT = 1.63 * np.sqrt(2 / len(SEEDS))


@pytest.fixture(scope="module")
def ref_available():
    try:
        TD.RefEnv().close()
    except OSError as e:                 # the library does not load here
        pytest.skip(f"drift/libref.so does not load: {e}")
    return True


@pytest.mark.parametrize("policy", ["script", "chase"])
def test_run_ours_matches_jax_harness(policy):
    """4 seeds x 30 steps: per-step masses, virus and food counts and the
    final metrics equal the JAX engine's."""
    ours = TD.run_ours([1, 2, 3, 4], 30, policy=policy, device="cpu")
    want = harness.run_ours([1, 2, 3, 4], 30, policy=policy)
    for o, w in zip(ours, want):
        assert o.keys() == w.keys()
        for k in o:
            np.testing.assert_array_equal(np.asarray(o[k]),
                                          np.asarray(w[k]), err_msg=k)


def test_merge_ticks_match_jax_probe():
    assert TD.merge_ticks(device="cpu") == ours_merge_ticks()


def test_drift_chase_distributions(ref_available):
    """tests/test_drift.py::test_drift_chase_distributions with the port's
    run_ours on the CPU."""
    kw = dict(mode=4, num_pellets=200, num_viruses=2, arena=100)
    ref = TD.run_reference(SEEDS, STEPS, policy="chase", **kw)
    ours = TD.run_ours(SEEDS, STEPS, policy="chase", device="cpu", **kw)
    rows = TD.compare(ref, ours, STEPS)
    for cp in (STEPS // 4 + 1, STEPS // 2 + 1, STEPS):
        r, o = rows[f"mean_mass@{cp}"]
        assert abs(o - r) / r < 0.10, (cp, r, o)
    assert rows["final_mass_ks"] < KS_CRIT, rows["final_mass_ks"]
    r, o = rows["mean_food_eaten"]
    assert abs(o - r) / r < 0.10, (r, o)
    r, o = rows["mean_pellets"]
    assert abs(o - r) / r < 0.05, (r, o)


def test_reference_rows_equal_jax_harness(ref_available):
    """The port's copies of run_reference and compare give the JAX
    harness's rows on the same runs (ks_stat included)."""
    kw = dict(mode=7, num_pellets=100, num_viruses=2, arena=80, num_bots=1)
    ref = TD.run_reference([1, 2, 3], 20, policy="virusfeed", **kw)
    want = harness.run_reference([1, 2, 3], 20, policy="virusfeed", **kw)
    for r, w in zip(ref, want):
        assert r["masses"].tolist() == w["masses"].tolist()
    assert TD.compare(ref, want, 20) == harness.compare(ref, want, 20)


def test_missing_reference_library_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(TD, "REF_LIB", str(tmp_path / "libref.so"))
    monkeypatch.setattr(TD, "_ref_lib", None)
    with pytest.raises(FileNotFoundError, match="libref.so"):
        TD.RefEnv()

"""The program's spans as the benchmark reads them (benchmark/spans.py):
the profiled second's reduction and the readers of METRICS against hand
counts on a synthetic Chrome trace and summary; the existing per-layer
readers against fixed readings; the tool end to end on the CPU; and on the
card, the launch spans' CUDA events against KernelEvents and the gym.step
span against the harness's call span over the same calls."""

from __future__ import annotations

import collections
import json
import statistics

import pytest

from benchmark import driver, manifest, run, spans, trace, work

import bench_tiny

LAYERS = {"k1": {"kernels": ["multi_step_kernel"]},
          "k3": {"kernels": ["screen_kernel"]}}


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _ann(name, t0, t1):
    return _x(name, "user_annotation", t0, t1 - t0)


# One gym step inside the harness's call span, then a launch outside
# every port span: runtime calls at their host times (us), the device
# operations they put on the stream, tied by correlation id.
TRACE = [
    _ann("call", 0, 100), _ann("gym.step", 1, 99),
    _ann("gym.actions", 2, 5), _ann("vec.multi_step", 10, 60),
    _ann("layout.to_kernel", 11, 20), _ann("k1.launch", 21, 30),
    _ann("k3.launch", 31, 40), _ann("rim.finish", 45, 55),
    _ann("gym.fetch", 70, 80), _ann("gym.fetch", 84, 88),
    _ann("gym.fetch", 89, 95), _ann("post", 110, 200),
    _x("cudaLaunchKernel", "cuda_runtime", 12, 2, 1),
    _x("cudaLaunchKernel", "cuda_runtime", 25, 2, 2),
    _x("cuLaunchKernel", "cuda_driver", 35, 2, 3),
    _x("cudaMemsetAsync", "cuda_runtime", 50, 1, 5),
    _x("cudaMemcpyAsync", "cuda_runtime", 72, 1, 4),
    _x("cudaStreamSynchronize", "cuda_runtime", 73, 6, 7),
    _x("cudaMemcpy", "cuda_runtime", 86, 1, 8),
    _x("cudaLaunchKernel", "cuda_runtime", 150, 2, 6),
    _x("elementwise_kernel", "kernel", 200, 1000, 1),
    _x("multi_step_kernel", "kernel", 1300, 5000, 2),
    _x("screen_kernel", "kernel", 6400, 2000, 3),
    _x("Memset (Device)", "gpu_memset", 8500, 250, 5),
    _x("Memcpy DtoH", "gpu_memcpy", 8800, 500, 4),
    _x("elementwise_kernel", "kernel", 9400, 100, 6),
]


def test_port_spans_are_the_programs():
    from agarcl_tpu_torch import profiling
    assert set(spans.PORT_SPANS) == set(profiling.SPANS)
    assert set(profiling.ROOTS) <= set(spans.PORT_SPANS)
    assert spans.LAUNCH_LAYER == {"k1.launch": "k1", "k2.launch": "k2",
                                  "k3.launch": "k3", "k4.launch": "k4"}


def test_reduce_port_by_hand():
    got = spans.reduce_port(TRACE, LAYERS)
    assert got["launches"] == {"layout.to_kernel": 1, "k1.launch": 1,
                               "k3.launch": 1, "rim.finish": 1,
                               "gym.fetch": 1, "none": 1}
    assert got["device_ms"] == pytest.approx({
        "layout.to_kernel": 1.0, "k1.launch": 5.0, "k3.launch": 2.0,
        "rim.finish": 0.25, "gym.fetch": 0.5, "none": 0.1})
    w = got["within"]
    assert w["gym.step"] == pytest.approx({"spans": 1, "launches": 5,
                                           "device_ms": 8.75,
                                           "other_ms": 1.75})
    assert w["vec.multi_step"] == pytest.approx({
        "spans": 1, "launches": 4, "device_ms": 8.25, "other_ms": 1.25})
    assert w["gym.fetch"]["spans"] == 3 and w["gym.fetch"]["launches"] == 1
    assert "vec.reset" not in w and "call" not in w


def _program():
    return {"by_root": {
        "gym.step": {
            "gym.step": {"count": 4, "host_ms": 30.0, "self_ms": 4.0},
            "gym.fetch": {"count": 12, "host_ms": 8.0, "self_ms": 8.0},
            "layout.to_kernel": {"count": 4, "host_ms": 2.0,
                                 "self_ms": 2.0},
            "layout.from_kernel": {"count": 4, "host_ms": 1.2,
                                   "self_ms": 1.2},
            "rim.finish": {"count": 4, "host_ms": 3.0, "self_ms": 2.4}},
        "vec.reset": {"vec.reset": {"count": 3, "host_ms": 99.0,
                                    "self_ms": 9.0}}}}


def test_new_readers_by_hand():
    r = spans.ProgramReadings(k=10, program=_program(), profile=dict(
        spans.reduce_port(TRACE, LAYERS), calls=2))
    got = {n: f(r) for n, f in spans.METRICS.items()}
    assert got == pytest.approx({
        "gym.wait_ms_per_step": 2.0, "gym.layout_ms_per_step": 0.8,
        "gym.rim_ms_per_step": 0.6, "gym.launches_per_step": 5.0,
        "reset.host_ms.ram": 33.0,
        "vecenv.torch_kernel_ms_per_step.screen": 1.25 / 20})
    empty = spans.ProgramReadings(k=10, program={"by_root": {}},
                                  profile={"within": {}, "calls": 0})
    assert all(f(empty) is None for f in spans.METRICS.values())


def _readings(workload, **kw):
    cell = manifest.cell(manifest.load(), workload)
    return trace.Readings(cell=cell, spans={}, **kw)


RAM = dict(entry="resident", envs=8192, k=40, frames=1, calls=10,
           window_s=0.5, layer_ms={"k1": 70.0}, layer_launches={"k1": 10},
           call_s=[0.001] * 10, call_kernel_ms=[7.0] * 10)
SCREEN = dict(entry="gamestate", envs=16384, k=10, frames=1, calls=3,
              window_s=0.06, layer_ms={"k1": 33.0, "k3": 14.4},
              layer_launches={"k1": 30, "k3": 30}, call_s=[0.006] * 3,
              call_kernel_ms=[15.8] * 3)
GYM = dict(entry="gym", envs=1, k=1, frames=1, calls=4, window_s=0.04,
           layer_ms={"k1": 0.4, "k3": 0.2},
           layer_launches={"k1": 4, "k3": 4},
           call_s=[0.008, 0.007, 0.009, 0.006], call_kernel_ms=[0.15] * 4)


def _k1_least(workload, envs, calls):
    return work.k1_per_call(manifest.cell(manifest.load(), workload),
                            envs) * calls


def _k3_least(workload, envs, calls):
    return work.k3_per_call(manifest.cell(manifest.load(), workload),
                            envs) * calls


@pytest.mark.parametrize("metric,workload,kw,want", [
    ("k1.ms_per_step.ram", "bench_ram.chained", RAM, 0.175),
    ("k1.roofline_pct.ram", "bench_ram.chained", RAM,
     lambda: 100 * _k1_least("bench_ram.chained", 8192, 10) / 0.07),
    ("vecenv.host_ms_per_step.ram", "bench_ram.chained", RAM, 0.025),
    ("device.idle_pct.ram", "bench_ram.chained", RAM, 86.0),
    ("k1.ms_per_step.screen", "task10_duel.chained", SCREEN, 1.1),
    ("k1.roofline_pct.screen", "task10_duel.chained", SCREEN,
     lambda: 100 * _k1_least("task10_duel.chained", 16384, 3) / 0.033),
    ("k3.ms_per_frame", "task10_duel.chained", SCREEN, 0.48),
    ("k3.roofline_pct", "task10_duel.chained", SCREEN,
     lambda: 100 * _k3_least("task10_duel.chained", 16384, 3) / 0.0144),
    ("vecenv.host_ms_per_step.screen", "task10_duel.chained", SCREEN, 0.6),
    ("device.idle_pct.screen", "task10_duel.chained", SCREEN, 21.0),
    ("gym.host_ms_per_step", "task10_duel.gym", GYM, 7.35),
    ("device.idle_pct.gym", "task10_duel.gym", GYM, 98.5),
])
def test_existing_readers_on_fixed_readings(metric, workload, kw, want):
    """The accepted readers read what they read: fixed readings, values
    by hand (the roofline shares from benchmark/work.py's least times)."""
    got = manifest.reader(metric)(_readings(workload, **kw))
    assert got == pytest.approx(want() if callable(want) else want)


def test_readings_of_spans_feed_the_existing_readers():
    program = {"calls": 3, "window_s": 0.06, "by_root": {"vec.multi_step": {
        "vec.multi_step": {"count": 3, "host_ms": 18.0, "self_ms": 1.0},
        "k1.launch": {"count": 30, "host_ms": 1.0, "self_ms": 1.0,
                      "device_ms": 33.0}}},
        "summary": {"spans": {
            "vec.multi_step": {"count": 3, "host_ms": 18.0,
                               "self_ms": 1.0, "device_ms": None},
            "k1.launch": {"count": 30, "host_ms": 1.0, "self_ms": 1.0,
                          "device_ms": 33.0},
            "k3.launch": {"count": 30, "host_ms": 1.0, "self_ms": 1.0,
                          "device_ms": 14.4}}}}
    cell = manifest.cell(manifest.load(), "task10_duel.chained")
    r = spans.readings_of_spans(cell, "gamestate", 16384, 10, 1, program)
    assert r.layer_ms == {"k1": 33.0, "k3": 14.4}
    assert r.layer_launches == {"k1": 30, "k3": 30}
    assert r.call_s == pytest.approx([0.006] * 3)
    for metric, want in (("k1.ms_per_step.screen", 1.1),
                         ("k3.ms_per_frame", 0.48),
                         ("vecenv.host_ms_per_step.screen", 0.6),
                         ("device.idle_pct.screen", 21.0)):
        assert manifest.reader(metric)(r) == pytest.approx(want)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny CPU root, with a RAM cell of 4-step episodes so that the
    spans window holds resets."""
    cfg = json.loads((manifest.ROOT / "benchmark" / "configs"
                      / "bench_ram.json").read_text())
    short = {"bench_ram_short": (dict(cfg, number_steps=4), {
        "source": "a throwaway configuration of the test", "reduced": [],
        "why": "episodes of four steps"})}
    cell = {"name": "bench_ram_short.chained", "config": "bench_ram_short",
            "traffic": "chained_move", "chips": 1,
            "why": "a throwaway cell of the test"}
    return bench_tiny.make_root(tmp_path_factory.mktemp("spans"), None,
                                [cell], short)


# On the CPU there is no profiled second, so the metrics read from it
# (gym.launches_per_step, vecenv.torch_kernel_ms_per_step.screen) are None.
@pytest.mark.parametrize("workload,present", [
    ("bench_ram_short.chained", ["reset.host_ms.ram"]),
    ("task10_duel.chained", []),
    ("task10_duel.gym", ["gym.wait_ms_per_step", "gym.layout_ms_per_step",
                         "gym.rim_ms_per_step"]),
])
def test_tool_on_the_cpu(root, workload, present, capsys):
    assert spans.main(["--workload", workload, "--seed", str(2**31 + 9),
                       "--seconds", "0.3", "--rates", "0.1"], root=root,
                      device="cpu") == 0
    res = bench_tiny.last_json(capsys.readouterr().out)
    assert res["device"] == "cpu" and res["events"] == {}
    assert res["profiled"] is None
    for name in present:
        assert res["metrics"][name] is not None, name
    for name in ("gym.launches_per_step",
                 "vecenv.torch_kernel_ms_per_step.screen"):
        assert res["metrics"][name] is None
    saved = json.loads((root / run.OUT / f"spans_{workload}.json")
                       .read_text())
    assert saved["calls"] == res["spans_window"]["calls"] > 0
    root_span = "gym.step" if workload.endswith("gym") else "vec.multi_step"
    assert saved["by_root"][root_span][root_span]["count"] == saved["calls"]
    assert res["span_cost_ns"]["off"] < res["span_cost_ns"]["on"]
    assert set(res["rates"]) == {"off", "on", "on_device_ms", "off_again"}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _card_entry(workload, device):
    import torch
    cell = manifest.cell(manifest.load(), workload)
    entry = driver.make_entry(cell.config, cell.traffic, 12345, device)
    gen = torch.Generator().manual_seed(1)
    entry.setup(lambda: driver.sample_rows(gen, entry.envs, 1).to(device))
    driver.run_window(entry, 0.0, driver.Spans())
    torch.cuda.synchronize()
    return entry


def _state_copy(state):
    """A copy of a VecEnv entry's carrier (K1 updates resident planes in
    place; a GameState is never written)."""
    from agarcl_tpu_torch.ops.fused_step import ResidentState
    if isinstance(state, ResidentState):
        return ResidentState([p.clone() for p in state.raw],
                             state.last_mass.clone(), state.dones.clone())
    return state


def _replay(entry, start, calls: int):
    """`calls` calls of the entry from `start` (carrier, action generator
    state, episode, steps since its reset), then a synchronise; returns
    the last call's rewards."""
    import torch
    state, gen, episode, since = start
    entry.state = _state_copy(state)
    entry.gen.set_state(gen)
    entry.episode, entry.since_reset = episode, since
    for _ in range(calls):
        out = entry.call(entry.draw())
        entry.post(out)
    torch.cuda.synchronize()
    return out[1]


@pytest.mark.gpu
@pytest.mark.parametrize("workload,calls", [("bench_ram.chained", 40),
                                            ("task10_duel.chained", 20)])
def test_card_launch_spans_match_kernel_events(workload, calls, card):
    """The same calls (one start state and action stream, replayed) timed
    by KernelEvents and by the kN.launch spans' CUDA events, in turns
    (events, spans, spans, events) after three seconds of load, so that
    the card's clocks weigh on both alike: the launch counts are equal and
    K1's and K3's device ms agree within 1%. (Both on at once, each pair
    of events would also time the other's two records.)"""
    import torch

    from agarcl_tpu_torch import profiling
    lib, _ = run.load_kernels(card)
    entry = _card_entry(workload, card)
    driver.run_window(entry, 3.0, driver.Spans())
    start = (_state_copy(entry.state), entry.gen.get_state(), entry.episode,
             entry.since_reset)
    ev = collections.defaultdict(float)
    n_ev = collections.Counter()
    got = collections.defaultdict(float)
    n_got = collections.Counter()
    outs = []
    for timer in ("events", "spans", "spans", "events"):
        if timer == "events":
            events = trace.KernelEvents(lib, manifest.layers())
            try:
                outs.append(_replay(entry, start, calls))
            finally:
                events.remove()
            for key, ms in events.times_ms():
                ev[key] += ms
                n_ev[key] += 1
            continue
        profiling.clear()
        profiling.enable(True, device_ms=True)
        try:
            outs.append(_replay(entry, start, calls))
        finally:
            profiling.enable(False)
        for name, s in profiling.summary()["spans"].items():
            if s["device_ms"] is not None:
                got[name] += s["device_ms"]
                n_got[name] += s["count"]
        profiling.clear()
    entry.release()
    assert all(torch.equal(o, outs[0]) for o in outs)     # the same calls
    assert ev["k1"] > 0
    for name, key in (("k1.launch", "k1"), ("k3.launch", "k3")):
        assert n_got[name] == n_ev[key]
        if n_ev[key]:
            assert got[name] == pytest.approx(ev[key], rel=0.01)


@pytest.mark.gpu
def test_card_gym_step_span_matches_call(card):
    """In a spans window the mean gym.step span is within 10% of the
    harness's call span over the same calls."""
    from agarcl_tpu_torch import profiling
    entry = _card_entry("task10_duel.gym", card)
    harness = driver.Spans()
    profiling.clear()
    profiling.enable(True, device_ms=True)
    try:
        win = driver.run_window(entry, 2.0, harness)
    finally:
        profiling.enable(False)
    step = profiling.summary(root="gym.step")["spans"]["gym.step"]
    profiling.clear()
    entry.release()
    assert step["count"] == win.calls
    call_ms = 1e3 * statistics.mean(harness.times["call"])
    assert step["host_ms"] / step["count"] == pytest.approx(call_ms,
                                                            rel=0.10)


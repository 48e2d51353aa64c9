"""The gym core's step as two CUDA graphs (ops/fused_step.py::StepGraphs).

On any machine: a CPU core steps eagerly, and the captured pieces make no
host-to-device copy and no host sync (run on meta tensors under a
TorchFunctionMode that records both). On a card (marker `gpu`): the graphed
core against an eager VecEnv.step loop on the same states and actions, bit
for bit, through a main-player death and respawn, a reset, seed() and a
reloaded snapshot. This file imports no JAX: on the card run it with
`python -m pytest tests/test_torch_gym_graph.py -m gpu --noconftest`.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from agarcl_tpu_torch import EnvConfig, profiling
from agarcl_tpu_torch.gym_core import AgarioCore
from agarcl_tpu_torch.obs.grid import GridObsConfig
from agarcl_tpu_torch.obs.ram import RamObsConfig
from agarcl_tpu_torch.obs.screen import ScreenObsConfig
from agarcl_tpu_torch.ops import fused_step
from agarcl_tpu_torch.state import STATE_FIELDS
from agarcl_tpu_torch.tasks import load_task_core

SMALL = dict(arena_size=120, num_pellets=80, num_viruses=3)
COUNTERS = ("graph_captures", "graph_steps", "eager_steps")


def _counts():
    c = profiling.counters()
    return {n: c[f"fused_step.{n}"] for n in COUNTERS}


def test_cpu_core_steps_eagerly():
    """A CPU core has no graphs: each step counts as eager."""
    core = AgarioCore("ram", device="cpu", mode=4, **SMALL)
    assert core.graphs is None
    core.reset(seed=3)
    c0 = _counts()
    for t in range(3):
        core.step(((0.5, -0.25), t % 3))
    c1 = _counts()
    assert {n: c1[n] - c0[n] for n in COUNTERS} == dict(
        graph_captures=0, graph_steps=0, eager_steps=3)


class _HostTraffic(TorchFunctionMode):
    """Records each call that would copy host data to the device or wait
    for the device, with tensors on `dev` standing for the card's."""

    SYNCS = {"item", "__bool__", "__int__", "__float__", "__index__",
             "tolist", "cpu", "numpy", "nonzero", "masked_select", "unique"}

    def __init__(self, dev):
        super().__init__()
        self.dev = torch.device(dev)
        self.found = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        out = func(*args, **kwargs)
        on_dev = (isinstance(out, torch.Tensor)
                  and out.device.type == self.dev.type)
        src = args[0] if args else kwargs.get("data")
        if name in self.SYNCS:
            self.found.append(name)
        elif name in ("tensor", "as_tensor", "asarray", "to", "cuda") \
                and on_dev and not (isinstance(src, torch.Tensor)
                                    and src.device.type == self.dev.type):
            self.found.append(f"{name} from the host")
        elif name == "copy_" and args[0].device.type == self.dev.type \
                and args[1].device.type != self.dev.type:
            self.found.append("copy_ from the host")
        return out


def test_captured_pieces_copy_nothing_from_the_host():
    """Graph A's and graph B's bodies on meta tensors, after the warm-up:
    no tensor made from host data on the device, no host-to-device copy,
    no host sync. The
    configurations cover the screen's main respawn with a bot (task 10),
    mode 0's respawn of every player and the squared-pellet respawn
    (modes 1 and 2); the mode also sees its own probe fire."""
    probe = "meta"
    cases = [
        (EnvConfig(num_bots=1, mode=10, **SMALL),
         ScreenObsConfig(32, agent_view=True), True),
        (EnvConfig(num_bots=2, mode=0, **SMALL), RamObsConfig(), False),
        (EnvConfig(mode=1, **SMALL), GridObsConfig(grid_size=32), True),
        (EnvConfig(mode=2, num_agents=2, **SMALL), RamObsConfig(), True),
    ]
    for cfg, ocfg, respawn in cases:
        g = fused_step.StepGraphs(cfg, ocfg, 2, probe,
                                  respawn_main_during_obs=respawn)
        g._warm()                         # the warm-up before the capture
        with _HostTraffic(probe) as mode:
            g._in = fused_step._step_in(cfg, g.state)
            g._out()
        assert mode.found == [], (cfg.mode, mode.found)
    with _HostTraffic(probe) as mode:
        torch.as_tensor(7, device=probe)
        g.state.ticks.copy_(torch.zeros(2, dtype=torch.int32))
    assert mode.found == ["as_tensor from the host", "copy_ from the host"]


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _clone(state):
    return state.replace(**{f: getattr(state, f).clone()
                            for f in STATE_FIELDS})


def _make(kind, dev):
    if kind == "screen":
        return load_task_core(10, device=dev)
    world = dict(mode=0, arena_size=200, num_pellets=150, num_viruses=4)
    if kind == "ram":
        return AgarioCore("ram", device=dev, num_bots=1, **world)
    return AgarioCore("grid", device=dev, num_bots=2, grid_size=64,
                      num_frames=2, **world)


def _kill_main(state):
    """The main player's first cell moved onto the first bot's, which
    grows to 4000: the bot eats it in the next step's first tick."""
    s = _clone(state)
    s.cell_pos[:, 0, 0] = s.cell_pos[:, 1, 0]
    s.cell_mass[:, 1, 0] = 4000
    s.cell_alive[:, 0, 1:] = False
    return s


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["screen", "ram", "grid"])
def test_graphed_core_matches_eager_vecenv(cuda_device, kind, tmp_path):
    """300 steps of the graphed core (task 10's duel screen; RAM and a
    two-frame grid in mode 0 with bots) and of its own VecEnv.step on a
    copy of each state with the same actions: every state field, frame,
    reward and done equal; a main-player death and respawn at step 40, a
    reset at 120, seed() at 170, a snapshot saved at 200 and reloaded at
    250; one capture, and every step a graph step."""
    core = _make(kind, cuda_device)
    core.add_noise = False
    assert core.graphs is not None
    c0 = _counts()
    rng = np.random.default_rng(15)
    core.reset(seed=11)
    ref = _clone(core.state)
    snap = str(tmp_path / "snap.json")
    for t in range(300):
        if t == 40:
            core.state = _kill_main(core.state)
            ref = _clone(core.state)
        elif t == 120:
            core.reset(seed=12)
            ref = _clone(core.state)
        elif t == 170:
            core.seed(99)
            ref = ref.replace(seed=torch.full_like(ref.seed, 99))
        elif t == 200:
            core.save_env_state(snap)
        elif t == 250:
            core.load_env_state(snap)
            ref = _clone(core.state)
        act = ((float(rng.uniform(-1, 1)), float(rng.uniform(-1, 1))),
               int(rng.integers(0, 3)))
        acts = core._sanitize_actions(act)[None]
        obs, r, d, _, _ = core.step(act)
        ref, ro, rr, rd = core.venv.step(ref, acts)
        for f in STATE_FIELDS:
            assert torch.equal(getattr(core.state, f), getattr(ref, f)), \
                (t, f)
        np.testing.assert_array_equal(obs, core._post_obs(ro[0])[0],
                                      err_msg=f"step {t}")
        assert np.float32(r) == rr[0, 0].item() and d == rd[0, 0].item(), t
        if t == 40:        # respawned: one fresh 25-mass cell
            assert int(ref.elapsed_ticks[0, 0]) == 0
            assert int(ref.cell_alive[0, 0].sum()) == 1
            assert int(ref.cell_mass[0, 0, 0]) == 25
            assert kind != "screen" or (bool(ref.main_respawned[0]) and d)
    c1 = _counts()
    assert {n: c1[n] - c0[n] for n in COUNTERS} == dict(
        graph_captures=1, graph_steps=300, eager_steps=0)

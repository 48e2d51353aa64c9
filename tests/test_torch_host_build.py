"""The CUDA sources of K1 (csrc/tick.cu), K3 (csrc/screen.cu) and K4
(csrc/grid.cu) compiled as host C++ (every kernel function is __host__
__device__, and without __CUDACC__ the sources build with g++), run frame
by frame with one thread, and held against their plain versions on the
CPU: exact equality of every state plane, every pixel and every frame
value. This checks the kernels' arithmetic and
control flow without a card; the card's own check is `python3
chip_smoke.py`. Skips without g++."""

import ctypes
import dataclasses
import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from agarcl_tpu_torch import EnvConfig
from agarcl_tpu_torch.env import env_reset, reset_seeds
from agarcl_tpu_torch.obs.grid import GridObsConfig
from agarcl_tpu_torch.obs.ram import RamObsConfig
from agarcl_tpu_torch.obs.screen import ScreenObsConfig
from agarcl_tpu_torch.ops import fused_grid as FG
from agarcl_tpu_torch.ops import fused_screen as FS
from agarcl_tpu_torch.ops import fused_tick as FT
from agarcl_tpu_torch.ops import params as KP
from agarcl_tpu_torch.state import zero_state
from agarcl_tpu_torch.vec import VecEnv

CSRC = Path(__file__).resolve().parent.parent / "agarcl_tpu_torch" / "csrc"
HARNESS = r"""
#include <vector>
#include "tick.cu"
#include "screen.cu"
#include "grid.cu"
using namespace agarcl;
extern "C" void host_multi_step(const EnvParams* p, void* const* planes,
                                const float* ax, const float* ay,
                                const int* aact, float* obs, float* info,
                                int N, int n_steps, int n_ticks) {
  const Planes s = planes_from(planes);
  for (int n = 0; n < N; n++)
    multi_step_env(*p, s, n, N, ax, ay, aact, obs, info, n_steps, n_ticks);
}
extern "C" void host_grid(const EnvParams* p, const GridParams* q,
                          void* const* planes, uint8_t* out, int N) {
  const Planes s = planes_from(planes);
  const int G = q->G;
  std::vector<int> hist(G * G);
  std::vector<uint8_t> flags(2 * G);
  std::vector<GridEnt> ents(GRID_MAX_ENTS);
  float cam[3];
  int nent;
  for (int b = 0; b < N * q->A; b++) {
    uint8_t* o = out + (long long)b * q->C * G * G * q->elem;
    if (q->A > 1)
      grid_env<true>(*p, *q, s, b / q->A, b % q->A, N, cam, &nent,
                     flags.data(), hist.data(), ents.data(), o, 0, 1);
    else
      grid_env<false>(*p, *q, s, b, 0, N, cam, &nent, flags.data(),
                      hist.data(), ents.data(), o, 0, 1);
  }
}
extern "C" void host_screen(const EnvParams* p, const ScreenParams* q,
                            void* const* planes, uint8_t* out, int N) {
  const Planes s = planes_from(planes);
  const int S = q->S;
  std::vector<float> tab(6 * S);
  std::vector<uint8_t> flags(2 * S), cls(S * S);
  float cam[4];
  for (int b = 0; b < N * q->A; b++) {
    uint8_t* o = out + (long long)b * S * S * q->C;
    const int n = b / q->A, a = b % q->A;
    auto* env = q->poly ? (q->A > 1 ? screen_env<true, true>
                                    : screen_env<true, false>)
                        : (q->A > 1 ? screen_env<false, true>
                                    : screen_env<false, false>);
    env(*p, *q, s, n, a, N, cam, tab.data(), flags.data(), cls.data(), o, 0,
        1);
  }
}
"""
CFG = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=200,
                num_pellets=150, num_viruses=6, reward_type=True, mode=4)
CFG3 = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=200,
                 num_pellets=150, num_viruses=6, reward_type=True, mode=3)
DUEL = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=200,
                 num_pellets=150, num_viruses=6, mode=7)
AGENTS2 = EnvConfig(num_agents=2, ticks_per_step=4, arena_size=200,
                    num_pellets=150, num_viruses=6, num_bots=1, mode=0)
N = 8


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel sources as host C++")
    d = tmp_path_factory.mktemp("host_kernels")
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libhost.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", f"-I{CSRC}", "-x", "c++", str(d / "harness.cpp"),
                    "-o", str(so)], check=True, capture_output=True,
                   timeout=300)
    lib = ctypes.CDLL(str(so))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.host_multi_step.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32, i32,
                                    i32]
    lib.host_grid.argtypes = [vp, vp, vp, vp, i32]
    lib.host_screen.argtypes = [vp, vp, vp, vp, i32]
    return lib


def _host_steps(lib, cfg, state, acts, k):
    """(planes, obs, info) of k steps of the K1 source on CPU planes, with
    every agent's RAM frame."""
    planes = FT.to_kernel_arrays(state)
    n = state.num_envs
    ax, ay, aact = FT._actions_planes(cfg, acts, n)
    prm = KP.env_params(cfg, RamObsConfig())
    obs = torch.zeros((k, n, cfg.num_agents, prm.R))
    info = torch.zeros((k, n, 2, cfg.num_players))
    lib.host_multi_step(ctypes.byref(prm), FT._ptr_array(planes),
                        ax.data_ptr(), ay.data_ptr(), aact.data_ptr(),
                        obs.data_ptr(), info.data_ptr(), n, k,
                        cfg.ticks_per_step)
    return planes, obs, info


def _assert_same_steps(lib, cfg, state, acts, k):
    got, gobs, ginfo = _host_steps(lib, cfg, state, acts, k)
    want, wobs, winfo = FT.multi_step_raw_plain(
        cfg, FT.to_kernel_arrays(state), acts, k, RamObsConfig())
    names = [name for name, _, _ in FT._plane_specs(cfg)]
    for name, a, b in zip(names, got, want):
        assert torch.equal(a, b), name
    assert torch.equal(ginfo, winfo)
    assert torch.allclose(gobs, wobs, rtol=1e-5, atol=1e-4)
    return got


def _acts(n, seed, agents=1):
    rng = np.random.default_rng(seed)
    a = np.concatenate([rng.uniform(-1, 1, (n, agents, 2)),
                        rng.integers(0, 3, (n, agents, 1))], -1)
    return torch.from_numpy(a.astype(np.float32))


def _eventful(n):
    """Heavy cells at the arena centre, a virus beside half of them."""
    s = env_reset(CFG, reset_seeds(n, 3))
    cm, cp, vp = s.cell_mass.clone(), s.cell_pos.clone(), s.virus_pos.clone()
    cm[:, 0, 0] = 400
    cp[:, 0, 0] = 100.0
    vp[: n // 2, 0] = 103.0
    return s.replace(cell_mass=cm, cell_pos=cp, virus_pos=vp)


@pytest.mark.parametrize("cfg,n_ticks,with_actions", [
    (CFG, 1, False), (CFG, 3, True), (CFG, 3, False), (DUEL, 1, False),
    (AGENTS2, 3, True)])
def test_tick_source_partial_step_matches_plain(host_lib, cfg, n_ticks,
                                                with_actions):
    """K1's partial-step mode (fused_engine_tick's counterpart): null
    action planes skip the action phase, n_ticks ticks run, then the RAM
    frames and info rows; equal to engine_tick_raw_plain on the eventful
    state after two steps (planes and info exact, RAM frames to rtol 1e-5 /
    atol 1e-4)."""
    A = cfg.num_agents
    s = _eventful(N) if cfg is CFG else env_reset(cfg, reset_seeds(N, 4))
    acts = _acts(N, 3, A)
    planes, _, _ = FT.multi_step_raw_plain(cfg, FT.to_kernel_arrays(s), acts,
                                           2, None)
    want = FT.engine_tick_raw_plain(
        cfg, [p.clone() for p in planes], n_ticks, RamObsConfig(),
        acts if with_actions else None)
    prm = KP.env_params(cfg, RamObsConfig())
    obs = torch.zeros((1, N, A, prm.R))
    info = torch.zeros((1, N, 2, cfg.num_players))
    ptr = (lambda t: t.data_ptr() if with_actions else None)
    ax, ay, aact = FT._actions_planes(cfg, acts, N)
    host_lib.host_multi_step(ctypes.byref(prm), FT._ptr_array(planes),
                             ptr(ax), ptr(ay), ptr(aact), obs.data_ptr(),
                             info.data_ptr(), N, 1, n_ticks)
    names = [name for name, _, _ in FT._plane_specs(cfg)]
    for name, a, b in zip(names, planes, want[0]):
        assert torch.equal(a, b), name
    assert torch.equal(info[0], want[2])
    assert torch.allclose(obs[0], want[1], rtol=1e-5, atol=1e-4)


def test_tick_source_matches_plain_on_eventful_steps(host_lib):
    planes = _assert_same_steps(host_lib, CFG, _eventful(N), _acts(N, 0), 4)
    assert int(planes[FT.PLANE_INDEX["viruses_eaten"][0]].sum()) > 0


def test_tick_source_matches_plain_with_equal_ids(host_lib):
    """Two cells of one player share the id 9 (as a hand-made state can):
    both stay in the rank order, both eat a pellet they both reach, a pair
    of equal rank never moves, and a virus pop's new cells (lower ids)
    match both of them at once, as the plain engine's rank rule gives."""
    s = env_reset(CFG3, reset_seeds(N, 2))
    cm, ca = s.cell_mass.clone(), s.cell_alive.clone()
    cid, cp = s.cell_id.clone(), s.cell_pos.clone()
    heavy = torch.arange(N) % 2 == 0
    cm[:, 0, :2] = torch.where(heavy, 20000, 300)[:, None]
    ca[:, 0, 1] = True
    cid[:, 0, :2] = 9
    cp[:, 0, 1, 0] = cp[:, 0, 0, 0] + torch.where(
        torch.arange(N) % 4 < 2, 30.0, 4.0)
    cp[:, 0, 1, 1] = cp[:, 0, 0, 1]
    s = s.replace(cell_alive=ca, cell_mass=cm, cell_id=cid, cell_pos=cp)
    acts = torch.tensor([[[0.6, -0.4, 0.0]]]).expand(N, 1, 3).contiguous()
    planes = _assert_same_steps(host_lib, CFG3, s, acts, 1)
    assert int(planes[FT.PLANE_INDEX["food_eaten"][0]].sum()) > 0


def _crowd(cfg, n, seed):
    """Every player's first cell within 16 of the arena centre at mass
    25-700 (so bots flee and hunt and cells eat each other), a virus
    there too; the rest of a reset world."""
    s = env_reset(cfg, reset_seeds(n, seed))
    g = torch.Generator().manual_seed(seed)
    P = cfg.num_players
    cp, cm = s.cell_pos.clone(), s.cell_mass.clone()
    cp[:, :, 0] = 100.0 + 16.0 * (2 * torch.rand((n, P, 2), generator=g) - 1)
    cm[:, :, 0] = torch.randint(25, 700, (n, P), generator=g,
                                dtype=torch.int32)
    vp = s.virus_pos.clone()
    vp[:, 0] = 100.0
    return s.replace(cell_pos=cp, cell_mass=cm, virus_pos=vp)


def _roster(mode, bots=1, agents=1):
    return EnvConfig(num_agents=agents, ticks_per_step=4, arena_size=200,
                     num_pellets=150, num_viruses=6, num_bots=bots,
                     mode=mode)


@pytest.mark.parametrize("cfg", [
    _roster(7), _roster(8), _roster(9), _roster(10), _roster(0, 4),
    _roster(0, 8), _roster(0, 1, 2)],
    ids=["mode7", "mode8", "mode9", "mode10", "P5", "P9", "2agents"])
def test_tick_source_matches_plain_with_bots(host_lib, cfg):
    """Crowded rosters for 3 steps (bots decide at ticks 0 and 10): cross
    eats, flee, hunt, contested pellets and a virus in the crowd."""
    s = _crowd(cfg, N, cfg.num_players)
    planes = _assert_same_steps(host_lib, cfg, s,
                                _acts(N, 4, cfg.num_agents), 3)
    eaten = planes[FT.PLANE_INDEX["cells_eaten"][0]]
    tx = planes[FT.PLANE_INDEX["target"][0]][cfg.num_agents:]
    assert int(eaten.sum()) > 0
    assert bool((tx != s.target[:, cfg.num_agents:, 0].T).any())


def test_tick_source_matches_plain_on_a_claimed_virus(host_lib):
    """Both duel players reach virus 0, player 1 virus 1 too: player 0's
    claim stands and player 1 gets no event (no fallback to virus 1) in
    the one tick of the step."""
    cfg = dataclasses.replace(_roster(7), ticks_per_step=1)
    s = env_reset(cfg, reset_seeds(N, 5))
    cp, cm = s.cell_pos.clone(), s.cell_mass.clone()
    vp, va = s.virus_pos.clone(), s.virus_alive.clone()
    cp[:, 0, 0] = torch.tensor([100.0, 100.0])
    cp[:, 1, 0] = torch.tensor([101.0, 100.0])
    cm[:, :, 0] = 400
    vp[:, 0], vp[:, 1] = torch.tensor([100.5, 100.0]), torch.tensor([103.0,
                                                                     100.0])
    va[:, :2] = True
    s = s.replace(cell_pos=cp, cell_mass=cm, virus_pos=vp, virus_alive=va)
    acts = torch.zeros((N, 1, 3))
    planes = _assert_same_steps(host_lib, cfg, s, acts, 1)
    ve = planes[FT.PLANE_INDEX["viruses_eaten"][0]]
    assert bool((ve[0] >= 1).all()) and bool((ve[1] == 0).all())


@functools.lru_cache(maxsize=None)
def _grid_states():
    env = VecEnv(CFG, N, "none", backend="torch", device="cpu")
    s0, _ = env.reset(0)
    played, _, _, _ = env.multi_step(s0, _acts(N, 1), 2)
    heavy, _, _, _ = env.multi_step(_eventful(N), _acts(N, 2), 2)
    vp, vm = played.virus_pos.clone(), played.virus_mass.clone()
    vp[:, 1] = vp[:, 0] + 0.01                   # two viruses in one bin
    vm[:, 1] = 150
    cm = played.cell_mass.clone()
    cm[:, 0, 0] = 40000                          # saturates int16 and int8
    z = zero_state(DUEL, N)
    cp, cmm, ca = z.cell_pos.clone(), z.cell_mass.clone(), z.cell_alive.clone()
    cp[:, 0], cp[:, 1] = heavy.cell_pos[:, 0], heavy.cell_pos[:, 0] + 9.0
    cp[:, 1, 1] = cp[:, 1, 0] + 0.01             # others' min below max
    cmm[:, 0], cmm[:, 1] = heavy.cell_mass[:, 0], heavy.cell_mass[:, 0] // 2
    cmm[:, 1, 1] = 40
    ca[:, 0], ca[:, 1] = heavy.cell_alive[:, 0], heavy.cell_alive[:, 0]
    ca[:, 1, 1] = True
    two = z.replace(cell_pos=cp, cell_mass=cmm, cell_alive=ca, **{
        f: getattr(heavy, f) for f in ("pellet_key", "virus_pos",
                                       "virus_mass", "virus_alive")})
    return [(CFG, played.replace(virus_pos=vp, virus_mass=vm, cell_mass=cm)),
            (CFG, heavy), (DUEL, two), (AGENTS2, _two_agents())]


def _two_agents():
    """Two agents and a bot after 3 steps of splits from masses 400-2500:
    every player's camera on its own cells."""
    env = VecEnv(AGENTS2, N, "none", backend="torch", device="cpu")
    s, _ = env.reset(4)
    cm = s.cell_mass.clone()
    cm[:, :, 0] = 400 + 300 * torch.arange(3 * N).reshape(N, 3) % 2100
    s, _, _, _ = env.multi_step(s.replace(cell_mass=cm), _acts(N, 5, 2), 3)
    return s


@pytest.mark.parametrize("grid", [
    GridObsConfig(grid_size=64, out_dtype="int16"),
    GridObsConfig(grid_size=32, out_dtype="int8"),
    GridObsConfig(grid_size=24, out_dtype="int32", observe_cells=False)])
def test_grid_source_matches_plain(host_lib, grid):
    frames = []
    for cfg, s in _grid_states():
        planes = FT.to_kernel_arrays(s)
        want = FG.frame_plain(cfg, grid, planes)
        got = torch.full_like(want, 77)
        host_lib.host_grid(ctypes.byref(KP.env_params(cfg, None)),
                           ctypes.byref(FG.grid_params(cfg, grid)),
                           FT._ptr_array(planes), got.data_ptr(),
                           s.num_envs)
        assert torch.equal(got, want)
        frames.append(want)
    ch = frames[2][:, 0].int()
    assert bool((ch[:, -2] != ch[:, -1]).any())          # others drawn
    assert tuple(want.shape[:2]) == (N, 2)               # one per agent
    assert not torch.equal(want[:, 0], want[:, 1])


@pytest.mark.parametrize("scr", [
    ScreenObsConfig(48, agent_view=True),
    ScreenObsConfig(41, agent_view=False, polygon_edges=True,
                    polygon_virus="circle"),
    ScreenObsConfig(128, agent_view=True, polygon_edges=True,
                    polygon_virus="circle")])
def test_screen_source_matches_plain(host_lib, scr):
    """K3 (circle mode, poly mode) on played, heavy, two-player and
    two-agent states against its plain version: every pixel equal."""
    for cfg, s in _grid_states():
        planes = FT.to_kernel_arrays(s)
        want = FS.frame_plain(cfg, scr, planes)
        got = torch.full_like(want, 77)
        host_lib.host_screen(ctypes.byref(KP.env_params(cfg, None)),
                             ctypes.byref(FS.screen_params(cfg, scr)),
                             FT._ptr_array(planes), got.data_ptr(),
                             s.num_envs)
        assert int((got != want).any(-1).sum()) == 0
    assert tuple(want.shape[:2]) == (N, 2)
    assert not torch.equal(want[:, 0], want[:, 1])

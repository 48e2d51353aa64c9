"""K1's lane-parallel phases (csrc/team.cuh, csrc/tick.cu) and K2's warp
frame (csrc/ram_frame.cuh) compiled as host C++: one thread plays the
warp's 32 lanes in turn, lane 0's items first, with the card's split of
the work and its reductions (int sums, int mins, (bits, index) mins,
ballot prefix ranks). Each case is held bit for bit against the plain
engine on a state built to reach one reduction: a tie for a bot's nearest
pellet, pellets past 512 slots, a regen whose dead slots span several
32-slot chunks, two foods bursting one virus, a pellet within reach of
two ranks and two players, and K2's frames; the food forms of the
virus-pop corner pile against the JAX package. Skips without g++."""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_engine as TE
import test_torch_host_build as HB
from agarcl_tpu_torch import EnvConfig
from agarcl_tpu_torch.bridge import state_from_numpy
from agarcl_tpu_torch.env import env_reset, reset_seeds
from agarcl_tpu_torch.obs.ram import RamObsConfig, ram_frame
from agarcl_tpu_torch.ops import fused_tick as FT
from agarcl_tpu_torch.ops import params as KP
from agarcl_tpu_torch.state import decode_pellet_xy, encode_pellet_key

HARNESS = r"""
#include "tick.cu"
using namespace agarcl;
extern "C" void host_multi_step(const EnvParams* p, void* const* planes,
                                const float* ax, const float* ay,
                                const int* aact, float* obs, float* info,
                                int N, int n_steps, int n_ticks) {
  const Planes s = planes_from(planes);
  for (int n = 0; n < N; n++)
    multi_step_env(*p, s, n, N, ax, ay, aact, obs, info, n_steps, n_ticks);
}
extern "C" void host_ram_frame(const EnvParams* p, void* const* planes,
                               float* out, int N) {
  const Planes s = planes_from(planes);
  for (int n = 0; n < N; n++)
    for (int a = 0; a < p->A; a++)
      ram_frame_host(*p, s, n, N, a, out + ((long long)n * p->A + a) * p->R);
}
"""
CFG = HB.CFG                      # 150 pellet slots: not a multiple of 32
N = 8


@pytest.fixture(scope="module")
def lanes_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel sources as host C++")
    d = tmp_path_factory.mktemp("lane_kernels")
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "liblanes.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", f"-I{HB.CSRC}", "-x", "c++",
                    str(d / "harness.cpp"), "-o", str(so)], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.host_multi_step.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32, i32,
                                    i32]
    lib.host_ram_frame.argtypes = [vp, vp, vp, i32]
    return lib


def _ticks_match_plain(lib, cfg, state, n_ticks=1):
    """n_ticks of the K1 source with no action phase (the partial-step
    chain) against engine_tick_raw_plain: every plane and info row equal.
    Returns the planes."""
    planes = FT.to_kernel_arrays(state)
    want = FT.engine_tick_raw_plain(cfg, FT.to_kernel_arrays(state), n_ticks)
    info = torch.zeros((1, state.num_envs, 2, cfg.num_players))
    lib.host_multi_step(ctypes.byref(KP.env_params(cfg, None)),
                        FT._ptr_array(planes), None, None, None, None,
                        info.data_ptr(), state.num_envs, 1, n_ticks)
    names = [name for name, _, _ in FT._plane_specs(cfg)]
    for name, a, b in zip(names, planes, want[0]):
        assert torch.equal(a, b), name
    assert torch.equal(info[0], want[2])
    return planes


def _plane(cfg, planes, field, axis=0):
    return planes[FT.PLANE_INDEX[field][axis]]


def _pellets(cfg, state, xy):
    """Every pellet slot dead but slot j at xy[j] for each j in xy."""
    key = torch.full_like(state.pellet_key, -1)
    for j, (x, y) in xy.items():
        key[:, j] = encode_pellet_key(cfg, torch.tensor([[x, y]]),
                                      torch.tensor([True]))
    return key


def test_bot_nearest_pellet_tie_takes_the_lowest_slot(lanes_lib):
    """A Hungry bot's centroid exactly 1 from two pellets (slot 37, lane 5,
    and slot 64, lane 0; arena 256 puts pellets on a 1/128 grid, so both
    distances are exact): the lower slot is its target, as the serial
    d < bd walk gives, and a lane-order winner would not."""
    cfg = dataclasses.replace(HB._roster(7), arena_size=256)
    s = env_reset(cfg, reset_seeds(N, 6))
    x0, y0 = 12800.5 / 128, 6400.5 / 128         # a pellet-grid point
    cp, cm, ca = s.cell_pos.clone(), s.cell_mass.clone(), s.cell_alive.clone()
    cp[:, 0, 0] = torch.tensor([200.0, 200.0])   # the agent far away
    ca[:, 1] = False
    ca[:, 1, 0] = True
    cp[:, 1, 0] = torch.tensor([x0, y0])
    cm[:, 1, 0] = 50
    key = _pellets(cfg, s, {64: (x0 - 1.0, y0), 37: (x0 + 1.0, y0)})
    s = s.replace(cell_pos=cp, cell_mass=cm, cell_alive=ca, pellet_key=key,
                  ticks=torch.zeros_like(s.ticks))
    planes = _ticks_match_plain(lanes_lib, cfg, s)
    assert bool((_plane(cfg, planes, "target", 0)[1] == x0 + 1.0).all())
    assert bool((_plane(cfg, planes, "target", 1)[1] == y0).all())


def test_pellets_past_512_slots_match_plain(lanes_lib):
    """Squared pellets (mode 1, arena 300: 600 slots, 19 chunks of 32, the
    last one partial) through 3 whole steps with actions and frames."""
    cfg = dataclasses.replace(CFG, mode=1, arena_size=300)
    assert cfg.pellet_capacity > 512 and cfg.pellet_capacity % 32 != 0
    s = env_reset(cfg, reset_seeds(N, 7))
    cm, cp = s.cell_mass.clone(), s.cell_pos.clone()
    cm[:, 0, 0] = 900
    cp[:, 0, 0] = decode_pellet_xy(cfg, s.pellet_key[:, 550])[0]  # on it
    s = s.replace(cell_mass=cm, cell_pos=cp)
    planes = HB._assert_same_steps(lanes_lib, cfg, s, HB._acts(N, 8), 3)
    eaten = _plane(cfg, planes, "food_eaten")
    assert int(eaten.sum()) > 0


def test_regen_fills_dead_slots_across_chunks(lanes_lib):
    """A regen tick (ticks = 120) with every third slot of 10-139 dead (44
    slots in five 32-slot chunks): the first dead slots in slot order are
    refilled, numbered by ballot prefix ranks chunk by chunk."""
    s = env_reset(CFG, reset_seeds(N, 9))
    key = s.pellet_key.clone()
    key[:, 10:140:3] = -1
    s = s.replace(pellet_key=key, ticks=torch.full_like(s.ticks, 120))
    planes = _ticks_match_plain(lanes_lib, CFG, s)
    pk = _plane(CFG, planes, "pellet_key")
    assert int((pk >= 0).sum()) == CFG.num_pellets * N
    assert not torch.equal(pk[10:140:3], key.T[10:140:3])


def test_two_foods_burst_one_virus_from_the_lowest_food(lanes_lib):
    """Foods 40 and 3 hit virus 0 (6 hits before) in one tick: 8 hits
    burst it, and the new virus takes food 3's pre-deceleration velocity
    (the lowest hitting food, a min over f), not food 40's."""
    s = env_reset(CFG, reset_seeds(N, 10))
    cp = s.cell_pos.clone()
    cp[:, 0, 0] = 30.0
    vp, vh, va = s.virus_pos.clone(), s.virus_hits.clone(), \
        s.virus_alive.clone()
    vp[:, 0] = 150.0
    vh[:, 0] = 6
    fp, fv, fa = s.food_pos.clone(), s.food_vel.clone(), s.food_alive.clone()
    fp[:, 3], fv[:, 3] = torch.tensor([151.0, 150.0]), torch.tensor([-5.0,
                                                                     1.0])
    fp[:, 40], fv[:, 40] = torch.tensor([150.0, 151.0]), torch.tensor([2.0,
                                                                       -7.0])
    fa[:, 3] = fa[:, 40] = True
    s = s.replace(cell_pos=cp, virus_pos=vp, virus_hits=vh, virus_alive=va,
                  food_pos=fp, food_vel=fv, food_alive=fa)
    slot = int((~va[0]).nonzero()[0])
    planes = _ticks_match_plain(lanes_lib, CFG, s)
    assert bool(_plane(CFG, planes, "virus_alive")[slot].all())
    assert bool((_plane(CFG, planes, "virus_vel", 0)[slot] == -5.0).all())
    assert bool((_plane(CFG, planes, "virus_vel", 1)[slot] == 1.0).all())
    assert not bool(_plane(CFG, planes, "food_alive")[[3, 40]].any())


def test_pellet_in_reach_of_two_ranks_and_two_players(lanes_lib):
    """One pellet inside player 0's rank-1 cell and player 1's rank-0 cell
    (cells of two players do not push each other apart): the first eater
    in (pid, rank) order, player 0's rank-1 cell, gains it alone."""
    cfg = HB._roster(7)
    s = env_reset(cfg, reset_seeds(N, 11))
    cp, cm, ca = s.cell_pos.clone(), s.cell_mass.clone(), s.cell_alive.clone()
    cid = s.cell_id.clone()
    cp[:, 0, 0], cp[:, 0, 1] = torch.tensor([40.0, 40.0]), \
        torch.tensor([101.0, 100.0])
    cp[:, 1, 0] = torch.tensor([102.0, 100.5])
    cm[:, :, :2] = 100
    ca[:, 0, 1] = True
    cid[:, 0, 1] = 2
    rec = torch.full_like(s.cell_recombine_at, 10**6)   # no recombining
    key = _pellets(cfg, s, {70: (101.5, 100.0)})
    s = s.replace(cell_pos=cp, cell_mass=cm, cell_alive=ca, cell_id=cid,
                  cell_recombine_at=rec, pellet_key=key,
                  ticks=torch.ones_like(s.ticks))
    planes = _ticks_match_plain(lanes_lib, cfg, s)
    mass = _plane(cfg, planes, "cell_mass")
    assert bool((mass[0] == 100).all()) and bool((mass[1] == 101).all())
    assert bool((mass[16] == 100).all())
    assert bool((_plane(cfg, planes, "pellet_key")[70] == -1).all())


@pytest.mark.parametrize("cfg", [CFG, HB.DUEL, HB.AGENTS2],
                         ids=["one", "duel", "2agents"])
def test_ram_frame_source_matches_plain(lanes_lib, cfg):
    """K2's frame (the warp code K1 also runs) of every (env, agent) on a
    played state, equal to obs/ram.py::ram_frame in every value."""
    env_state = env_reset(cfg, reset_seeds(N, 12))
    planes, _, _ = FT.multi_step_raw_plain(
        cfg, FT.to_kernel_arrays(env_state), HB._acts(N, 13,
                                                       cfg.num_agents), 3,
        None)
    state = FT.from_kernel_arrays(env_state, planes)
    ocfg = RamObsConfig()
    want = ram_frame(cfg, ocfg, state)
    got = torch.full_like(want, 77.0)
    lanes_lib.host_ram_frame(ctypes.byref(KP.env_params(cfg, ocfg)),
                             FT._ptr_array(planes), got.data_ptr(), N)
    assert torch.equal(got, want)


def test_tick_source_food_forms_bit_equal_to_jax(lanes_lib):
    """The K1 source's food positions on the virus-pop corner pile, each
    tick from the same JAX state, bit-equal to
    jax.jit(jax.vmap(engine_tick))'s (the forms of
    tests/test_torch_engine.py's pop-pile test)."""
    cfg = TE._cfgs(4)[1]
    prm = KP.env_params(cfg, None)
    fx, fy = FT.PLANE_INDEX["food_pos"]
    for t, (before, after) in enumerate(TE.pop_pile_ticks(12)):
        planes = FT.to_kernel_arrays(state_from_numpy(TE._fields(before)))
        info = torch.zeros((1, N, 2, 1))
        lanes_lib.host_multi_step(ctypes.byref(prm), FT._ptr_array(planes),
                                  None, None, None, None, info.data_ptr(), N,
                                  1, 1)
        want = np.asarray(after.food_pos)
        np.testing.assert_array_equal(planes[fx].T.numpy(), want[..., 0],
                                      err_msg=f"food x at tick {t}")
        np.testing.assert_array_equal(planes[fy].T.numpy(), want[..., 1],
                                      err_msg=f"food y at tick {t}")

"""The port's CUDA kernels: guards that hold on any machine, and
kernel-against-plain cases that need a CUDA device (marker `gpu`; they skip
without one, and the card's own check is `python3 chip_smoke.py`)."""

import numpy as np
import pytest
import torch

from agarcl_tpu_torch import EnvConfig
from agarcl_tpu_torch.env import env_reset, reset_seeds
from agarcl_tpu_torch.obs.grid import GridObsConfig
from agarcl_tpu_torch.obs.ram import RamObsConfig, ram_frame
from agarcl_tpu_torch.obs.screen import ScreenObsConfig
from agarcl_tpu_torch.ops import _build, fused_obs, fused_step
from agarcl_tpu_torch.ops import fused_grid as FG
from agarcl_tpu_torch.ops import fused_screen as FS
from agarcl_tpu_torch.ops import fused_tick as FT
from agarcl_tpu_torch.state import STATE_FIELDS, zero_state
from agarcl_tpu_torch.vec import VecEnv

CFG = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=200,
                num_pellets=150, num_viruses=6, reward_type=True, mode=4)


@pytest.fixture
def no_build(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library must not be built here")
    monkeypatch.setattr(_build, "load", refuse)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_same_state(a, b):
    """Every field of two GameStates bit-equal."""
    for f in STATE_FIELDS:
        torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0,
                                   atol=0, msg=f)


def _planes(n=4, cfg=CFG):
    return FT.to_kernel_arrays(env_reset(cfg, reset_seeds(n, 0)))


def test_cuda_backend_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        VecEnv(CFG, 4, "ram", backend="cuda")


def test_default_vecenv_runs_on_the_card():
    """The default backend is "cuda" on a CUDA device; without one the
    constructor raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for obs_type in ("screen", "ram"):
        with pytest.raises(RuntimeError, match="CUDA"):
            VecEnv(CFG, 4, obs_type)
    with pytest.raises(RuntimeError, match="CUDA"):
        VecEnv(CFG, 4, "screen", backend="torch")
    env = VecEnv(CFG, 4, "screen", backend="torch", device="cpu")
    assert env.device.type == "cpu"


def test_multi_step_wrapper_validates_before_building(no_build):
    acts = torch.zeros(4, 1, 3)
    planes = _planes()
    bad = list(planes)
    bad[3] = bad[3].float()                      # split_cooldown as f32
    with pytest.raises(TypeError, match="split_cooldown"):
        FT.multi_step_raw(CFG, bad, acts, 1, RamObsConfig())
    bad = list(planes)
    bad[25] = bad[25][:8]                        # pellet_key too short
    with pytest.raises(ValueError, match="pellet_key"):
        FT.multi_step_raw(CFG, bad, acts, 1, RamObsConfig())
    bad = list(planes)
    bad[14] = planes[14].T.contiguous().T        # cell_pos x, strided
    with pytest.raises(ValueError, match="contiguous"):
        FT.multi_step_raw(CFG, bad, acts, 1, RamObsConfig())
    with pytest.raises(ValueError, match="41"):
        FT.multi_step_raw(CFG, planes[:-1], acts, 1, RamObsConfig())
    with pytest.raises(ValueError, match="actions"):
        FT.multi_step_raw(CFG, planes, torch.zeros(3, 1, 3), 1,
                          RamObsConfig())
    with pytest.raises(ValueError):
        FT.multi_step_raw(CFG, planes, acts, 0, RamObsConfig())
    ten = EnvConfig(num_agents=1, arena_size=100, num_pellets=20,
                    num_viruses=2, num_bots=9, mode=0)     # 10 players
    with pytest.raises(NotImplementedError):
        FT.multi_step_raw(ten, _planes(cfg=ten), acts, 1, RamObsConfig())


def test_ram_frame_wrapper_validates_before_building(no_build):
    planes = _planes()
    bad = list(planes)
    bad[21] = bad[21].to(torch.int32)            # cell_alive must be bool
    with pytest.raises(TypeError, match="cell_alive"):
        fused_obs.fused_ram_obs(CFG, RamObsConfig(), bad)
    bad = list(planes)
    bad[14] = torch.zeros(15, 4)                 # 15 cell rows, not 16
    with pytest.raises(ValueError, match="cell_pos"):
        fused_obs.fused_ram_obs(CFG, RamObsConfig(), bad)


def test_cpu_planes_run_the_plain_version(no_build):
    before = FT.launches, FT.plain_calls
    planes, obs, info = FT.multi_step_raw(CFG, _planes(), torch.zeros(4, 1, 3),
                                          2, RamObsConfig())
    assert (FT.launches, FT.plain_calls) == (before[0], before[1] + 1)
    assert tuple(obs.shape) == (2, 4, 1, 231)
    assert tuple(info.shape) == (2, 4, 2, 1)
    assert (info[:, :, 1] == 1.0).all() and (info[:, :, 0] >= 25).all()


def test_screen_wrapper_validates_before_building(no_build):
    planes = _planes()
    scr = ScreenObsConfig(32, agent_view=True)
    bad = list(planes)
    bad[25] = bad[25].float()                    # pellet_key as f32
    with pytest.raises(TypeError, match="pellet_key"):
        FS.fused_screen_frame(CFG, scr, bad)
    bad = list(planes)
    bad[21] = bad[21][:, :2]                     # cell_alive for 2 envs
    with pytest.raises(ValueError, match="cell_alive"):
        FS.fused_screen_frame(CFG, scr, bad)
    with pytest.raises(NotImplementedError):         # the wavy virus rim
        FS.fused_screen_frame(CFG, ScreenObsConfig(32, polygon_edges=True),
                              planes)
    with pytest.raises(NotImplementedError):         # poly beyond S=128
        FS.fused_screen_frame(CFG, ScreenObsConfig(
            160, polygon_edges=True, polygon_virus="circle"), planes)
    with pytest.raises(ValueError, match="polygon_virus"):
        FS.fused_screen_frame(CFG, ScreenObsConfig(
            32, polygon_edges=True, polygon_virus="square"), planes)
    two = EnvConfig(num_agents=2, arena_size=100, num_pellets=20,
                    num_viruses=2, mode=4)
    with pytest.raises(ValueError, match="out"):     # one frame per agent
        FS.fused_screen_frame(two, scr, _planes(cfg=two),
                              out=torch.empty(4, 1, 32, 32, 4,
                                              dtype=torch.uint8))
    assert tuple(FS.fused_screen_frame(two, scr, _planes(cfg=two)).shape) \
        == (4, 2, 32, 32, 4)
    with pytest.raises(ValueError, match="screen_len"):
        FS.fused_screen_frame(CFG, ScreenObsConfig(FS.MAX_SCREEN + 1), planes)
    with pytest.raises(ValueError, match="out"):
        FS.fused_screen_frame(CFG, scr, planes,
                              out=torch.empty(4, 1, 32, 32, 3,
                                              dtype=torch.uint8))


def test_screen_wrapper_cpu_planes_run_the_plain_version(no_build):
    before = FS.launches, FS.plain_calls
    scr = ScreenObsConfig(24, agent_view=False)
    frame = FS.fused_screen_frame(CFG, scr, _planes())
    assert (FS.launches, FS.plain_calls) == (before[0], before[1] + 1)
    assert tuple(frame.shape) == (4, 1, 24, 24, 3)
    out = torch.zeros(4, 1, 24, 24, 3, dtype=torch.uint8)
    assert FS.fused_screen_frame(CFG, scr, _planes(), out=out) is out
    assert torch.equal(out, frame)


def test_grid_wrapper_validates_before_building(no_build):
    planes = _planes()
    grid = GridObsConfig(grid_size=32)
    bad = list(planes)
    vm = FT.PLANE_INDEX["virus_mass"][0]
    bad[vm] = bad[vm].float()                    # virus_mass as f32
    with pytest.raises(TypeError, match="virus_mass"):
        FG.fused_grid_frame(CFG, grid, bad)
    two = EnvConfig(num_agents=2, arena_size=100, num_pellets=20,
                    num_viruses=2, mode=4)
    with pytest.raises(ValueError, match="out"):     # one frame per agent
        FG.fused_grid_frame(two, grid, _planes(cfg=two),
                            out=torch.empty(4, 1, 8, 32, 32,
                                            dtype=torch.int16))
    assert tuple(FG.fused_grid_frame(two, grid, _planes(cfg=two)).shape) \
        == (4, 2, 8, 32, 32)
    with pytest.raises(ValueError, match="grid_size"):
        FG.fused_grid_frame(CFG, GridObsConfig(grid_size=FG.MAX_GRID + 1),
                            planes)
    with pytest.raises(ValueError, match="out_dtype"):
        FG.fused_grid_frame(CFG, GridObsConfig(grid_size=32,
                                               out_dtype="uint8"), planes)
    with pytest.raises(ValueError, match="out"):
        FG.fused_grid_frame(CFG, grid, planes,
                            out=torch.empty(4, 1, 8, 32, 32,
                                            dtype=torch.int32))
    # num_frames > 1 is the partial-step chain now (it used to raise)
    _, obs, _, _ = fused_step.fused_env_step(
        CFG, env_reset(CFG, reset_seeds(4, 0)), torch.zeros(4, 1, 3),
        GridObsConfig(num_frames=2, grid_size=32), num_frames=2)
    assert tuple(obs.shape) == (4, 2, 1, 8, 32, 32)


def test_grid_wrapper_cpu_planes_run_the_plain_version(no_build):
    before = FG.launches, FG.plain_calls
    grid = GridObsConfig(grid_size=24, out_dtype="int8",
                         observe_others=False)
    frame = FG.fused_grid_frame(CFG, grid, _planes())
    assert (FG.launches, FG.plain_calls) == (before[0], before[1] + 1)
    assert tuple(frame.shape) == (4, 1, 6, 24, 24)
    assert frame.dtype == torch.int8
    out = torch.zeros(4, 1, 6, 24, 24, dtype=torch.int8)
    assert FG.fused_grid_frame(CFG, grid, _planes(), out=out) is out
    assert torch.equal(out, frame)


def _assert_same_steps(got, want):
    """(states, obs, rewards, dones) of two step runs, bit-equal."""
    (gs, go, gr, gd), (ws, wo, wr, wd) = got, want
    _assert_same_state(gs, ws)
    assert go.shape == wo.shape and torch.equal(go, wo)
    torch.testing.assert_close(gr, wr, rtol=0, atol=0)
    assert torch.equal(gd, wd)


def _step_compositions_match_plain(dev, n, obs_type="screen"):
    """The kernel path's step compositions on `dev` against the plain torch
    backend: multi_step_resident's frame loop (k x (tick with k=1, then the
    screen or grid frame); stacked and tuple frames) in mode 4, and
    fused_env_step with auto_reset and respawn_main_during_obs in mode 3,
    from a state with dead main players (respawned, charged c_death) and
    players over the mode's mass limit (done, then reset in place)."""
    if obs_type == "screen":
        scr, mod, shape = ScreenObsConfig(32, agent_view=True), FS, (32, 32, 4)
    else:
        scr, mod = GridObsConfig(grid_size=32, out_dtype="int16"), FG
        shape = (8, 32, 32)
    acts = torch.tensor([[[0.6, -0.4, 0.0]]], device=dev).expand(n, 1, 3)
    s0 = env_reset(CFG, reset_seeds(n, 1, dev))
    plain = VecEnv(CFG, n, obs_type, backend="torch", device=dev,
                   obs_config=scr)
    for stack in (True, False):
        want = plain.multi_step(s0, acts, 3, stack_obs=stack)
        k1, k3 = FT.launches + FT.plain_calls, mod.launches + mod.plain_calls
        res, obs, r, d = fused_step.multi_step_resident(
            CFG, fused_step.to_resident(CFG, s0), acts, 3, scr,
            stack_obs=stack)
        assert (FT.launches + FT.plain_calls - k1,
                mod.launches + mod.plain_calls - k3) == (3, 3)
        if not stack:
            assert isinstance(obs, tuple) and len(obs) == 3
            obs, want = torch.stack(obs), (want[0], torch.stack(want[1]),
                                           *want[2:])
        assert tuple(obs.shape) == (3, n, 1, 1) + shape
        _assert_same_steps((fused_step.from_resident(CFG, res), obs, r, d),
                           want)
    cfg3 = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=200,
                     num_pellets=150, num_viruses=6, reward_type=True, mode=3,
                     c_death=-7)
    s = env_reset(cfg3, reset_seeds(n, 2, dev))
    ca, cm = s.cell_alive.clone(), s.cell_mass.clone()
    cid, cp = s.cell_id.clone(), s.cell_pos.clone()
    ca[:2] = False
    cm[2, 0, :2], ca[2, 0, 1], cid[2, 0, 1] = 20000, True, 9
    cp[2, 0, 1] = cp[2, 0, 0] + torch.tensor([30.0, 0.0], device=dev)
    nid = s.next_cell_id.clone()
    nid[2] = 10
    s = s.replace(cell_alive=ca, cell_mass=cm, cell_id=cid, cell_pos=cp,
                  next_cell_id=nid)
    plain = VecEnv(cfg3, n, obs_type, backend="torch", device=dev,
                   obs_config=scr, auto_reset=True,
                   respawn_main_during_obs=True)
    want = plain.multi_step(s, acts, 2)
    outs = []
    for _ in range(2):
        s, *out = fused_step.fused_env_step(cfg3, s, acts, scr, 1, True, True)
        outs.append(out)
    got = (s, *(torch.stack(x) for x in zip(*outs)))
    _assert_same_steps(got, want)
    assert (want[2][0, :2] > 0).all() and bool(want[3][0, 2, 0])
    assert int(want[0].ticks[2]) == 4 and int(want[0].ticks[3]) == 8


def test_step_compositions_on_cpu_planes_match_plain(no_build):
    _step_compositions_match_plain(torch.device("cpu"), 4)


def test_grid_step_compositions_on_cpu_planes_match_plain(no_build):
    _step_compositions_match_plain(torch.device("cpu"), 4, "grid")


@pytest.mark.parametrize("kind", ["screen", "grid", "tick"])
def test_launch_params_are_cached_per_config(no_build, kind):
    """The launch paths build their parameter blocks once per
    configuration: a cached block equals a freshly built one byte for byte,
    equal configs share one block, and a changed config (arena, screen or
    grid size, dtype, agents, RAM frame) gets a block of its own."""
    from agarcl_tpu_torch.ops import params as KP
    two = EnvConfig(num_agents=2, ticks_per_step=4, arena_size=300,
                    num_pellets=150, num_viruses=6, num_bots=1, mode=0)
    if kind == "screen":
        a, b = ScreenObsConfig(64), ScreenObsConfig(96, agent_view=False)
        mod, fresh = FS, FS.screen_params
    elif kind == "grid":
        a, b = GridObsConfig(grid_size=32), GridObsConfig(grid_size=32,
                                                          out_dtype="int8")
        mod, fresh = FG, FG.grid_params
    else:
        a, b = None, RamObsConfig(num_pellets=8)
    for cfg in (CFG, two):
        for oc in (a, b):
            if kind == "tick":
                got = (KP.launch_env_params(cfg, oc),)
                want = (KP.env_params(cfg, oc),)
                again = (KP.launch_env_params(cfg, oc),)
            else:
                got = mod.launch_params(cfg, oc)
                want = (KP.env_params(cfg, None), fresh(cfg, oc))
                again = mod.launch_params(cfg, oc)
            assert [bytes(x) for x in got] == [bytes(x) for x in want]
            assert all(x is y for x, y in zip(got, again))
    if kind == "tick":
        blocks = {id(KP.launch_env_params(c, o)) for c in (CFG, two)
                  for o in (a, b)}
        assert len(blocks) == 4
        assert bytes(KP.launch_env_params(CFG, a)) != bytes(
            KP.launch_env_params(two, a))
    else:
        q = {id(mod.launch_params(c, o)[1]) for c in (CFG, two)
             for o in (a, b)}
        assert len(q) == 4
        assert bytes(mod.launch_params(CFG, a)[1]) != bytes(
            mod.launch_params(CFG, b)[1])
        assert bytes(mod.launch_params(CFG, a)[1]) != bytes(
            mod.launch_params(two, a)[1])


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load()
    assert not (tmp_path / "build").exists()


# ----------------------------------------------------------- on the card
def _eventful_state(n, dev):
    s = env_reset(CFG, reset_seeds(n, 3, dev))
    cm = s.cell_mass.clone()
    cm[:, 0, 0] = 400
    cp = s.cell_pos.clone()
    cp[:, 0, 0] = 100.0
    vp = s.virus_pos.clone()
    vp[: n // 2, 0] = 103.0
    return s.replace(cell_mass=cm, cell_pos=cp, virus_pos=vp)


def _two_player_state(s):
    """Mode-7 layout (two players): player 1 a shifted half-mass copy of
    player 0 of s, the world of s."""
    duel = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=200,
                     num_pellets=150, num_viruses=6, mode=7)
    z = zero_state(duel, s.num_envs, s.device)
    cp, cm, ca = z.cell_pos.clone(), z.cell_mass.clone(), z.cell_alive.clone()
    cp[:, 0] = s.cell_pos[:, 0]
    cp[:, 1] = s.cell_pos[:, 0] + torch.tensor([12.0, -7.0], device=s.device)
    cm[:, 0], cm[:, 1] = s.cell_mass[:, 0], s.cell_mass[:, 0] // 2
    ca[:, 0], ca[:, 1] = s.cell_alive[:, 0], s.cell_alive[:, 0]
    world = {f: getattr(s, f) for f in ("pellet_key", "virus_pos",
                                        "virus_mass", "virus_alive")}
    return duel, z.replace(cell_pos=cp, cell_mass=cm, cell_alive=ca, **world)


@pytest.mark.gpu
def test_ram_frame_kernel_matches_plain(cuda_device):
    s = _eventful_state(512, cuda_device)
    before = fused_obs.launches
    got = fused_obs.fused_ram_obs(CFG, RamObsConfig(), FT.to_kernel_arrays(s))
    assert fused_obs.launches == before + 1
    torch.testing.assert_close(got, ram_frame(CFG, RamObsConfig(), s),
                               rtol=0, atol=0)


@pytest.mark.gpu
def test_multi_step_kernel_matches_plain(cuda_device):
    s = _eventful_state(512, cuda_device)
    rng = np.random.default_rng(0)
    acts = torch.from_numpy(np.concatenate(
        [rng.uniform(-1, 1, (512, 1, 2)), rng.integers(0, 3, (512, 1, 1))],
        -1).astype(np.float32)).to(cuda_device)
    rk = fused_step.to_resident(CFG, s)
    rp = fused_step.to_resident(CFG, s)
    before = FT.launches
    rk, ok, rwk, dk = fused_step.multi_step_resident(CFG, rk, acts, 8,
                                                     RamObsConfig())
    rp, op, rwp, dp = fused_step.multi_step_resident(
        CFG, rp, acts, 8, RamObsConfig(), plain=True)
    assert FT.launches == before + 1
    sk, sp = fused_step.from_resident(CFG, rk), fused_step.from_resident(CFG,
                                                                          rp)
    _assert_same_state(sk, sp)
    assert int(sk.viruses_eaten.sum()) > 0
    torch.testing.assert_close(ok, op, rtol=0, atol=0)
    torch.testing.assert_close(rwk, rwp, rtol=0, atol=0)
    assert torch.equal(dk, dp)


@pytest.mark.gpu
@pytest.mark.parametrize("scr", [ScreenObsConfig(128, agent_view=True),
                                 ScreenObsConfig(84, agent_view=False)])
def test_screen_kernel_matches_plain(cuda_device, scr):
    heavy = _eventful_state(512, cuda_device)
    cases = [(CFG, heavy), _two_player_state(heavy)]
    for cfg, s in cases:
        planes = FT.to_kernel_arrays(s)
        before = FS.launches
        got = FS.fused_screen_frame(cfg, scr, planes)
        assert FS.launches == before + 1
        want = FS.frame_plain(cfg, scr, planes)
        assert int((got != want).any(-1).sum()) == 0
    assert bool((want[..., 1] == 255).any())           # class 5 drawn


@pytest.mark.gpu
def test_step_compositions_on_the_card_match_plain(cuda_device):
    launches = FT.launches, FS.launches
    _step_compositions_match_plain(cuda_device, 512)
    assert (FT.launches - launches[0], FS.launches - launches[1]) == (8, 8)


def _equal_id_state(n, dev):
    """Mode-3 states in which the player's two cells share the id 9, as a
    hand-made state can: 20000-mass pairs 30 or 4 apart (one pellet inside
    both), and 300-mass pairs."""
    s = env_reset(CFG3, reset_seeds(n, 2, dev))
    cm, ca = s.cell_mass.clone(), s.cell_alive.clone()
    cid, cp = s.cell_id.clone(), s.cell_pos.clone()
    heavy = torch.arange(n, device=dev) % 2 == 0
    cm[:, 0, :2] = torch.where(heavy, 20000, 300)[:, None]
    ca[:, 0, 1] = True
    cid[:, 0, :2] = 9
    dx = torch.where(torch.arange(n, device=dev) % 4 < 2, 30.0, 4.0)
    cp[:, 0, 1, 0] = cp[:, 0, 0, 0] + dx
    cp[:, 0, 1, 1] = cp[:, 0, 0, 1]
    return s.replace(cell_alive=ca, cell_mass=cm, cell_id=cid, cell_pos=cp)


CFG3 = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=200,
                 num_pellets=150, num_viruses=6, reward_type=True, mode=3)


@pytest.mark.gpu
def test_per_step_frames_drawn_in_place_on_the_card(cuda_device):
    """VecEnv's per-step path (auto_reset, mode 3, a quarter of the envs
    over the mass limit, so done and reset in the first step) on the card:
    multi_step's frames, each step's drawn into its slice of one buffer a
    call, equal k single steps' stacked, with the same states, rewards and
    dones; vec.frames_in_place_steps grows by k a stacked call and not with
    stack_obs=False (step, and multi_step's k-tuple)."""
    from agarcl_tpu_torch import vec
    n, k = 512, 3
    env = VecEnv(CFG3, n, "screen", obs_config=ScreenObsConfig(
        32, agent_view=True), auto_reset=True)
    s0, _ = env.reset(4)
    heavy = torch.arange(n, device=cuda_device) % 4 == 0
    cm, ca = s0.cell_mass.clone(), s0.cell_alive.clone()
    cid, cp = s0.cell_id.clone(), s0.cell_pos.clone()
    nid = s0.next_cell_id.clone()
    cm[heavy, 0, :2], ca[heavy, 0, 1], cid[heavy, 0, 1] = 20000, True, 9
    cp[heavy, 0, 1] = cp[heavy, 0, 0] + torch.tensor([30.0, 0.0],
                                                     device=cuda_device)
    nid[heavy] = 10
    s0 = s0.replace(cell_mass=cm, cell_alive=ca, cell_id=cid, cell_pos=cp,
                    next_cell_id=nid)
    acts = torch.tensor([[[0.6, -0.4, 0.0]]], device=cuda_device).expand(
        n, 1, 3)
    before = vec.frames_in_place_steps
    got = env.multi_step(s0, acts, k)
    assert vec.frames_in_place_steps == before + k
    s, steps = s0, []
    for _ in range(k):
        s, *out = env.step(s, acts)
        steps.append(out)
    tup = env.multi_step(s0, acts, k, stack_obs=False)[1]
    assert vec.frames_in_place_steps == before + k
    _assert_same_steps(got, (s, *(torch.stack(x) for x in zip(*steps))))
    assert torch.equal(got[1], torch.stack(tup))
    assert bool(got[3][0][heavy, 0].all())


@pytest.mark.gpu
def test_multi_step_kernel_matches_plain_with_equal_ids(cuda_device):
    """K1 keeps both cells of one id in its rank order, lets both eat a
    pellet they both reach (as the plain engine's rank rule does) and
    never moves a pair of equal rank."""
    s = _equal_id_state(512, cuda_device)
    acts = torch.tensor([[[0.6, -0.4, 0.0]]],
                        device=cuda_device).expand(512, 1, 3)
    before = FT.launches
    rk, ok, rwk, dk = fused_step.multi_step_resident(
        CFG3, fused_step.to_resident(CFG3, s), acts, 1, None)
    rp, op, rwp, dp = fused_step.multi_step_resident(
        CFG3, fused_step.to_resident(CFG3, s), acts, 1, None,
        plain=True)
    assert FT.launches == before + 1
    sk, sp = (fused_step.from_resident(CFG3, rk),
              fused_step.from_resident(CFG3, rp))
    _assert_same_state(sk, sp)
    torch.testing.assert_close(rwk, rwp, rtol=0, atol=0)
    assert int(sk.food_eaten.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [
    GridObsConfig(grid_size=64, out_dtype="int16"),
    GridObsConfig(grid_size=128, out_dtype="int32", observe_pellets=False)])
def test_grid_kernel_matches_plain(cuda_device, grid):
    heavy = _eventful_state(512, cuda_device)
    cm = heavy.cell_mass.clone()
    cm[:8, 0, 0] = 40000                         # saturates int16
    cases = [(CFG, heavy.replace(cell_mass=cm)), _two_player_state(heavy)]
    for cfg, s in cases:
        planes = FT.to_kernel_arrays(s)
        before = FG.launches
        got = FG.fused_grid_frame(cfg, grid, planes)
        assert FG.launches == before + 1
        want = FG.frame_plain(cfg, grid, planes)
        assert got.dtype == want.dtype and int((got != want).sum()) == 0
    assert bool((want[:, 0, -1] > 0).any())            # others drawn


@pytest.mark.gpu
def test_grid_step_compositions_on_the_card_match_plain(cuda_device):
    launches = FT.launches, FG.launches
    _step_compositions_match_plain(cuda_device, 512, "grid")
    assert (FT.launches - launches[0], FG.launches - launches[1]) == (8, 8)


# ------------------------------------------------------- rosters with bots
def _roster(mode, bots=1, agents=1):
    return EnvConfig(num_agents=agents, ticks_per_step=4, arena_size=200,
                     num_pellets=150, num_viruses=6, num_bots=bots,
                     mode=mode)


ROSTERS = {"mode7": _roster(7), "mode10": _roster(10), "P5": _roster(0, 4),
           "P9": _roster(0, 8), "2agents": _roster(0, 1, 2)}


def _crowd_state(cfg, n, dev, seed=0):
    """Every player's first cell within 16 of the arena centre at mass
    25-700 and a virus there: bots flee and hunt, cells eat each other."""
    s = env_reset(cfg, reset_seeds(n, seed, dev))
    g = torch.Generator().manual_seed(seed)
    P = cfg.num_players
    cp, cm = s.cell_pos.clone(), s.cell_mass.clone()
    cp[:, :, 0] = (100.0 + 16.0 * (2 * torch.rand((n, P, 2), generator=g)
                                   - 1)).to(dev)
    cm[:, :, 0] = torch.randint(25, 700, (n, P), generator=g,
                                dtype=torch.int32).to(dev)
    vp = s.virus_pos.clone()
    vp[:, 0] = 100.0
    return s.replace(cell_pos=cp, cell_mass=cm, virus_pos=vp)


def _roster_acts(cfg, n, dev):
    rng = np.random.default_rng(1)
    a = np.concatenate([rng.uniform(-1, 1, (n, cfg.num_agents, 2)),
                        rng.integers(0, 3, (n, cfg.num_agents, 1))], -1)
    return torch.from_numpy(a.astype(np.float32)).to(dev)


def test_roster_planes_run_the_plain_version(no_build):
    """Two agents and a bot on CPU planes: one RAM frame per agent, one
    (mass, alive) column per player."""
    cfg = ROSTERS["2agents"]
    before = FT.launches, FT.plain_calls
    planes, obs, info = FT.multi_step_raw(
        cfg, FT.to_kernel_arrays(_crowd_state(cfg, 4, torch.device("cpu"))),
        torch.zeros(4, 2, 3), 2, RamObsConfig())
    assert (FT.launches, FT.plain_calls) == (before[0], before[1] + 1)
    assert tuple(obs.shape) == (2, 4, 2, 239)
    assert tuple(info.shape) == (2, 4, 2, 3)


def _ram_step_composition_matches_plain(dev, n):
    """Mode 0 with 4 bots and RAM frames: fused_env_step (respawn_all after
    a forced cross-eat) against the plain torch backend's per-step path."""
    cfg = ROSTERS["P5"]
    s = _crowd_state(cfg, n, dev, 3)
    cp, cm = s.cell_pos.clone(), s.cell_mass.clone()
    cp[:, 0, 0], cm[:, 0, 0] = cp[:, 1, 0], 900
    s = s.replace(cell_pos=cp, cell_mass=cm)
    acts = _roster_acts(cfg, n, dev)
    want = VecEnv(cfg, n, "ram", backend="torch", device=dev).multi_step(
        s, acts, 2)
    outs = []
    for _ in range(2):
        s, *out = fused_step.fused_env_step(cfg, s, acts, RamObsConfig())
        outs.append(out)
    got = (s, *(torch.stack(x) for x in zip(*outs)))
    _assert_same_state(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    assert torch.equal(got[3], want[3])
    assert int(want[0].cells_eaten.sum()) >= n
    assert bool(want[0].player_alive().all())            # respawned


def test_ram_step_composition_on_cpu_planes_matches_plain(no_build):
    _ram_step_composition_matches_plain(torch.device("cpu"), 4)


@pytest.mark.gpu
def test_ram_step_composition_on_the_card_matches_plain(cuda_device):
    before = FT.launches
    _ram_step_composition_matches_plain(cuda_device, 512)
    assert FT.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(ROSTERS))
def test_multi_step_kernel_matches_plain_with_bots(cuda_device, name):
    """K1 on crowded rosters (bot decisions, cross-player eating, contested
    pellets and viruses) against the plain engine after one step and
    after four: RAM frames, rewards, dones and integer state bit-equal."""
    cfg, n = ROSTERS[name], 512
    s = _crowd_state(cfg, n, cuda_device)
    acts = _roster_acts(cfg, n, cuda_device)
    for k in (1, 4):
        before = FT.launches
        rk, ok, rwk, dk = fused_step.multi_step_resident(
            cfg, fused_step.to_resident(cfg, s), acts, k, RamObsConfig())
        rp, op, rwp, dp = fused_step.multi_step_resident(
            cfg, fused_step.to_resident(cfg, s), acts, k, RamObsConfig(),
            plain=True)
        assert FT.launches == before + 1
        sk, sp = (fused_step.from_resident(cfg, rk),
                  fused_step.from_resident(cfg, rp))
        _assert_same_state(sk, sp)
        torch.testing.assert_close(ok, op, rtol=0, atol=0)
        torch.testing.assert_close(rwk, rwp, rtol=0, atol=0)
        assert torch.equal(dk, dp)
    assert int(sp.cells_eaten.sum()) > 0


# ----------------------------------------------- polygon screens, agents
POLY = [ScreenObsConfig(128, agent_view=True, polygon_edges=True,
                        polygon_virus="circle"),
        ScreenObsConfig(84, agent_view=False, polygon_edges=True,
                        polygon_virus="circle")]


@pytest.mark.gpu
@pytest.mark.parametrize("scr", POLY)
def test_screen_kernel_matches_plain_in_poly_mode(cuda_device, scr):
    """K3's fans (5-gon pellets, 7-gon foods, 50-gon cells) against the
    plain version on a heavy-cell and a two-player state: 0 pixels
    differ."""
    heavy = _eventful_state(512, cuda_device)
    for cfg, s in [(CFG, heavy), _two_player_state(heavy)]:
        planes = FT.to_kernel_arrays(s)
        before = FS.launches, FS.plain_calls
        got = FS.fused_screen_frame(cfg, scr, planes)
        assert (FS.launches, FS.plain_calls) == (before[0] + 1, before[1])
        want = FS.frame_plain(cfg, scr, planes)
        assert int((got != want).any(-1).sum()) == 0
    circle = FS.frame_plain(cfg, ScreenObsConfig(
        scr.screen_len, agent_view=scr.agent_view), planes)
    assert int((circle != want).any(-1).sum()) > 0      # the fans differ


@pytest.mark.gpu
def test_frame_kernels_match_plain_at_two_agents(cuda_device):
    """Two agents and a bot: K3 (circle and poly) and K4 draw one frame per
    (env, agent), each equal to the plain version's."""
    cfg = ROSTERS["2agents"]
    planes = FT.to_kernel_arrays(_crowd_state(cfg, 512, cuda_device))
    for ocfg, mod, wrapper in (
            (ScreenObsConfig(128, agent_view=True), FS,
             FS.fused_screen_frame),
            (POLY[0], FS, FS.fused_screen_frame),
            (GridObsConfig(grid_size=64, out_dtype="int16"), FG,
             FG.fused_grid_frame)):
        before = mod.launches
        got = wrapper(cfg, ocfg, planes)
        assert mod.launches == before + 1 and got.shape[1] == 2
        want = mod.frame_plain(cfg, ocfg, planes)
        assert got.shape == want.shape and torch.equal(got, want)
        assert not torch.equal(got[:, 0], got[:, 1])    # two cameras


def test_engine_tick_wrapper_validates_before_building(no_build):
    """K1's partial-step wrapper checks its arguments first, and on CPU
    planes runs its plain version (no build, no launch)."""
    planes = _planes()
    with pytest.raises(ValueError, match="n_ticks"):
        FT.engine_tick_raw(CFG, planes, -1)
    with pytest.raises(ValueError, match="actions"):
        FT.engine_tick_raw(CFG, planes, 1, actions=torch.zeros(3, 1, 3))
    ten = EnvConfig(num_agents=1, num_bots=9, mode=0)
    with pytest.raises(NotImplementedError):
        FT.engine_tick_raw(ten, _planes(cfg=ten), 1)
    before = FT.launches, FT.tick_launches, FT.plain_calls
    got = FT.engine_tick_raw(CFG, planes, 2, RamObsConfig(),
                             torch.zeros(4, 1, 3))
    assert (FT.launches, FT.tick_launches) == before[:2]
    assert FT.plain_calls == before[2] + 1
    want = FT.engine_tick_raw_plain(CFG, _planes(), 2, RamObsConfig(),
                                    torch.zeros(4, 1, 3))
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.gpu
@pytest.mark.parametrize("n_ticks,with_actions,players", [
    (1, False, 1), (3, True, 1), (3, False, 2), (1, True, 9)])
def test_partial_step_kernel_matches_plain(cuda_device, n_ticks,
                                           with_actions, players):
    """K1 in partial-step mode (null action planes or actions, n ticks)
    against engine_tick_raw_plain: state, RAM frames and info rows
    bit-equal."""
    cfg = {1: CFG, 2: ROSTERS["mode7"], 9: ROSTERS["P9"]}[players]
    n = 512
    s = (_eventful_state(n, cuda_device) if players == 1
         else _crowd_state(cfg, n, cuda_device))
    acts = (_roster_acts(cfg, n, cuda_device) if with_actions else None)
    before = FT.tick_launches
    pk, ok, ik = FT.engine_tick_raw(cfg, FT.to_kernel_arrays(s), n_ticks,
                                    RamObsConfig(), acts)
    pp, op, ip = FT.engine_tick_raw_plain(cfg, FT.to_kernel_arrays(s),
                                          n_ticks, RamObsConfig(), acts)
    assert FT.tick_launches == before + 1
    sk = FT.from_kernel_arrays(s, pk)
    sp = FT.from_kernel_arrays(s, pp)
    _assert_same_state(sk, sp)
    torch.testing.assert_close(ok, op, rtol=0, atol=0)
    assert torch.equal(ik, ip)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["screen", "grid"])
def test_multi_frame_paths_on_the_card_match_plain(cuda_device, kind):
    """num_frames = 4 (every tick of a 4-tick step framed) through K1's
    partial-step mode and K3 / K4, against the torch backend: frames,
    rewards and dones bit-equal; K1 and the frame kernel 4 launches a
    step."""
    n = 512
    ocfg = (ScreenObsConfig(128, agent_view=True, num_frames=4)
            if kind == "screen"
            else GridObsConfig(num_frames=4, grid_size=64, out_dtype="int16"))
    mod = FS if kind == "screen" else FG
    cuda = VecEnv(CFG, n, kind, obs_config=ocfg)
    plain = VecEnv(CFG, n, kind, backend="torch", device=cuda_device,
                   obs_config=ocfg)
    s, _ = cuda.reset(3)
    acts = torch.zeros(n, 1, 3, device=cuda_device)
    acts[:, 0, 0] = 0.6
    before = FT.tick_launches, mod.launches, FT.plain_calls
    got = cuda.multi_step(s, acts, 2)
    assert (FT.tick_launches - before[0], mod.launches - before[1]) == (8, 8)
    assert FT.plain_calls == before[2]
    want = plain.multi_step(s, acts, 2)
    assert got[1].shape == want[1].shape == (2, n, 4, 1) + got[1].shape[4:]
    assert int((got[1] != want[1]).sum()) == 0
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    assert torch.equal(got[3], want[3])

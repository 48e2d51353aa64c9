"""The port's CUDA kernels: guards that hold on any machine, and
kernel-against-plain cases that need a CUDA device (marker `gpu`; they skip
without one, and the card's own check is `python3 chip_smoke.py`)."""

import numpy as np
import pytest
import torch

from agarcl_tpu_torch import EnvConfig
from agarcl_tpu_torch.env import env_reset, reset_seeds
from agarcl_tpu_torch.obs.ram import RamObsConfig, ram_frame
from agarcl_tpu_torch.ops import _build, fused_obs, fused_step
from agarcl_tpu_torch.ops import fused_tick as FT
from agarcl_tpu_torch.state import STATE_FIELDS
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


def _planes(n=4, cfg=CFG):
    return FT.to_kernel_arrays(env_reset(cfg, reset_seeds(n, 0)))


def test_cuda_backend_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        VecEnv(CFG, 4, "ram", backend="cuda")


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
    duel = EnvConfig(num_agents=1, arena_size=100, num_pellets=20,
                     num_viruses=2, mode=7)
    with pytest.raises(NotImplementedError):
        FT.multi_step_raw(duel, _planes(cfg=duel), acts, 1, RamObsConfig())


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


def _int_mismatch(a, b):
    bad = torch.zeros(a.num_envs, dtype=torch.bool, device=a.device)
    for f in STATE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if not x.dtype.is_floating_point:
            bad |= (x != y).reshape(a.num_envs, -1).any(1)
    return bad


@pytest.mark.gpu
def test_ram_frame_kernel_matches_plain(cuda_device):
    s = _eventful_state(512, cuda_device)
    before = fused_obs.launches
    got = fused_obs.fused_ram_obs(CFG, RamObsConfig(), FT.to_kernel_arrays(s))
    assert fused_obs.launches == before + 1
    torch.testing.assert_close(got, ram_frame(CFG, RamObsConfig(), s),
                               rtol=1e-5, atol=1e-4)


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
        CFG, rp, acts, 8, RamObsConfig(), step=FT.multi_step_raw_plain)
    assert FT.launches == before + 1
    sk, sp = fused_step.from_resident(CFG, rk), fused_step.from_resident(CFG,
                                                                          rp)
    assert int(_int_mismatch(sk, sp).sum()) == 0
    assert int(sk.viruses_eaten.sum()) > 0
    torch.testing.assert_close(ok, op, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(rwk, rwp, rtol=0, atol=1e-5)
    assert torch.equal(dk, dp)

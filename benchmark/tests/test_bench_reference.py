"""The frozen reference against the port's plain version on the CPU, at a
few envs and steps of both configurations: reset, steps with their frames,
rewards and dones, and the kernel-layout decoder."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import check, driver, manifest
from benchmark.reference import env as R_env
from benchmark.reference import layout as R_layout


def _port_spec(config):
    from agarcl_tpu_torch.config import EnvConfig
    from agarcl_tpu_torch.obs.ram import RamObsConfig, ram_frame
    from agarcl_tpu_torch.obs.screen import ScreenObsConfig
    from agarcl_tpu_torch.ops import fused_screen as FS
    from agarcl_tpu_torch.ops import fused_tick as FT
    cfg = EnvConfig(**driver.env_kwargs(config))
    if config["obs_type"] == "ram":
        ocfg = RamObsConfig(**driver.obs_kwargs(config))
        return cfg, lambda s: ram_frame(cfg, ocfg, s)
    ocfg = ScreenObsConfig(**driver.obs_kwargs(config))
    return cfg, lambda s: FS.frame_plain(cfg, ocfg, FT.to_kernel_arrays(s))


def _same(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert torch.equal(x, y), f.name


@pytest.mark.parametrize("workload,steps,buttons", [
    ("bench_ram.chained", 3, [0]),
    ("task10_duel.chained", 3, [0, 1, 2]),
])
def test_reference_matches_port_plain(workload, steps, buttons):
    from agarcl_tpu_torch import env as P_env
    from agarcl_tpu_torch.state import GameState as PState
    cell = manifest.cell(manifest.load(), workload)
    sp = check.spec(cell.config, dict(cell.traffic, entry="gamestate"))
    cfg, obs_fn = _port_spec(cell.config)
    n, seed = 5, 2**31 + 7
    ref = R_env.env_reset(sp.cfg, R_env.reset_seeds(n, seed))
    port = P_env.env_reset(cfg, P_env.reset_seeds(n, seed))
    _same(ref, port)
    gen = torch.Generator().manual_seed(11)
    for _ in range(steps):
        a = torch.rand((n, 1, 3), generator=gen) * 2 - 1
        a[..., 2] = torch.tensor(buttons, dtype=torch.float32)[
            torch.randint(len(buttons), (n, 1), generator=gen)]
        ref, ro, rr, rd = R_env.env_step(sp.cfg, ref, a, obs_fn=sp.obs_fn)
        port, po, pr, pd = P_env.env_step(cfg, port, a, obs_fn=obs_fn)
        _same(ref, port)
        for x, y in ((ro, po), (rr, pr), (rd, pd)):
            assert torch.equal(x, y)
    # the decoder reads the port's kernel layout as the port writes it
    from agarcl_tpu_torch.ops import fused_tick as FT
    planes = FT.to_kernel_arrays(PState(**{
        f.name: getattr(port, f.name) for f in dataclasses.fields(port)}))
    back = R_layout.from_kernel_arrays(ref, planes)
    _same(back, ref)
    assert all(torch.equal(x, y) for x, y in
               zip(R_layout.to_kernel_arrays(ref), planes))


def test_control_rounds_state_and_outputs():
    cell = manifest.cell(manifest.load(), "bench_ram.chained")
    sp = check.spec(cell.config, cell.traffic)
    st = R_env.env_reset(sp.cfg, R_env.reset_seeds(3, 9))
    a = torch.zeros((3, 1, 3))
    sp1 = dataclasses.replace(sp, k=1)
    exact = check.replay(sp1, st, a)
    low = check.replay(sp1, st, a, control=True)
    assert check.state_diff(exact[0], low[0]) > 0
    assert check.ndiff(exact[1], low[1]) > 0


def test_screen_frame_matches_port_on_multicell_agents():
    """The frozen screen frame against the port's plain K3 version where
    the agent has up to 16 cells (the camera's centroid form matters
    there; the class map's XLA form differs in rare frames)."""
    from agarcl_tpu_torch.ops import fused_screen as FS
    from agarcl_tpu_torch.ops import fused_tick as FT
    cell = manifest.cell(manifest.load(), "task10_duel.chained")
    sp = check.spec(cell.config, cell.traffic)
    cfg, _ = _port_spec(cell.config)
    from agarcl_tpu_torch.obs.screen import ScreenObsConfig
    ocfg = ScreenObsConfig(**driver.obs_kwargs(cell.config))
    n = 64
    gen = torch.Generator().manual_seed(5)
    st = R_env.env_reset(sp.cfg, R_env.reset_seeds(n, 4))
    alive = torch.arange(16)[None] < torch.randint(2, 17, (n, 1),
                                                   generator=gen)
    pos = (torch.rand((n, 1, 2), generator=gen) * 300 + 25
           + (torch.rand((n, 16, 2), generator=gen) - 0.5) * 60)
    mass = torch.randint(10, 800, (n, 16), generator=gen, dtype=torch.int32)
    cp, cm, ca = st.cell_pos.clone(), st.cell_mass.clone(), \
        st.cell_alive.clone()
    cp[:, 0], cm[:, 0], ca[:, 0] = pos, torch.where(alive, mass, 0), alive
    st = st.replace(cell_pos=cp, cell_mass=cm, cell_alive=ca)
    planes = R_layout.to_kernel_arrays(st)
    assert torch.equal(sp.obs_fn(st), FS.frame_plain(cfg, ocfg, planes))
    assert FT.check_planes(cfg, planes) == n

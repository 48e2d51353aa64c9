"""The port's constants and configuration against the JAX package, and the
port's independence from JAX."""

import dataclasses
import os
import subprocess
import sys

import pytest

import agarcl_tpu.config as JC
import agarcl_tpu.constants as JK
import agarcl_tpu_torch.config as TC
import agarcl_tpu_torch.constants as TK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _public(mod):
    return {k: v for k, v in vars(mod).items() if k.isupper()}


def test_every_constant_matches():
    assert _public(TK) == _public(JK)


@pytest.mark.parametrize("mode", range(11))
def test_env_config_properties_match(mode):
    for kw in (dict(), dict(num_agents=2, num_bots=6, arena_size=180,
                            num_pellets=77, num_viruses=3)):
        j = JC.EnvConfig(mode=mode, **kw)
        t = TC.EnvConfig(mode=mode, **kw)
        assert dataclasses.asdict(t.mode_spec) == dataclasses.asdict(
            j.mode_spec)
        for prop in ("arena_width", "arena_height", "total_bots",
                     "num_players", "pellet_capacity", "virus_capacity"):
            assert getattr(t, prop) == getattr(j, prop), prop
        assert t.bot_types() == j.bot_types()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert TC.squared_pellet_count(350.0, 200.0) == \
        JC.squared_pellet_count(350.0, 200.0)


def test_invalid_mode_raises():
    with pytest.raises(ValueError):
        TC.EnvConfig(mode=11).mode_spec


def test_port_runs_without_jax():
    """Importing every module of the port (the gym wrapper, tasks, io and
    GoBigger among them) and running CPU resets and steps, the gym core's
    too, loads no JAX."""
    code = (
        "import sys\n"
        "import torch\n"
        "import agarcl_tpu_torch\n"
        "from agarcl_tpu_torch.vec import VecEnv\n"
        "cfg = agarcl_tpu_torch.EnvConfig(num_agents=1, ticks_per_step=2,"
        " arena_size=80, num_pellets=20, num_viruses=2, mode=4)\n"
        "env = VecEnv(cfg, 2, 'ram', backend='torch', device='cpu')\n"
        "s, obs = env.reset(0)\n"
        "s, obs, r, d = env.step(s, torch.zeros(2, 1, 3))\n"
        "from agarcl_tpu_torch.obs.screen import ScreenObsConfig\n"
        "scr = VecEnv(cfg, 2, 'screen', backend='torch', device='cpu',"
        " obs_config=ScreenObsConfig(16, agent_view=True))\n"
        "s2, o2 = scr.reset(0)\n"
        "s2, o2, r2, d2 = scr.step(s2, torch.zeros(2, 1, 3))\n"
        "assert o2.shape == (2, 1, 1, 16, 16, 4), o2.shape\n"
        "import importlib, pkgutil\n"
        "for m in pkgutil.walk_packages(agarcl_tpu_torch.__path__,"
        " 'agarcl_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from agarcl_tpu_torch.gym_core import AgarioCore\n"
        "core = AgarioCore('gobigger', device='cpu', arena_size=80,"
        " num_pellets=20, mode=4)\n"
        "core.reset(seed=1)\n"
        "core.step(((0.5, 0.5), 0))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'agarcl_tpu')]\n"
        "assert not bad, bad\n"
        # R = 3 + 16*6 + 20 pellets*3 + 8 viruses*4 + 1 player*4
        "assert obs.shape == (2, 1, 1, 195), obs.shape\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")

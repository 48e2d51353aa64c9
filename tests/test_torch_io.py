"""Snapshots, checkpoints and video written by either package load (or
compare) in the other: agarcl_tpu_torch/io against agarcl_tpu/io.

A JSON snapshot of a played duel state (mode 7: a bot, pellets, viruses,
foods, split cells) written by one package loads in the other field for
field, and both packages write the same text; the reference fixture
tests/fixtures/reference_snapshot_mode7.json loads to the same state in
both. A checkpoint (npz of every field plus the config header) of a batch,
and the JAX package's single-env checkpoint, load in the other package
exactly. write_video's AVI and GIF bytes are equal."""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agarcl_tpu import EnvConfig as JCfg
from agarcl_tpu.io import checkpoint as JC
from agarcl_tpu.io import snapshot as JS
from agarcl_tpu.io import video as JV
from agarcl_tpu.state import GameState as JState
from agarcl_tpu_torch import EnvConfig as TCfg
from agarcl_tpu_torch.bridge import state_from_numpy, state_to_numpy
from agarcl_tpu_torch.io import checkpoint as TC
from agarcl_tpu_torch.io import snapshot as TS
from agarcl_tpu_torch.io import video as TV
from agarcl_tpu_torch.vec import VecEnv as TVec

KW = dict(num_agents=1, ticks_per_step=4, arena_size=350, num_pellets=60,
          num_viruses=3, num_bots=1, mode=7)
FIXTURE = (Path(__file__).resolve().parent / "fixtures"
           / "reference_snapshot_mode7.json")
N = 3


@functools.lru_cache(maxsize=None)
def _played():
    """(N,) batched duel states after 6 steps of the port's plain engine
    with splits and feeds, as a JAX GameState."""
    cfg = TCfg(**KW)
    env = TVec(cfg, N, "none", backend="torch", device="cpu")
    s, _ = env.reset(2)
    cm = s.cell_mass.clone()
    cm[:, 0, 0] = 300
    s = s.replace(cell_mass=cm)
    for t in range(6):
        acts = torch.zeros(N, 1, 3)
        acts[:, 0, :2] = torch.tensor([0.5, -0.3])
        acts[:, 0, 2] = (2, 1, 0)[t % 3]
        s = env.step(s, acts)[0]
    return JState(**{f: jnp.asarray(a)
                     for f, a in state_to_numpy(s).items()})


def _np(js):
    return {f: np.asarray(getattr(js, f)) for f in js.__dataclass_fields__}


def _assert_fields(got: dict, want: dict):
    assert set(got) == set(want)
    for f in want:
        a, b = np.asarray(got[f]), np.asarray(want[f])
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_snapshot_cross_load(tmp_path):
    js = _played()
    one = jax.tree.map(lambda x: x[1], js)
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    JS.save_env_state(JCfg(**KW), one, str(jpath))
    TS.save_env_state(TCfg(**KW), state_from_numpy(_np(js)), str(tpath),
                      env=1)
    assert tpath.read_text() == jpath.read_text()
    assert TS.roster_from_snapshot(json.loads(tpath.read_text())) == (0, 1)
    j_from_t = _np(JS.load_env_state(JCfg(**KW), str(tpath)))
    t_from_j = state_to_numpy(TS.load_env_state(TCfg(**KW), str(jpath)))
    _assert_fields({f: a[0] for f, a in t_from_j.items()}, j_from_t)
    assert int(np.asarray(one.cell_alive).sum()) >= 3
    assert bool(np.asarray(one.food_alive).any())


def test_reference_fixture_loads_in_both():
    want = _np(JS.load_env_state(JCfg(**KW), str(FIXTURE)))
    got = state_to_numpy(TS.load_env_state(TCfg(**KW), str(FIXTURE)))
    _assert_fields({f: a[0] for f, a in got.items()}, want)
    with pytest.raises(ValueError):
        TS.load_env_state(TCfg(**dict(KW, mode=8)), str(FIXTURE))


def test_checkpoint_cross_load(tmp_path):
    js = _played()
    cfg_t = TCfg(**KW)
    JC.save_checkpoint(str(tmp_path / "j.npz"), JCfg(**KW), js)
    cfg, ts = TC.load_checkpoint(str(tmp_path / "j.npz"), cfg_t)
    assert cfg == cfg_t
    _assert_fields(state_to_numpy(ts), _np(js))
    TC.save_checkpoint(str(tmp_path / "t.npz"), cfg_t, ts)
    jcfg, back = JC.load_checkpoint(str(tmp_path / "t.npz"), JCfg(**KW))
    _assert_fields(_np(back), _np(js))
    one = jax.tree.map(lambda x: x[2], js)            # a single-env state
    JC.save_checkpoint(str(tmp_path / "one.npz"), JCfg(**KW), one)
    _, t1 = TC.load_checkpoint(str(tmp_path / "one.npz"))
    _assert_fields({f: a[0] for f, a in state_to_numpy(t1).items()},
                   _np(one))
    with pytest.raises(ValueError):
        TC.load_checkpoint(str(tmp_path / "t.npz"), TCfg(**dict(KW, mode=8)))


@pytest.mark.parametrize("ext", ["avi", "gif"])
def test_write_video_bytes_equal(tmp_path, ext):
    pytest.importorskip("PIL")
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
              for _ in range(4)]
    frames.append(rng.integers(0, 256, (24, 32, 4), dtype=np.uint8))
    JV.write_video(str(tmp_path / f"j.{ext}"), frames)
    TV.write_video(str(tmp_path / f"t.{ext}"), frames)
    data = (tmp_path / f"t.{ext}").read_bytes()
    assert data == (tmp_path / f"j.{ext}").read_bytes()
    assert data[:4] == (b"RIFF" if ext == "avi" else b"GIF8")

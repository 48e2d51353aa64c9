"""The port's env sharding (agarcl_tpu_torch/parallel/): ShardedVecEnv over
two CPU "devices" in one process against VecEnv, bit for bit; two gloo
processes of two shards each (tests/_torch_distributed_worker.py)
against the one-process run, with mean_reward equal to the global mean;
and a shard against the JAX package's ShardedVecEnv (XLA backend, CPU
mesh) from the same seeds."""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from agarcl_tpu.config import EnvConfig as JCfg
from agarcl_tpu.parallel.mesh import ShardedVecEnv as JSharded
from agarcl_tpu.parallel.mesh import make_env_mesh as j_mesh
from agarcl_tpu_torch.bridge import state_to_numpy
from agarcl_tpu_torch.env import reset_seeds
from agarcl_tpu_torch.obs.screen import ScreenObsConfig
from agarcl_tpu_torch.parallel import EnvMesh, ShardedVecEnv, make_env_mesh
from agarcl_tpu_torch.parallel import distributed as D
from agarcl_tpu_torch.state import STATE_FIELDS
from agarcl_tpu_torch.vec import VecEnv

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_distributed_worker as W  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU2 = [torch.device("cpu")] * 2


def _states_equal(sharded, whole):
    for f in STATE_FIELDS:
        a = np.concatenate([getattr(s, f).numpy() for s in sharded])
        np.testing.assert_array_equal(a, getattr(whole, f).numpy(),
                                      err_msg=f)


def test_reset_seeds_offset_is_a_slice_of_the_global_seeds():
    whole = reset_seeds(16, 7)
    assert torch.equal(torch.cat([reset_seeds(4, 7, offset=o)
                                  for o in (0, 4, 8, 12)]), whole)


@pytest.mark.parametrize("obs_type", ["ram", "screen"])
def test_one_process_two_shards_equal_vecenv(obs_type):
    """Resident RAM multi_step (k=3, twice) and screen steps: every
    output and the final state equal VecEnv's of 16 envs bit for bit."""
    ocfg = ScreenObsConfig(24, agent_view=True) if obs_type == "screen" \
        else None
    mesh = make_env_mesh(CPU2)
    assert (mesh.size, mesh.rank, mesh.world) == (2, 0, 1)
    assert D.global_env_count(8, mesh) == 16
    sh = ShardedVecEnv(W.CFG, 16, mesh, obs_type, obs_config=ocfg,
                       backend="torch")
    ve = VecEnv(W.CFG, 16, obs_type, backend="torch", device="cpu",
                obs_config=ocfg)
    acts = torch.from_numpy(W.actions())
    ss, so = sh.reset(3)
    vs, vo = ve.reset(3)
    np.testing.assert_array_equal(D.local_shard(so), vo.numpy())
    if obs_type == "ram":
        ss, vs = sh.make_resident(ss), ve.make_resident(vs)
        for _ in range(2):
            ss, so, sr, sd = sh.multi_step(ss, acts, 3)
            vs, vo, vr, vd = ve.multi_step(vs, acts, 3)
            for a, b in ((so, vo), (sr, vr), (sd, vd)):
                np.testing.assert_array_equal(D.local_shard(a, 1),
                                              b.numpy())
        ss, vs = sh.materialize(ss), ve.materialize(vs)
    else:
        for _ in range(2):
            ss, so, sr, sd = sh.step(ss, acts)
            vs, vo, vr, vd = ve.step(vs, acts)
            for a, b in ((so, vo), (sr, vr), (sd, vd)):
                np.testing.assert_array_equal(D.local_shard(a), b.numpy())
    _states_equal(ss, vs)
    assert sh.mean_reward(sr) == vr.to(torch.float64).mean().item()


def test_initialize_is_a_no_op_without_a_coordinator(monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    D.initialize()
    assert not torch.distributed.is_initialized()
    assert (D.process_count(), D.process_index()) == (1, 0)


@pytest.mark.parametrize("cuda,backend", [(True, "nccl"), (False, "gloo")])
def test_initialize_takes_the_env_vars_over_tcp(monkeypatch, cuda,
                                                backend):
    """COORDINATOR_ADDRESS (host:port), NUM_PROCESSES and PROCESS_ID go to
    init_process_group over tcp://, NCCL with a CUDA device, else gloo."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1234")
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "3")
    D.initialize()
    assert calls == [((backend,), dict(init_method="tcp://localhost:1234",
                                       world_size=4, rank=3))]


@pytest.mark.parametrize("devices,rank,world", [
    (1, 0, 1), (2, 0, 1), (2, 1, 2), (1, 3, 4)])
def test_shard_offsets_and_env_count_of_a_rank(devices, rank, world):
    """A rank's shards hold its process-major slice of the global envs:
    offsets, global_env_count and the reset state equal that slice of a
    VecEnv of all the envs (the mesh of a rank of `world` processes is
    built directly; nothing is communicated)."""
    mesh = EnvMesh(tuple([torch.device("cpu")] * devices), rank, world)
    n = 16 // mesh.size
    assert D.global_env_count(n, mesh) == 16
    sh = ShardedVecEnv(W.CFG, 16, mesh, "none", backend="torch")
    want = [(rank * devices + j) * n for j in range(devices)]
    assert list(sh.offsets) == want
    ss, _ = sh.reset(3)
    vs, _ = VecEnv(W.CFG, 16, "none", backend="torch",
                   device="cpu").reset(3)
    for o, s in zip(want, ss):
        for f in STATE_FIELDS:
            np.testing.assert_array_equal(
                getattr(s, f).numpy(), getattr(vs, f).numpy()[o:o + n],
                err_msg=f)


def test_sharded_vecenv_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="divide"):
        ShardedVecEnv(W.CFG, 10, make_env_mesh([torch.device("cpu")] * 4),
                      "ram", backend="torch")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_gloo_processes_equal_one_process(tmp_path):
    """Two ranks x two CPU shards, 16 envs, 3 steps: the ranks' local
    shards, in rank order, equal the one-process run over four shards,
    and every rank's mean_reward (one all_reduce) is the global mean."""
    port = _free_port()
    procs, outs = [], []
    for rank in range(2):
        out = tmp_path / f"rank_{rank}.npz"
        outs.append(out)
        env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES="2", PROCESS_ID=str(rank), TW_OUT=str(out),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "_torch_distributed_worker.py")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for p in procs:
        try:
            log, _ = p.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, log.decode(errors="replace")[-3000:]
    got = [np.load(o) for o in outs]
    assert [int(g["rank"]) for g in got] == [0, 1]
    r, o, m, mean = W.run(EnvMesh(tuple([torch.device("cpu")] * 4), 0, 1))
    np.testing.assert_array_equal(
        np.concatenate([g["rewards"] for g in got], 1), r)
    np.testing.assert_array_equal(np.concatenate([g["obs"] for g in got]), o)
    np.testing.assert_array_equal(np.concatenate([g["mass"] for g in got]),
                                  m)
    assert mean == r[-1].astype(np.float64).mean()
    assert all(float(g["mean"]) == mean for g in got)


def test_shards_match_jax_sharded_vecenv():
    """The JAX ShardedVecEnv (XLA backend) on a 2-device CPU mesh and the
    port's on two CPU shards, from reset(3) and 3 steps: RAM frames,
    rewards and dones per shard, and the state (integers equal, f32
    within 2e-3)."""
    jenv = JSharded(JCfg(**dataclasses.asdict(W.CFG)), 16,
                    j_mesh(jax.devices()[:2]), obs_type="ram")
    tenv = ShardedVecEnv(W.CFG, 16, make_env_mesh(CPU2), "ram",
                         backend="torch")
    js = jenv.reset(3)
    ts, _ = tenv.reset(3)
    acts = W.actions()
    for _ in range(3):
        js, jo, jr, jd = jenv.step(js, acts)
        ts, to, tr, td = tenv.step(ts, acts)
        for j, (o, r, d) in enumerate(zip(to, tr, td)):
            sl = slice(8 * j, 8 * j + 8)
            np.testing.assert_allclose(o.numpy(), np.asarray(jo)[sl],
                                       rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(r.numpy(), np.asarray(jr)[sl],
                                       atol=1e-5, rtol=0)
            np.testing.assert_array_equal(d.numpy(), np.asarray(jd)[sl])
    for j, s in enumerate(ts):
        t = state_to_numpy(s)
        for f in STATE_FIELDS:
            want = np.asarray(getattr(js, f))[8 * j:8 * j + 8]
            if np.issubdtype(want.dtype, np.floating):
                np.testing.assert_allclose(t[f], want, atol=2e-3, rtol=0,
                                           err_msg=f)
            else:
                np.testing.assert_array_equal(t[f], want, err_msg=f)

"""Worker process of tests/test_torch_parallel.py: one rank of a gloo
process group that runs the port's ShardedVecEnv over two CPU shards.

Environment: COORDINATOR_ADDRESS (host:port), NUM_PROCESSES, PROCESS_ID
(read by agarcl_tpu_torch.parallel.distributed.initialize) and TW_OUT,
the npz file the rank writes its local shards and the group's mean
reward to.
"""

import os

import numpy as np
import torch

from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.parallel import ShardedVecEnv, make_env_mesh
from agarcl_tpu_torch.parallel import distributed as D

CFG = EnvConfig(num_agents=1, ticks_per_step=2, arena_size=80,
                num_pellets=20, num_viruses=2, num_bots=0, mode=4)
NUM_ENVS = 16
STEPS = 3


def actions() -> np.ndarray:
    """Global (16, 1, 3) actions: a direction per env, no splits."""
    rng = np.random.default_rng(5)
    a = rng.uniform(-1, 1, (NUM_ENVS, 1, 3)).astype(np.float32)
    a[..., 2] = 0.0
    return a


def run(mesh):
    """reset(3), then STEPS steps: (local rewards (STEPS, n, 1), local obs
    of the last step, local player masses, mean_reward of the last
    step)."""
    env = ShardedVecEnv(CFG, NUM_ENVS, mesh, "ram", backend="torch")
    states, _ = env.reset(3)
    rewards = []
    for _ in range(STEPS):
        states, obs, r, d = env.step(states, actions())
        rewards.append(D.local_shard(r))
    mass = D.local_shard(tuple(s.player_mass() for s in states))
    return (np.stack(rewards), D.local_shard(obs), mass,
            env.mean_reward(r))


def main():
    torch.set_num_threads(1)
    D.initialize()
    assert D.process_count() == int(os.environ["NUM_PROCESSES"])
    mesh = make_env_mesh([torch.device("cpu")] * 2)
    assert mesh.size == 2 * D.process_count()
    assert D.global_env_count(NUM_ENVS // mesh.size, mesh) == NUM_ENVS
    r, o, m, mean = run(mesh)
    np.savez(os.environ["TW_OUT"], rewards=r, obs=o, mass=m, mean=mean,
             rank=D.process_index())
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

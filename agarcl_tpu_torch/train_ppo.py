"""PPO on the RAM-observation pellet task (counterpart of
examples/train_ppo.py), in PyTorch's idiom.

The policy is a small MLP (`PPOPolicy`); the rollout steps a
`VecEnv(cfg, N, "ram")` on resident state, one `multi_step(res, actions,
1)` per step: on the card that is K1 in n_steps mode writing the step's
RAM frame (K2 only at reset), on the CPU the plain engine. The update is
one full-batch Adam step on the PPO loss. The rollout makes no host round
trip; `main` fetches the printed numbers once every 5 iterations.

    python -m agarcl_tpu_torch.train_ppo                  # on the card
    python -m agarcl_tpu_torch.train_ppo --device cpu --envs 8 --iters 2

The MLP runs in float32 (TF32 stays off, as PyTorch's default), so the card
and the CPU compute the same function.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch
from torch import nn

from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.env import env_reset
from agarcl_tpu_torch.obs.ram import RamObsConfig, ram_size
from agarcl_tpu_torch.vec import VecEnv

NOISE_STD = 0.3
LOGP_DENOM = 2 * 0.09           # 2 * NOISE_STD**2, as the example writes it


def _linear(m: int, n: int, generator, device) -> nn.Linear:
    """mlp_init's layer: weights N(0, 1/m), zero bias."""
    layer = nn.utils.skip_init(nn.Linear, m, n, device=device)
    with torch.no_grad():
        layer.weight.copy_(torch.randn((n, m), generator=generator,
                                       device=device) / math.sqrt(m))
        layer.bias.zero_()
    return layer


def _mlp(layers, x):
    """The example's mlp: tanh between layers, none after the last."""
    for i, layer in enumerate(layers):
        x = layer(x)
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


class PPOPolicy(nn.Module):
    """Torso [obs_dim, 64, 64] with tanh, a mean head 64 -> 2 and a value
    head 64 -> 1 (examples/train_ppo.py:48-60). The input goes through
    tanh(obs * obs_scale) and the mean through tanh."""

    def __init__(self, obs_dim: int, obs_scale: float, generator=None,
                 device="cpu"):
        super().__init__()
        self.obs_scale = obs_scale
        self.torso = nn.ModuleList([_linear(obs_dim, 64, generator, device),
                                    _linear(64, 64, generator, device)])
        self.mean = nn.ModuleList([_linear(64, 2, generator, device)])
        self.value = nn.ModuleList([_linear(64, 1, generator, device)])

    def forward(self, obs):
        """(tanh(mean) (..., 2), value (...))."""
        h = _mlp(self.torso, torch.tanh(obs * self.obs_scale))
        return torch.tanh(_mlp(self.mean, h)), _mlp(self.value, h)[..., 0]


def params_from_jax(policy: PPOPolicy, params) -> PPOPolicy:
    """Load the example's parameters ({"torso": [(w, b), ...], "mean":
    [...], "value": [...]}, w shaped (in, out), as numpy arrays) into
    the policy; nn.Linear keeps w transposed."""
    with torch.no_grad():
        for name in ("torso", "mean", "value"):
            for layer, (w, b) in zip(getattr(policy, name), params[name]):
                layer.weight.copy_(torch.tensor(np.asarray(w).T))
                layer.bias.copy_(torch.tensor(np.asarray(b)))
    return policy


def sample_action(policy: PPOPolicy, obs, noise):
    """(act, logp, value) for obs (N, R) and a standard-normal noise draw
    (N, 2) (examples/train_ppo.py:62-67)."""
    mean, value = policy(obs)
    act = torch.clamp(mean + NOISE_STD * noise, -1.0, 1.0)
    logp = -torch.sum((act - mean) ** 2, dim=-1) / LOGP_DENOM
    return act, logp, value


def gae(values, rewards, dones, last_value, gamma: float, lam: float):
    """Generalized advantage estimates over a (T, N) rollout, a reverse
    loop (examples/train_ppo.py:100-111)."""
    advs = torch.empty_like(values)
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    for t in range(values.shape[0] - 1, -1, -1):
        nd = 1.0 - dones[t].to(torch.float32)
        delta = rewards[t] + gamma * v_next * nd - values[t]
        adv_next = delta + gamma * lam * nd * adv_next
        advs[t] = adv_next
        v_next = values[t]
    return advs


def ppo_loss(policy: PPOPolicy, traj, last_value, clip_eps: float,
             gamma: float = 0.99, lam: float = 0.95):
    """The clipped PPO loss plus half the value loss of a rollout
    (examples/train_ppo.py:115-132); traj = (obs, act, logp_old, values,
    rewards, dones), each (T, N, ...)."""
    obs, act, logp_old, values, rewards, dones = traj
    advs = gae(values, rewards, dones, last_value, gamma, lam)
    rets = advs + values
    advs = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
    mean, value = policy(obs)
    logp = -torch.sum((act - mean) ** 2, dim=-1) / LOGP_DENOM
    ratio = torch.exp(logp - logp_old)
    pg = -torch.minimum(
        ratio * advs,
        torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * advs).mean()
    vloss = ((value - rets) ** 2).mean()
    return pg + 0.5 * vloss


def make_train(cfg: EnvConfig, ocfg: RamObsConfig, num_envs: int,
               rollout_len: int, lr: float, clip_eps: float = 0.2,
               gamma: float = 0.99, lam: float = 0.95, device="cuda",
               generator=None):
    """(init, train_iter, reset), as examples/train_ppo.py:make_train
    returns init and train_iter:

    - init() -> (policy, optimizer): a fresh PPOPolicy drawn from
      `generator` and torch.optim.Adam(lr) (optax.adam's b1, b2, eps);
    - reset(seeds) -> (resident state, obs (N, A, R)): env_reset on the
      given per-env seeds, its RAM frame and make_resident;
    - train_iter(policy, optimizer, res, obs, noise=None) -> (res, obs,
      loss, mean_reward): a rollout of rollout_len steps, then one Adam
      step (policy and optimizer in place). The action noise is drawn
      from `generator` unless a (T, N, 2) standard-normal `noise` is given.

    device="cpu" steps the plain engine (backend "torch"); a CUDA device
    steps K1, and a configuration K1 refuses raises NotImplementedError.
    """
    device = torch.device(device)
    backend = "cuda" if device.type == "cuda" else "torch"
    venv = VecEnv(cfg, num_envs, "ram", backend=backend, device=device,
                  obs_config=ocfg)
    obs_dim = ram_size(cfg, ocfg)
    obs_scale = 1.0 / max(cfg.arena_width, cfg.arena_height)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)

    def init():
        policy = PPOPolicy(obs_dim, obs_scale, generator, device)
        return policy, torch.optim.Adam(policy.parameters(), lr=lr,
                                        betas=(0.9, 0.999), eps=1e-8)

    def reset(seeds):
        states = env_reset(cfg, torch.as_tensor(seeds, device=device))
        return venv.make_resident(states), venv.observe(states)

    def rollout(policy, res, obs, noise):
        zeros = torch.zeros((num_envs, 1), device=device)
        traj = [[] for _ in range(6)]
        with torch.no_grad():
            for t in range(rollout_len):
                nz = (noise[t] if noise is not None else torch.randn(
                    (num_envs, 2), generator=generator, device=device))
                o = obs[:, 0]
                act, logp, value = sample_action(policy, o, nz)
                actions = torch.cat([act, zeros], dim=-1)[:, None, :]
                res, obs_f, rewards, dones = venv.multi_step(res, actions, 1)
                obs = obs_f[0][:, -1]
                for buf, x in zip(traj, (o, act, logp, value, rewards[0, :, 0],
                                         dones[0, :, 0])):
                    buf.append(x)
            _, last_value = policy(obs[:, 0])
        return res, obs, tuple(torch.stack(b) for b in traj), last_value

    def train_iter(policy, opt, res, obs, noise=None):
        if noise is not None:
            noise = torch.as_tensor(noise, dtype=torch.float32,
                                    device=device)
        res, obs, traj, last_value = rollout(policy, res, obs, noise)
        loss = ppo_loss(policy, traj, last_value, clip_eps, gamma, lam)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return res, obs, loss.detach(), traj[4].mean()

    return init, train_iter, reset


def task_config() -> EnvConfig:
    """The example's dense-pellet task (examples/train_ppo.py:165-166)."""
    return EnvConfig(num_agents=1, ticks_per_step=4, arena_size=60,
                     num_pellets=200, num_viruses=0, num_bots=0, mode=3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--rollout", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = task_config()
    gen = torch.Generator(device).manual_seed(args.seed)
    init, train_iter, reset = make_train(
        cfg, RamObsConfig(), args.envs, args.rollout, args.lr,
        device=device, generator=gen)
    policy, opt = init()
    # per-env seeds 0..N-1, as the example's jnp.arange(envs)
    res, obs = reset(torch.arange(args.envs))

    t_win = time.perf_counter()
    rewards_hist, pending = [], []
    for it in range(args.iters):
        res, obs, loss, mr = train_iter(policy, opt, res, obs)
        pending.append(mr)
        if it % 5 == 0 or it == args.iters - 1:
            # one fetch per window; the first window includes the kernel
            # build, later ones are the steady-state training rate
            n_win = len(pending)
            rewards_hist += torch.stack(pending).tolist()
            pending = []
            now = time.perf_counter()
            sps = args.envs * args.rollout * n_win / (now - t_win)
            t_win = now
            print(f"iter {it:4d}  mean_reward/step {rewards_hist[-1]:7.4f}  "
                  f"loss {loss.item():8.4f}  env-steps/s {sps:9.0f}",
                  flush=True)
    early = float(np.mean(rewards_hist[:5]))
    late = float(np.mean(rewards_hist[-5:]))
    print(f"reward/step improved: {early:.4f} -> {late:.4f}")
    return early, late


if __name__ == "__main__":
    main()

"""The port's PPO trainer (agarcl_tpu_torch/train_ppo.py) against the JAX
example (examples/train_ppo.py) on the CPU, 8 envs, rollout 16.

Both start from the same parameters (the example's init, carried over by
params_from_jax) and the same states (per-env seeds 0..7); the action noise
is the example's own draw, its key chain replayed outside its train_iter
and passed to the port's. Per iteration the bars are:

- loss within rtol 1e-5 and mean reward within 1e-6 (float32 sums in
  another order);
- every parameter within 0.1 * lr: the first Adam steps move a parameter
  by about lr * sign(g), so the rounding of optax and torch.optim.Adam
  shows on the scale of lr; a flipped sign would be 2 * lr;
- the carried engine state: integer fields equal, float fields and the
  next RAM frame within 1e-4 (ulps of the policy's actions moved into the
  targets).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agarcl_tpu import EnvConfig as JCfg
from agarcl_tpu import env_reset as j_reset
from agarcl_tpu.obs.ram import RamObsConfig as JRam
from agarcl_tpu_torch import train_ppo as TP
from agarcl_tpu_torch.obs.ram import RamObsConfig
from agarcl_tpu_torch.ops import fused_step
from agarcl_tpu_torch.state import STATE_FIELDS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, T, LR = 8, 16, 3e-4
# Bars above 0, each with the size measured at these seeds (ROADMAP.md
# Queue 3 item 14: torch's and XLA's float32 sums of the MLP and Adam run in
# other orders): loss 1.1e-7 relative, parameters 6.8e-6 (about 0.02 lr),
# the policy's outputs 3.6e-7 and the carried state 9.5e-6 after the
# iterations (ulps of the actions moved into the targets). The example's
# init, reset and first frame run here under jit (it runs them eagerly,
# examples/train_ppo.py:173-175, where XLA rounds the spawn draw otherwise,
# Queue 3 item 10), so the reset frame is exact.
LOSS_RTOL = 1e-5
PARAM_ATOL = 0.1 * LR
STATE_ATOL = 1e-4


def _example():
    spec = importlib.util.spec_from_file_location(
        "examples_train_ppo", os.path.join(REPO, "examples", "train_ppo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def example():
    ex = _example()
    jcfg = JCfg(num_agents=1, ticks_per_step=4, arena_size=60,
                num_pellets=200, num_viruses=0, num_bots=0, mode=3)
    init, train_iter, frame_fn = ex.make_train(jcfg, JRam(), N, T, LR)
    return ex, jcfg, jax.jit(init), train_iter, frame_fn


def _np_params(params):
    return jax.tree.map(lambda x: np.array(x), params)


def _assert_params(policy, params):
    for name in ("torso", "mean", "value"):
        for layer, (w, b) in zip(getattr(policy, name), params[name]):
            np.testing.assert_allclose(layer.weight.detach().numpy(),
                                       np.asarray(w).T, rtol=0,
                                       atol=PARAM_ATOL, err_msg=name)
            np.testing.assert_allclose(layer.bias.detach().numpy(),
                                       np.asarray(b), rtol=0,
                                       atol=PARAM_ATOL, err_msg=name)


def test_policy_forward_matches_mlp(example):
    """params_from_jax + PPOPolicy give the example's policy_out: the
    torso, the mean head through tanh and the value head."""
    ex, jcfg, init, _, _ = example
    params, _ = init(jax.random.PRNGKey(3))
    obs_scale = 1.0 / max(jcfg.arena_width, jcfg.arena_height)
    rng = np.random.default_rng(0)
    obs = rng.uniform(-80.0, 80.0, (5, 7, 231)).astype(np.float32)
    h = ex.mlp(params["torso"], jnp.tanh(obs * obs_scale))
    j_mean = np.asarray(jnp.tanh(ex.mlp(params["mean"], h)))
    j_value = np.asarray(ex.mlp(params["value"], h)[..., 0])
    policy = TP.params_from_jax(TP.PPOPolicy(231, obs_scale),
                                _np_params(params))
    with torch.no_grad():
        t_mean, t_value = policy(torch.from_numpy(obs))
    np.testing.assert_allclose(t_mean.numpy(), j_mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_value.numpy(), j_value, rtol=1e-5,
                               atol=1e-6)


def test_policy_init_matches_mlp_init_scale():
    """PPOPolicy draws mlp_init's distribution: weights N(0, 1/fan_in),
    zero biases, the example's layer sizes."""
    g = torch.Generator().manual_seed(0)
    policy = TP.PPOPolicy(231, 1.0 / 60, g)
    shapes = [tuple(p.shape) for p in policy.parameters()]
    assert shapes == [(64, 231), (64,), (64, 64), (64,), (2, 64), (2,),
                      (1, 64), (1,)]
    w = policy.torso[0].weight.detach()
    assert abs(float(w.std()) * np.sqrt(231) - 1.0) < 0.05
    assert all(float(layer.bias.abs().max()) == 0.0 for layer in
               (*policy.torso, *policy.mean, *policy.value))


def test_train_iter_matches_jax(example):
    """Two train_iter calls of the port on the CPU against the example's,
    from carried parameters and states: loss, mean reward, parameters and
    the engine state, at the module docstring's bars.

    The reference is the jitted form of the example's init, reset and
    first frame; the example runs them eagerly. Jitted, the reset is the
    one the port's reset equals bit for bit (test_torch_state.py), so the
    start is the same on both sides and every difference below comes from
    the trainer. The eager reset differs from it by XLA's rounding of the
    spawn draw (Queue 3 item 10; 3.8e-6 in the reset frame at these seeds),
    which the steps would carry and the bars would charge to the trainer."""
    _, jcfg, init, train_iter, frame_fn = example
    key = jax.random.PRNGKey(0)
    params, opt_state = init(key)
    states = jax.jit(jax.vmap(functools.partial(j_reset, jcfg)))(
        jnp.arange(N, dtype=jnp.uint32))
    obs = jax.jit(jax.vmap(frame_fn))(states)

    t_init, t_train, t_reset = TP.make_train(TP.task_config(), RamObsConfig(),
                                             N, T, LR, device="cpu")
    policy, opt = t_init()
    TP.params_from_jax(policy, _np_params(params))
    res, t_obs = t_reset(torch.arange(N))
    np.testing.assert_allclose(t_obs.numpy(), np.asarray(obs), rtol=0,
                               atol=STATE_ATOL)
    for it in range(2):
        k, noise = key, []
        for _ in range(T):
            k, k1 = jax.random.split(k)
            noise.append(np.asarray(jax.random.normal(k1, (N, 2))))
        params, opt_state, states, obs, key, loss, mr = train_iter(
            params, opt_state, states, obs, key)
        res, t_obs, t_loss, t_mr = t_train(policy, opt, res, t_obs,
                                           np.stack(noise))
        np.testing.assert_allclose(float(t_loss), float(loss),
                                   rtol=LOSS_RTOL, err_msg=f"loss {it}")
        np.testing.assert_allclose(float(t_mr), float(mr), rtol=0,
                                   atol=1e-6, err_msg=f"reward {it}")
        _assert_params(policy, params)
        s = fused_step.from_resident(TP.task_config(), res)
        for f in STATE_FIELDS:
            got, want = getattr(s, f).numpy(), np.asarray(getattr(states, f))
            if want.dtype.kind == "f":
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=STATE_ATOL, err_msg=f)
            else:
                np.testing.assert_array_equal(got.astype(want.dtype), want,
                                              err_msg=f)
        np.testing.assert_allclose(t_obs.numpy(), np.asarray(obs), rtol=0,
                                   atol=STATE_ATOL)


def test_main_prints_the_examples_lines(capsys):
    """main on the CPU: the example's per-window line and closing line,
    (early, late) returned, finite values."""
    early, late = TP.main(["--device", "cpu", "--envs", "4", "--iters", "2",
                           "--rollout", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[:2] for ln in lines[:2]] == [["iter", "0"],
                                                    ["iter", "1"]]
    assert all("mean_reward/step" in ln and "loss" in ln
               and "env-steps/s" in ln for ln in lines[:2])
    assert lines[2] == (f"reward/step improved: {early:.4f} -> "
                        f"{late:.4f}")
    assert np.isfinite([early, late]).all()


def test_cuda_device_without_a_card_raises(monkeypatch):
    """The trainer runs on the card by default and never moves to the CPU
    by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.make_train(TP.task_config(), RamObsConfig(), 4, 2, LR,
                      device="cuda")

"""The comparison that decides `correct`.

The window captures a sample of the calls it makes, at times drawn from
the seed, and in each a sample of envs drawn from the seed: the state rows
the call started from, the actions the benchmark handed it, and what it
produced (the state after, the observations, rewards and dones). Once the
window has closed, the frozen reference (benchmark/reference/) replays
each captured call from the program's own input state with the same
actions, and `judge` counts the values that differ:

- reset_diff: the state (and the reset observation) the set-up produced
  against the reference's reset from the same seeds, which it derives
  itself (reset_seeds, or the gym's episode seed);
- state_diff, obs_diff, reward_diff, done_diff: each captured call's
  outputs against the reference's replay of it.

The port is bit-equal to its plain engine on the card, and the reference
is a frozen copy of that engine, so every count has the limit 0: a value
compares equal when it is ==, so -0.0 equals 0.0.

The control (benchmark/control.py, never run by the benchmark itself)
puts the reference computed in bfloat16 (`replay(..., control=True)`:
every float of the state rounded to bfloat16 before each step, and the
float outputs after) in the program's place.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark import driver
from benchmark.reference import env as R_env
from benchmark.reference import gym as R_gym
from benchmark.reference import layout as R_layout
from benchmark.reference.config import EnvConfig
from benchmark.reference.obs.frame import frame_plain
from benchmark.reference.obs.ram import RamObsConfig, ram_frame
from benchmark.reference.obs.screen import ScreenObsConfig
from benchmark.reference.state import GameState, zero_state

LIMITS = {"reset_diff": 0, "state_diff": 0, "obs_diff": 0,
          "reward_diff": 0, "done_diff": 0}


@dataclasses.dataclass(frozen=True)
class Spec:
    """What the reference needs to replay a cell's calls."""
    cfg: EnvConfig
    obs_fn: object            # state -> (E, A, ...) frame, or None
    frames: int               # frames a step returns
    k: int                    # steps a call
    gym: bool                 # the single-env gym protocol
    add_noise: bool
    number_steps: int
    env_type: int
    block: int                # rows replayed at a time
    respawn_main: bool        # a dead main player respawns after its frame


def spec(config: dict, traffic: dict) -> Spec:
    cfg = EnvConfig(**driver.env_kwargs(config))
    kind = config["obs_type"]
    if kind == "ram":
        ocfg = RamObsConfig(**driver.obs_kwargs(config))

        def obs_fn(s):
            return ram_frame(cfg, ocfg, s)
    elif kind == "screen":
        ocfg = ScreenObsConfig(**driver.obs_kwargs(config))

        def obs_fn(s):
            return frame_plain(cfg, ocfg, R_layout.to_kernel_arrays(s))
    else:
        raise ValueError(f"unsupported obs_type {kind!r}")
    gym = traffic["entry"] == "gym"
    return Spec(cfg=cfg, obs_fn=obs_fn,
                frames=driver.frames_per_step(config),
                k=int(traffic.get("k", 1)), gym=gym,
                add_noise=bool(config.get("add_noise", False)),
                number_steps=int(config.get("number_steps", 0)),
                env_type=int(config.get("env_type", 0)),
                block=int(traffic["reference_block"]),
                # the gym's screen step respawns a dead main player once its
                # frames are taken (ScreenEnvironment.hpp:233-243)
                respawn_main=gym and kind == "screen")


def to_state(sp: Spec, snap: dict, device) -> GameState:
    """A reference GameState of captured rows: resident planes (decoded
    with the reference's layout) or GameState fields."""
    if "planes" in snap:
        planes = [p.to(device) for p in snap["planes"]]
        E = planes[0].shape[-1]
        st = R_layout.from_kernel_arrays(zero_state(sp.cfg, E, device),
                                         planes)
        return st.replace(dones=snap["dones"].to(device))
    return GameState(**{f.name: snap["fields"][f.name].to(device)
                        for f in dataclasses.fields(GameState)})


def _cat_states(states) -> GameState:
    return GameState(**{f.name: torch.cat([getattr(s, f.name)
                                           for s in states])
                        for f in dataclasses.fields(GameState)})


def _take(st: GameState, sl) -> GameState:
    return GameState(**{f.name: getattr(st, f.name)[sl]
                        for f in dataclasses.fields(GameState)})


def _bf16(x: torch.Tensor) -> torch.Tensor:
    if x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    return x


def _round_state(st: GameState) -> GameState:
    return GameState(**{f.name: _bf16(getattr(st, f.name))
                        for f in dataclasses.fields(GameState)})


def replay(sp: Spec, state: GameState, actions: torch.Tensor,
           control: bool = False):
    """k steps of the reference from `state` with (E, A, 3) actions held
    for all of them. Returns (state, obs (k, E, F, A, ...), rewards
    (k, E, A), dones (k, E, A)); control=True computes them in bfloat16."""
    obs, rs, ds = [], [], []
    for _ in range(sp.k):
        if control:
            state = _round_state(state)
        state, o, r, d = R_env.env_step(sp.cfg, state, actions,
                                        sp.respawn_main, obs_fn=sp.obs_fn,
                                        num_frames=sp.frames)
        if control:
            state, o, r = _round_state(state), _bf16(o), _bf16(r)
        obs.append(o)
        rs.append(r)
        ds.append(d)
    return state, torch.stack(obs), torch.stack(rs), torch.stack(ds)


def ndiff(a, b) -> int:
    """Values that differ (==, so -0.0 equals 0.0); a shape mismatch or a
    missing side counts every value."""
    if a is None or b is None:
        return 0 if a is None and b is None else int(
            (a if a is not None else b).numel())
    a, b = torch.as_tensor(a), torch.as_tensor(b).to(torch.as_tensor(a)
                                                     .device)
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a != b).sum())


def state_diff(x: GameState, y: GameState) -> int:
    return sum(ndiff(getattr(x, f.name), getattr(y, f.name))
               for f in dataclasses.fields(GameState))


def _reset_seeds(sp: Spec, rec: dict, device) -> torch.Tensor:
    """The per-env seeds of a recorded reset's rows, from its seed alone."""
    if sp.gym:
        return torch.tensor([rec["seed"] & 0xFFFFFFFF], dtype=torch.int64,
                            device=device)
    return R_env.reset_seeds(int(rec["envs"]), rec["seed"],
                             device)[rec["rows"].to(device)]


def _reset_obs(sp: Spec, st: GameState):
    """The reference's reset observation in the layout the records keep:
    (E, A, ...) from a VecEnv reset, (E, F, ...) of agent 0 from the
    gym's."""
    o = sp.obs_fn(st)
    if sp.gym:
        return o[:, 0, None].expand((o.shape[0], sp.frames) + o.shape[2:])
    return o


def _check_resets(sp: Spec, resets: list, device, control: bool):
    """(differing values, rows checked, rows that differ) of every
    recorded reset against the reference's reset from the same seeds."""
    diff = rows = bad = 0
    for rec in resets:
        ref = R_env.env_reset(sp.cfg, _reset_seeds(sp, rec, device))
        got = _round_state(ref) if control else to_state(sp, rec["state"],
                                                         device)
        d = state_diff(got, ref)
        if rec.get("obs") is not None:
            ref_o = _reset_obs(sp, ref)
            got_o = _bf16(ref_o) if control else rec["obs"].to(device)
            d += ndiff(got_o, ref_o)
        diff += d
        rows += ref.num_envs
        bad += int(d > 0)
    return diff, rows, bad


def _actions(sp: Spec, rec_in: dict, noise, device) -> torch.Tensor:
    if not sp.gym:
        return rec_in["actions"].to(device)
    pair = noise[rec_in["call_index"]] if sp.add_noise else None
    return R_gym.actions_tensor([R_gym.action_row(rec_in["action"], pair)],
                                device)


def judge(sp: Spec, resets: list, records: list, device,
          control: bool = False) -> dict:
    """Counts of differing values (see the module docstring), the number
    of checked env-steps and reset rows, and of those that failed
    (a reset counts once). With control=True the reference in bfloat16
    takes the program's place."""
    out = {key: 0 for key in LIMITS}
    # the start: every reset, set-up's and each episode's
    out["reset_diff"], checked, failed = _check_resets(sp, resets, device,
                                                       control)
    # the captured calls, replayed from the program's input state
    noise = (R_gym.noise_table(1 + max(r[0]["call_index"] for r in records))
             if sp.gym and sp.add_noise and records else None)
    starts = [to_state(sp, rin["state"], device) for rin, _ in records]
    acts = [_actions(sp, rin, noise, device) for rin, _ in records]
    if not records:
        return dict(out, checked=checked, failed=failed)
    start = _cat_states(starts)
    act = torch.cat(acts)
    E = start.num_envs
    for b0 in range(0, E, sp.block):
        sl = slice(b0, b0 + sp.block)
        ref_st, ref_o, ref_r, ref_d = replay(sp, _take(start, sl), act[sl])
        if control:
            got_st, got_o, got_r, got_d = replay(sp, _take(start, sl),
                                                 act[sl], control=True)
        else:
            got_st, got_o, got_r, got_d = _gather_outputs(sp, records, sl,
                                                          device)
        if sp.gym:
            ref_d = _gym_dones(sp, records, sl, ref_d)
        diffs = dict(state_diff=state_diff(got_st, ref_st),
                     obs_diff=ndiff(got_o, ref_o),
                     reward_diff=ndiff(got_r, ref_r),
                     done_diff=ndiff(got_d, ref_d))
        for key, v in diffs.items():
            out[key] += v
        failed += _failed_rows(got_st, ref_st, got_o, ref_o, got_r, ref_r,
                               got_d, ref_d)
        checked += (min(E, b0 + sp.block) - b0) * sp.k
    return dict(out, checked=checked, failed=failed)


def _gather_outputs(sp: Spec, records: list, sl: slice, device):
    """The program's captured outputs of rows sl of the concatenated
    checkpoints: (state, obs (k, E, ...), rewards, dones)."""
    st = _take(_cat_states([to_state(sp, rout["state"], device)
                            for _, rout in records]), sl)
    cat = (lambda key: torch.cat([rout[key].to(device)
                                  for _, rout in records], 1)[:, sl])
    obs = cat("obs") if records[0][1]["obs"] is not None else None
    return st, obs, cat("rewards"), cat("dones")


def _gym_dones(sp: Spec, records: list, sl: slice, ref_d):
    """The gym's done: the engine's, or its episodic cutoff."""
    before = [rin["steps_before"] for rin, _ in records][sl]
    d = ref_d.clone()
    for i, steps in enumerate(before):
        d[0, i, 0] = R_gym.episode_done(bool(ref_d[0, i, 0]), steps,
                                        sp.number_steps, sp.env_type)
    return d


def _failed_rows(got_st, ref_st, got_o, ref_o, got_r, ref_r, got_d,
                 ref_d) -> int:
    """Env-steps with any value that differs (a step whose state after
    the call differs counts at every step of the call)."""
    k, E = ref_r.shape[:2]
    bad = torch.zeros((k, E), dtype=torch.bool, device=ref_r.device)

    def rows(a, b, lead):
        if a is None or b is None or a.shape != b.shape:
            return torch.ones((k, E), dtype=torch.bool, device=bad.device)
        ne = (a != b).reshape(a.shape[:lead] + (-1,)).any(-1)
        return ne if lead == 2 else ne[None].expand(k, E)

    for a, b in ((got_o, ref_o), (got_r, ref_r), (got_d, ref_d)):
        bad |= rows(a, b, 2)
    for f in dataclasses.fields(GameState):
        bad |= rows(getattr(got_st, f.name), getattr(ref_st, f.name), 1)
    return int(bad.sum())

"""The one driver of every traffic mix.

A traffic file (benchmark/traffic/<name>.json) names the port's entry a
caller drives and how it draws its actions:

- "entry": "resident" (`VecEnv.multi_step` on resident state, "k" steps a
  call), "gamestate" (`VecEnv.step` or `multi_step` on a GameState) or
  "gym" (one env through `gym_core.AgarioCore.step`, numpy back every
  step);
- "envs": lockstep envs (1 for "gym");
- "k": steps a call ("resident" and "gamestate"; a "gamestate" call of
  one step is `VecEnv.step`, of more `VecEnv.multi_step`);
- "buttons": the action buttons drawn uniformly (0 none, 1 feed,
  2 split); dx and dy are uniform in [-1, 1];
- "in_flight": calls the caller lets the device run behind it (a CUDA
  event per call; the caller waits for call i - in_flight before it
  issues call i);
- "checkpoints", "checked_envs", "reference_block": the check's sample
  (benchmark/check.py): calls captured at times drawn from the seed, envs
  drawn from the seed in each, and the rows the reference replays at a
  time.

Actions of the VecEnv entries are drawn on the device from a
torch.Generator seeded with --seed, fresh for every call and held for its
k steps; the gym entry draws on the host from numpy's Generator seeded
with --seed, as the suite's random_walk.py does, and starts episode e from
env seed --seed + e.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch

# The task-file keys AgarioCore reads (the suite's bench/tasks_configs
# schema); a configuration file may hold more (its source, what it assumed).
TASK_KEYS = ("ticks_per_step", "num_frames", "arena_size", "num_pellets",
             "num_viruses", "num_bots", "pellet_regen", "grid_size",
             "screen_len", "observe_cells", "observe_others",
             "observe_viruses", "observe_pellets", "reward_type", "c_death",
             "agent_view", "add_noise", "mode", "number_steps", "env_type")


def env_kwargs(config: dict) -> dict:
    """EnvConfig keyword arguments of a configuration file (as the gym
    core maps a task file)."""
    return dict(num_agents=config.get("num_agents", 1),
                ticks_per_step=config["ticks_per_step"],
                arena_size=config["arena_size"],
                pellet_regen=config["pellet_regen"],
                num_pellets=config["num_pellets"],
                num_viruses=config["num_viruses"],
                num_bots=config["num_bots"],
                reward_type=bool(config["reward_type"]),
                c_death=config["c_death"], mode=config["mode"])


def obs_kwargs(config: dict) -> dict:
    """Observation config keyword arguments: RAM (nearest pellets and
    viruses) or the screen as the gym core builds it."""
    if config["obs_type"] == "ram":
        return dict(num_pellets=config["ram_pellets"],
                    num_viruses=config["ram_viruses"])
    if config["obs_type"] == "screen":
        return dict(screen_len=config["screen_len"],
                    agent_view=config["agent_view"],
                    num_frames=config["num_frames"])
    raise ValueError(f"unsupported obs_type {config['obs_type']!r}")


def frames_per_step(config: dict) -> int:
    return config["num_frames"] if config["obs_type"] == "screen" else 1


def sample_rows(gen: torch.Generator, n: int, count: int) -> torch.Tensor:
    """`count` distinct env indices of n, drawn from gen, sorted."""
    return torch.randperm(n, generator=gen)[:min(count, n)].sort().values


class _Entry:
    """A system under test built from a configuration and a traffic file.
    `setup(rows_of)` builds and resets it, `draw` makes a call's actions,
    `call` makes one call, `post` ends an episode where it is due,
    `capture_in` / `capture_out` copy the sampled rows of a call's input
    and outputs for the check. Each reset (set-up's and every episode's)
    leaves a record of sampled rows in `reset_records`.

    Episodes follow the configuration: an episodic task (env_type 0) ends
    after number_steps steps, and the caller resets every env with the
    next seed (seed + e for episode e); the gym core also ends one on a
    done. So every window runs the task's whole episodes, whatever its
    speed, and the work of a step does not drift with how far the run
    got."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.k = int(traffic.get("k", 1))
        self.envs = int(traffic["envs"])
        self.buttons = [int(b) for b in traffic["buttons"]]
        self.episode_steps = (int(config["number_steps"])
                              if config.get("env_type", 0) == 0 else 0)
        self.episode = 0
        self.reset_records = []
        self.rows_of = None

    def setup(self, rows_of) -> None:
        self.rows_of = rows_of
        self._reset()

    def post(self, out) -> None:
        """Work a caller does between calls: the episode's reset when it
        is due."""

    def release(self) -> None:
        """Drop the system's state and buffers."""


class _VecEntry(_Entry):
    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        from agarcl_tpu_torch.config import EnvConfig
        from agarcl_tpu_torch.vec import VecEnv
        cfg = EnvConfig(**env_kwargs(config))
        if config["obs_type"] == "ram":
            from agarcl_tpu_torch.obs.ram import RamObsConfig
            ocfg = RamObsConfig(**obs_kwargs(config))
        else:
            from agarcl_tpu_torch.obs.screen import ScreenObsConfig
            ocfg = ScreenObsConfig(**obs_kwargs(config))
        cuda = self.device.type == "cuda"
        self.env = VecEnv(cfg, self.envs, config["obs_type"],
                          backend="cuda" if cuda else "torch",
                          device=self.device, obs_config=ocfg)
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.table = torch.tensor(self.buttons, dtype=torch.float32,
                                  device=self.device)
        self.state = None

    def draw(self):
        """(N, A, 3) f32 actions: dx, dy uniform in [-1, 1), a button
        drawn uniformly from the traffic's list."""
        a = torch.rand((self.envs, self.env.cfg.num_agents, 3),
                       generator=self.gen, device=self.device)
        a[..., :2].mul_(2.0).sub_(1.0)
        if self.buttons == [0]:
            a[..., 2].zero_()
        else:
            idx = (a[..., 2] * len(self.buttons)).long()
            a[..., 2] = self.table[idx.clamp_(max=len(self.buttons) - 1)]
        return a

    def _reset(self):
        """VecEnv.reset with the episode's seed; records sampled rows of
        the state the next call starts from and of the reset frame."""
        seed = self.seed + self.episode
        states, obs = self.env.reset(seed)
        self.state = self._carrier(states)
        self.since_reset = 0
        rows = self.rows_of()
        self.reset_records.append(dict(
            seed=seed, rows=rows, envs=self.envs,
            state=self._state_rows(self.state, rows),
            obs=obs[rows] if obs is not None else None))

    def post(self, out):
        self.since_reset += self.k
        if self.episode_steps and self.since_reset >= self.episode_steps:
            self.episode += 1
            self._reset()

    def capture_in(self, actions, rows):
        return dict(rows=rows, state=self._state_rows(self.state, rows),
                    actions=actions[rows])

    def capture_out(self, out, rows):
        obs, r, d = out
        return dict(state=self._state_rows(self.state, rows),
                    obs=obs[:, rows] if obs is not None else None,
                    rewards=r[:, rows], dones=d[:, rows])

    def release(self):
        self.state = None


class ResidentEntry(_VecEntry):
    """`VecEnv.multi_step(resident, actions, k)`: RAM or no observation on
    the kernel-layout state kept between calls."""

    def _carrier(self, states):
        return self.env.make_resident(states)

    @staticmethod
    def _state_rows(res, rows):
        return dict(planes=[p[:, rows] for p in res.raw],
                    dones=res.dones[rows])

    def call(self, actions):
        self.state, obs, r, d = self.env.multi_step(self.state, actions,
                                                    self.k)
        return obs, r, d


def _fields_rows(states, rows):
    return dict(fields={f.name: getattr(states, f.name)[rows]
                        for f in dataclasses.fields(states)})


class GameStateEntry(_VecEntry):
    """`VecEnv.step(states, actions)` on a GameState (k = 1), or
    `VecEnv.multi_step(states, actions, k)` with the frames stacked."""

    def _carrier(self, states):
        return states

    @staticmethod
    def _state_rows(states, rows):
        return _fields_rows(states, rows)

    def call(self, actions):
        if self.k == 1:
            self.state, obs, r, d = self.env.step(self.state, actions)
            return (obs[None] if obs is not None else None), r[None], d[None]
        self.state, obs, r, d = self.env.multi_step(self.state, actions,
                                                    self.k)
        return obs, r, d


class GymEntry(_Entry):
    """One env through `gym_core.AgarioCore.step`, with a new episode
    (`reset(seed + e)`) after each done."""

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        from agarcl_tpu_torch.gym_core import AgarioCore
        kw = {k: config[k] for k in TASK_KEYS if k in config}
        self.core = AgarioCore(config["obs_type"], None, self.device, None,
                               **kw)
        self.rng = np.random.default_rng(self.seed)
        self.calls = 0               # AgarioCore.step calls since built

    def _reset(self):
        seed = self.seed + self.episode
        obs, _ = self.core.reset(seed=seed)
        self.reset_records.append(dict(
            seed=seed, rows=None, envs=1, state=self._state(),
            obs=torch.as_tensor(np.array(obs))[None]))

    def _state(self):
        return dict(fields={f.name: getattr(self.core.state, f.name).clone()
                            for f in dataclasses.fields(self.core.state)})

    def draw(self):
        n = len(self.buttons)
        return ((float(self.rng.uniform(-1, 1)),
                 float(self.rng.uniform(-1, 1))),
                self.buttons[int(self.rng.integers(0, n))])

    def call(self, action):
        self.calls += 1
        obs, r, done, _, _ = self.core.step(action)
        return obs, r, done

    def post(self, out):
        if out[2]:
            self.episode += 1
            self._reset()

    def capture_in(self, action, rows):
        return dict(rows=rows, state=self._state(), action=action,
                    call_index=self.calls, steps_before=self.core.steps)

    def capture_out(self, out, rows):
        obs, r, done = out
        o = torch.as_tensor(np.array(obs))        # (F, S, S, C)
        return dict(state=self._state(),
                    obs=o[None, None, :, None],   # (k=1, E=1, F, A=1, ...)
                    rewards=torch.tensor([[[r]]], dtype=torch.float32),
                    dones=torch.tensor([[[bool(done)]]]))

    def release(self):
        self.core.state = None


ENTRIES = {"resident": ResidentEntry, "gamestate": GameStateEntry,
           "gym": GymEntry}


def make_entry(config: dict, traffic: dict, seed: int, device) -> _Entry:
    return ENTRIES[traffic["entry"]](config, traffic, seed, device)


class Spans:
    """Host-clock spans of the harness, by name, in seconds; with a
    profiler running, each span is also a record_function range."""

    def __init__(self, profiled: bool = False):
        self.times = collections.defaultdict(list)
        self.profiled = profiled

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = (torch.profiler.record_function(name) if self.profiled
              else contextlib.nullcontext())
        with rf:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.times[name].append(time.perf_counter() - t0)


@dataclasses.dataclass
class Window:
    calls: int
    seconds: float           # host clock, first issue to the final sync
    call_s: list             # host seconds of each call
    records: list            # (capture_in, capture_out) of checkpoints


def run_window(entry: _Entry, seconds: float, spans: Spans,
               checkpoint_at=(), rows_of=None, on_call=None) -> Window:
    """Drive the entry for `seconds` on the host clock, then wait for the
    device. A call is captured (capture_in before, capture_out after) when
    it is the first issued at or after each time in `checkpoint_at`
    (offsets into the window), with the rows rows_of() gives. on_call(i),
    if given, runs after call i returns."""
    cuda = entry.device.type == "cuda"
    depth = int(entry.traffic.get("in_flight", 0))
    pending = collections.deque()
    marks = sorted(checkpoint_at)
    records, call_s = [], []
    calls = 0
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        if cuda and depth:
            while len(pending) >= depth:
                with spans("wait"):
                    pending.popleft().synchronize()
        with spans("draw"):
            a = entry.draw()
        cap = None
        if marks and time.perf_counter() - t0 >= marks[0]:
            marks.pop(0)
            rows = rows_of()
            with spans("capture"):
                cap = entry.capture_in(a, rows)
        with spans("call"):
            out = entry.call(a)
        call_s.append(spans.times["call"][-1])
        if cuda and depth:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
        if cap is not None:
            with spans("capture"):
                records.append((cap, entry.capture_out(out, cap["rows"])))
        if on_call is not None:
            on_call(calls)
        with spans("post"):
            entry.post(out)
        calls += 1
        if time.perf_counter() >= t_end:
            break
    if cuda:
        with spans("sync"):
            torch.cuda.synchronize(entry.device)
    return Window(calls=calls, seconds=time.perf_counter() - t0,
                  call_s=call_s, records=records)

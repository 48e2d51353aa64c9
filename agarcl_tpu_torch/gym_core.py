"""The single-environment core of the Gymnasium wrapper (the counterpart of
agarcl_tpu/gym_env.py::AgarioEnv without gymnasium).

`AgarioCore` holds what `AgarioEnv` (gym_env.py) adds to a gym.Env: the
observation configs of the obs types "ram", "grid", "screen" and
"gobigger", reset and step of one env through `VecEnv` (num_envs=1), the
reference's action checks and optional action noise, the episodic cutoff,
snapshots, `get_frame` and the video recorder. It imports no gymnasium, so
it runs where gymnasium is not installed. It runs on the card unless the
caller asks for the CPU (device="cpu": the plain engine; backend="torch"
runs the plain engine on the card too); without a CUDA device it raises.
A screen step respawns a dead main player during observation and charges
c_death (ScreenEnvironment.hpp:233-243), as the JAX wrapper does.

On a CUDA device with the kernels (backend "cuda") a RAM, screen or grid
core steps through ops/fused_step.py::StepGraphs: the step's PyTorch glue
replayed as two CUDA graphs around the eager kernel launches, on a static
state that `self.state` then is; a state assigned in its place (reset,
load_env_state, seed, plain assignment) is copied into it at the next step.
GoBigger, the CPU and backend "torch" step through VecEnv.step
(`fused_step.eager_steps` counts those steps, `graph_steps` the others).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.env import env_reset
from agarcl_tpu_torch.io.snapshot import load_env_state as _load_snapshot
from agarcl_tpu_torch.io.snapshot import save_env_state as _save_snapshot
from agarcl_tpu_torch.obs.gobigger import GoBiggerObsConfig, to_player_states
from agarcl_tpu_torch.obs.grid import GridObsConfig
from agarcl_tpu_torch.obs.ram import RamObsConfig, ram_size
from agarcl_tpu_torch.obs.screen import ScreenObsConfig, render_rgb
from agarcl_tpu_torch.ops import fused_step
from agarcl_tpu_torch.profiling import span
from agarcl_tpu_torch.vec import VecEnv

DIFFICULTY = {
    "normal": dict(arena_size=1000, num_pellets=1000, num_viruses=0,
                   num_bots=0),
    "empty": dict(arena_size=1000, num_pellets=1000, num_viruses=0,
                  num_bots=0),
    "trivial": dict(arena_size=50, num_pellets=200, num_viruses=0,
                    num_bots=0),
}
OBS_TYPES = ("ram", "screen", "grid", "gobigger")


class AgarioCore:
    def __init__(self, obs_type="grid", render_mode=None, device=None,
                 backend=None, **kwargs):
        if obs_type not in OBS_TYPES:
            raise ValueError(obs_type)
        self.obs_type = obs_type
        self.render_mode = render_mode
        difficulty = kwargs.get("difficulty", "normal").lower()
        if difficulty not in DIFFICULTY:
            raise ValueError(f"Unrecognized difficulty: {difficulty}")
        base = dict(DIFFICULTY[difficulty])

        self.num_agents = kwargs.get("num_agents", 1)
        self.multi_agent = kwargs.get("multi_agent", False) \
            or self.num_agents > 1
        self.cfg = EnvConfig(
            num_agents=self.num_agents,
            ticks_per_step=kwargs.get("ticks_per_step", 4),
            arena_size=kwargs.get("arena_size", base["arena_size"]),
            pellet_regen=kwargs.get("pellet_regen", True),
            num_pellets=kwargs.get("num_pellets", base["num_pellets"]),
            num_viruses=kwargs.get("num_viruses", base["num_viruses"]),
            num_bots=kwargs.get("num_bots", base["num_bots"]),
            reward_type=bool(kwargs.get("reward_type", 1)),
            c_death=kwargs.get("c_death", 0),
            mode=kwargs.get("mode", 0),
        )
        self.number_of_steps = kwargs.get("number_steps", 500)
        self.env_type = kwargs.get("env_type", 0)  # 0 episodic, 1 continuing
        self.add_noise = kwargs.get("add_noise", False)
        self.agent_view = kwargs.get("agent_view", False)
        self.num_frames = kwargs.get("num_frames", 1)
        self.obs_config = self._make_obs_config(obs_type, kwargs)

        self.device = torch.device(device or "cuda")
        if backend is None:
            backend = "cuda" if self.device.type == "cuda" else "torch"
        self.venv = VecEnv(
            self.cfg, 1, obs_type, backend=backend,
            device=self.device, obs_config=self.obs_config,
            respawn_main_during_obs=(obs_type == "screen"))
        self.graphs = None
        if backend == "cuda" and obs_type != "gobigger":
            self.graphs = fused_step.StepGraphs(
                self.cfg, self.obs_config, 1, self.device,
                self.num_frames if obs_type != "ram" else 1,
                respawn_main_during_obs=(obs_type == "screen"))
        self.steps = None
        self._seed = 0
        self._rng = np.random.default_rng(0)
        self.state = None
        self.global_state = None
        self.video_recorder = []
        self.video_recorder_enabled = False

    # ------------------------------------------------------------------ obs
    def _make_obs_config(self, obs_type, kwargs):
        if obs_type == "ram":
            return RamObsConfig()
        if obs_type == "grid":
            return GridObsConfig(
                num_frames=self.num_frames,
                grid_size=kwargs.get("grid_size", 128),
                observe_cells=kwargs.get("observe_cells", True),
                observe_others=kwargs.get("observe_others", True),
                observe_viruses=kwargs.get("observe_viruses", True),
                observe_pellets=kwargs.get("observe_pellets", True),
                out_dtype=kwargs.get("grid_dtype", "int32"))
        if obs_type == "screen":
            return ScreenObsConfig(
                screen_len=kwargs.get("screen_len", 84),
                agent_view=self.agent_view, num_frames=self.num_frames,
                polygon_edges=kwargs.get("polygon_edges", False))
        return GoBiggerObsConfig(
            map_width=kwargs.get("map_width", 512),
            map_height=kwargs.get("map_height", 512),
            frame_limit=kwargs.get("frame_limit", 1000))

    def observation_shape(self) -> tuple:
        """The per-agent observation's shape and numpy dtype (GoBigger:
        ((1,), float32), as the reference declares it)."""
        o = self.obs_config
        if self.obs_type == "ram":
            return (ram_size(self.cfg, o),), np.float32
        if self.obs_type == "grid":
            G = o.grid_size
            return ((G, G, o.num_frames * o.channels_per_frame),
                    np.dtype(o.out_dtype))
        if self.obs_type == "screen":
            return ((self.num_frames, o.screen_len, o.screen_len,
                     4 if self.agent_view else 3), np.uint8)
        return (1,), np.float32

    def _post_obs(self, frames):
        """(F, A, ...) frames of the one env (GoBigger: a dict of them) ->
        per-agent host observations."""
        if self.obs_type == "gobigger":
            last = {k: v[-1] for k, v in frames.items()}
            gs, players = to_player_states(self.cfg, self.obs_config, last)
            self.global_state = gs
            return [players[a] for a in range(self.num_agents)]
        with span("gym.fetch"):
            obs = frames.detach().cpu().numpy()
        out = []
        for a in range(self.num_agents):
            o = obs[:, a]
            if self.obs_type == "grid":
                # frames stacked into channels, NCHW -> NHWC
                F, Cc, G, _ = o.shape
                o = o.reshape(F * Cc, G, G).transpose(1, 2, 0)
            elif self.obs_type == "ram":
                o = o[-1]
            out.append(np.ascontiguousarray(o))
        return out

    def _out(self, obs):
        return obs if self.multi_agent else obs[0]

    # ------------------------------------------------------------ episodes
    def reset(self, seed=None, **kwargs):
        with span("gym.reset"):
            if seed is not None:
                self._seed = seed
            self.steps = 0
            self.state = env_reset(self.cfg, torch.tensor(
                [self._seed & 0xFFFFFFFF], dtype=torch.int64,
                device=self.device))
            frame = self.venv.observe(self.state)
            if isinstance(frame, dict):
                frames = {k: v[0][None] for k, v in frame.items()}
            else:
                frames = frame[0][None].expand((self.num_frames,)
                                               + frame.shape[1:])
            return self._out(self._post_obs(frames)), {}

    def step(self, actions):
        if self.steps is None:
            raise RuntimeError("Cannot call step() before calling reset()")
        with span("gym.step"):
            with span("gym.actions"):
                acts = self._sanitize_actions(actions)
            self.state, obs, rewards, dones = self._step(acts[None])
            frames = ({k: v[0] for k, v in obs.items()}
                      if isinstance(obs, dict) else obs[0])
            observations = self._post_obs(frames)
            if self.video_recorder_enabled and isinstance(observations[0],
                                                          np.ndarray):
                self.video_recorder.append(
                    self._make_video_observation(observations[0]))
            with span("gym.fetch"):
                rewards = rewards[0].cpu().numpy()
            with span("gym.fetch"):
                dones = dones[0].cpu().numpy()
            rewards = [float(r) for r in rewards]
            dones = [bool(d) for d in dones]
            truncations = [False] * len(dones)
            if self.steps >= self.number_of_steps and self.env_type == 0:
                dones = [True] * len(dones)
            if not self.multi_agent:
                observations, rewards = observations[0], rewards[0]
                dones, truncations = dones[0], truncations[0]
            self.steps += 1
            return observations, rewards, dones, truncations, \
                {"steps": self.steps, "untransformed_rewards": rewards}

    def _step(self, acts):
        """One step of self.state: through the graphs, the state copied
        into their static one first unless it is that one; else
        VecEnv.step."""
        g = self.graphs
        if g is None:
            fused_step.eager_steps += 1
            return self.venv.step(self.state, acts)
        if self.state is not g.state:
            g.load(self.state)
        return g.step(acts)

    def seed(self, seed=None):
        if seed is not None:
            self._seed = seed
            if self.state is not None:
                self.state = self.state.replace(
                    seed=torch.full_like(self.state.seed,
                                         seed & 0xFFFFFFFF))
            return [self._seed]

    def render(self):
        if self.render_mode == "rgb_array":
            return self.get_frame()
        return None

    def get_frame(self, size: int = 512):
        """size x size natural-colour render of agent 0's view (the
        reference's FrameObservation path, GridEnvironment.hpp:456-472)."""
        return render_rgb(self.cfg, self.state, size)[0].cpu().numpy()

    def close(self):
        pass

    # ------------------------------------------------------------ snapshots
    def save_env_state(self, filename):
        _save_snapshot(self.cfg, self.state, filename)

    def load_env_state(self, filename):
        self.state = _load_snapshot(self.cfg, filename, self.device)
        self.steps = 0

    # ----------------------------------------------------------------- video
    def enable_video_recorder(self):
        self.video_recorder_enabled = True

    def disable_video_recorder(self):
        self.video_recorder_enabled = False

    def generate_video(self, path, video_name):
        from agarcl_tpu_torch.io.video import write_video
        os.makedirs(path, exist_ok=True)
        if not self.video_recorder_enabled:
            print("Video recorder is not enabled. Please enable it before "
                  "generating video")
            return
        if not self.video_recorder:
            print("No frames to generate video")
            return
        write_video(os.path.join(path, video_name), self.video_recorder)

    def _make_video_observation(self, observation):
        o = observation
        if self.obs_type == "grid":
            # pellet presence, own cells and others as RGB
            ch = o[..., :3].astype(np.float32)
            ch = 255.0 * ch / max(1.0, float(ch.max()))
            return ch.astype(np.uint8)
        if o.ndim == 4:
            o = o[-1]
        return np.asarray(o[..., :3], dtype=np.uint8)

    # --------------------------------------------------------------- actions
    def _sanitize_actions(self, actions) -> torch.Tensor:
        """The reference's action list protocol -> (A, 3) f32 (dx, dy, act)
        on the env's device."""
        if not self.multi_agent and not isinstance(actions, list):
            actions = [actions]
        if not isinstance(actions, list):
            raise ValueError(
                "Action list must be a list of two-element tuples")
        if len(actions) != self.num_agents:
            raise ValueError(
                f"Number of actions {len(actions)} does not match number of "
                f"agents {self.num_agents}")
        rows = []
        for action in actions:
            tgt, a = action
            dx, dy = float(tgt[0]), float(tgt[1])
            if self.add_noise:
                noise = self._rng.normal(0, 0.1, size=2)
                dx = float(np.clip(dx + noise[0], -1, 1))
                dy = float(np.clip(dy + noise[1], -1, 1))
            if not (-1 <= dx <= 1 and -1 <= dy <= 1 and a in (0, 1, 2)):
                raise ValueError(f"action {action} not in action space")
            rows.append((dx, dy, float(a)))
        return torch.tensor(rows, dtype=torch.float32, device=self.device)

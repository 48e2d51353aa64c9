"""Interactive human client (counterpart of client.py): a playable game
against scripted bots, the mouse steering, SPACE splitting, W feeding,
with a leaderboard.

One env steps through VecEnv(cfg, 1, "screen", ScreenObsConfig(S,
agent_view=False)) on the card: the tick kernel K1 and the screen kernel
K3 (S = 512 by default; rosters above 9 players run the plain engine on
the same device, and S above 544 the class map). `device="cpu"` runs the
plain backend on the CPU. `play` and `replay` draw with matplotlib, which
they import when called (a headless host may not have it; `play_ascii`
needs nothing).

    python -m agarcl_tpu_torch.client [--ascii] [--steps 100] [--device cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from agarcl_tpu_torch.config import EnvConfig

BOT_LABELS = ["", "Hungry", "HungryShy", "Aggressive", "AggressiveShy"]


def _matplotlib():
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise RuntimeError("play() and replay() draw with matplotlib, which "
                           "is not installed; play_ascii() needs nothing"
                           ) from e
    return plt


class Client:
    """Playable game: the agent against num_bots bots (two of each type by
    default, as the reference client)."""

    def __init__(self, arena_size=250, num_pellets=500, num_viruses=10,
                 num_bots=8, screen=512, seed=0, device="cuda"):
        from agarcl_tpu_torch.env import env_reset
        from agarcl_tpu_torch.obs.screen import ScreenObsConfig
        from agarcl_tpu_torch.ops import fused_tick as FT
        from agarcl_tpu_torch.vec import VecEnv

        self.cfg = EnvConfig(num_agents=1, ticks_per_step=1,
                             arena_size=arena_size, num_pellets=num_pellets,
                             num_viruses=num_viruses, num_bots=num_bots,
                             mode=0)
        self.ocfg = ScreenObsConfig(screen_len=screen, agent_view=False)
        dev = torch.device(device)
        backend = ("cuda" if dev.type == "cuda" and FT.supports(self.cfg)
                   else "torch")
        self.env = VecEnv(self.cfg, 1, "screen", backend=backend,
                          device=dev, obs_config=self.ocfg)
        self.device = dev
        self.state = env_reset(self.cfg, torch.tensor([seed], device=dev))
        self.action = 0
        self.direction = np.zeros(2, np.float32)
        self._mouse = None  # last cursor pixel (xpos, ypos), y down from top

    def _mass(self) -> float:
        return float(self.state.player_mass()[0, 0])

    def _centroid(self) -> np.ndarray:
        return self.state.player_centroid()[0, 0].cpu().numpy()

    def to_target(self, xpos, ypos):
        """Screen pixel -> world target through the camera transform of
        the reference renderer (renderer.hpp:62-78): the camera sits over
        the player centroid at z = clamp(100 + mass/10, 100, 900) with a
        45-degree fov and a square aspect, so the inverse projection is
        centroid + ndc * tan(22.5deg) * (1 + z)."""
        S = float(self.ocfg.screen_len)
        ndc_x = 2.0 * (xpos / S) - 1.0
        ndc_y = 1.0 - 2.0 * (ypos / S)
        cz = min(max(100.0 + self._mass() / 10.0, 100.0), 900.0)
        half = np.tan(np.radians(45.0) / 2.0)
        cx, cy = self._centroid()
        return (cx + ndc_x * half * (1.0 + cz),
                cy + ndc_y * half * (1.0 + cz))

    def set_mouse(self, xpos, ypos):
        """Record the cursor pixel; each step() re-derives the world target
        from it (the reference client reads the cursor every frame)."""
        self._mouse = (float(xpos), float(ypos))

    def leaderboard(self):
        """(name, mass) pairs, heaviest first."""
        masses = self.state.player_mass()[0].cpu().numpy()
        bots = self.cfg.bot_types()
        names = ["you"] + [f"{BOT_LABELS[b]}Bot{i}"
                           for i, b in enumerate(bots[1:], 1)]
        order = np.argsort(-masses)
        return [(names[i], int(masses[i])) for i in order]

    def step(self) -> np.ndarray:
        """One step toward the mouse's target (apply_actions sets target =
        centroid + 10 * (dx, dy) without clipping, so the direction
        reproduces the unprojected target) or the last direction, with
        the pending key; returns the (S, S, 3) uint8 frame, row 0 at the
        top."""
        if self._mouse is not None:
            tx, ty = self.to_target(*self._mouse)
            cx, cy = self._centroid()
            self.direction = np.array([(tx - cx) / 10.0, (ty - cy) / 10.0],
                                      np.float32)
        acts = np.array([[[self.direction[0], self.direction[1],
                           float(self.action)]]], np.float32)
        self.state, obs, _, _ = self.env.step(
            self.state, torch.from_numpy(acts).to(self.device))
        self.action = 0
        return obs[0, -1, 0].cpu().numpy()[::-1]

    def play(self, max_fps=30.0, max_seconds=None):
        """Interactive matplotlib loop: move with the mouse, SPACE=split,
        W=feed, Q quits."""
        plt = _matplotlib()
        fig, ax = plt.subplots(figsize=(6, 6))
        img = ax.imshow(self.step())
        ax.set_axis_off()
        title = ax.set_title("agarcl_tpu_torch")
        running = {"on": True}

        def on_move(event):
            if event.inaxes is ax and event.xdata is not None:
                self.set_mouse(event.xdata, event.ydata)

        def on_key(event):
            if event.key == " ":
                self.action = 2
            elif event.key in ("w", "W"):
                self.action = 1
            elif event.key in ("q", "Q"):
                running["on"] = False

        fig.canvas.mpl_connect("motion_notify_event", on_move)
        fig.canvas.mpl_connect("key_press_event", on_key)
        plt.ion()
        plt.show()
        t_start = time.time()
        while running["on"] and plt.fignum_exists(fig.number):
            t0 = time.time()
            img.set_data(self.step())
            lb = self.leaderboard()[:3]
            title.set_text("  ".join(f"{n}:{m}" for n, m in lb))
            fig.canvas.draw_idle()
            plt.pause(max(1.0 / max_fps - (time.time() - t0), 1e-3))
            if max_seconds and time.time() - t_start > max_seconds:
                break

    def play_ascii(self, steps=100, size=40, fps=10.0):
        """Headless terminal viewer: the agent chases the nearest pellet;
        every 30 / fps steps the class map of a size x size view is
        printed."""
        from agarcl_tpu_torch.obs.screen import _class_map
        chars = {0: " ", 1: ".", 2: "o", 3: "*", 4: "@", 5: "#", 6: "V"}
        for t in range(steps):
            c = self._centroid()
            ppos, palv = self.state.pellet_xy_alive(self.cfg)
            pel = ppos[0].cpu().numpy()
            d = np.linalg.norm(pel - c, axis=1)
            d[~palv[0].cpu().numpy()] = 1e9
            v = pel[d.argmin()] - c
            self.direction = np.clip(v / (np.abs(v).max() + 1e-9), -1, 1)
            self.step()
            if t % max(1, int(30 / fps)) == 0:
                cls = _class_map(self.cfg, self.state, size)[0, 0]
                sys.stdout.write("\x1b[H\x1b[2J")
                for row in cls.cpu().numpy()[::-1]:
                    sys.stdout.write("".join(chars[int(x)] for x in row)
                                     + "\n")
                lb = self.leaderboard()[:3]
                sys.stdout.write(" | ".join(f"{n}:{m}" for n, m in lb)
                                 + "\n")
                sys.stdout.flush()
                time.sleep(1.0 / fps)


def replay(frames, fps=30.0):
    """View a recorded list of RGB frames (matplotlib)."""
    plt = _matplotlib()
    fig, ax = plt.subplots()
    img = ax.imshow(frames[0])
    ax.set_axis_off()
    plt.ion()
    plt.show()
    for f in frames[1:]:
        img.set_data(f)
        fig.canvas.draw_idle()
        plt.pause(1.0 / fps)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--ascii", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    c = Client(device=args.device)
    if args.ascii:
        c.play_ascii(steps=args.steps)
    else:
        c.play()

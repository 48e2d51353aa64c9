"""The kernel layout of the port's resident state, as a frozen copy: every
GameState field as a contiguous (feature, N) plane with the env axis last,
41 planes in `SPLIT_PLAN` order (the JAX package's _SPLIT_PLAN). The
benchmark reads the port's resident planes through `from_kernel_arrays`
and writes the reference's states through `to_kernel_arrays`; both are
plain copies, so the decoder shares nothing with the code it judges.
"""

from __future__ import annotations

import torch

from benchmark.reference.state import GameState

# (name, kind): "s" per-env scalar -> (1, N); "p" per-player -> (P, N);
# "pk"/"pc" (N,P,F) -> (P*F, N); "v2p" (N,P,2) -> two (P, N);
# "v2c" (N,P,F,2) -> two (P*F, N); "v2" (N,F,2) -> two (F, N);
# "2d" (N,F) -> (F, N).
SPLIT_PLAN = [
    ("target", "v2p"),
    ("action", "p"), ("split_cooldown", "p"), ("feed_cooldown", "p"),
    ("elapsed_ticks", "p"), ("last_decay_tick", "p"),
    ("anti_team_decay", "p"),
    ("virus_eaten_ticks", "pk"), ("virus_eaten_ptr", "p"),
    ("food_eaten", "p"), ("highest_mass", "p"), ("viruses_eaten", "p"),
    ("cells_eaten", "p"),
    ("cell_pos", "v2c"), ("cell_vel", "v2c"), ("cell_split_vel", "v2c"),
    ("cell_mass", "pc"), ("cell_alive", "pc"), ("cell_id", "pc"),
    ("cell_recombine_at", "pc"), ("next_cell_id", "s"),
    ("pellet_key", "2d"),
    ("virus_pos", "v2"), ("virus_vel", "v2"), ("virus_mass", "2d"),
    ("virus_hits", "2d"), ("virus_alive", "2d"),
    ("food_pos", "v2"), ("food_vel", "v2"), ("food_alive", "2d"),
    ("food_next", "s"), ("ticks", "s"), ("seed", "s"),
]

# field name -> its plane index, or its (x, y) plane indices
PLANE_INDEX = {}
for _name, _kind in SPLIT_PLAN:
    _i = sum(len(v) for v in PLANE_INDEX.values())
    PLANE_INDEX[_name] = ((_i, _i + 1) if _kind in ("v2", "v2p", "v2c")
                          else (_i,))


def _seed_plane(seed: torch.Tensor) -> torch.Tensor:
    """int64 [0, 2^32) -> int32 holding the uint32 bit pattern."""
    s = seed & 0xFFFFFFFF
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32)


def to_kernel_arrays(states: GameState) -> list:
    """GameState -> list of contiguous (feature, N) planes (fresh copies)."""
    N = states.num_envs
    out = []
    for name, kind in SPLIT_PLAN:
        x = getattr(states, name)
        if name == "seed":
            x = _seed_plane(x)
        if kind == "s":
            out.append(x[None, :])
        elif kind in ("p", "2d"):
            out.append(x.T)
        elif kind in ("pk", "pc"):
            out.append(x.reshape(N, -1).T)
        elif kind in ("v2p", "v2"):
            out += [x[..., 0].T, x[..., 1].T]
        elif kind == "v2c":
            out += [x[..., 0].reshape(N, -1).T, x[..., 1].reshape(N, -1).T]
        else:
            raise ValueError(kind)
    return [p.clone(memory_format=torch.contiguous_format) for p in out]


def from_kernel_arrays(template: GameState, planes) -> GameState:
    """Inverse of to_kernel_arrays; the template supplies the fields the
    planes do not carry (dones, main_respawned) and the shapes."""
    kw = {}
    i = 0
    for name, kind in SPLIT_PLAN:
        shp = getattr(template, name).shape
        if kind == "s":
            x = planes[i][0].clone()
            if name == "seed":
                x = x.to(torch.int64) & 0xFFFFFFFF
            kw[name] = x
            i += 1
        elif kind in ("p", "2d", "pk", "pc"):
            kw[name] = planes[i].T.reshape(shp).clone(
                memory_format=torch.contiguous_format)
            i += 1
        else:
            kw[name] = torch.stack([planes[i].T.reshape(shp[:-1]),
                                    planes[i + 1].T.reshape(shp[:-1])],
                                   dim=-1)
            i += 2
    return template.replace(**kw)


def plane_bytes_per_env(template: GameState) -> int:
    """Bytes of one env's column of the planes (bool 1 byte, else 4): the
    state a kernel on this layout reads and writes once per call."""
    return sum(p.numel() * p.element_size()
               for p in to_kernel_arrays(template))

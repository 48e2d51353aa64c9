"""Native full-state checkpoints (counterpart of io/checkpoint.py).

The reference's JSON snapshots (io/snapshot.py) drop recombine timers,
virus food-hit counters and the tick counter; a checkpoint stores every
field of the batched GameState, so a run stops and resumes bit-exactly.

Format (the JAX package's): a numpy .npz of every field, with the JAX
package's dtypes (seed as uint32), plus `__config__`, the EnvConfig as a
JSON header, validated on load. The JAX package also writes single-env
states (no env axis); those load here as a batch of one. A checkpoint
written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from agarcl_tpu_torch.bridge import state_from_numpy, state_to_numpy
from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.state import GameState, zero_state


def save_checkpoint(path: str, cfg: EnvConfig, state: GameState) -> None:
    header = json.dumps(dataclasses.asdict(cfg))
    np.savez_compressed(path, __config__=np.frombuffer(
        header.encode(), dtype=np.uint8), **state_to_numpy(state))


def load_checkpoint(path: str, cfg: EnvConfig = None, device=None):
    """Returns (cfg, batched GameState on `device`). If cfg is given, it
    must match the stored one."""
    with np.load(path) as data:
        stored = EnvConfig(**json.loads(bytes(data["__config__"]).decode()))
        if cfg is not None and cfg != stored:
            raise ValueError(
                f"checkpoint config mismatch: stored {stored} != {cfg}")
        fields = {f: data[f] for f in data.files if f != "__config__"}
    single = zero_state(stored, 1)
    if fields["ticks"].ndim == 0:                 # one env, no env axis
        fields = {f: a[None] for f, a in fields.items()}
    for f, a in fields.items():
        want = tuple(getattr(single, f).shape[1:])
        if tuple(a.shape[1:]) != want:
            raise ValueError(f"checkpoint field {f} has shape {a.shape}, "
                             f"expected (N,) + {want}")
    return stored, state_from_numpy(fields, device)

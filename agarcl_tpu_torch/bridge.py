"""numpy bridge between a batched (vmapped) JAX GameState and the port's.

The game has no weights: its state is what crosses between the two
packages. A JAX state goes in as `{f: np.asarray(getattr(s, f))}` for every
field; the round trip is exact (seed uint32 <-> int64 holding the same
value).
"""

from __future__ import annotations

import numpy as np
import torch

from agarcl_tpu_torch.state import STATE_FIELDS, GameState


def state_from_numpy(fields: dict, device=None) -> GameState:
    """dict of batched numpy arrays (JAX field names) -> GameState."""
    missing = set(STATE_FIELDS) - set(fields)
    if missing:
        raise KeyError(f"missing state fields: {sorted(missing)}")
    kw = {}
    for f in STATE_FIELDS:
        a = np.asarray(fields[f])
        if f == "seed":
            a = a.astype(np.uint32).astype(np.int64)
        kw[f] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return GameState(**kw)


def state_to_numpy(state: GameState) -> dict:
    """GameState -> dict of numpy arrays with the JAX package's dtypes
    (seed back to uint32)."""
    out = {}
    for f in STATE_FIELDS:
        a = getattr(state, f).detach().cpu().numpy()
        if f == "seed":
            a = a.astype(np.uint32)
        out[f] = a
    return out

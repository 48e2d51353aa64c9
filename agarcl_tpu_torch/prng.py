"""Counter-based deterministic RNG, bit-identical to agarcl_tpu/prng.py.

SPEC.md pin D2: every random draw is a pure function of (seed, stream, tick,
slot, axis) through the `lowbias32` finalizer. No generator state exists, so
the port needs no `torch.Generator`.

Torch has no `>>` on uint32 for CPU tensors, so the hash runs in int64
holding values in [0, 2^32) and masks with 0xFFFFFFFF after every step.
The 32x32-bit products are split into 16-bit halves so that no
intermediate leaves int64 (a signed overflow would be undefined). The CUDA
kernels hash in native uint32_t (csrc/common.cuh).
"""

from __future__ import annotations

import torch

# Stream identifiers (must match agarcl_tpu/prng.py and csrc/common.cuh).
STREAM_PELLET = 1
STREAM_VIRUS = 2
STREAM_RESPAWN = 3
STREAM_BOT = 4
STREAM_FOOD_VIRUS = 5
STREAM_INIT = 6

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _u32(v, device=None) -> torch.Tensor:
    """Any int (or int tensor) -> int64 tensor of its uint32 bit pattern."""
    t = torch.as_tensor(v, device=device)
    return t.to(torch.int64) & _M32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32) without int64 overflow."""
    lo = h & 0xFFFF
    hi = h >> 16
    return ((((hi * c) & 0xFFFF) << 16) + lo * c) & _M32


def _mix(h: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer (public domain, Chris Wellons)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h


def hash_u32(seed, stream, tick, slot, axis=0) -> torch.Tensor:
    """uint32 hash of the 5 counters as int64 in [0, 2^32); broadcasts."""
    dev = next((x.device for x in (seed, stream, tick, slot, axis)
                if isinstance(x, torch.Tensor)), None)
    h = _mul32(_u32(seed, dev), _GOLDEN)
    for v in (stream, tick, slot, axis):
        h = _mix(h ^ _mul32(_u32(v, dev), _GOLDEN))
    return h


def uniform(seed, stream, tick, slot, axis=0) -> torch.Tensor:
    """float32 uniform in [0, 1) with 24 bits of entropy."""
    bits = hash_u32(seed, stream, tick, slot, axis) >> 8
    return bits.to(torch.float32) * (1.0 / (1 << 24))


def uniform_range(lo, hi, seed, stream, tick, slot, axis=0) -> torch.Tensor:
    """float32 uniform in [lo, hi); lo and hi are f32 values."""
    u = uniform(seed, stream, tick, slot, axis)
    lo = torch.as_tensor(lo, dtype=torch.float32, device=u.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=u.device)
    return lo + (hi - lo) * u


def uniform_q(nq, seed, stream, tick, slot, axis=0) -> torch.Tensor:
    """int32 in [0, nq): (u24 * nq) >> 24 in two exact 12-bit halves."""
    u24 = hash_u32(seed, stream, tick, slot, axis) >> 8
    hi = u24 >> 12
    lo = u24 & 0xFFF
    return ((hi * nq + ((lo * nq) >> 12)) >> 12).to(torch.int32)


def randint_mod(n, seed, stream, tick, slot, axis=0) -> torch.Tensor:
    """int32 in [0, n) via modulo (mirrors the reference's `rand() % n`)."""
    bits = hash_u32(seed, stream, tick, slot, axis)
    return (bits % _u32(n, bits.device)).to(torch.int32)

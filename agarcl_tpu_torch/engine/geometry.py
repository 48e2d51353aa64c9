"""Scalar game-math laws on tensors (counterpart of engine/geometry.py).

Formulas follow the reference: mass<->radius (utils.hpp:8-16), the speed
laws (Engine.hpp:1296-1302), velocity ops (types.hpp:152-258) and the
boundary clamp (Engine.hpp:695-698).

FMA contract. XLA on the CPU fuses `a*b + c` into one fused multiply-add at
the sites the C++ oracle mirrors with std::fmaf (oracle/oracle.cpp). Torch
has no fma operator, so `fma32` forms the product and the sum in float64
and rounds once to f32: the product of two f32 values is exact in f64, but
the sum then rounds twice (to f64, then to f32), which can differ from a
true fma in the last bit in rare cases. The CUDA kernels use fmaf (one
fma.rn.f32) at the same sites and contract nothing else (csrc/common.cuh).
Which product of a*b + c*d XLA fuses differs from site to site; the
choices here were read off XLA's own output, and the C++ oracle's
std::fmaf sites were the starting point.

Transcendentals. XLA-CPU's f32 pow is (all but always) the correctly
rounded value, so `powf` evaluates pow in float64 and rounds once; the
CUDA kernels do the same with the double-precision pow. atan, cos and sin
(the virus-pop angles) are taken in float64 too, so the plain version and
the kernels agree on every platform; XLA's own f32 approximations of those
three differ from the correctly rounded value on about 1-2% of inputs. XLA also rewrites
a division by a constant into a product with the f32 reciprocal, so the
radius law is sqrt(mass * f32(1/pi)) here and in the kernels. Torch's f32
sqrt on the CPU is not always correctly rounded (about 0.7% of random
inputs are off by one ulp), so `sqrt32` takes the root in float64, which
rounds correctly; CUDA's sqrtf is IEEE.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from agarcl_tpu_torch import constants as C

PI32 = float(np.float32(math.pi))
INV_PI32 = float(np.float32(1.0 / math.pi))


def fma32(a, b, c) -> torch.Tensor:
    """a*b + c with the product unrounded, as f32 (see module docstring)."""
    a, b, c = (torch.as_tensor(x, dtype=torch.float32) for x in (a, b, c))
    return (a.double() * b.double() + c.double()).to(torch.float32)


def norm2(x, y) -> torch.Tensor:
    """x*x + y*y in XLA-CPU's contracted form fma(x, x, y*y)."""
    return fma32(x, x, y * y)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root."""
    return torch.sqrt(x.double()).to(torch.float32)


def powf(x: torch.Tensor, e: float) -> torch.Tensor:
    """f32 x ** f32(e), computed in float64 and rounded once."""
    return torch.pow(x.double(), float(np.float32(e))).to(torch.float32)


def radius(mass) -> torch.Tensor:
    """radius = sqrt(mass / pi) (utils.hpp:8-11), as XLA evaluates it."""
    m = torch.as_tensor(mass).to(torch.float32)
    return sqrt32(m * INV_PI32)


def max_speed(mass) -> torch.Tensor:
    """v_max = 300 * max(mass, 1)^-0.439 (Engine.hpp:1300-1302), pinned as
    the negative-exponent product like geometry.py::max_speed."""
    m = torch.as_tensor(mass).to(torch.float32)
    return C.CELL_MAX_SPEED * powf(torch.clamp(m, min=1.0), -0.439)


def split_speed(mass) -> torch.Tensor:
    """clamp(3 * v_max^1.2, 20, 130) (Engine.hpp:1296-1298)."""
    return torch.clamp(3.0 * powf(max_speed(mass), 1.2), 20.0, 130.0)


def vec_norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Norm of (..., 2) vectors as sqrt(fma(x, x, y*y))."""
    n = sqrt32(norm2(v[..., 0], v[..., 1]))
    return n[..., None] if keepdim else n


def normed(v: torch.Tensor) -> torch.Tensor:
    """Safe unit vector; zero stays zero."""
    return v / torch.clamp(vec_norm(v, keepdim=True), min=1e-12)


def decelerate(v: torch.Tensor, decel: float, dt: float) -> torch.Tensor:
    """Velocity::decelerate: shrink each component by ratio*(decel*dt),
    stopping at zero (types.hpp:212-228); decel*dt is one f32 constant."""
    mag = vec_norm(v, keepdim=True)
    ratio = v / torch.clamp(mag, min=1e-12)
    dv = ratio * float(np.float32(decel) * np.float32(dt))
    return torch.where(dv.abs() <= v.abs(), v - dv, torch.zeros_like(v))


def direction(v: torch.Tensor) -> torch.Tensor:
    """Velocity::direction(): the reference's atan(dx/dy) convention
    (types.hpp:178-185); (0,0) pinned to angle 0. (..., 2) -> (...)."""
    dx, dy = v[..., 0], v[..., 1]
    both_zero = (dx == 0.0) & (dy == 0.0)
    ratio = torch.where(dy == 0.0, torch.sign(dx) * math.inf,
                        dx / torch.where(dy == 0.0, torch.ones_like(dy), dy))
    ang = torch.atan(ratio.double()).to(torch.float32)
    ang = torch.where(dx < 0, torch.where(dy > 0, ang + PI32, ang - PI32),
                      ang)
    return torch.where(both_zero, torch.zeros_like(ang), ang)


def boundary_clamp(pos: torch.Tensor, rad: torch.Tensor, arena_w: float,
                   arena_h: float) -> torch.Tensor:
    """x = max(0, max(min(x, W - r), r)) per axis (SPEC Q8).
    pos: (..., 2); rad: broadcastable to (...)."""
    rad = torch.as_tensor(rad, dtype=torch.float32, device=pos.device)
    rad = rad.expand(pos.shape[:-1])
    hi = torch.stack([arena_w - rad, arena_h - rad], dim=-1)
    lo = torch.stack([rad, rad], dim=-1)
    return torch.clamp(torch.maximum(torch.minimum(pos, hi), lo), min=0.0)

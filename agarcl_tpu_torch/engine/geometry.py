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
CUDA kernels do the same with the double-precision pow. XLA-CPU's f32
atan, cos and sin are glibc's atanf / cosf / sinf (the atan is lowered to
atan2f(x, 1), which glibc answers with atanf), which are not correctly
rounded: `atan32` is fdlibm's float atanf (argument reduction at 7/16,
11/16, 19/16 and 39/16, an 11-term odd polynomial, every operation
rounded to f32), `cos32` / `sin32` are glibc's sincosf (the argument in
double, quadrant from x * 2/pi scaled by 2^24, a degree-8 double
polynomial, one rounding to f32). Both reproduce XLA's results bit for
bit over 2^20 inputs of each range the game feeds them
(tests/test_torch_engine.py); csrc/common.cuh has the same functions.
XLA also rewrites
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
    ang = atan32(ratio)
    ang = torch.where(dx < 0, torch.where(dy > 0, ang + PI32, ang - PI32),
                      ang)
    return torch.where(both_zero, torch.zeros_like(ang), ang)


_ATAN_HI = (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01,
            1.5707962513e+00)
_ATAN_LO = (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08,
            7.5497894159e-08)
_ATAN_T = (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
           -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
           6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
           -3.6531571299e-02, 1.6285819933e-02)


def atan32(x) -> torch.Tensor:
    """glibc's f32 atanf (fdlibm's s_atanf.c), XLA-CPU's f32 atan: every
    operation in f32, none fused."""
    x = torch.as_tensor(x, dtype=torch.float32)
    ix = x.view(torch.int32) & 0x7FFFFFFF
    ax = x.abs()
    one = 1.0
    idn = torch.where(ix < 0x3F300000, 0, torch.where(
        ix < 0x3F980000, 1, torch.where(ix < 0x401C0000, 2, 3)))
    red = torch.stack([(2.0 * ax - one) / (2.0 + ax), (ax - one) / (ax + one),
                       (ax - 1.5) / (one + 1.5 * ax), -one / ax], dim=-1)
    small = ix < 0x3EE00000
    xr = torch.where(small, x, torch.gather(red, -1, idn[..., None])[..., 0])
    t = [torch.tensor(v, dtype=torch.float32) for v in _ATAN_T]
    z = xr * xr
    w = z * z
    s1 = z * (t[0] + w * (t[2] + w * (t[4] + w * (t[6] + w * (t[8]
                                                          + w * t[10])))))
    s2 = w * (t[1] + w * (t[3] + w * (t[5] + w * (t[7] + w * t[9]))))
    hi = torch.tensor(_ATAN_HI, dtype=torch.float32, device=x.device)[idn]
    lo = torch.tensor(_ATAN_LO, dtype=torch.float32, device=x.device)[idn]
    zz = hi - ((xr * (s1 + s2) - lo) - xr)
    out = torch.where(small, xr - xr * (s1 + s2), torch.where(x < 0, -zz, zz))
    huge = torch.where(x > 0, 1.0, -1.0) * float(
        np.float32(_ATAN_HI[3]) + np.float32(_ATAN_LO[3]))
    out = torch.where(ix >= 0x4C000000, huge.to(torch.float32), out)
    out = torch.where(ix < 0x31000000, x, out)
    return torch.where(torch.isnan(x), x, out)


_SC_C = tuple(float.fromhex(v) for v in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SC_S = tuple(float.fromhex(v) for v in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))
_HPI_INV_2P24 = float.fromhex("0x1.45F306DC9C883p+23")   # 2/pi * 2^24
_HPI = float.fromhex("0x1.921FB54442D18p0")


def _sincos32(y, cos: bool) -> torch.Tensor:
    """glibc's f32 sinf / cosf for |y| < 120 (sincosf.h's reduce_fast and
    sinf_poly in double, one rounding to f32); larger arguments, which the
    game never forms, are taken in float64 and rounded once."""
    y = torch.as_tensor(y, dtype=torch.float32)
    x = y.double()
    top = (y.view(torch.int32) >> 20) & 0x7FF
    r = x * _HPI_INV_2P24
    n = (r.to(torch.int32) + 0x800000) >> 24
    small = top < 0x3F4
    n = torch.where(small, 0, n)
    xr = torch.where(small, x, x - n.double() * _HPI)
    q = n & 3
    sgn = torch.where((q == 1) | (q == 2), -1.0, 1.0).double()
    xs = torch.where(small, x, xr * sgn)
    x2 = xr * xr
    odd = ((n ^ 1) if cos else n) & 1
    neg = torch.where((n & 2) != 0, -1.0, 1.0).double()
    c0, c1, c2, c3, c4 = _SC_C
    s1_, s2_, s3_ = _SC_S
    x3 = xs * x2
    sres = (xs + x3 * s1_) + (x3 * x2) * (s2_ + x2 * s3_)
    x4 = x2 * x2
    cres = ((c0 * neg + x2 * (c1 * neg)) + x4 * (c2 * neg)
            + (x4 * x2) * (c3 * neg + x2 * (c4 * neg)))
    out = torch.where(odd != 0, cres, sres).to(torch.float32)
    tiny = top < 0x398
    out = torch.where(tiny, torch.ones_like(y) if cos else y, out)
    far = torch.cos(x) if cos else torch.sin(x)
    return torch.where(top >= 0x42F, far.to(torch.float32), out)


def cos32(y) -> torch.Tensor:
    """glibc's f32 cosf, XLA-CPU's f32 cos."""
    return _sincos32(y, True)


def sin32(y) -> torch.Tensor:
    """glibc's f32 sinf, XLA-CPU's f32 sin."""
    return _sincos32(y, False)


def boundary_clamp(pos: torch.Tensor, rad: torch.Tensor, arena_w: float,
                   arena_h: float) -> torch.Tensor:
    """x = max(0, max(min(x, W - r), r)) per axis (SPEC Q8).
    pos: (..., 2); rad: broadcastable to (...)."""
    rad = torch.as_tensor(rad, dtype=torch.float32, device=pos.device)
    rad = rad.expand(pos.shape[:-1])
    hi = torch.stack([arena_w - rad, arena_h - rad], dim=-1)
    lo = torch.stack([rad, rad], dim=-1)
    return torch.clamp(torch.maximum(torch.minimum(pos, hi), lo), min=0.0)

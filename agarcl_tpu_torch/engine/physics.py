"""Cell movement and same-player collision relaxation (counterpart of
engine/physics.py).

Batched over (N envs, P players, Cc cell slots). Reference semantics:
move_player (Engine.hpp:609-630), check_player_self_collisions
(Engine.hpp:763-794), prevent_overlap (:857-888),
elastic_collision_between_balls (:893-938), avoid_static_overlap
(:701-749), separate_cells (:803-848). SPEC M6 pins the relaxation as 5
Jacobi passes over a mutual-nearest matching (each cell pairs with its
lowest-rank touching partner; a pair is active iff the choice is mutual),
then one avoid_static_overlap pass. fma32 marks the sites XLA-CPU fuses
(geometry.py docstring).
"""

from __future__ import annotations

import torch

from agarcl_tpu_torch import constants as C
from agarcl_tpu_torch.engine import geometry as G
from agarcl_tpu_torch.engine.geometry import fma32

_BIG = 2**30


def _w(mask, a, b):
    return torch.where(mask, a, b)


def move_cells(target, pos, split_vel, mass, alive, arena_w, arena_h, dt):
    """Per-cell movement (Engine.hpp:609-630): velocity = 3*(target-pos)
    clamped to v_max(mass); pos += (vel + split_vel)*dt; split_vel
    decelerates by 80/s; boundary clamp. target (N,P,2); pos (N,P,Cc,2).

    Returns (pos, vel, split_vel)."""
    # XLA reassociates (3*d)*scale into d*(scale*3); the kernel mirrors it
    d = target[..., None, :] - pos
    speed = G.vec_norm(3.0 * d, keepdim=True)
    lim = G.max_speed(mass)[..., None]
    scale = torch.where(speed > lim, lim / torch.clamp(speed, min=1e-12),
                        torch.ones_like(speed))
    vel = d * (scale * 3.0)
    pos = fma32(vel + split_vel, dt, pos)
    split_vel = G.decelerate(split_vel, C.SPLIT_DECELERATION, dt)
    pos = G.boundary_clamp(pos, G.radius(mass), arena_w, arena_h)
    keep = alive[..., None]
    z = torch.zeros_like(pos)
    return _w(keep, pos, z), _w(keep, vel, z), _w(keep, split_vel, z)


def _touch_matrix(pos, mass, alive):
    """(N,P,Cc,Cc) bool: distinct live cells i, j of a player touch."""
    d = pos[..., None, :, :] - pos[..., :, None, :]         # pos_j - pos_i
    dist2 = G.norm2(d[..., 0], d[..., 1])
    rad = G.radius(mass)
    rsum = rad[..., :, None] + rad[..., None, :]
    Cc = pos.shape[-2]
    not_self = ~torch.eye(Cc, dtype=torch.bool, device=pos.device)
    both = alive[..., :, None] & alive[..., None, :] & not_self
    return both & (rsum * rsum >= dist2)


def _mutual_match(touch, rank):
    """Pair (i, j) is active iff touching and each is the other's
    lowest-rank touching partner (SPEC M6)."""
    key = torch.where(touch, rank[..., None, :].expand_as(touch),
                      torch.full_like(touch, _BIG, dtype=torch.int32))
    minkey = key.min(-1, keepdim=True).values
    chose = touch & (key == minkey)
    return chose & chose.transpose(-1, -2)


def _elastic(vel_a, vel_b, mass_a, mass_b, dxy, dist):
    """elastic_collision_between_balls: updates the velocity of the
    smaller-mass cell only (both when equal). Returns the new (vel_a,
    vel_b) twice: in the form of XLA's velocity outputs, then in that of
    its position outputs (`_prevent_overlap`)."""
    n = dxy / torch.clamp(dist, min=1e-12)[..., None]
    nx, ny = n[..., 0], n[..., 1]
    tx, ty = -ny, nx
    # which product of each a*b + c*d XLA-CPU fuses was read off its
    # vmapped engine_tick (the context VecEnv runs), per fusion: the new
    # velocities and the new positions of a pass are two fusions, and the
    # tangential products are fused on (v.y, t.y) where the fusion sees
    # the negation of n.y and on (v.x, t.x) where -n.y arrives formed
    dp_n1 = fma32(vel_a[..., 0], nx, vel_a[..., 1] * ny)
    dp_n2 = fma32(vel_b[..., 0], nx, vel_b[..., 1] * ny)
    m1 = mass_a.to(torch.float32)
    m2 = mass_b.to(torch.float32)
    msum = torch.clamp(m1 + m2, min=1.0)
    v1 = fma32(dp_n1, m1 - m2, (2.0 * m2) * dp_n2) / msum
    v2 = fma32(dp_n2, m2 - m1, (2.0 * m1) * dp_n1) / msum
    out = []
    for tx_first in (False, True):
        if tx_first:
            dp_t1 = fma32(vel_a[..., 0], tx, vel_a[..., 1] * ty)
            dp_t2 = fma32(vel_b[..., 0], tx, vel_b[..., 1] * ty)
        else:
            dp_t1 = fma32(vel_a[..., 1], ty, vel_a[..., 0] * tx)
            dp_t2 = fma32(vel_b[..., 1], ty, vel_b[..., 0] * tx)
        new_a = torch.stack([fma32(tx, dp_t1, nx * v1),
                             fma32(ty, dp_t1, ny * v1)], dim=-1)
        new_b = torch.stack([fma32(tx, dp_t2, nx * v2),
                             fma32(ty, dp_t2, ny * v2)], dim=-1)
        out.append((_w((mass_a <= mass_b)[..., None], new_a, vel_a),
                    _w((mass_a >= mass_b)[..., None], new_b, vel_b)))
    return out


def _l1_ratio(dxy):
    """x_ratio = dx/(|dx|+|dy|), y_ratio = dy/(|dx|+|dy|)."""
    denom = dxy[..., 0].abs() + dxy[..., 1].abs()
    return dxy / torch.clamp(denom, min=1e-12)[..., None]


def _avoid_static_overlap(pos_a, vel_a, pos_b, vel_b, rad_a, rad_b,
                          arena_w, arena_h):
    """avoid_static_overlap: push the pair apart along the L1-normalized
    axis by the overlap depth; a cell pinned at a border moves the full
    depth and zeroes that velocity component (exact float equality)."""
    dxy = pos_b - pos_a
    dist = G.vec_norm(dxy)
    target_dist = rad_a + rad_b
    overlapping = dist <= target_dist
    rd = _l1_ratio(dxy) * (target_dist - dist)[..., None]

    def border_scale(pos, rad, vel):
        at_lo = pos == torch.stack([rad, rad], dim=-1)
        at_hi = pos == torch.stack([arena_w - rad, arena_h - rad], dim=-1)
        at = at_lo | at_hi
        scale = torch.where(at, 1.0, 0.5).to(torch.float32)
        return scale, _w(at, torch.zeros_like(vel), vel)

    scale_a, vel_a2 = border_scale(pos_a, rad_a, vel_a)
    scale_b, vel_b2 = border_scale(pos_b, rad_b, vel_b)
    new_a = fma32(-rd, scale_a, pos_a)
    new_b = fma32(rd, scale_b, pos_b)
    new_a = G.boundary_clamp(new_a, rad_a, arena_w, arena_h)
    new_b = G.boundary_clamp(new_b, rad_b, arena_w, arena_h)
    ow = overlapping[..., None]
    return (_w(ow, new_a, pos_a), _w(ow, vel_a2, vel_a),
            _w(ow, new_b, pos_b), _w(ow, vel_b2, vel_b))


def _separate_cells(pos_a, pos_b, mass_a, mass_b, rad_a, rad_b, target):
    """separate_cells: moves only the smaller cell by the full depth, its
    direction decided by the mass / target-distance sign votes."""
    dxy = pos_b - pos_a
    dist = G.vec_norm(dxy)
    target_dist = rad_a + rad_b
    overlapping = dist <= target_dist
    ratio = _l1_ratio(dxy)
    depth = target_dist - dist
    da = target - pos_a
    db = target - pos_b
    diff_a = G.norm2(da[..., 0], da[..., 1])
    diff_b = G.norm2(db[..., 0], db[..., 1])
    sign1 = torch.where(mass_a < mass_b, 1, -1)
    sign2 = torch.where(diff_a >= diff_b, 1, -1)
    sign = torch.where(sign1 == sign2, sign2, 0).to(torch.float32)
    dx, dy = dxy[..., 0], dxy[..., 1]
    one = torch.ones_like(dx)
    move_x = torch.where(dx >= 0, -one, one) * ratio[..., 0] * depth * sign
    move_y = torch.where(dy >= 0, -one, one) * ratio[..., 1] * depth * sign
    move = torch.stack([move_x, move_y], dim=-1)
    a_small = (mass_a < mass_b)[..., None]
    ow = overlapping[..., None]
    return (_w(ow & a_small, pos_a + move, pos_a),
            _w(ow & ~a_small, pos_b + move, pos_b))


def _settle(pos_a, vel_a, svel_a, mass_a, pos_b, vel_b, svel_b, mass_b,
            rad_a, rad_b, target, arena_w, arena_h, dt):
    """The end of prevent_overlap from the moved-back positions and the new
    velocities: move both forward one dt, the static/separate fallback if
    still touching, the boundary clamp."""
    pos_a = fma32(vel_a + svel_a, dt, pos_a)
    pos_b = fma32(vel_b + svel_b, dt, pos_b)
    d1 = pos_b - pos_a
    rs = rad_a + rad_b
    still = rs * rs >= G.norm2(d1[..., 0], d1[..., 1])
    near_mass = (mass_a - mass_b).abs() <= 10

    sa_pa, sa_va, sa_pb, sa_vb = _avoid_static_overlap(
        pos_a, vel_a, pos_b, vel_b, rad_a, rad_b, arena_w, arena_h)
    sc_pa, sc_pb = _separate_cells(pos_a, pos_b, mass_a, mass_b, rad_a,
                                   rad_b, target)
    use_static = (still & near_mass)[..., None]
    use_sep = (still & ~near_mass)[..., None]
    pos_a = _w(use_static, sa_pa, _w(use_sep, sc_pa, pos_a))
    pos_b = _w(use_static, sa_pb, _w(use_sep, sc_pb, pos_b))
    vel_a = _w(use_static, sa_va, vel_a)
    vel_b = _w(use_static, sa_vb, vel_b)
    pos_a = G.boundary_clamp(pos_a, rad_a, arena_w, arena_h)
    pos_b = G.boundary_clamp(pos_b, rad_b, arena_w, arena_h)
    return pos_a, vel_a, pos_b, vel_b


def _prevent_overlap(pos_a, vel_a, svel_a, mass_a, pos_b, vel_b, svel_b,
                     mass_b, target, arena_w, arena_h, dt):
    """prevent_overlap: move both back one dt, elastic collision (normals
    from the pre-move-back positions), then `_settle`. XLA-CPU computes the
    new velocities and the new positions in two fusions, each with its own
    form of the elastic velocities (`_elastic`), so each output is settled
    from its own."""
    rad_a, rad_b = G.radius(mass_a), G.radius(mass_b)
    dxy0 = pos_b - pos_a
    dist0 = G.vec_norm(dxy0)
    back_a = fma32(-(vel_a + svel_a), dt, pos_a)
    back_b = fma32(-(vel_b + svel_b), dt, pos_b)
    (va_v, vb_v), (va_p, vb_p) = _elastic(vel_a, vel_b, mass_a, mass_b,
                                          dxy0, dist0)
    pos_a, vel_a, pos_b, vel_b = _settle(
        back_a, va_v, svel_a, mass_a, back_b, vb_v, svel_b, mass_b, rad_a,
        rad_b, target, arena_w, arena_h, dt)
    # the pairs whose two forms differ in a bit (few) settle their
    # positions again from the position outputs' form
    differ = ((va_p != va_v) | (vb_p != vb_v)).any(-1)
    if bool(differ.any()):
        idx = differ.nonzero(as_tuple=True)

        def pick(x):
            return x.expand(differ.shape + x.shape[differ.dim():])[idx]
        pa, _, pb, _ = _settle(*(pick(x) for x in (
            back_a, va_p, svel_a, mass_a, back_b, vb_p, svel_b, mass_b,
            rad_a, rad_b, target)), arena_w, arena_h, dt)
        pos_a = pos_a.clone()
        pos_b = pos_b.clone()
        pos_a[idx] = pa
        pos_b[idx] = pb
    return pos_a, vel_a, pos_b, vel_b


def self_collisions(pos, vel, split_vel, mass, alive, rank, target,
                    arena_w, arena_h, dt):
    """check_player_self_collisions under SPEC M6: 5 Jacobi passes of
    mutually matched prevent_overlap, then one avoid_static_overlap pass.
    Shapes (N,P,Cc,...); target (N,P,2)."""

    def apply_pairs(pos, vel, static):
        # every ordered pair (i as "a", j as "b") is evaluated by
        # broadcasting, then the matched lower-rank-first pairs are picked
        touch = _touch_matrix(pos, mass, alive)
        M = _mutual_match(touch, rank)
        Mlow = M & (rank[..., :, None] < rank[..., None, :])   # (..., i, j)
        pa, va = pos[..., :, None, :], vel[..., :, None, :]
        pb, vb = pos[..., None, :, :], vel[..., None, :, :]
        ma, mb = mass[..., :, None], mass[..., None, :]
        if static:
            npa, nva, npb, nvb = _avoid_static_overlap(
                pa, va, pb, vb, G.radius(ma), G.radius(mb), arena_w,
                arena_h)
        else:
            npa, nva, npb, nvb = _prevent_overlap(
                pa, va, split_vel[..., :, None, :], ma, pb, vb,
                split_vel[..., None, :, :], mb, target[..., None, None, :],
                arena_w, arena_h, dt)
        ml = Mlow[..., None]
        zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
        # each cell is in at most one matched pair: the masked sums pick
        # its single update exactly
        upd_a_pos = _w(ml, npa, zero).sum(-2)
        upd_a_vel = _w(ml, nva, zero).sum(-2)
        upd_b_pos = _w(ml, npb, zero).sum(-3)
        upd_b_vel = _w(ml, nvb, zero).sum(-3)
        has_a = Mlow.any(-1)[..., None]
        has_b = Mlow.any(-2)[..., None]
        new_pos = _w(has_a, upd_a_pos, _w(has_b, upd_b_pos, pos))
        new_vel = _w(has_a, upd_a_vel, _w(has_b, upd_b_vel, vel))
        return new_pos, new_vel

    for _ in range(5):
        pos, vel = apply_pairs(pos, vel, False)
    pos, vel = apply_pairs(pos, vel, True)
    keep = alive[..., None]
    z = torch.zeros_like(pos)
    return _w(keep, pos, z), _w(keep, vel, z)

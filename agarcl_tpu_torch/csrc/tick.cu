// Kernel K1: k whole env steps per launch on the resident state planes.
//
// Replaces the TPU kernel agarcl_tpu/ops/fused_tick.py::_make_kernel in
// its n_steps mode (launched by _multi_step_raw_core), for rosters of up to
// 9 players: one or more agents plus the scripted bots. For each step it
// applies the agent actions (env.py::apply_actions), runs ticks_per_step
// engine ticks (engine/tick.py: bot decisions, movement and the 5-pass
// Jacobi relax, virus events, pellet eat, auto-split, food eat, feed,
// split, placement, recombine, decay, cross-player eating, food movement
// with virus feeding, regen), then writes that step's RAM frame for every
// agent (ram_frame.cuh) and every player's (mass, alive) row. With null
// action planes and a tick count per step it is the partial-step chain of
// agarcl_tpu/ops/fused_tick.py::fused_engine_tick (kernel_nosteps): n
// ticks with no action phase, the one-tick calls between the frames of a
// step that returns several (ops/fused_step.py).
// Wrapper and plain version: agarcl_tpu_torch/ops/fused_tick.py.
//
// Design: one warp per env, B envs per block (B = 8, 256 threads, where
// two blocks of 8 envs fit on an SM; halved until they do; a launch is
// refused if one env does not fit). At launch start the block copies its B
// envs' columns of the (feature, N) planes into shared memory with
// cp.async (a plane row is B contiguous words), and stores them back at
// the end, so the planes are read and written once per launch and the
// ticks touch shared memory only. The TPU kernel's machinery — envs in
// vector lanes, VMEM-scratch chunk loops, log-shift prefix sums, parking
// dead pellets at 1e9 — has no counterpart. The 32 lanes of the warp split
// the order-free phases (team.cuh): the pellet eat (the cells in (pid,
// rank) order, each against every lane's pellets at once, with flags of
// the pellets an earlier rank group took; the reaches are fixed at the
// phase's start), the food eat (a lane per food, gains by shared-memory
// int atomics), the food movement (hits per virus an int sum, the source
// food a min over f, the dead and bursting slots lowest-index mins), the
// regen (alive counts by a warp sum, the first dead slots by ballot prefix
// ranks), the bots' nearest pellet (a (distance bits, j) min), the virus
// events' best (rank, virus) pair (a lane per virus), movement and ranks
// (a lane per cell), the relaxation, cell order and recombine (a lane per
// player: a player's cells keep the serial walk and sum order, over live
// cells as bit sets) and the RAM frame. Lane 0 runs the rest in order, as
// the scalar C++ oracle (oracle/oracle.cpp::engine_tick) does: the virus
// events' claims and pops, feeds into the shared ring, splits and ids,
// decay, cross-player eating, the burst's spawn and virus regen.
//
// Several players. The plain engine resolves every contest at once by
// (pid, rank) keys (SPEC M1-M5); here players are walked in pid order and
// cells in rank order, and each phase keeps the plain engine's snapshot:
// pellets and foods go to the first eater in that walk (and the cells of
// its rank); a player's virus event is its best (rank, virus) pair over
// the viruses alive at the phase's start, and it is dropped, with no
// fallback, when a lower pid claimed that virus; foods enter the shared
// ring in (pid, rank) order; new cells take ids kind by kind (pops of all
// players, then auto-splits, then splits); cross-player eating tests the
// masses and live cells of its start (so an eaten cell still eats, and a
// gain is never seen by a later eater) and sums the gains in int32. The
// bot pass reads the start-of-tick state. The player capacity PC is a
// template argument chosen at launch from P (1, 2 or 9).
//
// What bounds it on Hopper: latency. A warp runs one env's phases one
// after another, about 25 warp barriers a tick, lane 0 alone in the serial
// ones; 24 warps share an SM (registers and shared memory) and cannot hide
// those chains. Per step the RAM frame's kp sequential picks cost about
// as much as a tick; per tick the pellet eat, the movement and relaxation
// and the food movement most (scripts/k1_phase_cycles.py measures lane
// 0's cycles per phase). The least work of a call is one read and one
// write of the planes, the pellet-eat distance tests and one key
// evaluation per live pellet and virus per frame
// (chip_smoke.py::_tick_work), bytes-bound on the main path.
#include "ram_frame.cuh"

#ifndef __CUDACC__
#include <cstddef>
#include <vector>
#endif

namespace agarcl {

constexpr int BOT_ACTION_PERIOD = 10;
constexpr uint32_t STREAM_BOT = 4;
constexpr float SHY_RADIUS = 25.0f;
constexpr float AGGRESSIVE_RADIUS = 20.0f;
constexpr int CELL_EAT_REQUIREMENT = 25;
constexpr int MC = MAX_CELLS;       // cell slots per player (params.py)
constexpr int N_PLANES = 41;
constexpr int K1_MAX_ENVS = 8;      // envs (warps) per block

struct V2 { float x, y; };

// One player's cell slots in its env's shared-memory state.
struct Cells {
  float *x, *y, *vx, *vy, *sx, *sy;
  int *m, *id, *rec;
  uint8_t* al;
};

struct NewCell { float x, y, vx, vy, sx, sy; int m, rec; };

// a virus pop's candidates are a function of these (disrupt_candidates)
struct Pop { float vx, vy, cvx, cvy; int pop_mass, num_new; };

// One player's scalar state in its env's shared-memory state.
struct Player {
  float &tx, &ty, &anti_team;
  int &action, &split_cd, &feed_cd, &elapsed, &last_decay;
  int* vticks;
  int &vptr, &food_eaten, &highest, &viruses_eaten, &cells_eaten;
};

// One env's state for the launch, in shared memory: its column of every
// plane whose length is fixed by the player capacity (a player's cells at
// q * MC + i, as the planes' rows), then one tick's scratch. The planes of
// runtime length (pellets, viruses, foods) and the RAM frame's keys follow
// it in the env's region (Layout).
template <int PC>
struct Hot {
  float tx[PC], ty[PC];
  int action[PC], split_cd[PC], feed_cd[PC], elapsed[PC], last_decay[PC];
  float anti_team[PC];
  int vticks[PC * MAX_TICKS_RING];
  int vptr[PC], food_eaten[PC], highest[PC], viruses_eaten[PC],
      cells_eaten[PC];
  float cx[PC * MC], cy[PC * MC], cvx[PC * MC], cvy[PC * MC];
  float svx[PC * MC], svy[PC * MC];
  int cmass[PC * MC], cid[PC * MC], crecomb[PC * MC];
  int next_id, fnext, ticks, seed;
  uint8_t calive[PC * MC];
  // scratch of one tick
  int rank[PC * MC], order[PC * MC];
  float r2[PC * MC];
  int n_start[PC], palive[PC], best[PC], pm[PC];
  uint32_t live[PC];            // live cells after the relaxation
  V2 cen[PC];
  // the pellet eat's flags of lane l's pellets of a chunk (bit t: pellet
  // base + l + 32 t): dead at the phase's start, taken by an earlier rank
  // group, won by the current one
  uint32_t pdead[LANES], ptaken[LANES], pwon[LANES];
  FrameScratch<PC> fs;
};

// Where each plane's rows sit in an env's region of shared memory, and
// the region's size. Built on the host (make_layout) for one launch.
struct Layout {
  int off[N_PLANES], rows[N_PLANES], esz[N_PLANES];
  int pk, vx, vy, vvx, vvy, vmass, vhits, valive, fx, fy, fvx, fvy, fal;
  int keys, sel, hits, src_f;   // scratch: the RAM frame's keys and
                                // picks, virus feeding
  int bytes;               // the region's stride
};

// the 41 plane pointers of one launch, in _SPLIT_PLAN order
struct PlaneArray { void* p[N_PLANES]; };

// One env's region in shared memory (on the host, a buffer).
template <int PC>
struct EnvS {
  uint8_t* base;
  const Layout& L;
  HD Hot<PC>& h() const { return *reinterpret_cast<Hot<PC>*>(base); }
  template <class E>
  HD E* at(int off) const { return reinterpret_cast<E*>(base + off); }
  HD int* pk() const { return at<int>(L.pk); }
  HD float* vxs() const { return at<float>(L.vx); }
  HD float* vys() const { return at<float>(L.vy); }
  HD float* vvx() const { return at<float>(L.vvx); }
  HD float* vvy() const { return at<float>(L.vvy); }
  HD int* vmasses() const { return at<int>(L.vmass); }
  HD int* vhits() const { return at<int>(L.vhits); }
  HD uint8_t* valives() const { return at<uint8_t>(L.valive); }
  HD float* fx() const { return at<float>(L.fx); }
  HD float* fy() const { return at<float>(L.fy); }
  HD float* fvx() const { return at<float>(L.fvx); }
  HD float* fvy() const { return at<float>(L.fvy); }
  HD uint8_t* fal() const { return at<uint8_t>(L.fal); }
  HD uint32_t* keys() const { return at<uint32_t>(L.keys); }
  HD uint32_t* sel() const { return at<uint32_t>(L.sel); }
  HD int* hits() const { return at<int>(L.hits); }
  HD int* src_f() const { return at<int>(L.src_f); }
  HD Cells c(int q) const {
    Hot<PC>& H = h();
    const int o = q * MC;
    return {H.cx + o, H.cy + o, H.cvx + o, H.cvy + o, H.svx + o, H.svy + o,
            H.cmass + o, H.cid + o, H.crecomb + o, H.calive + o};
  }
  HD Player pl(int q) const {
    Hot<PC>& H = h();
    return {H.tx[q], H.ty[q], H.anti_team[q], H.action[q], H.split_cd[q],
            H.feed_cd[q], H.elapsed[q], H.last_decay[q],
            H.vticks + q * MAX_TICKS_RING, H.vptr[q], H.food_eaten[q],
            H.highest[q], H.viruses_eaten[q], H.cells_eaten[q]};
  }
  // the RAM frame's reads (ram_frame.cuh)
  HD float cx(int f) const { return h().cx[f]; }
  HD float cy(int f) const { return h().cy[f]; }
  HD float cvx(int f) const { return h().cvx[f]; }
  HD float cvy(int f) const { return h().cvy[f]; }
  HD int cmass(int f) const { return h().cmass[f]; }
  HD bool calive(int f) const { return h().calive[f] != 0; }
  HD int pkey(int j) const { return pk()[j]; }
  HD float vx(int j) const { return vxs()[j]; }
  HD float vy(int j) const { return vys()[j]; }
  HD int vmass(int j) const { return vmasses()[j]; }
  HD bool valive(int j) const { return valives()[j] != 0; }
};

// the player count a PC-capacity kernel walks (1 is known at compile time)
template <int PC>
HD int players(const EnvParams& p) { return PC == 1 ? 1 : p.P; }

// counting rank by id among live cells (state.py::cell_rank_of): cells
// with equal ids share a rank; dead cells rank after the live ones
HD int cell_rank(const Cells& c, int i) {
  const int ki = c.al[i] ? c.id[i] : BIG_I;
  int r = 0;
  for (int j = 0; j < MC; j++) {
    const int kj = c.al[j] ? c.id[j] : BIG_I;
    r += ki > kj;
  }
  return r;
}

HD V2 clamp2(const EnvParams& p, V2 v, float r) {
  return {clampb(v.x, r, p.W), clampb(v.y, r, p.H)};
}

// ------------------------------------------------------------- movement
// physics.py::move_cells for cell i
HD void move_cell(const EnvParams& p, const Cells& c, int i, float tx,
                  float ty) {
  if (!c.al[i]) {
    c.x[i] = c.y[i] = c.vx[i] = c.vy[i] = c.sx[i] = c.sy[i] = 0.0f;
    return;
  }
  const float dx = tx - c.x[i], dy = ty - c.y[i];
  const float speed = sqrtf(norm2(3.0f * dx, 3.0f * dy));
  const float lim = max_speed(float(c.m[i]));
  const float scale = speed > lim ? lim / fmaxf(speed, 1e-12f) : 1.0f;
  const float vx = dx * (scale * 3.0f), vy = dy * (scale * 3.0f);
  // the position's fusion fuses d * (scale * 3) into vel + split_vel
  float px = FMAF(FMAF(dx, scale * 3.0f, c.sx[i]), p.dt, c.x[i]);
  float py = FMAF(FMAF(dy, scale * 3.0f, c.sy[i]), p.dt, c.y[i]);
  const float mag = sqrtf(norm2(c.sx[i], c.sy[i]));
  const float ddx = c.sx[i] / fmaxf(mag, 1e-12f) * p.kdec_split;
  const float ddy = c.sy[i] / fmaxf(mag, 1e-12f) * p.kdec_split;
  c.sx[i] = fabsf(ddx) <= fabsf(c.sx[i]) ? c.sx[i] - ddx : 0.0f;
  c.sy[i] = fabsf(ddy) <= fabsf(c.sy[i]) ? c.sy[i] - ddy : 0.0f;
  const float r = radius(float(c.m[i]));
  c.x[i] = clampb(px, r, p.W);
  c.y[i] = clampb(py, r, p.H);
  c.vx[i] = vx; c.vy[i] = vy;
}

// the forms of elastic_collision_between_balls XLA computes in its fusions
enum ElasticForm { VEL_OUT, POS_OUT, DIST };

// elastic_collision_between_balls (physics.py::_elastic) in the form of
// XLA's velocity outputs, of its position outputs or of the fallback's
// distance: the tangential products fuse on (v.y, t.y) (VEL_OUT, DIST) or
// (v.x, t.x) (POS_OUT); the new x component on (t.x, dp_t), or on (n.x, v)
// (DIST)
HD void elastic(V2& va, V2& vb, int ma, int mb, float dx, float dy,
                float dist, ElasticForm form) {
  const bool tx_first = form == POS_OUT;
  const float d = fmaxf(dist, 1e-12f);
  const float nx = dx / d, ny = dy / d;
  const float tx = -ny, ty = nx;
  const float dpn1 = FMAF(va.x, nx, va.y * ny);
  const float dpn2 = FMAF(vb.x, nx, vb.y * ny);
  const float dpt1 = tx_first ? FMAF(va.x, tx, va.y * ty)
                              : FMAF(va.y, ty, va.x * tx);
  const float dpt2 = tx_first ? FMAF(vb.x, tx, vb.y * ty)
                              : FMAF(vb.y, ty, vb.x * tx);
  const float m1 = float(ma), m2 = float(mb);
  const float msum = fmaxf(m1 + m2, 1.0f);
  const float v1 = FMAF(dpn1, m1 - m2, (2.0f * m2) * dpn2) / msum;
  const float v2 = FMAF(dpn2, m2 - m1, (2.0f * m1) * dpn1) / msum;
  const V2 na = {form == DIST ? FMAF(nx, v1, tx * dpt1)
                             : FMAF(tx, dpt1, nx * v1),
                 FMAF(ty, dpt1, ny * v1)};
  const V2 nb = {form == DIST ? FMAF(nx, v2, tx * dpt2)
                             : FMAF(tx, dpt2, nx * v2),
                 FMAF(ty, dpt2, ny * v2)};
  if (ma <= mb) va = na;
  if (ma >= mb) vb = nb;
}

// avoid_static_overlap (physics.py::_avoid_static_overlap); g is the
// pair's offset for the distance and ga its offset for the axis (settle)
HD void avoid_static(const EnvParams& p, V2& pa, V2& va, V2& pb, V2& vb,
                     float ra, float rb, V2 g, V2 ga) {
  const float dist = sqrtf(norm2(g.x, g.y));
  const float td = ra + rb;
  if (!(dist <= td)) return;
  const float den = fmaxf(fabsf(ga.x) + fabsf(ga.y), 1e-12f);
  const float depth = td - dist;
  const float rdx = (ga.x / den) * depth, rdy = (ga.y / den) * depth;
  const bool ax = pa.x == ra || pa.x == p.W - ra;
  const bool ay = pa.y == ra || pa.y == p.H - ra;
  const bool bx = pb.x == rb || pb.x == p.W - rb;
  const bool by = pb.y == rb || pb.y == p.H - rb;
  V2 na = {FMAF(-rdx, ax ? 1.0f : 0.5f, pa.x),
           FMAF(-rdy, ay ? 1.0f : 0.5f, pa.y)};
  V2 nb = {FMAF(rdx, bx ? 1.0f : 0.5f, pb.x),
           FMAF(rdy, by ? 1.0f : 0.5f, pb.y)};
  pa = clamp2(p, na, ra);
  pb = clamp2(p, nb, rb);
  if (ax) va.x = 0.0f;
  if (ay) va.y = 0.0f;
  if (bx) vb.x = 0.0f;
  if (by) vb.y = 0.0f;
}

HD void avoid_static(const EnvParams& p, V2& pa, V2& va, V2& pb, V2& vb,
                     float ra, float rb) {
  const V2 d = {pb.x - pa.x, pb.y - pa.y};
  avoid_static(p, pa, va, pb, vb, ra, rb, d, d);
}

// separate_cells (physics.py::_separate_cells); g is the pair's offset
// for the distance and ga its offset for the L1 ratio (settle), the signs
// take pb - pa
HD void separate(V2& pa, V2& pb, int ma, int mb, float ra, float rb,
                 float tgx, float tgy, V2 g, V2 ga) {
  const float dx = pb.x - pa.x, dy = pb.y - pa.y;
  const float dist = sqrtf(norm2(g.x, g.y));
  const float td = ra + rb;
  if (!(dist <= td)) return;
  const float den = fmaxf(fabsf(ga.x) + fabsf(ga.y), 1e-12f);
  const float rx = ga.x / den, ry = ga.y / den;
  const float depth = td - dist;
  const float diff_a = norm2(tgx - pa.x, tgy - pa.y);
  const float diff_b = norm2(tgx - pb.x, tgy - pb.y);
  const int s1 = ma < mb ? 1 : -1;
  const int s2 = diff_a >= diff_b ? 1 : -1;
  const float sign = s1 == s2 ? float(s2) : 0.0f;
  const float mx = (dx >= 0.0f ? -1.0f : 1.0f) * rx * depth * sign;
  const float my = (dy >= 0.0f ? -1.0f : 1.0f) * ry * depth * sign;
  if (ma < mb) { pa.x = pa.x + mx; pa.y = pa.y + my; }
  else { pb.x = pb.x + mx; pb.y = pb.y + my; }
}

// the end of prevent_overlap (physics.py::_settle): from the moved-back
// positions and the new velocities, move forward, the static / separate
// fallback, the boundary clamp. The fallback's distance takes the offset
// g, its axis the offset ga (prevent_overlap).
HD void settle(const EnvParams& p, V2& pa, V2& va, V2 sa, int ma, V2& pb,
               V2& vb, V2 sb, int mb, float ra, float rb, float tgx,
               float tgy, V2 g, V2 ga) {
  pa = {FMAF(va.x + sa.x, p.dt, pa.x), FMAF(va.y + sa.y, p.dt, pa.y)};
  pb = {FMAF(vb.x + sb.x, p.dt, pb.x), FMAF(vb.y + sb.y, p.dt, pb.y)};
  const float rs = ra + rb;
  const bool still = rs * rs >= norm2(pb.x - pa.x, pb.y - pa.y);
  const int dm = ma - mb;
  if (still && (dm < 0 ? -dm : dm) <= 10) {
    avoid_static(p, pa, va, pb, vb, ra, rb, g, ga);
  } else if (still) {
    separate(pa, pb, ma, mb, ra, rb, tgx, tgy, g, ga);
  }
  pa = clamp2(p, pa, ra);
  pb = clamp2(p, pb, rb);
}

HD bool same_bits(V2 a, V2 b) {
  return float_bits(a.x) == float_bits(b.x) &&
         float_bits(a.y) == float_bits(b.y);
}

// prevent_overlap (physics.py::_prevent_overlap): the new velocities are
// settled from the velocity outputs' elastic form, the new positions from
// the position outputs' (XLA computes them in two fusions), with the
// fallback's distance from the pair moved forward in the distance's form
// and its axis in the velocity outputs' form, but for b moved back and
// forward by one rounded product where b keeps its velocity (ma < mb: the
// axis's fusions branch on it and share that product); when the two
// output forms give the same bits, as they mostly do, one settle serves
// both
HD void prevent_overlap(const EnvParams& p, V2& pa, V2& va, V2 sa, int ma,
                        V2& pb, V2& vb, V2 sb, int mb, float tgx,
                        float tgy) {
  const float ra = radius(float(ma)), rb = radius(float(mb));
  const float dx0 = pb.x - pa.x, dy0 = pb.y - pa.y;
  const float dist0 = sqrtf(norm2(dx0, dy0));
  const V2 step_b = {(vb.x + sb.x) * p.dt, (vb.y + sb.y) * p.dt};
  const V2 kept_b = {(pb.x - step_b.x) + step_b.x,
                     (pb.y - step_b.y) + step_b.y};
  pa = {FMAF(-(va.x + sa.x), p.dt, pa.x), FMAF(-(va.y + sa.y), p.dt, pa.y)};
  pb = {FMAF(-(vb.x + sb.x), p.dt, pb.x), FMAF(-(vb.y + sb.y), p.dt, pb.y)};
  V2 va_p = va, vb_p = vb, va_d = va, vb_d = vb;
  elastic(va, vb, ma, mb, dx0, dy0, dist0, VEL_OUT);
  elastic(va_p, vb_p, ma, mb, dx0, dy0, dist0, POS_OUT);
  elastic(va_d, vb_d, ma, mb, dx0, dy0, dist0, DIST);
  const V2 fa = {FMAF(va.x + sa.x, p.dt, pa.x), FMAF(va.y + sa.y, p.dt, pa.y)};
  const V2 fb = ma < mb ? kept_b
                        : V2{FMAF(vb.x + sb.x, p.dt, pb.x),
                             FMAF(vb.y + sb.y, p.dt, pb.y)};
  const V2 g = {
      FMAF(vb_d.x + sb.x, p.dt, pb.x) - FMAF(va_d.x + sa.x, p.dt, pa.x),
      FMAF(vb_d.y + sb.y, p.dt, pb.y) - FMAF(va_d.y + sa.y, p.dt, pa.y)};
  const V2 ga = {fb.x - fa.x, fb.y - fa.y};
  if (same_bits(va, va_p) && same_bits(vb, vb_p)) {
    settle(p, pa, va, sa, ma, pb, vb, sb, mb, ra, rb, tgx, tgy, g, ga);
    return;
  }
  V2 qa = pa, qb = pb;
  settle(p, qa, va, sa, ma, qb, vb, sb, mb, ra, rb, tgx, tgy, g, ga);
  settle(p, pa, va_p, sa, ma, pb, vb_p, sb, mb, ra, rb, tgx, tgy, g, ga);
}

HD int lowest_bit(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

HD int bit_count(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// add one pair's update to cell i's sum (bit i of `has` marks a first
// update; 0 + x as the plain engine's masked sum gives)
HD void add_update(V2* p, V2* v, uint32_t& has, int i, V2 np_, V2 nv) {
  if ((has >> i) & 1u) {
    p[i] = {p[i].x + np_.x, p[i].y + np_.y};
    v[i] = {v[i].x + nv.x, v[i].y + nv.y};
  } else {
    p[i] = {0.0f + np_.x, 0.0f + np_.y};
    v[i] = {0.0f + nv.x, 0.0f + nv.y};
    has |= 1u << i;
  }
}

// check_player_self_collisions under SPEC M6 (physics.py::self_collisions):
// 5 Jacobi passes over the mutual lowest-rank matching, then one static
// pass. A cell chooses every touching cell of the lowest rank it touches
// (several only when ids are equal); a pair moves when the choice is
// mutual and its ranks differ, and a cell in several such pairs takes the
// sum of its updates (as "a", the lower rank, before as "b"), as the plain
// engine's masked sums give. Cells and pairs are walked as bit sets.
HD void self_collisions(const EnvParams& p, const Cells& c, const int* rank,
                        float tgx, float tgy) {
  uint32_t live = 0;
  for (int i = 0; i < MC; i++) live |= c.al[i] ? 1u << i : 0u;
  if (bit_count(live) < 2) return;        // no pair
  float rad[MC];
  for (uint32_t m = live; m; m &= m - 1) {
    const int i = lowest_bit(m);
    rad[i] = radius(float(c.m[i]));
  }
  for (int pass = 0; pass < 6; pass++) {
    uint32_t chose[MC];
    for (uint32_t mi = live; mi; mi &= mi - 1) {
      const int i = lowest_bit(mi);
      int best = BIG_I;
      chose[i] = 0;
      for (uint32_t mj = live & ~(1u << i); mj; mj &= mj - 1) {
        const int j = lowest_bit(mj);
        const float rs = rad[i] + rad[j];
        if (!(rs * rs >= norm2(c.x[j] - c.x[i], c.y[j] - c.y[i]))) continue;
        if (rank[j] < best) {
          best = rank[j];
          chose[i] = 0;
        }
        if (rank[j] == best) chose[i] |= 1u << j;
      }
    }
    V2 ap[MC], av[MC], bp[MC], bv[MC];
    uint32_t has_a = 0, has_b = 0;
    for (uint32_t mi = live; mi; mi &= mi - 1) {
      const int i = lowest_bit(mi);
      for (uint32_t mj = chose[i]; mj; mj &= mj - 1) {
        const int j = lowest_bit(mj);
        if (!((chose[j] >> i) & 1u) || rank[i] >= rank[j]) continue;
        V2 pa = {c.x[i], c.y[i]}, va = {c.vx[i], c.vy[i]};
        V2 pb = {c.x[j], c.y[j]}, vb = {c.vx[j], c.vy[j]};
        if (pass < 5) {
          prevent_overlap(p, pa, va, {c.sx[i], c.sy[i]}, c.m[i], pb, vb,
                          {c.sx[j], c.sy[j]}, c.m[j], tgx, tgy);
        } else {
          avoid_static(p, pa, va, pb, vb, rad[i], rad[j]);
        }
        add_update(ap, av, has_a, i, pa, va);
        add_update(bp, bv, has_b, j, pb, vb);
      }
    }
    for (uint32_t m = has_a | has_b; m; m &= m - 1) {
      const int i = lowest_bit(m);
      const bool a = (has_a >> i) & 1u;
      c.x[i] = a ? ap[i].x : bp[i].x;
      c.y[i] = a ? ap[i].y : bp[i].y;
      c.vx[i] = a ? av[i].x : bv[i].x;
      c.vy[i] = a ? av[i].y : bv[i].y;
    }
  }
}

// cell_split fields (actions.py::split_fields); returns the new cell and
// leaves the remaining mass in *remaining
HD NewCell split_fields(const EnvParams& p, float x, float y, int mass,
                        float tgx, float tgy, int elapsed, int* remaining) {
  const int split_mass = mass / 2;
  const int rem = mass - split_mass > CELL_MIN_SIZE ? mass - split_mass
                                                    : CELL_MIN_SIZE;
  const float rad = radius(float(rem));
  float dx = tgx - x, dy = tgy - y;
  const float nn = fmaxf(sqrtf(norm2(dx, dy)), 1e-12f);
  dx = dx / nn;
  dy = dy / nn;
  const V2 loc = clamp2(p, {FMAF(dx, rad, x), FMAF(dy, rad, y)}, rad);
  const float sp = split_speed(float(split_mass));
  *remaining = rem;
  return {loc.x, loc.y, dx * sp, dy * sp, dx * sp, dy * sp, split_mass,
          elapsed + RECOMBINE_TICKS};
}

// candidate k of a virus pop (actions.py::disrupt_candidates, SPEC Q3)
HD NewCell pop_candidate(const Pop& pop, int k, int elapsed) {
  const float theta = direction(pop.cvx, pop.cvy);
  const float nn = float(pop.num_new > 1 ? pop.num_new : 1);
  const float pop_speed = max_speed(float(CELL_POP_SIZE));
  const float ang = theta + (theta + TWO_PI32 * float(k) / nn);
  int mk = pop.pop_mass - CELL_POP_SIZE * k;
  mk = mk < CELL_POP_SIZE ? mk : CELL_POP_SIZE;
  return {pop.vx, pop.vy, pop.cvx, pop.cvy,
          sincos32(ang, true) * pop_speed,
          sincos32(ang, false) * pop_speed,
          mk > 1 ? mk : 1, elapsed + RECOMBINE_TICKS};
}

// place_new_cells (SPEC M8): candidates take the lowest free slots in
// creation order with consecutive fresh ids; a pop's candidates are made
// here from its record
HD void place_new_cells(const Cells& c, int& next_id, const NewCell* cand,
                        const Pop* pop, int elapsed, int count) {
  int k = 0;
  for (int i = 0; i < MC && k < count; i++) {
    if (c.al[i]) continue;
    const NewCell nc = pop ? pop_candidate(*pop, k, elapsed) : cand[k];
    c.x[i] = nc.x; c.y[i] = nc.y; c.vx[i] = nc.vx; c.vy[i] = nc.vy;
    c.sx[i] = nc.sx; c.sy[i] = nc.sy;
    c.m[i] = nc.m > CELL_MIN_SIZE ? nc.m : CELL_MIN_SIZE;
    c.id[i] = next_id + k;
    c.rec[i] = nc.rec;
    c.al[i] = 1;
    k++;
  }
  next_id += k;
}

// recombine_cells under SPEC M7 (eating.py::recombine): while two live
// cells past their recombine tick touch, the pair of the lowest (rank,
// rank) key (the first in slot order among equal keys) merges into the
// lower rank. Ranks count live cells only; cells and pairs are walked as
// bit sets, and fewer than two ready cells merge nothing.
HD void recombine(const Cells& c, int el) {
  uint32_t live = 0, ready = 0;
  for (int i = 0; i < MC; i++) {
    live |= c.al[i] ? 1u << i : 0u;
    ready |= c.al[i] && el >= c.rec[i] ? 1u << i : 0u;
  }
  while (bit_count(ready) >= 2) {
    int rk[MC];
    float rr[MC];
    for (uint32_t mi = ready; mi; mi &= mi - 1) {
      const int i = lowest_bit(mi);
      int r = 0;
      for (uint32_t mj = live; mj; mj &= mj - 1)
        r += c.id[i] > c.id[lowest_bit(mj)];
      rk[i] = r;
      rr[i] = radius(float(c.m[i]));
    }
    int best = BIG_I, bi = -1, bj = -1;
    for (uint32_t mi = ready; mi; mi &= mi - 1) {
      const int i = lowest_bit(mi);
      for (uint32_t mj = ready & ~(1u << i); mj; mj &= mj - 1) {
        const int j = lowest_bit(mj);
        if (rk[i] >= rk[j]) continue;
        const float rse = (rr[i] + rr[j]) + RECOMBINE_TOUCH_EPS;
        if (rse * rse >= norm2(c.x[j] - c.x[i], c.y[j] - c.y[i])) {
          const int key = rk[i] * MC + rk[j];
          if (key < best) { best = key; bi = i; bj = j; }
        }
      }
    }
    if (bi < 0) break;
    c.m[bi] += c.m[bj];
    c.al[bj] = 0;
    live &= ~(1u << bj);
    ready &= ~(1u << bj);
  }
}

// the centroid in XLA's form (state.py::xla_centroid_of): slot-order
// total, numerator a chain of fmas
HD V2 xla_centroid(const Cells& c) {
  float tot = 0.0f, sx = 0.0f, sy = 0.0f;
  for (int i = 0; i < MC; i++) {
    const float w = c.al[i] ? float(c.m[i]) : 0.0f;
    tot = i == 0 ? w : tot + w;
    sx = i == 0 ? c.x[i] * w : FMAF(c.x[i], w, sx);
    sy = i == 0 ? c.y[i] * w : FMAF(c.y[i], w, sy);
  }
  const float den = fmaxf(tot, 1.0f);
  return {sx / den, sy / den};
}

// ------------------------------------------------------------ bots
// engine/bots.py::bot_decide for every live bot, from the start-of-tick
// state: the nearest pellet (first of equal distances; (0, 0) when live
// pellets exist but none is farther than 0.01; the floor of a random draw
// when none lives), flee from the first other live player within
// SHY_RADIUS, hunt the first one within AGGRESSIVE_RADIUS with edible mass
constexpr uint64_t NEAR_ONLY = NO_KEY64 - 1;   // live pellets, none > 0.01

template <int PC>
HD void bot_pass(const Team& T, const EnvParams& p, const EnvS<PC>& e) {
  const int P = players<PC>(p);
  Hot<PC>& h = e.h();
  team_for(T, P, [&](int q) {
    const Cells c = e.c(q);
    h.cen[q] = xla_centroid(c);
    int m = 0;
    bool al = false;
    for (int i = 0; i < MC; i++) {
      m += c.al[i] ? c.m[i] : 0;
      al = al || c.al[i];
    }
    h.pm[q] = m;
    h.palive[q] = al;
  });
  const int* pk = e.pk();
  for (int q = 0; q < P; q++) {
    const int bt = p.bot_type[q];
    if (bt == 0 || !h.palive[q]) continue;
    const V2 c0 = h.cen[q];
    // nearest pellet: the lowest (distance bits, j), as the serial d < bd
    const uint64_t near = team_min64(T, p.Np, [&](int j) -> uint64_t {
      const int key = pk[j];
      if (key < 0) return NO_KEY64;
      const float d = sqrtf(norm2(c0.x - pellet_x(p, key),
                                  c0.y - pellet_y(p, key)));
      if (!(d > 0.01f)) return NEAR_ONLY;
      return (uint64_t(uint32_t(float_bits(d))) << 32) | uint32_t(j);
    });
    team_serial(T, [&] {
      V2 tg;
      if (near < NEAR_ONLY) {
        const int key = pk[int(near & 0xFFFFFFFFu)];
        tg = {pellet_x(p, key), pellet_y(p, key)};
      } else if (near == NEAR_ONLY) {
        tg = {0.0f, 0.0f};
      } else {
        const uint32_t tk = uint32_t(h.ticks), seed = uint32_t(h.seed);
        tg = {floorf(p.W * uniformf(seed, STREAM_BOT, tk, q, 0)),
              floorf(p.H * uniformf(seed, STREAM_BOT, tk, q, 1))};
      }
      const Cells me = e.c(q);
      // hunt
      if (bt == 3 || bt == 4) {
        int big = -1, bi = 0;
        for (int i = 0; i < MC; i++) {
          const int lm = me.al[i] ? me.m[i] : -1;
          if (lm > big) { big = lm; bi = i; }
        }
        big = me.m[bi];
        const float bigf = float(big);
        for (int j = 0; j < P; j++) {
          if (j == q || !h.palive[j]) continue;
          const float d = sqrtf(norm2(c0.x - h.cen[j].x, c0.y - h.cen[j].y));
          if (!(d <= AGGRESSIVE_RADIUS)) continue;
          const Cells o = e.c(j);
          float wsum = 0.0f, sx = 0.0f, sy = 0.0f;
          int edible = 0;
          for (int i = 0; i < MC; i++) {
            const bool can = big > CELL_EAT_REQUIREMENT
                             && bigf > float(o.m[i]) * 1.1f && o.al[i];
            const float w = can ? float(o.m[i]) : 0.0f;
            edible += can ? o.m[i] : 0;
            wsum = i == 0 ? w : wsum + w;
            sx = i == 0 ? o.x[i] * w : FMAF(o.x[i], w, sx);
            sy = i == 0 ? o.y[i] * w : FMAF(o.y[i], w, sy);
          }
          if (edible <= 0) continue;
          const float den = fmaxf(wsum, 1.0f);
          tg = {FMAF(3.0f, sx / den - c0.x, c0.x),
                FMAF(3.0f, sy / den - c0.y, c0.y)};
          break;
        }
      }
      // flee
      if (bt == 2 || bt == 4) {
        for (int j = 0; j < P; j++) {
          if (j == q || !h.palive[j] || h.pm[j] <= 0) continue;
          const float d = sqrtf(norm2(c0.x - h.cen[j].x, c0.y - h.cen[j].y));
          if (d < SHY_RADIUS) {
            tg = {2.0f * c0.x - h.cen[j].x, 2.0f * c0.y - h.cen[j].y};
            break;
          }
        }
      }
      h.tx[q] = tg.x;
      h.ty[q] = tg.y;
      h.action[q] = 0;
    });
  }
}

// ------------------------------------------------------------ cross-eat
// eating.py::cross_player_eat (SPEC M3): prey j goes to the lowest
// (pid, rank) eater of another player; the masses and live cells of the
// phase's start decide every pair, gains are summed in int32
template <int PC>
HD void cross_eat(const EnvParams& p, const EnvS<PC>& e) {
  const int P = players<PC>(p);
  int rank[PC][MC], m0[PC][MC];
  float rad[PC][MC];
  uint32_t live[PC], eaten[PC];
  for (int q = 0; q < P; q++) {
    const Cells c = e.c(q);
    live[q] = 0;
    eaten[q] = 0;
    for (int i = 0; i < MC; i++) {
      rank[q][i] = cell_rank(c, i);
      m0[q][i] = c.m[i];
      rad[q][i] = radius(float(m0[q][i]));
      live[q] |= c.al[i] ? 1u << i : 0u;
    }
  }
  for (int qj = 0; qj < P; qj++) {
    const Cells cj = e.c(qj);
    for (uint32_t mj = live[qj]; mj; mj &= mj - 1) {
      const int j = lowest_bit(mj);
      const float xj = cj.x[j], yj = cj.y[j];
      const float lim = float(m0[qj][j]) * 1.1f;
      // the lowest key: players in pid order, the lowest eligible rank
      int wq = -1, wr = BIG_I;
      for (int qi = 0; qi < P && wq < 0; qi++) {
        if (qi == qj) continue;
        const Cells ci = e.c(qi);
        for (uint32_t mi = live[qi]; mi; mi &= mi - 1) {
          const int i = lowest_bit(mi);
          if (rank[qi][i] >= wr) continue;
          const int mi_ = m0[qi][i];
          if (!(mi_ > CELL_EAT_REQUIREMENT && float(mi_) > lim)) continue;
          const float rm = fmaxf(rad[qi][i], rad[qj][j]);
          if (rm * rm >= norm2(xj - ci.x[i], yj - ci.y[i])) {
            wq = qi;
            wr = rank[qi][i];
          }
        }
      }
      if (wq < 0) continue;
      eaten[qj] |= 1u << j;
      const Cells cw = e.c(wq);
      for (uint32_t mi = live[wq]; mi; mi &= mi - 1) {
        const int i = lowest_bit(mi);
        if (rank[wq][i] != wr) continue;
        const int mi_ = m0[wq][i];
        if (!(mi_ > CELL_EAT_REQUIREMENT && float(mi_) > lim)) continue;
        const float rm = fmaxf(rad[wq][i], rad[qj][j]);
        if (rm * rm >= norm2(xj - cw.x[i], yj - cw.y[i])) {
          cw.m[i] += m0[qj][j];
          e.h().cells_eaten[wq] += 1;
        }
      }
    }
  }
  for (int q = 0; q < P; q++) {
    const Cells c = e.c(q);
    for (uint32_t m = eaten[q]; m; m &= m - 1) c.al[lowest_bit(m)] = 0;
  }
}

// Velocity::decelerate of a food (decel * dt = p.kdec_food)
HD V2 food_decel(const EnvParams& p, float vx0, float vy0) {
  const float mag = sqrtf(norm2(vx0, vy0));
  const float ddx = vx0 / fmaxf(mag, 1e-12f) * p.kdec_food;
  const float ddy = vy0 / fmaxf(mag, 1e-12f) * p.kdec_food;
  return {fabsf(ddx) <= fabsf(vx0) ? vx0 - ddx : 0.0f,
          fabsf(ddy) <= fabsf(vy0) ? vy0 - ddy : 0.0f};
}

// a food at (x, y): the first eater in (pid, rank)
// order wins, with the cells of its player that share its rank; h.r2
// holds each cell's squared reach, fixed at the phase's start, so foods
// are independent and the gains are exact int atomics. Returns whether
// the food was eaten.
template <int PC>
HD bool eat_item(const EnvParams& p, const EnvS<PC>& e, float x, float y,
                 int gain) {
  Hot<PC>& h = e.h();
  const int P = players<PC>(p);
  int won = -1;
  for (int q = 0; q < P && won < 0; q++) {
    const Cells c = e.c(q);
    const int* order = h.order + q * MC;
    const int* rank = h.rank + q * MC;
    const float* reach = h.r2 + q * MC;
    for (int r = 0; r < h.n_start[q]; r++) {
      const int i = order[r];
      if (won >= 0 && rank[i] != won) break;
      if (reach[i] >= norm2(c.x[i] - x, c.y[i] - y)) {
        team_add(&c.m[i], gain);
        team_add(&h.food_eaten[q], 1);
        won = rank[i];
      }
    }
  }
  return won >= 0;
}

// ------------------------------------------------------------ one tick
// engine/tick.py::engine_tick
template <int PC>
HD void engine_tick(const Team& T, const EnvParams& p, const EnvS<PC>& e) {
  const int P = players<PC>(p);
  const int Nv = p.Nv, Nf = p.Nf;
  Hot<PC>& h = e.h();
  // lane 0's state between its serial phases of this tick
  int action_eff[PC], n_disrupt[PC], n_auto[PC], n_split[PC];
  Pop pop[PC];
  NewCell cand[PC][MC];

  // --- 1. bots (start-of-tick snapshot) ----------------------------------
  if (p.n_bots > 0 && floor_mod(h.ticks, BOT_ACTION_PERIOD) == 0)
    bot_pass<PC>(T, p, e);

  // --- 2. elapsed ----------------------------------------------------------
  team_serial(T, [&] {
    for (int q = 0; q < P; q++) {
      const Cells c = e.c(q);
      bool al = false;
      for (int i = 0; i < MC; i++) al = al || c.al[i];
      h.palive[q] = al;
      action_eff[q] = al ? h.action[q] : 0;
      h.elapsed[q] += al ? 1 : 0;
    }
  });

  // --- 3. movement + relax: a lane per cell, then a lane per player -------
  team_for(T, P * MC, [&](int k) {
    const int q = k / MC;
    move_cell(p, e.c(q), k % MC, h.tx[q], h.ty[q]);
  });
  team_for(T, P * MC, [&](int k) {
    h.rank[k] = cell_rank(e.c(k / MC), k % MC);
  });
  team_for(T, P, [&](int q) {
    const Cells c = e.c(q);
    const int* rank = h.rank + q * MC;
    self_collisions(p, c, rank, h.tx[q], h.ty[q]);
    // live cells by rank, cells of one rank (equal ids) in slot order
    uint32_t live = 0;
    for (int i = 0; i < MC; i++) live |= c.al[i] ? 1u << i : 0u;
    const int ns = bit_count(live);
    h.live[q] = live;
    h.n_start[q] = ns;
    int* order = h.order + q * MC;
    for (int r = 0, k = 0; r < ns; r++)
      for (int i = 0; i < MC; i++)
        if (c.al[i] && rank[i] == r) order[k++] = i;
  });

  // --- 4. virus events (SPEC M2): each player's best (rank, virus) pair
  // over the viruses alive now (rank * Nv + v, then the lowest cell; a
  // lane per virus); only the lowest pid's claim stands --------------------
  {
    const int* vmass = e.vmasses();
    const float *vx = e.vxs(), *vy = e.vys();
    const uint8_t* valive = e.valives();
    for (int q = 0; q < P; q++) {
      const Cells c = e.c(q);
      const uint32_t live = h.live[q];
      const uint32_t b = team_min(T, Nv, [&](int v) {
        uint32_t k = NO_KEY;
        if (!valive[v]) return k;
        const float rv = radius(float(vmass[v]));
        for (uint32_t m = live; m; m &= m - 1) {
          const int i = lowest_bit(m);
          const float rm = fmaxf(radius(float(c.m[i])), rv);
          const bool can = float(c.m[i]) > float(vmass[v]) * 1.1f;
          if (!(can && rm * rm >= norm2(c.x[i] - vx[v], c.y[i] - vy[v])))
            continue;
          const uint32_t ki = (uint32_t(h.rank[q * MC + i] * Nv + v) << 4)
                              | uint32_t(i);
          k = ki < k ? ki : k;
        }
        return k;
      });
      if (team_owns(T, 0)) h.best[q] = int(b);
    }
    team_serial(T, [&] {
      uint64_t claimed = 0;
      for (int q = 0; q < P; q++) {
        n_disrupt[q] = 0;
        const uint32_t b = uint32_t(h.best[q]);
        if (b == NO_KEY) continue;
        const int v = int(b >> 4) % Nv, bc = int(b & 15u);
        if ((claimed >> v) & 1ull) continue;          // a lower pid's virus
        claimed |= 1ull << v;
        const Cells c = e.c(q);
        const Player u = e.pl(q);
        u.viruses_eaten += 1;
        u.vticks[floor_mod(u.vptr, p.K)] = u.elapsed;
        u.vptr += 1;
        if (h.n_start[q] >= NUM_CELLS_TO_SPLIT) {
          c.m[bc] += vmass[v];
        } else {
          // disrupt (actions.py::disrupt_candidates, SPEC Q3)
          const int total = c.m[bc];
          int cur = int(float(total) / 2.0f);
          cur = cur > CELL_MIN_SIZE ? cur : CELL_MIN_SIZE;
          cur = cur + floor_mod(total - cur, CELL_POP_SIZE);
          const int pop_mass = total - cur;
          int num_new = (pop_mass + CELL_POP_SIZE - 1) / CELL_POP_SIZE;
          int lim = PLAYER_CELL_LIMIT - h.n_start[q];
          lim = lim > 0 ? lim : 0;
          num_new = num_new < lim ? num_new : lim;
          c.m[bc] = cur;
          c.rec[bc] = u.elapsed + RECOMBINE_TICKS;
          pop[q] = {vx[v], vy[v], c.vx[bc], c.vy[bc], pop_mass, num_new};
          n_disrupt[q] = num_new;
        }
      }
      for (uint64_t m = claimed; m; m &= m - 1) {
#ifdef __CUDA_ARCH__
        e.valives()[__ffsll((long long)m) - 1] = 0;
#else
        e.valives()[__builtin_ctzll(m)] = 0;
#endif
      }
    });
  }

  // --- 5. pellets (SPEC M1): the cells in (pid, rank) order, each against
  // every lane's pellets at once; a pellet goes to the first rank group
  // with a cell that reaches it, and to each cell of that group that does
  {
    team_for(T, P * MC, [&](int k) {
      const float r = radius(float(h.cmass[k]));
      h.r2[k] = r * r;
    });
    int* pk = e.pk();
    uint32_t *dead = h.pdead, *taken = h.ptaken, *won = h.pwon;
    for (int base = 0; base < p.Np; base += LANES * 32) {
      const int n = p.Np - base < LANES * 32 ? p.Np - base : LANES * 32;
      team_for(T, LANES, [&](int l) {
        dead[l] = 0;
        for (int t = 0; t < column_length(l, n); t++)
          dead[l] |= pk[base + l + LANES * t] < 0 ? 1u << t : 0u;
        taken[l] = dead[l];
      });
      for (int q = 0; q < P; q++) {
        const int* order = h.order + q * MC;
        const int* rank = h.rank + q * MC;
        const Cells c = e.c(q);
        for (int r = 0; r < h.n_start[q];) {
          const int grp = rank[order[r]];
          team_for(T, LANES, [&](int l) { won[l] = 0; });
          for (; r < h.n_start[q] && rank[order[r]] == grp; r++) {
            const int i = order[r];
            const float x = c.x[i], y = c.y[i], reach = h.r2[q * MC + i];
            const int gain = team_sum(T, LANES, [&](int l) {
              int g = 0;
              for (int t = 0; t < column_length(l, n); t++) {
                if ((taken[l] >> t) & 1u) continue;
                const int key = pk[base + l + LANES * t];
                if (reach >= norm2(x - pellet_x(p, key),
                                   y - pellet_y(p, key))) {
                  won[l] |= 1u << t;
                  g++;
                }
              }
              return g;
            });
            if (gain > 0 && team_owns(T, 0)) {
              c.m[i] += gain * PELLET_MASS;
              h.food_eaten[q] += gain;
            }
          }
          team_for(T, LANES, [&](int l) { taken[l] |= won[l]; });
        }
      }
      team_for(T, LANES, [&](int l) {
        for (uint32_t m = taken[l] & ~dead[l]; m; m &= m - 1)
          pk[base + l + LANES * lowest_bit(m)] = -1;
      });
    }
    team_for(T, P, [&](int q) {
      const Cells c = e.c(q);
      int pm = 0;
      for (int i = 0; i < MC; i++) pm += c.al[i] ? c.m[i] : 0;
      h.highest[q] = pm > h.highest[q] ? pm : h.highest[q];
    });
  }

  // --- 6. auto-split + food eating ------------------------------------------
  // cand[q] holds player q's auto-split cells, then its split cells: at
  // most MC together (a split needs a free place under the limit)
  team_serial(T, [&] {
    for (int q = 0; q < P; q++) {
      const Cells c = e.c(q);
      const int* order = h.order + q * MC;
      n_auto[q] = 0;
      for (int r = 0; r < h.n_start[q]; r++) {
        const int i = order[r];
        if (c.m[i] < MAX_MASS_IN_THE_GAME) continue;
        if (h.n_start[q] < PLAYER_CELL_LIMIT) {
          int rem;
          cand[q][n_auto[q]++] = split_fields(p, c.x[i], c.y[i], c.m[i],
                                              h.tx[q], h.ty[q], h.elapsed[q],
                                              &rem);
          c.m[i] = rem;
          c.rec[i] = h.elapsed[q] + RECOMBINE_TICKS;
        } else {
          c.m[i] = NEW_MASS_IF_NO_SPLIT;
        }
      }
    }
  });
  {
    const float rf = radius(float(FOOD_MASS));
    team_for(T, P * MC, [&](int k) {
      const float rm = fmaxf(radius(float(h.cmass[k])), rf);
      h.r2[k] = h.cmass[k] > 11 ? rm * rm : -1.0f;
    });
    const float *fx = e.fx(), *fy = e.fy();
    uint8_t* fal = e.fal();
    team_for(T, Nf, [&](int f) {
      if (!fal[f]) return;
      if (eat_item<PC>(p, e, fx[f], fy[f], FOOD_MASS)) fal[f] = 0;
    });
  }

  // --- 7-9. feed emission (the shared ring in (pid, rank) order), split,
  // then the created cells: pops, auto-splits, splits, each kind for all
  // players in pid order (the id order) -------------------------------------
  team_serial(T, [&] {
    int g = 0;
    float *fx = e.fx(), *fy = e.fy(), *fvx = e.fvx(), *fvy = e.fvy();
    uint8_t* fal = e.fal();
    for (int q = 0; q < P; q++) {
      const Cells c = e.c(q);
      const Player u = e.pl(q);
      const int* order = h.order + q * MC;
      const int fcd = u.feed_cd - 1 > 0 ? u.feed_cd - 1 : 0;
      const bool act = action_eff[q] == 1 && fcd == 0;
      if (act) {
        for (int r = 0; r < h.n_start[q]; r++) {
          const int i = order[r];
          if (c.m[i] < CELL_MIN_SIZE + FOOD_MASS) continue;
          float dx = u.tx - c.x[i], dy = u.ty - c.y[i];
          const float nn = fmaxf(sqrtf(norm2(dx, dy)), 1e-12f);
          dx = dx / nn;
          dy = dy / nn;
          const float rad = radius(float(c.m[i]));
          const int slot = floor_mod(h.fnext + g, Nf);
          // the rim point fused, as XLA-CPU forms it in the food fusion
          fx[slot] = FMAF(dx, rad, c.x[i]);
          fy[slot] = FMAF(dy, rad, c.y[i]);
          fvx[slot] = dx * FOOD_SPEED;
          fvy[slot] = dy * FOOD_SPEED;
          fal[slot] = 1;
          c.m[i] -= FOOD_MASS;
          g++;
        }
      }
      if (h.palive[q]) u.feed_cd = act ? FEED_COOLDOWN : fcd;
    }
    h.fnext += g;

    for (int q = 0; q < P; q++) {
      const Cells c = e.c(q);
      const Player u = e.pl(q);
      const int* order = h.order + q * MC;
      n_split[q] = 0;
      const int scd = u.split_cd - 1 > 0 ? u.split_cd - 1 : 0;
      const bool act = action_eff[q] == 2 && scd == 0;
      int limit = PLAYER_CELL_LIMIT - h.n_start[q] - n_disrupt[q]
                  - n_auto[q];
      limit = limit > 0 ? limit : 0;
      if (act) {
        for (int r = 0; r < h.n_start[q] && n_split[q] < limit; r++) {
          const int i = order[r];
          if (c.m[i] < CELL_SPLIT_MINIMUM) continue;
          int rem;
          cand[q][n_auto[q] + n_split[q]++] = split_fields(
              p, c.x[i], c.y[i], c.m[i], u.tx, u.ty, u.elapsed, &rem);
          c.m[i] = rem;
          c.rec[i] = u.elapsed + RECOMBINE_TICKS;
        }
      }
      if (h.palive[q]) u.split_cd = act ? SPLIT_COOLDOWN : scd;
    }

    for (int q = 0; q < P; q++)
      place_new_cells(e.c(q), h.next_id, nullptr, &pop[q], h.elapsed[q],
                      n_disrupt[q]);
    for (int q = 0; q < P; q++)
      place_new_cells(e.c(q), h.next_id, cand[q], nullptr, 0, n_auto[q]);
    for (int q = 0; q < P; q++)
      place_new_cells(e.c(q), h.next_id, cand[q] + n_auto[q], nullptr, 0,
                      n_split[q]);
  });

  // --- 10. recombine (SPEC M7): a lane per player ---------------------------
  team_for(T, P, [&](int q) { recombine(e.c(q), h.elapsed[q]); });

  // --- 11-12. anti-team + decay, cross-player eating ------------------------
  team_serial(T, [&] {
    for (int q = 0; q < P; q++) {
      const Cells c = e.c(q);
      const Player u = e.pl(q);
      if (!(p.mass_decay && h.palive[q] && u.elapsed % 60 == 0)) continue;
      const int fall_off = u.elapsed - ANTI_TEAM_TICKS;
      int cnt = 0;
      for (int k = 0; k < p.K; k++) {
        if (u.vticks[k] < fall_off) u.vticks[k] = EMPTY_TICK;
        cnt += u.vticks[k] != EMPTY_TICK;
      }
      if (cnt > 0) u.anti_team = powd(1.1f, float(cnt - 1));
      if (u.elapsed - u.last_decay >= DECAY_TICKS) {
        const float f = 1.0f - PLAYER_DECAY_RATE * u.anti_team;
        for (int i = 0; i < MC; i++) {
          if (!c.al[i]) continue;
          const int d = int(float(c.m[i]) * f);
          c.m[i] = d > CELL_MIN_SIZE ? d : CELL_MIN_SIZE;
        }
        u.last_decay = u.elapsed;
      }
    }
    if (PC > 1 && P > 1) cross_eat<PC>(p, e);
  });

  // --- 13. foods move + virus feeding (SPEC M4): a lane per food; a food
  // that hits keeps its old velocity (the spawn's source) until the burst
  // is resolved ------------------------------------------------------------
  {
    uint8_t* valive = e.valives();
    float *fx = e.fx(), *fy = e.fy(), *fvx = e.fvx(), *fvy = e.fvy();
    uint8_t* fal = e.fal();
    int *hits = e.hits(), *src_f = e.src_f();
    const uint32_t ds = team_min(T, Nv, [&](int v) {
      return valive[v] ? NO_KEY : uint32_t(v);
    });
    const int dead_slot = ds == NO_KEY ? -1 : int(ds);
    const V2 vel0 = {fvx[0], fvy[0]};     // read before the barrier below
    team_for(T, Nv, [&](int v) {
      hits[v] = 0;
      src_f[v] = BIG_I;
    });
    const float rf = radius(float(FOOD_MASS));
    const int* vmass = e.vmasses();
    const float *vx = e.vxs(), *vy = e.vys();
    team_for(T, Nf, [&](int f) {
      if (!fal[f]) return;
      const float vx0 = fvx[f], vy0 = fvy[f];
      const float mag = sqrtf(norm2(vx0, vy0));
      if (!(mag > 0.0f)) return;
      const V2 nv = food_decel(p, vx0, vy0);
      // XLA-CPU rounds the product before the add (no fma here)
      const float x = clampb(fx[f] + nv.x * p.dt, rf, p.W);
      const float y = clampb(fy[f] + nv.y * p.dt, rf, p.H);
      fx[f] = x;
      fy[f] = y;
      for (int v = 0; v < Nv; v++) {
        if (!valive[v]) continue;
        const float rm = fmaxf(rf, radius(float(vmass[v])));
        if (rm * rm >= norm2(x - vx[v], y - vy[v])) {
          team_add(&hits[v], 1);
          team_min_at(&src_f[v], f);
          fal[f] = 2;
          return;
        }
      }
      fvx[f] = nv.x;
      fvy[f] = nv.y;
    });
    int* vhits = e.vhits();
    int* vm = e.vmasses();
    const uint32_t bs = team_min(T, Nv, [&](int v) {
      return valive[v] && vhits[v] + hits[v] > NUMBER_OF_FOOD_HITS
                 ? uint32_t(v) : NO_KEY;
    });
    team_for(T, Nv, [&](int v) {
      const int nh = vhits[v] + hits[v];
      const bool burst = valive[v] && nh > NUMBER_OF_FOOD_HITS;
      int post = nh - (NUMBER_OF_FOOD_HITS + 1);
      post = post > 0 ? post : 0;
      vhits[v] = burst ? post : nh;
      vm[v] = burst ? VIRUS_INITIAL_MASS + post * FOOD_MASS
                    : vm[v] + hits[v] * FOOD_MASS;
    });
    // the lowest bursting virus spawns one into the lowest dead slot
    if (bs != NO_KEY && dead_slot >= 0) team_serial(T, [&] {
        const int burst_slot = int(bs);
        const int sf = src_f[burst_slot];
        const V2 sv = hits[burst_slot] > 0 ? V2{fvx[sf], fvy[sf]} : vel0;
        const float r100 = radius(float(VIRUS_INITIAL_MASS));
        float *vxw = e.vxs(), *vyw = e.vys();
        const float spx = vxw[burst_slot] + sv.x * p.spawn_k;
        const float spy = vyw[burst_slot] + sv.y * p.spawn_k;
        vxw[dead_slot] = clampb(spx, r100, p.W);
        vyw[dead_slot] = clampb(spy, r100, p.H);
        e.vvx()[dead_slot] = sv.x;
        e.vvy()[dead_slot] = sv.y;
        vm[dead_slot] = VIRUS_INITIAL_MASS;
        vhits[dead_slot] = 0;
        valive[dead_slot] = 1;
    });
    team_for(T, Nf, [&](int f) {
      if (fal[f] != 2) return;
      const V2 nv = food_decel(p, fvx[f], fvy[f]);
      fvx[f] = nv.x;
      fvy[f] = nv.y;
      fal[f] = 0;
    });
  }

  // --- 14. regeneration: the first dead pellet slots by ballot ranks -------
  if (p.pellet_regen && floor_mod(h.ticks, REGEN_PERIOD) == 0) {
    const uint32_t tk = uint32_t(h.ticks), seed = uint32_t(h.seed);
    int* pk = e.pk();
    const int alive_n = team_sum(T, p.Np, [&](int j) {
      return pk[j] >= 0 ? 1 : 0;
    });
    team_rank_for(T, p.Np, p.num_pellets - alive_n,
                  [&](int j) { return pk[j] < 0; },
                  [&](int j, int) {
      const int qx = uniform_q(p.nqx, seed, STREAM_PELLET, tk, j, 0) + p.qlx;
      const int qy = uniform_q(p.nqy, seed, STREAM_PELLET, tk, j, 1) + p.qly;
      pk[j] = (qx << 15) | qy;
    });
    team_serial(T, [&] {
      uint8_t* valive = e.valives();
      int valive_n = 0;
      for (int v = 0; v < Nv; v++) valive_n += valive[v] ? 1 : 0;
      const int vdef = p.num_viruses - valive_n;
      for (int v = 0, dead = 0; v < Nv && dead < vdef; v++) {
        if (valive[v]) continue;
        // spawn.py::random_location: fma(f32(W - 2r), u, f32(r))
        e.vxs()[v] = FMAF(p.virus_hi_x,
                          uniformf(seed, STREAM_VIRUS, tk, v, 0),
                          p.virus_rad);
        e.vys()[v] = FMAF(p.virus_hi_y,
                          uniformf(seed, STREAM_VIRUS, tk, v, 1),
                          p.virus_rad);
        e.vvx()[v] = 0.0f; e.vvy()[v] = 0.0f;
        e.vmasses()[v] = VIRUS_INITIAL_MASS;
        e.vhits()[v] = 0;
        valive[v] = 1;
        dead++;
      }
    });
  }

  // --- 15. assemble: dead cells keep stale pos/vel, lose mass and split vel
  team_for(T, P * MC, [&](int k) {
    if (h.calive[k]) return;
    h.svx[k] = 0.0f; h.svy[k] = 0.0f; h.cmass[k] = 0;
  });
  team_serial(T, [&] { h.ticks += 1; });
}

// apply_actions (env.py) for agent a: target = fma(10, (dx, dy), centroid)
HD void apply_actions(const Cells& c, const Player& u, float ax, float ay,
                      int act) {
  bool al = false;
  for (int i = 0; i < MC; i++) al = al || c.al[i];
  if (!al) return;
  const V2 cen = xla_centroid(c);
  u.tx = FMAF(TARGET_ACTION_SCALE, ax, cen.x);
  u.ty = FMAF(TARGET_ACTION_SCALE, ay, cen.y);
  u.action = act;
}

// the whole launch for env n, its state in e: n_steps x (actions, n_ticks
// ticks, frames, info rows). Null action planes skip the action phase: the
// partial-step chain of fused_engine_tick (agarcl_tpu/ops/fused_tick.py
// kernel_nosteps), n_ticks engine ticks of the planes as they are.
template <int PC>
HD void multi_step_env_t(const Team& T, const EnvParams& p,
                         const EnvS<PC>& e, int n, int N, const float* ax,
                         const float* ay, const int* aact, float* obs,
                         float* info, int n_steps, int n_ticks) {
  const int P = players<PC>(p);
  Hot<PC>& h = e.h();
  for (int step = 0; step < n_steps; step++) {
    if (ax != nullptr)
      team_serial(T, [&] {
        for (int a = 0; a < p.A; a++)
          apply_actions(e.c(a), e.pl(a), ax[a * N + n], ay[a * N + n],
                        aact[a * N + n]);
      });
    for (int t = 0; t < n_ticks; t++) engine_tick<PC>(T, p, e);
    const long long row = (long long)step * N + n;
    if (obs != nullptr)
      for (int a = 0; a < p.A; a++)
        ram_frame_team(T, p, e, a, obs + (row * p.A + a) * p.R, h.fs,
                       e.keys(), e.sel());
    team_for(T, P, [&](int q) {
      const Cells c = e.c(q);
      int pm = 0;
      bool al = false;
      for (int i = 0; i < MC; i++) {
        pm += c.al[i] ? c.m[i] : 0;
        al = al || c.al[i];
      }
      info[row * 2 * P + q] = float(pm);
      info[(row * 2 + 1) * P + q] = al ? 1.0f : 0.0f;
    });
  }
}

// the player capacity of a roster of P players
HD int player_capacity(int P) { return P == 1 ? 1 : P == 2 ? 2 : 9; }

// The region layout of one env for a launch (host code): the planes of
// fixed length at their places in Hot<PC>, those of runtime length and the
// scratch after it, each 16-byte aligned; the stride (16 mod 128 bytes)
// puts row r of the block's env b in bank 4b + r.
template <int PC>
inline Layout make_layout(const EnvParams& p) {
  using H = Hot<PC>;
  Layout L;
  int k = 0, tail = int((sizeof(H) + 15) / 16 * 16);
  auto put = [&](int off, int rows, int esz) {
    L.off[k] = off; L.rows[k] = rows; L.esz[k] = esz; k++;
    return off;
  };
  auto grow = [&](int rows, int esz) {
    const int off = tail;
    tail += (rows * esz + 15) / 16 * 16;
    return off;
  };
  const int P = p.P, PCc = p.P * MC, PK = p.P * MAX_TICKS_RING;
  put(offsetof(H, tx), P, 4); put(offsetof(H, ty), P, 4);
  put(offsetof(H, action), P, 4); put(offsetof(H, split_cd), P, 4);
  put(offsetof(H, feed_cd), P, 4); put(offsetof(H, elapsed), P, 4);
  put(offsetof(H, last_decay), P, 4); put(offsetof(H, anti_team), P, 4);
  put(offsetof(H, vticks), PK, 4); put(offsetof(H, vptr), P, 4);
  put(offsetof(H, food_eaten), P, 4); put(offsetof(H, highest), P, 4);
  put(offsetof(H, viruses_eaten), P, 4); put(offsetof(H, cells_eaten), P, 4);
  put(offsetof(H, cx), PCc, 4); put(offsetof(H, cy), PCc, 4);
  put(offsetof(H, cvx), PCc, 4); put(offsetof(H, cvy), PCc, 4);
  put(offsetof(H, svx), PCc, 4); put(offsetof(H, svy), PCc, 4);
  put(offsetof(H, cmass), PCc, 4); put(offsetof(H, calive), PCc, 1);
  put(offsetof(H, cid), PCc, 4); put(offsetof(H, crecomb), PCc, 4);
  put(offsetof(H, next_id), 1, 4);
  L.pk = put(grow(p.Np, 4), p.Np, 4);
  L.vx = put(grow(p.Nv, 4), p.Nv, 4);
  L.vy = put(grow(p.Nv, 4), p.Nv, 4);
  L.vvx = put(grow(p.Nv, 4), p.Nv, 4);
  L.vvy = put(grow(p.Nv, 4), p.Nv, 4);
  L.vmass = put(grow(p.Nv, 4), p.Nv, 4);
  L.vhits = put(grow(p.Nv, 4), p.Nv, 4);
  L.valive = put(grow(p.Nv, 1), p.Nv, 1);
  L.fx = put(grow(p.Nf, 4), p.Nf, 4);
  L.fy = put(grow(p.Nf, 4), p.Nf, 4);
  L.fvx = put(grow(p.Nf, 4), p.Nf, 4);
  L.fvy = put(grow(p.Nf, 4), p.Nf, 4);
  L.fal = put(grow(p.Nf, 1), p.Nf, 1);
  put(offsetof(H, fnext), 1, 4); put(offsetof(H, ticks), 1, 4);
  put(offsetof(H, seed), 1, 4);
  L.keys = grow(p.Np, 4);
  L.sel = grow(p.kp, 4);
  L.hits = grow(p.Nv, 4);
  L.src_f = grow(p.Nv, 4);
  tail += (16 - tail % 128 + 128) % 128;
  L.bytes = tail;
  return L;
}

#ifdef __CUDACC__
__device__ __forceinline__ void cp_async4(void* smem, const void* g) {
  const unsigned s = unsigned(__cvta_generic_to_shared(smem));
  const size_t ga = __cvta_generic_to_global(g);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(ga) : "memory");
}

// The block's envs n0 .. n0 + B - 1 between the planes and shared memory:
// in (cp.async, then a wait and a block barrier) or out. Item (row r,
// env b) of a plane goes to thread (r * B + b) mod blockDim, so a warp
// moves 32 / B rows of B contiguous words.
__device__ void stage(const Layout& L, const PlaneArray& g, uint8_t* smem,
                      int n0, int N, int B, int log_b, bool in) {
  const int nb = N - n0 < B ? N - n0 : B;
  for (int k = 0; k < N_PLANES; k++) {
    const int total = L.rows[k] << log_b, esz = L.esz[k];
    uint8_t* gp = static_cast<uint8_t*>(g.p[k]);
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int r = idx >> log_b, b = idx & (B - 1);
      if (b >= nb) continue;
      const long long gi = ((long long)r * N + n0 + b) * esz;
      uint8_t* sp = smem + b * L.bytes + L.off[k] + r * esz;
      if (esz == 4) {
        if (in) cp_async4(sp, gp + gi);
        else *reinterpret_cast<int*>(gp + gi) = *reinterpret_cast<int*>(sp);
      } else {
        if (in) *sp = gp[gi];
        else gp[gi] = *sp;
      }
    }
  }
  if (in) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

template <int PC>
__global__ void __launch_bounds__(K1_MAX_ENVS * LANES, 3)
multi_step_kernel(const EnvParams p, const __grid_constant__ PlaneArray g,
                  const __grid_constant__ Layout L,
                  const float* __restrict__ ax, const float* __restrict__ ay,
                  const int* __restrict__ aact, float* __restrict__ obs,
                  float* __restrict__ info, int N, int n_steps, int n_ticks,
                  int B, int log_b) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int n0 = blockIdx.x * B;
  stage(L, g, smem, n0, N, B, log_b, true);
  const int warp = threadIdx.x / LANES;
  if (n0 + warp < N) {
    const Team T{int(threadIdx.x % LANES)};
    const EnvS<PC> e{smem + warp * L.bytes, L};
    multi_step_env_t<PC>(T, p, e, n0 + warp, N, ax, ay, aact, obs, info,
                         n_steps, n_ticks);
  }
  __syncthreads();
  stage(L, g, smem, n0, N, B, log_b, false);
}

// B (envs a block) for a region of `bytes`: 8, halved until two blocks fit
// on an SM; 0 when one env does not fit in a block
inline int k1_envs_per_block(int bytes) {
  const long long sm = 228 * 1024, block = 227 * 1024;
  int b = K1_MAX_ENVS;
  while (b > 1 && 2 * ((long long)b * bytes + 1024) > sm) b /= 2;
  return (long long)b * bytes <= block ? b : 0;
}

// B and the dynamic shared bytes of a launch (the kernel's limit raised
// past 48 KB); non-zero when one env does not fit
template <int PC>
inline int k1_prepare(const Layout& L, int* B, int* smem) {
  *B = k1_envs_per_block(L.bytes);
  if (*B == 0) return int(cudaErrorInvalidValue);
  *smem = *B * L.bytes;
  if (*smem <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(multi_step_kernel<PC>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  *smem));
}

// the launch shape: out = {blocks, B, dynamic shared bytes, resident
// blocks per SM, region bytes}
template <int PC>
inline int k1_shape(const EnvParams& p, int N, int* out) {
  const Layout L = make_layout<PC>(p);
  int B, smem;
  const int err = k1_prepare<PC>(L, &B, &smem);
  if (err != 0) return err;
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, multi_step_kernel<PC>, B * LANES, smem);
  if (e != cudaSuccess) return int(e);
  out[0] = (N + B - 1) / B; out[1] = B; out[2] = smem; out[3] = per_sm;
  out[4] = L.bytes;
  return 0;
}

template <int PC>
inline int k1_launch(const EnvParams& p, void* const* planes, const float* ax,
                     const float* ay, const int* aact, float* obs,
                     float* info, int N, int n_steps, int n_ticks,
                     cudaStream_t stream) {
  const Layout L = make_layout<PC>(p);
  int B, smem;
  const int err = k1_prepare<PC>(L, &B, &smem);
  if (err != 0) return err;
  PlaneArray g;
  for (int k = 0; k < N_PLANES; k++) g.p[k] = planes[k];
  int log_b = 0;
  while ((1 << log_b) < B) log_b++;
  multi_step_kernel<PC><<<(N + B - 1) / B, B * LANES, smem, stream>>>(
      p, g, L, ax, ay, aact, obs, info, N, n_steps, n_ticks, B, log_b);
  return int(cudaGetLastError());
}
#else
// One env on the host (the g++ build): its column of the planes into a
// buffer, the launch's steps with one thread playing the team, back.
template <int PC>
inline void multi_step_host(const EnvParams& p, const Planes& s, int n,
                            int N, const float* ax, const float* ay,
                            const int* aact, float* obs, float* info,
                            int n_steps, int n_ticks) {
  static_assert(sizeof(Planes) == N_PLANES * sizeof(void*), "planes");
  const Layout L = make_layout<PC>(p);
  std::vector<uint64_t> buf((L.bytes + 7) / 8);
  uint8_t* base = reinterpret_cast<uint8_t*>(buf.data());
  void* const* g = reinterpret_cast<void* const*>(&s);
  auto at = [&](int k, int r) {
    return static_cast<uint8_t*>(g[k]) + ((long long)r * N + n) * L.esz[k];
  };
  for (int k = 0; k < N_PLANES; k++)
    for (int r = 0; r < L.rows[k]; r++)
      std::memcpy(base + L.off[k] + r * L.esz[k], at(k, r), L.esz[k]);
  multi_step_env_t<PC>(Team{0}, p, EnvS<PC>{base, L}, n, N, ax, ay, aact,
                       obs, info, n_steps, n_ticks);
  for (int k = 0; k < N_PLANES; k++)
    for (int r = 0; r < L.rows[k]; r++)
      std::memcpy(at(k, r), base + L.off[k] + r * L.esz[k], L.esz[k]);
}

inline void multi_step_env(const EnvParams& p, const Planes& s, int n, int N,
                           const float* ax, const float* ay, const int* aact,
                           float* obs, float* info, int n_steps,
                           int n_ticks) {
  switch (player_capacity(p.P)) {
    case 1: multi_step_host<1>(p, s, n, N, ax, ay, aact, obs, info, n_steps,
                               n_ticks);
            break;
    case 2: multi_step_host<2>(p, s, n, N, ax, ay, aact, obs, info, n_steps,
                               n_ticks);
            break;
    default: multi_step_host<9>(p, s, n, N, ax, ay, aact, obs, info,
                                n_steps, n_ticks);
  }
}

// K2's frame of (env n, agent a) on the host, from the planes in place
inline void ram_frame_host(const EnvParams& p, const Planes& s, int n, int N,
                           int a, float* out) {
  FrameScratch<MAX_PLAYERS> fs;
  std::vector<uint32_t> keys(p.Np + p.kp + 1);
  ram_frame_team(Team{0}, p, PlaneView{s, n, N}, a, out, fs, keys.data(),
                 keys.data() + p.Np);
}
#endif

}  // namespace agarcl

#ifdef __CUDACC__
// the configurations K1 refuses: rosters past 9 players, cell, tick-ring
// and virus capacities other than the kernel's
static bool k1_refuses(const agarcl::EnvParams* prm, int n_ticks) {
  return prm->P < 1 || prm->P > 9 || n_ticks < 0 || prm->Cc != agarcl::MC
         || prm->K != agarcl::MAX_TICKS_RING
         || prm->Nv > agarcl::MAX_VIRUSES;
}

extern "C" int agarcl_multi_step(const agarcl::EnvParams* prm,
                                 void* const* planes, const float* ax,
                                 const float* ay, const int* aact,
                                 float* obs, float* info, int N, int n_steps,
                                 int n_ticks, cudaStream_t stream) {
  if (k1_refuses(prm, n_ticks)) return int(cudaErrorInvalidValue);
  switch (agarcl::player_capacity(prm->P)) {
    case 1:
      return agarcl::k1_launch<1>(*prm, planes, ax, ay, aact, obs, info, N,
                                  n_steps, n_ticks, stream);
    case 2:
      return agarcl::k1_launch<2>(*prm, planes, ax, ay, aact, obs, info, N,
                                  n_steps, n_ticks, stream);
    default:
      return agarcl::k1_launch<9>(*prm, planes, ax, ay, aact, obs, info, N,
                                  n_steps, n_ticks, stream);
  }
}

// K1's launch shape for N envs (k1_shape); non-zero when a launch would
// be refused
extern "C" int agarcl_multi_step_shape(const agarcl::EnvParams* prm, int N,
                                       int* out) {
  if (k1_refuses(prm, 0)) return int(cudaErrorInvalidValue);
  switch (agarcl::player_capacity(prm->P)) {
    case 1: return agarcl::k1_shape<1>(*prm, N, out);
    case 2: return agarcl::k1_shape<2>(*prm, N, out);
    default: return agarcl::k1_shape<9>(*prm, N, out);
  }
}
#endif

// Kernel K1: k whole env steps per launch on the resident state planes.
//
// Replaces the TPU kernel agarcl_tpu/ops/fused_tick.py::_make_kernel in
// its n_steps mode (launched by _multi_step_raw_core), for rosters of up to
// 9 players: one or more agents plus the scripted bots. For each step one
// thread applies the agent actions (env.py::apply_actions), runs
// ticks_per_step engine ticks (engine/tick.py: bot decisions, movement and
// the 5-pass Jacobi relax, virus events, pellet eat, auto-split, food eat,
// feed, split, placement, recombine, decay, cross-player eating, food
// movement with virus feeding, regen), then writes that step's RAM frame
// for every agent (ram_frame.cuh) and every player's (mass, alive) row.
// With null action planes and a tick count per step it is the partial-step
// chain of agarcl_tpu/ops/fused_tick.py::fused_engine_tick (kernel_nosteps):
// n ticks with no action phase, the one-tick calls between the frames of a
// step that returns several (ops/fused_step.py).
// Wrapper and plain version: agarcl_tpu_torch/ops/fused_tick.py.
//
// Design: one thread per env, 128-thread blocks (64 blocks at 8192 envs).
// The TPU kernel's machinery — envs in vector lanes, VMEM-scratch chunk
// loops, log-shift prefix sums, parking dead pellets at 1e9, untaken-branch
// workarounds — has no counterpart: each thread walks its env's phases in
// order, as the scalar C++ oracle (oracle/oracle.cpp::engine_tick) does.
// The players' cells live in per-thread arrays for the whole launch;
// pellets, viruses and foods stay in their (feature, N) planes and are
// walked in place, so a warp's accesses to one feature are coalesced.
//
// Several players, resolved in one thread. The plain engine resolves every
// contest at once by (pid, rank) keys (SPEC M1-M5); here a thread walks
// players in pid order and cells in rank order, and each phase keeps the
// plain engine's snapshot: pellets and foods go to the first eater in that
// walk (and the cells of its rank); a player's virus event is its best
// (rank, virus) pair over the viruses alive at the phase's start, and it is
// dropped, with no fallback, when a lower pid claimed that virus; foods
// enter the shared ring in (pid, rank) order; new cells take ids kind by
// kind (pops of all players, then auto-splits, then splits); cross-player
// eating tests the masses and live cells of its start (so an eaten cell
// still eats, and a gain is never seen by a later eater) and sums the gains
// in int32. The bot pass reads the start-of-tick state. The player capacity
// PC is a template argument chosen at launch from P (1, 2 or 9), so one
// player compiles to the arrays and loops it had before bots existed.
//
// What bounds it on Hopper: per tick and env the pellet pass (Np x live
// cells distance tests, 500 x 16 x P at most) and, per step, the RAM
// frame's k-nearest scans (32 x 500 key evaluations per agent); both read
// the env's pellet keys, 2 KB per env, which stay in L1/L2 (8192 envs x
// 2 KB = 16 MB < 50 MB L2). The design tests cells in (pid, rank) order and
// stops after the first eater of a pellet, and never materializes the
// pairwise tables the TPU kernel builds. With ~6 KB of state per player and
// several KB of per-thread arrays, occupancy is low; that is accepted for
// this first, simple version.
#include "ram_frame.cuh"

namespace agarcl {

constexpr int BOT_ACTION_PERIOD = 10;
constexpr uint32_t STREAM_BOT = 4;
constexpr float SHY_RADIUS = 25.0f;
constexpr float AGGRESSIVE_RADIUS = 20.0f;
constexpr int CELL_EAT_REQUIREMENT = 25;

struct V2 { float x, y; };

struct Cells {
  float x[MAX_CELLS], y[MAX_CELLS], vx[MAX_CELLS], vy[MAX_CELLS];
  float sx[MAX_CELLS], sy[MAX_CELLS];
  int m[MAX_CELLS], id[MAX_CELLS], rec[MAX_CELLS];
  bool al[MAX_CELLS];
};

struct NewCell { float x, y, vx, vy, sx, sy; int m, rec; };

// a virus pop's candidates are a function of these (disrupt_candidates)
struct Pop { float vx, vy, cvx, cvy; int pop_mass, num_new; };

// one player's scalar state
struct Player {
  float tx, ty, anti_team;
  int action, split_cd, feed_cd, elapsed, last_decay;
  int vticks[MAX_TICKS_RING];
  int vptr, food_eaten, highest, viruses_eaten, cells_eaten;
};

// per-thread working copy of one env's players and cells
template <int PC>
struct Env {
  Cells c[PC];
  Player pl[PC];
  int next_id, fnext, ticks;
  uint32_t seed;
};

#define AT(plane, f) (plane)[(long long)(f) * N + n]

// the player count a PC-capacity kernel walks (1 is known at compile time)
template <int PC>
HD int players(const EnvParams& p) { return PC == 1 ? 1 : p.P; }

template <int PC>
HD void load_env(const EnvParams& p, const Planes& s, int n, int N,
                 Env<PC>& e) {
  const int Cc = p.Cc;
  for (int q = 0; q < players<PC>(p); q++) {
    Cells& c = e.c[q];
    for (int i = 0; i < Cc; i++) {
      const int f = q * Cc + i;
      c.x[i] = AT(s.cx, f); c.y[i] = AT(s.cy, f);
      c.vx[i] = AT(s.cvx, f); c.vy[i] = AT(s.cvy, f);
      c.sx[i] = AT(s.svx, f); c.sy[i] = AT(s.svy, f);
      c.m[i] = AT(s.cmass, f); c.id[i] = AT(s.cid, f);
      c.rec[i] = AT(s.crecomb, f); c.al[i] = AT(s.calive, f) != 0;
    }
    Player& u = e.pl[q];
    u.tx = AT(s.tx, q); u.ty = AT(s.ty, q);
    u.action = AT(s.action, q); u.split_cd = AT(s.split_cd, q);
    u.feed_cd = AT(s.feed_cd, q); u.elapsed = AT(s.elapsed, q);
    u.last_decay = AT(s.last_decay, q); u.anti_team = AT(s.anti_team, q);
    for (int k = 0; k < p.K; k++) u.vticks[k] = AT(s.vticks, q * p.K + k);
    u.vptr = AT(s.vptr, q); u.food_eaten = AT(s.food_eaten, q);
    u.highest = AT(s.highest, q); u.viruses_eaten = AT(s.viruses_eaten, q);
    u.cells_eaten = AT(s.cells_eaten, q);
  }
  e.next_id = AT(s.next_id, 0);
  e.fnext = AT(s.fnext, 0); e.ticks = AT(s.ticks, 0);
  e.seed = uint32_t(AT(s.seed, 0));
}

template <int PC>
HD void store_cells(const EnvParams& p, const Planes& s, int n, int N,
                    const Env<PC>& e) {
  const int Cc = p.Cc;
  for (int q = 0; q < players<PC>(p); q++) {
    const Cells& c = e.c[q];
    for (int i = 0; i < Cc; i++) {
      const int f = q * Cc + i;
      AT(s.cx, f) = c.x[i]; AT(s.cy, f) = c.y[i];
      AT(s.cvx, f) = c.vx[i]; AT(s.cvy, f) = c.vy[i];
      AT(s.svx, f) = c.sx[i]; AT(s.svy, f) = c.sy[i];
      AT(s.cmass, f) = c.m[i]; AT(s.cid, f) = c.id[i];
      AT(s.crecomb, f) = c.rec[i]; AT(s.calive, f) = c.al[i] ? 1 : 0;
    }
  }
}

template <int PC>
HD void store_player(const EnvParams& p, const Planes& s, int n, int N,
                     const Env<PC>& e) {
  for (int q = 0; q < players<PC>(p); q++) {
    const Player& u = e.pl[q];
    AT(s.tx, q) = u.tx; AT(s.ty, q) = u.ty;
    AT(s.action, q) = u.action; AT(s.split_cd, q) = u.split_cd;
    AT(s.feed_cd, q) = u.feed_cd; AT(s.elapsed, q) = u.elapsed;
    AT(s.last_decay, q) = u.last_decay; AT(s.anti_team, q) = u.anti_team;
    for (int k = 0; k < p.K; k++) AT(s.vticks, q * p.K + k) = u.vticks[k];
    AT(s.vptr, q) = u.vptr; AT(s.food_eaten, q) = u.food_eaten;
    AT(s.highest, q) = u.highest; AT(s.viruses_eaten, q) = u.viruses_eaten;
    AT(s.cells_eaten, q) = u.cells_eaten;
  }
  AT(s.next_id, 0) = e.next_id;
  AT(s.fnext, 0) = e.fnext; AT(s.ticks, 0) = e.ticks;
}

// counting rank by id among live cells (state.py::cell_rank_of): cells
// with equal ids share a rank; dead cells rank after the live ones
HD void cell_ranks(const Cells& c, int Cc, int* rank) {
  for (int i = 0; i < Cc; i++) {
    const int ki = c.al[i] ? c.id[i] : BIG_I;
    int r = 0;
    for (int j = 0; j < Cc; j++) {
      const int kj = c.al[j] ? c.id[j] : BIG_I;
      r += ki > kj;
    }
    rank[i] = r;
  }
}

HD V2 clamp2(const EnvParams& p, V2 v, float r) {
  return {clampb(v.x, r, p.W), clampb(v.y, r, p.H)};
}

// ------------------------------------------------------------- movement
// physics.py::move_cells
HD void move_cells(const EnvParams& p, Cells& c, float tx, float ty) {
  for (int i = 0; i < p.Cc; i++) {
    if (!c.al[i]) {
      c.x[i] = c.y[i] = c.vx[i] = c.vy[i] = c.sx[i] = c.sy[i] = 0.0f;
      continue;
    }
    const float dx = tx - c.x[i], dy = ty - c.y[i];
    const float speed = sqrtf(norm2(3.0f * dx, 3.0f * dy));
    const float lim = max_speed(float(c.m[i]));
    const float scale = speed > lim ? lim / fmaxf(speed, 1e-12f) : 1.0f;
    const float vx = dx * (scale * 3.0f), vy = dy * (scale * 3.0f);
    float px = FMAF(vx + c.sx[i], p.dt, c.x[i]);
    float py = FMAF(vy + c.sy[i], p.dt, c.y[i]);
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
}

// elastic_collision_between_balls (physics.py::_elastic) in the form of
// XLA's velocity outputs (tx_first false) or of its position outputs
// (tx_first true): the tangential products fuse on (v.y, t.y) or (v.x, t.x)
HD void elastic(V2& va, V2& vb, int ma, int mb, float dx, float dy,
                float dist, bool tx_first) {
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
  const V2 na = {FMAF(tx, dpt1, nx * v1), FMAF(ty, dpt1, ny * v1)};
  const V2 nb = {FMAF(tx, dpt2, nx * v2), FMAF(ty, dpt2, ny * v2)};
  if (ma <= mb) va = na;
  if (ma >= mb) vb = nb;
}

// avoid_static_overlap (physics.py::_avoid_static_overlap)
HD void avoid_static(const EnvParams& p, V2& pa, V2& va, V2& pb, V2& vb,
                     float ra, float rb) {
  const float dx = pb.x - pa.x, dy = pb.y - pa.y;
  const float dist = sqrtf(norm2(dx, dy));
  const float td = ra + rb;
  if (!(dist <= td)) return;
  const float den = fmaxf(fabsf(dx) + fabsf(dy), 1e-12f);
  const float depth = td - dist;
  const float rdx = (dx / den) * depth, rdy = (dy / den) * depth;
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

// separate_cells (physics.py::_separate_cells)
HD void separate(V2& pa, V2& pb, int ma, int mb, float ra, float rb,
                 float tgx, float tgy) {
  const float dx = pb.x - pa.x, dy = pb.y - pa.y;
  const float dist = sqrtf(norm2(dx, dy));
  const float td = ra + rb;
  if (!(dist <= td)) return;
  const float den = fmaxf(fabsf(dx) + fabsf(dy), 1e-12f);
  const float rx = dx / den, ry = dy / den;
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
// fallback, the boundary clamp
HD void settle(const EnvParams& p, V2& pa, V2& va, V2 sa, int ma, V2& pb,
               V2& vb, V2 sb, int mb, float ra, float rb, float tgx,
               float tgy) {
  pa = {FMAF(va.x + sa.x, p.dt, pa.x), FMAF(va.y + sa.y, p.dt, pa.y)};
  pb = {FMAF(vb.x + sb.x, p.dt, pb.x), FMAF(vb.y + sb.y, p.dt, pb.y)};
  const float rs = ra + rb;
  const bool still = rs * rs >= norm2(pb.x - pa.x, pb.y - pa.y);
  const int dm = ma - mb;
  if (still && (dm < 0 ? -dm : dm) <= 10) {
    avoid_static(p, pa, va, pb, vb, ra, rb);
  } else if (still) {
    separate(pa, pb, ma, mb, ra, rb, tgx, tgy);
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
// the position outputs' (XLA computes them in two fusions); when the two
// forms give the same bits, as they mostly do, one settle serves both
HD void prevent_overlap(const EnvParams& p, V2& pa, V2& va, V2 sa, int ma,
                        V2& pb, V2& vb, V2 sb, int mb, float tgx,
                        float tgy) {
  const float ra = radius(float(ma)), rb = radius(float(mb));
  const float dx0 = pb.x - pa.x, dy0 = pb.y - pa.y;
  const float dist0 = sqrtf(norm2(dx0, dy0));
  pa = {FMAF(-(va.x + sa.x), p.dt, pa.x), FMAF(-(va.y + sa.y), p.dt, pa.y)};
  pb = {FMAF(-(vb.x + sb.x), p.dt, pb.x), FMAF(-(vb.y + sb.y), p.dt, pb.y)};
  V2 va_p = va, vb_p = vb;
  elastic(va, vb, ma, mb, dx0, dy0, dist0, false);
  elastic(va_p, vb_p, ma, mb, dx0, dy0, dist0, true);
  if (same_bits(va, va_p) && same_bits(vb, vb_p)) {
    settle(p, pa, va, sa, ma, pb, vb, sb, mb, ra, rb, tgx, tgy);
    return;
  }
  V2 qa = pa, qb = pb;
  settle(p, qa, va, sa, ma, qb, vb, sb, mb, ra, rb, tgx, tgy);
  settle(p, pa, va_p, sa, ma, pb, vb_p, sb, mb, ra, rb, tgx, tgy);
}

HD int lowest_bit(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
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
HD void self_collisions(const EnvParams& p, Cells& c, const int* rank,
                        float tgx, float tgy) {
  const int Cc = p.Cc;
  float rad[MAX_CELLS];
  uint32_t live = 0;
  for (int i = 0; i < Cc; i++) {
    rad[i] = radius(float(c.m[i]));
    live |= c.al[i] ? 1u << i : 0u;
  }
  for (int pass = 0; pass < 6; pass++) {
    uint32_t chose[MAX_CELLS];
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
    V2 ap[MAX_CELLS], av[MAX_CELLS], bp[MAX_CELLS], bv[MAX_CELLS];
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
HD void place_new_cells(const EnvParams& p, Cells& c, int& next_id,
                        const NewCell* cand, const Pop* pop, int elapsed,
                        int count) {
  int k = 0;
  for (int i = 0; i < p.Cc && k < count; i++) {
    if (c.al[i]) continue;
    const NewCell nc = pop ? pop_candidate(*pop, k, elapsed) : cand[k];
    c.x[i] = nc.x; c.y[i] = nc.y; c.vx[i] = nc.vx; c.vy[i] = nc.vy;
    c.sx[i] = nc.sx; c.sy[i] = nc.sy;
    c.m[i] = nc.m > CELL_MIN_SIZE ? nc.m : CELL_MIN_SIZE;
    c.id[i] = next_id + k;
    c.rec[i] = nc.rec;
    c.al[i] = true;
    k++;
  }
  next_id += k;
}

// the centroid in XLA's form (state.py::xla_centroid_of): slot-order
// total, numerator a chain of fmas
HD V2 xla_centroid(const Cells& c, int Cc) {
  float tot = 0.0f, sx = 0.0f, sy = 0.0f;
  for (int i = 0; i < Cc; i++) {
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
template <int PC>
HD void bot_pass(const EnvParams& p, const Planes& s, int n, int N,
                 Env<PC>& e) {
  const int P = players<PC>(p), Cc = p.Cc;
  V2 cen[PC];
  int pm[PC];
  bool pal[PC];
  for (int q = 0; q < P; q++) {
    cen[q] = xla_centroid(e.c[q], Cc);
    int m = 0;
    bool al = false;
    for (int i = 0; i < Cc; i++) {
      m += e.c[q].al[i] ? e.c[q].m[i] : 0;
      al = al || e.c[q].al[i];
    }
    pm[q] = m;
    pal[q] = al;
  }
  for (int q = 0; q < P; q++) {
    const int bt = p.bot_type[q];
    if (bt == 0 || !pal[q]) continue;
    const V2 c0 = cen[q];
    // nearest pellet
    float bd = 3.4e38f;
    int bj = -1;
    bool any_pellet = false;
    for (int j = 0; j < p.Np; j++) {
      const int key = AT(s.pkey, j);
      if (key < 0) continue;
      any_pellet = true;
      const float d = sqrtf(norm2(c0.x - pellet_x(p, key),
                                  c0.y - pellet_y(p, key)));
      if (d > 0.01f && d < bd) { bd = d; bj = j; }
    }
    V2 tg;
    if (bj >= 0) {
      const int key = AT(s.pkey, bj);
      tg = {pellet_x(p, key), pellet_y(p, key)};
    } else if (any_pellet) {
      tg = {0.0f, 0.0f};
    } else {
      const uint32_t tk = uint32_t(e.ticks);
      tg = {floorf(p.W * uniformf(e.seed, STREAM_BOT, tk, q, 0)),
            floorf(p.H * uniformf(e.seed, STREAM_BOT, tk, q, 1))};
    }
    // hunt
    if (bt == 3 || bt == 4) {
      int big = -1, bi = 0;
      for (int i = 0; i < Cc; i++) {
        const int lm = e.c[q].al[i] ? e.c[q].m[i] : -1;
        if (lm > big) { big = lm; bi = i; }
      }
      big = e.c[q].m[bi];
      const float bigf = float(big);
      for (int j = 0; j < P; j++) {
        if (j == q || !pal[j]) continue;
        const float d = sqrtf(norm2(c0.x - cen[j].x, c0.y - cen[j].y));
        if (!(d <= AGGRESSIVE_RADIUS)) continue;
        const Cells& o = e.c[j];
        float wsum = 0.0f, sx = 0.0f, sy = 0.0f;
        int edible = 0;
        for (int i = 0; i < Cc; i++) {
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
        if (j == q || !pal[j] || pm[j] <= 0) continue;
        const float d = sqrtf(norm2(c0.x - cen[j].x, c0.y - cen[j].y));
        if (d < SHY_RADIUS) {
          tg = {2.0f * c0.x - cen[j].x, 2.0f * c0.y - cen[j].y};
          break;
        }
      }
    }
    e.pl[q].tx = tg.x;
    e.pl[q].ty = tg.y;
    e.pl[q].action = 0;
  }
}

// ------------------------------------------------------------ cross-eat
// eating.py::cross_player_eat (SPEC M3): prey j goes to the lowest
// (pid, rank) eater of another player; the masses and live cells of the
// phase's start decide every pair, gains are summed in int32
template <int PC>
HD void cross_eat(const EnvParams& p, Env<PC>& e) {
  const int P = players<PC>(p), Cc = p.Cc;
  int rank[PC][MAX_CELLS], m0[PC][MAX_CELLS];
  float rad[PC][MAX_CELLS];
  uint32_t live[PC], eaten[PC];
  for (int q = 0; q < P; q++) {
    cell_ranks(e.c[q], Cc, rank[q]);
    live[q] = 0;
    eaten[q] = 0;
    for (int i = 0; i < Cc; i++) {
      m0[q][i] = e.c[q].m[i];
      rad[q][i] = radius(float(m0[q][i]));
      live[q] |= e.c[q].al[i] ? 1u << i : 0u;
    }
  }
  for (int qj = 0; qj < P; qj++) {
    for (uint32_t mj = live[qj]; mj; mj &= mj - 1) {
      const int j = lowest_bit(mj);
      const float xj = e.c[qj].x[j], yj = e.c[qj].y[j];
      const float lim = float(m0[qj][j]) * 1.1f;
      // the lowest key: players in pid order, the lowest eligible rank
      int wq = -1, wr = BIG_I;
      for (int qi = 0; qi < P && wq < 0; qi++) {
        if (qi == qj) continue;
        for (uint32_t mi = live[qi]; mi; mi &= mi - 1) {
          const int i = lowest_bit(mi);
          if (rank[qi][i] >= wr) continue;
          const int mi_ = m0[qi][i];
          if (!(mi_ > CELL_EAT_REQUIREMENT && float(mi_) > lim)) continue;
          const float rm = fmaxf(rad[qi][i], rad[qj][j]);
          if (rm * rm >= norm2(xj - e.c[qi].x[i], yj - e.c[qi].y[i])) {
            wq = qi;
            wr = rank[qi][i];
          }
        }
      }
      if (wq < 0) continue;
      eaten[qj] |= 1u << j;
      for (uint32_t mi = live[wq]; mi; mi &= mi - 1) {
        const int i = lowest_bit(mi);
        if (rank[wq][i] != wr) continue;
        const int mi_ = m0[wq][i];
        if (!(mi_ > CELL_EAT_REQUIREMENT && float(mi_) > lim)) continue;
        const float rm = fmaxf(rad[wq][i], rad[qj][j]);
        if (rm * rm >= norm2(xj - e.c[wq].x[i], yj - e.c[wq].y[i])) {
          e.c[wq].m[i] += m0[qj][j];
          e.pl[wq].cells_eaten += 1;
        }
      }
    }
  }
  for (int q = 0; q < P; q++)
    for (uint32_t m = eaten[q]; m; m &= m - 1) e.c[q].al[lowest_bit(m)] = false;
}

// ------------------------------------------------------------ one tick
// engine/tick.py::engine_tick
template <int PC>
HD void engine_tick(const EnvParams& p, const Planes& s, int n, int N,
                    Env<PC>& e) {
  const int P = players<PC>(p);
  const int Cc = p.Cc, Nv = p.Nv, Nf = p.Nf;
  bool palive[PC];
  int action_eff[PC];

  // --- 1. bots (start-of-tick snapshot) ----------------------------------
  if (p.n_bots > 0 && floor_mod(e.ticks, BOT_ACTION_PERIOD) == 0)
    bot_pass<PC>(p, s, n, N, e);

  // --- 2. elapsed ----------------------------------------------------------
  for (int q = 0; q < P; q++) {
    bool al = false;
    for (int i = 0; i < Cc; i++) al = al || e.c[q].al[i];
    palive[q] = al;
    action_eff[q] = al ? e.pl[q].action : 0;
    e.pl[q].elapsed += al ? 1 : 0;
  }

  // --- 3. movement + relax ---------------------------------------------
  int rank[PC][MAX_CELLS], order[PC][MAX_CELLS], n_start[PC];
  for (int q = 0; q < P; q++) {
    Cells& c = e.c[q];
    move_cells(p, c, e.pl[q].tx, e.pl[q].ty);
    cell_ranks(c, Cc, rank[q]);
    self_collisions(p, c, rank[q], e.pl[q].tx, e.pl[q].ty);
    // live cells by rank, cells of one rank (equal ids) in slot order
    int ns = 0;
    for (int i = 0; i < Cc; i++) ns += c.al[i] ? 1 : 0;
    n_start[q] = ns;
    for (int r = 0, k = 0; r < ns; r++)
      for (int i = 0; i < Cc; i++)
        if (c.al[i] && rank[q][i] == r) order[q][k++] = i;
  }

  // --- 4. virus events (SPEC M2): each player's best (rank, virus) pair
  // over the viruses alive now; only the lowest pid's claim stands --------
  Pop pop[PC];
  int n_disrupt[PC];
  {
    int best[PC], bcell[PC];
    for (int q = 0; q < P; q++) {
      const Cells& c = e.c[q];
      best[q] = BIG_I;
      bcell[q] = 0;
      for (int i = 0; i < Cc; i++) {
        if (!c.al[i]) continue;
        const float rc = radius(float(c.m[i]));
        for (int v = 0; v < Nv; v++) {
          if (!AT(s.valive, v)) continue;
          const int vm = AT(s.vmass, v);
          const float rm = fmaxf(rc, radius(float(vm)));
          const bool can = float(c.m[i]) > float(vm) * 1.1f;
          if (can && rm * rm >= norm2(c.x[i] - AT(s.vx, v),
                                      c.y[i] - AT(s.vy, v))) {
            const int key = rank[q][i] * Nv + v;
            if (key < best[q]) { best[q] = key; bcell[q] = i; }
          }
        }
      }
    }
    uint64_t claimed = 0;
    for (int q = 0; q < P; q++) {
      n_disrupt[q] = 0;
      if (best[q] == BIG_I) continue;
      const int v = best[q] % Nv;
      if ((claimed >> v) & 1ull) continue;          // a lower pid's virus
      claimed |= 1ull << v;
      Cells& c = e.c[q];
      Player& u = e.pl[q];
      const int bc = bcell[q];
      u.viruses_eaten += 1;
      u.vticks[floor_mod(u.vptr, p.K)] = u.elapsed;
      u.vptr += 1;
      if (n_start[q] >= NUM_CELLS_TO_SPLIT) {
        c.m[bc] += AT(s.vmass, v);
      } else {
        // disrupt (actions.py::disrupt_candidates, SPEC Q3)
        const int total = c.m[bc];
        int cur = int(float(total) / 2.0f);
        cur = cur > CELL_MIN_SIZE ? cur : CELL_MIN_SIZE;
        cur = cur + floor_mod(total - cur, CELL_POP_SIZE);
        const int pop_mass = total - cur;
        int num_new = (pop_mass + CELL_POP_SIZE - 1) / CELL_POP_SIZE;
        int lim = PLAYER_CELL_LIMIT - n_start[q];
        lim = lim > 0 ? lim : 0;
        num_new = num_new < lim ? num_new : lim;
        c.m[bc] = cur;
        c.rec[bc] = u.elapsed + RECOMBINE_TICKS;
        pop[q] = {AT(s.vx, v), AT(s.vy, v), c.vx[bc], c.vy[bc], pop_mass,
                  num_new};
        n_disrupt[q] = num_new;
      }
    }
    for (uint64_t m = claimed; m; m &= m - 1) {
#ifdef __CUDA_ARCH__
      AT(s.valive, __ffsll((long long)m) - 1) = 0;
#else
      AT(s.valive, __builtin_ctzll(m)) = 0;
#endif
    }
  }

  // --- 5. pellets (SPEC M1): the first eater in (pid, rank) order wins,
  // with the cells of its player that share its rank ----------------------
  {
    float r2[PC][MAX_CELLS];
    for (int q = 0; q < P; q++)
      for (int i = 0; i < Cc; i++) {
        const float r = radius(float(e.c[q].m[i]));
        r2[q][i] = r * r;
      }
    for (int j = 0; j < p.Np; j++) {
      const int key = AT(s.pkey, j);
      if (key < 0) continue;
      const float px = pellet_x(p, key), py = pellet_y(p, key);
      int won = -1;
      for (int q = 0; q < P && won < 0; q++) {
        Cells& c = e.c[q];
        for (int r = 0; r < n_start[q]; r++) {
          const int i = order[q][r];
          if (won >= 0 && rank[q][i] != won) break;
          if (r2[q][i] >= norm2(c.x[i] - px, c.y[i] - py)) {
            c.m[i] += PELLET_MASS;
            e.pl[q].food_eaten += 1;
            AT(s.pkey, j) = -1;
            won = rank[q][i];
          }
        }
      }
    }
    for (int q = 0; q < P; q++) {
      int pm = 0;
      for (int i = 0; i < Cc; i++) pm += e.c[q].al[i] ? e.c[q].m[i] : 0;
      e.pl[q].highest = pm > e.pl[q].highest ? pm : e.pl[q].highest;
    }
  }

  // --- 6. auto-split + food eating ------------------------------------------
  // cand[q] holds player q's auto-split cells, then its split cells: at
  // most MAX_CELLS together (a split needs a free place under the limit)
  NewCell cand[PC][MAX_CELLS];
  int n_auto[PC], n_split[PC];
  for (int q = 0; q < P; q++) {
    Cells& c = e.c[q];
    const Player& u = e.pl[q];
    n_auto[q] = 0;
    for (int r = 0; r < n_start[q]; r++) {
      const int i = order[q][r];
      if (c.m[i] < MAX_MASS_IN_THE_GAME) continue;
      if (n_start[q] < PLAYER_CELL_LIMIT) {
        int rem;
        cand[q][n_auto[q]++] = split_fields(p, c.x[i], c.y[i], c.m[i], u.tx,
                                            u.ty, u.elapsed, &rem);
        c.m[i] = rem;
        c.rec[i] = u.elapsed + RECOMBINE_TICKS;
      } else {
        c.m[i] = NEW_MASS_IF_NO_SPLIT;
      }
    }
  }
  {
    const float rf = radius(float(FOOD_MASS));
    float rm2[PC][MAX_CELLS];
    for (int q = 0; q < P; q++)
      for (int i = 0; i < Cc; i++) {
        const float rm = fmaxf(radius(float(e.c[q].m[i])), rf);
        rm2[q][i] = e.c[q].m[i] > 11 ? rm * rm : -1.0f;
      }
    for (int f = 0; f < Nf; f++) {
      if (!AT(s.falive, f)) continue;
      const float fx = AT(s.fx, f), fy = AT(s.fy, f);
      int won = -1;
      for (int q = 0; q < P && won < 0; q++) {
        Cells& c = e.c[q];
        for (int r = 0; r < n_start[q]; r++) {
          const int i = order[q][r];
          if (won >= 0 && rank[q][i] != won) break;
          if (rm2[q][i] >= norm2(c.x[i] - fx, c.y[i] - fy)) {
            c.m[i] += FOOD_MASS;
            e.pl[q].food_eaten += 1;
            AT(s.falive, f) = 0;
            won = rank[q][i];
          }
        }
      }
    }
  }

  // --- 7. feed emission: the shared ring in (pid, rank) order -------------
  {
    int g = 0;
    for (int q = 0; q < P; q++) {
      Cells& c = e.c[q];
      Player& u = e.pl[q];
      const int fcd = u.feed_cd - 1 > 0 ? u.feed_cd - 1 : 0;
      const bool act = action_eff[q] == 1 && fcd == 0;
      if (act) {
        for (int r = 0; r < n_start[q]; r++) {
          const int i = order[q][r];
          if (c.m[i] < CELL_MIN_SIZE + FOOD_MASS) continue;
          float dx = u.tx - c.x[i], dy = u.ty - c.y[i];
          const float nn = fmaxf(sqrtf(norm2(dx, dy)), 1e-12f);
          dx = dx / nn;
          dy = dy / nn;
          const float rad = radius(float(c.m[i]));
          const int slot = floor_mod(e.fnext + g, Nf);
          AT(s.fx, slot) = c.x[i] + dx * rad;
          AT(s.fy, slot) = c.y[i] + dy * rad;
          AT(s.fvx, slot) = dx * FOOD_SPEED;
          AT(s.fvy, slot) = dy * FOOD_SPEED;
          AT(s.falive, slot) = 1;
          c.m[i] -= FOOD_MASS;
          g++;
        }
      }
      if (palive[q]) u.feed_cd = act ? FEED_COOLDOWN : fcd;
    }
    e.fnext += g;
  }

  // --- 8. split --------------------------------------------------------------
  for (int q = 0; q < P; q++) {
    Cells& c = e.c[q];
    Player& u = e.pl[q];
    n_split[q] = 0;
    const int scd = u.split_cd - 1 > 0 ? u.split_cd - 1 : 0;
    const bool act = action_eff[q] == 2 && scd == 0;
    int limit = PLAYER_CELL_LIMIT - n_start[q] - n_disrupt[q] - n_auto[q];
    limit = limit > 0 ? limit : 0;
    if (act) {
      for (int r = 0; r < n_start[q] && n_split[q] < limit; r++) {
        const int i = order[q][r];
        if (c.m[i] < CELL_SPLIT_MINIMUM) continue;
        int rem;
        cand[q][n_auto[q] + n_split[q]++] = split_fields(
            p, c.x[i], c.y[i], c.m[i], u.tx, u.ty, u.elapsed, &rem);
        c.m[i] = rem;
        c.rec[i] = u.elapsed + RECOMBINE_TICKS;
      }
    }
    if (palive[q]) u.split_cd = act ? SPLIT_COOLDOWN : scd;
  }

  // --- 9. place created cells: pops, auto-splits, splits, each kind for
  // all players in pid order (the id order) --------------------------------
  for (int q = 0; q < P; q++)
    place_new_cells(p, e.c[q], e.next_id, nullptr, &pop[q], e.pl[q].elapsed,
                    n_disrupt[q]);
  for (int q = 0; q < P; q++)
    place_new_cells(p, e.c[q], e.next_id, cand[q], nullptr, 0, n_auto[q]);
  for (int q = 0; q < P; q++)
    place_new_cells(p, e.c[q], e.next_id, cand[q] + n_auto[q], nullptr, 0,
                    n_split[q]);

  // --- 10. recombine (SPEC M7) ---------------------------------------------
  for (int q = 0; q < P; q++) {
    Cells& c = e.c[q];
    const int el = e.pl[q].elapsed;
    for (int it = 0; it < Cc; it++) {
      int rk[MAX_CELLS];
      float rr[MAX_CELLS];
      cell_ranks(c, Cc, rk);
      for (int i = 0; i < Cc; i++) rr[i] = radius(float(c.m[i]));
      int best = BIG_I, bi = -1, bj = -1;
      for (int i = 0; i < Cc; i++) {
        if (!c.al[i] || el < c.rec[i]) continue;
        for (int j = 0; j < Cc; j++) {
          if (j == i || !c.al[j] || el < c.rec[j]) continue;
          if (rk[i] >= rk[j]) continue;
          const float rse = (rr[i] + rr[j]) + RECOMBINE_TOUCH_EPS;
          if (rse * rse >= norm2(c.x[j] - c.x[i], c.y[j] - c.y[i])) {
            const int key = rk[i] * Cc + rk[j];
            if (key < best) { best = key; bi = i; bj = j; }
          }
        }
      }
      if (bi < 0) break;
      c.m[bi] += c.m[bj];
      c.al[bj] = false;
    }
  }

  // --- 11. anti-team + decay ------------------------------------------------
  for (int q = 0; q < P; q++) {
    Cells& c = e.c[q];
    Player& u = e.pl[q];
    if (!(p.mass_decay && palive[q] && u.elapsed % 60 == 0)) continue;
    const int fall_off = u.elapsed - ANTI_TEAM_TICKS;
    int cnt = 0;
    for (int k = 0; k < p.K; k++) {
      if (u.vticks[k] < fall_off) u.vticks[k] = EMPTY_TICK;
      cnt += u.vticks[k] != EMPTY_TICK;
    }
    if (cnt > 0) u.anti_team = powd(1.1f, float(cnt - 1));
    if (u.elapsed - u.last_decay >= DECAY_TICKS) {
      const float f = 1.0f - PLAYER_DECAY_RATE * u.anti_team;
      for (int i = 0; i < Cc; i++) {
        if (!c.al[i]) continue;
        const int d = int(float(c.m[i]) * f);
        c.m[i] = d > CELL_MIN_SIZE ? d : CELL_MIN_SIZE;
      }
      u.last_decay = u.elapsed;
    }
  }

  // --- 12. cross-player eating ---------------------------------------------
  if (PC > 1 && P > 1) cross_eat<PC>(p, e);

  // --- 13. foods move + virus feeding (SPEC M4) -----------------------------
  {
    int dead_slot = -1;
    for (int v = 0; v < Nv; v++) {
      if (!AT(s.valive, v)) { dead_slot = v; break; }
    }
    int hits[MAX_VIRUSES];
    V2 src_vel[MAX_VIRUSES];
    for (int v = 0; v < Nv; v++) hits[v] = 0;
    const V2 vel0 = {AT(s.fvx, 0), AT(s.fvy, 0)};
    const float rf = radius(float(FOOD_MASS));
    for (int f = 0; f < Nf; f++) {
      if (!AT(s.falive, f)) continue;
      const float vx0 = AT(s.fvx, f), vy0 = AT(s.fvy, f);
      const float mag = sqrtf(norm2(vx0, vy0));
      if (!(mag > 0.0f)) continue;
      const float ddx = vx0 / fmaxf(mag, 1e-12f) * p.kdec_food;
      const float ddy = vy0 / fmaxf(mag, 1e-12f) * p.kdec_food;
      const float nvx = fabsf(ddx) <= fabsf(vx0) ? vx0 - ddx : 0.0f;
      const float nvy = fabsf(ddy) <= fabsf(vy0) ? vy0 - ddy : 0.0f;
      const float fx = clampb(FMAF(nvx, p.dt, AT(s.fx, f)), rf, p.W);
      const float fy = clampb(FMAF(nvy, p.dt, AT(s.fy, f)), rf, p.H);
      AT(s.fx, f) = fx; AT(s.fy, f) = fy;
      AT(s.fvx, f) = nvx; AT(s.fvy, f) = nvy;
      for (int v = 0; v < Nv; v++) {
        if (!AT(s.valive, v)) continue;
        const float rm = fmaxf(rf, radius(float(AT(s.vmass, v))));
        if (rm * rm >= norm2(fx - AT(s.vx, v), fy - AT(s.vy, v))) {
          if (hits[v] == 0) src_vel[v] = {vx0, vy0};
          hits[v] += 1;
          AT(s.falive, f) = 0;
          break;
        }
      }
    }
    int burst_slot = -1;
    for (int v = 0; v < Nv; v++) {
      const int nh = AT(s.vhits, v) + hits[v];
      const bool burst = AT(s.valive, v) && nh > NUMBER_OF_FOOD_HITS;
      int post = nh - (NUMBER_OF_FOOD_HITS + 1);
      post = post > 0 ? post : 0;
      AT(s.vhits, v) = burst ? post : nh;
      AT(s.vmass, v) = burst ? VIRUS_INITIAL_MASS + post * FOOD_MASS
                             : AT(s.vmass, v) + hits[v] * FOOD_MASS;
      if (burst && burst_slot < 0) burst_slot = v;
    }
    if (burst_slot >= 0 && dead_slot >= 0) {
      const V2 sv = hits[burst_slot] > 0 ? src_vel[burst_slot] : vel0;
      const float r100 = radius(float(VIRUS_INITIAL_MASS));
      const float spx = AT(s.vx, burst_slot) + sv.x * p.spawn_k;
      const float spy = AT(s.vy, burst_slot) + sv.y * p.spawn_k;
      AT(s.vx, dead_slot) = clampb(spx, r100, p.W);
      AT(s.vy, dead_slot) = clampb(spy, r100, p.H);
      AT(s.vvx, dead_slot) = sv.x;
      AT(s.vvy, dead_slot) = sv.y;
      AT(s.vmass, dead_slot) = VIRUS_INITIAL_MASS;
      AT(s.vhits, dead_slot) = 0;
      AT(s.valive, dead_slot) = 1;
    }
  }

  // --- 14. regeneration ------------------------------------------------------
  if (p.pellet_regen && floor_mod(e.ticks, REGEN_PERIOD) == 0) {
    const uint32_t tk = uint32_t(e.ticks);
    int alive_n = 0;
    for (int j = 0; j < p.Np; j++) alive_n += AT(s.pkey, j) >= 0;
    int deficit = p.num_pellets - alive_n;
    for (int j = 0, dead = 0; j < p.Np && dead < deficit; j++) {
      if (AT(s.pkey, j) >= 0) continue;
      const int qx = uniform_q(p.nqx, e.seed, STREAM_PELLET, tk, j, 0)
                     + p.qlx;
      const int qy = uniform_q(p.nqy, e.seed, STREAM_PELLET, tk, j, 1)
                     + p.qly;
      AT(s.pkey, j) = (qx << 15) | qy;
      dead++;
    }
    int valive_n = 0;
    for (int v = 0; v < Nv; v++) valive_n += AT(s.valive, v) ? 1 : 0;
    const int vdef = p.num_viruses - valive_n;
    for (int v = 0, dead = 0; v < Nv && dead < vdef; v++) {
      if (AT(s.valive, v)) continue;
      // spawn.py::random_location: fma(f32(W - 2r), u, f32(r))
      AT(s.vx, v) = FMAF(p.virus_hi_x,
                         uniformf(e.seed, STREAM_VIRUS, tk, v, 0),
                         p.virus_rad);
      AT(s.vy, v) = FMAF(p.virus_hi_y,
                         uniformf(e.seed, STREAM_VIRUS, tk, v, 1),
                         p.virus_rad);
      AT(s.vvx, v) = 0.0f; AT(s.vvy, v) = 0.0f;
      AT(s.vmass, v) = VIRUS_INITIAL_MASS;
      AT(s.vhits, v) = 0;
      AT(s.valive, v) = 1;
      dead++;
    }
  }

  // --- 15. assemble: dead cells keep stale pos/vel, lose mass and split vel
  for (int q = 0; q < P; q++) {
    Cells& c = e.c[q];
    for (int i = 0; i < Cc; i++) {
      if (c.al[i]) continue;
      c.sx[i] = 0.0f; c.sy[i] = 0.0f; c.m[i] = 0;
    }
  }
  e.ticks += 1;
}

// apply_actions (env.py) for agent a: target = fma(10, (dx, dy), centroid)
HD void apply_actions(const EnvParams& p, const Cells& c, Player& u,
                      float ax, float ay, int act) {
  bool al = false;
  for (int i = 0; i < p.Cc; i++) al = al || c.al[i];
  if (!al) return;
  const V2 cen = xla_centroid(c, p.Cc);
  u.tx = FMAF(TARGET_ACTION_SCALE, ax, cen.x);
  u.ty = FMAF(TARGET_ACTION_SCALE, ay, cen.y);
  u.action = act;
}

// the whole launch for env n: n_steps x (actions, n_ticks ticks, frames,
// info rows). Null action planes skip the action phase: the partial-step
// chain of fused_engine_tick (agarcl_tpu/ops/fused_tick.py kernel_nosteps),
// n_ticks engine ticks of the planes as they are.
template <int PC>
HD void multi_step_env_t(const EnvParams& p, const Planes& s, int n, int N,
                         const float* ax, const float* ay, const int* aact,
                         float* obs, float* info, int n_steps, int n_ticks) {
  const int P = players<PC>(p);
  Env<PC> e;
  load_env<PC>(p, s, n, N, e);
  for (int step = 0; step < n_steps; step++) {
    if (ax != nullptr)
      for (int a = 0; a < p.A; a++)
        apply_actions(p, e.c[a], e.pl[a], ax[a * N + n], ay[a * N + n],
                      aact[a * N + n]);
    for (int t = 0; t < n_ticks; t++)
      engine_tick<PC>(p, s, n, N, e);
    store_cells<PC>(p, s, n, N, e);
    const long long row = (long long)step * N + n;
    if (obs != nullptr)
      for (int a = 0; a < p.A; a++)
        ram_frame_env(p, s, n, N, a, obs + (row * p.A + a) * p.R);
    for (int q = 0; q < P; q++) {
      int pm = 0;
      bool al = false;
      for (int i = 0; i < p.Cc; i++) {
        pm += e.c[q].al[i] ? e.c[q].m[i] : 0;
        al = al || e.c[q].al[i];
      }
      info[row * 2 * P + q] = float(pm);
      info[(row * 2 + 1) * P + q] = al ? 1.0f : 0.0f;
    }
  }
  store_player<PC>(p, s, n, N, e);
}

// the player capacity of a roster of P players
HD int player_capacity(int P) { return P == 1 ? 1 : P == 2 ? 2 : 9; }

HD void multi_step_env(const EnvParams& p, const Planes& s, int n, int N,
                       const float* ax, const float* ay, const int* aact,
                       float* obs, float* info, int n_steps, int n_ticks) {
  switch (player_capacity(p.P)) {
    case 1: multi_step_env_t<1>(p, s, n, N, ax, ay, aact, obs, info, n_steps,
                                n_ticks);
            break;
    case 2: multi_step_env_t<2>(p, s, n, N, ax, ay, aact, obs, info, n_steps,
                                n_ticks);
            break;
    default: multi_step_env_t<9>(p, s, n, N, ax, ay, aact, obs, info,
                                 n_steps, n_ticks);
  }
}

#undef AT

#ifdef __CUDACC__
template <int PC>
__global__ void __launch_bounds__(128)
multi_step_kernel(const EnvParams p, const Planes s,
                  const float* __restrict__ ax, const float* __restrict__ ay,
                  const int* __restrict__ aact, float* __restrict__ obs,
                  float* __restrict__ info, int N, int n_steps, int n_ticks) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  multi_step_env_t<PC>(p, s, n, N, ax, ay, aact, obs, info, n_steps, n_ticks);
}
#endif

}  // namespace agarcl

#ifdef __CUDACC__
extern "C" int agarcl_multi_step(const agarcl::EnvParams* prm,
                                 void* const* planes, const float* ax,
                                 const float* ay, const int* aact,
                                 float* obs, float* info, int N, int n_steps,
                                 int n_ticks, cudaStream_t stream) {
  if (prm->P < 1 || prm->P > 9 || n_ticks < 0)
    return int(cudaErrorInvalidValue);
  const agarcl::Planes s = agarcl::planes_from(planes);
  const int threads = 128;
  const int blocks = (N + threads - 1) / threads;
  switch (agarcl::player_capacity(prm->P)) {
    case 1:
      agarcl::multi_step_kernel<1><<<blocks, threads, 0, stream>>>(
          *prm, s, ax, ay, aact, obs, info, N, n_steps, n_ticks);
      break;
    case 2:
      agarcl::multi_step_kernel<2><<<blocks, threads, 0, stream>>>(
          *prm, s, ax, ay, aact, obs, info, N, n_steps, n_ticks);
      break;
    default:
      agarcl::multi_step_kernel<9><<<blocks, threads, 0, stream>>>(
          *prm, s, ax, ay, aact, obs, info, N, n_steps, n_ticks);
  }
  return int(cudaGetLastError());
}
#endif

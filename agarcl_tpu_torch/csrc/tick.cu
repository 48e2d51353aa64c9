// Kernel K1: k whole env steps per launch on the resident state planes.
//
// Replaces the TPU kernel agarcl_tpu/ops/fused_tick.py::_make_kernel in
// its n_steps mode (launched by _multi_step_raw_core) for one player
// without bots. For each step one thread applies the agent actions
// (env.py::apply_actions), runs ticks_per_step engine ticks
// (engine/tick.py: movement and the 5-pass Jacobi relax, virus events,
// pellet eat, auto-split, food eat, feed, split, placement, recombine,
// decay, food movement with virus feeding, regen), then writes that
// step's RAM frame (ram_frame.cuh) and its (mass, alive) row. Wrapper and
// plain version: agarcl_tpu_torch/ops/fused_tick.py.
//
// Design: one thread per env, 128-thread blocks (64 blocks at 8192 envs).
// The TPU kernel's machinery — envs in vector lanes, VMEM-scratch chunk
// loops, log-shift prefix sums, parking dead pellets at 1e9, untaken-branch
// workarounds — has no counterpart: each thread walks its env's phases in
// order, as the scalar C++ oracle (oracle/oracle.cpp::engine_tick) does.
// The 16 cells live in per-thread arrays for the whole launch; pellets,
// viruses and foods stay in their (feature, N) planes and are walked in
// place, so a warp's accesses to one feature are coalesced.
//
// What bounds it on Hopper: per tick and env the pellet pass (Np x live
// cells distance tests, 500 x 16 at most on the main path) and, per step,
// the RAM frame's k-nearest scans (32 x 500 key evaluations); both read
// the env's pellet keys, 2 KB per env, which stay in L1/L2 (8192 envs x
// 2 KB = 16 MB < 50 MB L2). The design tests cells in rank order and stops
// after the first eater of a pellet (and the cells of equal rank), and
// never materializes the pairwise
// tables the TPU kernel builds. With ~6 KB of state and several KB of
// per-thread arrays, occupancy is low; that is accepted for this first,
// simple version.
#include "ram_frame.cuh"

namespace agarcl {

struct V2 { float x, y; };

struct Cells {
  float x[MAX_CELLS], y[MAX_CELLS], vx[MAX_CELLS], vy[MAX_CELLS];
  float sx[MAX_CELLS], sy[MAX_CELLS];
  int m[MAX_CELLS], id[MAX_CELLS], rec[MAX_CELLS];
  bool al[MAX_CELLS];
};

struct NewCell { float x, y, vx, vy, sx, sy; int m, rec; };

// per-thread working copy of one env's player and cell state
struct Env {
  Cells c;
  float tx, ty, anti_team;
  int action, split_cd, feed_cd, elapsed, last_decay;
  int vticks[MAX_TICKS_RING];
  int vptr, food_eaten, highest, viruses_eaten, cells_eaten;
  int next_id, fnext, ticks;
  uint32_t seed;
};

#define AT(plane, f) (plane)[(long long)(f) * N + n]

HD void load_env(const EnvParams& p, const Planes& s, int n, int N,
                 Env& e) {
  for (int i = 0; i < p.Cc; i++) {
    e.c.x[i] = AT(s.cx, i); e.c.y[i] = AT(s.cy, i);
    e.c.vx[i] = AT(s.cvx, i); e.c.vy[i] = AT(s.cvy, i);
    e.c.sx[i] = AT(s.svx, i); e.c.sy[i] = AT(s.svy, i);
    e.c.m[i] = AT(s.cmass, i); e.c.id[i] = AT(s.cid, i);
    e.c.rec[i] = AT(s.crecomb, i); e.c.al[i] = AT(s.calive, i) != 0;
  }
  e.tx = AT(s.tx, 0); e.ty = AT(s.ty, 0);
  e.action = AT(s.action, 0); e.split_cd = AT(s.split_cd, 0);
  e.feed_cd = AT(s.feed_cd, 0); e.elapsed = AT(s.elapsed, 0);
  e.last_decay = AT(s.last_decay, 0); e.anti_team = AT(s.anti_team, 0);
  for (int k = 0; k < p.K; k++) e.vticks[k] = AT(s.vticks, k);
  e.vptr = AT(s.vptr, 0); e.food_eaten = AT(s.food_eaten, 0);
  e.highest = AT(s.highest, 0); e.viruses_eaten = AT(s.viruses_eaten, 0);
  e.cells_eaten = AT(s.cells_eaten, 0); e.next_id = AT(s.next_id, 0);
  e.fnext = AT(s.fnext, 0); e.ticks = AT(s.ticks, 0);
  e.seed = uint32_t(AT(s.seed, 0));
}

HD void store_cells(const EnvParams& p, const Planes& s, int n, int N,
                    const Env& e) {
  for (int i = 0; i < p.Cc; i++) {
    AT(s.cx, i) = e.c.x[i]; AT(s.cy, i) = e.c.y[i];
    AT(s.cvx, i) = e.c.vx[i]; AT(s.cvy, i) = e.c.vy[i];
    AT(s.svx, i) = e.c.sx[i]; AT(s.svy, i) = e.c.sy[i];
    AT(s.cmass, i) = e.c.m[i]; AT(s.cid, i) = e.c.id[i];
    AT(s.crecomb, i) = e.c.rec[i]; AT(s.calive, i) = e.c.al[i] ? 1 : 0;
  }
}

HD void store_player(const EnvParams& p, const Planes& s, int n, int N,
                     const Env& e) {
  AT(s.tx, 0) = e.tx; AT(s.ty, 0) = e.ty;
  AT(s.action, 0) = e.action; AT(s.split_cd, 0) = e.split_cd;
  AT(s.feed_cd, 0) = e.feed_cd; AT(s.elapsed, 0) = e.elapsed;
  AT(s.last_decay, 0) = e.last_decay; AT(s.anti_team, 0) = e.anti_team;
  for (int k = 0; k < p.K; k++) AT(s.vticks, k) = e.vticks[k];
  AT(s.vptr, 0) = e.vptr; AT(s.food_eaten, 0) = e.food_eaten;
  AT(s.highest, 0) = e.highest; AT(s.viruses_eaten, 0) = e.viruses_eaten;
  AT(s.cells_eaten, 0) = e.cells_eaten; AT(s.next_id, 0) = e.next_id;
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
HD void move_cells(const EnvParams& p, Env& e) {
  Cells& c = e.c;
  for (int i = 0; i < p.Cc; i++) {
    if (!c.al[i]) {
      c.x[i] = c.y[i] = c.vx[i] = c.vy[i] = c.sx[i] = c.sy[i] = 0.0f;
      continue;
    }
    const float dx = e.tx - c.x[i], dy = e.ty - c.y[i];
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

// elastic_collision_between_balls (physics.py::_elastic)
HD void elastic(V2& va, V2& vb, int ma, int mb, float dx, float dy,
                float dist) {
  const float d = fmaxf(dist, 1e-12f);
  const float nx = dx / d, ny = dy / d;
  const float tx = -ny, ty = nx;
  const float dpn1 = FMAF(va.x, nx, va.y * ny);
  const float dpn2 = FMAF(vb.x, nx, vb.y * ny);
  const float dpt1 = FMAF(va.y, ty, va.x * tx);
  const float dpt2 = FMAF(vb.y, ty, vb.x * tx);
  const float m1 = float(ma), m2 = float(mb);
  const float msum = fmaxf(m1 + m2, 1.0f);
  const float v1 = FMAF(dpn1, m1 - m2, (2.0f * m2) * dpn2) / msum;
  const float v2 = FMAF(2.0f * m1, dpn1, dpn2 * (m2 - m1)) / msum;
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

// prevent_overlap (physics.py::_prevent_overlap)
HD void prevent_overlap(const EnvParams& p, V2& pa, V2& va, V2 sa, int ma,
                        V2& pb, V2& vb, V2 sb, int mb, float tgx,
                        float tgy) {
  const float ra = radius(float(ma)), rb = radius(float(mb));
  const float dx0 = pb.x - pa.x, dy0 = pb.y - pa.y;
  const float dist0 = sqrtf(norm2(dx0, dy0));
  pa = {FMAF(-(va.x + sa.x), p.dt, pa.x), FMAF(-(va.y + sa.y), p.dt, pa.y)};
  pb = {FMAF(-(vb.x + sb.x), p.dt, pb.x), FMAF(-(vb.y + sb.y), p.dt, pb.y)};
  elastic(va, vb, ma, mb, dx0, dy0, dist0);
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
HD void self_collisions(const EnvParams& p, Env& e, const int* rank) {
  Cells& c = e.c;
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
                          {c.sx[j], c.sy[j]}, c.m[j], e.tx, e.ty);
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

// place_new_cells (SPEC M8): candidates take the lowest free slots in
// creation order with consecutive fresh ids
HD void place_new_cells(const EnvParams& p, Env& e, const NewCell* cand,
                        int count) {
  Cells& c = e.c;
  int k = 0;
  for (int i = 0; i < p.Cc && k < count; i++) {
    if (c.al[i]) continue;
    const NewCell& nc = cand[k];
    c.x[i] = nc.x; c.y[i] = nc.y; c.vx[i] = nc.vx; c.vy[i] = nc.vy;
    c.sx[i] = nc.sx; c.sy[i] = nc.sy;
    c.m[i] = nc.m > CELL_MIN_SIZE ? nc.m : CELL_MIN_SIZE;
    c.id[i] = e.next_id + k;
    c.rec[i] = nc.rec;
    c.al[i] = true;
    k++;
  }
  e.next_id += k;
}

// ------------------------------------------------------------ one tick
// engine/tick.py::engine_tick for one player without bots
HD void engine_tick(const EnvParams& p, const Planes& s, int n, int N,
                    Env& e) {
  Cells& c = e.c;
  const int Cc = p.Cc, Nv = p.Nv, Nf = p.Nf;
  bool palive = false;
  for (int i = 0; i < Cc; i++) palive = palive || c.al[i];
  const int action_eff = palive ? e.action : 0;
  e.elapsed += palive ? 1 : 0;

  // --- 3. movement + relax ---------------------------------------------
  move_cells(p, e);
  int rank[MAX_CELLS];
  cell_ranks(c, Cc, rank);
  self_collisions(p, e, rank);
  // live cells by rank, cells of one rank (equal ids) in slot order
  int order[MAX_CELLS];
  int n_start = 0;
  for (int i = 0; i < Cc; i++) n_start += c.al[i] ? 1 : 0;
  for (int r = 0, k = 0; r < n_start; r++)
    for (int i = 0; i < Cc; i++)
      if (c.al[i] && rank[i] == r) order[k++] = i;

  // --- 4. virus events (SPEC M2) ------------------------------------------
  NewCell cand_pop[PLAYER_CELL_LIMIT];
  int n_disrupt = 0;
  {
    int best = BIG_I, bc = 0;
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
          const int key = rank[i] * Nv + v;
          if (key < best) { best = key; bc = i; }
        }
      }
    }
    if (best < BIG_I) {
      const int v = best % Nv;
      AT(s.valive, v) = 0;
      e.viruses_eaten += 1;
      e.vticks[floor_mod(e.vptr, p.K)] = e.elapsed;
      e.vptr += 1;
      if (n_start >= NUM_CELLS_TO_SPLIT) {
        c.m[bc] += AT(s.vmass, v);
      } else {
        // disrupt (actions.py::disrupt_candidates, SPEC Q3)
        const int total = c.m[bc];
        int cur = int(float(total) / 2.0f);
        cur = cur > CELL_MIN_SIZE ? cur : CELL_MIN_SIZE;
        cur = cur + floor_mod(total - cur, CELL_POP_SIZE);
        const int pop_mass = total - cur;
        int num_new = (pop_mass + CELL_POP_SIZE - 1) / CELL_POP_SIZE;
        int lim = PLAYER_CELL_LIMIT - n_start;
        lim = lim > 0 ? lim : 0;
        num_new = num_new < lim ? num_new : lim;
        c.m[bc] = cur;
        c.rec[bc] = e.elapsed + RECOMBINE_TICKS;
        const float theta = direction(c.vx[bc], c.vy[bc]);
        const float nn = float(num_new > 1 ? num_new : 1);
        const float pop_speed = max_speed(float(CELL_POP_SIZE));
        for (int k = 0; k < num_new; k++) {
          const float ang = theta + (theta + TWO_PI32 * float(k) / nn);
          int mk = pop_mass - CELL_POP_SIZE * k;
          mk = mk < CELL_POP_SIZE ? mk : CELL_POP_SIZE;
          cand_pop[k] = {AT(s.vx, v), AT(s.vy, v), c.vx[bc], c.vy[bc],
                         float(cos(double(ang))) * pop_speed,
                         float(sin(double(ang))) * pop_speed,
                         mk > 1 ? mk : 1, e.elapsed + RECOMBINE_TICKS};
        }
        n_disrupt = num_new;
      }
    }
  }

  // --- 5. pellets (SPEC M1): the lowest-rank eater wins; cells that share
  // that rank all eat it (eating.py::_resolve) ------------------------------
  {
    float r2[MAX_CELLS];
    int eaten[MAX_CELLS];
    for (int i = 0; i < Cc; i++) {
      const float r = radius(float(c.m[i]));
      r2[i] = r * r;
      eaten[i] = 0;
    }
    for (int j = 0; j < p.Np; j++) {
      const int key = AT(s.pkey, j);
      if (key < 0) continue;
      const float px = pellet_x(p, key), py = pellet_y(p, key);
      for (int r = 0, won = -1; r < n_start; r++) {
        const int i = order[r];
        if (won >= 0 && rank[i] != won) break;
        if (r2[i] >= norm2(c.x[i] - px, c.y[i] - py)) {
          eaten[i] += 1;
          AT(s.pkey, j) = -1;
          won = rank[i];
        }
      }
    }
    int pm = 0;
    for (int i = 0; i < Cc; i++) {
      c.m[i] += eaten[i] * PELLET_MASS;
      e.food_eaten += eaten[i];
      pm += c.al[i] ? c.m[i] : 0;
    }
    e.highest = pm > e.highest ? pm : e.highest;
  }

  // --- 6. auto-split + food eating ------------------------------------------
  NewCell cand_auto[MAX_CELLS];
  int n_auto = 0;
  for (int r = 0; r < n_start; r++) {
    const int i = order[r];
    if (c.m[i] < MAX_MASS_IN_THE_GAME) continue;
    if (n_start < PLAYER_CELL_LIMIT) {
      int rem;
      cand_auto[n_auto++] = split_fields(p, c.x[i], c.y[i], c.m[i], e.tx,
                                         e.ty, e.elapsed, &rem);
      c.m[i] = rem;
      c.rec[i] = e.elapsed + RECOMBINE_TICKS;
    } else {
      c.m[i] = NEW_MASS_IF_NO_SPLIT;
    }
  }
  {
    const float rf = radius(float(FOOD_MASS));
    float rm2[MAX_CELLS];
    int eaten[MAX_CELLS];
    for (int i = 0; i < Cc; i++) {
      const float rm = fmaxf(radius(float(c.m[i])), rf);
      rm2[i] = rm * rm;
      eaten[i] = 0;
    }
    for (int f = 0; f < Nf; f++) {
      if (!AT(s.falive, f)) continue;
      const float fx = AT(s.fx, f), fy = AT(s.fy, f);
      for (int r = 0, won = -1; r < n_start; r++) {
        const int i = order[r];
        if (won >= 0 && rank[i] != won) break;
        if (c.m[i] > 11 && rm2[i] >= norm2(c.x[i] - fx, c.y[i] - fy)) {
          eaten[i] += 1;
          AT(s.falive, f) = 0;
          won = rank[i];
        }
      }
    }
    for (int i = 0; i < Cc; i++) {
      c.m[i] += eaten[i] * FOOD_MASS;
      e.food_eaten += eaten[i];
    }
  }

  // --- 7. feed emission ------------------------------------------------------
  {
    const int fcd = e.feed_cd - 1 > 0 ? e.feed_cd - 1 : 0;
    const bool act = action_eff == 1 && fcd == 0;
    int g = 0;
    if (act) {
      for (int r = 0; r < n_start; r++) {
        const int i = order[r];
        if (c.m[i] < CELL_MIN_SIZE + FOOD_MASS) continue;
        float dx = e.tx - c.x[i], dy = e.ty - c.y[i];
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
    e.fnext += g;
    if (palive) e.feed_cd = act ? FEED_COOLDOWN : fcd;
  }

  // --- 8. split --------------------------------------------------------------
  NewCell cand_split[MAX_CELLS];
  int n_split = 0;
  {
    const int scd = e.split_cd - 1 > 0 ? e.split_cd - 1 : 0;
    const bool act = action_eff == 2 && scd == 0;
    int limit = PLAYER_CELL_LIMIT - n_start - n_disrupt - n_auto;
    limit = limit > 0 ? limit : 0;
    if (act) {
      for (int r = 0; r < n_start && n_split < limit; r++) {
        const int i = order[r];
        if (c.m[i] < CELL_SPLIT_MINIMUM) continue;
        int rem;
        cand_split[n_split++] = split_fields(p, c.x[i], c.y[i], c.m[i],
                                             e.tx, e.ty, e.elapsed, &rem);
        c.m[i] = rem;
        c.rec[i] = e.elapsed + RECOMBINE_TICKS;
      }
    }
    if (palive) e.split_cd = act ? SPLIT_COOLDOWN : scd;
  }

  // --- 9. place created cells (pop, auto-split, split order) ----------------
  place_new_cells(p, e, cand_pop, n_disrupt);
  place_new_cells(p, e, cand_auto, n_auto);
  place_new_cells(p, e, cand_split, n_split);

  // --- 10. recombine (SPEC M7) ---------------------------------------------
  for (int it = 0; it < Cc; it++) {
    int rk[MAX_CELLS];
    float rr[MAX_CELLS];
    cell_ranks(c, Cc, rk);
    for (int i = 0; i < Cc; i++) rr[i] = radius(float(c.m[i]));
    int best = BIG_I, bi = -1, bj = -1;
    for (int i = 0; i < Cc; i++) {
      if (!c.al[i] || e.elapsed < c.rec[i]) continue;
      for (int j = 0; j < Cc; j++) {
        if (j == i || !c.al[j] || e.elapsed < c.rec[j]) continue;
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

  // --- 11. anti-team + decay ------------------------------------------------
  if (p.mass_decay && palive && e.elapsed % 60 == 0) {
    const int fall_off = e.elapsed - ANTI_TEAM_TICKS;
    int cnt = 0;
    for (int k = 0; k < p.K; k++) {
      if (e.vticks[k] < fall_off) e.vticks[k] = EMPTY_TICK;
      cnt += e.vticks[k] != EMPTY_TICK;
    }
    if (cnt > 0) e.anti_team = powd(1.1f, float(cnt - 1));
    if (e.elapsed - e.last_decay >= DECAY_TICKS) {
      const float f = 1.0f - PLAYER_DECAY_RATE * e.anti_team;
      for (int i = 0; i < Cc; i++) {
        if (!c.al[i]) continue;
        const int d = int(float(c.m[i]) * f);
        c.m[i] = d > CELL_MIN_SIZE ? d : CELL_MIN_SIZE;
      }
      e.last_decay = e.elapsed;
    }
  }

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
  for (int i = 0; i < Cc; i++) {
    if (c.al[i]) continue;
    c.sx[i] = 0.0f; c.sy[i] = 0.0f; c.m[i] = 0;
  }
  e.ticks += 1;
}

// apply_actions (env.py) for agent 0: target = centroid + 10*(dx, dy)
HD void apply_actions(const EnvParams& p, Env& e, float ax, float ay,
                      int act) {
  const Cells& c = e.c;
  float tot = 0.0f, sx = 0.0f, sy = 0.0f;
  bool al = false;
  for (int i = 0; i < p.Cc; i++) {
    const float w = c.al[i] ? float(c.m[i]) : 0.0f;
    tot = tot + w;
    sx = sx + c.x[i] * w;
    sy = sy + c.y[i] * w;
    al = al || c.al[i];
  }
  if (!al) return;
  const float den = fmaxf(tot, 1.0f);
  e.tx = sx / den + TARGET_ACTION_SCALE * ax;
  e.ty = sy / den + TARGET_ACTION_SCALE * ay;
  e.action = act;
}

// the whole launch for env n: n_steps x (actions, ticks, frame, info row)
HD void multi_step_env(const EnvParams& p, const Planes& s, int n, int N,
                       const float* ax, const float* ay, const int* aact,
                       float* obs, float* info, int n_steps) {
  Env e;
  load_env(p, s, n, N, e);
  for (int step = 0; step < n_steps; step++) {
    apply_actions(p, e, ax[n], ay[n], aact[n]);
    for (int t = 0; t < p.ticks_per_step; t++) engine_tick(p, s, n, N, e);
    store_cells(p, s, n, N, e);
    const long long row = (long long)step * N + n;
    if (obs != nullptr) ram_frame_env(p, s, n, N, 0, obs + row * p.R);
    int pm = 0;
    bool al = false;
    for (int i = 0; i < p.Cc; i++) {
      pm += e.c.al[i] ? e.c.m[i] : 0;
      al = al || e.c.al[i];
    }
    info[row * 2] = float(pm);
    info[row * 2 + 1] = al ? 1.0f : 0.0f;
  }
  store_player(p, s, n, N, e);
}

#undef AT

#ifdef __CUDACC__
__global__ void __launch_bounds__(128)
multi_step_kernel(const EnvParams p, const Planes s,
                  const float* __restrict__ ax, const float* __restrict__ ay,
                  const int* __restrict__ aact, float* __restrict__ obs,
                  float* __restrict__ info, int N, int n_steps) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  multi_step_env(p, s, n, N, ax, ay, aact, obs, info, n_steps);
}
#endif

}  // namespace agarcl

#ifdef __CUDACC__
extern "C" int agarcl_multi_step(const agarcl::EnvParams* prm,
                                 void* const* planes, const float* ax,
                                 const float* ay, const int* aact,
                                 float* obs, float* info, int N, int n_steps,
                                 cudaStream_t stream) {
  const agarcl::Planes s = agarcl::planes_from(planes);
  const int threads = 128;
  const int blocks = (N + threads - 1) / threads;
  agarcl::multi_step_kernel<<<blocks, threads, 0, stream>>>(
      *prm, s, ax, ay, aact, obs, info, N, n_steps);
  return int(cudaGetLastError());
}
#endif

// Shared pieces of the hand-written Hopper kernels: constants, the
// parameter block, the state-plane pointers, the counter hash and the
// scalar game-math laws.
//
// Every function is host+device so the same source also compiles as plain
// C++ (no __CUDACC__). Arithmetic follows the plain engine of the port
// (agarcl_tpu_torch/engine/*.py) operation for operation:
//  - the library is built with --fmad=false, so no a*b+c is contracted
//    except the explicit FMAF sites, which are the sites XLA-CPU fuses
//    (engine/geometry.py "FMA contract");
//  - pow is evaluated in double and rounded once; atan, cos and sin are
//    glibc's f32 atanf / cosf / sinf, XLA-CPU's own (atan32, cos32, sin32
//    below; engine/geometry.py "Transcendentals");
//  - sqrtf and division are IEEE (nvcc's defaults; never --use_fast_math);
//  - f32 sums over cell slots run in slot order, one add at a time.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif
// one rounding of a*b+c: fma.rn.f32 on the device, libm's fmaf on the host
#define FMAF(a, b, c) fmaf((a), (b), (c))

namespace agarcl {

// compile-time capacities (agarcl_tpu_torch/ops/params.py checks configs)
constexpr int MAX_CELLS = 16;
constexpr int MAX_TICKS_RING = 16;
constexpr int MAX_VIRUSES = 64;
constexpr int MAX_PLAYERS = 16;

// game constants (agarcl_tpu_torch/constants.py)
constexpr int CELL_MIN_SIZE = 25;
constexpr float CELL_MAX_SPEED = 300.0f;
constexpr int CELL_SPLIT_MINIMUM = 50;
constexpr int RECOMBINE_TICKS = 300;
constexpr float RECOMBINE_TOUCH_EPS = 0.01f;
constexpr int CELL_POP_SIZE = 25;
constexpr int PLAYER_CELL_LIMIT = 14;
constexpr int NUM_CELLS_TO_SPLIT = PLAYER_CELL_LIMIT;
constexpr float PLAYER_DECAY_RATE = 0.002f;
constexpr int DECAY_TICKS = 60;
constexpr int NUMBER_OF_FOOD_HITS = 7;
constexpr int MAX_MASS_IN_THE_GAME = 22500;
constexpr int NEW_MASS_IF_NO_SPLIT = 22000;
constexpr int ANTI_TEAM_TICKS = 3600;
constexpr int PELLET_MASS = 1;
constexpr int FOOD_MASS = 10;
constexpr int VIRUS_INITIAL_MASS = 100;
constexpr float FOOD_SPEED = 100.0f;
constexpr int REGEN_PERIOD = 120;
constexpr int FEED_COOLDOWN = 10;
constexpr int SPLIT_COOLDOWN = 30;
constexpr float TARGET_ACTION_SCALE = 10.0f;
constexpr int EMPTY_TICK = -(1 << 30);
constexpr int BIG_I = 1 << 30;
constexpr int DEAD_KEY = 0x7FFFFFFF;
constexpr float PI32 = 3.14159265358979323846f;
constexpr float INV_PI32 = 0.31830988618379067154f;
constexpr float TWO_PI32 = 6.28318530717958647692f;
constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t STREAM_PELLET = 1;
constexpr uint32_t STREAM_VIRUS = 2;

// Mirrors agarcl_tpu_torch/ops/params.py::EnvParams field for field.
struct EnvParams {
  int P, A, Cc, Np, Nv, Nf, K, num_pellets, num_viruses;
  int mass_decay, pellet_regen, ticks_per_step;
  int qlx, nqx, qly, nqy, kp, kv, R, kbits_p, kbits_v;
  float W, H, dt, inv_w, inv_h, p_invx, p_invy, kdec_split, kdec_food;
  float spawn_k, virus_hi_x, virus_hi_y, virus_rad;
  int n_bots;                    // bots in the roster
  int bot_type[MAX_PLAYERS];     // per pid: 0 agent, 1-4 the bot types
};

// The 41 (feature, N) state planes in _SPLIT_PLAN order
// (agarcl_tpu_torch/ops/fused_tick.py); element (f, n) is at f * N + n.
struct Planes {
  float *tx, *ty;
  int *action, *split_cd, *feed_cd, *elapsed, *last_decay;
  float *anti_team;
  int *vticks, *vptr, *food_eaten, *highest, *viruses_eaten, *cells_eaten;
  float *cx, *cy, *cvx, *cvy, *svx, *svy;
  int *cmass;
  uint8_t *calive;
  int *cid, *crecomb, *next_id, *pkey;
  float *vx, *vy, *vvx, *vvy;
  int *vmass, *vhits;
  uint8_t *valive;
  float *fx, *fy, *fvx, *fvy;
  uint8_t *falive;
  int *fnext, *ticks, *seed;
};

inline Planes planes_from(void* const* p) {
  Planes s;
  int i = 0;
  s.tx = (float*)p[i++]; s.ty = (float*)p[i++];
  s.action = (int*)p[i++]; s.split_cd = (int*)p[i++];
  s.feed_cd = (int*)p[i++]; s.elapsed = (int*)p[i++];
  s.last_decay = (int*)p[i++]; s.anti_team = (float*)p[i++];
  s.vticks = (int*)p[i++]; s.vptr = (int*)p[i++];
  s.food_eaten = (int*)p[i++]; s.highest = (int*)p[i++];
  s.viruses_eaten = (int*)p[i++]; s.cells_eaten = (int*)p[i++];
  s.cx = (float*)p[i++]; s.cy = (float*)p[i++];
  s.cvx = (float*)p[i++]; s.cvy = (float*)p[i++];
  s.svx = (float*)p[i++]; s.svy = (float*)p[i++];
  s.cmass = (int*)p[i++]; s.calive = (uint8_t*)p[i++];
  s.cid = (int*)p[i++]; s.crecomb = (int*)p[i++];
  s.next_id = (int*)p[i++]; s.pkey = (int*)p[i++];
  s.vx = (float*)p[i++]; s.vy = (float*)p[i++];
  s.vvx = (float*)p[i++]; s.vvy = (float*)p[i++];
  s.vmass = (int*)p[i++]; s.vhits = (int*)p[i++];
  s.valive = (uint8_t*)p[i++];
  s.fx = (float*)p[i++]; s.fy = (float*)p[i++];
  s.fvx = (float*)p[i++]; s.fvy = (float*)p[i++];
  s.falive = (uint8_t*)p[i++];
  s.fnext = (int*)p[i++]; s.ticks = (int*)p[i++]; s.seed = (int*)p[i++];
  return s;
}

// ------------------------------------------------------------ counter hash
// lowbias32 over the 5 counters (SPEC D2), bit-identical to prng.py
HD uint32_t mix(uint32_t h) {
  h ^= h >> 16; h *= 0x7FEB352Du;
  h ^= h >> 15; h *= 0x846CA68Bu;
  h ^= h >> 16; return h;
}
HD uint32_t hash_u32(uint32_t seed, uint32_t stream, uint32_t tick,
                     uint32_t slot, uint32_t axis) {
  uint32_t h = seed * GOLDEN;
  h = mix(h ^ (stream * GOLDEN));
  h = mix(h ^ (tick * GOLDEN));
  h = mix(h ^ (slot * GOLDEN));
  h = mix(h ^ (axis * GOLDEN));
  return h;
}
HD float uniformf(uint32_t seed, uint32_t stream, uint32_t tick,
                  uint32_t slot, uint32_t axis) {
  return float(hash_u32(seed, stream, tick, slot, axis) >> 8)
         * (1.0f / 16777216.0f);
}
// prng.uniform_q: (u24 * nq) >> 24 in two exact 12-bit halves
HD int uniform_q(int nq, uint32_t seed, uint32_t stream, uint32_t tick,
                 uint32_t slot, uint32_t axis) {
  int u24 = int(hash_u32(seed, stream, tick, slot, axis) >> 8);
  int hi = u24 >> 12, lo = u24 & 0xFFF;
  return (hi * nq + ((lo * nq) >> 12)) >> 12;
}

// ------------------------------------------------------------ game math
HD float radius(float mass) { return sqrtf(mass * INV_PI32); }
HD float powd(float x, float e) { return float(pow(double(x), double(e))); }
HD float max_speed(float mass) {
  return CELL_MAX_SPEED * powd(fmaxf(mass, 1.0f), -0.439f);
}
HD float split_speed(float mass) {
  return fminf(fmaxf(3.0f * powd(max_speed(mass), 1.2f), 20.0f), 130.0f);
}
// x*x + y*y in XLA-CPU's contracted form fma(x, x, y*y)
HD float norm2(float x, float y) { return FMAF(x, x, y * y); }
HD float clampb(float v, float r, float hi_edge) {
  return fmaxf(0.0f, fmaxf(fminf(v, hi_edge - r), r));
}
HD int float_bits(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_int(f);
#else
  int i;
  std::memcpy(&i, &f, sizeof(i));
  return i;
#endif
}
// glibc's f32 atanf (fdlibm s_atanf.c): f32 operations, none fused
HD float atan32(float x) {
  const float hi[4] = {4.6364760399e-01f, 7.8539812565e-01f,
                       9.8279368877e-01f, 1.5707962513e+00f};
  const float lo[4] = {5.0121582440e-09f, 3.7748947079e-08f,
                       3.4473217170e-08f, 7.5497894159e-08f};
  const int ix = float_bits(x) & 0x7fffffff;
  if (ix > 0x7f800000) return x + x;
  if (ix >= 0x4c000000) return x > 0.0f ? hi[3] + lo[3] : -hi[3] - lo[3];
  int id = -1;
  float r = x;
  if (ix < 0x3ee00000) {
    if (ix < 0x31000000) return x;
  } else {
    const float a = fabsf(x);
    if (ix < 0x3f980000) {
      if (ix < 0x3f300000) { id = 0; r = (2.0f * a - 1.0f) / (2.0f + a); }
      else { id = 1; r = (a - 1.0f) / (a + 1.0f); }
    } else {
      if (ix < 0x401c0000) { id = 2; r = (a - 1.5f) / (1.0f + 1.5f * a); }
      else { id = 3; r = -1.0f / a; }
    }
  }
  const float z = r * r, w = z * z;
  const float s1 = z * (3.3333334327e-01f + w * (1.4285714924e-01f
      + w * (9.0908870101e-02f + w * (6.6610731184e-02f
      + w * (4.9768779427e-02f + w * 1.6285819933e-02f)))));
  const float s2 = w * (-2.0000000298e-01f + w * (-1.1111110449e-01f
      + w * (-7.6918758452e-02f + w * (-5.8335702866e-02f
      + w * -3.6531571299e-02f))));
  if (id < 0) return r - r * (s1 + s2);
  const float zz = hi[id] - ((r * (s1 + s2) - lo[id]) - r);
  return x < 0.0f ? -zz : zz;
}
// glibc's f32 sinf / cosf (sincosf.h): double argument reduction and
// polynomial, one rounding; |y| >= 120 (never formed by the game) in double
HD float sincos32(float y, bool want_cos) {
  const int top = (float_bits(y) >> 20) & 0x7ff;
  const double x = double(y);
  if (top >= 0x42f) return float(want_cos ? cos(x) : sin(x));
  if (top < 0x398) return want_cos ? 1.0f : y;
  int n = 0;
  double xr = x, xs = x;
  if (top >= 0x3f4) {
    const double r = x * 0x1.45F306DC9C883p+23;
    n = (int(r) + 0x800000) >> 24;
    xr = x - double(n) * 0x1.921FB54442D18p0;
    const int q = n & 3;
    xs = (q == 1 || q == 2) ? -xr : xr;
  }
  const double x2 = xr * xr;
  if ((((want_cos ? n ^ 1 : n)) & 1) == 0) {
    const double x3 = xs * x2;
    const double s1 = 0x1.1107605230bc4p-7 + x2 * -0x1.994eb3774cf24p-13;
    const double x7 = x3 * x2;
    const double s = xs + x3 * -0x1.555545995a603p-3;
    return float(s + x7 * s1);
  }
  const double g = (n & 2) ? -1.0 : 1.0;
  const double x4 = x2 * x2;
  const double c2 = g * -0x1.6c087e89a359dp-10 + x2 * (g * 0x1.99343027bf8c3p-16);
  const double c1 = g + x2 * (g * -0x1.ffffffd0c621cp-2);
  const double x6 = x4 * x2;
  const double c = c1 + x4 * (g * 0x1.55553e1068f19p-5);
  return float(c + x6 * c2);
}
// Velocity::direction(): atan(dx/dy) with +-pi corrections, (0,0) -> 0
HD float direction(float dx, float dy) {
  if (dx == 0.0f && dy == 0.0f) return 0.0f;
  float ratio;
  if (dy == 0.0f) ratio = dx > 0.0f ? INFINITY : -INFINITY;
  else ratio = dx / dy;
  float ang = atan32(ratio);
  if (dx < 0.0f) ang = dy > 0.0f ? ang + PI32 : ang - PI32;
  return ang;
}
HD int floor_mod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
// pellet key -> decoded position (state.py::decode_pellet_xy)
HD float pellet_x(const EnvParams& p, int key) {
  return (float((key >> 15) & 32767) + 0.5f) * p.p_invx;
}
HD float pellet_y(const EnvParams& p, int key) {
  return (float(key & 32767) + 0.5f) * p.p_invy;
}

// ------------------------------------------------------------ frames
// Shared-memory atomics of the frame kernels (K3, K4): on the host build,
// which runs a block's threads in turn, plain updates. Integer sums and
// ORs, so the result is the same in any order.
HD int shared_add(int* a, int v) {
#ifdef __CUDA_ARCH__
  return atomicAdd(a, v);
#else
  const int old = *a;
  *a = old + v;
  return old;
#endif
}
HD unsigned long long shared_add(unsigned long long* a,
                                 unsigned long long v) {
#ifdef __CUDA_ARCH__
  return atomicAdd(a, v);
#else
  const unsigned long long old = *a;
  *a = old + v;
  return old;
#endif
}
HD void shared_or(int* a, int v) {
#ifdef __CUDA_ARCH__
  atomicOr(a, v);
#else
  *a |= v;
#endif
}
HD void shared_or(uint32_t* a, uint32_t v) {
#ifdef __CUDA_ARCH__
  atomicOr(a, v);
#else
  *a |= v;
#endif
}

// 16 bytes to a frame in global memory, streaming (not read again). Never
// on shared memory: st.global.cs there faults on the card.
HD void store16(uint8_t* dst, uint32_t a, uint32_t b, uint32_t c,
                uint32_t d) {
#ifdef __CUDA_ARCH__
  __stcs(reinterpret_cast<uint4*>(dst), make_uint4(a, b, c, d));
#else
  const uint32_t v[4] = {a, b, c, d};
  std::memcpy(dst, v, 16);
#endif
}

// 16 zero bytes to shared memory (16-byte aligned)
HD void zero16(void* dst) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
#else
  std::memset(dst, 0, 16);
#endif
}

// The camera of a screen or grid frame: the centroid (cx, cy) and total
// mass pm of player a's Cc cells, from their positions x, y and masses m
// (0 for a dead cell), staged in slot order. One agent takes the
// slot-order sum of rounded products (the tick's section emission), more
// agents XLA's chain of fmas (player_centroid, which the JAX table build
// for A > 1 uses); state.py::centroid_of and xla_centroid_of.
HD void camera_fold(const float* x, const float* y, const int* m, int Cc,
                    bool multi, float& cx, float& cy, int& pm) {
  float tot = 0.0f, sx = 0.0f, sy = 0.0f;
  pm = 0;
  for (int c = 0; c < Cc; c++) {
    const float w = float(m[c]);
    tot = tot + w;
    if (!multi) {
      sx = sx + x[c] * w;
      sy = sy + y[c] * w;
    } else if (c == 0) {
      sx = x[c] * w;
      sy = y[c] * w;
    } else {
      sx = FMAF(x[c], w, sx);
      sy = FMAF(y[c], w, sy);
    }
    pm += m[c];
  }
  const float den = fmaxf(tot, 1.0f);
  cx = sx / den;
  cy = sy / den;
}

// Stage player a's cells of env n for camera_fold: thread tid of nthr
// loads slots tid, tid + nthr, ... (the loads of all slots in flight at
// once; a dead cell's mass as 0).
HD void camera_stage(const Planes& s, int Cc, int a, int n, int N, float* x,
                     float* y, int* m, int tid, int nthr) {
  for (int c = tid; c < Cc; c += nthr) {
    const long long i = (long long)(a * Cc + c) * N + n;
    const int mass = s.cmass[i];    // loaded with the flag, not after it
    x[c] = s.cx[i];
    y[c] = s.cy[i];
    m[c] = s.calive[i] ? mass : 0;
  }
}

}  // namespace agarcl

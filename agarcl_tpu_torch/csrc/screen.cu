// Kernel K3: the screen frame of every env and agent from the state planes.
//
// Replaces the TPU kernel agarcl_tpu/ops/fused_screen.py::_make_kernel
// (launched by _rasterize_sections and _rasterize_table) in circle mode
// and in poly mode, together with the tick kernel's screen_tab section
// emission (agarcl_tpu/ops/fused_tick.py:2459-2502) and the XLA table
// build of its one-row-per-(env, agent) input (_build_table(agents=A)),
// which have no separate pass here: each block builds its agent's camera
// from the planes itself. Wrapper and plain version:
// agarcl_tpu_torch/ops/fused_screen.py (screen_sections + rasterize_plain).
//
// What bounds it on Hopper: the frame store, S*S*C bytes per frame (64 KB
// at S=128 with 4 channels, 537 MB at 8192 envs of one agent), against
// about 30 MB of plane reads. The drawing stays in shared memory, so the
// design keeps the instructions per pixel few and the store wide.
//
// Design: one block of 256 threads per (env, agent), block b = n*A + a,
// from four instantiations (circles or fans, one agent or more).
//  - Draw order as a maximum. The class ids grow with draw order (grid 1 <
//    pellet 2 < food 3 < main 4 < other 5 < virus 6; player a's cells are
//    "main", every other player's "other") and every write of a class
//    stores the same id, so a pixel's class is the largest id among the
//    classes that cover it. Coverage is one bit plane per class 2-6 in
//    shared memory (32 pixels a word, S rows of ceil(S/32) words), ORed
//    with shared atomics in any order: no barrier between classes. The
//    grid class comes from the row and column flags in the final pass.
//  - A row meets an entity in one interval of pixels. The pixel centres
//    of a row grow with the pixel index, and so do their rounded offsets
//    dx from the entity; a circle's rounded dx*dx falls then rises, a
//    fan's tests are one bound on each side. So the pixels of a row that
//    pass the exact per-pixel predicate form an interval, found by binary
//    searches over the row's window with that same predicate: the bits
//    are those the per-pixel test would set, for a handful of tests.
//  - Balanced work. Threads cull the entities (pellets, foods, cells,
//    viruses; up to 1024 a round) into a compact shared list; one 64-bit
//    shared atomic gives an entity both its list slot and the start of
//    its range of (entity, row) items, so the starts ascend with the
//    slots and an item finds its entity by binary search. The block's
//    threads then take the items in turn: a large cell's rows spread over
//    many warps, a pellet's over a few threads.
//  - The camera: warp 0 loads the 16 cells' fields at once and lane 0
//    folds them in slot order (camera_fold), while the other warps clear
//    the bit planes.
//  - The store: each thread makes the class of 4 pixels from the planes
//    and the flags, looks the colours up in a shared palette, and writes
//    16 bytes with one streaming store (st.global.cs); for three-channel
//    frames a thread packs 4 such quads (48 bytes) into 3 stores.
//    A frame whose size is not a multiple of 16 bytes (S not a multiple
//    of 4) or an unaligned output takes byte stores.
//
// Poly mode draws the reference's regular fans (5-gon pellets, 7-gon
// foods, 50-gon cells; viruses stay circles) by the half-plane rule: a
// pixel row at offset dy from the centre meets the fan in one interval
// [xlo, xhi] (fan_bounds, over the FanLines tables the wrapper builds);
// pellets and foods test dx = wx - x against it, cells test the pixel
// centre wx against the absolute bounds xlo + x and xhi + x.
//
// f32 arithmetic follows the plain version (see its docstring): pixel
// centres fma(idx, half, c) with idx = (i+0.5)*2*f32(1/S) - 1 rounded in two
// steps for cells and grid lines in circle mode and in one fma for pellets,
// foods, viruses and every fan; circles test dx*dx <= fma(-dy, dy, r2);
// the fan bounds (c2*r - b*dy) * inv_a with each operation rounded; built
// with --fmad=false, so nothing else is contracted.
//
// The host build (no __CUDACC__) runs screen_env with one thread (tid 0
// of 1): every shared atomic is then a plain update, and every reduction
// of the design (OR, integer sums) is exact in any order.
#include "common.cuh"

namespace agarcl {

constexpr int FAN_MAX_LINES = 64;
constexpr int SCREEN_THREADS = 256;
constexpr int SCREEN_LIST = 1024;    // entities culled per round
constexpr int SCREEN_PLANES = 5;     // bit planes of classes 2-6

// Mirrors agarcl_tpu_torch/ops/fused_screen.py::FanLines: the half-plane
// lines of one n-gon fan, rights [0, nr), lefts [nr, nr + nl), flats
// [nr + nl, nr + nl + nf) (b only); c2 = cos(pi/n).
struct FanLines {
  int nr, nl, nf;
  float c2;
  float inv_a[FAN_MAX_LINES], b[FAN_MAX_LINES];
};

// Mirrors agarcl_tpu_torch/ops/fused_screen.py::ScreenParams.
struct ScreenParams {
  int S, C, A, poly;
  uint32_t palette[8];
  float rc, tan_half, lo, hi_x, hi_y, pr2, fr2;
  float xs[8], ys[8];
  FanLines fan[3];    // pellet, food, cell
};

#ifdef __CUDA_ARCH__
#define BARRIER() __syncthreads()
#define SYNCWARP() __syncwarp()
#else
#define BARRIER()
#define SYNCWARP()
#endif

#define AT(plane, f) (plane)[(long long)(f) * N + n]

// The shared scratch of one frame (screen_carve lays it out).
struct ScreenSmem {
  float* cam;                  // cx, cy, half
  float *cellx, *celly;        // player a's cells, staged for the camera
  int* cellm;
  unsigned long long* cnt;     // two round counters: slot << 32 | items
  uint32_t* pal;               // palette, 8 words
  float *wxc, *wyc, *wxs, *wys;  // pixel-centre tables (S each)
  uint8_t* flags;              // columns then rows: bit 0 on a line, 1 in
  float *ex, *ey, *er2;        // the round's list (SCREEN_LIST each)
  int *eii, *ejc, *estart;     // i0 | i1 << 16, j0 | cid << 16, first item
  uint32_t* bm;                // [class 2-6][row][word]
};

// Lay the scratch out from base (16-byte aligned pieces); returns its
// bytes. base may be null to size it.
HD long long screen_carve(int S, uint8_t* base, ScreenSmem& m) {
  long long o = 0;
  auto take = [&](long long bytes) {
    uint8_t* p = base ? base + o : nullptr;
    o += (bytes + 15) & ~15LL;
    return p;
  };
  const int W = (S + 31) / 32;
  m.cam = reinterpret_cast<float*>(take(16));
  m.cellx = reinterpret_cast<float*>(take(4 * MAX_CELLS));
  m.celly = reinterpret_cast<float*>(take(4 * MAX_CELLS));
  m.cellm = reinterpret_cast<int*>(take(4 * MAX_CELLS));
  m.cnt = reinterpret_cast<unsigned long long*>(take(16));
  m.pal = reinterpret_cast<uint32_t*>(take(32));
  m.wxc = reinterpret_cast<float*>(take(4LL * S));
  m.wyc = reinterpret_cast<float*>(take(4LL * S));
  m.wxs = reinterpret_cast<float*>(take(4LL * S));
  m.wys = reinterpret_cast<float*>(take(4LL * S));
  m.flags = take(2LL * S);
  m.ex = reinterpret_cast<float*>(take(4 * SCREEN_LIST));
  m.ey = reinterpret_cast<float*>(take(4 * SCREEN_LIST));
  m.er2 = reinterpret_cast<float*>(take(4 * SCREEN_LIST));
  m.eii = reinterpret_cast<int*>(take(4 * SCREEN_LIST));
  m.ejc = reinterpret_cast<int*>(take(4 * SCREEN_LIST));
  m.estart = reinterpret_cast<int*>(take(4 * SCREEN_LIST));
  m.bm = reinterpret_cast<uint32_t*>(take(4LL * SCREEN_PLANES * S * W));
  return o;
}

HD long long screen_scratch(int S) {
  ScreenSmem m;
  return screen_carve(S, nullptr, m);
}

// Index range [lo, hi] of the pixel centres (first centre w0, inverse
// pitch inv) that can be within reach of [c - r, c + r], three pixels of
// slack on each side; false if it misses the screen. Only a search range:
// every pixel in it is still tested exactly, and the pixels a shape
// covers lie within a pixel of [c - r, c + r].
HD bool window(float c, float r, float w0, float inv, int S, int& lo,
               int& hi) {
  const float a = (c - r - w0) * inv, b = (c + r - w0) * inv;
  if (!(a < float(S) + 3.0f) || !(b > -4.0f)) return false;
  lo = int(floorf(a)) - 3;
  hi = int(ceilf(b)) + 3;
  lo = lo < 0 ? 0 : lo;
  hi = hi > S - 1 ? S - 1 : hi;
  return lo <= hi;
}

// Row interval [xlo, xhi] of a fan of radius r at row offset dy, relative
// to its centre (xlo > xhi: the row misses it).
HD void fan_bounds(const FanLines& L, float dy, float r, float& xlo,
                   float& xhi) {
  const float c2r = L.c2 * r;
  xhi = 3.0e38f;
  xlo = -3.0e38f;
  for (int k = 0; k < L.nr; k++)
    xhi = fminf(xhi, (c2r - L.b[k] * dy) * L.inv_a[k]);
  for (int k = L.nr; k < L.nr + L.nl; k++)
    xlo = fmaxf(xlo, (c2r - L.b[k] * dy) * L.inv_a[k]);
  for (int k = L.nr + L.nl; k < L.nr + L.nl + L.nf; k++)
    if (L.b[k] * dy > c2r) xlo = 3.0e38f;
}

// The first i in [lo, hi] where pred holds, hi + 1 if none; pred must be
// false then true over the range.
template <class Pred>
HD int first_true(int lo, int hi, Pred pred) {
  int a = lo, b = hi + 1;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (pred(mid)) b = mid;
    else a = mid + 1;
  }
  return a;
}

// Set bits [a, b] of a bit row.
HD void or_span(uint32_t* row, int a, int b) {
  if (a > b) return;
  for (int w = a >> 5; w <= b >> 5; w++) {
    const int lo = w == (a >> 5) ? (a & 31) : 0;
    const int hi = w == (b >> 5) ? (b & 31) : 31;
    shared_or(&row[w], (0xFFFFFFFFu >> (31 - hi)) & (0xFFFFFFFFu << lo));
  }
}

// Pixels [a, b] of row j that the list entity e covers: the exact
// per-pixel predicate of its shape, as an interval (see the design).
template <bool POLY>
HD void entity_row(const ScreenParams& q, const ScreenSmem& m, int e, int j,
                   int& a, int& b) {
  const float x = m.ex[e], y = m.ey[e], r2 = m.er2[e];
  const int i0 = m.eii[e] & 0xFFFF, i1 = m.eii[e] >> 16;
  const int cid = m.ejc[e] >> 16;
  const bool cells_c = !POLY && (cid == 4 || cid == 5);
  const float* wx = cells_c ? m.wxc : m.wxs;
  const float* wy = cells_c ? m.wyc : m.wys;
  if (POLY && cid != 6) {
    float xlo, xhi;
    fan_bounds(q.fan[cid < 4 ? cid - 2 : 2], wy[j] - y, sqrtf(r2), xlo,
               xhi);
    if (cid < 4) {               // pellets and foods: dx against the bounds
      a = first_true(i0, i1, [&](int i) { return wx[i] - x >= xlo; });
      b = first_true(i0, i1, [&](int i) { return !(wx[i] - x <= xhi); })
          - 1;
    } else {                     // cells: the centre against xlo + x, ...
      const float rlo = xlo + x, rhi = xhi + x;
      a = first_true(i0, i1, [&](int i) { return wx[i] >= rlo; });
      b = first_true(i0, i1, [&](int i) { return !(wx[i] <= rhi); }) - 1;
    }
    return;
  }
  const float dy = wy[j] - y;
  const float lim = FMAF(-dy, dy, r2);
  // dx < 0 left of ic, where dx*dx <= lim holds on a suffix; from ic on
  // dx >= 0 and it holds on a prefix
  const int ic = first_true(i0, i1, [&](int i) { return wx[i] - x >= 0.0f; });
  a = first_true(i0, ic - 1, [&](int i) {
    const float dx = wx[i] - x;
    return dx * dx <= lim;
  });
  b = first_true(ic, i1, [&](int i) {
    const float dx = wx[i] - x;
    return !(dx * dx <= lim);
  }) - 1;
}

// The class of pixel (i, j): the largest id among the bit planes that
// cover it, else the grid line, else 0.
HD int pixel_class(const ScreenSmem& m, int S, int W, int i, int j) {
  const uint32_t* w = m.bm + (long long)j * W + (i >> 5);
  const int bit = i & 31;
  for (int c = 6; c >= 2; c--)
    if ((w[(long long)(c - 2) * S * W] >> bit) & 1u) return c;
  const int col = m.flags[i], row = m.flags[S + j];
  return ((col | row) & 1) && (col & row & 2) ? 1 : 0;
}

// The classes of pixels (i .. i+3, j), one row and one plane word (i is
// a multiple of 4): pixel_class for four pixels at once, bit-parallel.
// Bit u of each nibble is pixel i + u; the three class bits follow from
// the planes' nibbles (the largest id wins) and the grid-line nibble.
HD void quad_classes(const ScreenSmem& m, int S, int W, int i, int j,
                     int* cls) {
  const int pw = S * W, sh = i & 31;
  const uint32_t* w = m.bm + j * W + (i >> 5);
  const uint32_t P = (w[0] >> sh) & 15u, F = (w[pw] >> sh) & 15u;
  const uint32_t M = (w[2 * pw] >> sh) & 15u, O = (w[3 * pw] >> sh) & 15u;
  const uint32_t V = (w[4 * pw] >> sh) & 15u;
  uint32_t cf;                        // the four columns' flags, a byte each
#ifdef __CUDA_ARCH__
  cf = *reinterpret_cast<const uint32_t*>(m.flags + i);
#else
  std::memcpy(&cf, m.flags + i, 4);
#endif
  const uint32_t rf = m.flags[S + j] * 0x01010101u;
  // per byte: on a line (bit 0 of either) and inside (bit 1 of both)
  const uint32_t g = (cf | rf) & ((cf & rf) >> 1) & 0x01010101u;
  const uint32_t L = (g & 1u) | ((g >> 7) & 2u) | ((g >> 14) & 4u)
                     | ((g >> 21) & 8u);
  const uint32_t low = ~(V | O | M), pf = F | P;
  const uint32_t b2 = V | O | M;                   // classes 4-6
  const uint32_t b1 = V | (low & pf);              // 6, 3, 2
  const uint32_t b0 = (O & ~V) | (F & low) | (L & low & ~pf);  // 5, 3, 1
#pragma unroll
  for (int u = 0; u < 4; u++)
    cls[u] = int((((b2 >> u) & 1u) << 2) | (((b1 >> u) & 1u) << 1)
                 | ((b0 >> u) & 1u));
}

// The frame's store, S % 4 == 0 and out 16-byte aligned: thread tid
// takes runs tid, tid + nthr, ... of RUN quads (4 pixels of one row each):
// RUN = 1 for 4 channels (one 16-byte store), RUN = 4 for packed RGB (48
// bytes, three stores). Rows and columns advance without a division.
template <int RUN>
HD void store_quads(const ScreenSmem& m, int S, int W, uint8_t* out,
                    int tid, int nthr) {
  const int step = 4 * RUN * nthr, dj = step / S, di = step - dj * S;
  int j = 4 * RUN * tid / S, i = 4 * RUN * tid - j * S;
  for (int k = tid; k < S * S / (4 * RUN); k += nthr) {
    int cls[4 * RUN];
#pragma unroll
    for (int u = 0, iu = i, ju = j; u < RUN; u++) {
      quad_classes(m, S, W, iu, ju, cls + 4 * u);
      iu += 4;
      if (iu == S) { iu = 0; ju++; }
    }
    if (RUN == 1) {
      store16(out + 16LL * k, m.pal[cls[0]], m.pal[cls[1]], m.pal[cls[2]],
              m.pal[cls[3]]);
    } else {
      uint32_t v[12];
#pragma unroll
      for (int w = 0; w < 12; w++) {
        v[w] = 0;
#pragma unroll
        for (int t = 0; t < 4; t++) {
          const int byte = 4 * w + t;
          v[w] |= ((m.pal[cls[(byte / 3) % (4 * RUN)]] >> (8 * (byte % 3)))
                   & 255u) << (8 * t);
        }
      }
#pragma unroll
      for (int c = 0; c < 3; c++)
        store16(out + 48LL * k + 16 * c, v[4 * c], v[4 * c + 1],
                v[4 * c + 2], v[4 * c + 3]);
    }
    i += di;
    j += dj;
    if (i >= S) { i -= S; j++; }
  }
}

// The frame of agent a in env n, drawn by thread tid of nthr (a host
// build runs it with tid 0 of 1); POLY draws fans (q.poly), MULTI serves
// q.A > 1 agents (one agent compiles to the single-agent code). smem:
// screen_scratch(S) bytes, 16-byte aligned; out: S*S*C bytes, 16-byte
// aligned when vec (then S is a multiple of 4).
template <bool POLY, bool MULTI>
HD void screen_env(const EnvParams& p, const ScreenParams& q,
                   const Planes& s, int n, int a, int N, uint8_t* smem,
                   uint8_t* out, bool vec, int tid, int nthr) {
  if (!MULTI) a = 0;
  const int S = q.S, W = (S + 31) / 32, Cc = p.Cc, own0 = a * Cc;
  ScreenSmem m;
  screen_carve(S, smem, m);
  // warp 0 stages player a's cells and lane 0 folds the camera, while
  // every thread clears the bit planes
  if (tid < 32) {
    camera_stage(s, Cc, a, n, N, m.cellx, m.celly, m.cellm, tid,
                 nthr < 32 ? nthr : 32);
    SYNCWARP();
    if (tid == 0) {
      int pm;
      camera_fold(m.cellx, m.celly, m.cellm, Cc, MULTI, m.cam[0], m.cam[1],
                  pm);
      const float z = fminf(fmaxf(FMAF(float(pm), 0.1f, 100.0f), 100.0f),
                            900.0f);
      m.cam[2] = z * q.tan_half;
      m.cnt[0] = m.cnt[1] = 0;
    }
  }
  for (int k = tid; k < 8; k += nthr) m.pal[k] = q.palette[k];
  const int nwords = SCREEN_PLANES * S * W;
  for (int k = tid; k < nwords / 4; k += nthr) zero16(m.bm + 4 * k);
  for (int k = nwords / 4 * 4 + tid; k < nwords; k += nthr) m.bm[k] = 0;
  BARRIER();  // camera, cleared planes
  const float cx = m.cam[0], cy = m.cam[1], half = m.cam[2];
  const float ph = half * q.rc;
  for (int i = tid; i < S; i += nthr) {
    const float t = (float(i) + 0.5f) * 2.0f;
    const float ic = t * q.rc - 1.0f;
    const float is = FMAF(t, q.rc, -1.0f);
    const float xc = FMAF(ic, half, cx), yc = FMAF(ic, half, cy);
    m.wxc[i] = xc;
    m.wyc[i] = yc;
    m.wxs[i] = FMAF(is, half, cx);
    m.wys[i] = FMAF(is, half, cy);
    bool on_v = false, on_h = false;
    for (int k = 0; k < 8; k++) {
      on_v = on_v || fabsf(xc - q.xs[k]) <= ph;
      on_h = on_h || fabsf(yc - q.ys[k]) <= ph;
    }
    const bool in_x = xc >= q.lo && xc <= q.hi_x;
    const bool in_y = yc >= q.lo && yc <= q.hi_y;
    m.flags[i] = uint8_t((on_v ? 1 : 0) | (in_x ? 2 : 0));
    m.flags[S + i] = uint8_t((on_h ? 1 : 0) | (in_y ? 2 : 0));
  }
  BARRIER();  // tables and grid flags
  const float pc = m.wxc[S > 1 ? 1 : 0] - m.wxc[0];
  const float inv = 1.0f / (pc > 0.0f ? pc : 2.0f * half * q.rc);
  // entities: pellets, foods, player a's cells, every other player's
  // cells (own0 first, as the class ids need), viruses
  const int e_food = p.Np, e_cell = p.Np + p.Nf;
  const int e_virus = e_cell + p.P * Cc, n_ent = e_virus + p.Nv;
  int r = 0;
  for (int base = 0; base < n_ent; base += SCREEN_LIST, r ^= 1) {
    const int top = n_ent - base < SCREEN_LIST ? n_ent - base : SCREEN_LIST;
    for (int k = tid; k < top; k += nthr) {
      const int e = base + k;
      float x, y, r2;
      int cid;
      if (e < e_food) {
        const int key = AT(s.pkey, e);
        if (key < 0) continue;
        x = pellet_x(p, key);
        y = pellet_y(p, key);
        r2 = q.pr2;
        cid = 2;
      } else if (e < e_cell) {       // fields loaded with the flag
        x = AT(s.fx, e - e_food);
        y = AT(s.fy, e - e_food);
        if (!AT(s.falive, e - e_food)) continue;
        r2 = q.fr2;
        cid = 3;
      } else if (e < e_virus) {
        const int kc = e - e_cell;
        const int c = kc < Cc ? own0 + kc : (kc - Cc < own0 ? kc - Cc : kc);
        const int mass = AT(s.cmass, c);
        x = AT(s.cx, c);
        y = AT(s.cy, c);
        if (!AT(s.calive, c)) continue;
        const float rad = radius(float(mass));
        r2 = rad * rad;
        cid = kc < Cc ? 4 : 5;
      } else {
        const int mass = AT(s.vmass, e - e_virus);
        x = AT(s.vx, e - e_virus);
        y = AT(s.vy, e - e_virus);
        if (!AT(s.valive, e - e_virus)) continue;
        const float rad = radius(float(mass));
        r2 = rad * rad;
        cid = 6;
      }
      if (r2 < 0.0f) continue;
      const bool cells_c = !POLY && (cid == 4 || cid == 5);
      const float rad = sqrtf(r2);
      int i0, i1, j0, j1;
      if (!window(x, rad, (cells_c ? m.wxc : m.wxs)[0], inv, S, i0, i1))
        continue;
      if (!window(y, rad, (cells_c ? m.wyc : m.wys)[0], inv, S, j0, j1))
        continue;
      const unsigned long long old = shared_add(
          &m.cnt[r], (1ull << 32) | (unsigned long long)(j1 - j0 + 1));
      const int slot = int(old >> 32);
      m.ex[slot] = x;
      m.ey[slot] = y;
      m.er2[slot] = r2;
      m.eii[slot] = i0 | (i1 << 16);
      m.ejc[slot] = j0 | (cid << 16);
      m.estart[slot] = int(old & 0xFFFFFFFFu);
    }
    BARRIER();  // entities culled
    const unsigned long long tot = m.cnt[r];
    if (tid == 0) m.cnt[r ^ 1] = 0;
    const int nl = int(tot >> 32), ni = int(tot & 0xFFFFFFFFu);
    for (int t = tid; t < ni; t += nthr) {
      int lo = 0, hi = nl - 1;       // the last slot that starts <= t
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (m.estart[mid] <= t) lo = mid;
        else hi = mid - 1;
      }
      const int j = (m.ejc[lo] & 0xFFFF) + (t - m.estart[lo]);
      int ia, ib;
      entity_row<POLY>(q, m, lo, j, ia, ib);
      or_span(m.bm + ((long long)((m.ejc[lo] >> 16) - 2) * S + j) * W, ia,
              ib);
    }
    BARRIER();  // rows drawn
  }
  if (vec && q.C == 4) {
    store_quads<1>(m, S, W, out, tid, nthr);
  } else if (vec) {
    store_quads<4>(m, S, W, out, tid, nthr);
  } else {
    for (int k = tid; k < S * S; k += nthr) {
      const uint32_t w = m.pal[pixel_class(m, S, W, k % S, k / S)];
      for (int c = 0; c < q.C; c++)
        out[(long long)q.C * k + c] = uint8_t(w >> (8 * c));
    }
  }
}

#undef AT

#ifdef __CUDACC__
// one instantiation per mode and for more than one agent, so the
// single-agent circle frame keeps its own code and registers
template <bool POLY, bool MULTI>
__global__ void __launch_bounds__(SCREEN_THREADS)
screen_kernel(const EnvParams p, const ScreenParams q, const Planes s,
              uint8_t* __restrict__ out, int N) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x;
  const long long frame = (long long)q.S * q.S * q.C;
  const bool vec = q.S % 4 == 0
                   && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  screen_env<POLY, MULTI>(p, q, s, MULTI ? b / q.A : b, MULTI ? b % q.A : 0,
                          N, smem, out + b * frame, vec, threadIdx.x,
                          blockDim.x);
}

using ScreenKernel = void (*)(EnvParams, ScreenParams, Planes, uint8_t*,
                              int);

inline ScreenKernel screen_pick(const ScreenParams& q) {
  const bool multi = q.A > 1;
  return q.poly ? (multi ? screen_kernel<true, true>
                         : screen_kernel<true, false>)
                : (multi ? screen_kernel<false, true>
                         : screen_kernel<false, false>);
}
#endif

}  // namespace agarcl

#ifdef __CUDACC__
extern "C" int agarcl_screen(const agarcl::EnvParams* prm,
                             const agarcl::ScreenParams* q,
                             void* const* planes, uint8_t* out, int N,
                             cudaStream_t stream) {
  const agarcl::Planes s = agarcl::planes_from(planes);
  const int smem = int(agarcl::screen_scratch(q->S));
  const agarcl::ScreenKernel kernel = agarcl::screen_pick(*q);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
  }
  kernel<<<N * q->A, agarcl::SCREEN_THREADS, smem, stream>>>(*prm, *q, s,
                                                             out, N);
  return int(cudaGetLastError());
}

// K3's launch shape for N envs: blocks, threads a block, dynamic shared
// bytes, resident blocks per SM (the occupancy API)
extern "C" int agarcl_screen_shape(const agarcl::ScreenParams* q, int N,
                                   int* out) {
  const int smem = int(agarcl::screen_scratch(q->S));
  const agarcl::ScreenKernel kernel = agarcl::screen_pick(*q);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {     // as the launch does: never below the default
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, agarcl::SCREEN_THREADS, smem);
  out[0] = N * q->A;
  out[1] = agarcl::SCREEN_THREADS;
  out[2] = smem;
  out[3] = blocks;
  return int(err);
}
#endif

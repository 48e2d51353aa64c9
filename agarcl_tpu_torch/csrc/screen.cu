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
// Design: one block of 256 threads per (env, agent), block b = n*A + a
// (8192 blocks at the main path's 8192 envs fill all 132 SMs), from four
// instantiations (circles or fans, one agent or more), so the one-agent
// circle frame carries no fan or agent code. Thread 0 computes the camera
// (frame_camera: the centroid of player a's cells and z = clamp(100 +
// mass/10, 100, 900)); the block writes the pixel-centre tables and the
// grid-line flags of each row and column, then draws the S x S class map in
// shared memory one class at a time in draw order (grid < pellet < food <
// main < other < virus: player a's cells are "main", every other player's
// "other"), a barrier between classes. Class ids grow with draw order and
// every write of a phase stores the same value, so plain byte stores leave
// the topmost class with no atomics. Each entity tests only the pixels of a
// window two pixels wider on every side than its bounding box, with the
// exact predicate dx*dx <= fma(-dy, dy, r2). Pellets and foods (small,
// numerous) take one thread per entity; cells and viruses (few, possibly
// large) take the whole block per entity. The TPU kernel's MXU strip
// products, padded section tables and per-env unroll have no counterpart.
//
// Poly mode draws the reference's regular fans (5-gon pellets, 7-gon
// foods, 50-gon cells; viruses stay circles) by the half-plane rule: a
// pixel row at offset dy from the centre meets the fan in one interval
// [xlo, xhi] (fan_bounds, over the FanLines tables the wrapper builds).
// A pellet's or food's thread computes the interval of each row of its
// window, then tests the row's pixels; for a cell the block first writes
// the absolute bounds of each row of its window into shared memory, then
// tests the window's pixels, a barrier between the two.
//
// f32 arithmetic follows the plain version (see its docstring): pixel
// centres fma(idx, half, c) with idx = (i+0.5)*2*f32(1/S) - 1 rounded in two
// steps for cells and grid lines in circle mode and in one fma for pellets,
// foods, viruses and every fan; the fan bounds (c2*r - b*dy) * inv_a with
// each operation rounded; built with --fmad=false, so nothing else is
// contracted.
//
// What bounds it on Hopper: the frame store, S*S*C bytes per frame (64 KB
// at S=128 with 4 channels, 537 MB at 8192 envs of one agent), against
// about 30 MB of plane reads; the drawing itself stays in shared memory.
#include "common.cuh"

namespace agarcl {

constexpr int FAN_MAX_LINES = 64;

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
#else
#define BARRIER()
#endif

#define AT(plane, f) (plane)[(long long)(f) * N + n]

// Index range [lo, hi] of the pixel centres (first centre w0, pitch)
// within reach of [c - r, c + r], two pixels of slack on each side;
// false if it misses the screen.
HD bool window(float c, float r, float w0, float pitch, int S, int& lo,
               int& hi) {
  const float a = (c - r - w0) / pitch, b = (c + r - w0) / pitch;
  if (!(a < float(S) + 2.0f) || !(b > -3.0f)) return false;
  lo = int(floorf(a)) - 2;
  hi = int(ceilf(b)) + 2;
  lo = lo < 0 ? 0 : lo;
  hi = hi > S - 1 ? S - 1 : hi;
  return lo <= hi;
}

HD void cover_px(float x, float y, float r2, const float* wx,
                 const float* wy, int S, int i, int j, uint8_t cid,
                 uint8_t* cls) {
  const float dx = wx[i] - x;
  const float dy = wy[j] - y;
  if (dx * dx <= FMAF(-dy, dy, r2)) cls[j * S + i] = cid;
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

// one thread draws one (small) fan
HD void draw_own_fan(const FanLines& L, float x, float y, float r2,
                     const float* wx, const float* wy, float pitch, int S,
                     uint8_t cid, uint8_t* cls) {
  if (r2 < 0.0f) return;
  const float r = sqrtf(r2);
  int i0, i1, j0, j1;
  if (!window(x, r, wx[0], pitch, S, i0, i1)) return;
  if (!window(y, r, wy[0], pitch, S, j0, j1)) return;
  for (int j = j0; j <= j1; j++) {
    float xlo, xhi;
    fan_bounds(L, wy[j] - y, r, xlo, xhi);
    for (int i = i0; i <= i1; i++) {
      const float dx = wx[i] - x;
      if (dx >= xlo && dx <= xhi) cls[j * S + i] = cid;
    }
  }
}

// the block draws one (possibly large) fan: row bounds into rlo / rhi
// (shared, S each), a barrier, then the window's pixels. Every thread
// calls it with the same arguments.
HD void draw_shared_fan(const FanLines& L, float x, float y, float r2,
                        const float* wx, const float* wy, float pitch,
                        int S, uint8_t cid, uint8_t* cls, float* rlo,
                        float* rhi, int tid, int nthr) {
  const float r = sqrtf(r2);
  int i0, i1, j0, j1;
  if (!window(x, r, wx[0], pitch, S, i0, i1)) return;
  if (!window(y, r, wy[0], pitch, S, j0, j1)) return;
  BARRIER();                       // the previous fan's pixels are done
  for (int j = j0 + tid; j <= j1; j += nthr) {
    float xlo, xhi;
    fan_bounds(L, wy[j] - y, r, xlo, xhi);
    rlo[j] = xlo + x;
    rhi[j] = xhi + x;
  }
  BARRIER();
  const int w = i1 - i0 + 1, cnt = w * (j1 - j0 + 1);
  for (int k = tid; k < cnt; k += nthr) {
    const int i = i0 + k % w, j = j0 + k / w;
    if (wx[i] >= rlo[j] && wx[i] <= rhi[j]) cls[j * S + i] = cid;
  }
}

// one thread draws one (small) circle
HD void draw_own(float x, float y, float r2, const float* wx,
                 const float* wy, float pitch, int S, uint8_t cid,
                 uint8_t* cls) {
  if (r2 < 0.0f) return;
  const float r = sqrtf(r2);
  int i0, i1, j0, j1;
  if (!window(x, r, wx[0], pitch, S, i0, i1)) return;
  if (!window(y, r, wy[0], pitch, S, j0, j1)) return;
  for (int j = j0; j <= j1; j++)
    for (int i = i0; i <= i1; i++) cover_px(x, y, r2, wx, wy, S, i, j, cid,
                                            cls);
}

// the block draws one (possibly large) circle, threads over its pixels
HD void draw_shared(float x, float y, float r2, const float* wx,
                    const float* wy, float pitch, int S, uint8_t cid,
                    uint8_t* cls, int tid, int nthr) {
  if (r2 < 0.0f) return;
  const float r = sqrtf(r2);
  int i0, i1, j0, j1;
  if (!window(x, r, wx[0], pitch, S, i0, i1)) return;
  if (!window(y, r, wy[0], pitch, S, j0, j1)) return;
  const int w = i1 - i0 + 1, cnt = w * (j1 - j0 + 1);
  for (int k = tid; k < cnt; k += nthr)
    cover_px(x, y, r2, wx, wy, S, i0 + k % w, j0 + k / w, cid, cls);
}

// The frame of agent a in env n, drawn by thread tid of nthr (a host
// build runs it with tid 0 of 1); POLY draws fans (q.poly), MULTI serves
// q.A > 1 agents (one agent compiles to the single-agent code). Scratch:
// cam[4], tab[6*S] pixel-centre tables and fan row bounds, flags[2*S] grid
// flags, cls[S*S] class map; out: S*S*C bytes.
template <bool POLY, bool MULTI>
HD void screen_env(const EnvParams& p, const ScreenParams& q,
                   const Planes& s, int n, int a, int N, float* cam,
                   float* tab, uint8_t* flags, uint8_t* cls, uint8_t* out,
                   int tid, int nthr) {
  if (!MULTI) a = 0;
  const int S = q.S, Cc = p.Cc, own0 = a * Cc;
  if (tid == 0) {
    int pm;
    frame_camera(s, Cc, a, MULTI ? q.A : 1, n, N, cam[0], cam[1], pm);
    const float z = fminf(fmaxf(FMAF(float(pm), 0.1f, 100.0f), 100.0f),
                          900.0f);
    cam[2] = z * q.tan_half;
  }
  BARRIER();
  const float cx = cam[0], cy = cam[1], half = cam[2];
  float* wxc = tab;           // cells, grid lines
  float* wyc = tab + S;
  float* wxs = tab + 2 * S;   // pellet, food and virus strips
  float* wys = tab + 3 * S;
  float* rlo = tab + 4 * S;   // fan row bounds
  float* rhi = tab + 5 * S;
  const float ph = half * q.rc;
  for (int i = tid; i < S; i += nthr) {
    const float t = (float(i) + 0.5f) * 2.0f;
    const float ic = t * q.rc - 1.0f;
    const float is = FMAF(t, q.rc, -1.0f);
    const float xc = FMAF(ic, half, cx), yc = FMAF(ic, half, cy);
    wxc[i] = xc;
    wyc[i] = yc;
    wxs[i] = FMAF(is, half, cx);
    wys[i] = FMAF(is, half, cy);
    bool on_v = false, on_h = false;
    for (int k = 0; k < 8; k++) {
      on_v = on_v || fabsf(xc - q.xs[k]) <= ph;
      on_h = on_h || fabsf(yc - q.ys[k]) <= ph;
    }
    const bool in_x = xc >= q.lo && xc <= q.hi_x;
    const bool in_y = yc >= q.lo && yc <= q.hi_y;
    flags[i] = uint8_t((on_v ? 1 : 0) | (in_x ? 2 : 0));
    flags[S + i] = uint8_t((on_h ? 1 : 0) | (in_y ? 2 : 0));
  }
  BARRIER();
  for (int k = tid; k < S * S; k += nthr) {
    const int col = flags[k % S], row = flags[S + k / S];
    cls[k] = ((col | row) & 1) && (col & row & 2) ? 1 : 0;
  }
  BARRIER();
  const float pc = wxc[S > 1 ? 1 : 0] - wxc[0];
  const float pitch = pc > 0.0f ? pc : 2.0f * half * q.rc;
  for (int e = tid; e < p.Np; e += nthr) {
    const int key = AT(s.pkey, e);
    if (key < 0) continue;
    if (POLY)
      draw_own_fan(q.fan[0], pellet_x(p, key), pellet_y(p, key), q.pr2, wxs,
                   wys, pitch, S, 2, cls);
    else
      draw_own(pellet_x(p, key), pellet_y(p, key), q.pr2, wxs, wys, pitch,
               S, 2, cls);
  }
  BARRIER();
  for (int e = tid; e < p.Nf; e += nthr) {
    if (!AT(s.falive, e)) continue;
    if (POLY)
      draw_own_fan(q.fan[1], AT(s.fx, e), AT(s.fy, e), q.fr2, wxs, wys,
                   pitch, S, 3, cls);
    else
      draw_own(AT(s.fx, e), AT(s.fy, e), q.fr2, wxs, wys, pitch, S, 3, cls);
  }
  BARRIER();
  // player a's cells, then every other player's (k walks own0 first)
  const int n_cells = p.P * Cc;
  for (int k = 0; k < n_cells; k++) {
    if (k == Cc) BARRIER();                 // main player, then the others
    const int c = k < Cc ? own0 + k : (k - Cc < own0 ? k - Cc : k);
    if (!AT(s.calive, c)) continue;
    const float r = radius(float(AT(s.cmass, c)));
    const uint8_t cid = k < Cc ? 4 : 5;
    if (POLY)
      draw_shared_fan(q.fan[2], AT(s.cx, c), AT(s.cy, c), r * r, wxs, wys,
                      pitch, S, cid, cls, rlo, rhi, tid, nthr);
    else
      draw_shared(AT(s.cx, c), AT(s.cy, c), r * r, wxc, wyc, pitch, S, cid,
                  cls, tid, nthr);
  }
  BARRIER();
  for (int v = 0; v < p.Nv; v++) {
    if (!AT(s.valive, v)) continue;
    const float r = radius(float(AT(s.vmass, v)));
    draw_shared(AT(s.vx, v), AT(s.vy, v), r * r, wxs, wys, pitch, S, 6, cls,
                tid, nthr);
  }
  BARRIER();
  if (q.C == 4) {
    uint32_t* o = reinterpret_cast<uint32_t*>(out);
    for (int k = tid; k < S * S; k += nthr) o[k] = q.palette[cls[k]];
  } else {
    for (int k = tid; k < S * S; k += nthr) {
      const uint32_t w = q.palette[cls[k]];
      out[3 * k] = uint8_t(w);
      out[3 * k + 1] = uint8_t(w >> 8);
      out[3 * k + 2] = uint8_t(w >> 16);
    }
  }
}

#undef AT

// scratch bytes of one frame: cam, tables and fan bounds, flags, class map
HD long long screen_scratch(int S) {
  return 16 + 24LL * S + 2LL * S + (long long)S * S;
}

#ifdef __CUDACC__
constexpr int SCREEN_THREADS = 256;

// one instantiation per mode and for more than one agent, so the
// single-agent circle frame keeps its own code and registers
template <bool POLY, bool MULTI>
__global__ void __launch_bounds__(SCREEN_THREADS)
screen_kernel(const EnvParams p, const ScreenParams q, const Planes s,
              uint8_t* __restrict__ out, int N) {
  extern __shared__ float smem[];
  const int S = q.S;
  float* cam = smem;
  float* tab = smem + 4;
  uint8_t* flags = reinterpret_cast<uint8_t*>(tab + 6 * S);
  uint8_t* cls = flags + 2 * S;
  const int b = blockIdx.x;
  screen_env<POLY, MULTI>(p, q, s, MULTI ? b / q.A : b, MULTI ? b % q.A : 0,
                          N, cam, tab, flags, cls,
                          out + (long long)b * S * S * q.C, threadIdx.x,
                          blockDim.x);
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
  const bool multi = q->A > 1;
  void (*kernel)(agarcl::EnvParams, agarcl::ScreenParams, agarcl::Planes,
                 uint8_t*, int) =
      q->poly ? (multi ? agarcl::screen_kernel<true, true>
                       : agarcl::screen_kernel<true, false>)
              : (multi ? agarcl::screen_kernel<false, true>
                       : agarcl::screen_kernel<false, false>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
  }
  kernel<<<N * q->A, agarcl::SCREEN_THREADS, smem, stream>>>(*prm, *q, s,
                                                             out, N);
  return int(cudaGetLastError());
}
#endif

// Kernel K3: the screen frame of every env from the state planes.
//
// Replaces the TPU kernel agarcl_tpu/ops/fused_screen.py::_make_kernel
// (launched by _rasterize_sections and _rasterize_table) in circle mode,
// together with the tick kernel's screen_tab section emission
// (agarcl_tpu/ops/fused_tick.py:2459-2502), which has no separate pass
// here: each block builds its env's camera from the planes itself. Wrapper
// and plain version: agarcl_tpu_torch/ops/fused_screen.py
// (screen_sections + rasterize_plain).
//
// Design: one block of 256 threads per env (8192 blocks at the main
// path's 8192 envs fill all 132 SMs). Thread 0 computes the camera (the
// slot-order centroid of player 0's cells and z = clamp(100 + mass/10,
// 100, 900)); the block writes the pixel-centre tables and the grid-line
// flags of each row and column, then draws the S x S class map in shared
// memory one class at a time in draw order (grid < pellet < food < main <
// other < virus), a barrier between classes. Class ids grow with draw
// order and every write of a phase stores the same value, so plain byte
// stores leave the topmost class with no atomics. Each entity tests only
// the pixels of a window two pixels wider on every side than its bounding
// box, with the exact predicate dx*dx <= fma(-dy, dy, r2). Pellets and
// foods (small, numerous) take one thread per entity; cells and viruses
// (few, possibly large) take the whole block per entity. The TPU kernel's
// MXU strip products, padded section tables and per-env unroll have no
// counterpart.
//
// f32 arithmetic follows the plain version (see its docstring): pixel
// centres fma(idx, half, c) with idx = (i+0.5)*2*f32(1/S) - 1 rounded in two
// steps for cells and grid lines and in one fma for pellets, foods and
// viruses; built with --fmad=false, so nothing else is contracted.
//
// What bounds it on Hopper: the frame store, S*S*C bytes per env (64 KB at
// S=128 with 4 channels, 537 MB at 8192 envs), against about 30 MB of plane
// reads; the drawing itself stays in shared memory.
#include "common.cuh"

namespace agarcl {

// Mirrors agarcl_tpu_torch/ops/fused_screen.py::ScreenParams.
struct ScreenParams {
  int S, C;
  uint32_t palette[8];
  float rc, tan_half, lo, hi_x, hi_y, pr2, fr2;
  float xs[8], ys[8];
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

// The frame of env n, drawn by thread tid of nthr (a host build runs it
// with tid 0 of 1). Scratch: cam[4], tab[4*S] pixel-centre tables,
// flags[2*S] grid flags, cls[S*S] class map; out: S*S*C bytes.
HD void screen_env(const EnvParams& p, const ScreenParams& q,
                   const Planes& s, int n, int N, float* cam, float* tab,
                   uint8_t* flags, uint8_t* cls, uint8_t* out, int tid,
                   int nthr) {
  const int S = q.S, Cc = p.Cc;
  if (tid == 0) {
    float tot = 0.0f, sx = 0.0f, sy = 0.0f;
    int pm = 0;
    for (int c = 0; c < Cc; c++) {
      const bool al = AT(s.calive, c) != 0;
      const int m = al ? AT(s.cmass, c) : 0;
      const float w = float(m);
      tot = tot + w;
      sx = sx + AT(s.cx, c) * w;
      sy = sy + AT(s.cy, c) * w;
      pm += m;
    }
    const float den = fmaxf(tot, 1.0f);
    const float z = fminf(fmaxf(FMAF(float(pm), 0.1f, 100.0f), 100.0f),
                          900.0f);
    cam[0] = sx / den;
    cam[1] = sy / den;
    cam[2] = z * q.tan_half;
  }
  BARRIER();
  const float cx = cam[0], cy = cam[1], half = cam[2];
  float* wxc = tab;           // cells, grid lines
  float* wyc = tab + S;
  float* wxs = tab + 2 * S;   // pellet, food and virus strips
  float* wys = tab + 3 * S;
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
    if (key >= 0)
      draw_own(pellet_x(p, key), pellet_y(p, key), q.pr2, wxs, wys, pitch,
               S, 2, cls);
  }
  BARRIER();
  for (int e = tid; e < p.Nf; e += nthr)
    if (AT(s.falive, e))
      draw_own(AT(s.fx, e), AT(s.fy, e), q.fr2, wxs, wys, pitch, S, 3, cls);
  BARRIER();
  for (int c = 0; c < p.P * Cc; c++) {
    if (c == Cc) BARRIER();                 // main player, then the others
    if (!AT(s.calive, c)) continue;
    const float r = radius(float(AT(s.cmass, c)));
    draw_shared(AT(s.cx, c), AT(s.cy, c), r * r, wxc, wyc, pitch, S,
                c < Cc ? 4 : 5, cls, tid, nthr);
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

// scratch bytes of one env: cam, tables, flags, class map
HD long long screen_scratch(int S) {
  return 16 + 16LL * S + 2LL * S + (long long)S * S;
}

#ifdef __CUDACC__
constexpr int SCREEN_THREADS = 256;

__global__ void __launch_bounds__(SCREEN_THREADS)
screen_kernel(const EnvParams p, const ScreenParams q, const Planes s,
              uint8_t* __restrict__ out, int N) {
  extern __shared__ float smem[];
  const int S = q.S;
  float* cam = smem;
  float* tab = smem + 4;
  uint8_t* flags = reinterpret_cast<uint8_t*>(tab + 4 * S);
  uint8_t* cls = flags + 2 * S;
  const int n = blockIdx.x;
  screen_env(p, q, s, n, N, cam, tab, flags, cls,
             out + (long long)n * S * S * q.C, threadIdx.x, blockDim.x);
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
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        agarcl::screen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return int(err);
  }
  agarcl::screen_kernel<<<N, agarcl::SCREEN_THREADS, smem, stream>>>(
      *prm, *q, s, out, N);
  return int(cudaGetLastError());
}
#endif

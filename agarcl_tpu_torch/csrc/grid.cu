// Kernel K4: the grid frame of every env and agent from the state planes.
//
// Replaces the TPU kernel agarcl_tpu/ops/fused_grid.py::_make_kernel
// (launched by fused_grid_channels and fused_grid_frame_from_secs),
// together with the tick kernel's grid_tab section emission
// (agarcl_tpu/ops/fused_tick.py:2436-2457) and the XLA table build of its
// one-row-per-(env, agent) input (_build_grid_table(agents=A)), which have
// no separate pass here: each block builds its agent's camera and entity
// bins from the planes itself. Wrapper and plain version:
// agarcl_tpu_torch/ops/fused_grid.py (grid_sections + rasterize_plain;
// channel semantics in obs/grid.py).
//
// Design: one block of 256 threads per (env, agent), block b = n*A + a,
// from two instantiations (one agent or more). Thread 0 computes the camera
// (frame_camera: the centroid of player a's cells, and view = clamp(2*mass,
// 100, 300)); the block writes the out-of-bounds flag of each grid row and
// column and clears a G x G int32 histogram in shared memory. One thread
// per pellet adds 1 to its bin with a shared atomicAdd (integer atomics
// give the same counts in any order, so the frame is exact and
// deterministic). Viruses, own cells (player a's) and other players' cells,
// a few hundred at most, go into a short shared list (bin, kind, mass) and
// set a flag bit in their bin's histogram word. The output pass gives each
// thread whole pixels: OOB from the row and column flags, pellet presence
// and count from the histogram, and, only in a flagged bin, virus max and
// total, own total and others' min and max from a scan of the list; it
// writes the selected channels, saturated to the output dtype, straight
// into the caller's (C, G, G) slice. The TPU kernel's one-hot MXU products,
// its 2^17 count weight and its block-level exact rewrite have no
// counterpart.
//
// f32 arithmetic follows the plain version (obs/grid.py): bins are
// trunc(G*(x - cx)/view + G/2) with an IEEE division, the row and column
// coordinates fma((i - G/2)*view, f32(1/G), c); built with --fmad=false,
// so nothing else is contracted.
//
// What bounds it on Hopper: the frame store, C*G*G output elements per
// frame (64 KB at G=64 in int16 with 8 channels, 537 MB at 8192 envs of one
// agent), against about 2.5 KB of plane reads per env; the binning stays
// in shared memory.
#include "common.cuh"

namespace agarcl {

// Mirrors agarcl_tpu_torch/ops/fused_grid.py::GridParams.
struct GridParams {
  int G, C, elem, A;  // grid size, selected channels, output bytes, agents
  int chan[8];        // selected channel ids in output order
  float rg, W, H;     // f32(1/G), arena width and height
};

constexpr int GRID_FLAG = 1 << 30;   // histogram bit: a listed entity here
constexpr int GRID_INF = 1 << 30;    // min channel of an empty bin
constexpr int GRID_MAX_ENTS = MAX_VIRUSES + MAX_PLAYERS * MAX_CELLS;

struct GridEnt { int bin, kind, mass; };   // kind 0 virus, 1 own, 2 other

#ifndef BARRIER
#ifdef __CUDA_ARCH__
#define BARRIER() __syncthreads()
#else
#define BARRIER()
#endif
#endif

HD int shared_add(int* a, int v) {
#ifdef __CUDA_ARCH__
  return atomicAdd(a, v);
#else
  const int old = *a;
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

// flat bin r*G + c of the point (x, y), or -1 off the grid
HD int grid_bin(float x, float y, float cx, float cy, float view, int G) {
  const float fg = float(G), half = fg * 0.5f;
  const float bx = truncf(fg * (x - cx) / view + half);
  const float by = truncf(fg * (y - cy) / view + half);
  if (!(bx >= 0.0f && bx < fg && by >= 0.0f && by < fg)) return -1;
  return int(bx) * G + int(by);
}

HD void store_sat(uint8_t* out, long long i, int elem, int v) {
  if (elem == 4) {
    reinterpret_cast<int32_t*>(out)[i] = v;
  } else if (elem == 2) {
    v = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
    reinterpret_cast<int16_t*>(out)[i] = int16_t(v);
  } else {
    v = v < -128 ? -128 : (v > 127 ? 127 : v);
    reinterpret_cast<int8_t*>(out)[i] = int8_t(v);
  }
}

// value of channel ch (obs/grid.py order) from a bin's accumulators
HD int grid_value(int ch, int oob, int cnt, int vmax, int vsum, int own,
                  int omin, int omax) {
  switch (ch) {
    case 0: return oob;
    case 1: return cnt > 0 ? 1 : 0;
    case 2: return cnt;
    case 3: return vmax;
    case 4: return vsum;
    case 5: return own;
    case 6: return omin;
    default: return omax;
  }
}

#define AT(plane, f) (plane)[(long long)(f) * N + n]

// The frame of agent a in env n, drawn by thread tid of nthr (a host
// build runs it with tid 0 of 1); MULTI serves q.A > 1 agents (one agent
// compiles to the single-agent code). Scratch: cam[3], nent[1],
// flags[2*G] (row, column inside the arena), hist[G*G],
// ents[GRID_MAX_ENTS]; out: C*G*G elements.
template <bool MULTI>
HD void grid_env(const EnvParams& p, const GridParams& q, const Planes& s,
                 int n, int a, int N, float* cam, int* nent, uint8_t* flags,
                 int* hist, GridEnt* ents, uint8_t* out, int tid, int nthr) {
  if (!MULTI) a = 0;
  const int G = q.G, GG = q.G * q.G, Cc = p.Cc, own0 = a * Cc;
  if (tid == 0) {
    int pm;
    frame_camera(s, Cc, a, MULTI ? q.A : 1, n, N, cam[0], cam[1], pm);
    cam[2] = fminf(fmaxf(2.0f * float(pm), 100.0f), 300.0f);
    *nent = 0;
  }
  for (int k = tid; k < GG; k += nthr) hist[k] = 0;
  BARRIER();
  const float cx = cam[0], cy = cam[1], view = cam[2];
  for (int i = tid; i < G; i += nthr) {
    const float tv = (float(i) - float(G) * 0.5f) * view;
    const float wx = FMAF(tv, q.rg, cx), wy = FMAF(tv, q.rg, cy);
    flags[i] = wx >= 0.0f && wx < q.W;
    flags[G + i] = wy >= 0.0f && wy < q.H;
  }
  for (int e = tid; e < p.Np; e += nthr) {
    const int key = AT(s.pkey, e);
    if (key < 0) continue;
    const int b = grid_bin(pellet_x(p, key), pellet_y(p, key), cx, cy, view,
                           G);
    if (b >= 0) shared_add(&hist[b], 1);
  }
  const int n_cells = p.P * Cc;
  for (int e = tid; e < p.Nv + n_cells; e += nthr) {
    int b, kind, mass;
    if (e < p.Nv) {
      if (!AT(s.valive, e)) continue;
      b = grid_bin(AT(s.vx, e), AT(s.vy, e), cx, cy, view, G);
      kind = 0;
      mass = AT(s.vmass, e);
    } else {
      const int c = e - p.Nv;
      if (!AT(s.calive, c)) continue;
      b = grid_bin(AT(s.cx, c), AT(s.cy, c), cx, cy, view, G);
      kind = c >= own0 && c < own0 + Cc ? 1 : 2;
      mass = AT(s.cmass, c);
    }
    if (b < 0) continue;
    ents[shared_add(nent, 1)] = {b, kind, mass};
    shared_or(&hist[b], GRID_FLAG);
  }
  BARRIER();
  const int ne = *nent;
  for (int k = tid; k < GG; k += nthr) {
    const int h = hist[k];
    const int cnt = h & (GRID_FLAG - 1);
    const int oob = flags[k / G] && flags[G + k % G] ? 0 : -1;
    int vmax = 0, vsum = 0, own = 0, omin = GRID_INF, omax = 0;
    if (h & GRID_FLAG) {
      for (int e = 0; e < ne; e++) {
        const GridEnt& t = ents[e];
        if (t.bin != k) continue;
        if (t.kind == 0) {
          vmax = t.mass > vmax ? t.mass : vmax;
          vsum += t.mass;
        } else if (t.kind == 1) {
          own += t.mass;
        } else {
          omin = t.mass < omin ? t.mass : omin;
          omax = t.mass > omax ? t.mass : omax;
        }
      }
    }
    omin = omin == GRID_INF ? 0 : omin;
    for (int c = 0; c < q.C; c++)
      store_sat(out, (long long)c * GG + k, q.elem,
                grid_value(q.chan[c], oob, cnt, vmax, vsum, own, omin,
                           omax));
  }
}

#undef AT

// shared bytes of one env: cam + nent, entity list, row/column flags,
// histogram (4-byte aligned)
HD long long grid_scratch(int G) {
  return 16 + (long long)sizeof(GridEnt) * GRID_MAX_ENTS
         + 4LL * ((2 * G + 3) / 4) + 4LL * G * G;
}

#ifdef __CUDACC__
constexpr int GRID_THREADS = 256;

template <bool MULTI>
__global__ void __launch_bounds__(GRID_THREADS)
grid_kernel(const EnvParams p, const GridParams q, const Planes s,
            uint8_t* __restrict__ out, int N) {
  extern __shared__ int gsmem[];
  const int G = q.G;
  float* cam = reinterpret_cast<float*>(gsmem);
  int* nent = gsmem + 3;
  GridEnt* ents = reinterpret_cast<GridEnt*>(gsmem + 4);
  uint8_t* flags = reinterpret_cast<uint8_t*>(ents + GRID_MAX_ENTS);
  int* hist = reinterpret_cast<int*>(flags + 4 * ((2 * G + 3) / 4));
  const int b = blockIdx.x;
  grid_env<MULTI>(p, q, s, MULTI ? b / q.A : b, MULTI ? b % q.A : 0, N, cam,
                  nent, flags, hist, ents,
                  out + (long long)b * q.C * G * G * q.elem, threadIdx.x,
                  blockDim.x);
}
#endif

}  // namespace agarcl

#ifdef __CUDACC__
extern "C" int agarcl_grid(const agarcl::EnvParams* prm,
                           const agarcl::GridParams* q, void* const* planes,
                           uint8_t* out, int N, cudaStream_t stream) {
  const agarcl::Planes s = agarcl::planes_from(planes);
  const int smem = int(agarcl::grid_scratch(q->G));
  void (*kernel)(agarcl::EnvParams, agarcl::GridParams, agarcl::Planes,
                 uint8_t*, int) = q->A > 1 ? agarcl::grid_kernel<true>
                                           : agarcl::grid_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
  }
  kernel<<<N * q->A, agarcl::GRID_THREADS, smem, stream>>>(*prm, *q, s, out,
                                                           N);
  return int(cudaGetLastError());
}
#endif

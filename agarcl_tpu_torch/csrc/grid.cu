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
// What bounds it on Hopper: the frame store, C*G*G output elements per
// frame (64 KB at G=64 in int16 with 8 channels, 537 MB at 8192 envs of one
// agent), against about 2.5 KB of plane reads per env; the binning stays
// in shared memory, so the design keeps the output pass's instructions
// per element few and its stores wide.
//
// Design: one block of 256 threads per (env, agent), block b = n*A + a,
// from six instantiations (one agent or more, times the element size 1, 2
// or 4: the output width is resolved once per launch). Warp 0 loads player
// a's cells at once and lane 0 folds the camera (camera_fold; view =
// clamp(2*mass, 100, 300)) while every thread clears a G x G int32
// histogram in shared memory with 16-byte stores. Then the block writes the
// out-of-bounds flag of each grid row and column; one thread per pellet
// adds 1 to its bin with a shared atomicAdd (integer atomics give the same
// counts in any order, so the frame is exact and deterministic); viruses,
// own cells (player a's) and other players' cells, a few hundred at most,
// go into a short shared list (bin, kind, mass) and set a flag bit in
// their bin's histogram word. The output pass gives each thread a run of
// 16 bytes of adjacent bins in one row (8 bins in int16, 16 in int8, 4 in
// int32): for each selected channel (a table in GridParams) it assembles
// the run's values, saturated to the element size, in registers and
// writes one 16-byte streaming store, with the list channels (virus max
// and total, own total, others' min and max) as 0; a flagged bin of the
// run then scans the list and overwrites those channels with narrow
// stores. A row that G cuts short (the ragged run), or a frame whose rows
// are not 16-byte aligned (G*elem not a multiple of 16), takes narrow
// stores. The TPU kernel's one-hot MXU products, its 2^17 count weight
// and its block-level exact rewrite have no counterpart.
//
// f32 arithmetic follows the plain version (obs/grid.py): bins are
// trunc(G*(x - cx)/view + G/2) with an IEEE division, the row and column
// coordinates fma((i - G/2)*view, f32(1/G), c); built with --fmad=false,
// so nothing else is contracted.
//
// The host build (no __CUDACC__) runs grid_env with one thread (tid 0 of
// 1); every shared atomic is then a plain update.
#include "common.cuh"

namespace agarcl {

// Mirrors agarcl_tpu_torch/ops/fused_grid.py::GridParams.
struct GridParams {
  int G, C, elem, A;  // grid size, selected channels, output bytes, agents
  int chan[8];        // selected channel ids in output order
  float rg, W, H;     // f32(1/G), arena width and height
};

constexpr int GRID_THREADS = 256;
constexpr int GRID_FLAG = 1 << 30;   // histogram bit: a listed entity here
constexpr int GRID_INF = 1 << 30;    // min channel of an empty bin
constexpr int GRID_MAX_ENTS = MAX_VIRUSES + MAX_PLAYERS * MAX_CELLS;

struct GridEnt { int bin, kind, mass; };   // kind 0 virus, 1 own, 2 other

#ifndef BARRIER
#ifdef __CUDA_ARCH__
#define BARRIER() __syncthreads()
#define SYNCWARP() __syncwarp()
#else
#define BARRIER()
#define SYNCWARP()
#endif
#endif

// flat bin r*G + c of the point (x, y), or -1 off the grid
HD int grid_bin(float x, float y, float cx, float cy, float view, int G) {
  const float fg = float(G), half = fg * 0.5f;
  const float bx = truncf(fg * (x - cx) / view + half);
  const float by = truncf(fg * (y - cy) / view + half);
  if (!(bx >= 0.0f && bx < fg && by >= 0.0f && by < fg)) return -1;
  return int(bx) * G + int(by);
}

// v saturated to an ELEM-byte signed integer, as its ELEM*8 low bits
template <int ELEM>
HD uint32_t sat_bits(int v) {
  if (ELEM == 4) return uint32_t(v);
  if (ELEM == 2) {
    v = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
    return uint32_t(v) & 0xFFFFu;
  }
  v = v < -128 ? -128 : (v > 127 ? 127 : v);
  return uint32_t(v) & 0xFFu;
}

template <int ELEM>
HD void store_sat(uint8_t* out, long long i, int v) {
  const uint32_t bits = sat_bits<ELEM>(v);
  if (ELEM == 4) reinterpret_cast<int32_t*>(out)[i] = int32_t(bits);
  else if (ELEM == 2) reinterpret_cast<uint16_t*>(out)[i] = uint16_t(bits);
  else out[i] = uint8_t(bits);
}

// The shared scratch of one frame (grid_carve lays it out).
struct GridSmem {
  float* cam;                  // cx, cy, view
  int* nent;                   // listed entities
  float *cellx, *celly;        // player a's cells, staged for the camera
  int* cellm;
  uint8_t* flags;              // rows then columns inside the arena
  GridEnt* ents;               // [GRID_MAX_ENTS]
  int* hist;                   // [G*G] pellet counts | GRID_FLAG
};

// Lay the scratch out from base (16-byte aligned pieces); returns its
// bytes. base may be null to size it.
HD long long grid_carve(int G, uint8_t* base, GridSmem& m) {
  long long o = 0;
  auto take = [&](long long bytes) {
    uint8_t* p = base ? base + o : nullptr;
    o += (bytes + 15) & ~15LL;
    return p;
  };
  m.cam = reinterpret_cast<float*>(take(12));
  m.nent = reinterpret_cast<int*>(take(4));
  m.cellx = reinterpret_cast<float*>(take(4 * MAX_CELLS));
  m.celly = reinterpret_cast<float*>(take(4 * MAX_CELLS));
  m.cellm = reinterpret_cast<int*>(take(4 * MAX_CELLS));
  m.flags = take(2LL * G);
  m.ents = reinterpret_cast<GridEnt*>(take(sizeof(GridEnt)
                                           * GRID_MAX_ENTS));
  m.hist = reinterpret_cast<int*>(take(4LL * G * G));
  return o;
}

HD long long grid_scratch(int G) {
  GridSmem m;
  return grid_carve(G, nullptr, m);
}

#define AT(plane, f) (plane)[(long long)(f) * N + n]

// The frame of agent a in env n, drawn by thread tid of nthr (a host
// build runs it with tid 0 of 1); MULTI serves q.A > 1 agents (one agent
// compiles to the single-agent code), ELEM = q.elem. smem:
// grid_scratch(G) bytes, 16-byte aligned; out: C*G*G elements, 16-byte
// aligned when vec (then G*ELEM is a multiple of 16).
template <bool MULTI, int ELEM>
HD void grid_env(const EnvParams& p, const GridParams& q, const Planes& s,
                 int n, int a, int N, uint8_t* smem, uint8_t* out, bool vec,
                 int tid, int nthr) {
  if (!MULTI) a = 0;
  const int G = q.G, GG = q.G * q.G, Cc = p.Cc, own0 = a * Cc;
  GridSmem m;
  grid_carve(G, smem, m);
  // warp 0 stages player a's cells and lane 0 folds the camera, while
  // every thread clears the histogram
  if (tid < 32) {
    camera_stage(s, Cc, a, n, N, m.cellx, m.celly, m.cellm, tid,
                 nthr < 32 ? nthr : 32);
    SYNCWARP();
    if (tid == 0) {
      int pm;
      camera_fold(m.cellx, m.celly, m.cellm, Cc, MULTI, m.cam[0], m.cam[1],
                  pm);
      m.cam[2] = fminf(fmaxf(2.0f * float(pm), 100.0f), 300.0f);
      *m.nent = 0;
    }
  }
  for (int k = tid; k < GG / 4; k += nthr) zero16(m.hist + 4 * k);
  for (int k = GG / 4 * 4 + tid; k < GG; k += nthr) m.hist[k] = 0;
  BARRIER();  // camera, cleared histogram
  const float cx = m.cam[0], cy = m.cam[1], view = m.cam[2];
  for (int i = tid; i < G; i += nthr) {
    const float tv = (float(i) - float(G) * 0.5f) * view;
    const float wx = FMAF(tv, q.rg, cx), wy = FMAF(tv, q.rg, cy);
    m.flags[i] = wx >= 0.0f && wx < q.W;
    m.flags[G + i] = wy >= 0.0f && wy < q.H;
  }
  for (int e = tid; e < p.Np; e += nthr) {
    const int key = AT(s.pkey, e);
    if (key < 0) continue;
    const int b = grid_bin(pellet_x(p, key), pellet_y(p, key), cx, cy, view,
                           G);
    if (b >= 0) shared_add(&m.hist[b], 1);
  }
  const int n_cells = p.P * Cc;
  for (int e = tid; e < p.Nv + n_cells; e += nthr) {
    int b, kind, mass;
    if (e < p.Nv) {                  // fields loaded with the flag
      const float x = AT(s.vx, e), y = AT(s.vy, e);
      mass = AT(s.vmass, e);
      if (!AT(s.valive, e)) continue;
      b = grid_bin(x, y, cx, cy, view, G);
      kind = 0;
    } else {
      const int c = e - p.Nv;
      const float x = AT(s.cx, c), y = AT(s.cy, c);
      mass = AT(s.cmass, c);
      if (!AT(s.calive, c)) continue;
      b = grid_bin(x, y, cx, cy, view, G);
      kind = c >= own0 && c < own0 + Cc ? 1 : 2;
    }
    if (b < 0) continue;
    m.ents[shared_add(m.nent, 1)] = {b, kind, mass};
    shared_or(&m.hist[b], GRID_FLAG);
  }
  BARRIER();  // bins and the entity list
  constexpr int R = 16 / ELEM;            // bins of a 16-byte run
  const int runs = (G + R - 1) / R, ne = *m.nent;
  for (int it = tid; it < G * runs; it += nthr) {
    const int row = it / runs, c0 = (it - row * runs) * R;
    const int len = G - c0 < R ? G - c0 : R;
    const long long k0 = (long long)row * G + c0;
    const bool in_row = m.flags[row] != 0;
    int cnt[R];
    int oob = 0, flagged = 0;
#pragma unroll
    for (int j = 0; j < R; j++) {
      const int h = j < len ? m.hist[k0 + j] : 0;
      cnt[j] = h & (GRID_FLAG - 1);
      flagged |= (h & GRID_FLAG) ? 1 << j : 0;
      oob |= j < len && !(in_row && m.flags[G + c0 + j]) ? 1 << j : 0;
    }
    for (int ci = 0; ci < q.C; ci++) {
      const int ch = q.chan[ci];
      uint8_t* dst = out + ((long long)ci * GG + k0) * ELEM;
      // channels 3-7 come from the list: 0 here, a flagged bin below
      if (vec) {                      // then G % R == 0: a full run
        uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < R; j++) {
          const int v = ch == 0 ? -((oob >> j) & 1)
                        : ch == 1 ? (cnt[j] > 0 ? 1 : 0)
                        : ch == 2 ? cnt[j] : 0;
          w[j * ELEM / 4] |= sat_bits<ELEM>(v) << (8 * ((j * ELEM) & 3));
        }
        store16(dst, w[0], w[1], w[2], w[3]);
      } else {
        for (int j = 0; j < len; j++) {      // no runtime index of cnt
          const int h = m.hist[k0 + j] & (GRID_FLAG - 1);
          const int v = ch == 0 ? -((oob >> j) & 1)
                        : ch == 1 ? (h > 0 ? 1 : 0)
                        : ch == 2 ? h : 0;
          store_sat<ELEM>(dst, j, v);
        }
      }
    }
    for (int j = 0; flagged && j < len; j++) {
      if (!((flagged >> j) & 1)) continue;
      int vmax = 0, vsum = 0, own = 0, omin = GRID_INF, omax = 0;
      for (int e = 0; e < ne; e++) {
        const GridEnt& t = m.ents[e];
        if (t.bin != k0 + j) continue;
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
      omin = omin == GRID_INF ? 0 : omin;
      for (int ci = 0; ci < q.C; ci++) {
        const int ch = q.chan[ci];
        if (ch < 3) continue;
        const int v = ch == 3 ? vmax : ch == 4 ? vsum : ch == 5 ? own
                      : ch == 6 ? omin : omax;
        store_sat<ELEM>(out + ((long long)ci * GG + k0) * ELEM, j, v);
      }
    }
  }
}

#undef AT

#ifdef __CUDACC__
template <bool MULTI, int ELEM>
__global__ void __launch_bounds__(GRID_THREADS)
grid_kernel(const EnvParams p, const GridParams q, const Planes s,
            uint8_t* __restrict__ out, int N) {
  extern __shared__ __align__(16) uint8_t gsmem[];
  const int b = blockIdx.x;
  const bool vec = (q.G * ELEM) % 16 == 0
                   && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  grid_env<MULTI, ELEM>(p, q, s, MULTI ? b / q.A : b, MULTI ? b % q.A : 0,
                        N, gsmem,
                        out + (long long)b * q.C * q.G * q.G * ELEM, vec,
                        threadIdx.x, blockDim.x);
}

using GridKernel = void (*)(EnvParams, GridParams, Planes, uint8_t*, int);

inline GridKernel grid_pick(const GridParams& q) {
  const bool multi = q.A > 1;
  if (q.elem == 4)
    return multi ? grid_kernel<true, 4> : grid_kernel<false, 4>;
  if (q.elem == 2)
    return multi ? grid_kernel<true, 2> : grid_kernel<false, 2>;
  return multi ? grid_kernel<true, 1> : grid_kernel<false, 1>;
}
#endif

}  // namespace agarcl

#ifdef __CUDACC__
extern "C" int agarcl_grid(const agarcl::EnvParams* prm,
                           const agarcl::GridParams* q, void* const* planes,
                           uint8_t* out, int N, cudaStream_t stream) {
  const agarcl::Planes s = agarcl::planes_from(planes);
  const int smem = int(agarcl::grid_scratch(q->G));
  const agarcl::GridKernel kernel = agarcl::grid_pick(*q);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
  }
  kernel<<<N * q->A, agarcl::GRID_THREADS, smem, stream>>>(*prm, *q, s, out,
                                                           N);
  return int(cudaGetLastError());
}

// K4's launch shape for N envs: blocks, threads a block, dynamic shared
// bytes, resident blocks per SM (the occupancy API)
extern "C" int agarcl_grid_shape(const agarcl::GridParams* q, int N,
                                 int* out) {
  const int smem = int(agarcl::grid_scratch(q->G));
  const agarcl::GridKernel kernel = agarcl::grid_pick(*q);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {     // as the launch does: never below the default
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, agarcl::GRID_THREADS, smem);
  out[0] = N * q->A;
  out[1] = agarcl::GRID_THREADS;
  out[2] = smem;
  out[3] = blocks;
  return int(err);
}
#endif

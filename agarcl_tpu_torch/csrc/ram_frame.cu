// Kernel K2: the RAM frame of every (env, agent) from the state planes.
//
// Replaces the TPU kernel agarcl_tpu/ops/fused_obs.py::_make_obs_kernel
// (launched by fused_ram_obs). One warp per (env, agent), 8 warps a block:
// the warp runs ram_frame.cuh's team code on the planes in device memory,
// with its packed keys (p.Np words), picks (p.kp words) and per-player
// scratch in shared memory. Warps run over envs fastest, so a block's
// loads of one plane row fall in a few sectors. What bounds it: the
// sequential picks (ram_frame.cuh); it runs once per reset. Wrapper and
// plain version: agarcl_tpu_torch/ops/fused_obs.py (plain:
// obs/ram.py::ram_frame).
#include "ram_frame.cuh"

#ifdef __CUDACC__

namespace agarcl {

constexpr int K2_WARPS = 8;

// shared memory of one warp: the frame scratch, the keys, the picks
HD int k2_warp_bytes(const EnvParams& p) {
  return int((sizeof(FrameScratch<MAX_PLAYERS>) + 4 * (p.Np + p.kp) + 15)
             / 16 * 16);
}

__global__ void __launch_bounds__(K2_WARPS * LANES)
ram_frame_kernel(const EnvParams p, const Planes s, float* __restrict__ out,
                 int N) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / LANES;
  const int w = blockIdx.x * K2_WARPS + warp;
  if (w >= N * p.A) return;          // whole warps
  const int a = w / N, n = w % N;
  uint8_t* mine = smem + (long long)warp * k2_warp_bytes(p);
  auto& fs = *reinterpret_cast<FrameScratch<MAX_PLAYERS>*>(mine);
  uint32_t* keys = reinterpret_cast<uint32_t*>(
      mine + sizeof(FrameScratch<MAX_PLAYERS>));
  const Team T{int(threadIdx.x % LANES)};
  ram_frame_team(T, p, PlaneView{s, n, N}, a,
                 out + ((long long)n * p.A + a) * p.R, fs, keys, keys + p.Np);
}

}  // namespace agarcl

extern "C" int agarcl_ram_frame(const agarcl::EnvParams* prm,
                                void* const* planes, float* out, int N,
                                cudaStream_t stream) {
  using namespace agarcl;
  if (prm->P > MAX_PLAYERS) return int(cudaErrorInvalidValue);
  const Planes s = planes_from(planes);
  const int total = N * prm->A;
  const int blocks = (total + K2_WARPS - 1) / K2_WARPS;
  const int smem = K2_WARPS * k2_warp_bytes(*prm);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ram_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
  }
  ram_frame_kernel<<<blocks, K2_WARPS * LANES, smem, stream>>>(*prm, s, out,
                                                                N);
  return int(cudaGetLastError());
}

extern "C" const char* agarcl_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

#endif  // __CUDACC__

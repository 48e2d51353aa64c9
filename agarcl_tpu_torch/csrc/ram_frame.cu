// Kernel K2: the RAM frame of every (env, agent) from the state planes.
//
// Replaces the TPU kernel agarcl_tpu/ops/fused_obs.py::_make_obs_kernel
// (launched by fused_ram_obs). One thread per (env, agent), 128 threads a
// block; the thread index runs over envs fastest so a warp reads 32
// neighbouring envs of each plane. See ram_frame.cuh for the frame itself
// and what bounds it. Wrapper and plain version:
// agarcl_tpu_torch/ops/fused_obs.py (plain: obs/ram.py::ram_frame).
#include "ram_frame.cuh"

#ifdef __CUDACC__

namespace agarcl {

__global__ void __launch_bounds__(128)
ram_frame_kernel(const EnvParams p, const Planes s, float* __restrict__ out,
                 int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * p.A) return;
  const int a = i / N, n = i % N;
  ram_frame_env(p, s, n, N, a, out + ((long long)n * p.A + a) * p.R);
}

}  // namespace agarcl

extern "C" int agarcl_ram_frame(const agarcl::EnvParams* prm,
                                void* const* planes, float* out, int N,
                                cudaStream_t stream) {
  const agarcl::Planes s = agarcl::planes_from(planes);
  const int total = N * prm->A;
  const int threads = 128;
  const int blocks = (total + threads - 1) / threads;
  agarcl::ram_frame_kernel<<<blocks, threads, 0, stream>>>(*prm, s, out, N);
  return int(cudaGetLastError());
}

extern "C" const char* agarcl_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

#endif  // __CUDACC__

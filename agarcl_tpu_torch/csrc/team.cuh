// A team of 32 lanes that runs one env (K1) or one (env, agent) frame
// (K2): a warp on the device; on the host (the g++ build of the sources,
// tests/test_torch_host_build.py) one thread that plays the 32 lanes in
// turn, lane 0's items first, with the same per-lane split of the work.
//
// Every collective is exact in any order (int sums, int mins,
// lexicographic (bits, index) mins, ballot prefix ranks), so the card and
// the host agree bit for bit. The rules the env code keeps:
//  - a phase's items are independent (team_for, team_rank_for) or reduced
//    by one of the collectives;
//  - a serial phase (team_serial) runs on lane 0 and calls no collective
//    (the host build aborts if it does); it leaves its results in shared
//    memory, never in a register another lane reads;
//  - team_for and team_rank_for end with a warp barrier, so what their
//    items wrote is visible to every lane after them;
//  - state a lane keeps across collectives (its pellets' flags, its
//    column's head) lives in shared memory as item l of a 32-item phase,
//    which lane l runs.
#pragma once

#include "common.cuh"

#include <cstdlib>

namespace agarcl {

constexpr int LANES = 32;
constexpr uint32_t NO_KEY = 0xFFFFFFFFu;
constexpr uint64_t NO_KEY64 = ~0ull;

struct Team {
  int lane;        // 0 .. 31 on the device; 0 on the host
};

// the host side's check that no collective runs inside a serial phase
inline bool& host_in_serial() {
  static thread_local bool flag = false;
  return flag;
}
inline void host_collective() {
  if (host_in_serial()) std::abort();
}

// f(j) for every j in [0, n): lane l takes j = l, l + 32, ...
template <class F>
HD void team_for(const Team& T, int n, F f) {
#ifdef __CUDA_ARCH__
  for (int j = T.lane; j < n; j += LANES) f(j);
  __syncwarp();
#else
  (void)T;
  host_collective();
  for (int l = 0; l < LANES; l++)
    for (int j = l; j < n; j += LANES) f(j);
#endif
}

// the smallest f(j) over j in [0, n) (NO_KEY for n = 0), on every lane
template <class F>
HD uint32_t team_min(const Team& T, int n, F f) {
#ifdef __CUDA_ARCH__
  uint32_t m = NO_KEY;
  for (int j = T.lane; j < n; j += LANES) {
    const uint32_t k = f(j);
    m = k < m ? k : m;
  }
  return __reduce_min_sync(0xFFFFFFFFu, m);
#else
  (void)T;
  host_collective();
  uint32_t m = NO_KEY;
  for (int l = 0; l < LANES; l++) {
    uint32_t ml = NO_KEY;
    for (int j = l; j < n; j += LANES) {
      const uint32_t k = f(j);
      ml = k < ml ? k : ml;
    }
    m = ml < m ? ml : m;
  }
  return m;
#endif
}

// the same for 64-bit keys, (bits << 32 | index) pairs
template <class F>
HD uint64_t team_min64(const Team& T, int n, F f) {
#ifdef __CUDA_ARCH__
  uint64_t m = NO_KEY64;
  for (int j = T.lane; j < n; j += LANES) {
    const uint64_t k = f(j);
    m = k < m ? k : m;
  }
  for (int o = LANES / 2; o > 0; o >>= 1) {
    const uint64_t k = __shfl_xor_sync(0xFFFFFFFFu, m, o);
    m = k < m ? k : m;
  }
  return m;
#else
  (void)T;
  host_collective();
  uint64_t m = NO_KEY64;
  for (int l = 0; l < LANES; l++) {
    uint64_t ml = NO_KEY64;
    for (int j = l; j < n; j += LANES) {
      const uint64_t k = f(j);
      ml = k < ml ? k : ml;
    }
    m = ml < m ? ml : m;
  }
  return m;
#endif
}

// the int sum of f(j) over j in [0, n), on every lane
template <class F>
HD int team_sum(const Team& T, int n, F f) {
#ifdef __CUDA_ARCH__
  int s = 0;
  for (int j = T.lane; j < n; j += LANES) s += f(j);
  return __reduce_add_sync(0xFFFFFFFFu, s);
#else
  (void)T;
  host_collective();
  int s = 0;
  for (int l = 0; l < LANES; l++) {
    int sl = 0;
    for (int j = l; j < n; j += LANES) sl += f(j);
    s += sl;
  }
  return s;
#endif
}

// f(j, r) for the first `limit` j in [0, n) with pred(j), in j order, r
// their rank 0, 1, ...: chunks of 32, a ballot and the prefix count of
// each lane's bit. pred sees the chunk before any f of it runs.
template <class Pred, class F>
HD void team_rank_for(const Team& T, int n, int limit, Pred pred, F f) {
#ifdef __CUDA_ARCH__
  int base = 0;
  for (int b = 0; b < n && base < limit; b += LANES) {
    const int j = b + T.lane;
    const bool hit = j < n && pred(j);
    const uint32_t m = __ballot_sync(0xFFFFFFFFu, hit);
    const int r = base + __popc(m & ((1u << T.lane) - 1u));
    if (hit && r < limit) f(j, r);
    base += __popc(m);
  }
  __syncwarp();
#else
  (void)T;
  host_collective();
  int base = 0;
  for (int b = 0; b < n && base < limit; b += LANES) {
    uint32_t m = 0;
    for (int l = 0; l < LANES; l++)
      if (b + l < n && pred(b + l)) m |= 1u << l;
    for (int l = 0; l < LANES; l++) {
      const int r = base + __builtin_popcount(m & ((1u << l) - 1u));
      if (((m >> l) & 1u) && r < limit) f(b + l, r);
    }
    base += __builtin_popcount(m);
  }
#endif
}

// f() on lane 0 alone, then a warp barrier
template <class F>
HD void team_serial(const Team& T, F f) {
#ifdef __CUDA_ARCH__
  if (T.lane == 0) f();
  __syncwarp();
#else
  (void)T;
  host_in_serial() = true;
  f();
  host_in_serial() = false;
#endif
}

// whether this lane does item t of a phase that spreads items t = 0, 1, ...
// over the lanes in turn (the host plays every lane)
HD bool team_owns(const Team& T, int t) {
#ifdef __CUDA_ARCH__
  return (t & (LANES - 1)) == T.lane;
#else
  (void)T; (void)t;
  return true;
#endif
}

// exact shared-memory updates from the lanes of one phase
HD void team_add(int* a, int v) {
#ifdef __CUDA_ARCH__
  atomicAdd(a, v);
#else
  *a += v;
#endif
}
HD void team_min_at(int* a, int v) {
#ifdef __CUDA_ARCH__
  atomicMin(a, v);
#else
  *a = v < *a ? v : *a;
#endif
}

}  // namespace agarcl

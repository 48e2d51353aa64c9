// RAM frame of one (env, agent) — the device code shared by kernel K2
// (ram_frame.cu) and the multi-step tick K1 (tick.cu), run by a team of 32
// lanes (team.cuh). Plain version: agarcl_tpu_torch/obs/ram.py::ram_frame.
//
// Replaces agarcl_tpu/ops/fused_obs.py::obs_rows / _nearest_rows (run by
// _make_obs_kernel and by the tick kernel's n_steps mode). The TPU kernel
// keeps envs in the 128 vector lanes and extracts each neighbour with a
// min-reduce over sublanes; here the 32 lanes of a warp share one frame.
// The t-th nearest entity is the smallest packed key greater than the
// (t-1)-th: the keys (obs/ram.py::pack_nearest_key) are unique, so each
// pick is one warp min-reduce and no marking pass is needed.
//
// What bounds it on Hopper: the kp sequential picks (a warp min-reduce
// each) and the virus picks; the rest is one pass. The keys are computed
// once per frame into shared memory, one key evaluation per live pellet,
// the least work any implementation does; each lane sorts its column of
// Np/32 keys (a bitonic network in registers up to 16 keys, as on the
// main path); a pick is a warp min over the 32 column heads, and the rows
// are written after the picks, a lane per pick. Viruses (at most 64) are
// evaluated in each of the kv picks. Cells are written a lane per cell.
#pragma once

#include "team.cuh"

namespace agarcl {

// The frame's per-player scratch (centroids, masses) and each lane's
// place in its sorted column of pellet keys, in shared memory.
template <int NP>
struct FrameScratch {
  float ccx[NP], ccy[NP];
  int pmass[NP], palive[NP];
  uint32_t head[LANES];
  int pos[LANES];
};

// the length of lane l's column (items l, l + 32, ...) of n items
HD int column_length(int l, int n) {
  return l < n ? (n - 1 - l) / LANES + 1 : 0;
}

constexpr int SORT_REGS = 16;   // columns this long sort in registers

// Sorts lane l's column of n keys in place, ascending: up to SORT_REGS
// keys by a bitonic network in registers (padded with NO_KEY), longer
// columns by insertion in shared memory (the lane's own bank).
HD void sort_column(uint32_t* keys, int l, int n) {
  const int cnt = column_length(l, n);
  if (cnt <= SORT_REGS) {
    uint32_t k[SORT_REGS];
#pragma unroll
    for (int t = 0; t < SORT_REGS; t++)
      k[t] = t < cnt ? keys[l + LANES * t] : NO_KEY;
#pragma unroll
    for (int size = 2; size <= SORT_REGS; size <<= 1)
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1)
#pragma unroll
        for (int i = 0; i < SORT_REGS; i++) {
          const int j = i ^ stride;
          if (j <= i) continue;
          const uint32_t a = k[i], b = k[j];
          const bool swap = (i & size) == 0 ? a > b : a < b;
          k[i] = swap ? b : a;
          k[j] = swap ? a : b;
        }
#pragma unroll
    for (int t = 0; t < SORT_REGS; t++)
      if (t < cnt) keys[l + LANES * t] = k[t];
    return;
  }
  for (int t = 1; t < cnt; t++) {
    const uint32_t k = keys[l + LANES * t];
    int u = t;
    for (; u > 0 && keys[l + LANES * (u - 1)] > k; u--)
      keys[l + LANES * u] = keys[l + LANES * (u - 1)];
    keys[l + LANES * u] = k;
  }
}


// One env's state in the (feature, N) planes of device memory: element
// (f, n) at f * N + n (K2 reads them in place).
struct PlaneView {
  const Planes& s;
  long long n, N;
  HD float cx(int f) const { return s.cx[f * N + n]; }
  HD float cy(int f) const { return s.cy[f * N + n]; }
  HD float cvx(int f) const { return s.cvx[f * N + n]; }
  HD float cvy(int f) const { return s.cvy[f * N + n]; }
  HD int cmass(int f) const { return s.cmass[f * N + n]; }
  HD bool calive(int f) const { return s.calive[f * N + n] != 0; }
  HD int pkey(int j) const { return s.pkey[j * N + n]; }
  HD float vx(int j) const { return s.vx[j * N + n]; }
  HD float vy(int j) const { return s.vy[j * N + n]; }
  HD int vmass(int j) const { return s.vmass[j * N + n]; }
  HD bool valive(int j) const { return s.valive[j * N + n] != 0; }
};

// Writes the p.R features of agent a into out[0 .. R). V reads one env's
// state (PlaneView, or K1's shared-memory copy); fs, keys (p.Np words) and
// sel (p.kp words) are shared-memory scratch of this team.
template <int NP, class V>
HD void ram_frame_team(const Team& T, const EnvParams& p, const V& v, int a,
                       float* out, FrameScratch<NP>& fs, uint32_t* keys,
                       uint32_t* sel) {
  const int P = p.P, Cc = p.Cc;
  // XLA's centroid (state.py::xla_centroid_of): the numerator is a chain
  // of fmas in slot order; one lane per player
  team_for(T, P, [&](int q) {
    float tot = 0.0f, sx = 0.0f, sy = 0.0f;
    int im = 0;
    bool al = false;
    for (int c = 0; c < Cc; c++) {
      const int f = q * Cc + c;
      const bool ca = v.calive(f);
      const int m = ca ? v.cmass(f) : 0;
      const float w = float(m);
      tot = tot + w;
      sx = c == 0 ? v.cx(f) * w : FMAF(v.cx(f), w, sx);
      sy = c == 0 ? v.cy(f) * w : FMAF(v.cy(f), w, sy);
      im += m;
      al = al || ca;
    }
    const float den = fmaxf(tot, 1.0f);
    fs.ccx[q] = sx / den;
    fs.ccy[q] = sy / den;
    fs.pmass[q] = im;
    fs.palive[q] = al;
  });
  const float mx = fs.ccx[a], my = fs.ccy[a];
  const int o_cells = 3, o_pel = o_cells + 6 * Cc;
  const int o_vir = o_pel + 3 * p.kp, o_pl = o_vir + 4 * p.kv;

  // header; own cell slots: rel_x, rel_y, mass, vel_x, vel_y, alive
  team_for(T, Cc + 1, [&](int c) {
    if (c == Cc) {
      out[0] = mx * p.inv_w;
      out[1] = my * p.inv_h;
      out[2] = float(fs.pmass[a]);
      return;
    }
    const int f = a * Cc + c;
    const float af = v.calive(f) ? 1.0f : 0.0f;
    float* o = out + o_cells + 6 * c;
    o[0] = (v.cx(f) - mx) * af;
    o[1] = (v.cy(f) - my) * af;
    o[2] = float(v.cmass(f)) * af;
    o[3] = v.cvx(f) * af;
    o[4] = v.cvy(f) * af;
    o[5] = af;
  });

  // kp nearest pellets: rel_x, rel_y, alive
  {
    const int low = (1 << p.kbits_p) - 1;
    team_for(T, p.Np, [&](int j) {
      const int key = v.pkey(j);
      if (key < 0) {
        keys[j] = uint32_t(DEAD_KEY);
        return;
      }
      const float rx = pellet_x(p, key) - mx;
      const float ry = pellet_y(p, key) - my;
      keys[j] = uint32_t((float_bits(rx * rx + ry * ry) & ~low) | j);
    });
    // each lane sorts its column; a pick is the least of the 32 column
    // heads (item l of a 32-item phase is lane l's), and the last pick's
    // lane moves its head on inside the next pick's min (an exhausted lane
    // stays at NO_KEY). Pick t's key goes to sel[t], which lane t mod 32
    // writes and then reads to write the row.
    team_for(T, LANES, [&](int l) {
      sort_column(keys, l, p.Np);
      fs.pos[l] = 0;
      fs.head[l] = column_length(l, p.Np) > 0 ? keys[l] : NO_KEY;
    });
    uint32_t prev = NO_KEY;
    int live = 0;                         // picks of live pellets
    for (; live < p.kp; live++) {
      const uint32_t best = team_min(T, LANES, [&](int l) {
        if (fs.head[l] == prev) {
          const int u = ++fs.pos[l];
          fs.head[l] = u < column_length(l, p.Np) ? keys[l + LANES * u]
                                                   : NO_KEY;
        }
        return fs.head[l];
      });
      if (best >= uint32_t(DEAD_KEY)) break;
      if (team_owns(T, live)) sel[live] = best;
      prev = best;
    }
    team_for(T, p.kp, [&](int t) {
      float* o = out + o_pel + 3 * t;
      if (t >= live) {
        o[0] = 0.0f; o[1] = 0.0f; o[2] = 0.0f;
        return;
      }
      const int key = v.pkey(int(sel[t]) & low);
      o[0] = pellet_x(p, key) - mx;
      o[1] = pellet_y(p, key) - my;
      o[2] = 1.0f;
    });
  }

  // kv nearest viruses: rel_x, rel_y, mass, alive
  {
    const int low = (1 << p.kbits_v) - 1;
    uint32_t lo = 0;
    for (int t = 0; t < p.kv; t++) {
      const uint32_t best = lo > uint32_t(DEAD_KEY) ? uint32_t(DEAD_KEY)
          : team_min(T, p.Nv, [&](int j) {
              if (!v.valive(j)) return NO_KEY;
              const float rx = v.vx(j) - mx;
              const float ry = v.vy(j) - my;
              const uint32_t k =
                  uint32_t((float_bits(rx * rx + ry * ry) & ~low) | j);
              return k >= lo ? k : NO_KEY;
            });
      if (team_owns(T, t)) {
        float* o = out + o_vir + 4 * t;
        if (best >= uint32_t(DEAD_KEY)) {
          o[0] = 0.0f; o[1] = 0.0f; o[2] = 0.0f; o[3] = 0.0f;
        } else {
          const int j = int(best) & low;
          o[0] = v.vx(j) - mx;
          o[1] = v.vy(j) - my;
          o[2] = float(v.vmass(j));
          o[3] = 1.0f;
        }
      }
      lo = best >= uint32_t(DEAD_KEY) ? uint32_t(DEAD_KEY) + 1u : best + 1u;
    }
  }

  // per-player block: rel_x, rel_y, total_mass, alive; own slot zeroed
  team_for(T, P, [&](int q) {
    float* o = out + o_pl + 4 * q;
    if (q == a || !fs.palive[q]) {
      o[0] = 0.0f; o[1] = 0.0f; o[2] = 0.0f; o[3] = 0.0f;
      return;
    }
    o[0] = fs.ccx[q] - mx;
    o[1] = fs.ccy[q] - my;
    o[2] = float(fs.pmass[q]);
    o[3] = 1.0f;
  });
}

}  // namespace agarcl

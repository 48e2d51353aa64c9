// RAM frame of one (env, agent) from the state planes — the device
// function shared by kernel K2 (ram_frame.cu) and the multi-step tick K1
// (tick.cu). Plain version: agarcl_tpu_torch/obs/ram.py::ram_frame.
//
// Replaces agarcl_tpu/ops/fused_obs.py::obs_rows / _nearest_rows (run by
// _make_obs_kernel and by the tick kernel's n_steps mode). The TPU kernel
// keeps envs in the 128 vector lanes and extracts each neighbour with a
// min-reduce over sublanes; here one thread owns one (env, agent) and
// finds the t-th nearest entity as the smallest packed key greater than
// the (t-1)-th: the keys (obs/ram.py::pack_nearest_key) are unique, so no
// marking pass and no per-thread key array are needed.
//
// What bounds it on Hopper: the k-nearest scans, kp x Np key evaluations
// per frame (32 x 500 on the main path), each one pellet-key load from
// L1/L2 plus ~15 integer and f32 operations. The design keeps the keys out
// of local memory and recomputes them per pick; the state planes are
// (feature, N), so a warp's loads of one feature are one coalesced
// transaction. Output rows are env-major (the public layout), R floats
// contiguous per thread.
#pragma once

#include "common.cuh"

namespace agarcl {

// Writes the p.R features of agent a of env n into out[0 .. R).
HD void ram_frame_env(const EnvParams& p, const Planes& s, int n, int N,
                      int a, float* out) {
  const int P = p.P, Cc = p.Cc;
  float ctot[MAX_PLAYERS], ccx[MAX_PLAYERS], ccy[MAX_PLAYERS];
  int pmass[MAX_PLAYERS];
  bool palive[MAX_PLAYERS];
  for (int q = 0; q < P; q++) {
    float tot = 0.0f, sx = 0.0f, sy = 0.0f;
    int im = 0;
    bool al = false;
    // XLA's centroid (state.py::xla_centroid_of): the numerator is a
    // chain of fmas in slot order
    for (int c = 0; c < Cc; c++) {
      const int r = (q * Cc + c) * N + n;
      const bool ca = s.calive[r] != 0;
      const int m = ca ? s.cmass[r] : 0;
      const float w = float(m);
      tot = tot + w;
      sx = c == 0 ? s.cx[r] * w : FMAF(s.cx[r], w, sx);
      sy = c == 0 ? s.cy[r] * w : FMAF(s.cy[r], w, sy);
      im += m;
      al = al || ca;
    }
    const float den = fmaxf(tot, 1.0f);
    ctot[q] = tot;
    ccx[q] = sx / den;
    ccy[q] = sy / den;
    pmass[q] = im;
    palive[q] = al;
  }
  (void)ctot;
  const float mx = ccx[a], my = ccy[a];
  int o = 0;
  out[o++] = mx * p.inv_w;
  out[o++] = my * p.inv_h;
  out[o++] = float(pmass[a]);

  // own cell slots: rel_x, rel_y, mass, vel_x, vel_y, alive
  for (int c = 0; c < Cc; c++) {
    const int r = (a * Cc + c) * N + n;
    const float af = s.calive[r] ? 1.0f : 0.0f;
    out[o++] = (s.cx[r] - mx) * af;
    out[o++] = (s.cy[r] - my) * af;
    out[o++] = float(s.cmass[r]) * af;
    out[o++] = s.cvx[r] * af;
    out[o++] = s.cvy[r] * af;
    out[o++] = af;
  }

  // kp nearest pellets: rel_x, rel_y, alive
  {
    const int low = (1 << p.kbits_p) - 1;
    long long last = -(1LL << 40);
    for (int t = 0; t < p.kp; t++) {
      int best = DEAD_KEY;
      for (int j = 0; j < p.Np; j++) {
        const int key = s.pkey[j * N + n];
        if (key < 0) continue;
        const float rx = pellet_x(p, key) - mx;
        const float ry = pellet_y(p, key) - my;
        const int k = (float_bits(rx * rx + ry * ry) & ~low) | j;
        if (k > last && k < best) best = k;
      }
      if (best == DEAD_KEY) {
        out[o++] = 0.0f; out[o++] = 0.0f; out[o++] = 0.0f;
        last = DEAD_KEY;
        continue;
      }
      const int key = s.pkey[(best & low) * N + n];
      out[o++] = pellet_x(p, key) - mx;
      out[o++] = pellet_y(p, key) - my;
      out[o++] = 1.0f;
      last = best;
    }
  }

  // kv nearest viruses: rel_x, rel_y, mass, alive
  {
    const int low = (1 << p.kbits_v) - 1;
    long long last = -(1LL << 40);
    for (int t = 0; t < p.kv; t++) {
      int best = DEAD_KEY;
      for (int j = 0; j < p.Nv; j++) {
        const int r = j * N + n;
        if (!s.valive[r]) continue;
        const float rx = s.vx[r] - mx;
        const float ry = s.vy[r] - my;
        const int k = (float_bits(rx * rx + ry * ry) & ~low) | j;
        if (k > last && k < best) best = k;
      }
      if (best == DEAD_KEY) {
        out[o++] = 0.0f; out[o++] = 0.0f; out[o++] = 0.0f; out[o++] = 0.0f;
        last = DEAD_KEY;
        continue;
      }
      const int r = (best & low) * N + n;
      out[o++] = s.vx[r] - mx;
      out[o++] = s.vy[r] - my;
      out[o++] = float(s.vmass[r]);
      out[o++] = 1.0f;
      last = best;
    }
  }

  // per-player block: rel_x, rel_y, total_mass, alive; own slot zeroed
  for (int q = 0; q < P; q++) {
    if (q == a || !palive[q]) {
      out[o++] = 0.0f; out[o++] = 0.0f; out[o++] = 0.0f; out[o++] = 0.0f;
      continue;
    }
    out[o++] = ccx[q] - mx;
    out[o++] = ccy[q] - my;
    out[o++] = float(pmass[q]);
    out[o++] = 1.0f;
  }
}

}  // namespace agarcl

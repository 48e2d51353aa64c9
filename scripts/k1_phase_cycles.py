"""Where K1's time goes: lane 0's clock64() cycles per phase of the tick
(and per RAM frame) on one GPU.

Builds a timed copy of agarcl_tpu_torch (the package of the current
directory) under .kernel_build/phase_cycles/ (gitignored): csrc/tick.cu
with a clock64() reading at each phase marker of engine_tick ("// --- N.")
and around the RAM frames, added into a device array by lane 0 of every
warp. Then it runs one k=40 call of the bench.py game (mode 4, arena 350,
500 pellets, 10 viruses, random actions, a RAM frame every step) after 10
warm steps, at 8192 envs and at 1 env, and prints the cycles per env and
tick of each phase, and per env and step of the frame. At 8192 envs the
cycles include the waits of 24 warps sharing an SM; at 1 env they are one
warp's own latency. The shipped kernel is not changed.

    python3 scripts/k1_phase_cycles.py

Exits non-zero without a CUDA device.
"""

import ctypes
import os
import shutil
import sys

ROOT = os.getcwd()
PHASES = ["bots", "elapsed", "move+relax", "virus events", "pellets",
          "auto-split+food eat", "feed+split+place", "recombine",
          "decay+cross-eat", "food move", "regen", "assemble"]
MARKS = ["  // --- 2. elapsed", "  // --- 3. movement",
         "  // --- 4. virus events", "  // --- 5. pellets",
         "  // --- 6. auto-split", "  // --- 7-9.", "  // --- 10. recombine",
         "  // --- 11-12.", "  // --- 13. foods move",
         "  // --- 14. regeneration", "  // --- 15. assemble"]
TIMERS = """
#ifdef __CUDACC__
__device__ unsigned long long g_phase[16];
#endif
#ifdef __CUDA_ARCH__
#define PHASE_START long long t0_ = clock64();
#define PHASE(k) if (T.lane == 0) { const long long t1_ = clock64(); \\
  atomicAdd(&g_phase[k], (unsigned long long)(t1_ - t0_)); t0_ = t1_; }
#else
#define PHASE_START
#define PHASE(k)
#endif
"""
READER = """
#ifdef __CUDACC__
extern "C" void agarcl_phase_read(unsigned long long* out) {
  static const unsigned long long zero[16] = {0};
  cudaMemcpyFromSymbol(out, agarcl::g_phase, sizeof(agarcl::g_phase));
  cudaMemcpyToSymbol(agarcl::g_phase, zero, sizeof(zero));
}
#endif
"""


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"marker not found once in tick.cu: {old!r}")
    return src.replace(old, new)


def timed_source(src: str) -> str:
    """tick.cu with the phase timers."""
    src = _sub(src, "namespace agarcl {\n", "namespace agarcl {\n" + TIMERS)
    src = _sub(src, "  // --- 1. bots", "  PHASE_START\n  // --- 1. bots")
    for k, mark in enumerate(MARKS):
        src = _sub(src, mark, f"  PHASE({k})\n{mark}")
    src = _sub(src, "  team_serial(T, [&] { h.ticks += 1; });\n}",
               "  team_serial(T, [&] { h.ticks += 1; });\n  PHASE(11)\n}")
    src = _sub(src, "    if (obs != nullptr)\n      for (int a = 0;",
               "    PHASE_START\n    if (obs != nullptr)\n      for (int a = 0;")
    src = _sub(src, "                       e.keys(), e.sel());\n",
               "                       e.keys(), e.sel());\n    PHASE(12)\n")
    return src + READER


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_phase_cycles: no CUDA device", file=sys.stderr)
        return 2
    d = os.path.join(ROOT, ".kernel_build", "phase_cycles")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "agarcl_tpu_torch"),
                    os.path.join(d, "agarcl_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    tick = os.path.join(d, "agarcl_tpu_torch", "csrc", "tick.cu")
    with open(tick) as f:
        src = f.read()
    with open(tick, "w") as f:
        f.write(timed_source(src))
    sys.path.insert(0, d)
    from agarcl_tpu_torch import EnvConfig
    from agarcl_tpu_torch.env import env_reset, reset_seeds
    from agarcl_tpu_torch.obs.ram import RamObsConfig
    from agarcl_tpu_torch.ops import _build
    from agarcl_tpu_torch.ops import fused_tick as FT
    sys.path.insert(1, ROOT)
    from chip_smoke import _gpu_line
    gpu = _gpu_line()
    lib = _build.load()
    lib.agarcl_phase_read.argtypes = [ctypes.c_void_p]
    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=350,
                    num_pellets=500, num_viruses=10, mode=4)
    dev = torch.device("cuda", 0)
    out = (ctypes.c_ulonglong * 16)()
    for n in (8192, 1):
        planes = FT.to_kernel_arrays(env_reset(cfg, reset_seeds(n, 0, dev)))
        g = torch.Generator(device=dev).manual_seed(0)
        acts = torch.cat([torch.rand((n, 1, 2), device=dev, generator=g) * 2
                          - 1, torch.randint(0, 3, (n, 1, 1), device=dev,
                                             generator=g).float()], -1)
        FT.multi_step_raw(cfg, planes, acts, 10, RamObsConfig())
        torch.cuda.synchronize(dev)
        lib.agarcl_phase_read(out)
        FT.multi_step_raw(cfg, planes, acts, 40, RamObsConfig())
        torch.cuda.synchronize(dev)
        lib.agarcl_phase_read(out)
        per_tick = [out[k] / (n * 160) for k in range(12)]
        print(f"{n} envs: lane-0 cycles per env and tick: "
              + ", ".join(f"{name} {c:.0f}"
                          for name, c in zip(PHASES, per_tick))
              + f" (sum {sum(per_tick):.0f}); RAM frame "
              f"{out[12] / (n * 40):.0f} per env and step | {gpu}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

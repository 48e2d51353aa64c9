"""Where K3's and K4's time goes: thread 0's clock64() cycles per phase of
the screen frame (csrc/screen.cu) and the grid frame (csrc/grid.cu) on one
GPU, with each kernel's static SASS instruction counts and its resident
blocks per SM.

Builds a timed copy of agarcl_tpu_torch (the package of the current
directory) under .kernel_build/frame_cycles/ (gitignored). In the copy,
every statement `BARRIER();` that begins a line of screen_env or
grid_env ends a phase: thread 0 adds the cycles since its last reading
into that barrier's slot of a device array (a barrier inside a loop adds
up over the iterations), and a last barrier and reading close the
function. A phase's cycles are those of the block's slowest warp (the
barrier waits for it), with the SM shared by every resident block. The
labels come from the comment on each barrier line, or, for a source
without them (an older tree), from the list below. The shipped kernels are
not changed.

Then it draws frames of the bench.py game (mode 4, arena 350, 500
pellets, 10 viruses) after 10 steps of random actions, at 8192 envs: K3
at 128 x 128 agent view, in poly mode, and at 84 x 84 natural RGB; K4 at
64 x 64 int16 and 128 x 128 int32; and prints, per configuration, the
cycles per frame of each phase and their sum. Last, the static SASS
instructions of each kernel instantiation (`cuobjdump -sass` of the
shipped build, where the toolkit has it) and of each timed phase (the
instructions between two clock readings of the timed build), and
resident blocks per SM from the occupancy API.

    python3 scripts/frame_phase_cycles.py

Times the package of the current directory, so one copy of the script
can time two trees unpacked with `git archive` (cd into each). Exits
non-zero without a CUDA device.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys

ROOT = os.getcwd()
# phase labels of sources without barrier comments (the first K3 and K4)
OLD_LABELS = {
    "screen": ["camera", "tables+flags", "grid class map", "pellets",
               "foods", "cells", "viruses", "palette store"],
    "grid": ["camera+clear", "flags+bins+list", "output"],
}
TIMERS = """
#ifdef __CUDACC__
__device__ unsigned long long g_phase_{tag}[16];
#endif
#ifdef __CUDA_ARCH__
#define PHASE_START long long t0_ = clock64();
#define PHASE(k) if (tid == 0) {{ const long long t1_ = clock64(); \\
  atomicAdd(&g_phase_{tag}[k], (unsigned long long)(t1_ - t0_)); \\
  t0_ = t1_; }}
#else
#define PHASE_START
#define PHASE(k)
#endif
"""
READER = """
#ifdef __CUDACC__
extern "C" void agarcl_{tag}_phase_read(unsigned long long* out) {{
  static const unsigned long long zero[16] = {{0}};
  cudaMemcpyFromSymbol(out, agarcl::g_phase_{tag}, sizeof(zero));
  cudaMemcpyToSymbol(agarcl::g_phase_{tag}, zero, sizeof(zero));
}}
{occupancy}
#endif
"""
# resident blocks per SM in the timed build, for a source without
# agarcl_screen_shape / agarcl_grid_shape (an older tree)
OCC_FN = """
extern "C" int agarcl_{tag}_timed_occupancy(int size, int variant,
                                            int* blocks) {{
  {body}
}}
"""
OCC_SCREEN = """
  void (*k[4])(agarcl::EnvParams, agarcl::ScreenParams, agarcl::Planes,
               uint8_t*, int) = {
      agarcl::screen_kernel<false, false>, agarcl::screen_kernel<false, true>,
      agarcl::screen_kernel<true, false>, agarcl::screen_kernel<true, true>};
  const int smem = int(agarcl::screen_scratch(size));
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(k[variant],
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k[variant], agarcl::SCREEN_THREADS, smem));"""
OCC_GRID = """
  void (*k[2])(agarcl::EnvParams, agarcl::GridParams, agarcl::Planes,
               uint8_t*, int) = {agarcl::grid_kernel<false>,
                                 agarcl::grid_kernel<true>};
  const int smem = int(agarcl::grid_scratch(size));
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(k[variant],
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k[variant], agarcl::GRID_THREADS, smem));"""


def timed_source(src: str, fn: str, tag: str, occupancy: str):
    """(source with the phase timers in function `fn`, phase labels)."""
    start = src.index(f"HD void {fn}(")
    body0 = src.index("{\n", start) + 2
    end = src.index("\n}\n", body0)
    body = src[body0:end]
    labels = []

    def mark(m):
        labels.append(m.group(2).strip().lstrip("/").strip())
        return (f"{m.group(1)}BARRIER();{m.group(2)}\n"
                f"{m.group(1)}PHASE({len(labels) - 1})")
    body = re.sub(r"^( *)BARRIER\(\);(.*)$", mark, body, flags=re.M)
    labels.append("to the end")
    body = (f"  PHASE_START\n{body}\n  BARRIER();\n"
            f"  PHASE({len(labels) - 1})")
    if not all(labels[:-1]):
        labels = OLD_LABELS[tag]
    src = src[:body0] + body + src[end:]
    src = src.replace("namespace agarcl {\n",
                      "namespace agarcl {\n" + TIMERS.format(tag=tag), 1)
    occ = ("" if f"agarcl_{tag}_shape" in src
           else OCC_FN.format(tag=tag, body=occupancy))
    return src + READER.format(tag=tag, occupancy=occ), labels


def sass_counts(so: str, cuobjdump: str):
    """{kernel name: (instructions, [instructions between clock
    readings])} from cuobjdump -sass, or None without cuobjdump."""
    if not os.path.exists(cuobjdump):
        return None
    out = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                         text=True, timeout=300).stdout
    res = {}
    for part in re.split(r"\n\s*Function : ", out)[1:]:
        name = part.split("\n", 1)[0].strip()
        if "screen_kernel" not in name and "grid_kernel" not in name:
            continue
        inst = [ln for ln in part.splitlines()
                if re.search(r"/\*[0-9a-f]{4}\*/", ln)]
        segs, n = [], 0
        for ln in inst:
            n += 1
            if "SR_CLOCK" in ln:
                segs.append(n)
                n = 0
        res[name] = (len(inst), segs)
    return res


def _short(name: str) -> str:
    kind = "K3" if "screen_kernel" in name else "K4"
    flags = re.findall(r"Lb([01])E", name)
    if kind == "K3" and len(flags) >= 2:
        return (f"K3 {'poly' if flags[0] == '1' else 'circles'} "
                f"{'multi' if flags[1] == '1' else 'one'}-agent")
    elem = re.findall(r"Li([124])E", name)
    return (f"K4 {'multi' if flags and flags[0] == '1' else 'one'}-agent"
            + (f" {elem[0]}-byte" if elem else ""))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("frame_phase_cycles: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from agarcl_tpu_torch.ops import _build as shipped
    shipped_lib = shipped.load()
    shipped_so = str(shipped.BUILD_ROOT / shipped._digest(shipped._nvcc())
                     / "libagarcl_kernels.so")
    d = os.path.join(ROOT, ".kernel_build", "frame_cycles")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "agarcl_tpu_torch"),
                    os.path.join(d, "agarcl_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    labels = {}
    for tag, fn, occ in (("screen", "screen_env", OCC_SCREEN),
                         ("grid", "grid_env", OCC_GRID)):
        path = os.path.join(d, "agarcl_tpu_torch", "csrc", f"{tag}.cu")
        with open(path) as f:
            src, labels[tag] = timed_source(f.read(), fn, tag, occ)
        with open(path, "w") as f:
            f.write(src)
    for m in [m for m in sys.modules if m.startswith("agarcl_tpu_torch")]:
        del sys.modules[m]
    sys.path[0] = d
    from agarcl_tpu_torch import EnvConfig
    from agarcl_tpu_torch.env import env_reset, reset_seeds
    from agarcl_tpu_torch.obs.grid import GridObsConfig
    from agarcl_tpu_torch.obs.screen import ScreenObsConfig
    from agarcl_tpu_torch.ops import _build
    from agarcl_tpu_torch.ops import fused_grid as FG
    from agarcl_tpu_torch.ops import fused_screen as FS
    from agarcl_tpu_torch.ops import fused_tick as FT
    sys.path.insert(1, ROOT)
    from chip_smoke import _gpu_line
    gpu = _gpu_line()
    lib = _build.load()
    ull = ctypes.c_void_p
    for tag in ("screen", "grid"):
        getattr(lib, f"agarcl_{tag}_phase_read").argtypes = [ull]
        if not hasattr(shipped_lib, f"agarcl_{tag}_shape"):
            getattr(lib, f"agarcl_{tag}_timed_occupancy").argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=350,
                    num_pellets=500, num_viruses=10, mode=4)
    dev = torch.device("cuda", 0)
    n = 8192
    planes = FT.to_kernel_arrays(env_reset(cfg, reset_seeds(n, 0, dev)))
    g = torch.Generator(device=dev).manual_seed(0)
    acts = torch.cat([torch.rand((n, 1, 2), device=dev, generator=g) * 2
                      - 1, torch.randint(0, 3, (n, 1, 1), device=dev,
                                         generator=g).float()], -1)
    FT.multi_step_raw(cfg, planes, acts, 10, None)
    out = (ctypes.c_ulonglong * 16)()
    poly = ScreenObsConfig(128, agent_view=True, polygon_edges=True,
                           polygon_virus="circle")
    cases = [("screen", "K3 128 agent view", ScreenObsConfig(
                 128, agent_view=True), 0, 128),
             ("screen", "K3 128 poly", poly, 2, 128),
             ("screen", "K3 84 natural RGB", ScreenObsConfig(
                 84, agent_view=False), 0, 84),
             ("grid", "K4 64 int16", GridObsConfig(
                 grid_size=64, out_dtype="int16"), 0, 64),
             ("grid", "K4 128 int32", GridObsConfig(
                 grid_size=128, out_dtype="int32"), 0, 128)]
    calls = 5
    for tag, label, oc, variant, size in cases:
        frame = (FS.fused_screen_frame if tag == "screen"
                 else FG.fused_grid_frame)
        read = getattr(lib, f"agarcl_{tag}_phase_read")
        frame(cfg, oc, planes)
        torch.cuda.synchronize(dev)
        read(out)
        for _ in range(calls):
            frame(cfg, oc, planes)
        torch.cuda.synchronize(dev)
        read(out)
        names = labels[tag]
        per = [out[k] / (n * calls) for k in range(len(names))]
        if hasattr(shipped_lib, f"agarcl_{tag}_shape"):
            mod = FS if tag == "screen" else FG
            shape = (ctypes.c_int * 4)()
            st = getattr(shipped_lib, f"agarcl_{tag}_shape")(
                ctypes.byref(mod.launch_params(cfg, oc)[1]), n, shape)
            occ = (f"{shape[3]} resident blocks per SM of {shape[1]} "
                   f"threads, {shape[2]} shared bytes (shipped build)")
        else:
            blocks = (ctypes.c_int * 1)()
            st = getattr(lib, f"agarcl_{tag}_timed_occupancy")(
                size, variant, blocks)
            occ = f"{blocks[0]} resident blocks per SM (timed build)"
        if st != 0:
            occ = f"occupancy API error {st}"
        print(f"{label}, {n} envs: thread-0 cycles per frame: "
              + ", ".join(f"{name} {c:.0f}" for name, c in zip(names, per))
              + f" (sum {sum(per):.0f}); {occ} | {gpu}", flush=True)
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    timed_so = str(_build.BUILD_ROOT / _build._digest(_build._nvcc())
                   / "libagarcl_kernels.so")
    shipped_sass = sass_counts(shipped_so, cuobjdump)
    timed_sass = sass_counts(timed_so, cuobjdump)
    if shipped_sass is None:
        print(f"SASS: {cuobjdump} not found: not measured", flush=True)
        return 0
    for name, (total, _) in sorted(shipped_sass.items()):
        segs = timed_sass.get(name, (0, []))[1]
        print(f"SASS {_short(name)}: {total} instructions in the shipped "
              f"build; timed build, instructions between clock readings "
              f"(static, in source order): {segs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build the CUDA kernels of csrc/ with nvcc at first use and load them
with ctypes.

The library is compiled for sm_90a (Hopper) with a plain C interface, so no
PyTorch header is compiled: one nvcc per source, all started together, then
one link, so a cold build takes seconds. It goes to
`.kernel_build/<hash of the sources, flags and nvcc version>/` under the
repository root (listed in .gitignore), so a changed source or compiler
rebuilds and an unchanged one loads the existing library. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / ".kernel_build"
SOURCES = ("ram_frame.cu", "tick.cu", "screen.cu", "grid.cu")
HEADERS = ("common.cuh", "team.cuh", "ram_frame.cuh")
# --fmad=false: no contraction of a*b+c except the explicit __fmaf_rn sites
# (engine/geometry.py FMA contract); IEEE division and sqrt are nvcc's
# defaults and --use_fast_math is never given. -Xptxas -v reports each
# kernel's registers and shared memory (build_log).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_seconds = None     # wall time of the build this process ran, if any
build_log = ""           # ptxas report of that build


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (set CUDA_HOME or put nvcc on PATH)")
    return found


def nvcc_version(nvcc: str) -> str:
    """`nvcc --version` output; raises if nvcc does not run."""
    proc = subprocess.run([nvcc, "--version"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"{nvcc} --version failed: {proc.stderr}")
    return proc.stdout.strip()


def _digest(nvcc: str) -> str:
    """Build key: the sources, the flags and the compiler's version, so a
    changed toolchain rebuilds instead of loading another nvcc's library."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc_version(nvcc).encode())
    return h.hexdigest()[:16]


def _declare(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.agarcl_ram_frame.argtypes = [vp, vp, vp, i32, vp]
    lib.agarcl_ram_frame.restype = i32
    lib.agarcl_multi_step.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32, i32,
                                      i32, vp]
    lib.agarcl_multi_step.restype = i32
    lib.agarcl_multi_step_shape.argtypes = [vp, i32, vp]
    lib.agarcl_multi_step_shape.restype = i32
    lib.agarcl_screen.argtypes = [vp, vp, vp, vp, i32, vp]
    lib.agarcl_screen.restype = i32
    lib.agarcl_grid.argtypes = [vp, vp, vp, vp, i32, vp]
    lib.agarcl_grid.restype = i32
    lib.agarcl_screen_shape.argtypes = [vp, i32, vp]
    lib.agarcl_screen_shape.restype = i32
    lib.agarcl_grid_shape.argtypes = [vp, i32, vp]
    lib.agarcl_grid_shape.restype = i32
    lib.agarcl_error_string.argtypes = [i32]
    lib.agarcl_error_string.restype = ctypes.c_char_p


def _run_all(cmds) -> str:
    """Run the commands side by side; raise on the first failure, else
    return their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def load():
    """The loaded kernel library, building it first if needed."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        nvcc = _nvcc()
        out_dir = BUILD_ROOT / _digest(nvcc)
        so = out_dir / "libagarcl_kernels.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tag = os.getpid()
            objs = [out_dir / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
            tmp = out_dir / f"libagarcl_kernels.{tag}.so"
            t0 = time.perf_counter()
            build_log = _run_all(
                [[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
                 for s, o in zip(SOURCES, objs)])
            _run_all([[nvcc, "-shared", "-o", str(tmp),
                       *(str(o) for o in objs)]])
            os.replace(tmp, so)
            for o in objs:
                o.unlink()
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _lib = lib
        return lib


def check(lib, status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if status != 0:
        msg = lib.agarcl_error_string(status).decode()
        raise RuntimeError(f"{what} failed: CUDA error {status} ({msg})")

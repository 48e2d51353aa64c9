"""ctypes binding for the C++ parity oracle (counterpart of oracle.py).

The oracle (oracle/oracle.cpp) is an independent scalar implementation of
the pinned tick spec (SPEC.md), so it witnesses the port's engine and K1
without JAX: the same seed and actions through both, then the integer
fields compared exactly and the positions within a tolerance
(tests/test_torch_oracle.py, chip_smoke.py).

The library is compiled from the checkout's oracle/oracle.cpp (or from
$AGARCL_ORACLE_DIR/oracle.cpp) with oracle/Makefile's flags into
.kernel_build/oracle/ at first use, and rebuilt when the source is newer
than it. The tracked oracle/liboracle.so is never written. A missing
source or compiler raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.ops._build import BUILD_ROOT

ORACLE_DIR = os.environ.get("AGARCL_ORACLE_DIR") or str(
    BUILD_ROOT.parent / "oracle")
LIB_PATH = BUILD_ROOT / "oracle" / "liboracle.so"
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")  # Makefile's

_lock = threading.Lock()
_lib = None


def build() -> str:
    """Path of the oracle library, compiled first if it is missing or
    older than its source."""
    src = os.path.join(ORACLE_DIR, "oracle.cpp")
    if not os.path.exists(src):
        raise FileNotFoundError(
            f"parity oracle source not found: {src} (run from a checkout, "
            "or set AGARCL_ORACLE_DIR to the oracle/ directory)")
    if LIB_PATH.exists() and (os.path.getmtime(LIB_PATH)
                              >= os.path.getmtime(src)):
        return str(LIB_PATH)
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: the parity "
                           f"oracle ({src}) cannot be built")
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"liboracle.{os.getpid()}.so")
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the parity oracle failed:\n"
                           f"{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return str(LIB_PATH)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.oracle_create.restype = ctypes.c_void_p
        lib.oracle_create.argtypes = [ctypes.c_int] * 13 + [
            ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 8
        lib.oracle_destroy.argtypes = [ctypes.c_void_p]
        lib.oracle_reset.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.oracle_tick.argtypes = [ctypes.c_void_p]
        lib.oracle_step.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_double),
                                    ctypes.POINTER(ctypes.c_uint8)]
        F = ctypes.POINTER(ctypes.c_float)
        I = ctypes.POINTER(ctypes.c_int)
        U = ctypes.POINTER(ctypes.c_uint8)
        lib.oracle_get_state.argtypes = (
            [ctypes.c_void_p]
            + [F, I, I, I, I, I, F, I, I, I, I]      # player fields
            + [F, F, F, I, U, I, I]                  # cell fields
            + [F, U]                                 # pellets
            + [F, F, I, I, U]                        # viruses
            + [F, F, U]                              # foods
            + [ctypes.POINTER(ctypes.c_int64)])
        _lib = lib
        return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class OracleEnv:
    """Scalar single-env oracle with the reset / step API of env.py."""

    def __init__(self, cfg: EnvConfig):
        self.cfg = cfg
        lib = _load()
        ms = cfg.mode_spec
        self._bots = np.asarray(cfg.bot_types(), np.int32)
        self._h = lib.oracle_create(
            cfg.num_agents, cfg.ticks_per_step, cfg.arena_size,
            cfg.num_pellets, cfg.num_viruses, cfg.mode,
            int(cfg.reward_type), cfg.c_death, cfg.max_cells,
            cfg.pellet_capacity, cfg.virus_capacity, cfg.food_capacity,
            cfg.virus_ticks_capacity,
            _ptr(self._bots, ctypes.c_int), cfg.num_players,
            int(ms.mass_decay), int(ms.squared_pellets), int(ms.pellet_regen),
            ms.agent_mass, int(ms.respawn_all), int(ms.done_on_death),
            int(ms.done_on_max_mass))
        self._lib = lib

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.oracle_destroy(self._h)
            self._h = None

    def reset(self, seed: int):
        self._lib.oracle_reset(self._h, ctypes.c_uint32(seed))

    def tick(self):
        self._lib.oracle_tick(self._h)

    def step(self, actions):
        """actions: (A, 3) -> (rewards (A,) f64, dones (A,) bool)."""
        A = self.cfg.num_agents
        acts = np.ascontiguousarray(np.asarray(actions, np.float32)
                                    .reshape(A, 3))
        rewards = np.zeros((A,), np.float64)
        dones = np.zeros((A,), np.uint8)
        self._lib.oracle_step(self._h, _ptr(acts, ctypes.c_float),
                              _ptr(rewards, ctypes.c_double),
                              _ptr(dones, ctypes.c_uint8))
        return rewards, dones.astype(bool)

    def get_state(self) -> dict:
        """The full state as numpy arrays shaped like one env of a
        GameState, with pellet_key encoded as state.py encodes it."""
        cfg = self.cfg
        P, Cc = cfg.num_players, cfg.max_cells
        Np, Nv, Nf = cfg.pellet_capacity, cfg.virus_capacity, cfg.food_capacity
        out = dict(
            target=np.zeros((P, 2), np.float32),
            action=np.zeros((P,), np.int32),
            split_cooldown=np.zeros((P,), np.int32),
            feed_cooldown=np.zeros((P,), np.int32),
            elapsed_ticks=np.zeros((P,), np.int32),
            last_decay_tick=np.zeros((P,), np.int32),
            anti_team_decay=np.zeros((P,), np.float32),
            food_eaten=np.zeros((P,), np.int32),
            highest_mass=np.zeros((P,), np.int32),
            cells_eaten=np.zeros((P,), np.int32),
            viruses_eaten=np.zeros((P,), np.int32),
            cell_pos=np.zeros((P, Cc, 2), np.float32),
            cell_vel=np.zeros((P, Cc, 2), np.float32),
            cell_split_vel=np.zeros((P, Cc, 2), np.float32),
            cell_mass=np.zeros((P, Cc), np.int32),
            cell_alive=np.zeros((P, Cc), np.uint8),
            cell_id=np.zeros((P, Cc), np.int32),
            cell_recombine_at=np.zeros((P, Cc), np.int32),
            pellet_pos=np.zeros((Np, 2), np.float32),
            _pellet_alive=np.zeros((Np,), np.uint8),
            virus_pos=np.zeros((Nv, 2), np.float32),
            virus_vel=np.zeros((Nv, 2), np.float32),
            virus_mass=np.zeros((Nv,), np.int32),
            virus_hits=np.zeros((Nv,), np.int32),
            virus_alive=np.zeros((Nv,), np.uint8),
            food_pos=np.zeros((Nf, 2), np.float32),
            food_vel=np.zeros((Nf, 2), np.float32),
            food_alive=np.zeros((Nf,), np.uint8),
            ticks=np.zeros((1,), np.int64),
        )
        f32, i32, u8 = ctypes.c_float, ctypes.c_int, ctypes.c_uint8
        self._lib.oracle_get_state(
            self._h,
            _ptr(out["target"], f32), _ptr(out["action"], i32),
            _ptr(out["split_cooldown"], i32), _ptr(out["feed_cooldown"], i32),
            _ptr(out["elapsed_ticks"], i32), _ptr(out["last_decay_tick"], i32),
            _ptr(out["anti_team_decay"], f32), _ptr(out["food_eaten"], i32),
            _ptr(out["highest_mass"], i32), _ptr(out["cells_eaten"], i32),
            _ptr(out["viruses_eaten"], i32),
            _ptr(out["cell_pos"], f32), _ptr(out["cell_vel"], f32),
            _ptr(out["cell_split_vel"], f32), _ptr(out["cell_mass"], i32),
            _ptr(out["cell_alive"], u8), _ptr(out["cell_id"], i32),
            _ptr(out["cell_recombine_at"], i32),
            _ptr(out["pellet_pos"], f32), _ptr(out["_pellet_alive"], u8),
            _ptr(out["virus_pos"], f32), _ptr(out["virus_vel"], f32),
            _ptr(out["virus_mass"], i32), _ptr(out["virus_hits"], i32),
            _ptr(out["virus_alive"], u8),
            _ptr(out["food_pos"], f32), _ptr(out["food_vel"], f32),
            _ptr(out["food_alive"], u8),
            out["ticks"].ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        # the oracle stores pre-quantized pellet coordinates, so the key
        # encoding of state.py is exact
        alive = out.pop("_pellet_alive").astype(bool)
        out["pellet_alive"] = alive
        sx = np.float32(32768.0 / cfg.arena_width)
        sy = np.float32(32768.0 / cfg.arena_height)
        qx = np.clip(np.floor(out["pellet_pos"][:, 0] * sx), 0,
                     32767).astype(np.int32)
        qy = np.clip(np.floor(out["pellet_pos"][:, 1] * sy), 0,
                     32767).astype(np.int32)
        out["pellet_key"] = np.where(alive, (qx << 15) | qy, np.int32(-1))
        return out

"""RAM frame from kernel-layout planes (counterpart of ops/fused_obs.py).

Kernel K2 (csrc/ram_frame.cu) replaces the TPU kernel
agarcl_tpu/ops/fused_obs.py::_make_obs_kernel (launched by fused_ram_obs,
body obs_rows / _nearest_rows): one CUDA thread per (env, agent) builds the
whole feature vector of obs/ram.py, picking the k nearest pellets and
viruses as the smallest unique packed keys (obs/ram.py::pack_nearest_key)
one at a time. The same device function writes the frames inside the
multi-step tick kernel K1.

`fused_ram_obs` launches K2 for CUDA planes and runs the plain version,
obs/ram.py::ram_frame, only for CPU planes. `launches` counts K2 launches.
"""

from __future__ import annotations

import ctypes

import torch

from agarcl_tpu_torch.config import EnvConfig
from agarcl_tpu_torch.obs.ram import RamObsConfig, ram_frame, ram_size
from agarcl_tpu_torch.ops import _build
from agarcl_tpu_torch.ops import params as KP
from agarcl_tpu_torch.ops.fused_tick import (_ptr_array, check_planes,
                                             from_kernel_arrays)
from agarcl_tpu_torch.state import zero_state

launches = 0          # K2 launches
plain_calls = 0       # plain ram_frame calls made by fused_ram_obs


def supports(cfg: EnvConfig) -> bool:
    return (cfg.max_cells == KP.MAX_CELLS
            and cfg.num_players <= KP.MAX_PLAYERS)


def fused_ram_obs(cfg: EnvConfig, ocfg: RamObsConfig, planes) -> torch.Tensor:
    """(N, A, ram_size) f32 RAM frame of kernel-layout planes
    (ops/fused_tick.py::to_kernel_arrays)."""
    global launches, plain_calls
    if not supports(cfg):
        raise NotImplementedError("the RAM-frame kernel takes 16 cell slots "
                                  f"and at most {KP.MAX_PLAYERS} players")
    dev = planes[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    N = check_planes(cfg, planes)
    if dev.type == "cpu":
        plain_calls += 1
        state = from_kernel_arrays(zero_state(cfg, N, dev), planes)
        return ram_frame(cfg, ocfg, state)
    out = torch.empty((N, cfg.num_agents, ram_size(cfg, ocfg)),
                      dtype=torch.float32, device=dev)
    lib = _build.load()
    prm = KP.env_params(cfg, ocfg)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.agarcl_ram_frame(ctypes.byref(prm), _ptr_array(planes),
                                  out.data_ptr(), N, stream)
    _build.check(lib, status, "RAM-frame kernel")
    launches += 1
    return out

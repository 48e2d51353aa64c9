"""Snapshots, checkpoints and video (counterpart of agarcl_tpu/io)."""

from agarcl_tpu_torch.io.snapshot import load_env_state, save_env_state

__all__ = ["save_env_state", "load_env_state"]

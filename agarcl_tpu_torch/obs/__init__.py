"""Part of the agarcl_tpu_torch port; see the package docstring."""

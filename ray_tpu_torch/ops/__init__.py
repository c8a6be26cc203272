"""Compute ops of the port: attention (reference, flash) and the CUDA
kernels behind them (``csrc/``, built by ``_build``)."""

from ray_tpu_torch.ops.attention import attention

__all__ = ["attention"]

"""Compute ops of the port: attention (reference, flash, ring), the CUDA
kernels behind them (``csrc/``, built by ``_build``), ring attention
(``ring_attention``) and the MoE block (``moe``) over ``torch.distributed``
groups."""

from ray_tpu_torch.ops.attention import attention

__all__ = ["attention"]

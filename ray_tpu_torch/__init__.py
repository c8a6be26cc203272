"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's device layer.

``ray_tpu`` (JAX, Pallas kernels for the TPU) stays the reference. This
package is its counterpart for one NVIDIA H100: plain tensor code is
PyTorch, and every Pallas kernel on a ported path is a CUDA C++ kernel
written by hand for Hopper (``ops/csrc/``), built with nvcc at first use.

The package imports torch and numpy only: nothing of JAX and nothing of
``ray_tpu``. Modules mirror the JAX package's layout (``models/gpt2.py``,
``ops/attention.py``, ``ops/flash_attention.py``).
"""

from ray_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]

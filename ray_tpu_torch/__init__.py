"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu.

``ray_tpu`` (JAX, Pallas kernels for the TPU) stays the reference. This
package is its counterpart for NVIDIA H100 cards: plain tensor code is
PyTorch, and every Pallas kernel on a ported path is a CUDA C++ kernel
written by hand for Hopper (``ops/csrc/``), built with nvcc at first use.
The runtime under it (``core/``, ``data/``, ``utils/``, ``observability/``)
is a copy of the JAX package's, pinned file by file
(``tests/test_torch_runtime_copy.py``); ``accelerators/`` counts NVIDIA
cards instead of TPU chips.

The package imports torch and numpy only: nothing of JAX and nothing of
``ray_tpu``. Importing it imports no torch either: the core API below is
torch-free, so a worker process of the cluster pays for torch only when a
task uses it. The device modules (``models``, ``ops``, ``parallel``,
``serve``) and ``resolve_device`` load on first use.

Public core API, as ``ray_tpu``'s: ``init/remote/get/put/wait/kill/cancel``
and the rest below.
"""

from ray_tpu_torch._version import __version__

from ray_tpu_torch.core.api import (
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    get_runtime_context,
    init,
    is_initialized,
    kill,
    method,
    nodes,
    put,
    remote,
    shutdown,
    wait,
)
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.placement import (
    PlacementGroup,
    placement_group,
    remove_placement_group,
)
from ray_tpu_torch.core import exceptions

_SUBPACKAGES = ("dag", "data", "models", "ops", "parallel", "serve", "accelerators")


def __getattr__(name):
    # Lazy subpackages (`ray_tpu_torch.data` after `import ray_tpu_torch`)
    # and resolve_device: the device modules import torch.
    import importlib

    if name == "resolve_device":
        from ray_tpu_torch.device import resolve_device

        return resolve_device
    if name in _SUBPACKAGES:
        try:
            mod = importlib.import_module(f"ray_tpu_torch.{name}")
        except ImportError as e:
            # AttributeError keeps hasattr()-style feature probes working.
            raise AttributeError(
                f"module 'ray_tpu_torch' has no attribute {name!r}"
            ) from e
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


__all__ = [
    "__version__",
    "ObjectRef",
    "PlacementGroup",
    "available_resources",
    "cluster_resources",
    "nodes",
    "cancel",
    "exceptions",
    "get",
    "get_actor",
    "get_runtime_context",
    "init",
    "is_initialized",
    "kill",
    "method",
    "placement_group",
    "put",
    "remote",
    "remove_placement_group",
    "resolve_device",
    "shutdown",
    "wait",
]

"""Ambient mesh context: lets model code find the mesh it runs under
without threading it through every call signature (counterpart of
``ray_tpu/parallel/context.py``)."""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

from torch.distributed.device_mesh import DeviceMesh

_state = threading.local()


def current_mesh() -> Optional[DeviceMesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh):
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev

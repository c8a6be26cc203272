"""Where the port's entry points run.

The port is written for an NVIDIA Hopper card. Its entry points run on
``cuda`` unless the caller asks for the CPU by name (the CPU tests do, to
hold the port to the JAX package). With no CUDA device and no explicit
CPU request they raise: nothing carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> ``cuda`` (raises without CUDA); ``"cpu"`` is taken as asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")

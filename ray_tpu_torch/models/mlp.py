"""MLP classifier — BASELINE.md config 1 (Fashion-MNIST MLP, the
reference's PR1 Train example, python/ray/train test fixtures).

Counterpart of ``ray_tpu/models/mlp.py``: the same layers (``x @ kernel +
bias``, ReLU between them), the same He-normal init scale and zero biases,
the same loss and accuracy. Each layer's parameters keep the JAX pytree's
names and layout (``layer{i}.kernel`` [in, out], ``layer{i}.bias``), so
``from_jax`` and ``to_jax`` move values across by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: Sequence[int] = (128, 128)
    num_classes: int = 10
    dtype: torch.dtype = torch.float32

    @property
    def dims(self) -> list:
        return [self.in_dim, *self.hidden, self.num_classes]


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device))


class MLP(nn.Module):
    """Layers ``layer0`` ... ``layer{n-1}``, zero until ``init`` or
    ``from_jax`` fills them."""

    def __init__(self, cfg: MLPConfig, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dims = cfg.dims
        self.n = len(dims) - 1
        for i in range(self.n):
            self.add_module(f"layer{i}", Dense(dims[i], dims[i + 1], cfg.dtype, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            layer = getattr(self, f"layer{i}")
            x = x @ layer.kernel + layer.bias
            if i < self.n - 1:
                x = F.relu(x)
        return x


def init(generator: torch.Generator, cfg: MLPConfig, device: DeviceLike = None) -> MLP:
    """He-normal kernels (N(0, 1) x sqrt(2 / fan_in)) drawn from
    ``generator`` (on ``device``), layer by layer; zero biases."""
    model = MLP(cfg, device)
    dims = cfg.dims
    with torch.no_grad():
        for i in range(model.n):
            k = torch.randn(dims[i], dims[i + 1], generator=generator,
                            device=generator.device) * (2.0 / dims[i]) ** 0.5
            getattr(model, f"layer{i}").kernel.copy_(k.to(cfg.dtype))
    return model


def loss_fn(model: MLP, batch) -> torch.Tensor:
    """Mean negative log-likelihood of the labels (``jax.nn.log_softmax``
    and ``take_along_axis`` in the JAX package)."""
    x, y = batch
    logp = F.log_softmax(model(x), dim=-1)
    return -logp.gather(-1, y[:, None].long())[:, 0].mean()


def accuracy(model: MLP, batch) -> torch.Tensor:
    x, y = batch
    return (model(x).argmax(-1) == y).float().mean()


def from_jax(params: Dict[str, Any], cfg: MLPConfig, device: DeviceLike = None) -> MLP:
    """A model holding the JAX ``mlp.init`` pytree's values (numpy leaves
    ``layer{i}.kernel`` [in, out] and ``layer{i}.bias``)."""
    model = MLP(cfg, device)
    own = dict(model.named_parameters())
    with torch.no_grad():
        for layer, leaves in params.items():
            for name, leaf in leaves.items():
                own.pop(f"{layer}.{name}").copy_(torch.from_numpy(np.array(leaf, dtype=np.float32)))
    if own:
        raise ValueError(f"JAX pytree lacks {sorted(own)}")
    return model


def to_jax(model: MLP, grads: bool = False) -> Dict[str, Any]:
    """The model's parameters (or, with ``grads``, their .grad) in the JAX
    pytree layout, as f32 numpy arrays."""
    out: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        layer, leaf = name.split(".")
        t = p.grad if grads else p
        out.setdefault(layer, {})[leaf] = t.detach().float().cpu().numpy()
    return out

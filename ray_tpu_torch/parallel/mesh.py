"""The device mesh with the standard parallelism axes.

Counterpart of ``ray_tpu/parallel/mesh.py``. The axes and their meanings
are the JAX package's:

  dcn   data parallelism across slices (outermost)
  dp    data parallelism (batch split; gradients averaged)
  fsdp  parameter sharding, ZeRO-3 style (FSDP2 gathers and scatters)
  ep    expert parallelism (MoE all-to-all)
  cp    context parallelism (sequence split; ring attention)
  tp    tensor parallelism, Megatron style (innermost)

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, one named dimension per axis in ``AXIS_ORDER``,
most of them of size 1. Ranks are laid out as the JAX package lays out CPU
devices (``np.array(devices).reshape(shape)``): dcn varies slowest and tp
fastest, so the ranks of one tp group are neighbours (on one host, the
cards that share the fastest links).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.device import resolve_device

AXIS_ORDER = ("dcn", "dp", "fsdp", "ep", "cp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes per axis; -1 on exactly one axis means "absorb the rest"."""

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    cp: int = 1
    ep: int = 1
    dcn: int = 1

    def resolve(self, num_devices: int) -> Dict[str, int]:
        sizes = {
            "dcn": self.dcn, "dp": self.dp, "fsdp": self.fsdp,
            "ep": self.ep, "cp": self.cp, "tp": self.tp,
        }
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"only one axis may be -1, got {wild}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if num_devices % fixed != 0:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes {fixed}"
                )
            sizes[wild[0]] = num_devices // fixed
        if math.prod(sizes.values()) != num_devices:
            raise ValueError(
                f"mesh {sizes} does not cover {num_devices} devices"
            )
        return sizes


def rank_layout(config: MeshConfig, ranks: Sequence[int]) -> np.ndarray:
    """The ranks as an array of the mesh's shape (axes in AXIS_ORDER)."""
    sizes = config.resolve(len(ranks))
    return np.array(ranks).reshape(tuple(sizes[a] for a in AXIS_ORDER))


def build_mesh(config: Optional[MeshConfig] = None, ranks: Optional[Sequence[int]] = None,
               device_type: Optional[str] = None) -> DeviceMesh:
    """A DeviceMesh over ``ranks`` (default: every rank of the default
    process group) with the dimensions of AXIS_ORDER. Every rank of the
    default group must call it, with the same arguments: the mesh creates a
    process group per dimension. A rank outside ``ranks`` gets a mesh it has
    no coordinate in. ``device_type`` is ``cuda`` unless the caller asks
    for ``cpu``."""
    device = resolve_device(device_type)
    if ranks is None:
        ranks = range(dist.get_world_size())
    layout = rank_layout(config or MeshConfig(), list(ranks))
    mesh = DeviceMesh(device.type, layout, mesh_dim_names=AXIS_ORDER)
    # The data axes as FSDP2 and the train step use them: (dcn x dp, fsdp)
    # for HSDP and dcn x dp x fsdp flattened. Made here, from the layout,
    # because creating a group takes every rank of the default group in the
    # same order; slicing (below) reuses the groups and is local.
    n_rep, n_shard = layout.shape[0] * layout.shape[1], layout.shape[2]
    hsdp = DeviceMesh(device.type, layout.reshape(n_rep, n_shard, -1),
                      mesh_dim_names=("replicate", "shard", "model"))
    flat = DeviceMesh(device.type, layout.reshape(n_rep * n_shard, -1),
                      mesh_dim_names=("data", "model"))
    member = mesh.get_coordinate() is not None
    mesh.data_parallel_meshes = (hsdp["replicate", "shard"], flat["data"]) if member else None
    return mesh


def data_parallel_meshes(mesh: DeviceMesh):
    """(the 2-D HSDP mesh (dcn x dp replicated, fsdp sharded), the 1-D mesh
    of dcn x dp x fsdp) of this rank, from a mesh made by ``build_mesh``."""
    views = getattr(mesh, "data_parallel_meshes", None)
    if views is None:
        raise ValueError("expected a mesh from build_mesh that holds this rank")
    return views


def local_mesh(device_type: Optional[str] = None, **axis_sizes) -> DeviceMesh:
    """Convenience: a mesh over every rank with the given sizes, e.g.
    local_mesh(dp=2, tp=4)."""
    return build_mesh(MeshConfig(**axis_sizes), device_type=device_type)


def data_axes() -> List[str]:
    """Mesh axes a batch dimension is sharded over."""
    return ["dcn", "dp", "fsdp"]


def num_data_shards(mesh: DeviceMesh) -> int:
    names = mesh.mesh_dim_names or ()
    return math.prod(mesh.size(names.index(a)) for a in data_axes() if a in names)

"""Parallelism on the mesh: the port of ``ray_tpu/parallel`` (mesh,
partition rules, ambient mesh).

A ``torch.distributed`` DeviceMesh with the JAX package's axis names, and
partition rules that place a model on it: tensor parallelism on local
shards with explicit collectives (``tensor_parallel``), ZeRO-3 through
FSDP2 over the data axes. ``shard_pytree`` of the JAX package is
``shard_model`` here, since the port's parameters live in modules.
"""

from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh, local_mesh
from ray_tpu_torch.parallel.sharding import (
    PartitionRules,
    named_sharding,
    shard_model,
    with_sharding_constraint,
)

__all__ = [
    "MeshConfig",
    "PartitionRules",
    "build_mesh",
    "local_mesh",
    "named_sharding",
    "shard_model",
    "with_sharding_constraint",
]

"""Collective communication library for actors.

Parity: ray.util.collective (reference python/ray/util/collective/
collective.py — init_collective_group :171, create_collective_group :211,
allreduce/reduce/broadcast/allgather/reducescatter/send/recv :328-724;
backends NCCL/GLOO types.py:34-48).

Backend mapping in the port:
  - device collectives are torch.distributed ops over the train
    backend's process group (process_group.py: NCCL on cards, gloo on
    the CPU) and the meshes built over it; this library's ops take
    host arrays and torch tensors, and return numpy arrays;
  - "cpu" backend here fills the Gloo role: host-tensor collectives
    between actors, rendezvoused and exchanged through the control store
    KV (the reference rendezvouses NCCLUniqueID through a named store
    actor the same way, nccl_collective_group.py:29-60);
  - the process group's TCP store address is handed out through the
    control store KV (get_coordinator), so every member can call
    torch.distributed.init_process_group and then build a mesh.
"""

from ray_tpu_torch.collective.collective import (
    CollectiveError,
    ReduceOp,
    allgather,
    allreduce,
    barrier,
    broadcast,
    destroy_collective_group,
    get_rank,
    get_collective_group_size,
    init_collective_group,
    recv,
    reducescatter,
    send,
)
from ray_tpu_torch.collective.bucketed import GradSync, allreduce_async, grad_sync
from ray_tpu_torch.collective.process_group import (
    coordinator_env,
    get_coordinator,
    initialize_process_group,
)

__all__ = [
    "CollectiveError",
    "GradSync",
    "ReduceOp",
    "allgather",
    "allreduce",
    "allreduce_async",
    "barrier",
    "broadcast",
    "destroy_collective_group",
    "get_collective_group_size",
    "get_rank",
    "get_coordinator",
    "grad_sync",
    "init_collective_group",
    "recv",
    "reducescatter",
    "send",
    "coordinator_env",
    "initialize_process_group",
]

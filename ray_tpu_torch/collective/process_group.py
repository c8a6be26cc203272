"""The train backend's process group: ``torch.distributed`` over NCCL or
gloo, rendezvoused through the control store.

Counterpart of ``ray_tpu/collective/xla_group.py``. Where the JAX package
hands out the jax.distributed coordinator address through the control
store KV and joins every member into one JAX runtime, the port hands out
the address of a TCP store the same way (rank 0 claims ``host:free_port``,
the others poll for it) and joins every member into one
``torch.distributed`` process group: NCCL on cards, gloo on the CPU. The
group is the default one, so ``parallel.build_mesh`` spans its ranks and
device collectives are ``torch.distributed`` ops over it.

The host in the address is rank 0's worker address, the one its peers
already reach for the runtime's RPC (the JAX package resolves the host
name instead).

No counterpart: the multislice variables (``MEGASCALE_*``, TPU slices
joined over the data-center network). One NCCL group spans nodes by
itself; a group of one rank per card across cards waits for GPU-aware
placement (ROADMAP.md, Queue A item 9), and ``coordinator_env`` refuses
``num_slices > 1``.
"""

from __future__ import annotations

import socket
import time
from typing import Dict, Optional

BACKENDS = ("nccl", "gloo")
# The backend a train worker joins with: the controller sets it beside
# RT_XLA_GROUP, RT_XLA_RANK and RT_XLA_WORLD (train/controller.py).
BACKEND_ENV = "RT_XLA_BACKEND"

# Seconds the last initialize_process_group of this process took: the whole
# join, from the card's selection through the first barrier that builds
# NCCL's communicator.
last_init_s: Optional[float] = None


def _worker():
    from ray_tpu_torch.core import worker as worker_mod

    return worker_mod.global_worker()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def get_coordinator(group_name: str, rank: int, timeout_s: float = 60.0) -> str:
    """``host:port`` of the group's TCP store: rank 0 claims (or reuses)
    it, the others poll for it."""
    control = _worker().control
    key = f"pg/{group_name}/coordinator"
    if rank == 0:
        host = (_worker().address or "").rsplit(":", 1)[0] or "localhost"
        addr = f"{host}:{_free_port()}"
        if not control.call("kv_put", ns="coll", key=key, value=addr.encode(),
                            overwrite=False, retryable=True):
            addr = control.call("kv_get", ns="coll", key=key, retryable=True).decode()
        return addr
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        val = control.call("kv_get", ns="coll", key=key, retryable=True)
        if val is not None:
            return val.decode()
        time.sleep(0.05)
    raise TimeoutError(f"no coordinator for process group {group_name}")


def coordinator_env(group_name: str, rank: int, world_size: int,
                    num_slices: int = 1, slice_id: int = 0) -> Dict[str, str]:
    """The ``torch.distributed`` env:// variables for a worker joining the
    group (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)."""
    if num_slices > 1:
        raise NotImplementedError(
            "multislice groups (num_slices > 1) have no counterpart: one NCCL group spans "
            "nodes; cards across hosts wait for ROADMAP.md, Queue A item 9 (GPU-aware "
            "scheduling)")
    host, port = get_coordinator(group_name, rank).rsplit(":", 1)
    return {"MASTER_ADDR": host, "MASTER_PORT": port,
            "WORLD_SIZE": str(world_size), "RANK": str(rank)}


def initialize_process_group(group_name: str, rank: int, world_size: int,
                             backend: str) -> None:
    """Join this process into the group's default ``torch.distributed``
    process group. ``nccl`` first sets this process's card (rank modulo
    the visible cards) and raises if it sees none; it never drops to
    gloo. ``gloo`` runs on the CPU. The join ends with a barrier, as
    ``jax.distributed.initialize`` returns only once every member is in:
    NCCL builds its communicator there, so a member that cannot join fails
    here and not at the train function's first collective."""
    global last_init_s

    if backend not in BACKENDS:
        raise ValueError(f"unsupported backend {backend!r} (expected one of {BACKENDS})")
    import torch
    import torch.distributed as dist

    t0 = time.perf_counter()
    barrier_kw = {}
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"process group {group_name}: backend nccl needs a CUDA device and this "
                "worker sees none (a train run with use_gpu=True and gpus_per_worker >= 1)")
        card = rank % torch.cuda.device_count()
        torch.cuda.set_device(card)
        barrier_kw["device_ids"] = [card]
    coordinator = get_coordinator(group_name, rank)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world_size, rank=rank)
    dist.barrier(**barrier_kw)
    last_init_s = time.perf_counter() - t0

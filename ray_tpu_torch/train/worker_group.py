"""Train worker group: placement group + one actor per worker.

Parity: reference WorkerGroup (python/ray/train/v2/_internal/execution/
worker_group/worker_group.py:113 — PG creation :449-488, actors bound to
bundles :384-399) with the torch worker model: one worker = one process,
one rank of the process group, with its cards (GPU resources).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.placement import PlacementGroupSchedulingStrategy
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.utils import serialization


@ray_tpu_torch.remote
class TrainWorker:
    """Hosts one rank of the SPMD training job."""

    def __init__(self, rank: int, world_size: int, run_dir: Optional[str]):
        self.rank = rank
        self.world_size = world_size
        self.run_dir = run_dir

    def apply_env(self, env: Dict[str, str]) -> bool:
        os.environ.update(env)
        return True

    def node_id(self) -> str:
        return ray_tpu_torch.get_runtime_context().get_node_id()

    def setup_collectives(self, group_name: str) -> bool:
        from ray_tpu_torch import collective

        collective.init_collective_group(
            world_size=self.world_size, rank=self.rank, backend="cpu",
            group_name=group_name,
        )
        return True

    def run(
        self,
        train_fn_blob: bytes,
        train_loop_config: Optional[Dict[str, Any]],
        restore_checkpoint_path: Optional[str],
        collective_group: Optional[str],
        datasets_blob: Optional[bytes] = None,
    ) -> List[Dict[str, Any]]:
        """Execute the user train loop; returns this rank's reports."""
        from ray_tpu_torch.train import context as ctx_mod
        from ray_tpu_torch.utils.config import config

        # Join this worker into the group's torch.distributed process
        # group before the train fn runs (parity: reference TorchConfig
        # _setup_torch_process_group, train/torch/config.py). RT_XLA_*
        # arrive via apply_env() on this actor; the dynamic flags re-read
        # the process env on each access. Init failures propagate.
        if config.xla_group:
            from ray_tpu_torch.collective.process_group import (
                BACKEND_ENV,
                initialize_process_group,
            )

            initialize_process_group(
                config.xla_group,
                int(config.xla_rank),
                int(config.xla_world),
                os.environ[BACKEND_ENV],
            )

        train_fn = serialization.loads(train_fn_blob)
        restore = (
            Checkpoint(restore_checkpoint_path) if restore_checkpoint_path else None
        )
        # the blob already holds THIS rank's shard (driver-side split)
        shards = (
            serialization.loads(datasets_blob)
            if datasets_blob is not None
            else None
        )
        ctx = ctx_mod.TrainContext(
            world_rank=self.rank,
            world_size=self.world_size,
            local_rank=0,
            node_rank=self.rank,
            run_dir=self.run_dir,
            restore_checkpoint=restore,
            collective_group=collective_group,
            dataset_shards=shards,
        )
        if restore is not None:
            # continue checkpoint numbering from the restored step so a
            # resumed run never writes below the restore point
            base = os.path.basename(restore.path.rstrip("/"))
            try:
                ctx.report_step = int(base.split("_")[1])
            except (IndexError, ValueError):
                pass
        ctx_mod.set_context(ctx)
        try:
            if train_loop_config is not None:
                train_fn(train_loop_config)
            else:
                train_fn()
        finally:
            ctx_mod.set_context(None)
        return ctx.reports


class PlacementTimeoutError(RuntimeError):
    """The group's placement group did not become ready in time. In
    elastic mode this is a RESIZE signal, not a failure: the desired
    world size was computed from a cluster view that may not have
    registered node deaths yet (health_check_timeout_s lag), so the
    controller recomputes feasibility and retries smaller."""


class WorkerGroup:
    def __init__(self, scaling: ScalingConfig, run_dir: Optional[str]):
        self.scaling = scaling
        self.run_dir = run_dir
        self.pg = None
        self.workers: List[Any] = []

    def start(self, ready_timeout_s: float = 120.0) -> None:
        n = self.scaling.num_workers
        res = self.scaling.worker_resources()
        self.pg = ray_tpu_torch.placement_group(
            [dict(res) for _ in range(n)],
            strategy=self.scaling.placement_strategy,
        )
        if not self.pg.wait(timeout_seconds=ready_timeout_s):
            raise PlacementTimeoutError(
                f"placement group for {n} x {res} not ready in "
                f"{ready_timeout_s}s"
            )
        self.workers = [
            TrainWorker.options(
                num_cpus=res.get("CPU", 1),
                resources={"GPU": res["GPU"]} if res.get("GPU") else None,
                scheduling_strategy=PlacementGroupSchedulingStrategy(self.pg, i),
            ).remote(i, n, self.run_dir)
            for i in range(n)
        ]

    def apply_env(self, envs: List[Dict[str, str]]) -> None:
        ray_tpu_torch.get([
            w.apply_env.remote(env) for w, env in zip(self.workers, envs)
        ])

    def setup_collectives(self, group_name: str) -> None:
        ray_tpu_torch.get([
            w.setup_collectives.remote(group_name) for w in self.workers
        ], timeout=120)

    def run(self, train_fn_blob, config, restore_path, collective_group,
            dataset_blobs=None):
        return [
            w.run.remote(
                train_fn_blob, config, restore_path, collective_group,
                dataset_blobs[i] if dataset_blobs else None,
            )
            for i, w in enumerate(self.workers)
        ]

    def node_ids(self) -> List[str]:
        return ray_tpu_torch.get([w.node_id.remote() for w in self.workers])

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001
                pass
        self.workers = []
        if self.pg is not None:
            try:
                ray_tpu_torch.remove_placement_group(self.pg)
            except Exception:  # noqa: BLE001
                pass
            self.pg = None

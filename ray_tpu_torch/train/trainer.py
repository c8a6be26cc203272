"""DataParallelTrainer / TorchTrainer — the user-facing Train API.

Parity: DataParallelTrainer.fit (reference python/ray/train/v2/api/
data_parallel_trainer.py:157) and TorchTrainer (train/torch/torch_trainer.py),
the counterpart of the JAX package's JaxTrainer.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import Result, RunConfig, ScalingConfig
from ray_tpu_torch.train.controller import TrainController
from ray_tpu_torch.utils import serialization
from ray_tpu_torch.utils.config import config as rt_config


class DataParallelTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        dataset_split_mode: str = "materialize",
    ):
        self._train_fn = train_loop_per_worker
        self._train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        # "materialize": execute the pipeline ONCE on the driver, hand each
        # rank a FromBundles shard (no duplicated read/preprocess compute;
        # costs full materialization in the object store).
        # "reexecute": each rank streams its own execution filtered to
        # 1/world_size of the block stream (no materialization; read/map
        # compute runs world_size times).
        if dataset_split_mode not in ("materialize", "reexecute"):
            raise ValueError(f"unknown dataset_split_mode {dataset_split_mode!r}")
        self.dataset_split_mode = dataset_split_mode

    def _run_dir(self) -> str:
        base = self.run_config.storage_path or os.path.join(
            rt_config.temp_dir, "runs"
        )
        name = self.run_config.name or f"run_{int(time.time())}"
        path = os.path.join(base, name)
        os.makedirs(path, exist_ok=True)
        return path

    def _dataset_blobs(self):
        """Per-rank dataset dicts, sharded driver-side (each rank receives
        exactly its shard — no shard logic on the worker). dumps_function
        (cloudpickle + by-value module registration) so UDFs defined in
        user modules deserialize on workers."""
        if not self.datasets:
            return None
        n = self.scaling_config.num_workers
        per_rank = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            if n <= 1:
                parts = [ds]
            elif self.dataset_split_mode == "materialize":
                parts = ds.split(n)
            else:
                parts = [ds.shard(n, i) for i in range(n)]
            for i in range(n):
                per_rank[i][name] = parts[i]
        return [serialization.dumps_function(d) for d in per_rank]

    def fit(self) -> Result:
        if self.scaling_config.elastic and self.datasets:
            raise ValueError(
                "elastic scaling with datasets= is not supported yet: "
                "dataset shards are split at the initial world size"
            )
        run_dir = self._run_dir()
        cc = self.run_config.checkpoint_config
        # Pin the controller to the driver's node (reference v2 runs the
        # controller IN the driver process): it must not die with an
        # arbitrary worker node — its job is to outlive worker failures.
        from ray_tpu_torch.core.api import NodeAffinitySchedulingStrategy

        controller = TrainController.options(
            num_cpus=0,
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=ray_tpu_torch.get_runtime_context().get_node_id(),
                soft=True,
            ),
        ).remote(
            self.scaling_config,
            run_dir,
            self.run_config.failure_config.max_failures,
            cc.num_to_keep,
            cc.checkpoint_score_attribute,
            cc.checkpoint_score_order,
        )
        try:
            out = ray_tpu_torch.get(
                controller.run.remote(
                    serialization.dumps_function(self._train_fn),
                    self._train_loop_config,
                    self.scaling_config.use_gpu,
                    self.scaling_config.gpus_per_worker,
                    self._dataset_blobs(),
                ),
            )
        finally:
            try:
                ray_tpu_torch.kill(controller)
            except Exception:  # noqa: BLE001
                pass
        error = RuntimeError(out["error"]) if out.get("error") else None
        metrics = out.get("metrics")
        if metrics:
            metrics = {k: v for k, v in metrics.items() if not k.startswith("_")}
        ckpt = (
            Checkpoint(out["checkpoint_path"]) if out.get("checkpoint_path") else None
        )
        return Result(metrics=metrics, checkpoint=ckpt, error=error, path=run_dir)


class TorchTrainer(DataParallelTrainer):
    """Data-parallel torch training: one worker per card, the workers
    joined into one NCCL process group under ``use_gpu`` (on the CPU,
    without a process group, when not).

    Parity: reference TorchTrainer; the JAX package's JaxTrainer, whose
    ``tpu_chips_per_worker`` defaults to 1 under ``use_tpu`` as
    ``gpus_per_worker`` does here under ``use_gpu``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        sc = self.scaling_config
        if sc.use_gpu and not sc.gpus_per_worker:
            sc.gpus_per_worker = 1

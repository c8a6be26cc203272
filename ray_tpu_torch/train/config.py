"""Train configuration dataclasses.

Parity: ray.train ScalingConfig/RunConfig/FailureConfig/CheckpointConfig
(reference python/ray/train/v2/api/config.py, python/ray/air/config.py)
with GPU fields: use_gpu and gpus_per_worker ask for cards (the
cluster's GPU resource); one worker = one process = its cards.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = False
    # resources per worker (one worker = one HOST driving all its chips)
    resources_per_worker: Optional[Dict[str, float]] = None
    gpus_per_worker: int = 0
    topology: Optional[str] = None  # e.g. "v5e-16" → slice-aware placement
    placement_strategy: str = "PACK"
    # Elastic bounds (parity: reference ElasticScalingPolicy,
    # train/v2/_internal/execution/scaling_policy/elastic.py:29): when
    # min_workers is set, the controller restarts the group at the
    # largest FEASIBLE world size in [min_workers, max_workers] after a
    # failure, and resizes back up (from the latest checkpoint) when
    # capacity returns. max_workers defaults to num_workers.
    min_workers: Optional[int] = None
    max_workers: Optional[int] = None

    @property
    def elastic(self) -> bool:
        return self.min_workers is not None

    def elastic_bounds(self) -> "tuple[int, int]":
        lo = self.min_workers if self.min_workers is not None else self.num_workers
        hi = self.max_workers if self.max_workers is not None else self.num_workers
        return lo, hi

    def resized(self, n: int) -> "ScalingConfig":
        return dataclasses.replace(self, num_workers=n)

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        if self.use_gpu and self.gpus_per_worker:
            res.setdefault("GPU", float(self.gpus_per_worker))
        res.setdefault("CPU", 1.0)
        return res


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0  # worker-group restarts before giving up


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None  # None = keep all
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None  # local dir (fsspec remotes later)
    failure_config: FailureConfig = dataclasses.field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig
    )


@dataclasses.dataclass
class Result:
    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional["Checkpoint"]
    error: Optional[BaseException]
    path: Optional[str] = None

    @property
    def best_checkpoints(self):
        return self._best_checkpoints if hasattr(self, "_best_checkpoints") else []


from ray_tpu_torch.train.checkpoint import Checkpoint  # noqa: E402  (Result type)

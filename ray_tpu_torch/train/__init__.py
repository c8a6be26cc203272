"""ray_tpu_torch.train — distributed training orchestration (Train library).

Parity: ray.train v2 (reference python/ray/train/v2/) with torch on NVIDIA
cards as the backend: TorchTrainer spawns one worker actor per card, joins
them into one torch.distributed process group (NCCL; gloo on the CPU), and
the train loop uses ray_tpu_torch.parallel for dp/fsdp/tp sharding.
"""

from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.context import get_context, get_dataset_shard, grad_sync, report
from ray_tpu_torch.train.trainer import DataParallelTrainer, TorchTrainer

__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "CheckpointManager",
    "DataParallelTrainer",
    "FailureConfig",
    "TorchTrainer",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "get_context",
    "get_dataset_shard",
    "grad_sync",
    "report",
]

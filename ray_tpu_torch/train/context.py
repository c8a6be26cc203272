"""Per-worker train context + report() (parity: ray.train.get_context /
ray.train.report, reference python/ray/train/context.py)."""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_local = threading.local()


class TrainContext:
    def __init__(
        self,
        world_rank: int,
        world_size: int,
        local_rank: int,
        node_rank: int,
        run_dir: Optional[str],
        restore_checkpoint: Optional[Checkpoint],
        collective_group: Optional[str],
        dataset_shards: Optional[Dict[str, Any]] = None,
    ):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.node_rank = node_rank
        self.run_dir = run_dir
        self.restore_checkpoint = restore_checkpoint
        self.collective_group = collective_group
        self.dataset_shards = dataset_shards or {}
        self.reports: List[Dict[str, Any]] = []
        # resume the step counter from the restored checkpoint so a
        # restarted (or elastically resized) run never overwrites earlier
        # steps' checkpoint dirs
        self.report_step = 0
        if restore_checkpoint is not None:
            base = os.path.basename(restore_checkpoint.path.rstrip("/"))
            if base.startswith("checkpoint_"):
                try:
                    self.report_step = int(base.split("_")[1])
                except (IndexError, ValueError):
                    pass

    # -- API parity --

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.restore_checkpoint

    def get_experiment_name(self) -> Optional[str]:
        return os.path.basename(self.run_dir) if self.run_dir else None

    def get_dataset_shard(self, name: str = "train"):
        """This rank's 1/world_size shard of a Dataset passed to the
        Trainer via datasets= (parity: ray.train.get_dataset_shard,
        reference v2/_internal/data_integration/). Returns a
        ray_tpu_torch.data.DataIterator."""
        ds = self.dataset_shards.get(name)
        if ds is None:
            raise KeyError(
                f"no dataset named {name!r} was passed to the Trainer "
                f"(have: {sorted(self.dataset_shards)})"
            )
        return ds.iterator()

    def grad_sync(self, grads=None, *, average: bool = True,
                  quant: Optional[str] = None,
                  bucket_bytes: Optional[int] = None,
                  hierarchy: Optional[str] = None,
                  timeout_s: Optional[float] = None):
        """Overlapped bucketed DP gradient allreduce on this worker's
        collective group. ``grads = ctx.grad_sync(grads).join()`` is the
        one-shot form; for overlap, take an open handle before backward
        (``h = ctx.grad_sync()``), ``h.push(...)`` per microbatch/stage,
        and ``h.join()`` at optimizer apply. Single-worker runs (or no
        collective group) pass through locally. Averages by world size
        by default — the DP convention."""
        from ray_tpu_torch.collective import bucketed

        group = (
            self.collective_group if self.world_size > 1 else None
        )
        handle = bucketed.GradSync(
            group, average=average, quant=quant,
            bucket_bytes=bucket_bytes, hierarchy=hierarchy,
            timeout_s=timeout_s,
        )
        if grads is not None:
            handle.push(grads)
            handle.close()
        return handle


def set_context(ctx: Optional[TrainContext]) -> None:
    _local.ctx = ctx


def get_context() -> TrainContext:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise RuntimeError(
            "ray_tpu_torch.train.get_context() called outside a train worker"
        )
    return ctx


def get_dataset_shard(name: str = "train"):
    return get_context().get_dataset_shard(name)


def grad_sync(grads=None, **kwargs):
    """Module-level convenience for ``get_context().grad_sync(...)``."""
    return get_context().grad_sync(grads, **kwargs)


def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None) -> None:
    """Record metrics (and optionally persist a checkpoint) for this step.

    Mirrors the reference flow (SURVEY.md §3.4): every worker reaches a
    sync barrier; each worker's checkpoint shard is copied into the shared
    step directory under rank_<r>/; metrics are recorded per worker and
    rank 0's stream becomes the Result metrics.
    """
    ctx = get_context()
    ctx.report_step += 1
    step = ctx.report_step
    if checkpoint is not None and ctx.run_dir is not None:
        step_dir = os.path.join(ctx.run_dir, f"checkpoint_{step:06d}")
        rank_dir = os.path.join(step_dir, f"rank_{ctx.world_rank}")
        os.makedirs(step_dir, exist_ok=True)
        shutil.copytree(checkpoint.as_directory(), rank_dir, dirs_exist_ok=True)
    entry = dict(metrics)
    entry["_step"] = step
    entry["_has_checkpoint"] = checkpoint is not None
    ctx.reports.append(entry)
    # commit barrier so no worker races ahead of a partially-written step
    if ctx.collective_group is not None and ctx.world_size > 1:
        from ray_tpu_torch import collective

        collective.barrier(ctx.collective_group)
    if checkpoint is not None and ctx.run_dir is not None and ctx.world_rank == 0:
        # past the barrier every rank's shard landed: mark the step
        # COMPLETE with the world size that wrote it (an elastic restart
        # at a different size must not mistake a partial write for done)
        import json

        step_dir = os.path.join(ctx.run_dir, f"checkpoint_{step:06d}")
        with open(os.path.join(step_dir, "_complete.json"), "w") as f:
            json.dump({"world_size": ctx.world_size, "step": step}, f)

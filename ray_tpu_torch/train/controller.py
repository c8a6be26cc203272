"""Train controller — the run state machine.

Parity: reference TrainController actor (python/ray/train/v2/_internal/
execution/controller/controller.py:105 — group start, poll, failure
decisions :235/:283) simplified to the run-restart loop: start worker
group → backend bootstrap → run → on worker failure restart the WHOLE
group from the latest checkpoint (the reference's recommended recovery
for jax.distributed, SURVEY.md §7 hard part c) up to max_failures.
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import CheckpointManager
from ray_tpu_torch.train.config import FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.train.worker_group import PlacementTimeoutError, WorkerGroup
from ray_tpu_torch.utils.config import config

logger = logging.getLogger(__name__)


@ray_tpu_torch.remote
class TrainController:
    def __init__(
        self,
        scaling: ScalingConfig,
        run_dir: str,
        max_failures: int,
        num_to_keep: Optional[int],
        score_attribute: Optional[str],
        score_order: str,
    ):
        self.scaling = scaling
        self.run_dir = run_dir
        self.max_failures = max_failures
        self._resize_hint: Optional[int] = None
        self._view_cache: tuple = (-1, {})
        self.ckpts = CheckpointManager(
            run_dir, num_to_keep=num_to_keep,
            score_attribute=score_attribute, score_order=score_order,
        )

    def run(
        self,
        train_fn_blob: bytes,
        train_loop_config: Optional[Dict[str, Any]],
        use_gpu: bool,
        gpus_per_worker: int,
        dataset_blobs: Optional[List[bytes]] = None,
    ) -> Dict[str, Any]:
        attempt = 0
        resizes = 0
        last_error: Optional[str] = None
        while attempt <= self.max_failures:
            scaling = self._current_scaling()
            group_name = f"rt_train_{uuid.uuid4().hex[:8]}"
            wg = WorkerGroup(scaling, self.run_dir)
            try:
                # Elastic: a short ready-bound turns "desired size no
                # longer fits" (e.g. the cluster view had not registered
                # node deaths when we sized) into a prompt feasibility
                # recompute instead of a 120 s stall at a stale size.
                wg.start(
                    ready_timeout_s=5.0 if self.scaling.elastic else 120.0
                )
                self._bootstrap_backend(
                    wg, group_name, use_gpu, gpus_per_worker,
                    scaling.num_workers,
                )
                # pick up any complete checkpoints a crashed attempt left
                self.ckpts.rescan(expected_ranks=scaling.num_workers)
                restore = self.ckpts.latest()
                refs = wg.run(
                    train_fn_blob, train_loop_config,
                    restore.path if restore else None, group_name,
                    dataset_blobs,
                )
                outcome = self._monitor(refs, scaling, resizes)
                if outcome == "resize":
                    resizes += 1
                    logger.info(
                        "elastic resize: capacity returned, restarting the "
                        "group (resize %d)", resizes,
                    )
                    continue  # NOT a failure
                all_reports: List[List[Dict[str, Any]]] = ray_tpu_torch.get(refs)
                self._register_checkpoints(all_reports[0])
                last = all_reports[0][-1] if all_reports[0] else None
                latest = self.ckpts.latest()
                return {
                    "metrics": last,
                    "checkpoint_path": latest.path if latest else None,
                    "error": None,
                    "attempts": attempt + 1,
                    "resizes": resizes,
                    "final_world_size": scaling.num_workers,
                }
            except PlacementTimeoutError as e:
                if self.scaling.elastic and resizes < 30:
                    # not a failure: the size was computed from a stale
                    # view — recompute feasibility and retry
                    resizes += 1
                    logger.info("elastic re-size after %s", e)
                else:
                    last_error = f"{type(e).__name__}: {e}"
                    attempt += 1
            except Exception as e:  # noqa: BLE001 — worker/group failure
                last_error = f"{type(e).__name__}: {e}"
                logger.warning(
                    "train attempt %d failed: %s", attempt + 1, last_error
                )
                attempt += 1
                time.sleep(0.5)
            finally:
                wg.shutdown()
        latest = self.ckpts.latest()
        return {
            "metrics": None,
            "checkpoint_path": latest.path if latest else None,
            "error": f"train failed after {attempt} attempts: {last_error}",
            "attempts": attempt,
        }

    def _current_scaling(self):
        """Elastic sizing (reference ElasticScalingPolicy, elastic.py:29):
        wait until at least min_workers are feasible, then take the
        largest feasible size within [min, max]. After an upscale resize,
        `_resize_hint` carries the target computed BEFORE the old group
        released its resources — wait briefly for the release to land in
        the cluster view instead of restarting at idle-capacity-only."""
        if not self.scaling.elastic:
            return self.scaling
        lo, hi = self.scaling.elastic_bounds()
        hint = self._resize_hint
        self._resize_hint = None
        hint_deadline = time.monotonic() + 15.0
        deadline = time.monotonic() + 300.0
        while True:
            n = min(hi, self._feasible_workers())
            if hint and n < hint and time.monotonic() < hint_deadline:
                time.sleep(0.5)
                continue
            if n >= lo:
                return self.scaling.resized(n)
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"elastic train: fewer than min_workers={lo} workers "
                    f"feasible after 300s (feasible={n})"
                )
            time.sleep(1.0)

    def _feasible_workers(self) -> int:
        """How many workers the cluster's AVAILABLE resources could host
        right now (per-node bin-packing of worker_resources). Uses the
        versioned view protocol: an unchanged cluster costs O(1) on the
        wire, not a full per-node resource dump per poll."""
        from ray_tpu_torch.core import worker as worker_mod

        req = self.scaling.worker_resources()
        cached_version, cached_view = self._view_cache
        try:
            reply = worker_mod.global_worker().control.call(
                "get_cluster_view", known_version=cached_version,
                timeout_s=10.0,
            )
            if reply.get("unchanged"):
                view = cached_view
            else:
                view = reply["view"]
                self._view_cache = (reply["version"], view)
        except Exception:  # noqa: BLE001
            return 0
        total = 0
        for node in view.values():
            avail = node.get("resources_available", {})
            fits = min(
                (int(avail.get(k, 0.0) // v) for k, v in req.items() if v > 0),
                default=0,
            )
            total += max(0, fits)
        return total

    def _monitor(self, refs, scaling, resizes: int) -> str:
        """Block on the group's run; in elastic mode, watch for returned
        capacity and trigger an upscale restart (from the latest
        checkpoint) when more workers would fit. Returns "done" or
        "resize" (resize only in elastic mode, capped)."""
        lo, hi = scaling.elastic_bounds()
        can_grow = (
            self.scaling.elastic and scaling.num_workers < hi and resizes < 10
        )
        grow_seen = 0
        idle = 0
        while True:
            ready, pending = ray_tpu_torch.wait(
                refs, num_returns=len(refs), timeout=1.0
            )
            if not pending:
                return "done"
            # A rank that errored while others still run means the group
            # is dying (peers will hang in collectives until their own
            # timeout): fail the whole attempt NOW — restart latency is
            # what bounds elastic recovery, not the barrier timeout.
            for r in ready:
                try:
                    ray_tpu_torch.get(r)
                except BaseException as e:  # noqa: BLE001
                    raise RuntimeError(f"train worker failed: {e}") from None
            if not can_grow:
                continue
            idle = self._feasible_workers()  # capacity beyond our group
            if idle >= 1:
                grow_seen += 1
            else:
                grow_seen = 0
            # require capacity to be stable across a few polls before
            # paying a restart (checkpoint-bounded progress loss)
            if grow_seen >= 3:
                # the restart can host our current workers PLUS the idle
                # capacity; record it so _current_scaling doesn't size
                # from a view where our group still holds its resources
                self._resize_hint = min(hi, scaling.num_workers + idle)
                return "resize"

    def _bootstrap_backend(self, wg: WorkerGroup, group_name: str,
                           use_gpu: bool, gpus_per_worker: int,
                           n: Optional[int] = None) -> None:
        """The torch backend (the JAX package's JaxBackend equivalent;
        reference train/torch/config.py): CPU mode hides the cards from
        the workers, which run torch on the CPU with no process group; GPU
        mode hands every worker the RT_XLA_* env of one torch.distributed
        process group, joined before the train fn runs: NCCL when each
        worker has a card (gpus_per_worker >= 1), else gloo on the CPU."""
        from ray_tpu_torch.collective.process_group import BACKEND_ENV

        if n is None:
            n = self.scaling.num_workers
        if not use_gpu:
            envs = [{"CUDA_VISIBLE_DEVICES": ""} for _ in range(n)]
            wg.apply_env(envs)
        else:
            backend = "nccl" if gpus_per_worker >= 1 else "gloo"
            envs = [
                {
                    "RT_XLA_GROUP": group_name,
                    "RT_XLA_RANK": str(i),
                    "RT_XLA_WORLD": str(n),
                    BACKEND_ENV: backend,
                }
                for i in range(n)
            ]
            wg.apply_env(envs)
        wg.setup_collectives(group_name)

    def _register_checkpoints(self, rank0_reports: List[Dict[str, Any]]) -> None:
        for entry in rank0_reports:
            if entry.get("_has_checkpoint"):
                metrics = {
                    k: v for k, v in entry.items() if not k.startswith("_")
                }
                self.ckpts.register(entry["_step"], metrics)

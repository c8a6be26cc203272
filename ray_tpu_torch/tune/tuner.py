"""Tuner + trial controller.

Parity: ray.tune Tuner (reference python/ray/tune/tuner.py:43) and
TuneController (tune/execution/tune_controller.py:67 — event-loop step
:665, trial-actor scheduling :963): trials run in actors, the controller
polls their buffered results, feeds the scheduler, and stops losers
early; per-trial checkpoints land under the run dir.
"""

from __future__ import annotations

import logging
import os
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.tune import schedulers as sched_mod
from ray_tpu_torch.tune.search import generate_trials
from ray_tpu_torch.utils import serialization
from ray_tpu_torch.utils.config import config

logger = logging.getLogger(__name__)

# A drain that outlasts this is a miss; 24 misses in a row of a runner
# that holds its lease finish its trial as unresponsive.
DRAIN_TIMEOUT_S = 5.0


class TuneConfig:
    def __init__(
        self,
        metric: str = "score",
        mode: str = "max",
        num_samples: int = 1,
        max_concurrent_trials: int = 4,
        scheduler=None,
        seed: Optional[int] = None,
        search_alg=None,
        max_failures: int = 0,
    ):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.metric = metric
        self.mode = mode
        self.num_samples = num_samples
        self.max_concurrent_trials = max_concurrent_trials
        self.scheduler = scheduler or sched_mod.FIFOScheduler()
        self.seed = seed
        # model-based search (e.g. search.TPESearcher): configs are
        # SUGGESTED one at a time from completed-trial history instead of
        # pre-sampled (reference: tune search_alg / optuna integration)
        self.search_alg = search_alg
        # trial fault tolerance: a trial whose runner dies is relaunched
        # from its latest checkpoint up to this many times (reference
        # FailureConfig(max_failures))
        self.max_failures = max_failures


class TrialResult:
    def __init__(self, trial_id: str, config: Dict[str, Any]):
        self.trial_id = trial_id
        self.config = config
        self.metrics: Optional[Dict[str, Any]] = None  # last report
        self.all_reports: List[Dict[str, Any]] = []
        self.error: Optional[str] = None
        self.stopped_early = False
        self.checkpoint_path: Optional[str] = None
        self.exploited_from: Optional[str] = None  # PBT clone source

    def __repr__(self):
        return (
            f"TrialResult({self.trial_id}, metrics={self.metrics}, "
            f"stopped_early={self.stopped_early}, error={self.error})"
        )


class ResultGrid:
    def __init__(self, results: List[TrialResult], metric: str, mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __iter__(self):
        return iter(self._results)

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i):
        return self._results[i]

    def get_best_result(self) -> TrialResult:
        scored = [
            r for r in self._results
            if r.metrics and self._metric in r.metrics
        ]
        if not scored:
            raise ValueError("no trial reported the target metric")
        return (max if self._mode == "max" else min)(
            scored, key=lambda r: r.metrics[self._metric]
        )

    @property
    def num_errors(self) -> int:
        return sum(1 for r in self._results if r.error)


@ray_tpu_torch.remote
class _TrialRunner:
    """Hosts one trial; buffers reports for the controller to drain."""

    def __init__(self, fn_blob: bytes, config: Dict[str, Any], trial_dir: str,
                 restore_from: Optional[str] = None):
        import threading

        from ray_tpu_torch.tune import session

        self._fn = serialization.loads(fn_blob)
        self._config = config
        self._trial_dir = trial_dir
        self._restore_from = restore_from
        self._reports: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._done = False
        self._error: Optional[str] = None
        self._session = session

    def run(self) -> bool:
        """Executes the trainable to completion (or until killed)."""
        import inspect

        from ray_tpu_torch.tune import session
        from ray_tpu_torch.tune.trainable import Trainable

        session._set(
            self._on_report, self._trial_dir, self._config,
            restore_from=self._restore_from,
        )
        try:
            if inspect.isclass(self._fn) and issubclass(self._fn, Trainable):
                self._run_class_trainable()
            else:
                self._fn(self._config)
            return True
        except Exception as e:  # noqa: BLE001
            with self._lock:
                self._error = f"{type(e).__name__}: {e}"
            raise
        finally:
            with self._lock:
                self._done = True
            session._set(None, None, None)

    def _run_class_trainable(self) -> None:
        """Drive a Trainable subclass: setup → step loop, reporting each
        step with an auto-checkpoint (PBT exploits restore from these)."""
        from ray_tpu_torch.tune import session

        inst = self._fn()
        inst.config = dict(self._config)
        inst.setup(self._config)
        if self._restore_from is not None:
            state = session.load_checkpoint(self._restore_from)
            inst.load_checkpoint(state.get("trainable_state", state))
            inst.iteration = state.get("_iteration", inst.iteration)
        try:
            while True:
                metrics = inst.step() or {}
                inst.iteration += 1
                session.report(
                    dict(metrics),
                    checkpoint={
                        "trainable_state": inst.save_checkpoint(),
                        "_iteration": inst.iteration,
                    },
                )
                if metrics.get("done"):
                    return
        finally:
            inst.cleanup()

    def _on_report(self, metrics: Dict[str, Any]) -> None:
        with self._lock:
            self._reports.append(metrics)

    def drain(self, cursor: int = 0):
        """Reports from `cursor` onward. NON-destructive: a reply that the
        controller times out on and discards is re-fetched by the next
        drain (the cursor only advances after a delivered reply)."""
        with self._lock:
            return {
                "reports": self._reports[cursor:],
                "done": self._done,
                "error": self._error,
            }


class Tuner:
    def __init__(
        self,
        trainable: Callable[[Dict[str, Any]], None],
        *,
        param_space: Dict[str, Any],
        tune_config: Optional[TuneConfig] = None,
        run_dir: Optional[str] = None,
    ):
        self._trainable = trainable
        self._param_space = param_space
        self._cfg = tune_config or TuneConfig()
        self._run_dir = run_dir or os.path.join(
            str(config.temp_dir), "tune", f"run_{uuid.uuid4().hex[:8]}"
        )

    def _latest_checkpoint(self, tid: str) -> Optional[str]:
        trial_dir = os.path.join(self._run_dir, tid)
        if not os.path.isdir(trial_dir):
            return None
        ckpts = sorted(
            d for d in os.listdir(trial_dir) if d.startswith("checkpoint_")
        )
        return os.path.join(trial_dir, ckpts[-1]) if ckpts else None

    def fit(self) -> ResultGrid:
        cfg = self._cfg
        if cfg.search_alg is not None:
            cfg.search_alg.set_search_space(self._param_space)
            pending = [
                (f"trial_{i:04d}", None) for i in range(cfg.num_samples)
            ]
        else:
            configs = generate_trials(
                self._param_space, cfg.num_samples, seed=cfg.seed
            )
            pending = [
                (f"trial_{i:04d}", c) for i, c in enumerate(configs)
            ]
        fn_blob = serialization.dumps_function(self._trainable)
        results = {
            tid: TrialResult(tid, c) for tid, c in pending if c is not None
        }
        running: Dict[str, Dict[str, Any]] = {}  # tid -> {actor, run_ref}
        os.makedirs(self._run_dir, exist_ok=True)

        from ray_tpu_torch.tune.trainable import trial_resources

        resources = trial_resources(self._trainable) or {}
        if hasattr(cfg.scheduler, "on_trial_add") and cfg.search_alg is None:
            for tid, c in pending:
                cfg.scheduler.on_trial_add(tid, c)

        def launch(tid: str, config: Dict[str, Any],
                   restore_from: Optional[str] = None,
                   prev_iter: int = 0) -> None:
            trial_dir = os.path.join(self._run_dir, tid)
            os.makedirs(trial_dir, exist_ok=True)
            # max_concurrency=2: run() occupies one execution thread for
            # the trial's lifetime; drain() needs the other.
            opts: Dict[str, Any] = {"max_concurrency": 2}
            if resources:
                cpus = resources.get("CPU")
                if cpus is not None:
                    opts["num_cpus"] = cpus
                gpus = resources.get("GPU")
                if gpus is not None:
                    opts["num_gpus"] = gpus
                tpus = resources.get("TPU")
                if tpus is not None:
                    opts["num_tpus"] = tpus
                custom = {
                    k: v for k, v in resources.items()
                    if k not in ("CPU", "GPU", "TPU")
                }
                if custom:
                    opts["resources"] = custom
            actor = _TrialRunner.options(**opts).remote(
                fn_blob, config, trial_dir, restore_from
            )
            running[tid] = {
                "actor": actor,
                "run_ref": actor.run.remote(),
                "iter": prev_iter,
                "cursor": 0,
            }

        def finish(tid: str, stopped_early: bool = False,
                   error: Optional[str] = None) -> None:
            rec = running.pop(tid)
            res = results[tid]
            if cfg.search_alg is not None:
                cfg.search_alg.on_trial_complete(tid, res.metrics)
            res.stopped_early = stopped_early
            if error:
                res.error = error
            try:
                ray_tpu_torch.kill(rec["actor"])
            except Exception:  # noqa: BLE001
                pass
            ckpts = sorted(
                d for d in os.listdir(os.path.join(self._run_dir, tid))
                if d.startswith("checkpoint_")
            ) if os.path.isdir(os.path.join(self._run_dir, tid)) else []
            if ckpts:
                res.checkpoint_path = os.path.join(self._run_dir, tid, ckpts[-1])

        def placed(rec: Dict[str, Any]) -> bool:
            # A runner whose actor still waits for its lease (the card it
            # asks for held by another trial) is queued, not wedged: it is
            # polled, and its misses counted, only once its actor is up.
            if not rec.get("placed"):
                from ray_tpu_torch.core import worker as worker_mod

                info = worker_mod.global_worker().control.call(
                    "get_actor_info", actor_id=rec["actor"]._actor_id
                )
                rec["placed"] = info is not None and info["state"] not in (
                    "DEPENDENCIES_UNREADY", "PENDING_CREATION"
                )
            return rec["placed"]

        while pending or running:
            while pending and len(running) < cfg.max_concurrent_trials:
                tid, config = pending.pop(0)
                if config is None:  # model-based: suggest from history
                    config = cfg.search_alg.suggest(tid)
                    results[tid] = TrialResult(tid, config)
                    if hasattr(cfg.scheduler, "on_trial_add"):
                        cfg.scheduler.on_trial_add(tid, config)
                launch(tid, config)
            time.sleep(0.1)
            for tid in list(running):
                rec = running[tid]
                if not placed(rec):
                    continue
                try:
                    # Short per-poll timeout: a wedged runner must not
                    # head-of-line block the serial poll loop; the miss
                    # budget (~2min) decides wedged-vs-slow. The cursor
                    # makes a timed-out-then-completed drain harmless —
                    # its reports are re-fetched next round.
                    state = ray_tpu_torch.get(
                        rec["actor"].drain.remote(rec["cursor"]),
                        timeout=DRAIN_TIMEOUT_S,
                    )
                    rec["drain_misses"] = 0
                    rec["cursor"] += len(state["reports"])
                except ray_tpu_torch.exceptions.GetTimeoutError:
                    rec["drain_misses"] = rec.get("drain_misses", 0) + 1
                    if rec["drain_misses"] >= 24:
                        finish(tid, error="trial runner unresponsive")
                    continue
                except Exception as e:  # noqa: BLE001 — runner died
                    failures = rec.get("failures", 0)
                    ckpt = self._latest_checkpoint(tid)
                    if failures < cfg.max_failures:
                        # trial FT (reference FailureConfig + tune
                        # controller restore, tune_controller.py:1691):
                        # relaunch from the latest checkpoint
                        logger.warning(
                            "trial %s runner died (%s); restoring from %s "
                            "(failure %d/%d)",
                            tid, e, ckpt, failures + 1, cfg.max_failures,
                        )
                        # no checkpoint yet -> fresh restart (reference
                        # FailureConfig restarts from scratch then)
                        prev_iter = rec["iter"] if ckpt is not None else 0
                        running.pop(tid)
                        try:
                            ray_tpu_torch.kill(rec["actor"])
                        except Exception:  # noqa: BLE001
                            pass
                        launch(tid, results[tid].config,
                               restore_from=ckpt, prev_iter=prev_iter)
                        running[tid]["failures"] = failures + 1
                        continue
                    finish(tid, error=f"trial runner died: {e}")
                    continue
                res = results[tid]
                decision = sched_mod.CONTINUE
                for report in state["reports"]:
                    rec["iter"] += 1
                    report.setdefault("training_iteration", rec["iter"])
                    res.all_reports.append(report)
                    res.metrics = report
                    decision = cfg.scheduler.on_result(tid, report)
                    if decision != sched_mod.CONTINUE:
                        break
                if isinstance(decision, tuple) and decision[0] == "EXPLOIT":
                    # PBT: clone a top trial's checkpoint, restart with
                    # mutated hyperparameters (reference pbt.py exploit)
                    _, src_tid, new_config = decision
                    src_ckpt = self._latest_checkpoint(src_tid)
                    if src_ckpt is not None:
                        logger.info(
                            "PBT: trial %s exploits %s (new config %s)",
                            tid, src_tid, new_config,
                        )
                        prev_iter = rec["iter"]
                        rec_old = running.pop(tid)
                        try:
                            ray_tpu_torch.kill(rec_old["actor"])
                        except Exception:  # noqa: BLE001
                            pass
                        res.config = dict(new_config)
                        res.exploited_from = src_tid
                        launch(tid, new_config, restore_from=src_ckpt,
                               prev_iter=prev_iter)
                        continue
                    decision = sched_mod.CONTINUE  # no ckpt yet: carry on
                if state["done"] or state["error"]:
                    # drain any error; natural completion
                    finish(tid, error=state["error"])
                elif decision == sched_mod.STOP:
                    logger.info("early-stopping trial %s", tid)
                    finish(tid, stopped_early=True)
        return ResultGrid(
            list(results.values()), cfg.metric, cfg.mode
        )

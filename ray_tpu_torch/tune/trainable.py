"""Class Trainable API (parity: reference python/ray/tune/trainable/).

A ``Trainable`` subclass gives the controller step-level control: the
trial runner drives ``setup → step → step → ...``, reporting each step's
metrics, checkpointing via ``save_checkpoint`` (used by PBT exploits),
and restoring via ``load_checkpoint`` when a trial is cloned or resumed.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class Trainable:
    def __init__(self):
        self.config: Dict[str, Any] = {}
        self.iteration = 0

    # -- subclass surface (reference Trainable API) ---------------------

    def setup(self, config: Dict[str, Any]) -> None:
        """One-time initialization with the trial's (possibly mutated)
        hyperparameters."""

    def step(self) -> Dict[str, Any]:
        """One training iteration; returns the metrics to report. Return
        a dict containing ``{"done": True}`` to finish the trial."""
        raise NotImplementedError

    def save_checkpoint(self) -> Dict[str, Any]:
        """Serializable trial state (weights + counters)."""
        return {}

    def load_checkpoint(self, state: Dict[str, Any]) -> None:
        """Restore from ``save_checkpoint`` output."""

    def cleanup(self) -> None:
        """Teardown before the trial actor exits."""


def with_resources(trainable: Any, resources: Dict[str, float]) -> Any:
    """Attach per-trial resource requirements (parity:
    tune.with_resources): the trial actor leases these resources, so
    trial concurrency is bounded by cluster capacity, not just
    max_concurrent_trials."""
    trainable.__rt_trial_resources__ = dict(resources)
    return trainable


def trial_resources(trainable: Any) -> Optional[Dict[str, float]]:
    return getattr(trainable, "__rt_trial_resources__", None)

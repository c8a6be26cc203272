"""In-trial session API: tune.report(...) / tune.get_trial_dir().

Parity: ray.tune.report (reference tune/trainable/session-style API).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional

_local = threading.local()


def _set(report_cb: Optional[Callable], trial_dir: Optional[str],
         config: Optional[Dict[str, Any]],
         restore_from: Optional[str] = None) -> None:
    _local.report_cb = report_cb
    _local.trial_dir = trial_dir
    _local.config = config
    _local.restore_from = restore_from


def get_checkpoint() -> Optional[str]:
    """Checkpoint dir to resume from, if this trial was cloned (PBT
    exploit) or restored; None for a fresh trial. Parity:
    ray.tune.get_checkpoint."""
    return getattr(_local, "restore_from", None)


def report(metrics: Optional[Dict[str, Any]] = None,
           checkpoint: Optional[Dict[str, Any]] = None,
           **kwargs: Any) -> None:
    """Record one result for this trial (and optionally persist a
    checkpoint dict under the trial dir). Accepts a metrics dict, bare
    keyword metrics, or both (reference: both tune.report styles)."""
    metrics = {**(metrics or {}), **kwargs}
    cb = getattr(_local, "report_cb", None)
    if cb is None:
        raise RuntimeError("tune.report() called outside a tune trial")
    if checkpoint is not None:
        import pickle

        trial_dir = _local.trial_dir
        step = len(os.listdir(trial_dir)) if os.path.isdir(trial_dir) else 0
        ckpt_dir = os.path.join(trial_dir, f"checkpoint_{step:06d}")
        os.makedirs(ckpt_dir, exist_ok=True)
        with open(os.path.join(ckpt_dir, "state.pkl"), "wb") as f:
            pickle.dump(checkpoint, f)
        metrics = {**metrics, "_checkpoint": ckpt_dir}
    cb(dict(metrics))


def get_trial_dir() -> str:
    d = getattr(_local, "trial_dir", None)
    if d is None:
        raise RuntimeError("not inside a tune trial")
    return d


def load_checkpoint(ckpt_dir: str) -> Dict[str, Any]:
    import pickle

    with open(os.path.join(ckpt_dir, "state.pkl"), "rb") as f:
        return pickle.load(f)

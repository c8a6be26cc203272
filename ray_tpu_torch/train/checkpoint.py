"""Checkpoint handling.

Parity: ray.train.Checkpoint (python/ray/train/_checkpoint.py) +
CheckpointManager top-k retention (v2/_internal/execution/checkpoint/
checkpoint_manager.py). Storage is a directory tree under
RunConfig.storage_path:

  <run>/checkpoint_<step:6>/rank_<r>/...   per-worker shard dirs

TPU note: sharded-array async checkpointing (orbax) plugs in at the
train-fn level — workers write their own shards into their rank dir and
report() handles the commit barrier, which is exactly the orbax-style
per-host shard write + barrier described in SURVEY.md §5.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple


class Checkpoint:
    """A directory-backed checkpoint handle."""

    def __init__(self, path: str):
        self.path = path

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(os.path.abspath(path))

    def to_directory(self, dest: Optional[str] = None) -> str:
        dest = dest or tempfile.mkdtemp(prefix="rt_ckpt_")
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    def as_directory(self) -> str:
        return self.path

    def rank_dir(self, rank: int) -> str:
        return os.path.join(self.path, f"rank_{rank}")

    def __repr__(self):
        return f"Checkpoint({self.path})"


class CheckpointManager:
    """Top-k checkpoint retention with a score attribute."""

    def __init__(self, run_dir: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None, score_order: str = "max"):
        self.run_dir = run_dir
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        os.makedirs(run_dir, exist_ok=True)
        # [(step, score, path)]
        self._checkpoints: List[Tuple[int, Optional[float], str]] = []
        self._load_existing()

    def _load_existing(self, expected_ranks: Optional[int] = None) -> None:
        known = {c[0] for c in self._checkpoints}
        for name in sorted(os.listdir(self.run_dir)):
            if name.startswith("checkpoint_") and os.path.isdir(
                os.path.join(self.run_dir, name)
            ):
                try:
                    step = int(name.split("_")[1])
                except (IndexError, ValueError):
                    continue
                if step in known:
                    continue
                path = os.path.join(self.run_dir, name)
                if os.path.exists(os.path.join(path, "_complete.json")):
                    pass  # all ranks landed (post-barrier marker)
                elif expected_ranks is not None:
                    ranks = [
                        d for d in os.listdir(path) if d.startswith("rank_")
                    ]
                    if len(ranks) < expected_ranks:
                        continue  # partial write from a crashed attempt
                self._checkpoints.append((step, None, path))

    def rescan(self, expected_ranks: Optional[int] = None) -> None:
        """Pick up checkpoints written by a crashed attempt (only steps
        where every rank's shard landed — report()'s barrier guarantees
        completed steps have all rank dirs)."""
        self._load_existing(expected_ranks)

    def dir_for_step(self, step: int) -> str:
        return os.path.join(self.run_dir, f"checkpoint_{step:06d}")

    def register(self, step: int, metrics: Optional[Dict[str, Any]]) -> Checkpoint:
        path = self.dir_for_step(step)
        score = None
        if self.score_attribute and metrics:
            score = metrics.get(self.score_attribute)
        with open(os.path.join(path, "metrics.json"), "w") as f:
            json.dump(metrics or {}, f)
        self._checkpoints = [c for c in self._checkpoints if c[0] != step]
        self._checkpoints.append((step, score, path))
        self._evict()
        return Checkpoint(path)

    def _evict(self) -> None:
        if self.num_to_keep is None or len(self._checkpoints) <= self.num_to_keep:
            return
        if self.score_attribute:
            # scored checkpoints ranked best-first; unscored ones are the
            # first to go regardless of score_order
            scored = [c for c in self._checkpoints if c[1] is not None]
            unscored = [c for c in self._checkpoints if c[1] is None]
            scored.sort(key=lambda c: c[1], reverse=self.score_order == "max")
            unscored.sort(key=lambda c: c[0], reverse=True)
            ranked = scored + unscored
        else:
            ranked = sorted(self._checkpoints, key=lambda c: c[0], reverse=True)
        keep = ranked[: self.num_to_keep]
        for step, score, path in self._checkpoints:
            if (step, score, path) not in keep:
                shutil.rmtree(path, ignore_errors=True)
        self._checkpoints = keep

    def latest(self) -> Optional[Checkpoint]:
        if not self._checkpoints:
            return None
        return Checkpoint(max(self._checkpoints, key=lambda c: c[0])[2])

    def best(self) -> Optional[Checkpoint]:
        scored = [c for c in self._checkpoints if c[1] is not None]
        if not scored:
            return self.latest()
        reverse = self.score_order == "max"
        return Checkpoint(
            sorted(scored, key=lambda c: c[1], reverse=reverse)[0][2]
        )

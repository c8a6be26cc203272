"""Proxy-side admission control + load shedding.

Bounds the work a proxy will hold instead of letting overload collapse
the whole serving path: past the per-deployment in-flight bound the
proxy sheds with ``503`` (the deployment is overloaded — retry after
backoff), past the per-model concurrency cap with ``429`` (this model
is rate-limited — slow down). Every shed carries ``Retry-After`` so
well-behaved clients back off instead of hammering, and is counted in
``rt_serve_shed_total`` (by deployment and reason) which feeds the
``serve_shed_rate`` alert rule.

Counts are per-proxy (one proxy per node): the bound is "work THIS
proxy has admitted and not yet finished", covering both the fast
direct-RPC path and the pool paths, streaming included (a stream holds
its slot until the generator closes — in-flight is what occupies
replicas, not just what is queued).

This runs on the proxy's HTTP event loop (the fast-path handler), so
everything here must be non-blocking: plain dict bookkeeping under an
uncontended ``threading.Lock``, no RPCs, no sleeps. The rtlint
blocking-async pass pins that (ON_LOOP_FUNCTIONS).
"""

from __future__ import annotations

import math
import os
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class Shed:
    """A rejected admission: everything the HTTP layer needs to answer.
    ``status`` is 503 for deployment overload, 429 for a per-model
    concurrency cap."""

    status: int
    reason: str  # metric tag: "deployment_overload" | "model_concurrency"
    err_type: str  # OpenAI-style error.type for /v1 responses
    retry_after_s: float
    message: str

    def headers(self) -> Dict[str, str]:
        return {"Retry-After": str(max(1, math.ceil(self.retry_after_s)))}


class AdmissionController:
    """Per-proxy admission bookkeeping. ``try_acquire`` either admits
    (returns None; the caller MUST ``release`` exactly once when the
    request — including any streaming body — finishes) or shed
    (returns a ``Shed``; nothing to release)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._node_tag = f"pid{os.getpid()}"
        self._by_dep: Dict[str, int] = {}
        self._by_model: Dict[Tuple[str, str], int] = {}

    def inflight(self, deployment: str) -> int:
        with self._lock:
            return self._by_dep.get(deployment, 0)

    def try_acquire(
        self,
        deployment: str,
        model_id: Optional[str] = None,
        max_inflight: Optional[int] = None,
    ) -> Optional[Shed]:
        from ray_tpu_torch.observability import core_metrics
        from ray_tpu_torch.utils.config import config

        enabled = bool(config.serve_admission_enabled)
        cap = (
            int(max_inflight)
            if max_inflight is not None
            else int(config.serve_admission_max_inflight)
        )
        model_cap = int(config.serve_admission_model_concurrency)
        retry_after = float(config.serve_admission_retry_after_s)
        shed = None
        with self._lock:
            cur = self._by_dep.get(deployment, 0)
            if enabled and cap > 0 and cur >= cap:
                shed = Shed(
                    status=503,
                    reason="deployment_overload",
                    err_type="overloaded_error",
                    retry_after_s=retry_after,
                    message=(
                        f"deployment {deployment!r} is at its in-flight "
                        f"bound ({cap}); retry after backoff"
                    ),
                )
            elif (
                enabled
                and model_id
                and model_cap > 0
                and self._by_model.get((deployment, model_id), 0) >= model_cap
            ):
                shed = Shed(
                    status=429,
                    reason="model_concurrency",
                    err_type="rate_limit_error",
                    retry_after_s=retry_after,
                    message=(
                        f"model {model_id!r} is at its concurrency cap "
                        f"({model_cap}); slow down"
                    ),
                )
            else:
                # Admit. Counting even when disabled keeps acquire/release
                # pairing consistent if the kill switch flips mid-flight.
                self._by_dep[deployment] = cur + 1
                if model_id:
                    key = (deployment, model_id)
                    self._by_model[key] = self._by_model.get(key, 0) + 1
                cur += 1
        if core_metrics.ENABLED:
            if shed is not None:
                core_metrics.serve_shed.inc(
                    tags={"deployment": deployment, "reason": shed.reason}
                )
            else:
                core_metrics.serve_admission_inflight.set(
                    float(cur),
                    tags={"deployment": deployment, "node": self._node_tag},
                )
        return shed

    def release(
        self, deployment: str, model_id: Optional[str] = None
    ) -> None:
        from ray_tpu_torch.observability import core_metrics

        with self._lock:
            cur = self._by_dep.get(deployment, 0) - 1
            if cur <= 0:
                self._by_dep.pop(deployment, None)
                cur = 0
            else:
                self._by_dep[deployment] = cur
            if model_id:
                key = (deployment, model_id)
                n = self._by_model.get(key, 0) - 1
                if n <= 0:
                    self._by_model.pop(key, None)
                else:
                    self._by_model[key] = n
        if core_metrics.ENABLED:
            core_metrics.serve_admission_inflight.set(
                float(cur),
                tags={"deployment": deployment, "node": self._node_tag},
            )

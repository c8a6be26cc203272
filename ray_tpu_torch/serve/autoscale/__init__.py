"""Serving control loop — the acting half of the serving story.

PR 15 built the sensing half (metrics history, SLO burn-rate alerts,
``bench_serve.py``); this package closes the loop:

- ``policy``: the SLO-driven autoscaling policy. ``SignalCollector``
  reads windowed TTFT p95 / KV-slot occupancy / queue depth from the
  head's metrics history plus the burn-rate alert state; ``SLOPolicy``
  turns those into replica-count decisions with hysteresis, cooldowns
  and min/max bounds. Consumed by ``serve/controller.py:_autoscale``.
- ``admission``: proxy-side admission control + load shedding —
  bounded per-deployment in-flight work and per-model concurrency
  caps, shedding 429/503 + ``Retry-After`` instead of collapsing.

Session-aware drain (the third leg) lives in the controller's replica
lifecycle: a scale-down victim leaves the routing table (HRW re-pins
its sessions), finishes its in-flight streams, and only then exits.
"""

from ray_tpu_torch.serve.autoscale.admission import AdmissionController, Shed
from ray_tpu_torch.serve.autoscale.policy import (
    Decision,
    SignalCollector,
    Signals,
    SLOPolicy,
)

__all__ = [
    "AdmissionController",
    "Decision",
    "Shed",
    "SignalCollector",
    "Signals",
    "SLOPolicy",
]

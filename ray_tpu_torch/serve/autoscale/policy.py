"""SLO-driven autoscaling policy.

Replaces the naive requests-per-replica autoscaler with decisions
driven by the signals that actually predict SLO violation:

- windowed TTFT p95 from the head's metrics history (the serving
  north-star, same series the burn-rate alert watches),
- KV-slot occupancy (occupied/total) and queue-depth gauges,
- the ``serve_ttft_p95_burn`` alert state itself — firing is a
  scale-up hint even when raw counts look tame.

Split in two so the decision logic stays unit-testable without a
cluster:

- ``SignalCollector`` does the RPCs (metrics_history / alerts against
  the head) and degrades gracefully: any signal it cannot compute —
  sampler off, no samples in the window, RPC failure — comes back
  ``None``/``False`` and the policy falls back to the ongoing-count
  baseline.
- ``SLOPolicy`` is pure: (current replicas, Signals, autoscaling
  config, now) -> Decision, with hysteresis (separate high/low
  watermarks), cooldowns (scale-up can jump straight to the desired
  count after ``serve_autoscale_up_cooldown_s``; scale-down steps ONE
  replica at a time and only after every signal stayed quiet for
  ``serve_autoscale_down_cooldown_s``, re-armed after each step — with
  sustained FULL idleness overriding windowed echoes of handled
  traffic) and min/max replica bounds.

Tag fallback: engine metrics (serve/llm.py) tag series with the MODEL
id, not the serve deployment name, so the collector tries the
deployment name, then each multiplexed model id seen in replica stats,
then the untagged aggregate.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

from ray_tpu_torch.utils.config import config
from ray_tpu_torch.utils.metrics import hist_quantile

logger = logging.getLogger(__name__)

BURN_RULE = "serve_ttft_p95_burn"


@dataclass
class Signals:
    """One autoscale tick's view of a deployment. ``None`` means "no
    data" (never "zero") — the policy treats missing signals as quiet
    for scale-up and as non-blocking for scale-down."""

    ongoing: int = 0  # queued + running across replicas (always known)
    ttft_p95_s: Optional[float] = None
    kv_occupancy: Optional[float] = None  # occupied/total, 0..1
    queue_depth: Optional[float] = None  # windowed avg queued requests
    burn_firing: bool = False

    def describe(self) -> Dict[str, Any]:
        return {
            "ongoing": self.ongoing,
            "ttft_p95_s": self.ttft_p95_s,
            "kv_occupancy": self.kv_occupancy,
            "queue_depth": self.queue_depth,
            "burn_firing": self.burn_firing,
        }


@dataclass
class Decision:
    target: int
    direction: str  # "up" | "down" | "hold"
    reason: str

    def describe(self) -> Dict[str, Any]:
        return {
            "target": self.target,
            "direction": self.direction,
            "reason": self.reason,
        }


class SLOPolicy:
    """Pure decision engine; one instance per controller, per-deployment
    hysteresis state keyed by deployment name."""

    def __init__(self):
        # name -> {"last_up_ts", "last_down_ts", "ok_since"}
        self._state: Dict[str, Dict[str, Optional[float]]] = {}

    def forget(self, name: str) -> None:
        self._state.pop(name, None)

    def decide(
        self,
        name: str,
        current: int,
        signals: Signals,
        auto: Dict[str, Any],
        now: Optional[float] = None,
    ) -> Decision:
        now = time.monotonic() if now is None else now
        st = self._state.setdefault(
            name, {"last_up_ts": None, "last_down_ts": None, "ok_since": None}
        )
        lo = int(auto.get("min_replicas", 1))
        hi = int(auto.get("max_replicas", 8))
        target_per = max(
            1e-9, float(auto.get("target_ongoing_requests", 1))
        )
        ttft_target = max(1e-9, float(config.alerts_ttft_target_s))
        queue_max = float(config.alerts_queue_depth_max)

        # Baseline: the requests-per-replica count the old policy used.
        # It reacts instantly to a burst, before any windowed series has
        # samples, and keeps behavior on metric-less deployments intact.
        base = math.ceil(signals.ongoing / target_per)

        pressure: List[str] = []
        if signals.burn_firing:
            pressure.append("ttft_burn_firing")
        if (
            signals.ttft_p95_s is not None
            and signals.ttft_p95_s
            > ttft_target * float(config.serve_autoscale_ttft_high_frac)
        ):
            pressure.append(f"ttft_p95={signals.ttft_p95_s:.3f}s")
        if (
            signals.kv_occupancy is not None
            and signals.kv_occupancy
            > float(config.serve_autoscale_kv_high_frac)
        ):
            pressure.append(f"kv_occupancy={signals.kv_occupancy:.2f}")
        if (
            signals.queue_depth is not None
            and signals.queue_depth > queue_max
        ):
            pressure.append(f"queue_depth={signals.queue_depth:.1f}")

        desired = base
        if pressure and signals.ongoing > 0:
            # SLO pressure asks for at least one more replica even when
            # the ongoing count alone would not. With ZERO in-flight
            # work the pressure signals are windowed echoes of traffic
            # already handled — another replica can't serve requests
            # that no longer exist.
            desired = max(desired, current + 1)
        desired = max(lo, min(hi, desired))

        if desired > current:
            st["ok_since"] = None
            last_up = st["last_up_ts"]
            cooldown = float(config.serve_autoscale_up_cooldown_s)
            if last_up is not None and now - last_up < cooldown:
                return Decision(current, "hold", "up_cooldown")
            st["last_up_ts"] = now
            why = pressure[0] if pressure else f"ongoing={signals.ongoing}"
            return Decision(desired, "up", why)

        # Scale-down candidate: every signal must be quiet — below the
        # LOW watermarks, not merely below the high ones (hysteresis) —
        # and stay quiet for the whole down-cooldown before one replica
        # drains. Missing signals don't block (None = no data), and a
        # FULLY idle deployment (zero queued + running at every tick of
        # the cooldown) is quiet regardless: the windowed series and the
        # global burn alert lag by their window lengths, and echoes of a
        # burst that was already handled must not pin replicas up.
        idle = signals.ongoing == 0
        quiet = desired < current and (
            idle
            or (
                not pressure
                and not signals.burn_firing
                and (
                    signals.ttft_p95_s is None
                    or signals.ttft_p95_s
                    < ttft_target
                    * float(config.serve_autoscale_ttft_low_frac)
                )
                and (
                    signals.kv_occupancy is None
                    or signals.kv_occupancy
                    < float(config.serve_autoscale_kv_low_frac)
                )
                and (
                    signals.queue_depth is None
                    or signals.queue_depth < 1.0
                )
            )
        )
        if not quiet:
            st["ok_since"] = None
            return Decision(current, "hold", "steady")
        if st["ok_since"] is None:
            st["ok_since"] = now
        held = now - st["ok_since"]
        cooldown = float(config.serve_autoscale_down_cooldown_s)
        if held < cooldown:
            return Decision(
                current, "hold", f"sustained_ok {held:.0f}s/{cooldown:.0f}s"
            )
        # One step at a time, re-armed: draining is deliberate.
        st["ok_since"] = now
        st["last_down_ts"] = now
        return Decision(
            max(lo, current - 1), "down",
            f"sustained_ok>{cooldown:.0f}s ongoing={signals.ongoing}",
        )


class SignalCollector:
    """Pulls policy signals from the head over an existing control-store
    RPC client. ``call`` is ``client.call``-shaped:
    ``call(method, timeout_s=..., **kwargs) -> result``."""

    def __init__(self, call: Callable[..., Any]):
        self._call = call

    # -- RPC wrappers (each degrades to None on any failure) ----------

    def _history(
        self,
        metric: str,
        tags: Optional[Dict[str, str]],
        window_s: float,
    ) -> Optional[Dict[str, Any]]:
        try:
            out = self._call(
                "metrics_history", name=metric, tags=tags,
                window_s=window_s, timeout_s=5.0,
            )
        except Exception:  # noqa: BLE001 — head restarting, sampler off
            return None
        if not isinstance(out, dict) or not out.get("points"):
            return None
        return out

    def _tag_candidates(
        self, name: str, model_ids: Iterable[str]
    ) -> List[Optional[Dict[str, str]]]:
        cands: List[Optional[Dict[str, str]]] = [{"deployment": name}]
        cands.extend({"deployment": m} for m in dict.fromkeys(model_ids))
        cands.append(None)
        return cands

    def hist_p95(
        self, metric: str, name: str, model_ids: Iterable[str],
        window_s: float,
    ) -> Optional[float]:
        for tags in self._tag_candidates(name, model_ids):
            out = self._history(metric, tags, window_s)
            if out is None or out.get("kind") != "histogram":
                continue
            bounds = out.get("boundaries")
            pts = [p for p in out["points"] if "buckets" in p]
            if not bounds or not pts:
                continue
            buckets = [0.0] * (len(bounds) + 1)
            for p in pts:
                for i, b in enumerate(p["buckets"]):
                    buckets[i] += b
            q = hist_quantile(bounds, buckets, 0.95)
            if q is not None:
                return float(q)
        return None

    def gauge_avg(
        self, metric: str, name: str, model_ids: Iterable[str],
        window_s: float,
    ) -> Optional[float]:
        for tags in self._tag_candidates(name, model_ids):
            out = self._history(metric, tags, window_s)
            if out is None or out.get("kind") != "gauge":
                continue
            vals = [
                p["value"] for p in out["points"] if p.get("value") is not None
            ]
            if vals:
                return float(sum(vals) / len(vals))
        return None

    def burn_firing(self) -> bool:
        try:
            rep = self._call("alerts", timeout_s=5.0)
        except Exception:  # noqa: BLE001
            return False
        for a in (rep or {}).get("alerts", []) or []:
            if a.get("name") == BURN_RULE and a.get("state") == "firing":
                return True
        return False

    # -- the one call the controller makes per deployment per tick ----

    def history_enabled(self) -> bool:
        try:
            inv = self._call("metrics_history", name=None, timeout_s=5.0)
        except Exception:  # noqa: BLE001
            return False
        return bool((inv or {}).get("enabled"))

    def collect(
        self, name: str, model_ids: Iterable[str], ongoing: int
    ) -> Signals:
        if not self.history_enabled():
            # Sampler off (tests, bare clusters): degrade to the
            # ongoing-count baseline + alert state, skip 4×3 doomed RPCs.
            return Signals(
                ongoing=int(ongoing), burn_firing=self.burn_firing()
            )
        window_s = float(config.serve_autoscale_window_s)
        model_ids = list(model_ids)
        ttft = self.hist_p95("rt_serve_ttft_s", name, model_ids, window_s)
        # KV signal: page occupancy (paged engine) preferred — pages
        # track actual KV bytes pinned, where slot occupancy saturated
        # at "every slot holds a request" even with most rows unused.
        # Slot gauges remain the fallback for RT_SERVE_PAGED_KV=0
        # engines (the paged engine also aliases its page numbers onto
        # the slot names for one release, so either branch works).
        occupied = self.gauge_avg(
            "rt_serve_kv_pages_occupied", name, model_ids, window_s
        )
        total = self.gauge_avg(
            "rt_serve_kv_pages_total", name, model_ids, window_s
        )
        if occupied is None or not total:
            occupied = self.gauge_avg(
                "rt_serve_kv_slots_occupied", name, model_ids, window_s
            )
            total = self.gauge_avg(
                "rt_serve_kv_slots_total", name, model_ids, window_s
            )
        occupancy = None
        if occupied is not None and total:
            occupancy = occupied / total
        queue = self.gauge_avg(
            "rt_serve_queued_requests", name, model_ids, window_s
        )
        return Signals(
            ongoing=int(ongoing),
            ttft_p95_s=ttft,
            kv_occupancy=occupancy,
            queue_depth=queue,
            burn_firing=self.burn_firing(),
        )

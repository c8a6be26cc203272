"""Declarative alerting over the metrics history store.

Two rule kinds, both evaluated by the head's sampler tick against
``MetricsHistory`` (observability/history.py):

- ``threshold``: a windowed scalar (gauge avg/max, counter rate, or a
  gauge/gauge ratio via ``denominator``) compared against a bound, which
  must hold for ``for_s`` before the rule fires (threshold-for-duration
  — transient spikes stay in ``pending``).
- ``burn_rate``: the two-window SLO burn-rate pattern (SRE workbook
  chapter 5): fraction-of-observations-over-target / error-budget,
  required to exceed ``factor`` on BOTH a short and a long window. The
  short window makes firing fast; the long window keeps one stray
  sample from paging; requiring both makes resolve fast once the spike
  ends (the short window drains first).

Alert lifecycle: ``ok → pending → firing → resolved(ok)``. Every
transition is stamped as a ``{"type": "alert"}`` event into the head
process's worker event ring via tracing.emit — guarded by
``tracing.ENABLED`` per the check_metric_guards discipline — so firings
land in ``state.timeline()`` next to the request spans that caused
them. Current state is served by ``state.alerts()`` / ``rt alerts`` /
``GET /api/alerts`` and bannered in ``rt top``.

No-data semantics: a rule whose metric has no samples in the window is
treated as not-met (and resolves if firing) — a freshly idle deployment
must not page.

Extra rules ship via ``RT_ALERTS_RULES_EXTRA`` (a JSON list of rule
dicts, same field names as ``Rule``).
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.utils.config import config

logger = logging.getLogger(__name__)

OK = "ok"
PENDING = "pending"
FIRING = "firing"
RESOLVED = "resolved"

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


@dataclass
class Rule:
    name: str
    kind: str  # "threshold" | "burn_rate"
    metric: str
    tags: Optional[Dict[str, str]] = None
    severity: str = "warn"
    # -- threshold fields --
    op: str = ">"
    threshold: float = 0.0
    window_s: float = 30.0
    agg: str = "avg"  # gauge rollup: "avg" | "max" (counters use rate)
    for_s: float = 0.0
    denominator: Optional[str] = None  # ratio rules (e.g. occupancy/total)
    # -- burn_rate fields --
    target_s: float = 0.0  # SLO latency target (bucket threshold)
    budget: float = 0.05  # allowed bad-event fraction
    short_window_s: float = 60.0
    long_window_s: float = 300.0
    factor: float = 1.0  # burn multiple that trips the rule
    extra: Dict[str, Any] = field(default_factory=dict)

    def describe(self) -> Dict[str, Any]:
        d = {
            "name": self.name, "kind": self.kind, "metric": self.metric,
            "severity": self.severity,
        }
        if self.tags:
            d["tags"] = dict(self.tags)
        if self.kind == "burn_rate":
            d.update(target_s=self.target_s, budget=self.budget,
                     short_window_s=self.short_window_s,
                     long_window_s=self.long_window_s, factor=self.factor)
        else:
            d.update(op=self.op, threshold=self.threshold,
                     window_s=self.window_s, for_s=self.for_s)
            if self.denominator:
                d["denominator"] = self.denominator
        return d


def rule_from_dict(d: Dict[str, Any]) -> Rule:
    fields = {f for f in Rule.__dataclass_fields__}
    return Rule(**{k: v for k, v in d.items() if k in fields})


def default_rules() -> List[Rule]:
    """The built-in rule pack. Metric names here are pinned against the
    registered core-metric series by tests/test_alerts.py, so a series
    rename cannot silently orphan a rule."""
    for_s = float(config.alerts_for_s)
    rules = [
        # TTFT SLO: the serving north-star. Burn-rate over the engine
        # admission→first-token histogram.
        Rule(
            name="serve_ttft_p95_burn", kind="burn_rate",
            metric="rt_serve_ttft_s", severity="page",
            target_s=float(config.alerts_ttft_target_s),
            budget=float(config.alerts_ttft_budget),
            short_window_s=float(config.alerts_burn_short_s),
            long_window_s=float(config.alerts_burn_long_s),
            factor=float(config.alerts_burn_factor),
        ),
        # Router/engine backlog: requests waiting for a KV slot.
        Rule(
            name="serve_queue_deep", kind="threshold",
            metric="rt_serve_queued_requests", op=">",
            threshold=float(config.alerts_queue_depth_max),
            window_s=max(for_s, 10.0), agg="avg", for_s=for_s,
        ),
        # KV saturation: occupied/total slot ratio across engines.
        Rule(
            name="serve_kv_occupancy", kind="threshold",
            metric="rt_serve_kv_slots_occupied",
            denominator="rt_serve_kv_slots_total", op=">",
            threshold=float(config.alerts_kv_occupancy_frac),
            window_s=max(for_s, 10.0), agg="avg", for_s=for_s,
        ),
        # Admission control shedding faster than clients should retry:
        # sustained 429/503 volume means capacity, caps, or the
        # autoscaler max bound need attention.
        Rule(
            name="serve_shed_rate", kind="threshold",
            metric="rt_serve_shed_total", op=">",
            threshold=float(config.alerts_shed_rate_max),
            window_s=max(for_s, 10.0), for_s=for_s,
        ),
        # Observability self-check: ring evictions mean truncated
        # timelines and undercounted percentiles.
        Rule(
            name="events_dropped", kind="threshold",
            metric="rt_task_events_dropped_total", op=">",
            threshold=0.0, window_s=30.0, for_s=0.0,
        ),
        # Node health: any node currently marked dead by the health loop.
        Rule(
            name="node_heartbeat_missed", kind="threshold",
            metric="rt_cluster_nodes_dead", op=">", threshold=0.0,
            window_s=15.0, agg="max", for_s=0.0, severity="page",
        ),
    ]
    raw = str(config.alerts_rules_extra).strip()
    if raw:
        try:
            rules.extend(rule_from_dict(d) for d in json.loads(raw))
        except (ValueError, TypeError) as e:
            logger.warning("ignoring malformed alerts_rules_extra: %s", e)
    return rules


class AlertEngine:
    """Evaluates rules against a MetricsHistory on every sampler tick
    and tracks the per-rule state machine."""

    def __init__(self, rules: List[Rule], store,
                 emit: Optional[Callable[[Dict[str, Any]], None]] = None):
        self.rules = list(rules)
        self.store = store
        self._emit = emit
        self._states: Dict[str, Dict[str, Any]] = {
            r.name: {
                "state": OK, "since": None, "pending_since": None,
                "value": None, "last_transition_ts": None, "evals": 0,
            }
            for r in self.rules
        }

    # -- evaluation -----------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        for rule in self.rules:
            try:
                value, met = self._eval_rule(rule, now)
            except Exception:  # noqa: BLE001 — one bad rule ≠ no alerts
                logger.exception("alert rule %s evaluation failed", rule.name)
                continue
            self._advance(rule, value, met, now)

    def _eval_rule(self, rule: Rule, now: float):
        if rule.kind == "burn_rate":
            short = self.store.fraction_above(
                rule.metric, rule.target_s, rule.short_window_s,
                tags=rule.tags, now=now,
            )
            long = self.store.fraction_above(
                rule.metric, rule.target_s, rule.long_window_s,
                tags=rule.tags, now=now,
            )
            if short is None or long is None or rule.budget <= 0:
                return None, False
            burn_short = short / rule.budget
            burn_long = long / rule.budget
            met = burn_short > rule.factor and burn_long > rule.factor
            return burn_short, met
        value = self.store.windowed_value(
            rule.metric, rule.window_s, tags=rule.tags, agg=rule.agg,
            now=now,
        )
        if value is None:
            return None, False
        if rule.denominator:
            denom = self.store.windowed_value(
                rule.denominator, rule.window_s, tags=rule.tags,
                agg=rule.agg, now=now,
            )
            if not denom:
                return None, False
            value = value / denom
        return value, _OPS[rule.op](value, rule.threshold)

    # -- state machine --------------------------------------------------

    def _advance(self, rule: Rule, value: Optional[float], met: bool,
                 now: float) -> None:
        st = self._states[rule.name]
        st["value"] = value
        st["evals"] += 1
        cur = st["state"]
        if met:
            if cur == OK:
                st["state"] = PENDING
                st["pending_since"] = now
                st["since"] = now
                st["last_transition_ts"] = now
                self._stamp(rule, PENDING, value, now)
                cur = PENDING
            if cur == PENDING and now - st["pending_since"] >= rule.for_s:
                # stamp BEFORE flipping the describe()-visible state: the
                # firing stamp can be slow (page severity attaches a
                # forensics capture), and a poller that sees "firing" via
                # rpc_alerts must also find the firing instant in the ring
                self._stamp(rule, FIRING, value, now)
                st["state"] = FIRING
                st["since"] = now
                st["last_transition_ts"] = now
        else:
            if cur == FIRING:
                self._stamp(rule, RESOLVED, value, now)
                st["last_transition_ts"] = now
            if cur != OK:
                st["state"] = OK
                st["since"] = None
                st["pending_since"] = None

    def _stamp(self, rule: Rule, state: str, value: Optional[float],
               now: float) -> None:
        from ray_tpu_torch.observability import tracing

        if not tracing.ENABLED:
            return
        evt = {
            "type": "alert",
            "rule": rule.name,
            "state": state,
            "metric": rule.metric,
            "severity": rule.severity,
            "value": float(value) if value is not None else None,
            "ts_us": tracing.now_us(),
            "pid": os.getpid(),
        }
        if state == FIRING and rule.severity == "page":
            # one automatic hang-forensics capture rides the page event
            # (rate-limited by alert_capture_min_interval_s): the stacks
            # at firing time are exactly what the responder wants and
            # are gone by the time a human runs `rt stacks`
            from ray_tpu_torch.observability import forensics

            capture = forensics.maybe_alert_capture()
            if capture is not None:
                evt["stacks"] = capture
        if self._emit is not None:
            self._emit(evt)
        else:
            tracing.emit(evt)

    # -- reporting ------------------------------------------------------

    def describe(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        now = time.time() if now is None else now
        out = []
        for rule in self.rules:
            st = self._states[rule.name]
            entry = dict(rule.describe())
            entry.update(
                state=st["state"],
                value=st["value"],
                since_s=(now - st["since"]) if st["since"] else None,
                evals=st["evals"],
            )
            out.append(entry)
        return out

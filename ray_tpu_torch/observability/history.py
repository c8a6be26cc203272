"""Metrics history: head-side time-series ring buffers + sampler.

PR 10 gave every metric an instantaneous scrape; nothing retained a time
series, so "TTFT p95 over the last 60 s" (the SLO question) was
uncomputable — only "p95 since boot". This module keeps a bounded,
multi-resolution in-memory history on the head:

- A sampler thread (``HistorySampler``, started by the control store)
  scrapes ``state.cluster_metrics()`` + ``state.request_summary()``
  every ``metrics_sample_interval_s`` (default 1.0 s;
  ``RT_METRICS_SAMPLE_INTERVAL_S=0`` disables the whole plane).
- Each scraped series lands in fixed-cadence ring buffers at three
  resolutions (defaults, in sample-interval units):
  1×interval × 600 points → 10×interval × 360 → 60×interval × 240 —
  at the 1 s default that is 10 minutes at 1 s, 1 hour at 10 s, and
  4 hours at 1 min. Coarser tiers are folded incrementally at append
  time (no rescan): gauges average, counter deltas sum, histogram
  bucket deltas sum.
- Counters are stored as **reset-aware deltas** (``counter_delta``): a
  restarted replica makes a cumulative counter go backwards, and the
  Prometheus convention — treat a decrease as a reset and count the new
  cumulative value as the delta — keeps rates non-negative without
  silently dropping the post-restart traffic to zero.
- Histograms are stored as **per-window bucket deltas**, so a windowed
  percentile is just "sum the bucket deltas over the window, then
  interpolate" (utils/metrics.hist_quantile).

Memory budget (documented, enforced): per series ≤ 600+360+240 = 1200
points. A scalar point is (ts, value[, extra]) ≈ 100 B → ~120 KiB per
scalar series; a histogram point carries one bucket-delta list (core
latency histograms have 14 buckets) ≈ 300 B → ~360 KiB per histogram
series. The store caps distinct series at ``metrics_history_max_series``
(default 2048, counted per (name, tags) pair; overflow series are
dropped and counted in ``stats()``), bounding the store at roughly
2048 × ~360 KiB ≈ 700 MiB absolute worst case but ~10–40 MiB for a
realistic mix (a serving cluster produces tens of series, not
thousands).

Import discipline: ``ray_tpu_torch.utils.*`` at module level; ``ray_tpu_torch.state``
only inside the sampler loop (import-at-use, like tracing.emit).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.utils.metrics import hist_fraction_above, hist_quantile

logger = logging.getLogger(__name__)

# (step multiplier, ring capacity) per tier, in base-interval units.
DEFAULT_TIERS: Tuple[Tuple[int, int], ...] = ((1, 600), (10, 360), (60, 240))


def counter_delta(prev: Optional[float], cur: float) -> float:
    """Reset-aware increase of a cumulative counter between two scrapes
    (Prometheus ``increase`` semantics): normally ``cur - prev``, but a
    decrease means the underlying process restarted and began a fresh
    counter — the observed cumulative value IS the post-reset increase.

    This replaces the old ``max(cur - prev, 0.0)`` clamp in the ``rt
    top`` QPS column, which rendered a silent zero-QPS frame across
    every replica restart."""
    if prev is None or cur < prev:
        return cur
    return cur - prev


def hist_delta(
    prev: Optional[Dict[str, Any]], cur: Dict[str, Any]
) -> Tuple[float, float, List[float]]:
    """Reset-aware (count, sum, buckets) delta between two cumulative
    histogram snapshots. A count decrease marks a reset: the current
    cumulative state is the whole delta."""
    buckets = list(cur.get("buckets") or ())
    if prev is None or cur["count"] < prev["count"]:
        return float(cur["count"]), float(cur["sum"]), buckets
    pb = list(prev.get("buckets") or ())
    if len(pb) != len(buckets):
        # bucket detail appeared/vanished mid-flight (divergent
        # boundaries across workers): restart the delta baseline
        return float(cur["count"]), float(cur["sum"]), buckets
    return (
        float(cur["count"] - prev["count"]),
        float(cur["sum"] - prev["sum"]),
        [c - p for c, p in zip(buckets, pb)],
    )


class _Series:
    """One (metric name, tag values) time series: cumulative baseline
    for delta computation plus per-tier rings and fold accumulators."""

    __slots__ = ("kind", "prev", "rings", "acc")

    def __init__(self, kind: str, tiers: Sequence[Tuple[int, int]]):
        self.kind = kind
        self.prev: Any = None  # last cumulative value (counter/histogram)
        self.rings: List[deque] = [deque(maxlen=cap) for _, cap in tiers]
        # per coarser tier: points accumulated since its last fold
        self.acc: List[List[Tuple]] = [[] for _ in tiers[1:]]


class MetricsHistory:
    """Bounded multi-resolution store for scraped metric snapshots.

    Point shapes per kind (``ts`` = window END, seconds since epoch):
      gauge     ``(ts, value)``          — mean over the window
      counter   ``(ts, delta)``          — reset-aware increase
      histogram ``(ts, count, sum, buckets)`` — per-window deltas
    """

    def __init__(
        self,
        base_step_s: float = 1.0,
        tiers: Sequence[Tuple[int, int]] = DEFAULT_TIERS,
        max_series: int = 2048,
    ):
        self.base_step_s = float(base_step_s)
        self.tiers = tuple((int(m), int(cap)) for m, cap in tiers)
        self.max_series = int(max_series)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, Tuple[str, ...]], _Series] = {}
        # name -> {"kind", "tag_keys", "boundaries"} (latest seen)
        self._meta: Dict[str, Dict[str, Any]] = {}
        self._started = time.time()
        self._ticks = 0
        self._dropped_series = 0
        self._scrape_s_total = 0.0
        self._scrape_s = deque(maxlen=128)  # recent per-tick scrape cost

    # -- append path ----------------------------------------------------

    def record(
        self,
        ts: float,
        snapshot: Dict[str, Dict],
        request_summary: Optional[Dict[str, Any]] = None,
        scrape_s: float = 0.0,
    ) -> None:
        """Ingest one merged cluster snapshot (state.cluster_metrics
        shape) plus optional request-summary derived gauges."""
        with self._lock:
            self._ticks += 1
            self._scrape_s_total += scrape_s
            self._scrape_s.append(scrape_s)
            for name, m in snapshot.items():
                self._record_metric_locked(ts, name, m)
            if request_summary:
                for name, m in _derive_request_gauges(request_summary).items():
                    self._record_metric_locked(ts, name, m)

    def _record_metric_locked(self, ts: float, name: str, m: Dict) -> None:
        kind = m["kind"]
        self._meta[name] = {
            "kind": kind,
            "tag_keys": tuple(m.get("tag_keys", ())),
            "boundaries": tuple(m.get("boundaries", ()) or ()),
        }
        for tagvals, value in m["series"].items():
            key = (name, tuple(tagvals))
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self.max_series:
                    self._dropped_series += 1
                    continue
                s = self._series[key] = _Series(kind, self.tiers)
            if kind == "gauge":
                point: Tuple = (ts, float(value))
            elif kind == "counter":
                point = (ts, counter_delta(s.prev, float(value)))
                s.prev = float(value)
            else:  # histogram
                dcount, dsum, dbuckets = hist_delta(s.prev, value)
                s.prev = {
                    "count": value["count"], "sum": value["sum"],
                    "buckets": list(value.get("buckets") or ()),
                }
                point = (ts, dcount, dsum, dbuckets)
            self._append_locked(s, point)

    def _append_locked(self, s: _Series, point: Tuple) -> None:
        s.rings[0].append(point)
        # incremental fold into coarser tiers: when a tier's accumulator
        # holds ratio-many child points, emit one folded point upward
        child = point
        for i, (mult, _cap) in enumerate(self.tiers[1:]):
            ratio = mult // self.tiers[i][0]
            acc = s.acc[i]
            acc.append(child)
            if len(acc) < ratio:
                return
            child = _fold(s.kind, acc)
            acc.clear()
            s.rings[i + 1].append(child)

    # -- query path -----------------------------------------------------

    def _pick_tier(self, window_s: Optional[float],
                   step_s: Optional[float]) -> int:
        steps = [m * self.base_step_s for m, _ in self.tiers]
        if step_s:
            # coarsest request wins: smallest tier step >= requested
            for i, st in enumerate(steps):
                if st >= step_s * 0.999:
                    return i
            return len(steps) - 1
        if window_s:
            # finest tier whose span covers the window
            for i, ((_m, cap), st) in enumerate(zip(self.tiers, steps)):
                if st * cap >= window_s:
                    return i
            return len(steps) - 1
        return 0

    def query(
        self,
        name: str,
        tags: Optional[Dict[str, str]] = None,
        window_s: Optional[float] = None,
        step_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Aggregated points for one metric: series matching the ``tags``
        subset are summed per timestamp (gauges sum across nodes — queue
        depths and occupancy are cluster totals; counter deltas and
        histogram bucket deltas sum naturally)."""
        now = time.time() if now is None else now
        with self._lock:
            meta = self._meta.get(name)
            if meta is None:
                return {"name": name, "kind": None, "points": [],
                        "step_s": None}
            tier = self._pick_tier(window_s, step_s)
            step = self.tiers[tier][0] * self.base_step_s
            cutoff = (now - window_s) if window_s else None
            kind = meta["kind"]
            agg: Dict[float, List] = {}
            for (mname, tagvals), s in self._series.items():
                if mname != name:
                    continue
                if tags and not _tags_match(meta["tag_keys"], tagvals, tags):
                    continue
                for p in s.rings[tier]:
                    if cutoff is not None and p[0] < cutoff:
                        continue
                    cur = agg.get(p[0])
                    if cur is None:
                        agg[p[0]] = list(p)
                    elif kind == "histogram":
                        cur[1] += p[1]
                        cur[2] += p[2]
                        a, b = cur[3], p[3]
                        if len(b) > len(a):
                            a = a + [0.0] * (len(b) - len(a))
                        cur[3] = [
                            x + (b[i] if i < len(b) else 0.0)
                            for i, x in enumerate(a)
                        ]
                    else:
                        cur[1] += p[1]
            points = []
            for ts in sorted(agg):
                p = agg[ts]
                if kind == "gauge":
                    points.append({"ts": p[0], "value": p[1]})
                elif kind == "counter":
                    points.append({
                        "ts": p[0], "delta": p[1],
                        "rate": p[1] / step if step > 0 else 0.0,
                    })
                else:
                    points.append({
                        "ts": p[0], "count": p[1], "sum": p[2],
                        "buckets": p[3],
                    })
            return {
                "name": name, "kind": kind, "step_s": step,
                "tag_keys": list(meta["tag_keys"]),
                "boundaries": list(meta["boundaries"]),
                "points": points,
            }

    def windowed_hist(
        self,
        name: str,
        window_s: float,
        tags: Optional[Dict[str, str]] = None,
        now: Optional[float] = None,
    ) -> Optional[Dict[str, Any]]:
        """Summed bucket deltas over the trailing window: the windowed
        histogram every percentile/burn-rate computation starts from."""
        q = self.query(name, tags=tags, window_s=window_s, now=now)
        pts = [p for p in q["points"] if "buckets" in p]
        if q["kind"] != "histogram" or not pts:
            return None
        buckets = [0.0] * max(len(p["buckets"]) for p in pts)
        count = 0.0
        total = 0.0
        for p in pts:
            count += p["count"]
            total += p["sum"]
            for i, b in enumerate(p["buckets"]):
                buckets[i] += b
        return {
            "boundaries": q["boundaries"], "buckets": buckets,
            "count": count, "sum": total,
        }

    def quantile(
        self,
        name: str,
        q: float,
        window_s: float,
        tags: Optional[Dict[str, str]] = None,
        now: Optional[float] = None,
    ) -> Optional[float]:
        h = self.windowed_hist(name, window_s, tags=tags, now=now)
        if h is None:
            return None
        return hist_quantile(h["boundaries"], h["buckets"], q)

    def fraction_above(
        self,
        name: str,
        threshold: float,
        window_s: float,
        tags: Optional[Dict[str, str]] = None,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Windowed share of observations above ``threshold`` — the SLO
        burn-rate numerator ("bad-event fraction over the window")."""
        h = self.windowed_hist(name, window_s, tags=tags, now=now)
        if h is None or not h["count"]:
            return None
        return hist_fraction_above(h["boundaries"], h["buckets"], threshold)

    def windowed_value(
        self,
        name: str,
        window_s: float,
        tags: Optional[Dict[str, str]] = None,
        agg: str = "avg",
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Scalar rollup over the window for threshold rules: gauges
        average or max over points; counters return the windowed rate
        (total delta / window). None when the window holds no samples."""
        qr = self.query(name, tags=tags, window_s=window_s, now=now)
        pts = qr["points"]
        if not pts:
            return None
        if qr["kind"] == "counter":
            return sum(p["delta"] for p in pts) / window_s
        vals = [p.get("value", 0.0) for p in pts]
        return max(vals) if agg == "max" else sum(vals) / len(vals)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            scrapes = sorted(self._scrape_s)
            return {
                "base_step_s": self.base_step_s,
                "tiers": [
                    {"step_s": m * self.base_step_s, "capacity": cap}
                    for m, cap in self.tiers
                ],
                "series": len(self._series),
                "names": sorted(self._meta),
                "max_series": self.max_series,
                "dropped_series": self._dropped_series,
                "ticks": self._ticks,
                "uptime_s": time.time() - self._started,
                "scrape_s_total": self._scrape_s_total,
                "scrape_s_p50": (
                    scrapes[len(scrapes) // 2] if scrapes else 0.0
                ),
            }


def _fold(kind: str, children: List[Tuple]) -> Tuple:
    """Fold ratio-many fine points into one coarse point (ts = last
    child's window end)."""
    ts = children[-1][0]
    if kind == "gauge":
        return (ts, sum(c[1] for c in children) / len(children))
    if kind == "counter":
        return (ts, sum(c[1] for c in children))
    nb = max(len(c[3]) for c in children)
    buckets = [0.0] * nb
    for c in children:
        for i, b in enumerate(c[3]):
            buckets[i] += b
    return (
        ts,
        sum(c[1] for c in children),
        sum(c[2] for c in children),
        buckets,
    )


def _tags_match(tag_keys: Tuple[str, ...], tagvals: Tuple[str, ...],
                want: Dict[str, str]) -> bool:
    have = dict(zip(tag_keys, tagvals))
    return all(have.get(k) == str(v) for k, v in want.items())


def _derive_request_gauges(reqs: Dict[str, Any]) -> Dict[str, Dict]:
    """Synthesize per-deployment gauges from a request_summary rollup so
    traced end-to-end percentiles get history too (the engine-side TTFT
    histogram measures admission→first-token; these cover the full
    proxy-inclusive path)."""
    out: Dict[str, Dict] = {}
    for dep, entry in (reqs.get("deployments") or {}).items():
        e2e = entry.get("e2e_s") or {}
        for q in ("p50", "p95", "p99"):
            if q not in e2e:
                continue
            m = out.setdefault(f"rt_request_e2e_{q}_s", {
                "kind": "gauge", "tag_keys": ("deployment",), "series": {},
            })
            m["series"][(str(dep),)] = float(e2e[q])
    return out


class HistorySampler:
    """The head-side scrape loop: one daemon thread driving the store
    (and, when alerting is on, the alert engine) every interval. Scrape
    failures during cluster churn/teardown are swallowed — a sampler
    must never take the control store down with it."""

    THREAD_NAME = "cs-obs"

    def __init__(
        self,
        store: MetricsHistory,
        control_address: str,
        stopped: threading.Event,
        interval_s: float,
        on_tick: Optional[Callable[[float], None]] = None,
    ):
        self.store = store
        self.control_address = control_address
        self._stopped = stopped
        self.interval_s = float(interval_s)
        self._on_tick = on_tick
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name=self.THREAD_NAME, daemon=True
        )
        self._thread.start()

    def _scrape(self) -> Tuple[Dict[str, Dict], Dict[str, Any]]:
        from ray_tpu_torch import state

        mx = state.cluster_metrics(self.control_address)
        reqs = state.request_summary(self.control_address)
        return mx, reqs

    def _loop(self) -> None:
        while not self._stopped.wait(self.interval_s):
            t0 = time.perf_counter()
            try:
                mx, reqs = self._scrape()
            except Exception as e:  # noqa: BLE001 — teardown races
                logger.debug("history scrape failed: %s", e)
                continue
            scrape_s = time.perf_counter() - t0
            now = time.time()
            try:
                self.store.record(
                    now, mx, request_summary=reqs, scrape_s=scrape_s
                )
                if self._on_tick is not None:
                    self._on_tick(now)
            except Exception:  # noqa: BLE001
                logger.exception("history record/evaluate failed")

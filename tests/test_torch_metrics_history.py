"""The port's metrics history (``ray_tpu_torch/observability/history.py``,
a pinned copy of the JAX package's) and the sampler plane its control
store starts: the contracts of ``tests/test_metrics_history.py``, re-run.
Reset-aware deltas, multi-resolution ring folding, windowed percentiles
against a direct reference, the head-side sampler plane end-to-end at the
default interval and at 0; the e2e test reads the series through the
port's dashboard route (/api/metrics/history), as the JAX test does."""

import json
import threading
import time

import pytest

from ray_tpu_torch.observability.history import (
    MetricsHistory,
    counter_delta,
    hist_delta,
)
from ray_tpu_torch.utils.metrics import hist_quantile

# small tiers so every fold level is exercised in a handful of appends:
# 1-unit ring of 10, 5-unit ring of 6, 25-unit ring of 4
TIERS = ((1, 10), (5, 6), (25, 4))


def _gauge(value, ts=None):
    return {"g": {"kind": "gauge", "tag_keys": (), "series": {(): value}}}


def _counter(value, tags=("a",)):
    return {
        "c": {
            "kind": "counter",
            "tag_keys": ("k",),
            "series": {tags: value},
        }
    }


def _hist(count, total, buckets, bounds=(0.1, 1.0)):
    return {
        "h": {
            "kind": "histogram",
            "tag_keys": (),
            "boundaries": bounds,
            "series": {(): {"count": count, "sum": total,
                            "buckets": list(buckets)}},
        }
    }


# -- unit: reset-aware deltas ---------------------------------------------


def test_counter_delta_monotonic_reset_none():
    assert counter_delta(None, 5.0) == 5.0  # first scrape: all of it
    assert counter_delta(5.0, 8.0) == 3.0  # normal increase
    assert counter_delta(8.0, 8.0) == 0.0  # idle
    # decrease = process restart: the new cumulative IS the increase,
    # never a negative and never a silent zero
    assert counter_delta(8.0, 2.0) == 2.0
    assert counter_delta(2.0, 0.0) == 0.0


def test_hist_delta_reset_and_bucket_change():
    prev = {"count": 10, "sum": 5.0, "buckets": [6, 4]}
    cur = {"count": 13, "sum": 6.5, "buckets": [8, 5]}
    assert hist_delta(prev, cur) == (3.0, 1.5, [2, 1])
    # count went backwards -> restart: current cumulative is the delta
    reset = {"count": 2, "sum": 0.4, "buckets": [2, 0]}
    assert hist_delta(prev, reset) == (2.0, 0.4, [2, 0])
    # bucket arity changed (boundaries diverged mid-flight) -> rebaseline
    widened = {"count": 12, "sum": 6.0, "buckets": [6, 4, 2]}
    assert hist_delta(prev, widened) == (12.0, 6.0, [6, 4, 2])
    assert hist_delta(None, cur) == (13.0, 6.5, [8, 5])


# -- store: every tier, every kind ----------------------------------------


def test_gauge_folds_mean_through_every_tier():
    h = MetricsHistory(base_step_s=1.0, tiers=TIERS, max_series=64)
    # 50 ticks of a ramp: values 0..49 at ts 0..49
    for t in range(50):
        h.record(float(t), _gauge(float(t)))
    q0 = h.query("g")
    assert q0["kind"] == "gauge" and q0["step_s"] == 1.0
    assert [p["value"] for p in q0["points"]] == [
        float(v) for v in range(40, 50)
    ]  # ring of 10 keeps the last 10
    q1 = h.query("g", step_s=5.0)
    assert q1["step_s"] == 5.0
    # each 5-wide fold averages its children: mean(20..24)=22, ...
    assert [p["value"] for p in q1["points"]] == [22.0, 27.0, 32.0, 37.0,
                                                  42.0, 47.0]
    q2 = h.query("g", step_s=25.0)
    assert q2["step_s"] == 25.0
    assert [p["value"] for p in q2["points"]] == [12.0, 37.0]


def test_counter_folds_sum_and_reset_never_negative():
    h = MetricsHistory(base_step_s=1.0, tiers=TIERS, max_series=64)
    cum = 0.0
    for t in range(12):
        cum += 2.0
        if t == 7:
            cum = 1.0  # replica restart mid-run
        h.record(float(t), _counter(cum))
    q = h.query("c")
    deltas = [p["delta"] for p in q["points"]]
    assert all(d >= 0.0 for d in deltas)
    # tick 0 baselines at 2.0 (first scrape), tick 7 resets to 1.0
    assert deltas[-5] == 1.0  # the reset tick
    rates = [p["rate"] for p in q["points"]]
    assert rates == deltas  # step is 1 s
    # tier-1 folds are SUMS of deltas (increase over 5 s), not averages
    q1 = h.query("c", step_s=5.0)
    assert q1["points"][0]["delta"] == pytest.approx(10.0)  # ticks 0-4
    assert q1["points"][0]["rate"] == pytest.approx(2.0)


def test_histogram_windowed_quantile_matches_direct_reference():
    bounds = (0.1, 0.5, 1.0, 5.0)
    h = MetricsHistory(base_step_s=1.0, tiers=TIERS, max_series=64)
    # cumulative growth: each tick adds one observation per bucket slot
    # according to a schedule; track the flat list of per-window deltas
    cum = [0, 0, 0, 0, 0]
    schedule = [
        [1, 0, 0, 0, 0], [0, 2, 0, 0, 0], [0, 0, 3, 0, 0],
        [0, 0, 0, 1, 0], [2, 1, 0, 0, 1], [0, 0, 4, 0, 0],
    ]
    count = 0
    total = 0.0
    for t, add in enumerate(schedule):
        cum = [c + a for c, a in zip(cum, add)]
        count += sum(add)
        total += sum(add) * 0.3
        h.record(float(t), _hist(count, total, cum, bounds=bounds))
    # reference: windowed bucket deltas over the last 3 ticks = the sum
    # of the last 3 schedule rows, interpolated the same way
    ref_buckets = [sum(col) for col in zip(*schedule[3:])]
    ref = hist_quantile(bounds, ref_buckets, 0.95)
    got = h.quantile("h", 0.95, window_s=3.0, now=5.0)
    assert got == pytest.approx(ref)
    # whole-history window equals the full cumulative distribution
    # (window 6 s stays on the finest tier, which holds every tick)
    ref_all = hist_quantile(bounds, cum, 0.95)
    assert h.quantile("h", 0.95, window_s=6.0, now=5.0) == \
        pytest.approx(ref_all)
    # fraction_above agrees with the definition at a bucket edge
    frac = h.fraction_above("h", 5.0, window_s=6.0, now=5.0)
    assert frac == pytest.approx(cum[4] / sum(cum))


def test_tag_filter_and_cross_series_sum():
    h = MetricsHistory(base_step_s=1.0, tiers=TIERS, max_series=64)
    snap = {
        "q": {
            "kind": "gauge", "tag_keys": ("deployment", "node"),
            "series": {("d1", "n1"): 3.0, ("d1", "n2"): 5.0,
                       ("d2", "n1"): 100.0},
        }
    }
    h.record(1.0, snap)
    allp = h.query("q")["points"]
    assert allp[0]["value"] == 108.0  # untagged query sums the cluster
    d1 = h.query("q", tags={"deployment": "d1"})["points"]
    assert d1[0]["value"] == 8.0  # subset-match sums within the subset
    d2n1 = h.query("q", tags={"deployment": "d2", "node": "n1"})["points"]
    assert d2n1[0]["value"] == 100.0
    assert h.query("q", tags={"deployment": "nope"})["points"] == []
    assert h.query("missing")["points"] == []


def test_series_cap_drops_and_counts():
    h = MetricsHistory(base_step_s=1.0, tiers=TIERS, max_series=3)
    snap = {
        "m": {
            "kind": "gauge", "tag_keys": ("i",),
            "series": {(str(i),): float(i) for i in range(10)},
        }
    }
    h.record(1.0, snap)
    st = h.stats()
    assert st["series"] == 3
    assert st["dropped_series"] == 7
    assert st["ticks"] == 1


def test_windowed_value_gauge_counter_and_no_data():
    h = MetricsHistory(base_step_s=1.0, tiers=TIERS, max_series=64)
    for t in range(5):
        h.record(float(t), {**_gauge(float(t * 10)), **_counter(float(t))})
    # cutoff is inclusive: ts >= now - window -> ticks 1,2,3,4
    assert h.windowed_value("g", window_s=3.0, now=4.0) == \
        pytest.approx(25.0)  # mean of 10,20,30,40
    assert h.windowed_value("g", window_s=3.0, agg="max", now=4.0) == 40.0
    # counter: total windowed delta / window (deltas of 1.0 at ticks 1-4)
    assert h.windowed_value("c", window_s=3.0, now=4.0) == \
        pytest.approx(4.0 / 3.0)
    assert h.windowed_value("g", window_s=3.0, now=100.0) is None
    assert h.windowed_value("nope", window_s=3.0) is None


def test_pick_tier_prefers_finest_covering_window():
    h = MetricsHistory(base_step_s=1.0, tiers=TIERS, max_series=4)
    assert h._pick_tier(None, None) == 0
    assert h._pick_tier(8.0, None) == 0  # 10-point 1 s ring covers 8 s
    assert h._pick_tier(25.0, None) == 1  # needs the 5 s × 6 ring
    assert h._pick_tier(90.0, None) == 2
    assert h._pick_tier(None, 5.0) == 1  # explicit step wins
    assert h._pick_tier(None, 1000.0) == 2  # clamped to coarsest


def test_derived_request_gauges_land_in_history():
    h = MetricsHistory(base_step_s=1.0, tiers=TIERS, max_series=64)
    reqs = {"deployments": {"d1": {"e2e_s": {"p50": 0.1, "p95": 0.4,
                                             "p99": 0.9}}}}
    h.record(1.0, {}, request_summary=reqs)
    q = h.query("rt_request_e2e_p95_s", tags={"deployment": "d1"})
    assert q["points"][0]["value"] == pytest.approx(0.4)


# -- cluster e2e: sampler thread + state API + dashboard route -----------


def test_history_sampler_e2e_cluster():
    import ray_tpu_torch
    from ray_tpu_torch import state
    from ray_tpu_torch.core import cluster_utils
    from ray_tpu_torch.observability import core_metrics
    from ray_tpu_torch.observability.history import HistorySampler
    from ray_tpu_torch.utils.config import config

    config.set("metrics_sample_interval_s", 0.2)
    try:
        cluster_utils.sweep_stale_runtime()
        ray_tpu_torch.init(num_cpus=2)
        try:
            # sampler thread exists under its documented name
            names = [t.name for t in threading.enumerate()]
            assert HistorySampler.THREAD_NAME in names
            # drive a counter from the driver (its registry is scraped)
            for _ in range(5):
                core_metrics.lease_requests.inc()
            deadline = time.time() + 15.0
            pts = []
            while time.time() < deadline:
                rep = state.metrics_history(
                    "rt_lease_requests_total", window_s=30.0
                )
                if rep.get("enabled") and rep.get("points"):
                    pts = rep["points"]
                    if sum(p["delta"] for p in pts) >= 5.0:
                        break
                time.sleep(0.2)
            assert pts, "sampler never recorded the driver counter"
            assert sum(p["delta"] for p in pts) >= 5.0
            assert all(p["delta"] >= 0.0 for p in pts)
            # inventory form (no name) reports sampler stats
            inv = state.metrics_history()
            assert inv["enabled"] and inv["ticks"] >= 1
            assert "rt_lease_requests_total" in inv["names"]
            # dashboard route parses query params and round-trips JSON
            from ray_tpu_torch.core import worker as worker_mod
            from ray_tpu_torch.dashboard import Dashboard

            addr = worker_mod.global_worker().control_address
            dash = Dashboard(addr, port=0)
            try:
                status, ctype, body = dash._route(
                    "/api/metrics/history?name=rt_lease_requests_total"
                    "&window_s=30&step_s=0.2"
                )
                assert status == 200 and ctype == "application/json"
                rep = json.loads(body)
                assert rep["enabled"] and rep["name"] == \
                    "rt_lease_requests_total"
                assert sum(p["delta"] for p in rep["points"]) >= 5.0
            finally:
                dash._server.server_close()
        finally:
            ray_tpu_torch.shutdown()
    finally:
        config.set("metrics_sample_interval_s", 1.0)


def test_history_disabled_with_zero_interval():
    import ray_tpu_torch
    from ray_tpu_torch import state
    from ray_tpu_torch.core import cluster_utils
    from ray_tpu_torch.observability.history import HistorySampler
    from ray_tpu_torch.utils.config import config

    # an earlier cluster's sampler may still be ending its last scrape
    for t in threading.enumerate():
        if t.name == HistorySampler.THREAD_NAME:
            t.join(timeout=30)
    config.set("metrics_sample_interval_s", 0)
    try:
        cluster_utils.sweep_stale_runtime()
        ray_tpu_torch.init(num_cpus=1)
        try:
            names = [t.name for t in threading.enumerate()]
            assert HistorySampler.THREAD_NAME not in names
            assert state.metrics_history() == {"enabled": False}
            assert state.alerts() == {"enabled": False, "alerts": []}
        finally:
            ray_tpu_torch.shutdown()
    finally:
        config.set("metrics_sample_interval_s", 1.0)

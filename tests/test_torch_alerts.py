"""The port's alert engine (``ray_tpu_torch/observability/alerts.py``, a
pinned copy of the JAX package's): the contracts of ``tests/test_alerts.py``,
re-run. Default-rule-pack metric pinning, the threshold/burn-rate state
machines over a real history store, extra-rule config parsing, and the
end-to-end spike -> firing -> timeline -> resolved loop through a live
port cluster, read through the port's ``rt alerts`` and ``rt top`` (as the
JAX test reads them) and its dashboard's /api/alerts route."""

import json
import threading
import time

import pytest

from ray_tpu_torch.observability import core_metrics
from ray_tpu_torch.observability.alerts import (
    FIRING,
    OK,
    PENDING,
    RESOLVED,
    AlertEngine,
    Rule,
    default_rules,
    rule_from_dict,
)
from ray_tpu_torch.observability.history import MetricsHistory
from ray_tpu_torch.utils import metrics as metrics_mod
from ray_tpu_torch.utils.config import config

TIERS = ((1, 60), (5, 12), (25, 4))


def _registered_core_metric_names():
    """Prometheus series names of every instrument core_metrics builds,
    keyed by kind — read from the module attributes themselves so the
    pinning test tracks renames automatically."""
    names = {}
    for attr in dir(core_metrics):
        obj = getattr(core_metrics, attr)
        if isinstance(obj, metrics_mod._Metric):
            kind = {
                metrics_mod.Counter: "counter",
                metrics_mod.Gauge: "gauge",
                metrics_mod.Histogram: "histogram",
            }[type(obj)]
            names[obj.name] = kind
    return names


# -- satellite (d): the default pack must reference real series -----------


def test_default_rule_pack_metrics_are_registered():
    names = _registered_core_metric_names()
    rules = default_rules()
    assert {r.name for r in rules} >= {
        "serve_ttft_p95_burn", "serve_queue_deep", "serve_kv_occupancy",
        "events_dropped", "node_heartbeat_missed",
    }
    for r in rules:
        assert r.metric in names, (
            f"rule {r.name} references unregistered metric {r.metric}"
        )
        if r.denominator:
            assert r.denominator in names, (
                f"rule {r.name} denominator {r.denominator} unregistered"
            )
        if r.kind == "burn_rate":
            # burn rates need bucket detail to interpolate
            assert names[r.metric] == "histogram", (
                f"burn-rate rule {r.name} needs a histogram metric"
            )
        assert r.kind in ("threshold", "burn_rate")
        assert r.severity in ("warn", "page")


def test_rule_from_dict_filters_unknown_fields():
    r = rule_from_dict({
        "name": "x", "kind": "threshold", "metric": "m",
        "threshold": 5.0, "bogus_field": 1,
    })
    assert r.name == "x" and r.threshold == 5.0
    assert not hasattr(r, "bogus_field")


def test_extra_rules_from_config():
    extra = json.dumps([{
        "name": "custom_queue", "kind": "threshold",
        "metric": "rt_sched_queue_depth", "threshold": 5.0,
    }])
    config.set("alerts_rules_extra", extra)
    try:
        rules = default_rules()
        assert any(r.name == "custom_queue" for r in rules)
        config.set("alerts_rules_extra", "not json")
        assert all(
            r.name != "custom_queue" for r in default_rules()
        )  # malformed extras are dropped, defaults survive
    finally:
        config.set("alerts_rules_extra", "")


# -- state machines over a real store -------------------------------------


def _gauge_snap(value):
    return {"g": {"kind": "gauge", "tag_keys": (), "series": {(): value}}}


def test_threshold_for_duration_state_machine():
    h = MetricsHistory(base_step_s=1.0, tiers=TIERS, max_series=16)
    events = []
    rule = Rule(name="q", kind="threshold", metric="g", op=">",
                threshold=10.0, window_s=3.0, agg="avg", for_s=2.0)
    eng = AlertEngine([rule], h, emit=events.append)
    # above threshold from t=0: pending at t0, firing once held 2 s
    for t in range(5):
        h.record(float(t), _gauge_snap(20.0))
        eng.evaluate(now=float(t))
    assert eng._states["q"]["state"] == FIRING
    assert [e["state"] for e in events] == [PENDING, FIRING]
    assert events[0]["rule"] == "q" and events[0]["type"] == "alert"
    assert events[1]["value"] == pytest.approx(20.0)
    # drop to zero: the 3 s windowed average must drain below threshold
    # before the rule resolves (no flapping on a single good sample)
    t = 5
    while eng._states["q"]["state"] == FIRING and t < 20:
        h.record(float(t), _gauge_snap(0.0))
        eng.evaluate(now=float(t))
        t += 1
    assert eng._states["q"]["state"] == OK
    assert [e["state"] for e in events] == [PENDING, FIRING, RESOLVED]


def test_threshold_transient_stays_pending():
    h = MetricsHistory(base_step_s=1.0, tiers=TIERS, max_series=16)
    events = []
    rule = Rule(name="q", kind="threshold", metric="g", op=">",
                threshold=10.0, window_s=2.0, agg="max", for_s=5.0)
    eng = AlertEngine([rule], h, emit=events.append)
    h.record(0.0, _gauge_snap(50.0))  # one-tick spike
    eng.evaluate(now=0.0)
    assert eng._states["q"]["state"] == PENDING
    for t in range(1, 8):
        h.record(float(t), _gauge_snap(0.0))
        eng.evaluate(now=float(t))
    # spike ended before for_s elapsed: back to ok, never fired, and a
    # pending->ok transition is silent (no resolved stamp for non-firing)
    assert eng._states["q"]["state"] == OK
    assert [e["state"] for e in events] == [PENDING]


def test_threshold_ratio_denominator():
    h = MetricsHistory(base_step_s=1.0, tiers=TIERS, max_series=16)
    snap = {
        "occ": {"kind": "gauge", "tag_keys": (), "series": {(): 19.0}},
        "tot": {"kind": "gauge", "tag_keys": (), "series": {(): 20.0}},
    }
    rule = Rule(name="kv", kind="threshold", metric="occ",
                denominator="tot", op=">", threshold=0.9,
                window_s=3.0, for_s=0.0)
    eng = AlertEngine([rule], h, emit=lambda e: None)
    h.record(0.0, snap)
    eng.evaluate(now=0.0)
    st = eng._states["kv"]
    assert st["state"] == FIRING
    assert st["value"] == pytest.approx(0.95)


def test_burn_rate_two_window_fire_and_resolve():
    bounds = (0.1, 1.0)
    h = MetricsHistory(base_step_s=1.0, tiers=TIERS, max_series=16)
    events = []
    rule = Rule(name="slo", kind="burn_rate", metric="h",
                target_s=0.1, budget=0.5, short_window_s=2.0,
                long_window_s=4.0, factor=1.0)
    eng = AlertEngine([rule], h, emit=events.append)
    # every observation lands above target (overflow bucket): bad
    # fraction 1.0 -> burn 2.0 > factor on both windows immediately
    h.record(0.0, {"h": {
        "kind": "histogram", "tag_keys": (), "boundaries": bounds,
        "series": {(): {"count": 10, "sum": 50.0, "buckets": [0, 0, 10]}},
    }})
    eng.evaluate(now=0.0)
    assert eng._states["slo"]["state"] == FIRING  # for_s=0: same tick
    assert [e["state"] for e in events] == [PENDING, FIRING]
    assert eng._states["slo"]["value"] == pytest.approx(2.0)
    # spike ends: no further deltas. Once the short window slides past
    # the last bad point it holds no samples -> not met -> resolved.
    eng.evaluate(now=1.0)
    assert eng._states["slo"]["state"] == FIRING  # still in window
    eng.evaluate(now=3.5)
    assert eng._states["slo"]["state"] == OK
    assert [e["state"] for e in events] == [PENDING, FIRING, RESOLVED]


def test_no_data_never_pages_and_bad_rule_is_isolated():
    h = MetricsHistory(base_step_s=1.0, tiers=TIERS, max_series=16)
    events = []
    rules = [
        Rule(name="ghost", kind="threshold", metric="never_scraped",
             op=">", threshold=0.0, window_s=10.0),
        Rule(name="broken", kind="threshold", metric="g", op="!!",
             threshold=0.0, window_s=10.0),  # unknown op -> KeyError
        Rule(name="live", kind="threshold", metric="g", op=">",
             threshold=1.0, window_s=10.0, for_s=0.0),
    ]
    eng = AlertEngine(rules, h, emit=events.append)
    h.record(0.0, _gauge_snap(5.0))
    eng.evaluate(now=0.0)
    assert eng._states["ghost"]["state"] == OK
    assert eng._states["broken"]["state"] == OK  # failed eval, no crash
    assert eng._states["live"]["state"] == FIRING  # others still ran
    rep = eng.describe(now=0.0)
    by_name = {r["name"]: r for r in rep}
    assert by_name["live"]["state"] == FIRING
    assert by_name["ghost"]["value"] is None


# -- e2e: spike -> firing -> timeline + state API -> resolved -------------


def test_alert_loop_e2e_cluster(capsys):
    import ray_tpu_torch
    from ray_tpu_torch import state
    from ray_tpu_torch.cli import main as cli_main
    from ray_tpu_torch.core import cluster_utils
    from ray_tpu_torch.core import worker as worker_mod
    from ray_tpu_torch.observability.history import HistorySampler

    config.set("metrics_sample_interval_s", 0.1)
    config.set("alerts_ttft_target_s", 0.5)
    config.set("alerts_burn_short_s", 1.0)
    config.set("alerts_burn_long_s", 3.0)
    try:
        cluster_utils.sweep_stale_runtime()
        ray_tpu_torch.init(num_cpus=2)
        try:
            assert HistorySampler.THREAD_NAME in [
                t.name for t in threading.enumerate()
            ]
            addr = worker_mod.global_worker().control_address
            rep = state.alerts(addr)
            assert rep["enabled"]
            assert {a["name"] for a in rep["alerts"]} >= {
                "serve_ttft_p95_burn", "node_heartbeat_missed",
            }
            # TTFT spike: every observation far above the 0.5 s target
            for _ in range(30):
                core_metrics.serve_ttft_s.observe(
                    4.0, tags={"deployment": "d1"}
                )
            deadline = time.time() + 15.0
            fired = None
            while time.time() < deadline:
                rep = state.alerts(addr)
                by = {a["name"]: a for a in rep["alerts"]}
                if by["serve_ttft_p95_burn"]["state"] == "firing":
                    fired = by["serve_ttft_p95_burn"]
                    break
                time.sleep(0.1)
            assert fired is not None, "burn rule never fired on the spike"
            assert fired["severity"] == "page"
            assert fired["value"] > 1.0  # burn multiple, not a latency
            # firing transition landed in the head's event ring and
            # renders as a timeline instant
            tl = state.timeline(addr)
            alert_evts = [
                e for e in tl if e.get("cat") == "alert"
                and "serve_ttft_p95_burn" in e.get("name", "")
            ]
            assert any(
                e["name"].endswith(":firing") for e in alert_evts
            ), f"no firing instant in timeline: {alert_evts}"
            # rt alerts exits 2 while firing; --json round-trips
            rc = cli_main(["--address", addr, "--json", "alerts"])
            out = capsys.readouterr().out
            assert rc == 2
            parsed = json.loads(out)
            assert parsed["enabled"]
            assert any(
                a["name"] == "serve_ttft_p95_burn"
                and a["state"] == "firing" for a in parsed["alerts"]
            )
            # the dashboard's route answers the same
            from ray_tpu_torch.dashboard import Dashboard

            dash = Dashboard(addr, port=0)
            try:
                status, _, body = dash._route("/api/alerts")
                assert status == 200
                assert any(a["name"] == "serve_ttft_p95_burn" and a["state"] == "firing"
                           for a in json.loads(body)["alerts"])
            finally:
                dash._server.server_close()
            # rt top --once --json carries the same alert + history data
            rc = cli_main([
                "--address", addr, "--json", "top", "--once", "--since", "5",
            ])
            out = capsys.readouterr().out
            assert rc == 0
            frame = json.loads(out)
            assert frame["alerts"]["enabled"]
            assert frame["history"] is not None
            # spike over: short window drains first, rule resolves
            deadline = time.time() + 20.0
            resolved = False
            while time.time() < deadline:
                rep = state.alerts(addr)
                by = {a["name"]: a for a in rep["alerts"]}
                if by["serve_ttft_p95_burn"]["state"] == "ok":
                    resolved = True
                    break
                time.sleep(0.2)
            assert resolved, "burn rule never resolved after the spike"
            tl = state.timeline(addr)
            assert any(
                e.get("cat") == "alert"
                and e["name"] == "alert:serve_ttft_p95_burn:resolved"
                for e in tl
            )
            rc = cli_main(["--address", addr, "alerts"])
            out = capsys.readouterr().out
            assert rc == 0  # nothing firing any more
            assert "serve_ttft_p95_burn" in out
        finally:
            ray_tpu_torch.shutdown()
    finally:
        config.set("metrics_sample_interval_s", 1.0)
        config.set("alerts_ttft_target_s", 2.0)
        config.set("alerts_burn_short_s", 60.0)
        config.set("alerts_burn_long_s", 300.0)

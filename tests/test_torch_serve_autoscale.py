"""The port's serve control loop (``ray_tpu_torch/serve/autoscale``, pinned
copies of the JAX package's, whose SignalCollector reads the port's
metrics history and alerts): the contracts of
``tests/test_serve_autoscale.py``, re-run on the port's cluster. SLO
autoscaling policy, proxy admission control / load shedding, and
session-aware drain (parity model: python/ray/serve/tests/
test_autoscaling_policy + test_backpressure).

Policy and admission units run without a cluster; the e2e legs bring up
one module-scoped cluster and exercise the overload contract (unary
429/503 + Retry-After, never a hung chunked response), drain
correctness (zero dropped streams, zero hung clients), the
drain-deadline force-close, and one full scale-up -> drain ->
scale-down smoke cycle with autoscale_status/timeline visibility.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from ray_tpu_torch.serve.autoscale.admission import AdmissionController
from ray_tpu_torch.serve.autoscale.policy import Decision, Signals, SLOPolicy
from ray_tpu_torch.utils.config import config

AUTO = {"min_replicas": 1, "max_replicas": 4, "target_ongoing_requests": 2}


# ---------------------------------------------------------------------------
# SLOPolicy units (pure: explicit `now`, no cluster)
# ---------------------------------------------------------------------------


def test_policy_scales_up_on_ongoing_baseline():
    p = SLOPolicy()
    d = p.decide("d", 1, Signals(ongoing=8), AUTO, now=100.0)
    assert (d.target, d.direction) == (4, "up")  # ceil(8/2)=4, clamped


def test_policy_up_respects_max_and_cooldown():
    p = SLOPolicy()
    d = p.decide("d", 1, Signals(ongoing=100), AUTO, now=100.0)
    assert d.target == AUTO["max_replicas"]
    # second up-decision inside the cooldown holds
    d2 = p.decide("d", 2, Signals(ongoing=100), AUTO, now=100.5)
    assert (d2.direction, d2.target) == ("hold", 2)
    assert d2.reason == "up_cooldown"
    # ...and goes through once the cooldown expires
    later = 100.0 + float(config.serve_autoscale_up_cooldown_s) + 0.1
    d3 = p.decide("d", 2, Signals(ongoing=100), AUTO, now=later)
    assert (d3.direction, d3.target) == ("up", 4)


def test_policy_slo_pressure_scales_up_without_ongoing():
    """A firing burn alert (or high TTFT) asks for one more replica even
    when the ongoing count alone would not."""
    p = SLOPolicy()
    d = p.decide("d", 2, Signals(ongoing=1, burn_firing=True), AUTO,
                 now=10.0)
    assert (d.target, d.direction) == (3, "up")
    assert d.reason == "ttft_burn_firing"

    p2 = SLOPolicy()
    hot = float(config.alerts_ttft_target_s)  # way above the high frac
    d2 = p2.decide("d", 2, Signals(ongoing=1, ttft_p95_s=hot), AUTO,
                   now=10.0)
    assert (d2.target, d2.direction) == (3, "up")


def test_policy_down_needs_sustained_quiet():
    p = SLOPolicy()
    cooldown = float(config.serve_autoscale_down_cooldown_s)
    # quiet signals, but not yet held for the cooldown -> hold
    d = p.decide("d", 3, Signals(ongoing=0), AUTO, now=0.0)
    assert d.direction == "hold"
    d = p.decide("d", 3, Signals(ongoing=0), AUTO, now=cooldown / 2)
    assert d.direction == "hold"
    # held long enough -> ONE step down, not a jump to min
    d = p.decide("d", 3, Signals(ongoing=0), AUTO, now=cooldown + 0.1)
    assert (d.direction, d.target) == ("down", 2)
    # the cooldown re-arms after each step
    d = p.decide("d", 2, Signals(ongoing=0), AUTO, now=cooldown + 0.2)
    assert d.direction == "hold"
    d = p.decide("d", 2, Signals(ongoing=0), AUTO,
                 now=2 * cooldown + 0.3)
    assert (d.direction, d.target) == ("down", 1)
    # at min_replicas there is nothing to drain
    d = p.decide("d", 1, Signals(ongoing=0), AUTO,
                 now=4 * cooldown)
    assert d.direction == "hold"


def test_policy_down_hysteresis_blocks_on_mid_band_signals():
    """With live traffic, signals below the HIGH watermark but above the
    LOW one block scale-down (hysteresis band): no flapping."""
    p = SLOPolicy()
    cooldown = float(config.serve_autoscale_down_cooldown_s)
    target = float(config.alerts_ttft_target_s)
    mid = target * (
        (float(config.serve_autoscale_ttft_low_frac)
         + float(config.serve_autoscale_ttft_high_frac)) / 2
    )
    sig = Signals(ongoing=1, ttft_p95_s=mid)
    for i in range(4):
        d = p.decide("d", 3, sig, AUTO, now=i * cooldown)
        assert d.direction == "hold", d
    # a single noisy tick resets the quiet clock
    p2 = SLOPolicy()
    p2.decide("d", 3, Signals(ongoing=0), AUTO, now=0.0)
    p2.decide("d", 3, sig, AUTO, now=cooldown - 0.5)  # noise
    d = p2.decide("d", 3, Signals(ongoing=0), AUTO, now=cooldown + 0.1)
    assert d.direction == "hold"  # clock restarted at the noisy tick


def test_policy_idle_overrides_windowed_echoes():
    """Zero in-flight work sustained through the whole cooldown scales
    down even while the windowed series / the global burn alert still
    carry echoes of the already-handled burst (they lag by their window
    lengths) — and those echoes must not scale an idle deployment UP."""
    p = SLOPolicy()
    cooldown = float(config.serve_autoscale_down_cooldown_s)
    echo = Signals(
        ongoing=0,
        ttft_p95_s=float(config.alerts_ttft_target_s) * 2,
        queue_depth=5.0,
        burn_firing=True,
    )
    d = p.decide("d", 3, echo, AUTO, now=0.0)
    assert d.direction == "hold", d  # quiet clock starts; no echo-up
    d = p.decide("d", 3, echo, AUTO, now=cooldown + 0.1)
    assert (d.direction, d.target) == ("down", 2)


def test_policy_missing_signals_do_not_block_down():
    """None = no data (sampler off): the ongoing-count baseline still
    drives scale-down."""
    p = SLOPolicy()
    cooldown = float(config.serve_autoscale_down_cooldown_s)
    p.decide("d", 2, Signals(ongoing=0), AUTO, now=0.0)
    d = p.decide("d", 2, Signals(ongoing=0), AUTO, now=cooldown + 1)
    assert (d.direction, d.target) == ("down", 1)


def test_policy_forget_resets_state():
    p = SLOPolicy()
    p.decide("d", 1, Signals(ongoing=100), AUTO, now=0.0)  # starts cooldown
    p.forget("d")
    d = p.decide("d", 2, Signals(ongoing=100), AUTO, now=0.1)
    assert d.direction == "up"  # no lingering up-cooldown


def test_decision_and_signals_describe_roundtrip():
    d = Decision(target=3, direction="up", reason="x")
    assert d.describe() == {"target": 3, "direction": "up", "reason": "x"}
    s = Signals(ongoing=5, ttft_p95_s=0.5, burn_firing=True)
    desc = s.describe()
    assert desc["ongoing"] == 5 and desc["burn_firing"] is True
    assert desc["kv_occupancy"] is None


# ---------------------------------------------------------------------------
# AdmissionController units
# ---------------------------------------------------------------------------


def test_admission_sheds_503_over_deployment_bound():
    a = AdmissionController()
    assert a.try_acquire("d", max_inflight=2) is None
    assert a.try_acquire("d", max_inflight=2) is None
    shed = a.try_acquire("d", max_inflight=2)
    assert shed is not None and shed.status == 503
    assert shed.reason == "deployment_overload"
    assert shed.err_type == "overloaded_error"
    assert int(shed.headers()["Retry-After"]) >= 1
    # release frees a slot
    a.release("d")
    assert a.try_acquire("d", max_inflight=2) is None
    assert a.inflight("d") == 2


def test_admission_sheds_429_over_model_cap():
    a = AdmissionController()
    config.set("serve_admission_model_concurrency", 1)
    try:
        assert a.try_acquire("d", model_id="m", max_inflight=10) is None
        shed = a.try_acquire("d", model_id="m", max_inflight=10)
        assert shed is not None and shed.status == 429
        assert shed.reason == "model_concurrency"
        assert shed.err_type == "rate_limit_error"
        assert "Retry-After" in shed.headers()
        # a different model under the same deployment is unaffected
        assert a.try_acquire("d", model_id="m2", max_inflight=10) is None
        a.release("d", model_id="m")
        assert a.try_acquire("d", model_id="m", max_inflight=10) is None
    finally:
        config.set("serve_admission_model_concurrency", 0)


def test_admission_disabled_still_counts():
    """The kill switch admits everything but keeps counting, so
    acquire/release pairing stays consistent if it flips mid-flight."""
    a = AdmissionController()
    config.set("serve_admission_enabled", False)
    try:
        for _ in range(5):
            assert a.try_acquire("d", max_inflight=1) is None
        assert a.inflight("d") == 5
    finally:
        config.set("serve_admission_enabled", True)
    for _ in range(5):
        a.release("d")
    assert a.inflight("d") == 0


def test_admission_release_floors_at_zero():
    a = AdmissionController()
    a.release("d")  # spurious release must not go negative
    assert a.inflight("d") == 0
    assert a.try_acquire("d", max_inflight=1) is None
    shed = a.try_acquire("d", max_inflight=1)
    assert shed is not None


# ---------------------------------------------------------------------------
# http_server: 4-tuple unary results carry extra headers
# ---------------------------------------------------------------------------


def test_http_server_extra_headers_and_429():
    from ray_tpu_torch.serve.http_server import AioHttpServer

    def handler(method, path, query, headers, body):
        if path == "/shed":
            return (429, "application/json", b'{"error":"slow down"}',
                    {"Retry-After": "7"})
        return 200, "application/json", b'{"ok":true}'

    srv = AioHttpServer(handler, port=0, host="127.0.0.1")
    try:
        url = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(url + "/plain", timeout=10) as resp:
            assert resp.status == 200
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "/shed", timeout=10)
        assert ei.value.code == 429
        assert ei.value.headers["Retry-After"] == "7"
        assert json.loads(ei.value.read()) == {"error": "slow down"}
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# e2e: overload shedding, session-aware drain, smoke cycle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rt():
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.core import cluster_utils

    cluster_utils.sweep_stale_runtime()
    ray_tpu_torch.init(num_cpus=6)
    serve.start(http_port=0)
    yield ray_tpu_torch
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _proxy_addr(serve):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        addrs = serve.proxy_addresses()
        if addrs:
            return addrs[0]
        time.sleep(0.2)
    raise AssertionError("no HTTP proxy came up")


def _post(addr, path, body, timeout=60):
    """POST returning (status, headers, body_bytes); HTTP errors are
    returned, not raised — overload tests need the shed responses."""
    req = urllib.request.Request(
        f"http://{addr}{path}", data=json.dumps(body).encode(),
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_http_overload_sheds_cleanly(rt):
    """Concurrent posts over the deployment's max_queued_requests bound:
    some succeed, the rest shed 503 + Retry-After, nobody hangs."""
    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=1, max_concurrency=2,
                      route_prefix="/busy", max_queued_requests=2)
    def busy(req):
        time.sleep(1.0)
        return "ok"

    serve.run(busy.bind())
    addr = _proxy_addr(serve)
    results = []
    lock = threading.Lock()

    def hit():
        out = _post(addr, "/busy", {"x": 1}, timeout=60)
        with lock:
            results.append(out)

    threads = [threading.Thread(target=hit) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    assert not any(t.is_alive() for t in threads), "hung overload client"
    assert len(results) == 8
    by_status = {}
    for status, headers, body in results:
        by_status.setdefault(status, []).append((headers, body))
    assert by_status.get(200), f"nothing succeeded: {sorted(by_status)}"
    assert by_status.get(503), f"nothing shed: {sorted(by_status)}"
    for headers, body in by_status[503]:
        assert int(headers["Retry-After"]) >= 1
        rec = json.loads(body)
        assert rec["reason"] == "deployment_overload"
    # shed counter made it to the metrics plane
    deadline = time.monotonic() + 20
    shed_total = 0.0
    while time.monotonic() < deadline and shed_total <= 0:
        from ray_tpu_torch import state
        m = state.cluster_metrics().get("rt_serve_shed_total") or {}
        shed_total = sum(m.get("series", {}).values())
        time.sleep(0.5)
    assert shed_total >= len(by_status[503])
    serve.delete("busy")


def test_scale_down_drains_live_streams(rt):
    """Scale-down mid-stream: the draining replica leaves the routing
    table but every in-flight stream runs to completion — zero dropped
    streams, zero hung clients — and the fleet converges to the new
    target."""
    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=2, max_concurrency=4,
                      route_prefix="/tick")
    def ticker(request):
        for i in range(10):
            time.sleep(0.3)
            yield {"i": i}

    serve.run(ticker.bind())
    addr = _proxy_addr(serve)
    results = []
    lock = threading.Lock()

    def stream():
        req = urllib.request.Request(
            f"http://{addr}/tick?stream=1", data=b"{}", method="POST"
        )
        lines = []
        with urllib.request.urlopen(req, timeout=60) as resp:
            for line in resp:
                if line.strip():
                    lines.append(json.loads(line))
        with lock:
            results.append(lines)

    threads = [threading.Thread(target=stream) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(1.0)  # streams are mid-flight on both replicas
    assert serve.scale("ticker", 1)
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "hung stream client"
    assert len(results) == 4
    for lines in results:
        assert [x["i"] for x in lines] == list(range(10)), lines
    # the drained replica exits once quiescent
    deadline = time.monotonic() + 45
    while time.monotonic() < deadline:
        st = serve.status()["ticker"]
        if st["running"] == 1 and st["draining"] == 0:
            break
        time.sleep(0.5)
    st = serve.status()["ticker"]
    assert (st["running"], st["draining"]) == (1, 0), st
    serve.delete("ticker")


def test_drain_deadline_force_closes(rt):
    """A stream that outlives the drain deadline is force-closed: the
    client sees the stream end (not hang), and the fleet converges.
    6 streams against 2 replicas capped at max_concurrency=4 pigeonhole
    at least two streams onto EACH replica, so the drained one is
    guaranteed to hold live streams when the deadline fires."""
    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=2, max_concurrency=4,
                      route_prefix="/slowtick")
    def slowtick(request):
        # never completes within the test: the ONLY way a client's
        # stream ends is the force-close (or the final delete)
        for i in range(120):
            time.sleep(0.5)
            yield {"i": i}

    serve.run(slowtick.bind())
    addr = _proxy_addr(serve)
    dones = [threading.Event() for _ in range(6)]
    started = [threading.Event() for _ in range(6)]

    def stream(idx):
        req = urllib.request.Request(
            f"http://{addr}/slowtick?stream=1", data=b"{}", method="POST"
        )
        try:
            with urllib.request.urlopen(req, timeout=90) as resp:
                for _ in resp:
                    started[idx].set()
        except Exception:  # noqa: BLE001 — force-close may sever mid-read
            pass
        dones[idx].set()

    threads = [
        threading.Thread(target=stream, args=(i,)) for i in range(6)
    ]
    for t in threads:
        t.start()
    # every stream is on a replica (its first item arrived) before the
    # scale-down: a loaded box may take longer than the JAX test's 1 s sleep
    deadline = time.monotonic() + 30
    while not all(s.is_set() for s in started) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert all(s.is_set() for s in started), "a stream never started"
    assert serve.scale("slowtick", 1, drain_deadline_s=2.0)
    deadline = time.monotonic() + 45
    while time.monotonic() < deadline:
        st = serve.status()["slowtick"]
        if st["running"] == 1 and st["draining"] == 0:
            break
        time.sleep(0.5)
    st = serve.status()["slowtick"]
    assert (st["running"], st["draining"]) == (1, 0), st
    # the drained replica's >=2 clients were severed by the force-close:
    # they must see their stream END (not hang) right after convergence
    deadline = time.monotonic() + 15
    while (
        time.monotonic() < deadline
        and sum(d.is_set() for d in dones) < 2
    ):
        time.sleep(0.2)
    assert sum(d.is_set() for d in dones) >= 2, (
        "no client observed the drain-deadline force-close"
    )
    # the survivor's streams are still live (the handler never finishes
    # on its own); deleting the deployment severs them the same way
    serve.delete("slowtick")
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads), "hung client after " \
        "drain-deadline force-close"


def test_smoke_scale_cycle_with_status_and_timeline(rt):
    """One scale-up -> drain -> scale-down cycle, observed end to end:
    serve.autoscale_status() / state.autoscale_status() show the moving
    targets and decisions, and the timeline carries autoscale instants."""
    from ray_tpu_torch import serve, state

    @serve.deployment(num_replicas=1, route_prefix="/cycle")
    def cycle(req):
        return "ok"

    serve.run(cycle.bind())
    assert serve.scale("cycle", 3)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        st = serve.autoscale_status().get("cycle") or {}
        if st.get("running") == 3:
            break
        time.sleep(0.5)
    st = serve.autoscale_status()["cycle"]
    assert st["running"] == 3 and st["target"] == 3
    assert st["last_decision"]["direction"] == "up"
    assert st["last_decision"]["reason"] == "manual"

    assert serve.scale("cycle", 1)
    # while draining, status exposes per-drainer progress
    saw_draining = False
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        st = serve.autoscale_status().get("cycle") or {}
        drainers = st.get("draining") or {}
        if drainers:
            saw_draining = True
            rec = next(iter(drainers.values()))
            assert "ongoing" in rec and "deadline_in_s" in rec
        if st.get("running") == 1 and not drainers:
            break
        time.sleep(0.3)
    st = serve.autoscale_status()["cycle"]
    assert st["running"] == 1 and st["target"] == 1
    assert saw_draining, "never observed a draining replica"
    assert st["last_decision"]["direction"] == "down"

    # the KV-published snapshot state.autoscale_status() reads agrees
    deadline = time.monotonic() + 30
    kv = {}
    while time.monotonic() < deadline:
        kv = state.autoscale_status()
        if kv.get("cycle", {}).get("running") == 1:
            break
        time.sleep(0.5)
    assert kv.get("cycle", {}).get("target") == 1

    # scale decisions are timeline instants
    trace = state.timeline()
    names = {e.get("name") for e in trace}
    assert any(n and n.startswith("autoscale:cycle:") for n in names), (
        sorted(n for n in names if n)[:50]
    )
    serve.delete("cycle")

"""Request router — power-of-two-choices replica selection.

Parity: the reference Router + PowerOfTwoChoicesRequestRouter
(python/ray/serve/_private/router.py:473, request_router/pow_2_router.py):
sample two replicas, pick the one with the smaller known queue; queue
lengths come from the controller's routing table, refreshed by version
polling (long-poll-lite) plus a local in-flight delta so bursts spread
before the next refresh.

Affinity tiers on top of pow-2:
  - ``model_id``: replicas already holding a multiplexed model are
    preferred (warm-engine affinity, reference multiplex routing);
  - ``session_key``: rendezvous (highest-random-weight) hashing pins a
    session to ONE replica while the replica set is stable — the serve
    LLM path uses the OpenAI ``user`` field so a conversation keeps
    hitting the replica whose KV slots hold its prefix. Replica death
    re-pins only the sessions that lived on the dead replica (the HRW
    property), unlike mod-N hashing which reshuffles everyone.

``call_direct`` is the proxy's hot path: one RPC to the replica's
hosting worker (rpc_actor_direct_call) on PR 3's multi-segment frames +
cached dispatcher pool — no TaskSpec, no return-object round trip
through the owner's memory store. It falls back to the ordinary
actor-task path when the target worker predates the direct handler or
the feature is switched off (config.serve_direct_rpc).
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.core.actor import ActorHandle
from ray_tpu_torch.observability import core_metrics, tracing
from ray_tpu_torch.utils.config import config

ROUTE_REFRESH_S = 1.0


def _trace_id_of(payload: Any) -> Optional[str]:
    """Trace id the proxy injected into the request headers, if the
    payload is header-bearing (serve Request) and tracing stamped one."""
    headers = getattr(payload, "headers", None)
    if headers:
        return headers.get(tracing.TRACE_HEADER)
    return None


class Router:
    def __init__(self, controller: Any):
        self._controller = controller
        self._lock = threading.Lock()
        self._version = -1
        self._table: Dict[str, Dict[str, Any]] = {}
        self._last_refresh = 0.0
        # replica_id -> locally-issued in-flight count (delta on top of
        # the controller-reported ongoing count)
        self._local_inflight: Dict[str, int] = {}
        self._stopped = threading.Event()
        # TOPOLOGY long-poll: replica add/remove/death propagates in ~ms
        # (the controller holds the reply until its version changes)
        # instead of the 1 s ongoing-count refresh cadence — the round-3
        # "router thrashes between refreshes" weakness.
        threading.Thread(
            target=self._topology_longpoll, name="router-longpoll",
            daemon=True,
        ).start()

    def _topology_longpoll(self) -> None:
        while not self._stopped.is_set():
            with self._lock:
                version = self._version
            try:
                reply = ray_tpu_torch.get(
                    self._controller.get_routing_table.remote(version, 20.0),
                    timeout=40,
                )
            except Exception:  # noqa: BLE001 — controller briefly away
                self._stopped.wait(1.0)
                continue
            if reply.get("table") is not None:
                with self._lock:
                    if reply["version"] != self._version:
                        self._version = reply["version"]
                        self._table = reply["table"]
                        self._last_refresh = time.monotonic()

    def _refresh(self, force: bool = False) -> None:
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_refresh < ROUTE_REFRESH_S:
                return
            version = self._version
        reply = ray_tpu_torch.get(
            self._controller.get_routing_table.remote(version, 0.0),
            timeout=10,
        )
        with self._lock:
            self._last_refresh = time.monotonic()
            if reply["table"] is not None:
                self._version = reply["version"]
                self._table = reply["table"]
                # fresh controller-observed ongoing counts supersede the
                # local deltas (callers that never report completion decay
                # here) — wait_s=0 polls always return a table, so this
                # runs every ROUTE_REFRESH_S
                self._local_inflight.clear()

    def deployment_for_route(self, path: str) -> Optional[str]:
        self._refresh()
        with self._lock:
            best = None
            for name, dep in self._table.items():
                prefix = dep["route_prefix"]
                if path == prefix or path.startswith(prefix.rstrip("/") + "/"):
                    if best is None or len(prefix) > len(
                        self._table[best]["route_prefix"]
                    ):
                        best = name
            return best

    def max_queued_requests(self, deployment: str) -> Optional[int]:
        """Per-deployment admission bound from the routing table
        (@serve.deployment(max_queued_requests=...)); None means the
        global RT_SERVE_ADMISSION_MAX_INFLIGHT applies. Table-shipped so
        every proxy enforces the deploy-time bound without a config
        round-trip."""
        with self._lock:
            dep = self._table.get(deployment)
            if dep is None:
                return None
            return dep.get("max_queued_requests")

    @staticmethod
    def _rendezvous(session_key: str, replicas):
        """Highest-random-weight choice: stable per (session, replica
        set), minimal re-pinning when the set changes."""
        return max(
            replicas,
            key=lambda r: zlib.crc32(
                f"{session_key}\x00{r['replica_id']}".encode()
            ),
        )

    def choose_replica(self, deployment: str, timeout_s: float = 30.0,
                       model_id: Optional[str] = None,
                       session_key: Optional[str] = None,
                       prefix_hint: Optional[str] = None):
        """Pow-2 choice; blocks (re-polling) until a replica exists.
        With a multiplexed ``model_id``, replicas already holding that
        model are preferred (reference multiplex routing hint) — traffic
        for one model stays warm on one replica instead of thrashing
        every replica's LRU; when nobody holds it, normal pow-2 picks the
        replica that will load it. A ``session_key`` overrides both with
        rendezvous hashing over the FULL replica set (KV/session
        affinity): sessions spread across every replica — each loading
        the model on its first session — rather than piling onto
        whichever replica warmed the model first. ``prefix_hint`` (a
        digest of the request's leading prompt text, computed by the
        proxy) rendezvous-hashes the same way when no session pins the
        request: requests sharing a system prompt land on the replica
        whose engine already holds those prefix KV blocks."""
        affinity = session_key or prefix_hint
        t0 = time.monotonic()
        deadline = t0 + timeout_s
        while True:
            self._refresh()
            with self._lock:
                dep = self._table.get(deployment)
                replicas = list(dep["replicas"]) if dep else []
                if replicas and model_id and not affinity:
                    holding = [
                        r for r in replicas
                        if model_id in r.get("model_ids", [])
                    ]
                    if holding:
                        replicas = holding
                if replicas:
                    if affinity:
                        chosen = self._rendezvous(affinity, replicas)
                    elif len(replicas) == 1:
                        chosen = replicas[0]
                    else:
                        a, b = random.sample(replicas, 2)
                        chosen = min(
                            (a, b),
                            key=lambda r: r["ongoing"]
                            + self._local_inflight.get(r["replica_id"], 0),
                        )
                    rid = chosen["replica_id"]
                    self._local_inflight[rid] = (
                        self._local_inflight.get(rid, 0) + 1
                    )
                    if core_metrics.ENABLED:
                        core_metrics.serve_router_requests.inc(
                            tags={"deployment": deployment}
                        )
                        core_metrics.serve_router_queue_wait_s.observe(
                            time.monotonic() - t0
                        )
                    return rid, ActorHandle(*chosen["handle_info"])
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"no replicas available for deployment {deployment!r}"
                )
            self._refresh(force=True)
            time.sleep(0.1)

    def try_pick_nowait(self, path: str,
                        model_id: Optional[str] = None,
                        session_key: Optional[str] = None,
                        prefix_hint: Optional[str] = None):
        """Event-loop-safe replica pick: route-match + selection against
        the CURRENT table only — no refresh RPC, no polling, no sleeps.
        Returns (deployment, replica_id, handle) or None when the table
        is stale or has no match (the caller takes the blocking pool
        path, whose choose_replica refreshes for everyone). Staleness
        gating doubles as the ongoing-count refresh driver: at least one
        request per ROUTE_REFRESH_S goes through the refreshing path."""
        with self._lock:
            if time.monotonic() - self._last_refresh >= ROUTE_REFRESH_S:
                return None
            best = None
            for name, dep in self._table.items():
                prefix = dep["route_prefix"]
                if path == prefix or path.startswith(prefix.rstrip("/") + "/"):
                    if best is None or len(prefix) > len(
                        self._table[best]["route_prefix"]
                    ):
                        best = name
            if best is None:
                return None
            replicas = list(self._table[best]["replicas"])
            if not replicas:
                return None
            affinity = session_key or prefix_hint
            if model_id and not affinity:
                holding = [
                    r for r in replicas
                    if model_id in r.get("model_ids", [])
                ]
                if holding:
                    replicas = holding
            if affinity:
                chosen = self._rendezvous(affinity, replicas)
            elif len(replicas) == 1:
                chosen = replicas[0]
            else:
                a, b = random.sample(replicas, 2)
                chosen = min(
                    (a, b),
                    key=lambda r: r["ongoing"]
                    + self._local_inflight.get(r["replica_id"], 0),
                )
            rid = chosen["replica_id"]
            self._local_inflight[rid] = self._local_inflight.get(rid, 0) + 1
            if core_metrics.ENABLED:
                core_metrics.serve_router_requests.inc(
                    tags={"deployment": best}
                )
            return best, rid, ActorHandle(*chosen["handle_info"])

    def request_finished(self, replica_id: str) -> None:
        with self._lock:
            n = self._local_inflight.get(replica_id, 0) - 1
            if n <= 0:
                self._local_inflight.pop(replica_id, None)
            else:
                self._local_inflight[replica_id] = n

    def assign(self, deployment: str, payload: Any,
               method: Optional[str] = None, timeout_s: float = 30.0,
               model_id: Optional[str] = None,
               session_key: Optional[str] = None,
               prefix_hint: Optional[str] = None):
        """Route one request; returns (replica_id, result ObjectRef)."""
        rid, handle = self.choose_replica(
            deployment, timeout_s, model_id, session_key, prefix_hint
        )
        if method:
            return rid, handle.handle_request.remote(payload, method=method)
        return rid, handle.handle_request.remote(payload)

    def call_streaming(self, deployment: str, payload: Any,
                       method: Optional[str] = None,
                       timeout_s: float = 60.0,
                       model_id: Optional[str] = None,
                       session_key: Optional[str] = None,
                       prefix_hint: Optional[str] = None):
        """Route one request to the replica's streaming entry point and
        yield items as they are produced (core actor streaming
        generators). The in-flight delta is held until the stream is
        exhausted or abandoned; an ABANDONED stream (the HTTP client
        disconnected and the proxy closed this generator) cancels the
        replica-side task so the deployment's generator unwinds and the
        LLM engine frees the request's KV slot."""
        tid = _trace_id_of(payload) if tracing.ENABLED else None
        t0u = tracing.now_us() if tid else 0
        rid, handle = self.choose_replica(
            deployment, timeout_s, model_id, session_key, prefix_hint
        )
        if tid and tracing.ENABLED:
            tracing.emit(tracing.request_span(
                tid, tracing.ROUTER, deployment, t0u,
                tracing.now_us() - t0u, replica=rid,
            ))
        gen = None
        exhausted = False
        try:
            gen = handle.handle_request_streaming.remote(
                payload, method=method
            )
            for item_ref in gen:
                yield ray_tpu_torch.get(item_ref, timeout=timeout_s)
            exhausted = True
        finally:
            self.request_finished(rid)
            if gen is not None and not exhausted:
                self._cancel_streaming(handle, gen)

    @staticmethod
    def _cancel_streaming(handle: ActorHandle, gen) -> None:
        """Interrupt an abandoned streaming task on its replica (oneway;
        best effort — a dead replica freed everything anyway)."""
        from ray_tpu_torch.core import worker as worker_mod

        try:
            w = worker_mod.global_worker()
            addr = w._resolve_actor_address(handle._actor_id, timeout_s=5.0)
            w.workers.get(addr).call_oneway(
                "cancel_task", task_id_hex=gen._task_id.hex(), force=False
            )
        except Exception:  # noqa: BLE001 — cancellation is advisory
            pass

    def call(self, deployment: str, payload: Any,
             method: Optional[str] = None, timeout_s: float = 60.0,
             model_id: Optional[str] = None,
             session_key: Optional[str] = None,
             prefix_hint: Optional[str] = None) -> Any:
        """Route + get with retry on replica death: the routing table lags
        replica failures by up to a health-check period, so a request that
        lands on a corpse is transparently re-routed (reference: the
        router's queue-probe failures trigger re-selection)."""
        from ray_tpu_torch.core.exceptions import (
            ActorDiedError,
            ActorUnavailableError,
        )

        deadline = time.monotonic() + timeout_s
        last_exc: Optional[BaseException] = None
        tid = _trace_id_of(payload) if tracing.ENABLED else None
        for _ in range(4):
            remaining = max(0.5, deadline - time.monotonic())
            t0u = tracing.now_us() if tid else 0
            rid, ref = self.assign(
                deployment, payload, method, remaining, model_id,
                session_key, prefix_hint,
            )
            if tid and tracing.ENABLED:
                tracing.emit(tracing.request_span(
                    tid, tracing.ROUTER, deployment, t0u,
                    tracing.now_us() - t0u, replica=rid,
                ))
            try:
                return ray_tpu_torch.get(ref, timeout=remaining)
            except (ActorDiedError, ActorUnavailableError) as e:
                last_exc = e
                self._refresh(force=True)
            finally:
                self.request_finished(rid)
            if time.monotonic() >= deadline:
                break
        raise last_exc

    # -- proxy hot path --------------------------------------------------

    def call_direct(self, deployment: str, payload: Any,
                    method: Optional[str] = None, timeout_s: float = 60.0,
                    model_id: Optional[str] = None,
                    session_key: Optional[str] = None,
                    prefix_hint: Optional[str] = None) -> Any:
        """One-hop request: proxy → the replica's hosting worker over a
        single RPC (rpc_actor_direct_call) instead of the actor-task
        machinery (TaskSpec + submit/reply threads + owner memory store).
        The reply rides the multi-segment wire format, so a Frame-wrapped
        response body ≥32 KiB travels as a raw out-of-band segment.

        Falls back to the ordinary path per-request when the feature is
        off or the target worker predates the handler; connection-level
        failures re-route like call()."""
        from ray_tpu_torch.core import worker as worker_mod
        from ray_tpu_torch.utils.rpc import (
            RpcConnectionError,
            RpcError,
            RpcTimeout,
        )

        if not config.serve_direct_rpc:
            return self.call(
                deployment, payload, method, timeout_s, model_id,
                session_key, prefix_hint,
            )
        w = worker_mod.global_worker()
        deadline = time.monotonic() + timeout_s
        last_exc: Optional[BaseException] = None
        tid = _trace_id_of(payload) if tracing.ENABLED else None
        for _ in range(4):
            remaining = max(0.5, deadline - time.monotonic())
            t0u = tracing.now_us() if tid else 0
            rid, handle = self.choose_replica(
                deployment, remaining, model_id, session_key, prefix_hint
            )
            if tid and tracing.ENABLED:
                tracing.emit(tracing.request_span(
                    tid, tracing.ROUTER, deployment, t0u,
                    tracing.now_us() - t0u, replica=rid,
                ))
            addr = None
            try:
                addr = w._resolve_actor_address(
                    handle._actor_id, timeout_s=remaining
                )
                reply = w.workers.get(addr).call(
                    "actor_direct_call",
                    target="handle_request_direct",
                    args=(payload,),
                    kwargs={"method": method} if method else None,
                    timeout_s=remaining,
                )
            except RpcTimeout:
                # the request may STILL be executing on the replica: do
                # not re-submit (duplicate execution) and do not tear
                # down the shared worker connection — surface it, like
                # the actor-task path's get-timeout
                raise
            except RpcConnectionError as e:
                # replica/worker died (same re-route semantics as
                # call()'s ActorDied/ActorUnavailable retry)
                last_exc = e
                w._actor_addr_cache.pop(handle._actor_id, None)
                if addr is not None:
                    w.workers.drop(addr)
                self._refresh(force=True)
                continue
            except RpcError:
                raise
            finally:
                self.request_finished(rid)
            if reply[0] == "no_actor":
                # mid-restart or pre-direct worker: serve THIS request on
                # the ordinary path (its retry ladder handles the rest)
                return self.call(
                    deployment, payload, method,
                    max(0.5, deadline - time.monotonic()), model_id,
                    session_key, prefix_hint,
                )
            return self._unwrap_direct(reply[1])
        raise last_exc

    @staticmethod
    def _unwrap_direct(wrapped: Any) -> Any:
        """Invert replica.handle_request_direct's wrapping; Frame bodies
        come back as zero-copy memoryviews."""
        from ray_tpu_torch.utils import serialization

        kind, value = wrapped
        if kind == "raw":
            return serialization.as_view(value)
        if kind == "http":
            status, ctype, body = value
            return status, ctype, serialization.as_view(body)
        return value

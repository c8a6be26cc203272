"""Serve replica actor.

Parity: the reference Replica/UserCallableWrapper
(python/ray/serve/_private/replica.py:1688,2679): hosts one instance of
the user's deployment callable, tracks ongoing-request count (the signal
the pow-2 router and the autoscaler consume), and exposes a health probe.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

import ray_tpu_torch


class Request:
    """Minimal HTTP-ish request object handed to deployments called via
    the proxy (parity: starlette Request in the reference)."""

    def __init__(self, method: str, path: str, body: bytes,
                 headers: Optional[Dict[str, str]] = None,
                 query: Optional[Dict[str, str]] = None):
        self.method = method
        self.path = path
        self.body = body
        self.headers = headers or {}
        self.query = query or {}

    def json(self) -> Any:
        import json

        return json.loads(self.body or b"null")

    def text(self) -> str:
        return (self.body or b"").decode("utf-8", errors="replace")


@ray_tpu_torch.remote
class ServeReplica:
    """One replica of a deployment. max_concurrency on the actor lets
    multiple requests execute concurrently in threads; _ongoing tracks
    in-flight requests for routing/autoscaling."""

    def __init__(self, deployment_name: str, callable_blob: bytes,
                 init_args: Tuple, init_kwargs: Dict[str, Any]):
        from ray_tpu_torch.utils import serialization

        self.deployment_name = deployment_name
        cls_or_fn = serialization.loads(callable_blob)
        if isinstance(cls_or_fn, type):
            self._callable = cls_or_fn(*init_args, **init_kwargs)
        else:
            self._callable = cls_or_fn
        self._ongoing = 0
        self._total = 0
        self._lock = threading.Lock()
        self._started = time.time()

    def _trace_id_of(self, payload: Any) -> Optional[str]:
        from ray_tpu_torch.observability import tracing

        headers = getattr(payload, "headers", None)
        if headers:
            return headers.get(tracing.TRACE_HEADER)
        return None

    def _stamp(self, trace_id: Optional[str], t0_us: int) -> None:
        from ray_tpu_torch.observability import tracing

        if trace_id and tracing.ENABLED:
            tracing.emit(tracing.request_span(
                trace_id, tracing.REPLICA, self.deployment_name,
                t0_us, tracing.now_us() - t0_us,
            ))

    def handle_request(self, payload: Any, *, method: Optional[str] = None):
        from ray_tpu_torch.observability import tracing

        trace_id = self._trace_id_of(payload) if tracing.ENABLED else None
        t0_us = tracing.now_us() if trace_id else 0
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            target = self._callable
            if method:
                target = getattr(self._callable, method)
            return target(payload)
        finally:
            with self._lock:
                self._ongoing -= 1
            self._stamp(trace_id, t0_us)

    def handle_request_direct(self, payload: Any, *,
                              method: Optional[str] = None):
        """Proxy hot-path entry (worker rpc_actor_direct_call): same
        semantics as handle_request, but the result is wrapped so bulk
        response bodies ride the RPC reply as out-of-band multi-segment
        frames instead of being re-pickled in-band:

          ("raw",  body)                  bytes-like response
          ("http", (status, ctype, body)) explicit HTTP triple
          ("obj",  value)                 anything else (JSON-encoded by
                                          the proxy)

        where ``body`` is serialization.maybe_frame output — a Frame
        once it crosses the 32 KiB out-of-band floor."""
        from ray_tpu_torch.utils import serialization

        result = self.handle_request(payload, method=method)
        if isinstance(result, (bytes, bytearray)):
            return ("raw", serialization.maybe_frame(result))
        if (
            isinstance(result, tuple) and len(result) == 3
            and isinstance(result[0], int)
            and isinstance(result[2], (bytes, bytearray))
        ):
            status, ctype, body = result
            return ("http", (status, ctype, serialization.maybe_frame(body)))
        return ("obj", result)

    @ray_tpu_torch.method(num_returns="streaming")
    def handle_request_streaming(self, payload: Any, *,
                                 method: Optional[str] = None):
        """Streaming variant: the deployment returns an iterable and each
        item reaches the caller as it is produced (core streaming
        generators; parity: reference streaming deployment responses
        through the proxy's chunked transfer)."""
        from ray_tpu_torch.observability import tracing

        trace_id = self._trace_id_of(payload) if tracing.ENABLED else None
        t0_us = tracing.now_us() if trace_id else 0
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            target = self._callable
            if method:
                target = getattr(self._callable, method)
            result = target(payload)
            if result is None:
                return
            if isinstance(result, (bytes, str, dict, tuple)):
                # non-iterable response (a tuple is an HTTP triple, not a
                # stream): one chunk
                yield result
                return
            yield from result
        finally:
            with self._lock:
                self._ongoing -= 1
            self._stamp(trace_id, t0_us)

    def health(self) -> bool:
        return True

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "ongoing": self._ongoing,
                "total": self._total,
                "uptime_s": time.time() - self._started,
            }

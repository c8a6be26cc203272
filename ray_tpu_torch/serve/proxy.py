"""Per-node HTTP proxy actor.

Parity: the reference ProxyActor/HTTPProxy (python/ray/serve/_private/
proxy.py:1176,827): one proxy per node accepts HTTP, matches the route
prefix, routes to a replica (pow-2 router) and returns the response.

Data plane: asyncio (ray_tpu_torch/serve/http_server.py) — the reference's
proxy is ASGI/asyncio (proxy.py:732), and the round-4 review flagged the
previous thread-per-request stdlib server as the gap. Connections are
event-driven with keep-alive; the blocking replica call runs on a
bounded pool; streamed responses ride chunked transfer encoding.

Hot path: replica calls go over ONE direct RPC to the replica's hosting
worker (router.call_direct → rpc_actor_direct_call) on the multi-segment
wire format + cached dispatcher pool — no TaskSpec, no owner-side object
store (PROFILE.md "Serve no-op front-door budget"). config.serve_direct_rpc
switches the old actor-task path back on.

OpenAI front door: paths shaped like `/v1/completions`,
`/v1/chat/completions` and `/v1/models` get a cheap body probe
(serve/openai/protocol.py) for the routing hints that live in the JSON
body — the ``stream`` flag (SSE, not ?stream=1), the ``model`` id
(multiplexed warm-engine affinity) and the ``user`` session key
(rendezvous KV affinity). Errors on those routes are OpenAI-shaped.

Model multiplexing: a request carrying a ``serve_multiplexed_model_id``
header (or ``model_id`` query param) is routed preferentially to a
replica that already holds that model (reference multiplex routing).
"""

from __future__ import annotations

import asyncio
import json
from typing import Optional

import ray_tpu_torch
from ray_tpu_torch.serve.http_server import AioHttpServer, FallbackToPool
from ray_tpu_torch.serve.openai import protocol as oai
from ray_tpu_torch.serve.replica import Request
from ray_tpu_torch.utils.rpc import RpcError, RpcTimeout

# NOTE: this class is cloudpickled BY VALUE (the @ray_tpu_torch.remote wrapper
# shadows the module attribute, so by-reference lookup fails): methods
# must not reference module globals that hold _thread.locks — the config
# registry is imported at call time for exactly that reason.

_MODEL_ID_HEADER = "serve_multiplexed_model_id"
# bodies past this stay off the fast path: the request frame is sent on
# the event loop thread, which must never sit in a long sendmsg
_FAST_MAX_BODY = 64 * 1024


@ray_tpu_torch.remote
class ServeProxy:
    def __init__(self, port: int = 0, controller_name: str = "SERVE_CONTROLLER"):
        from ray_tpu_torch.serve.autoscale.admission import AdmissionController
        from ray_tpu_torch.serve.router import Router

        controller = ray_tpu_torch.get_actor(controller_name)
        self._router = Router(controller)
        self._admission = AdmissionController()
        self._server = AioHttpServer(
            self._handle, port=port, fast_handler=self._try_fast
        )

    # -- admission control (serve/autoscale/admission.py) ----------------

    def _admit(self, deployment: str, model_id: Optional[str]):
        """One admission attempt: None = admitted (caller owns exactly
        one release), or a Shed to return. The per-deployment bound comes
        from the routing table (deploy-time max_queued_requests) with
        RT_SERVE_ADMISSION_MAX_INFLIGHT as the default."""
        cap = self._router.max_queued_requests(deployment)
        return self._admission.try_acquire(
            deployment, model_id=model_id, max_inflight=cap
        )

    @staticmethod
    def _shed_response(shed, openai: bool):
        """429/503 + Retry-After: the overload contract. OpenAI routes
        get an OpenAI-shaped error body; everything else plain JSON."""
        if openai:
            body = oai.error_body(
                shed.message, err_type=shed.err_type, code=shed.reason
            )
        else:
            body = json.dumps({
                "error": shed.message,
                "reason": shed.reason,
                "retry_after_s": shed.retry_after_s,
            }).encode()
        return shed.status, "application/json", body, shed.headers()

    # -- fast path (runs ON the event loop; must never block) ------------

    def _try_fast(self, method, path, query, headers, body: bytes):
        """Zero-executor-hop dispatch for unary requests whose replica is
        instantly routable: pick from the router's cached table, fire the
        direct RPC asynchronously, and await the reply as a loop future.
        Anything not instantly serviceable (streaming, stale table, cold
        actor-address cache, oversized body, feature off) returns None —
        the ordinary pool handler takes it."""
        from ray_tpu_torch.utils.config import config

        if not config.serve_direct_rpc or len(body) > _FAST_MAX_BODY:
            return None
        if query.get("stream") in ("1", "true"):
            return None
        if path.startswith("/-/"):
            return None  # admin endpoints touch router internals
        probe = oai.probe(method, path, body, headers)
        if probe is not None and probe.stream:
            return None
        if probe is not None:
            model_id, session_key = probe.model, probe.session_key
            prefix_hint = (
                probe.prefix_hint if config.serve_prefix_cache else None
            )
        else:
            model_id = (
                headers.get(_MODEL_ID_HEADER) or query.get("model_id") or None
            )
            session_key = None
            prefix_hint = None
        from ray_tpu_torch.observability import tracing

        trace = None
        if tracing.ENABLED:
            trace_id = (headers.get(tracing.TRACE_HEADER)
                        or tracing.new_trace_id())
            headers[tracing.TRACE_HEADER] = trace_id
            trace = (trace_id, None, tracing.now_us())
        picked = self._router.try_pick_nowait(
            path, model_id, session_key, prefix_hint
        )
        if picked is None:
            return None
        deployment, rid, handle = picked
        shed = self._admit(deployment, model_id)
        if shed is not None:
            # shed BEFORE the replica RPC: overload never reaches an
            # engine, and the reply is a plain tuple (no pool hop)
            self._router.request_finished(rid)
            if trace is not None:
                self._trace_end(
                    (trace[0], deployment, trace[2]), shed.status
                )
            return self._shed_response(shed, openai=probe is not None)
        if trace is not None:
            # fill in the deployment the pick resolved; stamp the pick
            # itself as the (sub-ms) router leg of this trace
            trace = (trace[0], deployment, trace[2])
            if tracing.ENABLED:
                tracing.emit(tracing.request_span(
                    trace[0], tracing.ROUTER, deployment, trace[2],
                    tracing.now_us() - trace[2], replica=rid,
                ))
        from ray_tpu_torch.core import worker as worker_mod

        w = worker_mod.global_worker()
        addr = w._actor_addr_cache.get(handle._actor_id)
        client = w.workers.get(addr) if addr is not None else None
        if client is None or client._sock is None:
            # cold address/connection: resolving would block the loop
            self._router.request_finished(rid)
            self._admission.release(deployment, model_id)
            return None
        request = Request(method, path, body, headers, query)
        try:
            pending = client.call_async(
                "actor_direct_call", target="handle_request_direct",
                args=(request,),
            )
        except RpcError:
            self._router.request_finished(rid)
            self._admission.release(deployment, model_id)
            return None  # connection just dropped: pool path re-routes
        return self._await_direct(pending, rid, openai=probe is not None,
                                  trace=trace,
                                  admitted=(deployment, model_id))

    def _trace_begin(self, headers, deployment):
        """Mint (or adopt) the trace id, inject it into the request
        headers, and return (trace_id, deployment, t0_us) — or None when
        tracing is off, so downstream stamp sites short-circuit."""
        from ray_tpu_torch.observability import tracing

        if not tracing.ENABLED:
            return None
        trace_id = (headers.get(tracing.TRACE_HEADER)
                    or tracing.new_trace_id())
        headers[tracing.TRACE_HEADER] = trace_id
        return (trace_id, deployment, tracing.now_us())

    def _trace_end(self, trace, status: int = 200) -> None:
        """Stamp the proxy (end-to-end) span for a request begun with
        _trace_begin."""
        if trace is None:
            return
        from ray_tpu_torch.observability import tracing

        if tracing.ENABLED:
            trace_id, deployment, t0 = trace
            tracing.emit(tracing.request_span(
                trace_id, tracing.PROXY, deployment or "?",
                t0, tracing.now_us() - t0, status=status,
            ))

    async def _await_direct(self, pending, rid: str, openai: bool,
                            trace=None, admitted=None):
        from ray_tpu_torch.serve.router import Router
        from ray_tpu_torch.utils.rpc import RemoteError

        loop = asyncio.get_running_loop()
        fut = loop.create_future()

        def _deliver(p):
            loop.call_soon_threadsafe(
                lambda: fut.set_result(p) if not fut.done() else None
            )

        pending.add_done_callback(_deliver)
        status = None  # None at exit = fell back to pool: no proxy span
        try:
            try:
                p = await asyncio.wait_for(fut, timeout=120)
            except asyncio.TimeoutError:
                status = 503
                return 503, "application/json", (
                    oai.error_body("request timed out",
                                   err_type="overloaded_error")
                    if openai else b'{"error":"request timed out"}'
                )
            if not p.ok:
                if isinstance(p.payload, RemoteError):
                    # the request EXECUTED and raised: a real 500, never
                    # re-dispatched (double execution)
                    msg = f"RemoteError: {p.payload}"
                    status = 500
                    return 500, "application/json", (
                        oai.error_body(msg, err_type="internal_error")
                        if openai else json.dumps({"error": msg}).encode()
                    )
                # connection lost: re-route on the pool path (same
                # retry-on-replica-death semantics as router.call)
                raise FallbackToPool
            reply = p.payload
            if reply[0] == "no_actor":
                raise FallbackToPool  # mid-restart: pool path re-routes
            result = Router._unwrap_direct(reply[1])
            if openai:
                out = oai.split_http_result(result)
                status = out[0]
                return out
            status = 200
            if isinstance(result, (bytes, bytearray, memoryview)):
                return 200, "application/json", result
            if (
                isinstance(result, tuple) and len(result) == 3
                and isinstance(result[0], int)
            ):
                status = result[0]
                return result
            return 200, "application/json", json.dumps(result).encode()
        finally:
            self._router.request_finished(rid)
            if admitted is not None:
                self._admission.release(*admitted)
            if status is not None:
                self._trace_end(trace, status)

    # -- request path (runs on the server's executor pool) --------------

    def _handle(self, method: str, path: str, query, headers, body: bytes):
        probe = oai.probe(method, path, body, headers)
        if probe is not None:
            return self._handle_openai(method, path, query, headers, body,
                                       probe)
        if query.get("stream") in ("1", "true"):
            return self._handle_streaming(method, path, query, headers, body)
        try:
            return self._dispatch(method, path, query, headers, body)
        except (TimeoutError, RpcTimeout) as e:
            return 503, "application/json", json.dumps(
                {"error": str(e)}
            ).encode()
        except Exception as e:  # noqa: BLE001 — app errors -> 500
            return 500, "application/json", json.dumps(
                {"error": f"{type(e).__name__}: {e}"}
            ).encode()

    def _handle_streaming(self, method, path, query, headers, body):
        """?stream=1: a generator — the asyncio server turns each yielded
        item into one chunk (reference proxy's streaming response path)."""
        deployment = self._router.deployment_for_route(path)
        if deployment is None:
            return 404, "application/json", json.dumps(
                {"error": f"no route for {path}"}
            ).encode()
        model_id: Optional[str] = (
            headers.get(_MODEL_ID_HEADER) or query.get("model_id") or None
        )
        shed = self._admit(deployment, model_id)
        if shed is not None:
            # shed is a unary reply even on a would-be stream: the
            # client gets headers + body + Retry-After, never a hung
            # half-open chunked response
            return self._shed_response(shed, openai=False)
        trace = self._trace_begin(headers, deployment)
        request = Request(method, path, body, headers, query)

        def gen():
            try:
                for item in self._router.call_streaming(
                    deployment, request, timeout_s=300
                ):
                    line = (
                        item if isinstance(item, bytes)
                        else json.dumps(item).encode()
                    )
                    yield line + b"\n"
            except Exception as e:  # noqa: BLE001 — trailer chunk
                yield json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}
                ).encode() + b"\n"
            finally:
                self._admission.release(deployment, model_id)
                self._trace_end(trace, 200)

        return gen()

    # -- OpenAI front door ----------------------------------------------

    def _handle_openai(self, method, path, query, headers, body,
                       probe: "oai.Probe"):
        """`/v1/*`-shaped requests: body-probed routing hints, SSE when
        the body says ``stream: true``, OpenAI-shaped errors."""
        deployment = self._router.deployment_for_route(path)
        if deployment is None:
            return 404, "application/json", oai.error_body(
                f"no route for {path}", err_type="invalid_request_error",
                code="route_not_found",
            )
        from ray_tpu_torch.utils.config import config

        shed = self._admit(deployment, probe.model)
        if shed is not None:
            # one unary 429/503 + Retry-After whether the request wanted
            # SSE or not: overload must never open a stream
            return self._shed_response(shed, openai=True)
        trace = self._trace_begin(headers, deployment)
        request = Request(method, path, body, headers, query)
        if probe.stream:
            # the stream generator owns the admission slot from here
            return self._openai_stream(deployment, request, probe, trace)
        try:
            result = self._router.call_direct(
                deployment, request, timeout_s=300,
                model_id=probe.model, session_key=probe.session_key,
                prefix_hint=(
                    probe.prefix_hint if config.serve_prefix_cache else None
                ),
            )
        except (TimeoutError, RpcTimeout) as e:
            self._trace_end(trace, 503)
            return 503, "application/json", oai.error_body(
                str(e), err_type="overloaded_error"
            )
        except Exception as e:  # noqa: BLE001
            self._trace_end(trace, 500)
            return 500, "application/json", oai.error_body(
                f"{type(e).__name__}: {e}", err_type="internal_error"
            )
        finally:
            self._admission.release(deployment, probe.model)
        out = oai.split_http_result(result)
        self._trace_end(trace, out[0])
        return out

    def _openai_stream(self, deployment: str, request: Request,
                       probe: "oai.Probe", trace=None):
        """SSE response: each yielded ``data: {...}\\n\\n`` event is one
        chunk; closing the connection closes this generator, which
        cancels the replica-side stream and frees the engine's KV slot.
        The proxy span closes when the generator does, so its duration
        covers the whole stream (the e2e number request_summary rolls
        up)."""

        from ray_tpu_torch.utils.config import config

        hint = probe.prefix_hint if config.serve_prefix_cache else None

        def gen():
            try:
                for item in self._router.call_streaming(
                    deployment, request, timeout_s=600,
                    model_id=probe.model, session_key=probe.session_key,
                    prefix_hint=hint,
                ):
                    yield item if isinstance(item, bytes) else oai.sse_event(
                        item
                    )
            except Exception as e:  # noqa: BLE001 — mid-stream trailer
                yield oai.sse_error(f"{type(e).__name__}: {e}")
            finally:
                # admission slot acquired by _handle_openai: a stream
                # occupies replica capacity until it closes, so it holds
                # its slot just as long
                self._admission.release(deployment, probe.model)
                self._trace_end(trace, 200)

        return 200, oai.SSE_CONTENT_TYPE, gen()

    # -- generic dispatch ------------------------------------------------

    def _dispatch(self, method: str, path: str, query, headers, body: bytes):
        if path == "/-/routes":
            self._router._refresh(force=True)
            return 200, "application/json", json.dumps(
                {
                    name: dep["route_prefix"]
                    for name, dep in self._router._table.items()
                }
            ).encode()
        if path == "/-/healthz":
            return 200, "application/json", b'"ok"'
        deployment = self._router.deployment_for_route(path)
        if deployment is None:
            return 404, "application/json", json.dumps(
                {"error": f"no route for {path}"}
            ).encode()
        model_id: Optional[str] = (
            headers.get(_MODEL_ID_HEADER) or query.get("model_id") or None
        )
        shed = self._admit(deployment, model_id)
        if shed is not None:
            return self._shed_response(shed, openai=False)
        trace = self._trace_begin(headers, deployment)
        request = Request(method, path, body, headers, query)
        try:
            result = self._router.call_direct(
                deployment, request, timeout_s=120, model_id=model_id
            )
        finally:
            self._admission.release(deployment, model_id)
        if isinstance(result, (bytes, bytearray, memoryview)):
            self._trace_end(trace, 200)
            return 200, "application/json", result
        if (
            isinstance(result, tuple) and len(result) == 3
            and isinstance(result[0], int)
        ):
            self._trace_end(trace, result[0])
            return result
        self._trace_end(trace, 200)
        return 200, "application/json", json.dumps(result).encode()

    def address(self) -> str:
        from ray_tpu_torch.core import worker as worker_mod

        # the node's routable address, not loopback: multi-node clients
        # must be able to reach every node's proxy
        host = worker_mod.global_worker().node_agent_address.split(":")[0]
        return f"{host}:{self._server.port}"

    def health(self) -> bool:
        return True

    def refresh_routes(self) -> int:
        """Take the controller's routing table now (serve.run asks once a
        deployment is ready, so traffic sent after run() returns is routed
        over all of its replicas, not the ones this proxy had heard of).
        Returns the table's version."""
        self._router._refresh(force=True)
        return self._router._version

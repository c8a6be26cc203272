"""Minimal asyncio HTTP/1.1 server for the serve data plane.

Parity rationale: the reference proxy is ASGI/asyncio (uvicorn +
starlette, python/ray/serve/_private/proxy.py:732) — connection handling
is event-driven, so thousands of keep-alive connections cost one loop,
not one thread each. This is the same design without external deps: a
hand-rolled HTTP/1.1 parser over ``asyncio.start_server``, keep-alive by
default, chunked transfer for streaming handlers, and a bounded thread
pool for the (blocking) replica calls.

Handlers are plain callables (run in the pool, NOT on the loop):

    handler(method, path, query, headers, body)
      -> (status:int, content_type:str, payload:bytes)        # unary
      -> (status:int, content_type:str, payload:bytes,
          extra_headers:dict)           # unary with extra response
                                        # headers (admission control
                                        # sheds attach Retry-After)
      -> generator yielding bytes                             # streaming
      -> (status:int, content_type:str, generator)            # streaming
                                       with explicit status/content-type
                                       (SSE: "text/event-stream")

A client disconnect mid-stream CLOSES the handler's generator (on the
pool), so producers can release held resources — the serve LLM path
relies on this to cancel the replica-side stream and free its engine
KV slot.

Fast path: an optional ``fast_handler`` runs ON THE EVENT LOOP before
the pool dispatch. It must never block; it returns None (take the pool
path), a ready result, or an awaitable resolving to a result. Raising
``FallbackToPool`` from the awaitable re-dispatches the request to the
ordinary pool handler. The serve proxy uses this to issue the
replica RPC asynchronously — the request then costs zero executor
hops and no parked pool thread (PROFILE.md serve budget).
"""

from __future__ import annotations

import asyncio
import inspect
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qsl, unquote, urlparse

_MAX_HEADER = 64 * 1024
_MAX_BODY = 256 * 1024 * 1024


class FallbackToPool(Exception):
    """Raised by a fast-path awaitable: re-dispatch on the pool handler
    (only safe when the request provably did NOT execute yet)."""


class AioHttpServer:
    def __init__(self, handler: Callable, port: int = 0,
                 host: str = "0.0.0.0", pool_size: int = 32,
                 fast_handler: Optional[Callable] = None):
        self._handler = handler
        self._fast = fast_handler
        self._host = host
        self._port = port
        self._pool = ThreadPoolExecutor(
            max_workers=pool_size, thread_name_prefix="serve-call"
        )
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._started = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="serve-aio", daemon=True
        )
        self._thread.start()
        if not self._started.wait(timeout=30):
            raise RuntimeError("asyncio HTTP server failed to start")

    @property
    def port(self) -> int:
        return self._port

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def boot():
            server = await asyncio.start_server(
                self._serve_conn, self._host, self._port,
            )
            self._port = server.sockets[0].getsockname()[1]
            self._started.set()
            async with server:
                await server.serve_forever()

        try:
            loop.run_until_complete(boot())
        except asyncio.CancelledError:
            pass
        finally:
            loop.close()

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(
                lambda: [t.cancel() for t in asyncio.all_tasks(self._loop)]
            )
        self._pool.shutdown(wait=False)

    # -- connection handling -------------------------------------------

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except (asyncio.IncompleteReadError, ConnectionError):
                    return
                except asyncio.LimitOverrunError:
                    await self._simple(writer, 431, b'{"error":"headers too large"}')
                    return
                if len(head) > _MAX_HEADER:
                    await self._simple(writer, 431, b'{"error":"headers too large"}')
                    return
                try:
                    method, target, headers = self._parse_head(head)
                except ValueError:
                    await self._simple(writer, 400, b'{"error":"bad request"}')
                    return
                try:
                    length = int(headers.get("content-length") or 0)
                    if length < 0:
                        raise ValueError
                except ValueError:
                    await self._simple(writer, 400, b'{"error":"bad content-length"}')
                    return
                if length > _MAX_BODY:
                    await self._simple(writer, 413, b'{"error":"body too large"}')
                    return
                body = await reader.readexactly(length) if length else b""
                parsed = urlparse(target)
                path = unquote(parsed.path)
                query = dict(parse_qsl(parsed.query))
                keep = headers.get("connection", "keep-alive").lower() != "close"
                loop = asyncio.get_running_loop()
                result = None
                if self._fast is not None:
                    try:
                        fast = self._fast(method, path, query, headers, body)
                    except Exception:  # noqa: BLE001 — probe bug: pool path
                        fast = None
                    if fast is not None:
                        try:
                            result = (
                                await fast if inspect.isawaitable(fast)
                                else fast
                            )
                        except FallbackToPool:
                            result = None
                        except Exception as e:  # noqa: BLE001
                            await self._simple(
                                writer, 500,
                                f'{{"error":"{type(e).__name__}"}}'.encode(),
                                keep,
                            )
                            if not keep:
                                return
                            continue
                if result is None:
                    try:
                        result = await loop.run_in_executor(
                            self._pool, self._handler, method, path, query,
                            headers, body,
                        )
                    except Exception as e:  # noqa: BLE001 — crash -> 500
                        await self._simple(
                            writer, 500,
                            f'{{"error":"{type(e).__name__}"}}'.encode(),
                            keep,
                        )
                        if not keep:
                            return
                        continue
                if hasattr(result, "__next__"):  # streaming generator
                    ok = await self._stream(writer, result, loop)
                    # chunked responses end the exchange cleanly; keep
                    # the connection for the next request
                    if not ok:
                        return  # client went away mid-stream
                elif (
                    isinstance(result, tuple) and len(result) == 3
                    and hasattr(result[2], "__next__")
                ):  # streaming with explicit status/content-type (SSE)
                    status, ctype, gen = result
                    ok = await self._stream(
                        writer, gen, loop, status=status, ctype=ctype
                    )
                    if not ok:
                        return
                else:
                    extra = None
                    if len(result) == 4:
                        status, ctype, payload, extra = result
                    else:
                        status, ctype, payload = result
                    await self._respond(
                        writer, status, ctype, payload, keep, extra
                    )
                if not keep:
                    return
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    @staticmethod
    def _parse_head(head: bytes) -> Tuple[str, str, Dict[str, str]]:
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3:
            raise ValueError("bad request line")
        method, target, _version = parts
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        return method.upper(), target, headers

    async def _respond(self, writer, status: int, ctype: str,
                       payload: bytes, keep: bool,
                       extra: Optional[Dict[str, str]] = None) -> None:
        extra_lines = b""
        if extra:
            extra_lines = b"".join(
                b"%s: %s\r\n" % (k.encode("latin-1"), v.encode("latin-1"))
                for k, v in extra.items()
            )
        writer.write(
            b"HTTP/1.1 %d %s\r\n"
            b"Content-Type: %s\r\n"
            b"Content-Length: %d\r\n"
            b"%s"
            b"Connection: %s\r\n\r\n"
            % (
                status, _REASONS.get(status, b"OK"), ctype.encode(),
                len(payload), extra_lines,
                b"keep-alive" if keep else b"close",
            )
        )
        writer.write(payload)
        await writer.drain()

    async def _simple(self, writer, status: int, payload: bytes,
                      keep: bool = False) -> None:
        await self._respond(
            writer, status, "application/json", payload, keep
        )

    async def _stream(self, writer, gen, loop, status: int = 200,
                      ctype: str = "application/x-ndjson") -> bool:
        """Chunked transfer encoding: one chunk per yielded bytes item.
        The (blocking) generator advances on the pool, the writes on the
        loop. Returns False when the client disconnected mid-stream —
        the generator is CLOSED either way (its finally blocks release
        producer resources, e.g. the LLM engine's KV slot)."""
        writer.write(
            b"HTTP/1.1 %d %s\r\n"
            b"Content-Type: %s\r\n"
            b"Transfer-Encoding: chunked\r\n"
            b"Connection: keep-alive\r\n\r\n"
            % (status, _REASONS.get(status, b"OK"), ctype.encode())
        )
        alive = True
        try:
            while True:
                item = await loop.run_in_executor(self._pool, _next_or_done, gen)
                if item is _DONE:
                    break
                writer.write(b"%x\r\n%s\r\n" % (len(item), item))
                await writer.drain()
        except (ConnectionError, OSError):
            alive = False  # client went away: stop producing NOW
        finally:
            # close on the pool: generator finally blocks may issue
            # (blocking) cancel RPCs and must not run on the event loop
            await loop.run_in_executor(self._pool, _close_gen, gen)
            if alive:
                try:
                    writer.write(b"0\r\n\r\n")
                    await writer.drain()
                except (ConnectionError, OSError):
                    alive = False
        return alive


_DONE = object()


def _next_or_done(gen):
    try:
        return next(gen)
    except StopIteration:
        return _DONE


def _close_gen(gen):
    try:
        gen.close()
    except Exception:  # noqa: BLE001 — producer cleanup is best-effort
        pass


_REASONS = {
    200: b"OK", 400: b"Bad Request", 404: b"Not Found",
    413: b"Payload Too Large", 429: b"Too Many Requests",
    431: b"Request Header Fields Too Large",
    500: b"Internal Server Error", 503: b"Service Unavailable",
}

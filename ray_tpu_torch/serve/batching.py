"""@serve.batch — transparent request batching inside a deployment.

Parity: the reference's ``ray.serve.batch`` (python/ray/serve/batching.py:1
_BatchQueue + @serve.batch decorator): concurrent calls to the decorated
method are gathered into one list-in/list-out invocation, amortizing
per-call overhead (tokenization, device dispatch) across the batch.

Thread-based (not asyncio): replicas execute requests on actor
max_concurrency threads, so the accumulator collects across those threads
— the first caller of an empty batch becomes the *flusher* and waits out
``batch_wait_timeout_s`` (or until ``max_batch_size`` arrives), everyone
else parks on their item's event. Matches the reference's semantics:

- the wrapped function receives a LIST of requests and must return a
  list of equal length (ValueError otherwise, delivered to every caller);
- per-item exceptions: if the batch fn raises, every batched caller gets
  the error;
- ``max_batch_size`` / ``batch_wait_timeout_s`` are tunable at decoration
  time and via ``set_max_batch_size`` / ``set_batch_wait_timeout_s``
  handles (reference batching.py set_* parity).

State is created LAZILY and PER INSTANCE (method case): deployments ship
to replicas via pickle, so threading primitives must not live in the
decorator closure — and two instances of one class must never share a
queue (a batch would execute with the wrong ``self``). The config dict is
read live by the queue, so driver-side ``set_*`` calls before deployment
never materialize unpicklable state.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, List, Optional

from ray_tpu_torch.observability import core_metrics

_LAZY_LOCK = threading.Lock()


class _Item:
    __slots__ = ("value", "event", "result", "error", "enq_ts")

    def __init__(self, value):
        self.value = value
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.enq_ts = time.monotonic()


class _BatchQueue:
    def __init__(self, fn: Callable[..., List[Any]], cfg: dict):
        self.fn = fn
        self.cfg = cfg  # read live: set_* updates apply to running queues
        self._lock = threading.Lock()
        self._items: List[_Item] = []
        self._flusher_active = False
        self._arrived = threading.Condition(self._lock)
        # observability (reference exposes batch utilization metrics)
        self.num_batches = 0
        self.batch_sizes: List[int] = []

    @property
    def max_batch_size(self) -> int:
        return int(self.cfg["max_batch_size"])

    @property
    def batch_wait_timeout_s(self) -> float:
        return float(self.cfg["batch_wait_timeout_s"])

    def call(self, instance, value) -> Any:
        item = _Item(value)
        with self._lock:
            self._items.append(item)
            self._arrived.notify_all()
            if not self._flusher_active:
                self._flusher_active = True
                flusher = True
            else:
                flusher = False
        if flusher:
            self._flush_when_ready(instance)
        if not item.event.wait(timeout=300.0):
            raise TimeoutError("batched call timed out")
        if item.error is not None:
            raise item.error
        return item.result

    def _flush_when_ready(self, instance) -> None:
        deadline = time.monotonic() + self.batch_wait_timeout_s
        with self._lock:
            while (
                len(self._items) < self.max_batch_size
                and time.monotonic() < deadline
            ):
                self._arrived.wait(
                    max(0.0, min(deadline - time.monotonic(), 0.05))
                )
            batch, self._items = (
                self._items[: self.max_batch_size],
                self._items[self.max_batch_size:],
            )
            self._flusher_active = False
            if self._items:
                # leftovers: promote a new flusher thread (same instance —
                # one queue serves exactly one instance)
                self._flusher_active = True
                threading.Thread(
                    target=self._flush_when_ready, args=(instance,),
                    daemon=True,
                ).start()
        if not batch:
            return
        self.num_batches += 1
        self.batch_sizes.append(len(batch))
        if len(self.batch_sizes) > 100:
            del self.batch_sizes[:-100]
        if core_metrics.ENABLED:
            core_metrics.serve_batch_size.observe(len(batch))
            now = time.monotonic()
            for it in batch:
                core_metrics.serve_batch_wait_s.observe(now - it.enq_ts)
        try:
            args = [it.value for it in batch]
            results = (
                self.fn(instance, args) if instance is not None
                else self.fn(args)
            )
            if not isinstance(results, (list, tuple)) or len(results) != len(batch):
                raise ValueError(
                    f"@serve.batch function {self.fn.__name__} must return "
                    f"a list of length {len(batch)}, got {type(results)}"
                )
            for it, r in zip(batch, results):
                it.result = r
                it.event.set()
        except BaseException as e:  # noqa: BLE001 — fan the error out
            for it in batch:
                it.error = e
                it.event.set()


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: gather concurrent calls into one list-in/list-out call.

    Usage (reference @serve.batch parity)::

        @serve.deployment(max_concurrency=16)
        class Model:
            @serve.batch(max_batch_size=32, batch_wait_timeout_s=0.02)
            def __call__(self, requests):   # receives a LIST
                return [self.net(r) for r in requests]
    """

    def wrap(fn):
        cfg = {
            "max_batch_size": max_batch_size,
            "batch_wait_timeout_s": batch_wait_timeout_s,
        }
        attr = f"_rt_batch_queue__{fn.__name__}"
        state: dict = {}  # free-function case only

        def queue_for(instance) -> _BatchQueue:
            # import-at-call: referencing module globals directly would
            # drag a _thread.lock into this (pickled-by-value) closure
            from ray_tpu_torch.serve import batching as _mod

            holder = instance.__dict__ if instance is not None else state
            q = holder.get(attr)
            if q is None:
                with _mod._LAZY_LOCK:
                    q = holder.get(attr)
                    if q is None:
                        q = holder[attr] = _mod._BatchQueue(fn, cfg)
            return q

        @functools.wraps(fn)
        def inner(self_or_first, *rest):
            # method: inner(self, request); free function: inner(request)
            if rest:
                return queue_for(self_or_first).call(self_or_first, rest[0])
            return queue_for(None).call(None, self_or_first)

        def set_max_batch_size(n):
            cfg["max_batch_size"] = int(n)

        def set_batch_wait_timeout_s(s):
            cfg["batch_wait_timeout_s"] = float(s)

        inner._rt_batch_cfg = cfg
        inner._rt_batch_queue_for = queue_for
        inner.set_max_batch_size = set_max_batch_size
        inner.set_batch_wait_timeout_s = set_batch_wait_timeout_s
        return inner

    if _fn is not None:
        return wrap(_fn)
    return wrap

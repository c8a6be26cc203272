"""@serve.multiplexed — N model variants per replica with LRU eviction.

Parity: the reference's model multiplexing (python/ray/serve/multiplex.py:1
_ModelMultiplexWrapper + @serve.multiplexed): one replica hosts up to
``max_num_models_per_replica`` models, loaded on demand by ``model_id``
and evicted least-recently-used; the router prefers replicas that already
hold the requested model (routing hint via the controller's replica
stats), so repeated traffic for one model stays warm on one replica.

The decorated loader must be a method taking ``model_id`` and returning
the loaded model. Consumers call ``get_model(model_id)`` — here the
decorated function IS the getter (call it with the id), matching the
reference's ``self.get_model(model_id)`` shape.

The per-replica loaded set is reported to the controller through the
replica's stats (replica.py attaches ``multiplexed_model_ids``), and the
router's pow-2 choice is filtered to model-holding replicas first
(router.py), falling back to any replica (which then loads + maybe
evicts).
"""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import Callable, Optional

# replica-process-global registry: replica.py reads it to report loaded
# model ids; keyed by wrapper id so several multiplexed loaders coexist
_REGISTRY = {}
_REGISTRY_LOCK = threading.Lock()


def loaded_model_ids():
    """All model ids currently loaded in this process (for replica
    stats)."""
    with _REGISTRY_LOCK:
        wrappers = list(_REGISTRY.values())
    out = []
    for w in wrappers:
        out.extend(w.model_ids())
    return out


class _Multiplexer:
    def __init__(self, loader: Callable, max_models: int):
        self.loader = loader
        self.max_models = max_models
        self._lock = threading.Lock()
        self._models: "OrderedDict[str, object]" = OrderedDict()
        self._loading: dict = {}  # model_id -> Event (single-flight)

    def model_ids(self):
        with self._lock:
            return list(self._models)

    def peek(self, model_id: str):
        """Loaded model or None — never loads, never touches the LRU."""
        with self._lock:
            return self._models.get(model_id)

    def get(self, instance, model_id: str):
        while True:
            with self._lock:
                if model_id in self._models:
                    self._models.move_to_end(model_id)
                    return self._models[model_id]
                ev = self._loading.get(model_id)
                if ev is None:
                    ev = threading.Event()
                    self._loading[model_id] = ev
                    break
            # another thread is loading this model: wait for it
            ev.wait(timeout=300.0)
        try:
            model = (
                self.loader(instance, model_id) if instance is not None
                else self.loader(model_id)
            )
            from ray_tpu_torch.observability import core_metrics

            if core_metrics.ENABLED:
                core_metrics.serve_multiplex_loads.inc(
                    tags={"model": model_id}
                )
            with self._lock:
                self._models[model_id] = model
                self._models.move_to_end(model_id)
                evicted = []
                evicted_ids = []
                while len(self._models) > self.max_models:
                    old_id, old = self._models.popitem(last=False)  # LRU out
                    evicted.append(old)
                    evicted_ids.append(old_id)
            if core_metrics.ENABLED:
                for old_id in evicted_ids:
                    core_metrics.serve_multiplex_evictions.inc(
                        tags={"model": old_id}
                    )
            for old in evicted:
                # reference calls __del__/model cleanup hooks if present
                unload = getattr(old, "unload", None)
                if callable(unload):
                    try:
                        unload()
                    except Exception:  # noqa: BLE001 — eviction best-effort
                        pass
            return model
        finally:
            with self._lock:
                self._loading.pop(model_id, None)
            ev.set()


class ModelMultiplexer:
    """Imperative multiplexer for callers that configure ``max_models``
    at runtime (the decorator form fixes it at class-definition time).
    ``loader(model_id)`` loads a model; get() caches it LRU-bounded and
    the loaded set feeds the replica's multiplexed-model stats like the
    decorator does. Build with :func:`make_multiplexer` INSIDE the
    replica (init, not module scope): the registry entry must land in
    the replica process for the router's warm-model affinity to see it."""

    def __init__(self, mux: _Multiplexer):
        self._mux = mux

    def get(self, model_id: str):
        return self._mux.get(None, model_id)

    def peek(self, model_id: str):
        return self._mux.peek(model_id)

    def model_ids(self):
        return self._mux.model_ids()


def make_multiplexer(loader: Callable, max_models: int = 3) -> ModelMultiplexer:
    mux = _Multiplexer(loader, max_models)
    with _REGISTRY_LOCK:
        _REGISTRY[id(mux)] = mux
    return ModelMultiplexer(mux)


def multiplexed(_fn: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorator for a model-loading method; calling the decorated method
    returns the (cached) model for ``model_id``::

        @serve.deployment
        class Multi:
            @serve.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id: str):
                return load_weights(model_id)   # expensive, runs once

            def __call__(self, req):
                model = self.get_model(req.query["model_id"])
                return model(req.body)
    """

    def wrap(fn):
        # The multiplexer (with its locks) is created LAZILY and PER
        # INSTANCE: deployments ship to replicas via pickle (threading
        # primitives must stay out of the closure), and two instances of
        # one class must not share an LRU — a model loaded with r1's self
        # must never be served for r2. Lazy creation also lands the
        # _REGISTRY entry in the REPLICA process, where the loaded-model
        # stats belong.
        attr = f"_rt_multiplexer__{fn.__name__}"
        state: dict = {}  # free-function case only

        def mux_for(instance) -> _Multiplexer:
            # import-at-call: referencing the module lock directly would
            # drag a _thread.lock into this (pickled-by-value) closure
            from ray_tpu_torch.serve import multiplex as _mod

            holder = instance.__dict__ if instance is not None else state
            m = holder.get(attr)
            if m is None:
                with _mod._REGISTRY_LOCK:
                    m = holder.get(attr)
                    if m is None:
                        m = holder[attr] = _mod._Multiplexer(
                            fn, max_num_models_per_replica
                        )
                        _mod._REGISTRY[id(m)] = m
            return m

        @functools.wraps(fn)
        def inner(self_or_id, *rest):
            if rest:
                return mux_for(self_or_id).get(self_or_id, rest[0])
            return mux_for(None).get(None, self_or_id)

        inner._rt_multiplexer_for = mux_for
        return inner

    if _fn is not None:
        return wrap(_fn)
    return wrap

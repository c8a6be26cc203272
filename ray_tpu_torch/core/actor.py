"""Actor API: ActorClass / ActorHandle / ActorMethod.

Parity: python/ray/actor.py — ActorClass._remote :793, ActorHandle :1878.
Handles are plain pickleable records (actor_id + method metadata); the
receiving process routes calls through its own CoreWorker, resolving the
actor's current address from the control store (reference: caller resolves
actor location via GCS subscribe, SURVEY.md §3.3).
"""

from __future__ import annotations

import hashlib
import inspect
from typing import Any, Dict, List, Optional

from ray_tpu_torch.utils import serialization

_ACTOR_OPTION_KEYS = {
    "name", "namespace", "lifetime", "max_restarts", "max_concurrency",
    "num_cpus", "num_tpus", "num_gpus", "resources", "scheduling_strategy",
    "max_task_retries", "runtime_env", "concurrency_groups",
}


def method(num_returns=1, tensor_transport: str = "object",
           concurrency_group: Optional[str] = None):
    """Decorator configuring an actor method (parity: ray.method —
    including the RDT ``tensor_transport`` option, reference
    gpu_object_manager.py; ``num_returns="streaming"`` for generator
    methods that yield through an ObjectRefGenerator; and
    ``concurrency_group`` routing the method onto a named per-group
    thread pool, reference concurrency_group_manager.h:38)."""

    from ray_tpu_torch.core.device_objects import validate_transport

    validate_transport(tensor_transport)

    def wrap(fn):
        fn.__rt_num_returns__ = num_returns
        fn.__rt_tensor_transport__ = tensor_transport
        if concurrency_group is not None:
            fn.__rt_concurrency_group__ = concurrency_group
        return fn

    return wrap


class ActorClass:
    def __init__(self, cls, options: Dict[str, Any]):
        self._cls = cls
        self._options = dict(options)
        self._blob: Optional[bytes] = None
        self._class_id: Optional[str] = None
        self.__name__ = cls.__name__

    @property
    def cls(self):
        return self._cls

    def options(self, **kwargs) -> "ActorClass":
        unknown = set(kwargs) - _ACTOR_OPTION_KEYS
        if unknown:
            raise TypeError(f"unknown actor options: {sorted(unknown)}")
        merged = {**self._options, **kwargs}
        clone = ActorClass(self._cls, merged)
        clone._blob, clone._class_id = self._blob, self._class_id
        return clone

    def _class_blob(self):
        if self._blob is None:
            blob = serialization.dumps_function(self._cls)
            self._blob = blob
            self._class_id = "cls_" + hashlib.sha1(blob).hexdigest()[:24]
        return self._class_id, self._blob

    def _method_meta(self) -> Dict[str, Any]:
        meta: Dict[str, Any] = {}
        for name, fn in inspect.getmembers(self._cls, callable):
            if name.startswith("__") and name != "__call__":
                continue
            nr = getattr(fn, "__rt_num_returns__", 1)
            tt = getattr(fn, "__rt_tensor_transport__", "object")
            meta[name] = nr if tt == "object" else (nr, tt)
        return meta

    def remote(self, *args, **kwargs) -> "ActorHandle":
        from ray_tpu_torch.core import worker as worker_mod

        w = worker_mod.global_worker()
        class_id, blob = self._class_blob()
        opts = dict(self._options)
        resources = dict(opts.get("resources") or {})
        num_cpus = opts.get("num_cpus")
        if num_cpus is None:
            num_cpus = 1.0 if not resources and not opts.get("num_tpus") else 0.0
        if num_cpus:
            resources["CPU"] = float(num_cpus)
        if opts.get("num_gpus") is not None:
            raise NotImplementedError(
                "num_gpus is not ported: ROADMAP.md, Queue A item 9 (GPU-aware "
                "scheduling); ask for cards with resources={'GPU': n}")
        num_tpus = opts.get("num_tpus")
        if num_tpus:
            resources["TPU"] = float(num_tpus)
        opts["resources"] = resources
        method_meta = self._method_meta()
        opts["method_names"] = sorted(method_meta)
        groups = opts.get("concurrency_groups")
        method_groups = {
            name: getattr(fn, "__rt_concurrency_group__")
            for name, fn in inspect.getmembers(self._cls, callable)
            if getattr(fn, "__rt_concurrency_group__", None) is not None
        }
        if method_groups and not groups:
            raise ValueError(
                "methods declare concurrency_group "
                f"{sorted(set(method_groups.values()))} but the actor has "
                "no concurrency_groups option"
            )
        unknown = set(method_groups.values()) - set(groups or {})
        if unknown:
            raise ValueError(
                f"methods reference undeclared concurrency groups "
                f"{sorted(unknown)}"
            )
        opts["method_groups"] = method_groups
        actor_id = w.create_actor(
            class_id, blob, self.__name__, args, kwargs, opts
        )
        return ActorHandle(actor_id, self.__name__, method_meta, owner=True)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self.__name__} cannot be instantiated directly; "
            f"use {self.__name__}.remote()."
        )


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns: int = 1,
                 tensor_transport: str = "object"):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._tensor_transport = tensor_transport

    def options(self, num_returns: Optional[int] = None,
                tensor_transport: Optional[str] = None) -> "ActorMethod":
        if tensor_transport is not None:
            from ray_tpu_torch.core.device_objects import validate_transport

            validate_transport(tensor_transport)
        return ActorMethod(
            self._handle, self._name,
            num_returns if num_returns is not None else self._num_returns,
            tensor_transport if tensor_transport is not None
            else self._tensor_transport,
        )

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.core import worker as worker_mod

        w = worker_mod.global_worker()
        nr = -1 if self._num_returns == "streaming" else self._num_returns
        refs = w.submit_actor_task(
            self._handle._actor_id, self._name, args, kwargs,
            num_returns=nr,
            tensor_transport=self._tensor_transport,
        )
        if nr in (1, -1):  # single ref, or the ObjectRefGenerator
            return refs[0]
        return refs

    def bind(self, *args):
        """Create a static-DAG node for this method (compiled graphs,
        ray_tpu_torch/dag.py; parity: python/ray/dag/dag_node.py bind)."""
        from ray_tpu_torch.dag import ClassMethodNode

        return ClassMethodNode(self._handle, self._name, args)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._name} cannot be called directly; "
            f"use .remote()."
        )


class ActorHandle:
    def __init__(self, actor_id: str, class_name: str, method_meta: Dict[str, int],
                 owner: bool = False):
        self._actor_id = actor_id
        self._class_name = class_name
        self._method_meta = method_meta
        # The handle returned by ActorClass.remote() is the "original handle";
        # when it goes out of scope the (non-detached) actor is killed —
        # parity with the reference's actor GC, where the GCS kills an actor
        # once its creator's handle count drops to zero.
        self._owner = owner

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        if self._method_meta and name not in self._method_meta:
            raise AttributeError(
                f"actor {self._class_name} has no method {name!r}"
            )
        meta = self._method_meta.get(name, 1)
        if isinstance(meta, tuple):
            num_returns, transport = meta
        else:
            num_returns, transport = meta, "object"
        return ActorMethod(self, name, num_returns, transport)

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id[:8]})"

    def __reduce__(self):
        # pickled copies are borrowers, never owners
        return (ActorHandle, (self._actor_id, self._class_name, self._method_meta))

    def __del__(self):
        if not getattr(self, "_owner", False):
            return
        try:
            from ray_tpu_torch.core import worker as worker_mod

            w = worker_mod.global_worker_or_none()
            if w is not None and not w._shutdown.is_set():
                # via the worker so the drop orders after a still-batched
                # registration of this very actor (core/worker.py
                # drop_actor_handle)
                w.drop_actor_handle(self._actor_id)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def make_handle_from_info(info: Dict[str, Any]) -> ActorHandle:
    """Build a handle from a control-store actor record (get_actor path)."""
    method_names: List[str] = info.get("method_names") or []
    return ActorHandle(
        info["actor_id"], info.get("class_name", "Actor"),
        {m: 1 for m in method_names},
    )

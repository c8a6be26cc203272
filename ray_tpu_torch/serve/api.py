"""Serve public API.

Parity: ray.serve (reference python/ray/serve/api.py): @serve.deployment,
Deployment.bind, serve.run, DeploymentHandle, serve.status/shutdown.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Union

import ray_tpu_torch
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.utils import serialization

_lock = threading.Lock()
_controller = None
_local_router = None


class Deployment:
    def __init__(
        self,
        func_or_class: Union[Callable, type],
        name: str,
        num_replicas: int = 1,
        route_prefix: Optional[str] = None,
        max_concurrency: int = 8,
        autoscaling_config: Optional[Dict[str, Any]] = None,
        ray_actor_options: Optional[Dict[str, float]] = None,
        max_queued_requests: Optional[int] = None,
    ):
        self.func_or_class = func_or_class
        self.name = name
        self.num_replicas = num_replicas
        self.route_prefix = route_prefix
        self.max_concurrency = max_concurrency
        self.autoscaling_config = autoscaling_config
        self.ray_actor_options = ray_actor_options
        # per-deployment proxy admission bound (in-flight requests per
        # proxy; None = RT_SERVE_ADMISSION_MAX_INFLIGHT)
        self.max_queued_requests = max_queued_requests
        self.init_args: tuple = ()
        self.init_kwargs: dict = {}

    def bind(self, *args, **kwargs) -> "Deployment":
        clone = Deployment(
            self.func_or_class, self.name, self.num_replicas,
            self.route_prefix, self.max_concurrency, self.autoscaling_config,
            self.ray_actor_options, self.max_queued_requests,
        )
        clone.init_args = args
        clone.init_kwargs = kwargs
        return clone

    def options(self, **kwargs) -> "Deployment":
        clone = self.bind(*self.init_args, **self.init_kwargs)
        for k, v in kwargs.items():
            if not hasattr(clone, k):
                raise TypeError(f"unknown deployment option {k!r}")
            setattr(clone, k, v)
        return clone


def deployment(
    _func_or_class=None,
    *,
    name: Optional[str] = None,
    num_replicas: int = 1,
    route_prefix: Optional[str] = None,
    max_concurrency: int = 8,
    autoscaling_config: Optional[Dict[str, Any]] = None,
    ray_actor_options: Optional[Dict[str, float]] = None,
    max_queued_requests: Optional[int] = None,
):
    """@serve.deployment decorator (reference api.py deployment)."""

    def wrap(obj):
        return Deployment(
            obj,
            name or getattr(obj, "__name__", "deployment"),
            num_replicas=num_replicas,
            route_prefix=route_prefix,
            max_concurrency=max_concurrency,
            autoscaling_config=autoscaling_config,
            ray_actor_options=ray_actor_options,
            max_queued_requests=max_queued_requests,
        )

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap


def start(http_port: Optional[int] = 0, detached: bool = False):
    """Start (or connect to) the Serve controller."""
    global _controller
    with _lock:
        if _controller is not None:
            return _controller
        try:
            _controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        except ValueError:
            _controller = ServeController.options(
                name=CONTROLLER_NAME,
                lifetime="detached" if detached else None,
                num_cpus=0,
                max_concurrency=16,
            ).remote(http_port)
        return _controller


def run(dep: Deployment, *, wait_ready: bool = True,
        ready_timeout_s: float = 120.0) -> "DeploymentHandle":
    """Deploy (or redeploy) and return a handle."""
    controller = start()
    blob = serialization.dumps_function(dep.func_or_class)
    ray_tpu_torch.get(
        controller.deploy.remote(
            dep.name, blob, dep.init_args, dep.init_kwargs,
            dep.num_replicas, dep.route_prefix, dep.max_concurrency,
            dep.autoscaling_config, dep.ray_actor_options,
            dep.max_queued_requests,
        )
    )
    if wait_ready and not _wait_ready(controller, dep.name, ready_timeout_s):
        raise TimeoutError(f"deployment {dep.name!r} did not become ready")
    return DeploymentHandle(dep.name)


def _wait_ready(controller, name: str, timeout_s: float) -> bool:
    """Client side of the sliced controller.ready(): the controller
    answers each call within config.dispatch_wait_slice_s (dispatcher-
    block discipline), so the client re-issues slices until its own
    deadline."""
    import time

    deadline = time.monotonic() + timeout_s
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            return False
        if ray_tpu_torch.get(
            controller.ready.remote(name, left), timeout=left + 30
        ):
            return True


class DeploymentResponse:
    """Future-like result of handle.remote() (reference handle.py
    DeploymentResponse): submitted eagerly; .result() blocks, and retries
    on a replica that died after routing."""

    def __init__(self, router, deployment: str, payload: Any,
                 method: Optional[str], replica_id: str, ref):
        self._router = router
        self._deployment = deployment
        self._payload = payload
        self._method = method
        self._replica_id = replica_id
        self._ref = ref
        self._done = False
        self._value: Any = None
        self._error: Optional[BaseException] = None

    @property
    def ref(self):
        return self._ref

    def result(self, timeout_s: float = 60.0) -> Any:
        from ray_tpu_torch.core.exceptions import (
            ActorDiedError,
            ActorUnavailableError,
        )

        from ray_tpu_torch.core.exceptions import GetTimeoutError

        if not self._done:
            try:
                self._value = ray_tpu_torch.get(self._ref, timeout=timeout_s)
            except GetTimeoutError:
                # the request is still running: NOT a terminal outcome —
                # the response stays live (in-flight count included) and
                # the caller may retry result() with a longer timeout
                raise
            except (ActorDiedError, ActorUnavailableError):
                # replica died under us: re-route the request
                try:
                    self._value = self._router.call(
                        self._deployment, self._payload, self._method,
                        timeout_s,
                    )
                except BaseException as e:  # noqa: BLE001
                    self._error = e
            except BaseException as e:  # noqa: BLE001
                self._error = e
            self._done = True
            self._router.request_finished(self._replica_id)
        if self._error is not None:
            raise self._error
        return self._value


class DeploymentHandle:
    """Python-level calls into a deployment (reference handle.py:757)."""

    def __init__(self, deployment_name: str):
        self.deployment_name = deployment_name
        self._model_id: Optional[str] = None

    def options(self, *, multiplexed_model_id: Optional[str] = None
                ) -> "DeploymentHandle":
        """Reference handle.options(multiplexed_model_id=...) parity:
        route the call to a replica already holding this model."""
        h = DeploymentHandle(self.deployment_name)
        h._model_id = multiplexed_model_id
        return h

    def _router(self):
        global _local_router
        with _lock:
            if _local_router is None:
                from ray_tpu_torch.serve.router import Router

                _local_router = Router(ray_tpu_torch.get_actor(CONTROLLER_NAME))
            return _local_router

    def remote(self, payload: Any = None, *,
               method: Optional[str] = None) -> DeploymentResponse:
        router = self._router()
        rid, ref = router.assign(
            self.deployment_name, payload, method,
            model_id=self._model_id,
        )
        return DeploymentResponse(
            router, self.deployment_name, payload, method, rid, ref
        )

    def __repr__(self):
        return f"DeploymentHandle({self.deployment_name!r})"


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def status() -> Dict[str, Any]:
    controller = start()
    return ray_tpu_torch.get(controller.status.remote())


def scale(name: str, num_replicas: int,
          drain_deadline_s: Optional[float] = None) -> bool:
    """Manually set a deployment's target replica count. Scale-down is
    session-aware: surplus replicas drain (no new sessions, live SSE
    streams finish) and exit, force-killed only at ``drain_deadline_s``
    (default RT_SERVE_AUTOSCALE_DRAIN_DEADLINE_S). On an autoscaling
    deployment the policy re-evaluates from the new target next tick."""
    controller = start()
    return ray_tpu_torch.get(
        controller.set_target_replicas.remote(
            name, num_replicas, drain_deadline_s
        )
    )


def autoscale_status() -> Dict[str, Any]:
    """Live control-loop state straight from the controller: replica
    counts (target/running/draining with per-drainer progress), the last
    scale decision, and the signals behind it. `state.autoscale_status()`
    reads the same snapshot from the head KV without needing the
    controller handle."""
    controller = start()
    return ray_tpu_torch.get(controller.autoscale_status.remote())


def delete(name: str) -> None:
    controller = start()
    ray_tpu_torch.get(controller.delete_deployment.remote(name))


def proxy_addresses():
    controller = start()
    return ray_tpu_torch.get(controller.proxy_addresses.remote())


def shutdown() -> None:
    global _controller, _local_router
    with _lock:
        controller = _controller
        _controller = None
        _local_router = None
    if controller is not None:
        try:
            ray_tpu_torch.get(controller.shutdown.remote(), timeout=30)
            ray_tpu_torch.kill(controller)
        except Exception:  # noqa: BLE001
            pass

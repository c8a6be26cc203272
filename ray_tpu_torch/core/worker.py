"""CoreWorker — the per-process runtime (driver and workers alike).

Parity: the reference CoreWorker (src/ray/core_worker/core_worker.h:167 —
Put :486, Get :662, Wait :702, CreateActor :884, SubmitActorTask :952), its
in-process memory store (store_provider/memory_store/), ownership tracking
(reference_counter.h:44), task submission (normal_task_submitter.h:124,
actor_task_submitter.h with per-caller ordering) and task execution
(task_execution/task_receiver.h + ordered actor queues).

Ownership model: the process that creates an object (by put or by task
submission) owns it — stores the value (or its plasma marker), serves
get_object to borrowers, and decides deletion. Refs crossing process
boundaries use the token-based borrow protocol (ReferenceTracker): each
serialization creates a TTL-bounded in-flight pin at the owner that the
deserializer consumes into a real borrow, released when the borrower's
last local ref drops.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
import traceback
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import object_store as os_mod
from ray_tpu_torch.core import runtime_env as runtime_env_mod
from ray_tpu_torch.core.device_objects import DeviceValue
from collections import OrderedDict, deque

from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    ActorUnavailableError,
    GetTimeoutError,
    ObjectLostError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.object_store import (
    LostValue,
    MemoryStore,
    PlasmaValue,
    ShmClient,
    pwritev_all,
)
from ray_tpu_torch.core.task import TaskOptions, TaskSpec
from ray_tpu_torch.observability import core_metrics, forensics, profiler, tracing
from ray_tpu_torch.utils import serialization
from ray_tpu_torch.utils.config import config
from ray_tpu_torch.utils.ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.utils.rpc import (
    ClientPool,
    RemoteError,
    RpcClient,
    RpcConnectionError,
    RpcError,
    RpcServer,
    RpcTimeout,
)

logger = logging.getLogger(__name__)

_global_worker: Optional["CoreWorker"] = None
_global_lock = threading.Lock()


def global_worker() -> "CoreWorker":
    if _global_worker is None:
        raise RuntimeError(
            "ray_tpu_torch is not initialized; call ray_tpu_torch.init() first."
        )
    return _global_worker


def global_worker_or_none() -> Optional["CoreWorker"]:
    return _global_worker


def set_global_worker(w: Optional["CoreWorker"]) -> None:
    global _global_worker
    with _global_lock:
        _global_worker = w


class ReferenceTracker:
    """Per-process ref bookkeeping (reference: reference_counter.h:44).

    Borrow protocol (token-based, replaces round-1 permanent escape
    pinning): every serialization of a ref creates an *in-flight pin* at
    the owner, tagged with a fresh token. The deserializer's add_borrow
    *consumes* the token — transferring the pin to the borrower — so the
    pin lives exactly as long as the borrow. A ref serialized but never
    deserialized (e.g. task args whose lease failed) would leak its pin;
    in-flight pins therefore carry a TTL (config.borrow_pin_ttl_s) and are
    swept opportunistically on tracker activity — the lightweight stand-in
    for the reference's task-completion borrow reports.

    Args of still-pending tasks are additionally guarded by a
    TASK-PENDENCY BORROW (the reference achieves this with
    task-completion borrow reports, reference_counter.h:44): when packing
    a task's args the submitter takes one plain borrow per serialized ref
    and releases it when the task reaches a terminal state. Unlike the
    in-flight token (consumed by the first deserialization), the pendency
    borrow survives retries — a ref arg stays alive across a lease-queue
    wait longer than the TTL AND between attempts of a retried task.
    """

    def __init__(self, worker: "CoreWorker"):
        self._worker = worker
        self._lock = threading.Lock()
        self._local_counts: Dict[ObjectID, int] = {}
        self._borrows: Dict[ObjectID, int] = {}  # owner side: remote borrowers
        # owner side: in-flight pins, token -> (oid, created_at monotonic)
        self._escape_tokens: Dict[str, Tuple[ObjectID, float]] = {}
        # serializer side: per-thread capture of refs serialized while
        # packing task args (worker._pack_task_args)
        self._capture = threading.local()
        self._next_sweep = 0.0
        # Tokens whose consume arrived before their register (one-way RPCs
        # on different sockets have no cross-connection ordering): a later
        # register for one of these must be dropped, not pinned forever.
        self._consumed_tokens: "OrderedDict[str, None]" = OrderedDict()
        self._borrow_sends: Dict[ObjectID, int] = {}  # borrower side: add_borrows sent

    def _remember_consumed_locked(self, token: str) -> None:
        self._consumed_tokens[token] = None
        while len(self._consumed_tokens) > 65536:
            self._consumed_tokens.popitem(last=False)

    def stats(self) -> Dict[str, Any]:
        """Reference-state snapshot for the state API: per-object local
        ref counts, outstanding remote borrows, and in-flight pins with
        their oldest age (a pin far past the TTL is a leaked borrow)."""
        now = time.monotonic()
        with self._lock:
            inflight: Dict[str, Dict[str, Any]] = {}
            for oid, created in self._escape_tokens.values():
                rec = inflight.setdefault(
                    oid.hex(), {"count": 0, "oldest_age_s": 0.0}
                )
                rec["count"] += 1
                rec["oldest_age_s"] = max(
                    rec["oldest_age_s"], round(now - created, 3)
                )
            return {
                "address": self._worker.address,
                "local_refs": {
                    o.hex(): n for o, n in self._local_counts.items() if n
                },
                "borrows": {
                    o.hex(): n for o, n in self._borrows.items() if n
                },
                "inflight_pins": inflight,
            }

    def add_local_ref(self, ref: ObjectRef) -> None:
        with self._lock:
            self._local_counts[ref.id] = self._local_counts.get(ref.id, 0) + 1

    def remove_local_ref(self, ref: ObjectRef) -> None:
        delete = False
        release = None
        with self._lock:
            count = self._local_counts.get(ref.id, 0) - 1
            if count <= 0:
                self._local_counts.pop(ref.id, None)
                if self._worker.owns(ref):
                    if not self._borrows.get(ref.id):
                        delete = True
                else:
                    release = self._borrow_sends.pop(ref.id, 0)
            else:
                self._local_counts[ref.id] = count
        if delete:
            self._worker.delete_owned_object(ref.id)
        elif release:
            self._worker.send_release_borrow(ref.owner_address, ref.id, n=release)
        self.sweep_expired_pins()

    def on_serialize(self, ref: ObjectRef, token: str) -> None:
        """A ref is crossing a process boundary: pin the object at the
        owner for the duration of the flight, keyed by token."""
        owned = self._worker.owns(ref)
        items = getattr(self._capture, "items", None)
        if items is not None:
            items.append((ref.owner_address, ref.id, owned))
        if owned:
            with self._lock:
                self._escape_tokens[token] = (ref.id, time.monotonic())
                self._borrows[ref.id] = self._borrows.get(ref.id, 0) + 1
            self.sweep_expired_pins()
        else:
            self._worker.send_add_borrow(
                ref.owner_address, ref.id, register_token=token
            )

    def begin_capture(self) -> None:
        """Start recording refs serialized by on_serialize on this thread."""
        self._capture.items = []

    def end_capture(self) -> List[Tuple[str, ObjectID, bool]]:
        """Stop recording; return [(owner_address, oid, owned)]."""
        items = getattr(self._capture, "items", None) or []
        self._capture.items = None
        return items

    def add_task_borrow(self, oid: ObjectID) -> None:
        """Owner-side pendency borrow: keep an owned ref arg alive while
        its task is pending (released via owner_release_borrow)."""
        with self._lock:
            self._borrows[oid] = self._borrows.get(oid, 0) + 1

    def on_deserialize(self, ref: ObjectRef, token: Optional[str]) -> None:
        """A ref arrived from another process; take over its in-flight pin
        (or add a fresh borrow if the token was already consumed)."""
        if self._worker.owns(ref):
            # Our own ref came back: the local count now guards it.
            consume = False
            with self._lock:
                if token is not None:
                    if token in self._escape_tokens:
                        del self._escape_tokens[token]
                        consume = True
                    else:
                        # The serializer's register (a one-way RPC on another
                        # socket) hasn't landed yet: remember the token so the
                        # late register is dropped instead of pinning forever.
                        self._remember_consumed_locked(token)
            if consume:
                self.owner_release_borrow(ref.id)
            return
        with self._lock:
            self._borrow_sends[ref.id] = self._borrow_sends.get(ref.id, 0) + 1
        self._worker.send_add_borrow(
            ref.owner_address, ref.id, consume_token=token
        )

    def owner_add_borrow(
        self,
        oid: ObjectID,
        register_token: Optional[str] = None,
        consume_token: Optional[str] = None,
    ) -> None:
        with self._lock:
            if consume_token is not None:
                if consume_token in self._escape_tokens:
                    # Transfer the in-flight pin to this borrower: no increment.
                    del self._escape_tokens[consume_token]
                    return
                # Consume beat its register (no cross-socket ordering):
                # count this borrower now and remember the token so the
                # late register is dropped instead of pinning forever.
                self._remember_consumed_locked(consume_token)
            if register_token is not None:
                if register_token in self._consumed_tokens:
                    # The deserializer already took (and counted) this pin.
                    return
                self._escape_tokens[register_token] = (oid, time.monotonic())
            self._borrows[oid] = self._borrows.get(oid, 0) + 1
        self.sweep_expired_pins()

    def owner_release_borrow(self, oid: ObjectID, n: int = 1) -> None:
        delete = False
        with self._lock:
            remaining = self._borrows.get(oid, 0) - n
            if remaining <= 0:
                self._borrows.pop(oid, None)
                if not self._local_counts.get(oid):
                    delete = True
            else:
                self._borrows[oid] = remaining
        if delete and self._worker.owns_id(oid):
            # If the producing task hasn't stored the result yet, the store
            # hook (maybe_delete_unreferenced at _store_task_reply) catches
            # the release-before-store ordering.
            self._worker.delete_owned_object(oid)

    def sweep_expired_pins(self) -> None:
        """Release in-flight pins whose token was never consumed within the
        TTL (serialized-but-never-deserialized refs — lease failures,
        dropped messages). Rate-limited to one sweep per TTL/4."""
        ttl = float(config.borrow_pin_ttl_s)
        now = time.monotonic()
        expired: List[ObjectID] = []
        with self._lock:
            if now < self._next_sweep:
                return
            self._next_sweep = now + ttl / 4
            for token, (oid, created) in list(self._escape_tokens.items()):
                if now - created > ttl:
                    del self._escape_tokens[token]
                    expired.append(oid)
        for oid in expired:
            self.owner_release_borrow(oid)

    def maybe_delete_unreferenced(self, oid: ObjectID) -> bool:
        """True if nothing (local refs, borrows, in-flight pins) can ever
        reach this object — called when a task result lands after all its
        refs were already dropped."""
        with self._lock:
            return not self._local_counts.get(oid) and not self._borrows.get(oid)


class _ActorRuntime:
    """Executor-side state when this worker hosts an actor."""

    def __init__(self, actor_id: str, instance, max_concurrency: int,
                 concurrency_groups: Optional[Dict[str, int]] = None,
                 method_groups: Optional[Dict[str, str]] = None):
        self.actor_id = actor_id
        self.instance = instance
        self.max_concurrency = max_concurrency
        # Concurrency groups (reference
        # task_execution/concurrency_group_manager.h:38): each named
        # group gets its OWN queue + thread pool sized to its limit, so a
        # saturated "io" group can never starve "compute" — ungrouped
        # methods ride the default pool of max_concurrency threads.
        self.queue: "queue.Queue" = queue.Queue()  # default group
        self.group_queues: Dict[str, "queue.Queue"] = {
            g: queue.Queue() for g in (concurrency_groups or {})
        }
        self.group_limits: Dict[str, int] = dict(concurrency_groups or {})
        self.method_groups: Dict[str, str] = dict(method_groups or {})
        self.threads: List[threading.Thread] = []
        self.running = 0  # executions in flight (guarded by running_lock)
        self.running_lock = threading.Lock()
        # Direct-call concurrency bound (rpc_actor_direct_call): direct
        # dispatches run on the RPC dispatcher pool, not the executor
        # threads, so they need their OWN max_concurrency gate — without
        # it the serve proxy's hot path would run a max_concurrency=1
        # deployment's callable concurrently. (Mixed handle+direct
        # traffic can still reach 2x the bound — one per path — which
        # serve replicas tolerate; handle-only or proxy-only traffic,
        # the common cases, see exactly max_concurrency.)
        self.direct_sem = threading.BoundedSemaphore(max(1, max_concurrency))
        # Lazily-started asyncio loop for `async def` methods (reference:
        # async actors run coroutines on one event loop, task_execution
        # fiber/async queues): coroutines are scheduled here and the reply
        # is sent from a done-callback, so thousands of IO-bound calls
        # overlap without occupying executor threads.
        self.loop = None
        self.loop_lock = threading.Lock()
        # async mode: ANY coroutine method makes every call run on the
        # event loop (set at creation from the instance's methods)
        import inspect

        self.is_async = any(
            inspect.iscoroutinefunction(m)
            for _, m in inspect.getmembers(instance, callable)
        )

    def queue_for(self, method_name: str) -> "queue.Queue":
        group = self.method_groups.get(method_name)
        if group is not None and group in self.group_queues:
            return self.group_queues[group]
        return self.queue

    def total_queued(self) -> int:
        return self.queue.qsize() + sum(
            q.qsize() for q in self.group_queues.values()
        )

    def ensure_loop(self):
        import asyncio

        with self.loop_lock:
            if self.loop is None:
                self.loop = asyncio.new_event_loop()
                t = threading.Thread(
                    target=self.loop.run_forever,
                    name="actor-asyncio", daemon=True,
                )
                t.start()
                self.threads.append(t)
            return self.loop


class CoreWorker:
    def __init__(
        self,
        mode: str,  # "driver" | "worker"
        control_address: str,
        node_agent_address: str,
        session_id: str,
        node_id_hex: str,
        job_id: Optional[JobID] = None,
    ):
        self.mode = mode
        self.worker_id = WorkerID.from_random()
        self.session_id = session_id
        self.node_id_hex = node_id_hex
        self.control_address = control_address
        self.node_agent_address = node_agent_address

        self.server = RpcServer(f"{mode}-worker")
        self.server.register_instance(self)
        self.server.register_raw("actor_task", self._raw_actor_task)
        self.server.start()

        from ray_tpu_torch.core.ha import head_resolver

        self.control = RpcClient(
            control_address, name=f"{mode}->cs", resolver=head_resolver()
        )
        self.agent = RpcClient(node_agent_address, name=f"{mode}->agent")
        self.workers = ClientPool("w2w")
        self.agents = ClientPool("w2agent")

        self.memory_store = MemoryStore()
        self.shm = ShmClient()
        # deferred segment reclaim: private segments whose DELETE arrived
        # while live views (arrays a get() returned) still pinned the
        # mapping — in `get(put(x))` the value dies a beat AFTER the ref,
        # so recycling at ref-death would always miss. Entries are
        # [oid_hex, path, attempts]; flushed before the next plasma
        # create (the previous iteration's views are dead by then), so a
        # put/delete loop reuses its own warm pages.
        self._pending_reclaim: deque = deque()
        self._pending_reclaim_lock = threading.Lock()
        # data-plane port cache per agent: addr -> (port, fetched_at);
        # entries expire so an agent restart gets re-discovered
        self._data_ports: Dict[str, Tuple[int, float]] = {}
        # TPU-RDT: lazily-built store of device-resident pytrees this
        # process produced under tensor_transport="device"
        self._device_store = None
        self._device_store_lock = threading.Lock()
        # obj_hex -> export meta dict: device leaves exported once into a
        # local-agent shm segment, then served zero-copy (same host) or
        # over the sendfile data plane (cross host)
        self._device_exports: Dict[str, Dict[str, Any]] = {}
        self._device_exports_lock = threading.Lock()
        # eager-export throttle: at most this many background D2H+write
        # threads at once; past it, exports stay lazy (consumer's first
        # get builds them) instead of queueing unbounded work
        self._eager_export_sem = threading.BoundedSemaphore(2)
        # remote-driver (gateway) mode: set by enable_gateway_mode()
        self._public_address: Optional[str] = None
        self._remote_driver = False
        self._reverse_listener = None
        self.reference_tracker = ReferenceTracker(self)

        self.job_id = job_id or JobID.nil()
        self.driver_task_id: Optional[TaskID] = None
        self._task_index_lock = threading.Lock()
        self._put_index = 0

        self._registered_fns: set = set()
        self._fn_cache: Dict[str, Any] = {}

        self._submit_pool = ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="submit"
        )
        # Owner-side task dependency resolution (reference
        # local_dependency_resolver.h): started lazily on the first task
        # submitted with a pending ObjectRef arg.
        self._dep_resolver: Optional[_DependencyResolver] = None
        self._dep_resolver_lock = threading.Lock()
        # actor tasks: task_id hex -> pending top-level ObjectRef args,
        # awaited by the actor sender thread before the send
        self._pending_task_deps: Dict[str, List[ObjectRef]] = {}
        # per-actor ordered senders + address cache
        self._actor_senders: Dict[str, "_ActorSender"] = {}
        self._actor_senders_lock = threading.Lock()
        # per-scheduling-key lease-caching normal-task submitters
        # (reference normal_task_submitter.h:52-82), swept by ONE shared
        # janitor thread (started with the first submitter)
        self._task_submitters: Dict[tuple, "_NormalTaskSubmitter"] = {}
        self._task_submitters_lock = threading.Lock()
        self._submitter_janitor: Optional[threading.Thread] = None
        self._actor_addr_cache: Dict[str, str] = {}
        # lifecycle batching (ISSUE 14): created on first use when
        # actor_batch_flush_ms > 0; kill_actor records the id here so a
        # task submitted right after a (still-queued) kill fails with
        # ActorDiedError deterministically instead of racing the flush
        self._lifecycle_batcher: Optional[_ActorLifecycleBatcher] = None
        self._lifecycle_batcher_lock = threading.Lock()
        self._locally_killed: set = set()

        self._actor_runtime: Optional[_ActorRuntime] = None
        self._current_ctx = threading.local()
        self._shutdown = threading.Event()

        # cancellation + bookkeeping of in-flight executions
        self._running_tasks: Dict[str, Dict[str, Any]] = {}
        self._cancelled_tasks: set = set()
        # owner side: task_id hex -> worker address currently executing it
        self._inflight_push: Dict[str, str] = {}
        # submitter side: task_id hex -> [(owner_address, ObjectID, owned)]
        # pendency borrows protecting the task's serialized args until it
        # reaches a terminal state
        self._arg_pins: Dict[str, List[Tuple[str, ObjectID, bool]]] = {}
        # actors whose init-arg borrows must outlive the first ALIVE
        # observation (max_restarts != 0: restarts re-read the init args)
        self._restartable_actor_inits: set = set()
        self._reattach_lock = threading.Lock()
        # lineage (reference object_recovery_manager.h:26 + task_manager.h
        # lineage bookkeeping): task_id hex -> [spec, strategy,
        # live_return_count] for re-executing the creating task when its
        # objects are lost. Bounded by BYTES of retained arg frames (the
        # reference bounds lineage the same way) as well as entry count;
        # entries drop when every return of the task has been deleted.
        self._lineage: "OrderedDict[str, List[Any]]" = OrderedDict()
        self._lineage_bytes = 0
        self._lineage_lock = threading.Lock()
        # single-flight guard: task_id hex -> Event set when re-execution done
        self._reconstructing: Dict[str, threading.Event] = {}
        # actor_id -> max_task_retries (lazily fetched from the actor record)
        self._actor_retry_cache: Dict[str, int] = {}
        # task execution events for the timeline (reference
        # task_event_buffer.cc -> GcsTaskManager -> `ray timeline`):
        # bounded ring of execution slices {name, task_id, ts_us, dur_us}
        # plus lifecycle instants (observability/tracing.py). Evictions
        # are counted so a truncated timeline is detectable.
        self._task_events: deque = deque(maxlen=10000)
        self._task_events_dropped = 0

    # ------------------------------------------------------------------
    # identity / context
    # ------------------------------------------------------------------

    @property
    def address(self) -> str:
        # remote-driver mode: advertise the gateway-side reverse address
        # (cluster peers cannot reach a NAT'd driver directly)
        if self._public_address is not None:
            return self._public_address
        return self.server.address

    def owns(self, ref: ObjectRef) -> bool:
        return ref.owner_address == self.address

    def owns_id(self, oid: ObjectID) -> bool:
        """True if this worker is the owner of an object it stores locally
        (used when only the id, not a ref with owner address, is at hand)."""
        return self.memory_store.contains(oid)

    def current_task_id(self) -> Optional[TaskID]:
        return getattr(self._current_ctx, "task_id", None) or self.driver_task_id

    def current_actor_id(self) -> Optional[str]:
        if self._actor_runtime is not None:
            return self._actor_runtime.actor_id
        return None

    def current_job_id(self) -> JobID:
        ctx_job = getattr(self._current_ctx, "job_id", None)
        return ctx_job or self.job_id

    def _next_task_id(self) -> TaskID:
        return TaskID.for_normal_task(self.current_job_id())

    # ------------------------------------------------------------------
    # connection bring-up
    # ------------------------------------------------------------------

    def connect_driver(self) -> None:
        job_hex = self.control.call(
            "register_job", driver_address=self.address, metadata={"pid": os.getpid()},
            retryable=True,
        )
        self.job_id = JobID.from_hex(job_hex)
        self.driver_task_id = TaskID.for_driver(self.job_id)
        self._subscribe_actor_updates()

    def _subscribe_actor_updates(self) -> None:
        """Track actor address changes via control-store pubsub (parity:
        callers resolve actor location via GCS subscribe, SURVEY.md §3.3)."""

        def on_pubsub(payload):
            topic, data = payload
            if topic != "actor":
                return
            aid = data.get("actor_id")
            if not aid:
                return
            if data.get("state") == "ALIVE" and data.get("worker_address"):
                self._actor_addr_cache[aid] = data["worker_address"]
            else:
                self._actor_addr_cache.pop(aid, None)

        self.control.on_push("pubsub", on_pubsub)
        self.control.call("subscribe", topics=["actor"], retryable=True)
        # Subscriptions are connection-scoped server state: after a head
        # bounce the (re-attached) connection must re-assert them, and the
        # address cache may be stale for anything that moved meanwhile.
        def resubscribe():
            self._actor_addr_cache.clear()
            self.control.call("subscribe", topics=["actor"], timeout_s=10.0)

        self.control.add_reconnect_callback(resubscribe)

    def enable_gateway_mode(self) -> None:
        """Remote-driver mode (reference ray:// client,
        util/client/ARCHITECTURE.md): this driver reaches the cluster
        only through the head gateway. Outbound connections tunnel
        (rpc.py connect); inbound peers reach us via a gateway-side
        reverse bind whose address we advertise; and shm paths are never
        local, so big objects stay in the memory store and plasma reads
        always take the chunked/data-plane pull."""
        from ray_tpu_torch.utils import gateway as gateway_mod

        self._remote_driver = True
        rl = gateway_mod.ReverseListener(
            self.server, f"drv-{self.worker_id.hex()[:12]}"
        )
        self._public_address = rl.start()
        self._reverse_listener = rl

    def connect_worker(self) -> None:
        self.agent.call(
            "register_worker",
            worker_id=self.worker_id.hex(),
            address=self.address,
            pid=os.getpid(),
            kind=getattr(self, "worker_kind", "cpu"),
            env_hash=getattr(self, "boot_env_hash", ""),
            retryable=True,
        )
        self._subscribe_actor_updates()
        t = threading.Thread(target=self._agent_watchdog, name="agent-watch", daemon=True)
        t.start()
        if forensics.ENABLED and float(config.task_stall_dump_s) > 0:
            threading.Thread(
                target=self._stall_watchdog, name="stall-watch",
                daemon=True,
            ).start()
        profiler.maybe_start_continuous()

    def _stall_watchdog(self) -> None:
        """Flag tasks running past ``task_stall_dump_s``: ONE
        ``{"type": "stall"}`` event per task occurrence, carrying the
        stuck thread's stack into the event ring (forensics)."""
        threshold = float(config.task_stall_dump_s)
        period = min(max(threshold / 4.0, 0.05), 2.0)
        stamped: set = set()
        while not self._shutdown.wait(period):
            now = time.monotonic()
            for tid_hex, info in list(self._running_tasks.items()):
                t0 = info.get("t0")
                if t0 is None or now - t0 < threshold \
                        or tid_hex in stamped:
                    continue
                stamped.add(tid_hex)
                if forensics.ENABLED:
                    forensics.stamp_stall(
                        task_id=tid_hex,
                        name=info.get("name", ""),
                        elapsed_s=now - t0,
                        thread_ident=info.get("tid"),
                        worker_address=self.address,
                    )
            # forget finished tasks so the one-shot set stays bounded
            stamped &= set(self._running_tasks)

    def _agent_watchdog(self) -> None:
        """Exit if the node agent goes away (orphan prevention: a node's
        workers die with the node, as the reference raylet guarantees)."""
        failures = 0
        while not self._shutdown.wait(2.0):
            try:
                self.agent.call("store_usage", timeout_s=5.0)
                failures = 0
            except RpcConnectionError:
                # connection refused/reset: the agent process is gone
                failures += 3
            except RpcError:
                # slow but alive (CPU contention): be patient
                failures += 1
            if failures >= 3:
                logger.warning("node agent unreachable; worker exiting")
                os._exit(1)

    def shutdown(self) -> None:
        if self._reverse_listener is not None:
            try:
                self._reverse_listener.stop()
            except Exception:  # noqa: BLE001 — teardown path
                pass
        self._shutdown.set()
        if self._lifecycle_batcher is not None:
            # ship still-queued registrations/kills before the control
            # connection goes away
            self._lifecycle_batcher.close()
        self._submit_pool.shutdown(wait=False)
        self.server.stop()
        self.control.close()
        self.agent.close()
        self.workers.close_all()
        self.agents.close_all()
        self.shm.close()

    # ------------------------------------------------------------------
    # function table
    # ------------------------------------------------------------------

    def register_function(self, fn_id: str, blob: bytes, name: str) -> None:
        if fn_id in self._registered_fns:
            return
        self.control.call("kv_put", ns="fn", key=fn_id, value=blob, overwrite=False,
                          retryable=True)
        self._registered_fns.add(fn_id)

    def load_function(self, fn_id: str):
        fn = self._fn_cache.get(fn_id)
        if fn is None:
            blob = self.control.call("kv_get", ns="fn", key=fn_id, retryable=True)
            if blob is None:
                raise RuntimeError(f"function {fn_id} not found in function table")
            fn = serialization.loads(blob)
            self._fn_cache[fn_id] = fn
        return fn

    # ------------------------------------------------------------------
    # put / get / wait / free (reference core_worker.h:486,662,702)
    # ------------------------------------------------------------------

    def put(self, value: Any, tensor_transport: str = "object") -> ObjectRef:
        with self._task_index_lock:
            self._put_index += 1
            idx = self._put_index
        task_id = self.current_task_id() or TaskID.for_driver(self.current_job_id())
        oid = ObjectID.from_task(task_id, 2**31 + idx)
        if tensor_transport == "device":
            parts = self.device_store.put(oid.hex(), value)
            if parts is not None:
                skeleton, leaves_meta = parts
                self._maybe_eager_export(oid.hex())
                self.memory_store.put(
                    oid,
                    DeviceValue(self.address, oid.hex(), skeleton, leaves_meta),
                )
                return ObjectRef(oid, self.address)
            # no device arrays inside: fall through to the object path
        self.memory_store.put(oid, self._serialize_to_store(oid, value))
        return ObjectRef(oid, self.address)

    def _serialize_to_store(self, oid: ObjectID, value: Any):
        """Serialize a value to its stored form: a PlasmaValue whose frame
        was written through to shm (write-through put: the pickle-5
        buffers are sized first, the segment created at exactly that
        size, then header+meta+buffers land in ONE vectored pwritev — no
        intermediate pack() concatenation, no second shm copy), or an
        in-band frame below the plasma threshold."""
        meta, views = serialization.serialize(value)
        total = serialization.frame_nbytes(meta, views)
        if self._remote_driver or total <= config.max_direct_call_object_size:
            # no local shm on a gateway driver: keep the frame owner-side;
            # consumers fetch via get_object (chunked over the tunnel)
            return serialization.pack_parts(meta, views)
        path = self._write_through_plasma(oid.hex(), meta, views, total)
        return PlasmaValue(path, total, self.node_agent_address, private=True)

    _RECLAIM_MAX = 32
    _RECLAIM_ATTEMPTS = 8

    def _flush_pending_reclaim(self) -> None:
        """Retry deferred reclaims: a segment whose views have died since
        its delete gets recycled (warm pages for the create about to
        happen on the same connection); one whose views persist re-queues
        up to _RECLAIM_ATTEMPTS, then downgrades to a plain delete (the
        pinned mapping keeps its pages either way — the downgrade only
        restores the agent's accounting)."""
        if not self._pending_reclaim:
            return
        with self._pending_reclaim_lock:
            pending = list(self._pending_reclaim)
            self._pending_reclaim.clear()
        for entry in pending:
            oid_hex, path, attempts = entry
            try:
                if self.shm.try_drop(path):
                    self.agent.call_oneway("recycle_object", oid_hex=oid_hex)
                elif attempts + 1 >= self._RECLAIM_ATTEMPTS:
                    # evict the cached mapping too (GC closes it when the
                    # views die) — a cache entry surviving the unlink
                    # would pin the dead pages for the process lifetime
                    self.shm.drop(path)
                    self.agent.call_oneway(
                        "delete_objects", oid_hexes=[oid_hex]
                    )
                else:
                    with self._pending_reclaim_lock:
                        self._pending_reclaim.append(
                            [oid_hex, path, attempts + 1]
                        )
            except RpcError:
                pass

    def _defer_reclaim(self, oid: ObjectID, path: str) -> None:
        overflow = None
        with self._pending_reclaim_lock:
            self._pending_reclaim.append([oid.hex(), path, 0])
            if len(self._pending_reclaim) > self._RECLAIM_MAX:
                overflow = self._pending_reclaim.popleft()
        if overflow is not None:
            self.shm.drop(overflow[1])  # evict cache; GC closes with the views
            try:
                self.agent.call_oneway(
                    "delete_objects", oid_hexes=[overflow[0]]
                )
            except RpcError:
                pass

    def _write_through_plasma(
        self, oid_hex: str, meta, views, total: int
    ) -> str:
        """create_object at the exact frame size, then pwritev the
        scatter-gather pieces straight into the segment. seal rides a
        oneway call: same-host readers only learn the path from the
        marker we store after this returns, and get_meta-based readers
        block on the store's sealed condition, so ordering is safe."""
        self._flush_pending_reclaim()
        path = self.agent.call("create_object", oid_hex=oid_hex, size=total)
        parts = serialization.frame_parts(meta, views)
        fd = os.open(path, os.O_RDWR)
        try:
            pwritev_all(fd, parts)
        finally:
            os.close(fd)
        if serialization.copy_hook is not None:
            serialization.note_copy(total, "put-pwritev")
        self._send_seal(oid_hex)
        return path

    def _send_seal(self, oid_hex: str) -> None:
        """Seal without waiting, but with delivery guaranteed: the frame
        goes out synchronously (in-order with the surrounding create /
        recycle traffic on this connection — the agent's raw handler
        preserves that order), and the ack is checked asynchronously — a
        seal lost to a dropped connection is re-sent with the full retry
        ladder, because an unsealed segment wedges every future reader
        of an object whose put() already reported success."""
        pending = self.agent.call_async("seal_object", oid_hex=oid_hex)

        def _on_done(p, oid_hex=oid_hex):
            if not p.ok:
                self._submit_pool.submit(self._retry_seal, oid_hex)

        pending.add_done_callback(_on_done)

    def _retry_seal(self, oid_hex: str) -> None:
        try:
            self.agent.call("seal_object", oid_hex=oid_hex, retryable=True)
        except RpcError:
            pass  # object deleted meanwhile, or agent truly gone

    @property
    def device_store(self):
        """TPU-RDT device object store (lazy: imports jax machinery only
        when tensor_transport='device' is actually used)."""
        with self._device_store_lock:
            if self._device_store is None:
                from ray_tpu_torch.core.device_objects import DeviceObjectStore

                self._device_store = DeviceObjectStore()
            return self._device_store

    def _fetch_device_value(self, dv) -> Any:
        """Materialize a DeviceValue: zero-copy when this process holds
        the payload; otherwise the holder exports its leaves once into an
        agent shm segment and we mmap it (same host) or stream it over
        the raw-TCP sendfile data plane (cross host), then device_put —
        tensor bytes never ride a pickled RPC reply (VERDICT r4 #3)."""
        import numpy as np

        from ray_tpu_torch.core import device_objects as dev_mod

        if dv.worker_address == self.address:
            return self.device_store.get_value(dv.obj_hex)
        client = self.workers.get(dv.worker_address)
        try:
            meta = client.call(
                "export_device_object", obj_hex=dv.obj_hex, timeout_s=600.0
            )
        except RpcConnectionError as e:
            raise ObjectLostError(
                f"device object {dv.obj_hex[:16]} lost: holder "
                f"{dv.worker_address} unreachable ({e})"
            ) from None
        if meta is None:
            raise ObjectLostError(
                f"device object {dv.obj_hex[:16]} was freed at the holder"
            )
        if (
            meta["agent_addr"] == self.node_agent_address
            and not self._remote_driver
        ):
            # drop any cached mmap of this path first: a retried task can
            # re-export under the same deterministic object id, and a
            # stale mapping of the deleted inode would silently serve the
            # failed attempt's bytes
            self.shm.drop(meta["path"])
            view = self._read_local_segment(meta["path"], meta["size"])
        else:
            view = memoryview(
                self._pull_remote_segment(
                    meta["path"], meta["size"], meta["agent_addr"]
                )
            )
        # each leaf into a tensor of its own on its kind of device (a CUDA
        # leaf on this process's card); bf16 crossed the wire as its bits
        arrays = dev_mod.device_put(view, meta["offsets"], dv.leaves_meta)
        return dev_mod.join_device_value(dv.skeleton, arrays)

    def _store_frame_maybe_plasma(self, oid: ObjectID, frame) -> None:
        """Store an ALREADY-PACKED frame (placement specs, channel relays):
        write-through to shm above the plasma threshold, in-band below."""
        nbytes = len(frame)
        if self._remote_driver or nbytes <= config.max_direct_call_object_size:
            # no local shm on a gateway driver: keep the frame owner-side;
            # consumers fetch via get_object (chunked over the tunnel)
            self.memory_store.put(oid, frame)
            return
        path = self.agent.call("create_object", oid_hex=oid.hex(), size=nbytes)
        fd = os.open(path, os.O_RDWR)
        try:
            pwritev_all(fd, [serialization.as_view(frame)])
        finally:
            os.close(fd)
        if serialization.copy_hook is not None:
            serialization.note_copy(nbytes, "put-pwritev")
        self._send_seal(oid.hex())
        self.memory_store.put(
            oid, PlasmaValue(path, nbytes, self.node_agent_address)
        )

    def get(self, refs: List[ObjectRef], timeout_s: Optional[float] = None) -> List[Any]:
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        out = []
        for ref in refs:
            remaining = None
            if deadline is not None:
                remaining = max(0.0, deadline - time.monotonic())
            out.append(self._get_one(ref, remaining))
        return out

    def _get_one(self, ref: ObjectRef, timeout_s: Optional[float]) -> Any:
        if self.owns(ref):
            try:
                stored = self.memory_store.get(ref.id, timeout_s)
            except TimeoutError:
                raise GetTimeoutError(
                    f"get() on {ref.id.hex()} timed out after {timeout_s}s"
                ) from None
            try:
                return self._materialize(stored)
            except (ObjectLostError, RpcConnectionError):
                # the value's segment is gone (hosting node died): lineage
                # reconstruction re-executes the creating task. The re-run
                # may overrun a short get timeout — recovery is bounded by
                # the task, not the caller's poll interval (reference
                # recovery is likewise asynchronous w.r.t. the get).
                if not self.reconstruct_object(ref.id):
                    raise
                stored = self.memory_store.get(ref.id, timeout_s)
                return self._materialize(stored)
        client = self.workers.get(ref.owner_address)
        for attempt in range(2):
            try:
                reply = client.call(
                    "get_object", oid_hex=ref.id.hex(), wait_s=timeout_s,
                    requester_agent=(
                        "remote-driver" if self._remote_driver
                        else self.node_agent_address
                    ),
                    timeout_s=(timeout_s + 30.0) if timeout_s is not None else 86400.0,
                )
            except RpcTimeout:
                raise GetTimeoutError(
                    f"get() on {ref.id.hex()} timed out after {timeout_s}s"
                ) from None
            except RpcConnectionError as e:
                raise ObjectLostError(
                    f"owner of {ref.id.hex()} at {ref.owner_address} is "
                    f"unreachable: {e}"
                ) from None
            try:
                return self._materialize_reply(reply)
            except (ObjectLostError, RpcConnectionError):
                # segment pull failed (hosting node died): ask the OWNER to
                # reconstruct from lineage, then re-fetch once. Bounded by
                # the caller's remaining timeout when one was given.
                if attempt > 0:
                    raise
                recon_timeout = 600.0 if timeout_s is None else max(
                    1.0, timeout_s
                )
                try:
                    ok = client.call(
                        "reconstruct_object", oid_hex=ref.id.hex(),
                        timeout_s=recon_timeout,
                    )
                except RpcError:
                    ok = False
                if not ok:
                    raise

    def _materialize(self, stored: Any) -> Any:
        if serialization.is_bytes_like(stored):
            return serialization.unpack(stored)
        if isinstance(stored, PlasmaValue):
            if (
                stored.agent_address != self.node_agent_address
                or self._remote_driver
            ):
                # Owner-side ref to a segment hosted on another node (the
                # producing task ran remotely): pull through that node's
                # agent rather than touching a path that only exists there.
                data = self._pull_remote_segment(
                    stored.path, stored.size, stored.agent_address
                )
                return serialization.unpack(data)
            view = self._read_local_segment(stored.path, stored.size)
            return serialization.unpack(view)
        if isinstance(stored, DeviceValue):
            return self._fetch_device_value(stored)
        if isinstance(stored, TaskError):
            raise stored
        if isinstance(stored, LostValue):
            stored.raise_()
        if isinstance(stored, Exception):
            raise stored
        raise RuntimeError(f"unexpected stored value kind: {type(stored)}")

    def _materialize_reply(self, reply: Tuple[str, Any]) -> Any:
        kind, payload = reply
        if kind == "frame":
            return serialization.unpack(payload)
        if kind == "plasma":
            path, size = payload
            view = self._read_local_segment(path, size)
            return serialization.unpack(view)
        if kind == "remote_plasma":
            # Object lives in another host's shm store: pull it in chunks
            # through that host's node agent (reference C8 object-manager
            # push/pull, object_manager.h:128 — chunked transfer).
            path, size, agent_address = payload
            data = self._pull_remote_segment(path, size, agent_address)
            return serialization.unpack(data)
        if kind == "device":
            addr, skeleton, leaves_meta = payload[:3]
            obj_hex = payload[3]
            return self._fetch_device_value(
                DeviceValue(addr, obj_hex, skeleton, leaves_meta)
            )
        if kind == "error":
            raise payload
        raise RuntimeError(f"unexpected get_object reply kind {kind}")

    def _read_local_segment(self, path: str, size: int) -> memoryview:
        """mmap a same-host segment; if the file is gone the store spilled
        it — ask the agent for the meta (get_meta restores spilled
        segments into shm) and retry. Bounded retries: under heavy
        spill/restore thrash the restored segment can be re-spilled
        before our mmap lands."""
        oid_hex = path.rsplit("_", 1)[-1]
        for _ in range(4):
            try:
                return self.shm.read_view(path, size)
            except FileNotFoundError:
                pass
            meta = self.agent.call(
                "get_object_meta", oid_hex=oid_hex, timeout_s=60.0,
            )
            if meta is None:
                raise ObjectLostError(f"segment {path} is gone from the store")
            path, size = meta
        raise ObjectLostError(
            f"segment {path} kept vanishing (spill/restore thrash)"
        )

    def _pull_remote_segment(
        self, path: str, size: int, agent_address: str
    ) -> memoryview:
        """Chunked pull with a sliding window of chunk RPCs in flight
        (parity: reference PushManager/PullManager pipelining,
        src/ray/object_manager/push_manager.h:28 — one-at-a-time round
        trips made a 1 GiB object ~1,000 serial RPCs). Objects past the
        large-object threshold stream into a disk-backed mmap instead of
        one giant heap bytearray."""
        chunk = int(config.object_transfer_chunk_size)
        window = max(1, int(config.object_transfer_window))
        agent = self.agents.get(agent_address)
        if size >= int(config.object_pull_disk_threshold):
            import tempfile

            f = tempfile.TemporaryFile(prefix="rtpull_")
            f.truncate(max(size, 1))
            import mmap as mmap_mod

            mm = mmap_mod.mmap(f.fileno(), max(size, 1))
            f.close()  # mapping keeps the (anonymous-after-close) file alive
            buf: Any = mm
        else:
            buf = bytearray(size)
        # Data plane first: one raw-TCP request streams the whole segment
        # (agent-side sendfile, native recv pump) — the chunked RPC pull
        # below is the fallback when the agent predates the data port or
        # the stream breaks mid-flight.
        if size > 0 and self._pull_via_data_plane(
            path, size, agent_address, buf
        ):
            return memoryview(buf)
        offsets = list(range(0, size, chunk))
        inflight: "OrderedDict[int, Any]" = OrderedDict()
        next_idx = 0
        done = 0
        while done < len(offsets):
            while next_idx < len(offsets) and len(inflight) < window:
                off = offsets[next_idx]
                n = min(chunk, size - off)
                inflight[off] = agent.call_async(
                    "read_object_chunk", path=path, offset=off, length=n,
                )
                next_idx += 1
            off, pending = next(iter(inflight.items()))
            del inflight[off]
            piece = pending.wait(60.0)
            expected = min(chunk, size - off)
            mv = serialization.as_view(piece) if piece is not None else None
            if mv is None or mv.nbytes != expected:
                # None (file gone) or short (segment truncated/replaced):
                # either way the object is lost. A gap must never be
                # silently zero-filled.
                raise ObjectLostError(
                    f"remote segment {path} vanished during transfer"
                )
            buf[off:off + mv.nbytes] = mv
            if serialization.copy_hook is not None:
                serialization.note_copy(mv.nbytes, "pull-chunk-assemble")
            done += 1
        return memoryview(buf)  # no copy; unpack accepts buffer views

    _DATA_LOST = 0xFFFFFFFFFFFFFFFF

    def _pull_via_data_plane(
        self, path: str, size: int, agent_address: str, buf
    ) -> bool:
        """Stream the whole segment over the agent's data port into
        ``buf``. True on success; False falls back to the chunked RPC
        pull. Raises ObjectLostError when the holder reports the object
        gone (the fallback would fail identically)."""
        import socket
        import struct

        cached = self._data_ports.get(agent_address)
        if cached is not None and time.monotonic() - cached[1] > 60.0:
            cached = None  # stale: agent may have restarted with a new port
        if cached is None:
            try:
                port = int(self.agents.get(agent_address).call(
                    "get_data_port", timeout_s=10.0
                ) or 0)
            except RpcError:
                # transient: fall back THIS pull, ask again next time
                return False
            cached = (port, time.monotonic())
            self._data_ports[agent_address] = cached
        port = cached[0]
        if not port:
            return False
        host = agent_address.rsplit(":", 1)[0]
        from ray_tpu_torch.utils import gateway as gateway_mod

        def _open_data_conn():
            if gateway_mod.gateway_address() is not None:
                # remote-driver mode: the raw data plane tunnels too
                return gateway_mod.open_tunnel(
                    f"{host}:{port}", timeout=5.0
                )
            return socket.create_connection((host, port), timeout=5.0)

        try:
            with _open_data_conn() as s:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # kernel-level receive timeout: the native pump blocks in
                # recv(2) without Python's non-blocking timeout machinery
                s.settimeout(None)
                s.setsockopt(
                    socket.SOL_SOCKET, socket.SO_RCVTIMEO,
                    struct.pack("@ll", 120, 0),
                )
                p = path.encode()
                s.sendall(
                    struct.pack("<I", len(p)) + p
                    + struct.pack("<QQ", 0, size)
                )
                hdr = b""
                while len(hdr) < 8:
                    part = s.recv(8 - len(hdr))
                    if not part:
                        return False
                    hdr += part
                (total,) = struct.unpack("<Q", hdr)
                if total == self._DATA_LOST:
                    raise ObjectLostError(
                        f"remote segment {path} vanished during transfer"
                    )
                if total != size:
                    return False  # truncated view: let the fallback decide
                from ray_tpu_torch import native as native_mod

                lib = native_mod.store_lib()
                if lib is not None:
                    import ctypes

                    cbuf = (ctypes.c_char * size).from_buffer(buf)
                    got = lib.rt_recv_full(
                        s.fileno(), ctypes.addressof(cbuf), size
                    )
                    del cbuf
                else:
                    view = memoryview(buf)
                    got = 0
                    while got < size:
                        n = s.recv_into(view[got:], size - got)
                        if n <= 0:
                            break
                        got += n
                return got == size
        except OSError:
            # broken stream or dead port: drop the cache entry so the next
            # pull re-discovers instead of re-dialing a corpse
            self._data_ports.pop(agent_address, None)
            return False

    def wait(
        self,
        refs: List[ObjectRef],
        num_returns: int = 1,
        timeout_s: Optional[float] = None,
        fetch_local: bool = True,
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        local = [r for r in refs if self.owns(r)]
        remote = [r for r in refs if not self.owns(r)]
        if not remote:
            # Fully event-driven: block on the memory store's condition —
            # an arriving object wakes the waiter immediately (reference
            # wait is likewise future-driven, core_worker.h:702; the
            # round-3 20 ms poll tick is gone).
            known = -1
            while True:
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                present = self.memory_store.wait_newly_present(
                    [r.id for r in local], known, remaining
                )
                present_set = set(present)
                ready = [r for r in local if r.id in present_set]
                if len(ready) >= num_returns or len(ready) == len(local):
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    break
                known = len(present)
            ready_set = set(ready)
            return ready, [r for r in refs if r not in ready_set]
        return self._wait_mixed(refs, num_returns, deadline)

    def _wait_mixed(self, refs, num_returns, deadline):
        """wait() over refs owned (partly) by other workers: one BLOCKING
        wait_objects RPC per owner (async, completion sets the event) plus
        a memory-store watcher for locally-owned arrivals — event-driven
        end to end, no poll tick."""
        evt = threading.Event()
        self.memory_store.add_watcher(evt)
        inflight: Dict[str, bool] = {}
        replies: Dict[str, set] = {}
        lost: set = set()
        try:
            while True:
                # clear BEFORE recomputing: a completion landing between
                # the scan and the wait must not be lost
                evt.clear()
                ready: List[ObjectRef] = []
                pending: List[ObjectRef] = []
                by_owner: Dict[str, List[ObjectRef]] = {}
                for r in refs:
                    if self.owns(r):
                        if self.memory_store.contains(r.id):
                            ready.append(r)
                        else:
                            pending.append(r)
                    elif r.id.hex() in replies.get(r.owner_address, ()):
                        ready.append(r)
                    elif r.owner_address in lost:
                        # owner unreachable: surfacing the error counts as
                        # ready (get() will raise OwnerDiedError)
                        ready.append(r)
                    else:
                        pending.append(r)
                        by_owner.setdefault(r.owner_address, []).append(r)
                if len(ready) >= num_returns or not pending:
                    return ready, pending
                if deadline is not None and time.monotonic() >= deadline:
                    return ready, pending
                remaining = (
                    30.0 if deadline is None
                    else min(30.0, max(0.05, deadline - time.monotonic()))
                )
                for owner, group in by_owner.items():
                    if inflight.get(owner):
                        continue
                    inflight[owner] = True
                    # the group holds only still-pending oids, none of
                    # which we know to be present — any arrival counts
                    known = 0

                    def _done(p, owner=owner):
                        inflight[owner] = False
                        try:
                            present = p.wait(0)
                            replies.setdefault(owner, set()).update(present)
                        except RpcConnectionError:
                            lost.add(owner)
                        except RpcError:
                            pass
                        evt.set()

                    try:
                        pend = self.workers.get(owner).call_async(
                            "wait_objects",
                            oid_hexes=[r.id.hex() for r in group],
                            known_present=known, wait_s=remaining,
                        )
                        pend.add_done_callback(_done)
                    except RpcConnectionError:
                        lost.add(owner)
                        inflight[owner] = False
                evt.wait(remaining)
        finally:
            self.memory_store.remove_watcher(evt)

    def rpc_wait_objects(
        self, conn, oid_hexes: List[str], known_present: int = -1,
        wait_s: float = 30.0,
    ):
        """Owner side of event-driven wait: block until more of the oids
        are present than the waiter already knows about."""
        oids = [ObjectID.from_hex(h) for h in oid_hexes]
        present = self.memory_store.wait_newly_present(
            oids, known_present, min(wait_s, 120.0)
        )
        return [o.hex() for o in present]

    def free(self, refs: List[ObjectRef]) -> None:
        for ref in refs:
            if self.owns(ref):
                self.delete_owned_object(ref.id)
            else:
                try:
                    self.workers.get(ref.owner_address).call_oneway(
                        "free_object", oid_hex=ref.id.hex()
                    )
                except RpcError:
                    pass

    def delete_owned_object(self, oid: ObjectID) -> None:
        # ref GC runs steadily even when large puts stop, so deferred
        # reclaims can't sit pinned for the worker's lifetime
        self._flush_pending_reclaim()
        stored = self.memory_store.try_get(oid)
        self.memory_store.delete(oid)
        self._drop_lineage_return(oid)
        if isinstance(stored, PlasmaValue):
            # Drop our cached mapping while the file still exists — a
            # mapping pinned past the unlink holds the (dead) pages for
            # the life of the process. try_drop refuses when live views
            # (arrays a get() returned) still reference it.
            local = (
                stored.agent_address == self.node_agent_address
                and not self._remote_driver
            )
            released = self.shm.try_drop(stored.path) if local else True
            try:
                if stored.private and local:
                    if released:
                        # never shared + no live local views: the
                        # segment's pages can be recycled into the next
                        # create. Rides self.agent — the SAME connection
                        # create_object uses — so the raw in-order
                        # handler parks the pages before our next create
                        # asks for them.
                        self.agent.call_oneway(
                            "recycle_object", oid_hex=oid.hex()
                        )
                    else:
                        # views still pin the mapping (the usual case in
                        # `get(put(x))`: the value outlives the ref by a
                        # beat) — defer; the next plasma put retries
                        self._defer_reclaim(oid, stored.path)
                else:
                    if local and not released:
                        # shared segment with live views: evict the cache
                        # entry now (GC closes it with the views) so the
                        # unlinked pages don't stay pinned forever
                        self.shm.drop(stored.path)
                    self.agents.get(stored.agent_address).call_oneway(
                        "delete_objects", oid_hexes=[oid.hex()]
                    )
            except RpcError:
                pass
        elif isinstance(stored, DeviceValue):
            if stored.worker_address == self.address:
                self.device_store.free(stored.obj_hex)
            else:
                try:
                    self.workers.get(stored.worker_address).call_oneway(
                        "free_device_object", obj_hex=stored.obj_hex
                    )
                except RpcError:
                    pass

    def send_add_borrow(
        self,
        owner_address: str,
        oid: ObjectID,
        register_token: Optional[str] = None,
        consume_token: Optional[str] = None,
    ) -> None:
        try:
            self.workers.get(owner_address).call_oneway(
                "add_borrow", oid_hex=oid.hex(),
                register_token=register_token, consume_token=consume_token,
            )
        except RpcError:
            pass

    def send_release_borrow(
        self, owner_address: str, oid: ObjectID, n: int = 1
    ) -> None:
        try:
            self.workers.get(owner_address).call_oneway(
                "release_borrow", oid_hex=oid.hex(), n=n
            )
        except RpcError:
            pass

    def _pack_task_args(self, payload, task_hex: str) -> bytes:
        """Pack task args, taking a pendency borrow on every ObjectRef
        serialized inside — held until the task reaches a terminal state
        (_release_arg_pins). Unlike the in-flight serialization pin
        (consumed by the first deserialization), the pendency borrow
        survives long lease-queue waits AND retries. Reference parity:
        borrow reports keep task-arg refs alive for the task's whole
        pendency (reference_counter.h:44)."""
        tr = self.reference_tracker
        tr.begin_capture()
        try:
            frame = serialization.pack(payload)
        finally:
            pins = tr.end_capture()
        if pins:
            self._arg_pins[task_hex] = pins
            for addr, oid, owned in pins:
                if owned:
                    tr.add_task_borrow(oid)
                else:
                    self.send_add_borrow(addr, oid)
        # big args frames ride push_task as a raw trailing wire segment
        # instead of being re-pickled in-band per hop
        return serialization.maybe_frame(frame)

    def _release_arg_pins(self, task_hex: str) -> None:
        """Task reached a terminal state: drop its args' pendency borrows."""
        pins = self._arg_pins.pop(task_hex, None)
        if not pins:
            return
        tr = self.reference_tracker
        for addr, oid, owned in pins:
            if owned:
                tr.owner_release_borrow(oid)
            else:
                self.send_release_borrow(addr, oid)

    # ------------------------------------------------------------------
    # normal task submission (reference normal_task_submitter.h:124)
    # ------------------------------------------------------------------

    def submit_task(self, fn_id, fn_name, args, kwargs, options: TaskOptions):
        task_id = self._next_task_id()
        if options.num_returns == -1:  # streaming generator
            from ray_tpu_torch.core.object_ref import ObjectRefGenerator

            refs = [ObjectRefGenerator(task_id, self)]
        else:
            refs = [
                ObjectRef(ObjectID.from_task(task_id, i), self.address)
                for i in range(options.num_returns)
            ]
        # Anything that can raise resolves BEFORE packing the args: packing
        # takes pendency borrows that only terminal task states release.
        strategy = self._resolve_strategy(options.scheduling_strategy)
        runtime_env = runtime_env_mod.prepare(options.runtime_env, self.control)
        spec = TaskSpec(
            task_id=task_id,
            fn_id=fn_id,
            fn_name=fn_name,
            args_frame=self._pack_task_args((args, kwargs), task_id.hex()),
            num_returns=options.num_returns,
            owner_address=self.address,
            resources=options.resource_demand(default_cpus=1.0),
            max_retries=(
                options.max_retries
                if options.max_retries is not None
                else config.task_max_retries
            ),
            retry_exceptions=options.retry_exceptions,
            name=options.name or fn_name,
            runtime_env=runtime_env,
            tensor_transport=options.tensor_transport or "object",
        )
        with self._lineage_lock:
            self._lineage[task_id.hex()] = [spec, strategy, options.num_returns]
            self._lineage_bytes += len(spec.args_frame)
            while len(self._lineage) > int(config.lineage_max_entries) or (
                self._lineage_bytes > int(config.lineage_max_bytes)
                and len(self._lineage) > 1
            ):
                _, dropped = self._lineage.popitem(last=False)
                self._lineage_bytes -= len(dropped[0].args_frame)
        if tracing.ENABLED:
            self._append_task_event(tracing.lifecycle_event(
                tracing.SUBMITTED, task_id.hex(), spec.name, self.address,
            ))
        pending_deps = self._pending_arg_deps(args, kwargs)
        if pending_deps:
            # The task must not compete for a worker lease until every
            # top-level ObjectRef arg is available — an executor blocking
            # on an upstream producer while HOLDING a leased CPU starves
            # the producers themselves (shuffle reduce-before-map
            # deadlock). Reference: local_dependency_resolver.h.
            self.dep_resolver.add(
                pending_deps,
                lambda: self._enqueue_normal_task(spec, strategy),
            )
        else:
            self._enqueue_normal_task(spec, strategy)
        return refs

    def _enqueue_normal_task(self, spec: TaskSpec, strategy) -> None:
        """Route a ready-to-run task to its scheduling key's submitter
        (lease cache). Keys split on anything that changes which worker
        may run the task: resource shape, placement strategy, runtime
        env (reference SchedulingKey, normal_task_submitter.h:52)."""
        key = (
            tuple(sorted(spec.resources.items())),
            repr(strategy),
            repr(spec.runtime_env),
        )
        while True:
            with self._task_submitters_lock:
                sub = self._task_submitters.get(key)
                if sub is None:
                    sub = _NormalTaskSubmitter(
                        self, spec.resources, strategy, spec.runtime_env
                    )
                    self._task_submitters[key] = sub
                    if self._submitter_janitor is None:
                        self._submitter_janitor = threading.Thread(
                            target=self._janitor_loop,
                            name="task-submit-janitor", daemon=True,
                        )
                        self._submitter_janitor.start()
            if sub.submit(spec):
                return
            # lost the race with the janitor's disposal sweep: drop the
            # dead entry and mint a fresh submitter
            with self._task_submitters_lock:
                if self._task_submitters.get(key) is sub:
                    del self._task_submitters[key]

    def _janitor_loop(self) -> None:
        """ONE maintenance thread for every scheduling key's submitter
        (a thread per key would leak: each PG strategy mints a key):
        stall scaling, idle-lease keepalive reaping, and disposal of
        long-empty submitters; releases all cached leases at shutdown."""
        while not self._shutdown.is_set():
            time.sleep(0.05)
            with self._task_submitters_lock:
                items = list(self._task_submitters.items())
            dead = [key for key, sub in items if sub.maintain_tick()]
            if dead:
                with self._task_submitters_lock:
                    for key in dead:
                        sub = self._task_submitters.get(key)
                        # try_dispose re-verifies emptiness under the
                        # submitter lock and marks it disposed, so a
                        # submit racing this sweep either lands before
                        # (keeps the submitter) or sees _disposed and
                        # re-registers a fresh one
                        if sub is not None and sub.try_dispose():
                            del self._task_submitters[key]
        with self._task_submitters_lock:
            subs = list(self._task_submitters.values())
        for sub in subs:
            sub.release_all()

    def _pending_arg_deps(self, args, kwargs) -> List[ObjectRef]:
        """Top-level ObjectRef args not yet known to be available (Ray
        semantics: only top-level refs are task dependencies; nested refs
        pass through un-awaited)."""
        deps = [a for a in args if isinstance(a, ObjectRef)]
        deps.extend(v for v in kwargs.values() if isinstance(v, ObjectRef))
        pending, seen = [], set()
        for r in deps:
            if r.id in seen:
                continue
            seen.add(r.id)
            if self.owns(r):
                if not self.memory_store.contains(r.id):
                    pending.append(r)
            else:
                pending.append(r)  # resolver confirms with the owner
        return pending

    @property
    def dep_resolver(self) -> "_DependencyResolver":
        with self._dep_resolver_lock:
            if self._dep_resolver is None:
                self._dep_resolver = _DependencyResolver(self)
            return self._dep_resolver

    def _drop_lineage_return(self, oid: ObjectID) -> None:
        """An owned object was deleted: its task's lineage entry loses a
        live return; at zero the entry (and its retained args) drops."""
        task_hex = oid.task_id().hex()
        with self._lineage_lock:
            entry = self._lineage.get(task_hex)
            if entry is None:
                return
            entry[2] -= 1
            if entry[2] <= 0:
                self._lineage.pop(task_hex, None)
                self._lineage_bytes -= len(entry[0].args_frame)

    def _object_really_lost(self, oid: ObjectID) -> bool:
        """Distinguish a dead segment from a transient blip: if the
        hosting agent still answers and holds the object, do NOT
        re-execute (a reconstruction over a live value would race the
        existing segment)."""
        stored = self.memory_store.try_get(oid)
        if isinstance(stored, DeviceValue):
            try:
                return not self.workers.get(stored.worker_address).call(
                    "device_object_contains", obj_hex=stored.obj_hex,
                    timeout_s=5.0,
                )
            except RpcError:
                return True  # holder unreachable: device payload is gone
        if not isinstance(stored, PlasmaValue):
            return not os_mod.is_missing(stored) and isinstance(
                stored, LostValue
            )
        try:
            return not self.agents.get(stored.agent_address).call(
                "object_contains", oid_hex=oid.hex(), timeout_s=5.0,
            )
        except RpcError:
            return True  # agent unreachable: treat as lost

    def reconstruct_object(self, oid: ObjectID) -> bool:
        """Re-execute the task that created oid (lineage reconstruction,
        reference object_recovery_manager.h:26). Single-flight per task;
        returns True if the value is available again (either a
        re-execution ran, one was joined, or the loss turned out to be a
        transient failure and the value is intact)."""
        task_hex = oid.task_id().hex()
        with self._lineage_lock:
            entry = self._lineage.get(task_hex)
            if entry is None:
                return False
            event = self._reconstructing.get(task_hex)
            if event is None:
                event = threading.Event()
                self._reconstructing[task_hex] = event
                leader = True
            else:
                leader = False
        if not leader:
            event.wait(timeout=600.0)
            return True
        try:
            if not self._object_really_lost(oid):
                return True
            spec, strategy = entry[0], entry[1]
            logger.warning(
                "reconstructing lost object %s by re-executing task %s",
                oid.hex()[:16], spec.name,
            )
            self._submit_normal_task(spec, strategy)
            return True
        finally:
            event.set()
            with self._lineage_lock:
                self._reconstructing.pop(task_hex, None)

    def rpc_reconstruct_object(self, conn, oid_hex: str):
        """Borrower-triggered reconstruction: a remote reader failed to
        pull our object's segment (hosting node died)."""
        return self.reconstruct_object(ObjectID.from_hex(oid_hex))

    def _resolve_strategy(self, strategy):
        """Convert API strategy objects into the wire dict form."""
        from ray_tpu_torch.core.placement import PlacementGroupSchedulingStrategy
        from ray_tpu_torch.core.api import NodeAffinitySchedulingStrategy

        if strategy is None or strategy == "DEFAULT":
            return None
        if isinstance(strategy, str):
            return strategy
        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            return {
                "type": "placement_group",
                "pg_id": strategy.placement_group.id_hex,
                "bundle_index": strategy.placement_group_bundle_index,
            }
        if isinstance(strategy, NodeAffinitySchedulingStrategy):
            return {
                "type": "node_affinity",
                "node_id": strategy.node_id,
                "soft": strategy.soft,
            }
        if isinstance(strategy, dict):
            return strategy
        raise TypeError(f"unsupported scheduling strategy {strategy!r}")

    def _submit_normal_task(self, spec: TaskSpec, strategy) -> None:
        attempts = spec.max_retries + 1
        last_error: Optional[Exception] = None
        for attempt in range(attempts):
            if spec.task_id.hex() in self._cancelled_tasks:
                err = TaskCancelledError(f"task {spec.name} was cancelled")
                self._store_error_returns(spec, err)
                return
            try:
                self._run_task_on_lease(spec, strategy)
                return
            except (RpcConnectionError, RpcTimeout, WorkerCrashedError) as e:
                last_error = e
                logger.warning(
                    "task %s attempt %d/%d failed: %s",
                    spec.name, attempt + 1, attempts, e,
                )
                if isinstance(e, RpcConnectionError):
                    # The failure may be our own node agent dying (a driver
                    # outlives its node, unlike workers): re-attach to a
                    # surviving agent before retrying.
                    self._maybe_reattach_agent()
                continue
            except TaskError as e:
                last_error = e
                if spec.retry_exceptions and attempt + 1 < attempts:
                    continue
                break
            except Exception as e:  # noqa: BLE001 — store scheduling errors
                last_error = e
                break
        err = last_error
        if not isinstance(err, TaskError):
            err = TaskError(
                f"task {spec.name} failed after {attempts} attempts: {last_error}",
            )
        self._store_error_returns(spec, err)

    def _maybe_reattach_agent(self) -> None:
        """Driver-only: if our node agent is unreachable, re-attach to a
        surviving alive node (reference parity gap P14: the remote driver
        must not die with the node it happened to pick at init)."""
        if self.mode != "driver":
            return
        with self._reattach_lock:
            try:
                self.agent.call("store_usage", timeout_s=3.0)
                return  # agent alive; failure was elsewhere
            except RpcConnectionError:
                pass
            except RpcError:
                return  # slow, not dead
            try:
                view = self.control.call("get_cluster_view", timeout_s=10.0)
            except RpcError:
                return
            for nid, node in view.items():
                addr = node["address"]
                if addr == self.node_agent_address:
                    continue
                probe = RpcClient(addr, name="driver->agent")
                try:
                    probe.call("store_usage", timeout_s=3.0)
                except RpcError:
                    probe.close()
                    continue
                logger.warning(
                    "driver re-attaching from dead agent %s to %s",
                    self.node_agent_address, addr,
                )
                old = self.agent
                self.agent = probe
                self.node_agent_address = addr
                self.node_id_hex = nid
                try:
                    old.close()
                except Exception:  # noqa: BLE001
                    pass
                return

    def _run_task_on_lease(self, spec: TaskSpec, strategy) -> None:
        bundle = None
        if isinstance(strategy, dict) and strategy.get("type") == "placement_group":
            bundle = (strategy["pg_id"], strategy.get("bundle_index"))
        agent = self.agent
        hops = 0
        while True:
            lease = agent.call(
                "lease_worker",
                resources=spec.resources,
                bundle=bundle,
                strategy=strategy,
                wait_s=30.0,
                timeout_s=45.0,
                runtime_env=spec.runtime_env,
            )
            if lease.get("granted"):
                break
            spill = lease.get("spillback")
            if spill:
                hops += 1
                if hops > 16:
                    raise TaskError(f"task {spec.name}: too many spillback hops")
                agent = self.agents.get(spill)
                continue
            if lease.get("error") == "lease timeout":
                # Stay queued (reference behavior: leases wait). The agent
                # answers instantly for pending PGs, so back off briefly to
                # avoid hammering it and the control store in a tight loop.
                time.sleep(0.2)
                continue
            raise TaskError(
                f"task {spec.name} unschedulable: {lease.get('error')} "
                f"(resources={spec.resources})"
            )
        worker_addr = lease["worker_address"]
        lease_id = lease["lease_id"]
        if spec.task_id.hex() in self._cancelled_tasks:
            # cancelled while waiting for the lease
            try:
                agent.call_oneway("release_worker", lease_id=lease_id, kill=False)
            except RpcError:
                pass
            err = TaskCancelledError(f"task {spec.name} was cancelled")
            self._store_error_returns(spec, err)
            return
        kill = False
        self._inflight_push[spec.task_id.hex()] = worker_addr
        try:
            client = self.workers.get(worker_addr)
            # Task duration is unbounded: effectively no RPC timeout here;
            # worker death is detected by connection loss instead.
            reply = client.call("push_task", spec=spec, timeout_s=86400.0 * 30)
            self._store_task_reply(spec, reply)
        except (RpcConnectionError, RpcTimeout):
            if spec.tensor_transport == "device":
                # The executor may have finished and parked device-resident
                # returns before the reply was lost; a retry lands on a new
                # worker, so free any HBM the (possibly still-alive) first
                # executor pinned for this task. Best-effort on the
                # EXISTING connection only — reconnecting to a dead worker
                # would stall the retry path for rpc_connect_timeout_s.
                try:
                    c = self.workers.get(worker_addr)
                    if c._sock is not None:
                        for i in range(max(spec.num_returns, 0)):
                            c.call_oneway(
                                "free_device_object",
                                obj_hex=ObjectID.from_task(
                                    spec.task_id, i
                                ).hex(),
                            )
                except RpcError:
                    pass
            self.workers.drop(worker_addr)
            kill = True
            raise WorkerCrashedError(
                f"worker {worker_addr} died while executing {spec.name}"
            ) from None
        finally:
            self._inflight_push.pop(spec.task_id.hex(), None)
            try:
                agent.call_oneway("release_worker", lease_id=lease_id, kill=kill)
            except RpcError:
                pass

    def _stream_done_oid(self, task_id: TaskID) -> ObjectID:
        return ObjectID.from_task(task_id, self._STREAM_DONE_INDEX)

    def _drop_stale_stream_items(self, spec: TaskSpec, count: int) -> None:
        """A retried streaming task can leave items from a longer failed
        attempt at indices >= the final count; the generator (correctly)
        never yields them, so free them here lest they leak. Items are
        pushed in order, so stale ones sit contiguously from `count`."""
        idx = count
        while idx < count + 100000:  # safety bound
            oid = ObjectID.from_task(spec.task_id, idx)
            stored = self.memory_store.try_get(oid)
            if os_mod.is_missing(stored):
                break
            self.memory_store.delete(oid)
            if isinstance(stored, PlasmaValue):
                try:
                    self.agents.get(stored.agent_address).call_oneway(
                        "delete_objects", oid_hexes=[oid.hex()]
                    )
                except RpcError:
                    pass
            idx += 1

    def _store_error_returns(self, spec: TaskSpec, err: Exception) -> None:
        """Fail every return slot. Streaming tasks (num_returns == -1)
        have no fixed slots: the error lands in the done-marker, which the
        ObjectRefGenerator raises when it reaches it."""
        self._release_arg_pins(spec.task_id.hex())
        if spec.num_returns == -1:
            self.memory_store.put(self._stream_done_oid(spec.task_id), err)
            return
        for i in range(spec.num_returns):
            self.memory_store.put(ObjectID.from_task(spec.task_id, i), err)

    def rpc_stream_item(self, conn, task_id_hex: str, index: int, payload):
        """Owner side: one streamed generator item landed (in-order
        oneway pushes from the executor)."""
        oid = ObjectID.from_task(TaskID.from_hex(task_id_hex), index)
        kind, data = payload
        if kind == "frame":
            self.memory_store.put(oid, data)
        else:
            path, size, agent_addr = data
            self.memory_store.put(oid, PlasmaValue(path, size, agent_addr))
        return True

    def _store_task_reply(self, spec: TaskSpec, reply: Dict[str, Any]) -> None:
        if reply.get("status") == "interrupted":
            # a stray cancel interrupt hit this (innocent) task: surface
            # it in the type each retry ladder classifies as retryable
            # (the lease-cache path also special-cases it pre-store)
            if spec.actor_id is not None:
                raise ActorUnavailableError(
                    f"actor task {spec.name} caught a stray cancel "
                    "interrupt"
                )
            raise WorkerCrashedError(
                f"task {spec.name} caught a stray cancel interrupt"
            )
        if reply["status"] != "error" or not spec.retry_exceptions:
            # terminal (the retry_exceptions error path re-raises to the
            # retry loop: the task is still pending, so its args keep
            # their pendency borrows for the next attempt)
            self._release_arg_pins(spec.task_id.hex())
        if reply["status"] == "ok" and spec.num_returns == -1:
            # streaming: items arrived via rpc_stream_item pushes (possibly
            # still in flight on another connection — the generator waits
            # for item i even after seeing the count); store the count
            count = reply["returns"][0][1]
            self.memory_store.put(self._stream_done_oid(spec.task_id), count)
            self._drop_stale_stream_items(spec, int(count))
            return
        if reply["status"] == "ok":
            for oid_hex, (kind, payload) in reply["returns"]:
                oid = ObjectID.from_hex(oid_hex)
                if kind == "frame":
                    self.memory_store.put(oid, payload)
                elif kind == "plasma":
                    path, size, agent_addr = payload
                    self.memory_store.put(oid, PlasmaValue(path, size, agent_addr))
                elif kind == "device":
                    addr, skeleton, leaves_meta = payload
                    self.memory_store.put(
                        oid, DeviceValue(addr, oid_hex, skeleton, leaves_meta)
                    )
                if self.reference_tracker.maybe_delete_unreferenced(oid):
                    # every ref (and borrow) died while the task was running
                    self.delete_owned_object(oid)
        elif reply["status"] == "cancelled":
            err = TaskCancelledError(f"task {spec.name} was cancelled")
            self._store_error_returns(spec, err)
        else:
            error: TaskError = reply["error"]
            if spec.retry_exceptions:
                raise error
            self._store_error_returns(spec, error)

    # ------------------------------------------------------------------
    # actor submission (reference actor_task_submitter.h)
    # ------------------------------------------------------------------

    def create_actor(self, class_id, class_blob, class_name, init_args, init_kwargs,
                     actor_options) -> str:
        actor_id = ActorID.of(self.current_job_id()).hex()
        self.register_function(class_id, class_blob, class_name)
        # resolve fallible inputs before packing (packing takes pendency
        # borrows that need a terminal event to release)
        strategy = self._resolve_strategy(
            actor_options.get("scheduling_strategy")
        )
        runtime_env = runtime_env_mod.prepare(
            actor_options.get("runtime_env"), self.control
        )
        spec = {
            "actor_id": actor_id,
            "job_id": self.current_job_id().hex(),
            "class_id": class_id,
            "class_name": class_name,
            # actor-creation args can wait arbitrarily long in PG queues;
            # the pendency borrows are released when the creator first
            # observes the actor ALIVE or DEAD (_resolve_actor_address) —
            # an actor the creator never interacts with keeps them until
            # process exit, which is the semantics of holding the handle
            "init_args_frame": self._pack_task_args(
                (init_args, init_kwargs), f"actor_init_{actor_id}"
            ),
            "resources": actor_options.get("resources", {}),
            "name": actor_options.get("name"),
            "namespace": actor_options.get("namespace", "default"),
            "lifetime": actor_options.get("lifetime"),
            "max_restarts": actor_options.get("max_restarts", 0),
            "max_task_retries": actor_options.get("max_task_retries", 0),
            "max_concurrency": actor_options.get("max_concurrency", 1),
            "concurrency_groups": actor_options.get("concurrency_groups"),
            "method_groups": actor_options.get("method_groups"),
            "method_names": actor_options.get("method_names", []),
            "scheduling_strategy": strategy,
            "runtime_env": runtime_env,
            "owner_address": self.address,
        }
        if int(spec["max_restarts"] or 0) != 0:
            # a restart re-deserializes init_args_frame: the pendency
            # borrows must survive until the actor is PERMANENTLY dead
            self._restartable_actor_inits.add(actor_id)
        try:
            batcher = self._actor_batcher()
            if batcher is not None:
                batcher.enqueue_register(spec)
                if spec.get("name"):
                    # named creation keeps synchronous semantics: a name
                    # conflict must raise HERE, not at first use
                    batcher.wait_registered(actor_id)
            else:
                self.control.call("register_actor", spec=spec, retryable=True)
        except BaseException:
            self._restartable_actor_inits.discard(actor_id)
            self._release_arg_pins(f"actor_init_{actor_id}")
            raise
        return actor_id

    def _actor_batcher(self) -> Optional["_ActorLifecycleBatcher"]:
        """The lifecycle batcher, or None when batching is off
        (actor_batch_flush_ms=0 — the legacy one-RPC-per-actor path)."""
        if float(config.actor_batch_flush_ms) <= 0:
            return None
        b = self._lifecycle_batcher
        if b is None:
            with self._lifecycle_batcher_lock:
                b = self._lifecycle_batcher
                if b is None:
                    b = self._lifecycle_batcher = _ActorLifecycleBatcher(self)
        return b

    def _await_actor_registered(self, actor_id: str,
                                timeout_s: float = 60.0) -> None:
        """Surface a batched registration's per-record error (no-op for
        ids registered synchronously or long since flushed)."""
        b = self._lifecycle_batcher
        if b is None:
            return
        try:
            b.wait_registered(actor_id, timeout_s)
        except BaseException:
            self._restartable_actor_inits.discard(actor_id)
            self._release_arg_pins(f"actor_init_{actor_id}")
            raise

    def _actor_sender(self, actor_id: str) -> "_ActorSender":
        with self._actor_senders_lock:
            sender = self._actor_senders.get(actor_id)
            if sender is None:
                sender = _ActorSender(self, actor_id)
                self._actor_senders[actor_id] = sender
        return sender

    def _resolve_actor_address(self, actor_id: str, timeout_s: float = 60.0) -> str:
        """Block until the actor is ALIVE, up to timeout_s total (pending
        creation / restart / resource queuing can legitimately take long —
        reference callers block on the GCS actor table the same way, but
        the timeout bounds the WHOLE wait, not each control-store call)."""
        if actor_id in self._locally_killed:
            # killed from this process: the kill may still be riding the
            # lifecycle batch, but its outcome is already decided
            raise ActorDiedError(f"actor {actor_id} was killed")
        addr = self._actor_addr_cache.get(actor_id)
        if addr:
            return addr
        self._await_actor_registered(actor_id, timeout_s=timeout_s)
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = max(0.05, deadline - time.monotonic())
            info = self.control.call(
                "wait_actor_alive", actor_id=actor_id, wait_s=remaining,
                timeout_s=remaining + 30.0, retryable=True,
            )
            if info is None:
                self._restartable_actor_inits.discard(actor_id)
                self._release_arg_pins(f"actor_init_{actor_id}")
                raise ActorDiedError(f"actor {actor_id} does not exist")
            if info["state"] == "DEAD":
                self._restartable_actor_inits.discard(actor_id)
                self._release_arg_pins(f"actor_init_{actor_id}")
                raise ActorDiedError(
                    f"actor {actor_id} is dead: {info.get('death_cause')}"
                )
            if info["state"] == "ALIVE" and info.get("worker_address"):
                self._actor_addr_cache[actor_id] = info["worker_address"]
                if actor_id not in self._restartable_actor_inits:
                    # creation args were consumed by the actor start and a
                    # non-restartable actor never re-reads them
                    self._release_arg_pins(f"actor_init_{actor_id}")
                return info["worker_address"]
            if self._shutdown.is_set() or time.monotonic() >= deadline:
                raise ActorUnavailableError(f"actor {actor_id} is {info['state']}")
            time.sleep(0.05)

    def _actor_max_task_retries(self, actor_id: str) -> int:
        n = self._actor_retry_cache.get(actor_id)
        if n is not None:
            return n
        try:
            # a batched registration may still be in flight; get_actor_info
            # on an unknown actor would silently report 0 retries
            self._await_actor_registered(actor_id, timeout_s=30.0)
        except Exception:  # noqa: BLE001 — submission surfaces the error
            pass
        try:
            info = self.control.call("get_actor_info", actor_id=actor_id)
            n = int((info or {}).get("max_task_retries") or 0)
        except RpcError:
            n = 0
        self._actor_retry_cache[actor_id] = n
        return n

    def submit_actor_task(self, actor_id: str, method_name: str, args, kwargs,
                          num_returns: int = 1,
                          tensor_transport: str = "object") -> List[ObjectRef]:
        task_id = TaskID.for_actor_task(ActorID.from_hex(actor_id))
        if num_returns == -1:  # streaming actor method (generator)
            from ray_tpu_torch.core.object_ref import ObjectRefGenerator

            refs: List[Any] = [ObjectRefGenerator(task_id, self)]
        else:
            refs = [
                ObjectRef(ObjectID.from_task(task_id, i), self.address)
                for i in range(num_returns)
            ]
        spec = TaskSpec(
            task_id=task_id,
            fn_id="",
            fn_name=method_name,
            args_frame=self._pack_task_args((args, kwargs), task_id.hex()),
            num_returns=num_returns,
            owner_address=self.address,
            resources={},
            # opt-in at-least-once for actor methods (reference
            # task_manager.h max_task_retries): connection-loss failures
            # are re-submitted to the restarted actor up to this many times
            max_retries=self._actor_max_task_retries(actor_id),
            actor_id=actor_id,
            method_name=method_name,
            name=f"{actor_id[:8]}.{method_name}",
            tensor_transport=tensor_transport,
        )
        if tracing.ENABLED:
            self._append_task_event(tracing.lifecycle_event(
                tracing.SUBMITTED, task_id.hex(), spec.name, self.address,
            ))
        pending_deps = self._pending_arg_deps(args, kwargs)
        if pending_deps:
            # awaited by the sender thread just before the send — ordered
            # per-caller, so later calls queue behind as Ray's sequence
            # numbers would
            self._pending_task_deps[task_id.hex()] = pending_deps
        self._actor_sender(actor_id).submit(spec)
        return refs

    def _store_actor_task_failure(self, spec: TaskSpec, e: Exception) -> None:
        self._release_arg_pins(spec.task_id.hex())
        if not isinstance(e, (TaskError, ActorDiedError, ActorUnavailableError)):
            e = TaskError(f"actor task {spec.name} failed: {e}", traceback.format_exc())
        if spec.num_returns == -1:
            # streaming: the error marker rides the done-slot, raised by
            # the ObjectRefGenerator after the produced prefix is consumed
            self.memory_store.put(self._stream_done_oid(spec.task_id), e)
            return
        for i in range(spec.num_returns):
            self.memory_store.put(ObjectID.from_task(spec.task_id, i), e)

    def _actor_connection_lost(self, spec: TaskSpec) -> Exception:
        """Classify a connection loss for an in-flight actor task.

        At-most-once semantics (reference default max_task_retries=0): the
        task may or may not have executed, so it is NEVER silently resent —
        the caller gets ActorDiedError (permanent) or ActorUnavailableError
        (actor restarting; new calls will reach the restarted actor)."""
        self._actor_addr_cache.pop(spec.actor_id, None)
        try:
            info = self.control.call(
                "get_actor_info", actor_id=spec.actor_id, retryable=True
            )
        except RpcError:
            info = None
        if info is None or info["state"] == "DEAD":
            self._restartable_actor_inits.discard(spec.actor_id)
            self._release_arg_pins(f"actor_init_{spec.actor_id}")
            return ActorDiedError(
                f"actor {spec.actor_id[:8]} died: "
                f"{info.get('death_cause') if info else 'unknown'}"
            )
        return ActorUnavailableError(
            f"actor {spec.actor_id[:8]} is {info['state']}; in-flight call "
            f"{spec.name} failed (not retried: at-most-once semantics)"
        )

    def kill_actor(self, actor_id: str, no_restart: bool = True) -> None:
        if no_restart:
            # record BEFORE the (possibly batched) RPC: a submit racing
            # the flush must observe the kill deterministically
            self._locally_killed.add(actor_id)
        batcher = self._actor_batcher()
        if batcher is not None:
            batcher.enqueue_kill(actor_id, no_restart)
        else:
            self.control.call(
                "kill_actor", actor_id=actor_id, no_restart=no_restart
            )
        self._actor_addr_cache.pop(actor_id, None)
        if no_restart:
            self._restartable_actor_inits.discard(actor_id)
            self._release_arg_pins(f"actor_init_{actor_id}")

    def drop_actor_handle(self, actor_id: str) -> None:
        """Owner handle GC. Routed through the lifecycle batcher so a
        drop can never overtake its actor's still-queued registration at
        the store (an unknown-actor drop is a silent no-op — the actor
        would register right after and leak)."""
        batcher = self._actor_batcher()
        if batcher is not None:
            batcher.enqueue_drop(actor_id)
        else:
            self.control.call_oneway(
                "actor_handle_dropped", actor_id=actor_id
            )

    def cancel_task(self, ref: ObjectRef, force: bool = False) -> None:
        """Cancel (reference core_worker.h Cancel): tasks not yet
        dispatched are dropped owner-side; tasks already pushed get a
        cancel RPC. A RUNNING task is interrupted executor-side:
        force=False raises KeyboardInterrupt in its thread (the
        reference's non-force semantics), force=True kills the executing
        worker process outright (a task stuck in C code or refusing the
        interrupt still dies; the owner's retry ladder sees the
        cancellation and stores TaskCancelledError instead of retrying)."""
        task_hex = ref.task_id().hex()
        self._cancelled_tasks.add(task_hex)
        worker_addr = self._inflight_push.get(task_hex)
        if worker_addr:
            try:
                self.workers.get(worker_addr).call_oneway(
                    "cancel_task", task_id_hex=task_hex, force=force
                )
            except RpcError:
                pass

    # ------------------------------------------------------------------
    # execution side: worker service RPCs
    # ------------------------------------------------------------------

    def rpc_push_task(self, conn, spec: TaskSpec):
        return self._execute_spec(spec)

    def rpc_push_tasks(self, conn, specs: List[TaskSpec]):
        """Batched normal-task push: the owner coalesces queued short
        tasks bound for one leased worker into a single RPC, amortizing
        the ~100us frame roundtrip across the batch (the lease cache only
        batches when the measured service latency is sub-5ms, so a slow
        task never delays unrelated replies)."""
        return [self._execute_spec(s) for s in specs]

    def _raw_actor_task(self, conn, req_id, args, kwargs) -> None:
        spec: TaskSpec = kwargs.get("spec") or args[0]
        rt = self._actor_runtime
        if rt is None:
            RpcServer.reply(
                conn, req_id, False,
                RemoteError("this worker hosts no actor", ""),
            )
            return
        rt.queue_for(spec.method_name).put((conn, req_id, spec))

    def _actor_loop(self, q: "queue.Queue") -> None:
        rt = self._actor_runtime
        while not self._shutdown.is_set():
            try:
                conn, req_id, spec = q.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                if rt.is_async:
                    # Async actor (any `async def` method makes the WHOLE
                    # actor async, like the reference): every method runs
                    # on the one event loop — coroutines overlap at
                    # awaits, sync methods run to completion on the loop
                    # thread — so actor state is single-threaded and
                    # scheduling order follows submission order. The
                    # executor thread frees immediately; the reply is sent
                    # from a pool thread on completion.
                    self._execute_async_actor_task(conn, req_id, spec)
                    continue
                incremented = False
                try:
                    with rt.running_lock:
                        rt.running += 1
                        incremented = True
                    reply = self._execute_spec(spec)
                except KeyboardInterrupt:
                    # stray cancel interrupt delivered outside
                    # _execute_spec's try block: this persistent executor
                    # thread must survive
                    reply = {"status": "interrupted"}
                finally:
                    if incremented:
                        with rt.running_lock:
                            rt.running -= 1
                try:
                    RpcServer.reply(conn, req_id, True, reply)
                except KeyboardInterrupt:
                    # mid-send interrupt may have written a partial frame:
                    # resending would desync the multiplexed stream — drop
                    # the connection instead (the caller's conn-loss path
                    # classifies and retries)
                    conn.alive = False
                    try:
                        conn.sock.close()
                    except OSError:
                        pass
            except KeyboardInterrupt:
                # stray interrupt outside the guarded regions: a just-
                # dequeued item or a computed-but-unsent reply may be
                # lost, so DROP the connection — the caller's conn-loss
                # path retries per its policy instead of hanging forever
                # — and keep this persistent thread alive
                try:
                    conn.alive = False
                    conn.sock.close()
                except (OSError, NameError, AttributeError):
                    pass  # interrupt landed before a conn was dequeued
                continue

    def _execute_async_actor_task(self, conn, req_id, spec: TaskSpec) -> None:
        import asyncio
        import inspect

        rt = self._actor_runtime
        _t0 = time.time()
        try:
            target = getattr(rt.instance, spec.method_name)
            args, kwargs = serialization.unpack(spec.args_frame)
            args = [self._resolve_arg(a) for a in args]
            kwargs = {k: self._resolve_arg(v) for k, v in kwargs.items()}
            if inspect.iscoroutinefunction(target):
                coro = target(*args, **kwargs)
            else:
                async def _sync_on_loop(t=target, a=args, kw=kwargs):
                    return t(*a, **kw)

                coro = _sync_on_loop()
        except Exception as e:  # noqa: BLE001
            RpcServer.reply(conn, req_id, True, {
                "status": "error",
                "error": TaskError(
                    f"{type(e).__name__}: {e}", traceback.format_exc(),
                    cause=e,
                ),
            })
            return
        with rt.running_lock:
            rt.running += 1
        fut = asyncio.run_coroutine_threadsafe(coro, rt.ensure_loop())

        def _finish(f):
            with rt.running_lock:
                rt.running -= 1
            try:
                result = f.result()
                reply = {
                    "status": "ok",
                    "returns": self._package_returns(spec, result),
                }
            except Exception as e:  # noqa: BLE001
                reply = {
                    "status": "error",
                    "error": TaskError(
                        f"{type(e).__name__}: {e}", traceback.format_exc(),
                        cause=e,
                    ),
                }
            if tracing.ENABLED:
                self._append_task_event({
                    "name": spec.name or spec.method_name,
                    "task_id": spec.task_id.hex(),
                    "actor_id": spec.actor_id,
                    "ts_us": int(_t0 * 1e6),
                    "dur_us": int((time.time() - _t0) * 1e6),
                    "worker": self.address,
                    "pid": os.getpid(),
                })
            RpcServer.reply(conn, req_id, True, reply)

        # the reply path serializes results and makes plasma RPCs — hand
        # it to a pool thread so the event loop never blocks on it
        fut.add_done_callback(
            lambda f: self._submit_pool.submit(_finish, f)
        )

    def rpc_actor_direct_call(self, conn, target: str, args=(), kwargs=None):
        """Latency-optimized call into the hosted actor instance for the
        serve data plane: the proxy invokes the replica's request method
        DIRECTLY on this server's cached dispatcher thread — no TaskSpec,
        no return-object registration, no executor-queue hop, no owner-
        side memory-store put. Replies ride the same multi-segment frames
        as every RPC, so a wrapped (serialization.Frame) response body
        ≥32 KiB travels as a raw out-of-band segment.

        The actor's max_concurrency bound still applies: direct calls
        gate on rt.direct_sem (same limit as the executor pool), so a
        max_concurrency=1 deployment's callable never runs concurrently
        on this path either — excess direct calls block their dispatcher
        thread until a slot frees. Only methods designed for direct
        dispatch (serve replicas' handle_request_direct, which do their
        own ongoing accounting) should be targeted. The in-flight count
        still reflects in actor_queue_stats via rt.running so the pow-2
        router and the autoscaler keep seeing direct load.

        Returns ("ok", result) or ("no_actor", reason) — the marker, not
        an error, so the router can fall back to the ordinary actor-task
        path without burning its retry ladder."""
        rt = self._actor_runtime
        if rt is None:
            return ("no_actor", "this worker hosts no actor")
        fn = getattr(rt.instance, target, None)
        if fn is None:
            return ("no_actor", f"actor has no method {target!r}")
        with rt.direct_sem:  # the actor's max_concurrency bound
            with rt.running_lock:
                rt.running += 1
            try:
                return ("ok", fn(*args, **(kwargs or {})))
            finally:
                with rt.running_lock:
                    rt.running -= 1

    def rpc_actor_queue_stats(self, conn):
        """Queue depth + in-flight count for the hosted actor, served by
        the RPC layer (NOT the actor's execution queue) so probes answer
        instantly even when every actor thread is busy — the reference
        replica's out-of-band queue-length probe."""
        rt = self._actor_runtime
        if rt is None:
            return None
        with rt.running_lock:
            running = rt.running
        out = {"queued": rt.total_queued(), "running": running}
        # serve model multiplexing: piggyback the replica's loaded model
        # ids on the out-of-band probe (no extra RPC, and no import cost
        # unless the process actually uses @serve.multiplexed)
        import sys as _sys

        mux = _sys.modules.get("ray_tpu_torch.serve.multiplex")
        if mux is not None:
            try:
                out["multiplexed_model_ids"] = mux.loaded_model_ids()
            except Exception:  # noqa: BLE001 — stats must never fail
                pass
        return out

    def rpc_create_actor(self, conn, spec: Dict[str, Any]):
        """Returns {"ok": True} or {"ok": False, "error": TaskError}.

        Application-level __init__ failures travel as data, NOT as RPC
        errors — the control store must distinguish "constructor raised"
        (actor is DEAD, tell the user why) from "transport failed" (retry
        on another worker)."""
        try:
            # Actor runtime env applies for the worker's whole life — the
            # process is dedicated to this actor (reference: worker-pool
            # processes are keyed by runtime-env hash).
            runtime_env_mod.apply_permanent(
                spec.get("runtime_env"), self.control
            )
            cls = self.load_function(spec["class_id"])
            args, kwargs = serialization.unpack(spec["init_args_frame"])
            args = [self._resolve_arg(a) for a in args]
            kwargs = {k: self._resolve_arg(v) for k, v in kwargs.items()}
            self._current_ctx.job_id = JobID.from_hex(spec["job_id"])
            instance = cls(*args, **kwargs)
        except Exception as e:  # noqa: BLE001
            return {
                "ok": False,
                "error": TaskError(
                    f"actor {spec['class_name']}.__init__ failed: {e}",
                    traceback.format_exc(),
                ),
            }
        rt = _ActorRuntime(
            spec["actor_id"], instance, int(spec.get("max_concurrency", 1)),
            concurrency_groups=spec.get("concurrency_groups"),
            method_groups=spec.get("method_groups"),
        )
        self._actor_runtime = rt
        for i in range(rt.max_concurrency):
            t = threading.Thread(
                target=self._actor_loop, args=(rt.queue,),
                name=f"actor-exec-{i}", daemon=True,
            )
            t.start()
            rt.threads.append(t)
        for group, limit in rt.group_limits.items():
            for i in range(max(1, int(limit))):
                t = threading.Thread(
                    target=self._actor_loop, args=(rt.group_queues[group],),
                    name=f"actor-{group}-{i}", daemon=True,
                )
                t.start()
                rt.threads.append(t)
        return {"ok": True}

    def _execute_spec(self, spec: TaskSpec) -> Dict[str, Any]:
        if spec.task_id.hex() in self._cancelled_tasks:
            return {"status": "cancelled"}
        self._current_ctx.task_id = spec.task_id
        self._current_ctx.job_id = spec.task_id.job_id()
        self._running_tasks[spec.task_id.hex()] = {
            "name": spec.name, "tid": threading.get_ident(),
            "t0": time.monotonic(),
        }
        _t0 = time.time()
        try:
            if spec.actor_id is not None:
                rt = self._actor_runtime
                if spec.method_name == "__rt_dag_exec_loop__":
                    # compiled-graph exec loop (ray_tpu_torch/dag.py): a system
                    # task that parks on this actor until DAG teardown
                    import functools

                    from ray_tpu_torch import dag as dag_mod

                    target = functools.partial(
                        dag_mod._actor_exec_loop, rt.instance
                    )
                elif spec.method_name == "__rt_pipe_exec_loop__":
                    # compiled-pipeline stage loop (parallel/pipeline.py):
                    # parks on this stage actor until pipeline teardown
                    import functools

                    from ray_tpu_torch.parallel import pipeline as pipeline_mod

                    target = functools.partial(
                        pipeline_mod._stage_exec_loop, rt.instance
                    )
                else:
                    target = getattr(rt.instance, spec.method_name, None)
                if target is None:
                    raise AttributeError(
                        f"actor has no method {spec.method_name!r}"
                    )
            else:
                target = self.load_function(spec.fn_id)
            args, kwargs = serialization.unpack(spec.args_frame)
            args = [self._resolve_arg(a) for a in args]
            kwargs = {k: self._resolve_arg(v) for k, v in kwargs.items()}
            if spec.runtime_env and spec.runtime_env == getattr(
                self, "boot_env_spec", None
            ):
                # env-keyed pool hit: this worker BOOTED inside the env
                # (worker_main applied it permanently) — skip per-task
                # setup entirely (reference: env-hash worker binning)
                result = target(*args, **kwargs)
            else:
                with runtime_env_mod.apply(spec.runtime_env, self.control):
                    result = target(*args, **kwargs)
            returns = self._package_returns(spec, result)
            return {"status": "ok", "returns": returns}
        except KeyboardInterrupt:
            if spec.task_id.hex() in self._cancelled_tasks:
                return {"status": "cancelled"}
            # a cancel aimed at a task that finished in the delivery
            # window landed here instead: this task is innocent — report
            # "interrupted" so the owner retries it rather than failing
            return {"status": "interrupted"}
        except TaskError as e:
            return {"status": "error", "error": e}
        except Exception as e:  # noqa: BLE001 — forwarded to the owner
            return {
                "status": "error",
                "error": TaskError(
                    f"{type(e).__name__}: {e}", traceback.format_exc(), cause=e
                ),
            }
        finally:
            self._running_tasks.pop(spec.task_id.hex(), None)
            self._current_ctx.task_id = None
            if tracing.ENABLED:
                self._append_task_event({
                    "name": spec.name or spec.fn_name,
                    "task_id": spec.task_id.hex(),
                    "actor_id": spec.actor_id,
                    "ts_us": int(_t0 * 1e6),
                    "dur_us": int((time.time() - _t0) * 1e6),
                    "worker": self.address,
                    "pid": os.getpid(),
                })

    def _append_task_event(self, evt: Dict[str, Any]) -> None:
        """Append to the bounded event ring, counting silent evictions —
        a full ring drops the OLDEST event, so long runs would otherwise
        truncate their timelines undetectably."""
        ring = self._task_events
        if len(ring) == ring.maxlen:
            self._task_events_dropped += 1
            if core_metrics.ENABLED:
                core_metrics.task_events_dropped.inc()
        ring.append(evt)

    def rpc_get_task_events(self, conn, clear: bool = False,
                            types: Optional[List[str]] = None):
        """Drain/peek this worker's event ring. ``types`` filters
        server-side by the events' "type" key — the metrics-history
        sampler polls request spans every second, and shipping a full
        10k-event ring per worker per tick (mostly lifecycle/exec
        events under actor-heavy load) would make the sampler the
        biggest RPC client in the cluster."""
        # list() first: one atomic C-level copy under the GIL — a python
        # -level comprehension over the live deque would race concurrent
        # appends (RuntimeError: deque mutated during iteration)
        events = list(self._task_events)
        if types is not None:
            want = set(types)
            events = [e for e in events if e.get("type") in want]
        dropped = self._task_events_dropped
        if clear:
            # window semantics: clearing starts a fresh window, so the
            # drop count must restart with it
            self._task_events.clear()
            self._task_events_dropped = 0
        return {"events": events, "dropped": dropped}

    def rpc_get_metrics(self, conn):
        from ray_tpu_torch.utils import metrics as metrics_mod

        return {
            "token": metrics_mod.PROCESS_TOKEN,
            "metrics": metrics_mod.snapshot_all(),
        }

    def rpc_profile(self, conn, duration_s: float = 5.0,
                    hz: float = 99.0):
        """Sample this worker's threads for ``duration_s`` at ``hz``
        (both clamped inside profiler.capture)."""
        return profiler.capture(duration_s=duration_s, hz=hz)

    def rpc_stack_dump(self, conn):
        """All-thread stacks from this live worker (hang forensics)."""
        return forensics.all_thread_stacks()

    def rpc_borrow_stats(self, conn):
        """Owner-side reference state for `state.objects()` / `rt memory`
        (leaked-borrow triage: an object held only by an old in-flight
        pin is a borrow that never completed)."""
        return self.reference_tracker.stats()

    def _resolve_arg(self, value: Any) -> Any:
        if isinstance(value, ObjectRef):
            return self._get_one(value, timeout_s=None)
        return value

    _STREAM_DONE_INDEX = 2**31 - 1  # sentinel return slot: item count

    def _package_returns(self, spec: TaskSpec, result: Any) -> List[Tuple[str, Any]]:
        if spec.num_returns == -1:
            return self._stream_returns(spec, result)
        if spec.num_returns == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != spec.num_returns:
                raise ValueError(
                    f"task {spec.name} declared num_returns={spec.num_returns} "
                    f"but returned {len(values)} values"
                )
        returns = []
        for i, value in enumerate(values):
            oid = ObjectID.from_task(spec.task_id, i)
            if spec.tensor_transport == "device":
                parts = self.device_store.put(oid.hex(), value)
                if parts is not None:
                    skeleton, leaves_meta = parts
                    self._maybe_eager_export(oid.hex())
                    returns.append((
                        oid.hex(),
                        ("device", (self.address, skeleton, leaves_meta)),
                    ))
                    continue
                # no device arrays in the value: ordinary object path
            meta, views = serialization.serialize(value)
            total = serialization.frame_nbytes(meta, views)
            if total > config.max_direct_call_object_size:
                path = self._write_through_plasma(oid.hex(), meta, views, total)
                returns.append(
                    (oid.hex(), ("plasma", (path, total, self.node_agent_address)))
                )
            else:
                # big frames ride the reply as a raw trailing wire segment
                # (multi-segment RPC) instead of an in-band re-pickle
                returns.append((oid.hex(), ("frame", serialization.maybe_frame(
                    serialization.pack_parts(meta, views)))))
        return returns

    def _stream_returns(self, spec: TaskSpec, result: Any) -> List[Tuple[str, Any]]:
        """num_returns="streaming": push each yielded value to the OWNER
        as it is produced (reference: streaming generators,
        task_manager's dynamic returns) — the consumer's
        ObjectRefGenerator sees item i long before the task finishes.
        Items ride in-order oneway RPCs; big items go through plasma and
        only their marker travels."""
        owner = self.workers.get(spec.owner_address)
        count = 0
        for value in result:
            oid = ObjectID.from_task(spec.task_id, count)
            meta, views = serialization.serialize(value)
            total = serialization.frame_nbytes(meta, views)
            if total > config.max_direct_call_object_size:
                path = self._write_through_plasma(oid.hex(), meta, views, total)
                payload = ("plasma", (path, total, self.node_agent_address))
            else:
                payload = ("frame", serialization.maybe_frame(
                    serialization.pack_parts(meta, views)))
            owner.call_oneway(
                "stream_item", task_id_hex=spec.task_id.hex(),
                index=count, payload=payload,
            )
            count += 1
        # the count marker travels on the ordinary reply path
        return [("__stream_count__", count)]

    # -- object service (owner side) --

    def rpc_get_object(
        self,
        conn,
        oid_hex: str,
        wait_s: Optional[float] = None,
        requester_agent: Optional[str] = None,
    ):
        oid = ObjectID.from_hex(oid_hex)
        try:
            stored = self.memory_store.get(oid, wait_s)
        except TimeoutError:
            return ("error", GetTimeoutError(f"object {oid_hex} not ready"))
        if serialization.is_bytes_like(stored):
            # big frames ride the reply as a raw wire segment — never
            # re-pickled in-band
            if not isinstance(stored, serialization.Frame):
                stored = serialization.maybe_frame(stored)
            return ("frame", stored)
        if isinstance(stored, PlasmaValue):
            # the path escapes to another process: the segment is shared
            # from here on and must never be page-recycled. Clear the
            # bit FIRST, then re-check liveness: delete_owned_object
            # removes the marker from the store BEFORE it reads
            # `private`, so either our re-check sees the deletion (reply
            # error, no path escapes) or the deleter sees private=False
            # (no recycle) — a concurrently-deleted segment can never be
            # both handed out and page-recycled.
            stored.private = False
            if os_mod.is_missing(self.memory_store.try_get(oid)):
                return ("error", ObjectLostError(
                    f"object {oid_hex} was freed during get"
                ))
            if (
                requester_agent is not None
                and requester_agent != stored.agent_address
            ):
                # Requester is on a different host: the shm path is useless
                # to it. Hand back the hosting agent's address so the
                # requester pulls the segment in chunks from that agent.
                return (
                    "remote_plasma",
                    (stored.path, stored.size, stored.agent_address),
                )
            return ("plasma", (stored.path, stored.size))
        if isinstance(stored, DeviceValue):
            return (
                "device",
                (stored.worker_address, stored.skeleton, stored.leaves_meta,
                 stored.obj_hex),
            )
        if isinstance(stored, LostValue):
            return ("error", ObjectLostError(stored.message))
        if isinstance(stored, Exception):
            return ("error", stored)
        return ("error", RuntimeError(f"bad stored kind {type(stored)}"))

    def rpc_peek_object(self, conn, oid_hex: str):
        return self.memory_store.contains(ObjectID.from_hex(oid_hex))

    def rpc_peek_objects(self, conn, oid_hexes: List[str]):
        return [
            self.memory_store.contains(ObjectID.from_hex(h)) for h in oid_hexes
        ]

    def rpc_free_object(self, conn, oid_hex: str):
        self.delete_owned_object(ObjectID.from_hex(oid_hex))
        return True

    def _maybe_eager_export(self, obj_hex: str) -> None:
        """Kick the shm export in the background the moment a device
        value is parked (task return / put): the D2H + segment write
        overlaps the consumer task's submit/schedule latency instead of
        sitting on its first-get critical path — the producer-side half
        of hiding transfer behind execution (arxiv 1909.09756). The
        export is single-flight and cached, so the consumer's
        ``export_device_object`` RPC finds it done (or joins it
        mid-flight); a value freed before any consumer reads it deletes
        the eager segment through the normal free path. RT_RDT_EAGER_
        EXPORT=0 restores lazy first-get exports (saves the wasted work
        when consumers are usually in-process)."""
        if not config.rdt_eager_export:
            return
        if not self._eager_export_sem.acquire(blocking=False):
            return  # throttled: this object exports lazily on first get

        def _run():
            try:
                self._export_device_segment(obj_hex)
            except Exception:  # noqa: BLE001 — consumer path will retry
                pass
            finally:
                self._eager_export_sem.release()

        threading.Thread(
            target=_run, daemon=True, name="rt-rdt-eager-export"
        ).start()

    def rpc_export_device_object(self, conn, obj_hex: str):
        """Export a device object's leaf buffers ONCE into a shm segment
        hosted by this node's agent, and hand consumers (path, size,
        offsets): a same-host consumer mmaps it zero-copy; a cross-host
        consumer streams it over the raw-TCP sendfile data plane. This
        replaces the pickled control-RPC reply as the bulk path — the
        host bounce the reference's RDT transports exist to avoid
        (reference nixl_tensor_transport.py:1 role; VERDICT r4 fix #3).
        Returns None when the object is not (or no longer) held here."""
        if self._device_store is None or not self._device_store.contains(obj_hex):
            return None
        try:
            return self._export_device_segment(obj_hex)
        except KeyError:
            return None

    def _export_device_segment(self, obj_hex: str) -> Dict[str, Any]:
        import numpy as np

        # per-object single-flight: the exports lock only guards the
        # cache dict — holding it across the D2H copy + agent RPCs would
        # serialize unrelated exports and block rpc_free_device_object
        while True:
            with self._device_exports_lock:
                entry = self._device_exports.get(obj_hex)
                if isinstance(entry, dict):
                    return entry
                if entry is None:
                    inflight = threading.Event()
                    self._device_exports[obj_hex] = inflight
                    break
            entry.wait(timeout=300.0)  # another thread is exporting
        try:
            meta = self._build_device_export(obj_hex)
            with self._device_exports_lock:
                if self._device_exports.get(obj_hex) is inflight:
                    self._device_exports[obj_hex] = meta
                else:
                    # freed mid-export: don't leak the fresh segment
                    try:
                        self.agent.call_oneway(
                            "delete_objects", oid_hexes=[obj_hex]
                        )
                    except RpcError:
                        pass
            return meta
        except BaseException:
            with self._device_exports_lock:
                if self._device_exports.get(obj_hex) is inflight:
                    del self._device_exports[obj_hex]
            raise
        finally:
            inflight.set()

    def _build_device_export(self, obj_hex: str) -> Dict[str, Any]:
        from ray_tpu_torch.core import device_objects as dev_mod

        arrays = self.device_store.arrays(obj_hex)
        # layout from avals only — nothing materializes until the
        # overlapped writer stages it chunk by chunk
        offsets, total = dev_mod.plan_export_layout(arrays)
        try:
            path = self.agent.call(
                "create_object", oid_hex=obj_hex, size=total
            )
        except RemoteError:
            # a stale segment from a freed predecessor: replace it
            self.agent.call("delete_objects", oid_hexes=[obj_hex])
            path = self.agent.call(
                "create_object", oid_hex=obj_hex, size=total
            )
        # pwrite, not mmap: writing fresh tmpfs pages through a
        # mapping pays a page-fault per 4K page (~3x slower than the
        # kernel's bulk allocate+copy in write(2)). The writer double-
        # buffers: D2H of chunk k overlaps the pwrite of chunk k-1
        # (device_objects.write_arrays_overlapped).
        fd = os.open(path, os.O_RDWR)
        try:
            dev_mod.write_arrays_overlapped(fd, arrays, offsets)
        finally:
            os.close(fd)
        # oneway: consumers read the bytes by path, not through the
        # agent, so nothing downstream waits on the seal bookkeeping
        # (same-connection ordering still lands it before any later
        # call from this worker)
        self.agent.call_oneway("seal_object", oid_hex=obj_hex)
        return {
            "path": path,
            "size": total,
            "offsets": offsets,
            "agent_addr": self.node_agent_address,
        }

    def rpc_device_object_contains(self, conn, obj_hex: str):
        return (
            self._device_store is not None
            and self._device_store.contains(obj_hex)
        )

    def rpc_free_device_object(self, conn, obj_hex: str):
        if self._device_store is not None:
            self._device_store.free(obj_hex)
        with self._device_exports_lock:
            exported = self._device_exports.pop(obj_hex, None)
        if exported is not None:
            try:
                self.agent.call_oneway("delete_objects", oid_hexes=[obj_hex])
            except RpcError:
                pass
        return True

    def rpc_device_store_stats(self, conn):
        if self._device_store is None:
            return {"device_objects": 0, "device_bytes": 0}
        return self._device_store.stats()

    def rpc_add_borrow(
        self, conn, oid_hex: str, register_token=None, consume_token=None
    ):
        self.reference_tracker.owner_add_borrow(
            ObjectID.from_hex(oid_hex),
            register_token=register_token,
            consume_token=consume_token,
        )
        return True

    def rpc_release_borrow(self, conn, oid_hex: str, n: int = 1):
        self.reference_tracker.owner_release_borrow(ObjectID.from_hex(oid_hex), n=n)
        return True

    def rpc_cancel_task(self, conn, task_id_hex: str, force: bool = False):
        self._cancelled_tasks.add(task_id_hex)
        running = self._running_tasks.get(task_id_hex)
        if running is None:
            return True
        if force:
            # force-cancel semantics (reference: force=True kills the
            # worker): the task may be wedged in native code where no
            # Python exception can land. The owner detects the connection
            # loss; the cancelled task stores TaskCancelledError and any
            # batch peers retry elsewhere.
            logger.warning(
                "force-cancel: killing worker over task %s", task_id_hex[:16]
            )
            os.kill(os.getpid(), 9)
            return True  # unreachable
        tid = running.get("tid")
        if tid is not None:
            import ctypes

            # re-verify IDENTITY at the last instant: _execute_spec pops
            # the entry in its finally before the thread can exit, so an
            # entry that is still present with the same tid cannot belong
            # to a reused thread ident
            current = self._running_tasks.get(task_id_hex)
            if current is None or current.get("tid") != tid:
                return True
            # the reference raises KeyboardInterrupt in the executing
            # thread for non-force cancellation of a running task
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(tid), ctypes.py_object(KeyboardInterrupt)
            )
        return True

    def rpc_coll_deliver(self, conn, group: str, token: str, tag: str,
                         payload=None, poison: Optional[str] = None):
        """Host-collective ring transport (collective/p2p.py): peer ranks
        dial this worker DIRECTLY and deliver chunk payloads into the
        target group's mailbox — the worker↔worker hop the p2p
        collectives ride, with ndarray payloads arriving as raw
        out-of-band multiseg segments (recv_into preallocated buffers),
        never through the control store. Idempotent per (group
        incarnation token, tag), so senders retry freely across
        connection drops; a stale token (destroyed/re-initialized group)
        drops the delivery. ``poison`` carries ring failure propagation
        instead of a payload."""
        from ray_tpu_torch.collective import p2p

        return p2p.deliver(group, token, tag, payload, poison=poison)

    def rpc_chan_push(self, conn, chan_id: str, seq: int, payload,
                      slots: int = 1):
        """Cross-host channel delivery (core/channels.py RpcChannel):
        the compiled-pipeline stage-boundary hop for stages that do not
        share a host. The payload arrives Frame-wrapped when ≥ the
        multiseg floor — raw out-of-band segments on the wire, never an
        in-band re-pickle. Idempotent per (chan_id, seq); a full mailbox
        bounces with ``full`` (the writer's retry loop is the
        backpressure)."""
        from ray_tpu_torch.core import channels as channels_mod

        return channels_mod.rpc_channel_deliver(chan_id, seq, payload, slots)

    def rpc_ping(self, conn):
        return {"worker_id": self.worker_id.hex(), "mode": self.mode,
                "actor": self.current_actor_id()}

    def rpc_exit_worker(self, conn):
        def _die():
            time.sleep(0.05)
            os._exit(0)

        threading.Thread(target=_die, daemon=True).start()
        return True


class _DependencyResolver:
    """Owner-side task dependency resolution (reference
    local_dependency_resolver.h): a normal task whose top-level ObjectRef
    args are not yet available must not compete for a worker lease —
    executors would hold leased CPUs while blocked fetching upstream
    outputs, starving the very producer tasks they wait on (observed as
    the shuffle reduce-before-map lease deadlock).

    Event-driven: locally-owned arrivals wake the loop through a
    memory-store watcher; deps owned by other workers resolve through
    async wait_objects RPCs to their owners (completion re-wakes the
    loop). An unreachable owner marks its deps resolved — the executor
    surfaces OwnerDiedError at arg fetch, which is the reference's
    error-propagation path too."""

    def __init__(self, worker: CoreWorker):
        self.worker = worker
        self._lock = threading.Lock()
        # entries: [pending deps list, ready callback]
        self._entries: List[List] = []
        self._remote_present: set = set()  # oid hexes confirmed at owners
        self._owners_lost: set = set()
        self._inflight: Dict[str, bool] = {}
        self._evt = threading.Event()
        worker.memory_store.add_watcher(self._evt)
        self._thread = threading.Thread(
            target=self._loop, name="dep-resolver", daemon=True
        )
        self._thread.start()

    def add(self, deps: List[ObjectRef], ready_cb) -> None:
        with self._lock:
            self._entries.append([list(deps), ready_cb])
        self._evt.set()

    def _dep_ready(self, r: ObjectRef) -> bool:
        w = self.worker
        if w.owns(r):
            return w.memory_store.contains(r.id)
        return (
            r.id.hex() in self._remote_present
            or r.owner_address in self._owners_lost
        )

    def _loop(self) -> None:
        w = self.worker
        while not w._shutdown.is_set():
            self._evt.wait(1.0)
            self._evt.clear()
            ready_cbs: List = []
            by_owner: Dict[str, set] = {}
            with self._lock:
                still: List[List] = []
                for deps, cb in self._entries:
                    remaining = [r for r in deps if not self._dep_ready(r)]
                    if remaining:
                        still.append([remaining, cb])
                        for r in remaining:
                            if not w.owns(r):
                                by_owner.setdefault(
                                    r.owner_address, set()
                                ).add(r.id.hex())
                    else:
                        ready_cbs.append(cb)
                self._entries = still
                # prune confirmations no longer referenced by any entry
                if self._remote_present:
                    referenced: set = set()
                    for hexes in by_owner.values():
                        referenced |= hexes
                    self._remote_present &= referenced
            for owner, hexes in by_owner.items():
                if self._inflight.get(owner) or owner in self._owners_lost:
                    continue
                self._inflight[owner] = True

                def _done(p, owner=owner):
                    self._inflight[owner] = False
                    try:
                        present = p.wait(0)
                        with self._lock:
                            self._remote_present.update(present)
                    except RpcConnectionError:
                        self._owners_lost.add(owner)
                    except RpcError:
                        pass  # transient: next pass re-issues
                    self._evt.set()

                try:
                    pend = w.workers.get(owner).call_async(
                        "wait_objects", oid_hexes=sorted(hexes),
                        known_present=0, wait_s=30.0,
                    )
                    pend.add_done_callback(_done)
                except RpcError:
                    self._owners_lost.add(owner)
                    self._inflight[owner] = False
                    self._evt.set()
            for cb in ready_cbs:
                try:
                    cb()
                except Exception:  # noqa: BLE001
                    logger.exception("dependency-ready callback failed")


class _ActorLifecycleBatcher:
    """Client-side actor lifecycle coalescing (ISSUE 14).

    ``create_actor`` / ``kill_actor`` enqueue and return immediately; one
    flusher thread ships a single ``register_actors`` / ``kill_actors``
    RPC per flush window (``actor_batch_flush_ms``), amortizing one RPC
    round trip + one scheduler wakeup over the whole batch — the
    10k-actor launch storm a Podracer-style job produces in one loop.

    Semantics preserved:
      * named creations wait synchronously (``wait_registered``) so a
        name conflict still raises at ``.remote()`` time;
      * per-record results — one bad spec fails only its own creation,
        surfaced at ``wait_registered`` (first address resolution);
      * intra-batch ordering — kills/drops for actors registered in the
        SAME window land after the register RPC, kills for other actors
        land before it (a named replacement may be waiting on the old
        holder's death);
      * retried batches are safe: the store treats duplicate register
        (same actor_id) and duplicate kill as idempotent ok.
    """

    def __init__(self, worker: "CoreWorker"):
        self._worker = worker
        self._cv = threading.Condition(threading.Lock())
        self._pending_reg: Dict[str, Dict[str, Any]] = {}
        self._pending_kill: List[Tuple[str, bool]] = []
        self._pending_drop: List[str] = []
        self._inflight: set = set()  # actor_ids in a register RPC
        self._errors: Dict[str, str] = {}  # actor_id -> per-record error
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    def enqueue_register(self, spec: Dict[str, Any]) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("worker is shutting down")
            self._pending_reg[spec["actor_id"]] = spec
            self._ensure_thread_locked()
            self._cv.notify_all()

    def enqueue_kill(self, actor_id: str, no_restart: bool) -> None:
        with self._cv:
            if self._closed:
                return
            self._pending_kill.append((actor_id, no_restart))
            self._ensure_thread_locked()
            self._cv.notify_all()

    def enqueue_drop(self, actor_id: str) -> None:
        with self._cv:
            if self._closed:
                return
            self._pending_drop.append(actor_id)
            self._ensure_thread_locked()
            self._cv.notify_all()

    def wait_registered(self, actor_id: str, timeout_s: float = 60.0) -> None:
        """Block until the batch carrying this registration was acked,
        re-raising its per-record error. Ids this batcher never saw (or
        that already flushed clean) return immediately."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while actor_id in self._pending_reg or actor_id in self._inflight:
                if time.monotonic() >= deadline:
                    raise ActorUnavailableError(
                        f"actor {actor_id} registration not acked in {timeout_s}s"
                    )
                self._cv.notify_all()  # wake the flusher: cut the window
                self._cv.wait(0.5)
            err = self._errors.pop(actor_id, None)
        if err is not None:
            raise ValueError(f"actor registration failed: {err}")

    def close(self, timeout_s: float = 5.0) -> None:
        """Flush everything still queued and stop the thread."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)

    def _ensure_thread_locked(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="actor-lifecycle-batch", daemon=True
            )
            self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not (self._pending_reg or self._pending_kill
                           or self._pending_drop or self._closed):
                    self._cv.wait(0.5)
                if self._closed and not (
                    self._pending_reg or self._pending_kill or self._pending_drop
                ):
                    return
            flush_s = float(config.actor_batch_flush_ms) / 1000.0
            if flush_s > 0 and not self._closed:
                time.sleep(flush_s)  # accumulation window
            with self._cv:
                regs = list(self._pending_reg.values())
                self._pending_reg.clear()
                kills, self._pending_kill = self._pending_kill, []
                drops, self._pending_drop = self._pending_drop, []
                self._inflight.update(s["actor_id"] for s in regs)
            try:
                self._flush(regs, kills, drops)
            except Exception:  # noqa: BLE001 — keep the flusher alive
                logger.exception("actor lifecycle flush failed")
                with self._cv:
                    for s in regs:
                        self._inflight.discard(s["actor_id"])
                        self._errors.setdefault(
                            s["actor_id"], "lifecycle flush failed"
                        )
            with self._cv:
                self._cv.notify_all()

    def _flush(self, regs: List[Dict[str, Any]],
               kills: List[Tuple[str, bool]], drops: List[str]) -> None:
        reg_ids = {s["actor_id"] for s in regs}
        self._send_kills([k for k in kills if k[0] not in reg_ids])
        if regs:
            try:
                res = self._worker.control.call(
                    "register_actors", specs=regs, retryable=True,
                    timeout_s=120.0,
                )
            except BaseException as e:  # noqa: BLE001 — whole batch failed
                res = [
                    {"actor_id": s["actor_id"], "ok": False,
                     "error": f"{type(e).__name__}: {e}"}
                    for s in regs
                ]
            with self._cv:
                for r in res:
                    if not r.get("ok"):
                        self._errors[r.get("actor_id")] = (
                            r.get("error") or "registration failed"
                        )
                for s in regs:
                    self._inflight.discard(s["actor_id"])
                self._cv.notify_all()
        self._send_kills([k for k in kills if k[0] in reg_ids])
        for actor_id in drops:
            try:
                self._worker.control.call_oneway(
                    "actor_handle_dropped", actor_id=actor_id
                )
            except RpcError:
                pass

    def _send_kills(self, kills: List[Tuple[str, bool]]) -> None:
        for flag in (True, False):
            ids = [aid for aid, nr in kills if nr is flag]
            if ids:
                try:
                    self._worker.control.call(
                        "kill_actors", actor_ids=ids, no_restart=flag,
                        retryable=True, timeout_s=120.0,
                    )
                except RpcError as e:
                    logger.warning(
                        "batched kill of %d actor(s) failed: %s", len(ids), e
                    )


class _ActorSender:
    """Caller-side ordered, pipelined actor task submission.

    Parity: ActorTaskSubmitter's per-caller sequence ordering (reference
    src/ray/core_worker/task_submission/actor_task_submitter.h). One sender
    thread serializes the sends (so frames hit the actor's socket in
    submission order — the server's raw handler enqueues them in arrival
    order), while a waiter thread collects replies, keeping many calls in
    flight. After a connection break the affected call falls back to the
    synchronous resend path and strict ordering is relaxed for the tail
    (the reference similarly re-queues on actor restart).
    """

    def __init__(self, worker: CoreWorker, actor_id: str):
        self.worker = worker
        self.actor_id = actor_id
        self.specs: "queue.Queue" = queue.Queue()
        # (pending, spec) pairs whose reply/failure has LANDED: populated
        # by per-call done-callbacks, so replies are processed in
        # COMPLETION order — a long-running call (an actor method that
        # blocks for minutes) must not head-of-line block the replies of
        # later calls that already finished on other executor threads.
        self.completed: "queue.Queue" = queue.Queue()
        self.attempts: Dict[str, int] = {}  # task_id hex -> retries used
        self._sender = threading.Thread(
            target=self._send_loop, name=f"actor-send-{actor_id[:8]}", daemon=True
        )
        self._waiter = threading.Thread(
            target=self._wait_loop, name=f"actor-wait-{actor_id[:8]}", daemon=True
        )
        self._sender.start()
        self._waiter.start()

    def submit(self, spec: TaskSpec) -> None:
        self.specs.put(spec)

    def _maybe_retry(self, spec: TaskSpec, err: Exception) -> bool:
        """Actor max_task_retries: re-queue a call that failed on
        connection loss while the actor restarts (at-least-once — the
        method may have executed; only opt-in via max_task_retries,
        reference task_manager.h:175). Permanent death never retries."""
        if spec.max_retries <= 0 or not isinstance(err, ActorUnavailableError):
            return False
        attempts = self.attempts.get(spec.task_id.hex(), 0)
        if attempts >= spec.max_retries:
            self.attempts.pop(spec.task_id.hex(), None)
            return False
        self.attempts[spec.task_id.hex()] = attempts + 1
        logger.warning(
            "retrying actor task %s (attempt %d/%d) after: %s",
            spec.name, attempts + 1, spec.max_retries, err,
        )
        self.specs.put(spec)
        return True

    def _send_loop(self) -> None:
        w = self.worker
        while not w._shutdown.is_set():
            try:
                spec = self.specs.get(timeout=0.5)
            except queue.Empty:
                continue
            deps = w._pending_task_deps.pop(spec.task_id.hex(), None)
            if deps:
                # resolve arg dependencies before the send (reference
                # actor_task_submitter dependency wait); event-driven via
                # worker.wait, owner loss counts as resolved (the executor
                # surfaces the error at arg fetch)
                try:
                    w.wait(deps, num_returns=len(deps), timeout_s=None)
                except Exception:  # noqa: BLE001 — never wedge the sender
                    logger.exception(
                        "actor task %s dependency wait failed", spec.name
                    )
                # the refs go now, not when the actor's next call comes:
                # a device object passed to its last task would stay in
                # its producer's store, on the card, after every ref died
                deps = None
            # A failed *send* (frame never accepted by the socket) is safe
            # to retry against the restarted actor; once the frame is out,
            # failures are classified by _actor_connection_lost instead.
            addr = None
            for _ in range(3):
                try:
                    # Long bound: calls to an actor still pending creation /
                    # restart legitimately wait (reference blocks on the GCS
                    # actor table); probes that need a short bound pass
                    # their own timeout_s.
                    addr = w._resolve_actor_address(spec.actor_id, timeout_s=3600.0)
                    client = w.workers.get(addr)
                    pending = client.call_async("actor_task", spec=spec)
                    pending.add_done_callback(
                        lambda p, s=spec: self.completed.put((p, s))
                    )
                    break
                except (RpcConnectionError, RpcTimeout):
                    w._actor_addr_cache.pop(spec.actor_id, None)
                    if addr is not None:
                        w.workers.drop(addr)
                    time.sleep(0.1)
                    continue
                except Exception as e:  # noqa: BLE001
                    w._store_actor_task_failure(spec, e)
                    break
            else:
                err = w._actor_connection_lost(spec)
                if not self._maybe_retry(spec, err):
                    w._store_actor_task_failure(spec, err)

    def _wait_loop(self) -> None:
        w = self.worker
        while not w._shutdown.is_set():
            try:
                pending, spec = self.completed.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                reply = pending.wait(0)  # already done: no blocking
                self.attempts.pop(spec.task_id.hex(), None)
                w._store_task_reply(spec, reply)
            except (RpcConnectionError, RpcTimeout):
                err = w._actor_connection_lost(spec)
                if not self._maybe_retry(spec, err):
                    w._store_actor_task_failure(spec, err)
            except Exception as e:  # noqa: BLE001
                w._store_actor_task_failure(spec, e)


class _Lease:
    """A granted worker lease held by the owner's lease cache."""

    __slots__ = ("agent_addr", "worker_addr", "lease_id", "idle_since",
                 "client", "fresh")

    def __init__(self, agent_addr: str, worker_addr: str, lease_id: str):
        self.agent_addr = agent_addr
        self.worker_addr = worker_addr
        self.lease_id = lease_id
        self.idle_since = time.monotonic()
        self.client = None  # RpcClient, bound at first dispatch
        # True until the first dispatch: that one task paid the lease
        # RPC, every later one is a cache hit (rt_lease_cache_hits_total)
        self.fresh = True


class _NormalTaskSubmitter:
    """Per-scheduling-key lease cache + pipelined normal-task submission.

    Parity: the reference caches granted worker leases per SchedulingKey
    and pipelines queued tasks onto held workers instead of paying a
    lease round trip per task (reference
    src/ray/core_worker/task_submission/normal_task_submitter.h:52-82,
    worker_to_lease_entry_), with owner-side bounded lease requests (its
    max_pending_lease_requests). Steady state pays ZERO lease RPCs per
    task; an idle lease is returned to its agent after lease_keepalive_s.

    Threading: a mutex guards the queue/pool state; dispatch happens
    INLINE on whichever thread makes a lease available — the submitting
    thread when a cached lease is idle, the RPC read thread the moment a
    worker's reply lands (so a held worker gets its next task without a
    queue hop), the acquisition thread when a fresh lease is granted. A
    maintenance thread only sizes the pool while replies are stalled
    behind long tasks, reaps idle leases, and releases them at shutdown.

    Pool sizing is Little's law: hold enough workers to drain the queue
    in ~lease_rampup_target_s at the measured (EMA) per-task service
    latency. Short tasks pipeline onto a few warm workers — a worker
    process per nop task is pure context-switch overhead — while long
    tasks scale wide via stall detection (the oldest in-flight age
    overrides a stale-low EMA, so the pool grows before any slow reply
    lands).
    """

    def __init__(self, worker: CoreWorker, resources: Dict[str, float],
                 strategy, runtime_env=None):
        self.w = worker
        self.resources = dict(resources)
        self.strategy = strategy
        self.runtime_env = runtime_env
        self.lock = threading.Lock()
        self.pending: deque = deque()
        self.idle: List[_Lease] = []
        self.nbusy = 0
        self.requesting = 0
        self.attempts: Dict[str, int] = {}  # task hex -> attempts used
        # EMA of per-task service latency (dispatch -> reply); 10ms prior.
        # The key-wide EMA drives pool sizing; the per-FUNCTION EMA gates
        # batching — different fns share a scheduling key, and one slow fn
        # must never be coalesced on the strength of a fast fn's history.
        self._svc_latency = 0.01
        self._fn_lat: Dict[str, float] = {}
        self._dispatch_ts: Dict[str, float] = {}
        self._next_request_at = 0.0
        # dispatched calls whose done-callback is not yet registered:
        # arming happens OUTSIDE the lock (add_done_callback runs the
        # callback synchronously when the reply already landed, and
        # _on_done takes the lock — arming under it would self-deadlock)
        self._to_arm: List[tuple] = []
        self._arming = threading.local()
        self._sender_kicked = False
        self._empty_since: Optional[float] = None
        self._disposed = False

    def submit(self, spec: TaskSpec) -> bool:
        """False if this submitter was already disposed by the janitor
        (caller re-registers a fresh one)."""
        with self.lock:
            if self._disposed:
                return False
            self.pending.append(spec)
            self._flow_locked()
        # sends go to the pool, NOT inline: a caller submitting a burst
        # must not pay serialize+sendall per task — while the pool sender
        # works, later submits queue up and coalesce into fatter chunks
        # (replies, by contrast, send their next chunk inline to keep the
        # worker pipeline tight)
        self._kick_sender()
        return True

    def _kick_sender(self) -> None:
        with self.lock:
            if not self._to_arm or self._sender_kicked:
                return
            self._sender_kicked = True
        self.w._submit_pool.submit(self._drain_sends)

    def _drain_sends(self) -> None:
        try:
            self._arm_callbacks()
        finally:
            with self.lock:
                self._sender_kicked = False
            # items planned after _arm_callbacks drained but before the
            # flag cleared would strand: re-kick if any
        self._kick_sender()

    def _arm_callbacks(self) -> None:
        """Perform the actual sends for chunks the state machine planned
        under the lock. Runs with the lock RELEASED — the serialize +
        sendall of a push (~100us) must not sit in the critical section,
        where it would serialize every submitting thread against every
        reply thread. Reentrancy-guarded: a synchronously-completed reply
        runs _on_done inline, which can plan more sends and land back
        here."""
        if getattr(self._arming, "active", False):
            return  # the outer frame's drain loop will pick new items up
        self._arming.active = True
        try:
            while True:
                with self.lock:
                    if not self._to_arm:
                        return
                    items, self._to_arm = self._to_arm, []
                for lease in items:
                    self._send_chunk(lease)
        finally:
            self._arming.active = False

    def _send_chunk(self, lease: _Lease) -> None:
        """Bind up to a chunk of queued specs to this reserved lease and
        push them in one RPC. Runs OUTSIDE the lock (serialize+sendall
        must not serialize submitters against reply threads)."""
        w = self.w
        with self.lock:
            specs = self._take_chunk_locked()
            if not specs:
                # queue drained before this reservation got serviced
                self.nbusy -= 1
                lease.idle_since = time.monotonic()
                self.idle.append(lease)
                return
            now = time.monotonic()
            for spec in specs:
                w._inflight_push[spec.task_id.hex()] = lease.worker_addr
                self._dispatch_ts[spec.task_id.hex()] = now
        if core_metrics.ENABLED:
            # tasks that rode an ALREADY-PAID-FOR lease: the first
            # dispatch on a fresh grant is the one task its lease RPC
            # bought, every other is a cache hit
            hits = len(specs) - (1 if lease.fresh else 0)
            if hits:
                core_metrics.lease_cache_hits.inc(hits)
        lease.fresh = False
        if tracing.ENABLED:
            for spec in specs:
                w._append_task_event(tracing.lifecycle_event(
                    tracing.DISPATCHED, spec.task_id.hex(), spec.name,
                    w.address, target=lease.worker_addr,
                ))
        try:
            client = lease.client
            if client is None:
                client = lease.client = w.workers.get(lease.worker_addr)
            pending = client.call_async("push_tasks", specs=specs)
        except (RpcError, OSError):
            w.workers.drop(lease.worker_addr)
            # release off-thread: a dead agent must not stall this
            # (submit or reply) thread for a connect timeout
            w._submit_pool.submit(self._release, lease, True)
            with self.lock:
                self.nbusy -= 1
                for spec in specs:
                    w._inflight_push.pop(spec.task_id.hex(), None)
                    self._dispatch_ts.pop(spec.task_id.hex(), None)
                    self._retry_or_fail_locked(
                        spec,
                        WorkerCrashedError(
                            f"worker {lease.worker_addr} unreachable for "
                            f"{spec.name}"
                        ),
                    )
                self._flow_locked()
            return
        pending.add_done_callback(
            lambda p, s=specs, l=lease: self._on_done(p, s, l)
        )

    # -- state machine (lock held) --------------------------------------

    def _flow_locked(self) -> None:
        """Reserve idle leases for queued specs, then size the pool. A
        reservation carries the LEASE only — the specs are taken at SEND
        time (_send_chunk), so during a submit flood the (slower, pooled)
        sender finds a fattened queue and coalesces many specs per RPC
        instead of freezing chunk boundaries at plan time."""
        while self.pending and self.idle:
            lease = self.idle.pop()  # LIFO: warmest worker first
            self.nbusy += 1
            self._to_arm.append(lease)
        self._scale_locked()

    def _take_chunk_locked(self) -> List[TaskSpec]:
        """How many queued specs ride one push RPC. Tasks of a MEASURED
        sub-ms function coalesce (the ~100us frame roundtrip dominates
        them); anything slower — or not yet measured — goes one-per-RPC
        so a slow task never executes serially behind batch peers. A
        batch stops at a fn whose profile differs. Cancelled specs are
        consumed here (error stored) without entering the chunk."""
        w = self.w
        chunk: List[TaskSpec] = []
        cap = min(16, max(1, len(self.pending) // (len(self.idle) + 1)))
        while self.pending and len(chunk) < cap:
            spec = self.pending[0]
            task_hex = spec.task_id.hex()
            if task_hex in w._cancelled_tasks:
                self.pending.popleft()
                self.attempts.pop(task_hex, None)
                w._store_error_returns(
                    spec,
                    TaskCancelledError(f"task {spec.name} was cancelled"),
                )
                continue
            lat = self._fn_lat.get(spec.fn_id, 0.01)
            if lat >= 0.005:
                if not chunk:
                    chunk.append(self.pending.popleft())
                break  # slow fn: alone in its RPC, never behind peers
            chunk.append(self.pending.popleft())
        return chunk

    def _scale_locked(self) -> None:
        if not self.pending:
            return
        now = time.monotonic()
        held = self.nbusy + len(self.idle)
        lat = self._svc_latency
        # Stall detection: if the oldest in-flight task has been out much
        # longer than the EMA says tasks take, the pool is provably stuck
        # behind long tasks — scale on the observed age, uncapped (the
        # EMA alone would react only after those slow replies land).
        stalled = False
        if self._dispatch_ts:
            age = now - min(self._dispatch_ts.values())
            if age > max(3.0 * lat, 0.05):
                stalled = True
        if stalled:
            # demand is provably stuck behind long tasks: one lease per
            # stuck-or-queued task (busy leases count — each is pinned
            # under a long task, so queued work needs NEW workers, and the
            # resulting parked lease requests are exactly the demand
            # signal the autoscaler scales on), capped at 4x the pool per
            # 50ms tick so a transient reply gap can't fork a worker per
            # queue entry
            want = min(
                len(self.pending) + self.nbusy, max(held * 4, 8)
            )
        else:
            want = int(
                len(self.pending) * lat / float(config.lease_rampup_target_s)
            )
            if held > 0:
                # exponential ramp: at most double the pool per step, with
                # spacing between steps — a burst of short tasks must not
                # fork a worker per queue entry before the first replies
                # reveal the true service latency
                want = min(want, held * 2)
            want = min(want, len(self.pending))
        want = max(want, 1 if held == 0 else 0)
        need = want - self.requesting - held
        if need > 0 and (stalled or now >= self._next_request_at):
            cap = int(config.max_lease_requests_per_key)
            fired = False
            while need > 0 and self.requesting < cap:
                self.requesting += 1
                need -= 1
                fired = True
                self.w._submit_pool.submit(self._acquire_lease)
            if fired:
                self._next_request_at = now + 0.05

    def _retry_or_fail_locked(self, spec: TaskSpec, err: Exception) -> None:
        """Mirror of the pre-cache retry ladder (_submit_normal_task):
        connection/crash failures always retry; app-level TaskErrors only
        with retry_exceptions; anything else is terminal."""
        w = self.w
        task_hex = spec.task_id.hex()
        used = self.attempts.get(task_hex, 0) + 1
        self.attempts[task_hex] = used
        total = spec.max_retries + 1
        retryable = isinstance(
            err, (RpcConnectionError, RpcTimeout, WorkerCrashedError)
        ) or (isinstance(err, TaskError) and spec.retry_exceptions)
        if (
            retryable
            and used < total
            and task_hex not in w._cancelled_tasks
            and not w._shutdown.is_set()
        ):
            logger.warning(
                "task %s attempt %d/%d failed: %s",
                spec.name, used, total, err,
            )
            self.pending.append(spec)
            return
        self.attempts.pop(task_hex, None)
        if task_hex in w._cancelled_tasks:
            # a force-cancel kills the worker: the resulting connection
            # loss is the CANCELLATION landing, not a crash
            err = TaskCancelledError(f"task {spec.name} was cancelled")
        elif not isinstance(err, TaskError):
            err = TaskError(
                f"task {spec.name} failed after {used} attempts: {err}"
            )
        w._store_error_returns(spec, err)

    # -- reply path (RPC read thread) -----------------------------------

    def _on_done(self, pending, specs: List[TaskSpec], lease: _Lease) -> None:
        w = self.w
        now = time.monotonic()
        for spec in specs:
            w._inflight_push.pop(spec.task_id.hex(), None)
        with self.lock:
            self.nbusy -= 1
            ts = None
            for spec in specs:
                ts = self._dispatch_ts.pop(spec.task_id.hex(), None) or ts
            if ts is not None:
                # per-task share of the batch wall time; slow EMA so
                # transient contention (e.g. worker spawns stealing CPU)
                # doesn't read as "tasks got long" and trigger a
                # self-reinforcing scale-out spiral
                sample = (now - ts) / len(specs)
                self._svc_latency = (
                    0.95 * self._svc_latency + 0.05 * sample
                )
                for spec in specs:
                    prev = self._fn_lat.get(spec.fn_id, sample)
                    self._fn_lat[spec.fn_id] = 0.7 * prev + 0.3 * sample
        try:
            replies = pending.wait(0)  # already done: no blocking
        except (RpcConnectionError, RpcTimeout):
            for spec in specs:
                if spec.tensor_transport == "device":
                    # the executor may have parked device-resident returns
                    # before the reply was lost; free that HBM best-effort
                    # on the existing connection only
                    try:
                        c = w.workers.get(lease.worker_addr)
                        if c._sock is not None:
                            for i in range(max(spec.num_returns, 0)):
                                c.call_oneway(
                                    "free_device_object",
                                    obj_hex=ObjectID.from_task(
                                        spec.task_id, i
                                    ).hex(),
                                )
                    except RpcError:
                        pass
            w.workers.drop(lease.worker_addr)
            self._release(lease, kill=True)
            with self.lock:
                for spec in specs:
                    self._retry_or_fail_locked(
                        spec,
                        WorkerCrashedError(
                            f"worker {lease.worker_addr} died while "
                            f"executing {spec.name}"
                        ),
                    )
                self._flow_locked()
            self._arm_callbacks()
            return
        except Exception as e:  # noqa: BLE001 — RPC-level failure
            self._release(lease, kill=True)
            with self.lock:
                for spec in specs:
                    self._retry_or_fail_locked(spec, e)
                self._flow_locked()
            self._arm_callbacks()
            return
        # healthy worker: pipeline the next queued chunk onto it NOW —
        # inline on this reply thread, which keeps the worker's pipeline
        # tight (the submit path, by contrast, offloads sends to the pool)
        with self.lock:
            reserved = bool(self.pending)
            if reserved:
                self.nbusy += 1
            else:
                lease.idle_since = time.monotonic()
                self.idle.append(lease)
        if reserved:
            self._send_chunk(lease)
        retry = []
        for spec, reply in zip(specs, replies):
            task_hex = spec.task_id.hex()
            if (
                isinstance(reply, dict)
                and reply.get("status") == "interrupted"
            ):
                # a stray cancel interrupt hit this (innocent) task on
                # the executor: always retryable
                retry.append((
                    spec,
                    WorkerCrashedError(
                        f"task {spec.name} caught a stray cancel interrupt"
                    ),
                ))
                continue
            try:
                w._store_task_reply(spec, reply)
                with self.lock:
                    self.attempts.pop(task_hex, None)
            except TaskError as e:
                # retry_exceptions path: _store_task_reply re-raises the
                # app-level error so the task can retry
                retry.append((spec, e))
            except Exception as e:  # noqa: BLE001
                with self.lock:
                    self.attempts.pop(task_hex, None)
                w._store_error_returns(spec, e)
        if retry:
            with self.lock:
                for spec, e in retry:
                    self._retry_or_fail_locked(spec, e)
                self._flow_locked()
            self._arm_callbacks()

    # -- leases ---------------------------------------------------------

    def maintain_tick(self) -> bool:
        """One janitor sweep: stall scaling + idle-lease reaping (no
        submit/reply thread will run the pump while every reply is stuck
        behind a long task). Returns True when this submitter has been
        completely empty past the keepalive window and can be dropped —
        every distinct scheduling key (each PG strategy mints one) must
        not cost a live object forever."""
        cutoff = time.monotonic() - float(config.lease_keepalive_s)
        expired = []
        with self.lock:
            # _flow (not just _scale): a rare failed dispatch re-queues
            # its spec without an event to pick it up — sweep it onto
            # an idle lease here
            self._flow_locked()
            if self.idle and self.idle[0].idle_since < cutoff:
                keep = []
                for lease in self.idle:
                    (keep if lease.idle_since >= cutoff
                     else expired).append(lease)
                self.idle = keep
            empty = not (
                self.pending or self.idle or self.nbusy or self.requesting
            )
            if not empty:
                self._empty_since = None
            elif self._empty_since is None:
                self._empty_since = time.monotonic()
            disposable = (
                empty
                and self._empty_since is not None
                and time.monotonic() - self._empty_since > 60.0
            )
        self._arm_callbacks()
        for lease in expired:
            self._release(lease, kill=False)
        return disposable

    def try_dispose(self) -> bool:
        """Mark disposed iff still completely empty (janitor sweep)."""
        with self.lock:
            if (
                self.pending or self.idle or self.nbusy or self.requesting
            ):
                return False
            self._disposed = True
            return True

    def release_all(self) -> None:
        """Shutdown: hand every idle lease back (best effort)."""
        with self.lock:
            leases, self.idle = self.idle, []
        for lease in leases:
            self._release(lease, kill=False)

    def _release(self, lease: _Lease, kill: bool) -> None:
        try:
            self.w.agents.get(lease.agent_addr).call_oneway(
                "release_worker", lease_id=lease.lease_id, kill=kill
            )
        except RpcError:
            pass

    def _on_lease(self, lease: _Lease) -> None:
        with self.lock:
            self.requesting -= 1
            self.idle.append(lease)
            self._flow_locked()
        self._arm_callbacks()

    def _on_no_lease(self, err: Optional[Exception], fatal: bool) -> None:
        specs = []
        with self.lock:
            self.requesting -= 1
            if fatal:
                while self.pending:
                    spec = self.pending.popleft()
                    self.attempts.pop(spec.task_id.hex(), None)
                    specs.append(spec)
            elif err is not None:
                # transient acquisition failure: back off briefly so a
                # dead agent isn't hammered in a tight loop
                self._next_request_at = time.monotonic() + 0.2
        # the key is unschedulable (hard scheduler error): every queued
        # spec gets the same verdict — identical resources/strategy mean
        # an identical outcome, per-spec retries would all see it again
        for spec in specs:
            self.w._store_error_returns(
                spec,
                TaskError(
                    f"task {spec.name} unschedulable: {err} "
                    f"(resources={self.resources})"
                ),
            )

    def _acquire_lease(self) -> None:
        """Blocking lease acquisition with spillback hops; runs on the
        submit pool. Reports exactly one _on_lease/_on_no_lease."""
        w = self.w
        strategy = self.strategy
        bundle = None
        if isinstance(strategy, dict) and strategy.get("type") == "placement_group":
            bundle = (strategy["pg_id"], strategy.get("bundle_index"))
        agent = w.agent
        agent_addr = w.node_agent_address
        hops = 0
        try:
            while True:
                if w._shutdown.is_set() or not self.pending:
                    # demand evaporated while we waited (tasks were served
                    # by cached leases, or cancelled)
                    self._on_no_lease(None, False)
                    return
                try:
                    lease = agent.call(
                        "lease_worker",
                        resources=self.resources,
                        bundle=bundle,
                        strategy=strategy,
                        wait_s=5.0,
                        timeout_s=20.0,
                        runtime_env=self.runtime_env,
                    )
                except (RpcConnectionError, RpcTimeout) as e:
                    if isinstance(e, RpcConnectionError):
                        # possibly our own agent died (driver outlives its
                        # node): re-attach before the next attempt
                        w._maybe_reattach_agent()
                    self._on_no_lease(e, False)
                    return
                if lease.get("granted"):
                    granted = _Lease(
                        agent_addr, lease["worker_address"],
                        lease["lease_id"],
                    )
                    # bind + connect the worker client HERE (pool thread,
                    # no lock): the first dispatch otherwise pays the TCP
                    # connect under the submitter lock
                    try:
                        granted.client = w.workers.get(granted.worker_addr)
                        granted.client.connect()
                    except RpcError:
                        pass  # dispatch's failure path handles it
                    if tracing.ENABLED:
                        w._append_task_event(tracing.lifecycle_event(
                            tracing.LEASE_GRANTED, granted.lease_id,
                            "lease", w.address,
                            target=granted.worker_addr,
                        ))
                    self._on_lease(granted)
                    return
                spill = lease.get("spillback")
                if spill:
                    hops += 1
                    if hops > 16:
                        self._on_no_lease(
                            TaskError("too many spillback hops"), True
                        )
                        return
                    agent = w.agents.get(spill)
                    agent_addr = spill
                    continue
                if lease.get("error") == "lease timeout":
                    # stay queued (reference: leases wait); the agent
                    # answers instantly for pending PGs, so back off
                    # briefly to avoid a tight loop
                    time.sleep(0.2)
                    continue
                self._on_no_lease(TaskError(str(lease.get("error"))), True)
                return
        except Exception as e:  # noqa: BLE001 — never leak `requesting`
            self._on_no_lease(e, False)

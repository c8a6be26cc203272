"""Control store — the cluster control plane (GCS equivalent).

Parity: the reference GCS server (src/ray/gcs/gcs_server.h:96) and its
managers: node membership + health checks (GcsNodeManager,
gcs_health_check_manager.h:45), actor directory + FT scheduling
(GcsActorManager src/ray/gcs/actor/gcs_actor_manager.h:93, restart logic
gcs_actor_manager.cc:1477-1506), placement groups with 2-phase commit
(GcsPlacementGroupManager gcs_placement_group_manager.h:50, PREPARE/COMMIT
gcs_placement_group_scheduler.h:115-117), jobs (GcsJobManager), KV store
(store_client.h — in-memory here, pluggable), pubsub (src/ray/pubsub/), and
the resource-view syncer (src/ray/ray_syncer/ray_syncer.h:91 — here:
heartbeat-carried resource reports fanned out on a pubsub topic).

Runs as threads inside the head process. State is in-memory, with an
optional durable log behind it (core/ha/wal.py — the reference's
Redis-backed GCS FT mode, C14): every durable table mutation flows
through ONE choke point, ``_apply``, which dispatches to a ``_mut_*``
state-machine function and appends the fully-resolved operation to a
write-ahead log. Recovery replays snapshot+WAL through the same
functions, rebuilding byte-identical tables, then runs a bounded
*reconciliation window* in which live node agents re-attach and
re-assert their leases/bundles/workers before scheduling resumes
(tools/check_wal_choke.py statically enforces the choke point).
"""

from __future__ import annotations

import heapq
import itertools
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import scheduling
from ray_tpu_torch.core.ha import FileBackend, HAState, write_head_address
from ray_tpu_torch.observability import core_metrics, forensics, profiler
from ray_tpu_torch.utils.config import config
from ray_tpu_torch.utils import rpc
from ray_tpu_torch.utils.ids import ActorID, JobID, NodeID, PlacementGroupID
from ray_tpu_torch.utils.rpc import ClientPool, RpcError, RpcServer

logger = logging.getLogger(__name__)


class ActorState:
    DEPENDENCIES_UNREADY = "DEPENDENCIES_UNREADY"
    PENDING_CREATION = "PENDING_CREATION"
    ALIVE = "ALIVE"
    RESTARTING = "RESTARTING"
    DEAD = "DEAD"


class PGState:
    PENDING = "PENDING"
    CREATED = "CREATED"
    REMOVED = "REMOVED"
    RESCHEDULING = "RESCHEDULING"


# Node-record fields the durable projection keeps — exactly the
# registration payload plus liveness. Everything else (heartbeat runtime
# state, reattach bookkeeping, arbitrary `extra` keys) is structurally
# excluded, so a new runtime field can never silently break replay
# determinism; agents re-assert runtime state during reconciliation.
_DURABLE_NODE_FIELDS = (
    "node_id", "address", "resources_total", "labels",
    "object_store_capacity", "alive",
)

# Ops applied through the choke point but NOT appended to the WAL:
# per-heartbeat runtime state whose replay would be meaningless across a
# process restart.
_VOLATILE_OPS = frozenset({"node_runtime"})

# Dispatcher pipelining (ISSUE 14): extra already-queued items one
# scheduler wakeup drains in the same pass, and the cap on async lease
# RPCs fired per batched-arrival item (each spawns a per-request handler
# thread on the target agent; the overflow parks in the retry heap).
_SCHED_DRAIN_MAX = 64
_SCHED_BATCH_FANOUT = 128


class ControlStore:
    def __init__(self, session_id: str, host: str = "127.0.0.1", port: int = 0,
                 persistence_path: Optional[str] = None):
        self.session_id = session_id
        # Durable log (reference C14: in-memory default vs Redis FT mode):
        # with a path, every durable mutation is WAL'd (snapshot at <path>,
        # log at <path>.wal) and a restarted control store rebuilds an
        # identical control plane, then reconciles with live agents.
        self._persistence_path = persistence_path or (
            str(config.control_store_persistence_path) or None
        )
        self._ha: Optional[HAState] = None
        if self._persistence_path:
            self._ha = HAState(
                FileBackend(self._persistence_path),
                compact_entries=int(config.ha_wal_compact_entries),
                fsync=bool(config.ha_wal_fsync),
                group_commit_ms=float(config.wal_group_commit_ms),
            )
        # Reconciliation window state (live failover): set by _restore when
        # previously-alive nodes were recovered from the log.
        self._recovering = False
        self._reconcile_deadline = 0.0
        # node_id -> re-attach report ({"leases": set, "bundles": {pg: set}})
        # — recorded only during the window, consumed+cleared at finalize
        self._reattached: Dict[str, Dict[str, Any]] = {}
        self._reattached_total = 0  # distinct nodes re-attached (status)
        self._server = RpcServer("control_store", host, port)
        self._server.register_instance(self)
        self._server.on_disconnect = self._handle_disconnect
        if self._ha is not None and self._ha.group_commit:
            # acked => durable under group commit: every reply waits for
            # the group holding its ops to flush (wal.py HAState.barrier)
            self._server.post_dispatch = self._ha.barrier

        self._lock = threading.RLock()
        self._kv: Dict[str, Dict[str, bytes]] = {}
        self._kv_cv = threading.Condition(self._lock)
        self._nodes: Dict[str, Dict[str, Any]] = {}  # node_id hex -> record
        self._actors: Dict[str, Dict[str, Any]] = {}  # actor_id hex -> record
        self._named_actors: Dict[Tuple[str, str], str] = {}
        self._pgs: Dict[str, Dict[str, Any]] = {}
        # woken on every PG terminal transition (CREATED/REMOVED) so
        # rpc_wait_placement_group returns the moment the 2PC finishes
        # instead of quantizing every waiter to a poll interval
        self._pg_cv = threading.Condition(self._lock)
        self._jobs: Dict[str, Dict[str, Any]] = {}
        self._next_job = 1

        # pubsub: topic -> {conn_id: conn}
        self._subs: Dict[str, Dict[int, Any]] = {}

        # Volatile KV traffic accounting (NOT durable state — survives
        # nothing, counts everything): payload bytes written into and
        # served out of the KV. The p2p collective tier's head-traffic
        # guarantee ("rendezvous only, independent of payload size") is
        # asserted against these counters (rpc_kv_stats).
        self._kv_traffic = {
            "puts": 0, "bytes_put": 0, "gets": 0, "bytes_out": 0,
        }

        # aggregate resource-view version: bumps on any node join/leave or
        # resource change (versioned sync, reference ray_syncer.h:91)
        self._view_version = 0

        self._agents = ClientPool("cs->agent")
        self._workers = ClientPool("cs->worker")
        self._stopped = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        # Metrics history + alert plane (ISSUE 15): built in start()
        # when sampling is enabled (metrics_sample_interval_s > 0 and
        # observability on); None otherwise so the RPC handlers report
        # "disabled" instead of serving empty stores.
        self._history = None
        self._alert_engine = None
        self._sampler = None

        # Scheduling queue (reference GcsActorScheduler/PG scheduler run
        # on the GCS io-service, not a thread per entity): ONE dispatcher
        # thread drains this queue; lease/create RPCs go out async and
        # their completions re-enqueue follow-up items, so thread count
        # stays flat no matter how many actors/PGs are pending.
        self._sched_q: "queue.Queue" = queue.Queue()
        self._sched_retries: List[Tuple[float, int, tuple]] = []  # heap
        self._sched_seq = itertools.count()
        self._sched_backoff: Dict[tuple, float] = {}
        self._sched_retry_lock = threading.Lock()  # heap+backoff (pg pool
        # threads and the dispatcher both retry/enqueue)
        # PG 2PC does synchronous prepare/commit RPCs; a hung agent must
        # not stall the (async) actor pipeline, so PG passes run on a
        # small fixed pool instead of the dispatcher thread.
        from concurrent.futures import ThreadPoolExecutor

        self._pg_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="cs-pg"
        )
        self._pg_running: set = set()
        # Parallel kill-drain (ISSUE 14): teardown RPCs (exit_worker +
        # release_workers) fan out across node agents on this bounded
        # pool instead of a serial per-actor loop in the handler thread.
        self._kill_pool = ThreadPoolExecutor(
            max_workers=max(1, int(config.actor_kill_fanout)),
            thread_name_prefix="cs-kill",
        )

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        self._restore()
        self._server.start()
        write_head_address(self.address)
        self._health_thread = threading.Thread(
            target=self._health_loop, name="cs-health", daemon=True
        )
        self._health_thread.start()
        threading.Thread(
            target=self._sched_loop, name="cs-scheduler", daemon=True
        ).start()
        self._start_observability()
        # continuous sampler rides observability_enabled + profiler_hz
        # only — it is useful precisely when the history sampler is off
        profiler.maybe_start_continuous()
        if self._recovering:
            threading.Thread(
                target=self._reconcile_loop, name="cs-reconcile", daemon=True
            ).start()

    def _start_observability(self) -> None:
        """Start the metrics-history sampler (+ alert engine) on this
        head. interval<=0 or observability_enabled=0 disables the whole
        plane — no store, no thread, no per-tick scrape cost."""
        interval = float(config.metrics_sample_interval_s)
        if interval <= 0 or not bool(config.observability_enabled):
            return
        from ray_tpu_torch.observability import alerts as alerts_mod
        from ray_tpu_torch.observability import history as history_mod

        self._history = history_mod.MetricsHistory(
            base_step_s=interval,
            max_series=int(config.metrics_history_max_series),
        )
        on_tick = None
        if bool(config.alerts_enabled):
            self._alert_engine = alerts_mod.AlertEngine(
                alerts_mod.default_rules(), self._history
            )
            on_tick = self._alert_engine.evaluate
        self._sampler = history_mod.HistorySampler(
            self._history, self.address, self._stopped, interval,
            on_tick=on_tick,
        )
        self._sampler.start()

    def stop(self) -> None:
        self._stopped.set()
        self._pg_pool.shutdown(wait=False)
        self._kill_pool.shutdown(wait=False)
        # server down first, and the final snapshot under the store lock:
        # an in-flight handler must not append between the close's state
        # copy and its WAL truncation (the acked op would vanish). An
        # append that lands after the close is still safe — it reopens
        # the truncated WAL with seq > snapshot seq and replays.
        self._server.stop()
        if self._ha is not None:
            with self._lock:
                self._ha.close(self._durable_state_snapshot)
        self._agents.close_all()
        self._workers.close_all()

    # ------------------------------------------------------------------
    # durable log (reference C14: gcs_table_storage + store_client) —
    # THE WAL CHOKE POINT. Every mutation of the state tables (_kv,
    # _nodes, _actors, _named_actors, _pgs, _jobs, _next_job) must go
    # through _apply, which runs a _mut_* state-machine function and
    # appends the fully-resolved op to the WAL. tools/check_wal_choke.py
    # enforces this statically (tier-1).
    # ------------------------------------------------------------------

    def _apply(self, op: str, *args):
        """Sole entry point for state-table mutations. Caller must hold
        self._lock — appends are thereby totally ordered, and an inline
        compaction snapshot is consistent with the log position.

        Write-ahead ordering: the op is logged BEFORE the in-memory
        mutation runs, so an append failure (disk full, closed backend)
        surfaces to the caller with memory and log still in agreement —
        logged-but-unapplied is the one crash window, and replay then
        applies it, which is the WAL contract (logged == committed)."""
        assert self._lock._is_owned(), "mutation outside the store lock"
        if (
            self._ha is not None
            and op not in _VOLATILE_OPS
            # collective rendezvous namespaces (coll/*) are incarnation-
            # scoped: replaying them into a restarted cluster would satisfy
            # a new group's barrier/op tags with a dead run's keys.
            and not (op.startswith("kv_") and args[0].startswith("coll/"))
        ):
            self._ha.append(op, args, self._durable_state_snapshot)
        return getattr(self, "_mut_" + op)(*args)

    # -- state-machine mutation functions: pure in-memory table updates,
    # -- deterministic given their (logged) args; no RPC, no clock reads.

    def _mut_kv_put(self, ns: str, key: str, value: bytes) -> None:
        self._kv.setdefault(ns, {})[key] = value

    def _mut_kv_del(self, ns: str, key: str) -> bool:
        return self._kv.get(ns, {}).pop(key, None) is not None

    def _mut_kv_del_prefix(self, ns: str, prefix: str) -> int:
        table = self._kv.get(ns)
        if table is None:
            return 0
        doomed = [k for k in table if k.startswith(prefix)]
        for k in doomed:
            del table[k]
        if not table and prefix == "":
            self._kv.pop(ns, None)
        return len(doomed)

    def _mut_node_register(self, node_id: str, info: Dict[str, Any]) -> None:
        node = self._nodes.get(node_id)
        if node is None:
            node = {}
            self._nodes[node_id] = node
        node.update(info)
        node["alive"] = True

    def _mut_node_runtime(self, node_id: str, fields: Dict[str, Any]) -> None:
        # VOLATILE: heartbeat-carried runtime state, never WAL'd.
        node = self._nodes.get(node_id)
        if node is not None:
            node.update(fields)

    def _mut_node_dead(self, node_id: str) -> None:
        node = self._nodes.get(node_id)
        if node is not None:
            node["alive"] = False

    def _mut_job_add(self, driver_address: str, metadata: Dict[str, Any],
                     ts: float) -> str:
        job_id = JobID.from_int(self._next_job)
        self._next_job += 1
        self._jobs[job_id.hex()] = {
            "job_id": job_id.hex(),
            "driver_address": driver_address,
            "metadata": metadata,
            "start_time": ts,
            "alive": True,
        }
        return job_id.hex()

    def _mut_job_finish(self, job_id: str, ts: float) -> None:
        job = self._jobs.get(job_id)
        if job:
            job["alive"] = False
            job["end_time"] = ts

    def _mut_actor_register(self, record: Dict[str, Any]) -> None:
        actor_id = record["actor_id"]
        self._actors[actor_id] = dict(record)
        name = record.get("name")
        if name:
            self._named_actors[(record.get("namespace", "default"), name)] = (
                actor_id
            )

    def _mut_actor_update(self, actor_id: str, fields: Dict[str, Any]) -> None:
        record = self._actors.get(actor_id)
        if record is not None:
            record.update(fields)

    def _mut_pg_add(self, record: Dict[str, Any]) -> None:
        rec = dict(record)
        rec["bundle_locations"] = dict(rec.get("bundle_locations") or {})
        self._pgs[rec["pg_id"]] = rec

    def _mut_pg_update(self, pg_id: str, fields: Dict[str, Any]) -> None:
        pg = self._pgs.get(pg_id)
        if pg is not None:
            pg.update(fields)

    def _mut_pg_merge_locations(self, pg_id: str,
                                placement: Dict[int, str]) -> None:
        pg = self._pgs.get(pg_id)
        if pg is not None:
            pg["bundle_locations"].update(
                {int(i): nid for i, nid in placement.items()}
            )

    def _mut_pg_drop_locations(self, pg_id: str, idxs: List[int]) -> None:
        pg = self._pgs.get(pg_id)
        if pg is not None:
            for i in idxs:
                pg["bundle_locations"].pop(int(i), None)

    # -- durable projection + snapshot/restore --

    def _durable_state(self) -> Dict[str, Any]:
        """The WAL-covered tables, minus volatile runtime fields. Replay
        of snapshot+WAL reproduces this projection byte-identically
        (tests/test_ha_failover.py::test_wal_replay_determinism)."""
        return {
            "kv": {
                ns: dict(t) for ns, t in self._kv.items()
                if not ns.startswith("coll/")
            },
            "nodes": {
                nid: {k: n[k] for k in _DURABLE_NODE_FIELDS if k in n}
                for nid, n in self._nodes.items()
            },
            "jobs": {j: dict(r) for j, r in self._jobs.items()},
            "next_job": self._next_job,
            "actors": {a: dict(r) for a, r in self._actors.items()},
            "named_actors": dict(self._named_actors),
            "pgs": {
                p: dict(r, bundle_locations=dict(r["bundle_locations"]))
                for p, r in self._pgs.items()
            },
        }

    def _durable_state_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return self._durable_state()

    def _load_tables(self, tables: Dict[str, Any]) -> None:
        self._kv = {ns: dict(t) for ns, t in tables.get("kv", {}).items()}
        self._nodes = {n: dict(r) for n, r in tables.get("nodes", {}).items()}
        self._jobs = {j: dict(r) for j, r in tables.get("jobs", {}).items()}
        self._next_job = tables.get("next_job", 1)
        self._actors = {
            a: dict(r) for a, r in tables.get("actors", {}).items()
        }
        self._named_actors = dict(tables.get("named_actors", {}))
        self._pgs = {
            p: dict(r, bundle_locations=dict(r["bundle_locations"]))
            for p, r in tables.get("pgs", {}).items()
        }

    def _restore(self) -> None:
        if self._ha is None:
            return
        tables, records = self._ha.recover()
        if tables is None and not records:
            self._ha.start(
                self._durable_state_snapshot,
                meta={"session_id": self.session_id},
            )
            return
        prev_session = self._ha.meta.get("session_id")
        with self._lock:
            if tables is not None:
                self._load_tables(tables)
            for op, args in records:
                try:
                    getattr(self, "_mut_" + op)(*args)
                except Exception:  # noqa: BLE001 — replay must not abort
                    logger.exception("WAL replay of %s%r failed", op, args)
            self._post_restore_locked()
        if prev_session:
            # keep the cluster's session identity stable across the bounce
            # (agents/workers key temp dirs and shm prefixes by it)
            self.session_id = prev_session
        self._ha.start(
            self._durable_state_snapshot,
            meta={"session_id": self.session_id},
        )
        logger.info(
            "control store restored (epoch %d): %d nodes, %d actors, "
            "%d PGs, %d jobs, %d KV namespaces; %s",
            self._ha.epoch, len(self._nodes), len(self._actors),
            len(self._pgs), len(self._jobs), len(self._kv),
            "reconciliation window open" if self._recovering
            else "no live nodes to reconcile",
        )

    def _post_restore_locked(self) -> None:
        """Reset volatile runtime state after a replay: node liveness is
        re-asserted by the agents themselves during the reconciliation
        window; monotonic stamps from the dead process are meaningless."""
        now = time.monotonic()
        restored_alive = []
        for nid in self._nodes:
            self._apply("node_runtime", nid, {
                "last_heartbeat": now,
                "resources_available": dict(
                    self._nodes[nid].get("resources_total", {})
                ),
                "reconciled": False,
            })
            if self._nodes[nid].get("alive"):
                restored_alive.append(nid)
        self._view_version += 1
        if restored_alive:
            self._recovering = True
            self._reconcile_deadline = now + float(
                config.ha_reconcile_window_s
            )
        # nothing in-flight survives a restart: requeue pending work (the
        # scheduler defers it until the reconciliation window closes)
        for aid, r in self._actors.items():
            if r["state"] in (
                ActorState.PENDING_CREATION, ActorState.RESTARTING,
            ):
                self._sched_enqueue(("actor", aid))
        for pid, pg in self._pgs.items():
            if pg["state"] in (PGState.PENDING, PGState.RESCHEDULING):
                self._sched_enqueue(("pg", pid))

    # -- reconciliation window (live failover) --

    def _reconcile_loop(self) -> None:
        while not self._stopped.wait(0.1):
            with self._lock:
                if not self._recovering:
                    return
                pending = [
                    nid for nid, n in self._nodes.items()
                    if n.get("alive") and not n.get("reconciled")
                ]
                if pending and time.monotonic() < self._reconcile_deadline:
                    continue
            self._finalize_reconciliation()
            return

    def _finalize_reconciliation(self) -> None:
        with self._lock:
            # compute the stale set in the same critical section that ends
            # the window: a node whose reattach lands after this point is
            # spared again inside _mark_node_dead's reconciled re-check —
            # a live, successfully re-attached node must never be GC'd
            self._recovering = False
            stale_nodes = [
                nid for nid, n in self._nodes.items()
                if n.get("alive") and not n.get("reconciled")
            ]
        for nid in stale_nodes:
            logger.warning(
                "node %s did not re-attach within the reconciliation "
                "window; garbage-collecting", nid[:8],
            )
            self._mark_node_dead(
                nid, "did not re-attach after head restart",
                only_if_unreconciled=True,
            )
        # Verify restored-ALIVE actors against the agents' re-attach
        # reports: a worker that died during the outage never told us.
        lost = []
        with self._lock:
            for aid, r in self._actors.items():
                if r["state"] != ActorState.ALIVE:
                    continue
                nid = r.get("node_id")
                node = self._nodes.get(nid) if nid else None
                if node is None or not node["alive"]:
                    continue  # _mark_node_dead above already failed it over
                report = self._reattached.get(nid)
                if report is None:
                    # alive node without a report: its reattach raced the
                    # window close (recorded nothing) — SPARE the actor;
                    # killing a possibly-running instance risks split
                    # brain, and a genuinely dead worker is still caught
                    # by the agent's report_worker_failure path
                    continue
                if r.get("lease_id") not in report["leases"]:
                    lost.append(aid)
        for aid in lost:
            self._on_actor_worker_lost(aid, "worker lost during head outage")
        # Verify PG bundle placements the same way, then resume pending
        # placement work.
        requeue_pgs = []
        with self._lock:
            for pg in self._pgs.values():
                if pg["state"] not in (PGState.CREATED, PGState.PENDING,
                                       PGState.RESCHEDULING):
                    continue
                drop = []
                for idx, nid in list(pg["bundle_locations"].items()):
                    node = self._nodes.get(nid)
                    if node is None or not node["alive"]:
                        drop.append(idx)
                        continue
                    report = self._reattached.get(nid)
                    if report is not None and idx not in report[
                        "bundles"
                    ].get(pg["pg_id"], ()):
                        drop.append(idx)
                if drop:
                    self._apply("pg_drop_locations", pg["pg_id"], drop)
                    if pg["state"] == PGState.CREATED:
                        self._apply(
                            "pg_update", pg["pg_id"],
                            {"state": PGState.PENDING},
                        )
                if pg["state"] in (PGState.PENDING, PGState.RESCHEDULING):
                    requeue_pgs.append(pg["pg_id"])
        for pid in requeue_pgs:
            self._sched_enqueue(("pg", pid))
        self._sched_enqueue(("kick",))
        with self._lock:
            reattached = len(self._reattached)
            self._reattached.clear()  # reports are consumed; window over
        self.publish("head", {"event": "reconciled",
                              "stale_nodes": stale_nodes})
        logger.info(
            "reconciliation complete: %d nodes re-attached, %d stale "
            "nodes GC'd, %d actors failed over, %d PGs re-placing",
            reattached, len(stale_nodes), len(lost), len(requeue_pgs),
        )

    def rpc_reattach_node(self, conn, node_info: Dict[str, Any],
                          leases: Optional[Dict[str, Dict[str, Any]]] = None,
                          bundles: Optional[Dict[str, List[int]]] = None,
                          workers: Optional[List[str]] = None):
        """A live agent re-asserts its state after a head restart (or
        after the store otherwise lost its registration). Returns the
        normal registration payload plus store-managed lease_ids the
        agent should release (orphans no live actor references)."""
        node_id = node_info["node_id"]
        leases = leases or {}
        with self._lock:
            node = self._nodes.get(node_id)
            if node is not None and not node["alive"]:
                return {"ok": False}  # explicitly declared dead: agent exits
            known = node is not None
            self._apply("node_register", node_id, dict(node_info))
            self._apply("node_runtime", node_id, {
                "last_heartbeat": time.monotonic(),
                "resources_available": dict(node_info["resources_total"]),
                "reconciled": True,
            })
            self._view_version += 1
            if self._recovering:
                # the report only feeds _finalize_reconciliation; post-
                # window reattaches (store lost a record) must not
                # accumulate in it forever
                if node_id not in self._reattached:
                    self._reattached_total += 1
                self._reattached[node_id] = {
                    "leases": set(leases),
                    "bundles": {
                        pg_id: {int(i) for i in idxs}
                        for pg_id, idxs in (bundles or {}).items()
                    },
                    "workers": list(workers or ()),
                }
            referenced = {
                r.get("lease_id") for r in self._actors.values()
                if r["state"] in (ActorState.ALIVE,
                                  ActorState.PENDING_CREATION)
            }
            release = [
                lid for lid, info in leases.items()
                if not info.get("bound") and lid not in referenced
            ]
        logger.info(
            "node %s re-attached (%d leases, %d PGs, %d workers; "
            "%d orphan leases to release)",
            node_id[:8], len(leases), len(bundles or {}),
            len(workers or ()), len(release),
        )
        if not known:
            self.publish(
                "node", {"event": "added", "node": self._public_node(node_id)}
            )
        self._sched_enqueue(("kick",))
        return {
            "ok": True,
            "config_snapshot": config.snapshot(),
            "session_id": self.session_id,
            "release_leases": release,
        }

    def rpc_ha_status(self, conn):
        """HA/failover introspection for `rt status` and tests."""
        with self._lock:
            st: Dict[str, Any] = {
                "enabled": self._ha is not None,
                "recovering": self._recovering,
                "reconcile_remaining_s": (
                    max(0.0, self._reconcile_deadline - time.monotonic())
                    if self._recovering else 0.0
                ),
                "unreconciled_nodes": [
                    nid for nid, n in self._nodes.items()
                    if n.get("alive") and not n.get("reconciled", True)
                ],
                "reattached_nodes": self._reattached_total,
            }
            if self._ha is not None:
                st.update(self._ha.stats())
        return st

    @property
    def address(self) -> str:
        return self._server.address

    # ------------------------------------------------------------------
    # pubsub (reference C16)
    # ------------------------------------------------------------------

    def rpc_subscribe(self, conn, topics: List[str]):
        with self._lock:
            for t in topics:
                self._subs.setdefault(t, {})[id(conn)] = conn
        return True

    def rpc_publish(self, conn, topic: str, payload: Any):
        self.publish(topic, payload)
        return True

    def publish(self, topic: str, payload: Any) -> None:
        with self._lock:
            conns = list(self._subs.get(topic, {}).values())
        if not conns:
            return
        # serialize ONCE per publish; the encoded frame is shared (read-
        # only) across every subscriber connection instead of re-pickling
        # the payload per subscriber
        bufs = rpc.encode_message(("push", "pubsub", (topic, payload)))
        for c in conns:
            if not c.push_encoded(bufs):
                with self._lock:
                    self._subs.get(topic, {}).pop(id(c), None)

    def _handle_disconnect(self, conn) -> None:
        with self._lock:
            for subs in self._subs.values():
                subs.pop(id(conn), None)
        node_id = getattr(conn, "node_id", None)
        if node_id is not None:
            # Fast failure detection: the agent's heartbeat connection
            # broke. Confirm with a short grace (a live agent re-heartbeats
            # on a fresh connection within one period) before declaring
            # death — much faster than the full health_check_timeout_s.
            threading.Thread(
                target=self._confirm_node_death, args=(node_id,),
                name="cs-conn-death", daemon=True,
            ).start()

    def _confirm_node_death(self, node_id: str) -> None:
        if self._recovering:
            return  # mid-reattach churn must not kill a returning node
        t_break = time.monotonic()
        grace = 2.5 * config.health_check_period_s
        while time.monotonic() - t_break < grace:
            if self._stopped.wait(0.25):
                return
            with self._lock:
                node = self._nodes.get(node_id)
                if node is None or not node["alive"]:
                    return
                if node["last_heartbeat"] > t_break:
                    return  # re-heartbeated on a fresh connection: alive
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or not node["alive"] or (
                node["last_heartbeat"] > t_break
            ):
                return
        logger.warning(
            "node %s heartbeat connection lost; marking dead", node_id[:8]
        )
        self._mark_node_dead(node_id, "heartbeat connection lost")

    # ------------------------------------------------------------------
    # KV (reference C14 / internal KV)
    # ------------------------------------------------------------------

    def rpc_kv_put(self, conn, ns: str, key: str, value: bytes, overwrite: bool = True):
        with self._lock:
            if not overwrite and key in self._kv.get(ns, {}):
                return False
            self._kv_traffic["puts"] += 1
            self._kv_traffic["bytes_put"] += len(value) if value is not None else 0
            self._apply("kv_put", ns, key, value)
            self._kv_cv.notify_all()
            return True

    def _kv_note_out(self, val) -> None:
        """Count a KV value served to a client (volatile accounting)."""
        if val is not None:
            self._kv_traffic["gets"] += 1
            self._kv_traffic["bytes_out"] += len(val)

    def rpc_kv_get(self, conn, ns: str, key: str):
        with self._lock:
            val = self._kv.get(ns, {}).get(key)
            self._kv_note_out(val)
            return val

    def rpc_kv_wait(self, conn, ns: str, key: str, wait_s: float = 60.0):
        """Block server-side until the key exists (or timeout); returns
        the value or None. The collective tier's rendezvous primitive:
        one blocking RPC replaces a client-side poll loop (the round-2
        O(n^2)-polling weakness).

        The server never honors the caller's full deadline in one call:
        the wait is capped at dispatch_wait_slice_s so a fan-in of
        blocked waiters can't strand the whole dispatcher pool (clients
        re-issue slices until their own deadline — see
        collective._recv_either)."""
        wait_s = min(wait_s, float(config.dispatch_wait_slice_s))
        deadline = time.monotonic() + wait_s
        with self._lock:
            while True:
                val = self._kv.get(ns, {}).get(key)
                if val is not None:
                    self._kv_note_out(val)
                    return val
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stopped.is_set():
                    return None
                self._kv_cv.wait(min(remaining, 1.0))

    def rpc_kv_stats(self, conn):
        """Volatile KV traffic counters: payload bytes in (kv_put) and
        out (kv_get/kv_wait hits) since this head process started. Tests
        pin the collective head-traffic guarantee against deltas of
        these."""
        with self._lock:
            return dict(self._kv_traffic)

    def rpc_kv_del(self, conn, ns: str, key: str):
        with self._lock:
            if key not in self._kv.get(ns, {}):
                return False
            return self._apply("kv_del", ns, key)

    def rpc_kv_keys(self, conn, ns: str, prefix: str = ""):
        with self._lock:
            return [k for k in self._kv.get(ns, {}) if k.startswith(prefix)]

    def rpc_kv_del_prefix(self, conn, ns: str, prefix: str = ""):
        with self._lock:
            if not any(
                k.startswith(prefix) for k in self._kv.get(ns, ())
            ):
                return 0
            return self._apply("kv_del_prefix", ns, prefix)

    # ------------------------------------------------------------------
    # nodes (reference GcsNodeManager + health checks + syncer)
    # ------------------------------------------------------------------

    def rpc_register_node(self, conn, node_info: Dict[str, Any]):
        node_id = node_info["node_id"]
        with self._lock:
            self._apply("node_register", node_id, dict(node_info))
            self._apply("node_runtime", node_id, {
                "last_heartbeat": time.monotonic(),
                "resources_available": dict(node_info["resources_total"]),
                "reconciled": True,
            })
            self._view_version += 1
        logger.info("node %s registered at %s", node_id[:8], node_info["address"])
        self.publish("node", {"event": "added", "node": self._public_node(node_id)})
        # fresh capacity: retry anything the scheduler had parked
        self._sched_enqueue(("kick",))
        return {"config_snapshot": config.snapshot(), "session_id": self.session_id}

    def rpc_heartbeat(self, conn, node_id: str,
                      resources_available: Optional[Dict[str, float]] = None,
                      extra: Optional[Dict[str, Any]] = None,
                      pending_leases: int = 0, active_leases: int = 0,
                      view_version: Optional[int] = None):
        """Versioned resource-view sync (reference ray_syncer.h:91):
        resources_available=None is a LIGHT beat — liveness only, the
        resource view is unchanged at `view_version`. A version mismatch
        (store restarted / payload lost) asks the agent to resync with a
        full beat."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                # The store has no record of this live agent (restarted
                # head with no/lost log): ask it to re-attach rather than
                # telling it to die.
                return {"ok": False, "reattach": True}
            if not node["alive"]:
                return {"ok": False}  # tells a zombie agent to exit
            # Tag the transport so a broken agent connection fast-paths
            # failure detection (reference: GCS treats the raylet channel
            # break as a death signal, not just missed heartbeats).
            conn.node_id = node_id
            # Heartbeats call _mut_node_runtime DIRECTLY instead of going
            # through _apply: node_runtime is in _VOLATILE_OPS (never
            # WAL'd), so the choke point adds only dispatch overhead on
            # the store's single hottest path — one call per node per
            # beat. Cold-path node_runtime writers (register/reattach/
            # restore) keep using _apply.
            if not node.get("reconciled", True):
                # restored-from-log record: the agent must re-assert its
                # leases/bundles/workers before scheduling trusts the node
                self._mut_node_runtime(node_id, {"last_heartbeat": time.monotonic()})  # rtlint: ignore[wal-choke] volatile heartbeat field, _VOLATILE_OPS skips the WAL; hot path bypasses _apply dispatch
                return {"ok": True, "reattach": True}
            runtime: Dict[str, Any] = {"last_heartbeat": time.monotonic()}
            if resources_available is None:
                self._mut_node_runtime(node_id, runtime)  # rtlint: ignore[wal-choke] volatile heartbeat field, _VOLATILE_OPS skips the WAL; hot path bypasses _apply dispatch
                if node.get("view_version") != view_version:
                    return {"ok": True, "resync": True}
                return {"ok": True}
            runtime.update({
                "resources_available": resources_available,
                "pending_leases": pending_leases,
                "active_leases": active_leases,
                "view_version": view_version,
            })
            if extra:
                runtime.update(extra)
            self._mut_node_runtime(node_id, runtime)  # rtlint: ignore[wal-choke] volatile heartbeat runtime, _VOLATILE_OPS skips the WAL; hot path bypasses _apply dispatch
            self._view_version += 1
        return {"ok": True}

    def rpc_capacity_freed(self, conn, node_id: str):
        """A lease was released on `node_id`: retry parked scheduling work
        immediately instead of waiting out its backoff (ADVICE r4: pending
        actors otherwise idle up to 2s after capacity frees). Coalesced:
        on a busy cluster every release fires this, so kicks within 100ms
        collapse to one — a dropped kick only costs one short backoff step
        (heartbeat anti-entropy is the backstop)."""
        now = time.monotonic()
        if now - getattr(self, "_last_kick_req", 0.0) >= 0.1:
            self._last_kick_req = now
            self._sched_enqueue(("kick",))
        return {"ok": True}

    def rpc_get_nodes(self, conn, alive_only: bool = True):
        with self._lock:
            return [
                self._public_node(nid)
                for nid, n in self._nodes.items()
                if n["alive"] or not alive_only
            ]

    def rpc_get_cluster_view(self, conn, known_version: Optional[int] = None):
        """Scheduling view: per-node totals/availables (syncer
        equivalent). With known_version, reply {"unchanged": True} when
        the aggregate view hasn't moved — consumers polling the view
        (autoscaler, elastic train) pay O(1) instead of O(nodes)."""
        with self._lock:
            if known_version is not None:
                if known_version == self._view_version:
                    return {"unchanged": True, "version": self._view_version}
                return {
                    "version": self._view_version,
                    "view": self._cluster_view_locked(),
                }
            return self._cluster_view_locked()

    def rpc_drain_node(self, conn, node_id: str):
        self._mark_node_dead(node_id, "drained")
        return True

    def rpc_get_metrics(self, conn):
        """This process's metric registry (built-in scheduler series live
        here). The token lets state.cluster_metrics dedup the head case
        where control store + agent + driver share one process."""
        from ray_tpu_torch.utils import metrics as metrics_mod

        return {
            "token": metrics_mod.PROCESS_TOKEN,
            "metrics": metrics_mod.snapshot_all(),
        }

    def rpc_metrics_history(self, conn, name: Optional[str] = None,
                            tags: Optional[Dict[str, str]] = None,
                            window_s: Optional[float] = None,
                            step_s: Optional[float] = None):
        """Query the head-side metrics history (observability/history.py).
        name=None returns the store inventory + sampler stats; with a
        name, aggregated points for that metric (tags filter, window,
        requested resolution)."""
        h = self._history
        if h is None:
            return {"enabled": False}
        if name is None:
            return {"enabled": True, **h.stats()}
        out = h.query(name, tags=tags, window_s=window_s, step_s=step_s)
        out["enabled"] = True
        return out

    def rpc_alerts(self, conn):
        """Current alert-rule states (observability/alerts.py)."""
        eng = self._alert_engine
        if eng is None:
            return {"enabled": False, "alerts": []}
        return {"enabled": True, "alerts": eng.describe()}

    def rpc_profile(self, conn, duration_s: float = 5.0,
                    hz: float = 99.0):
        """Sample the head process's threads. The caller-supplied
        duration is capped so a profile RPC can hold a dispatcher
        thread for at most profiler_max_duration_s."""
        duration_s = min(
            float(duration_s), float(config.profiler_max_duration_s)
        )
        return profiler.capture(duration_s=duration_s, hz=hz)

    def rpc_stack_dump(self, conn):
        """All-thread stacks from the head process (hang forensics)."""
        return forensics.all_thread_stacks()

    def _public_node(self, node_id: str) -> Dict[str, Any]:
        n = self._nodes[node_id]
        return {
            "node_id": node_id,
            "address": n["address"],
            "resources_total": n["resources_total"],
            "labels": n.get("labels", {}),
            "alive": n["alive"],
            "pending_leases": n.get("pending_leases", 0),
            "active_leases": n.get("active_leases", 0),
            "pending_shapes": n.get("pending_shapes", []),
        }

    def _health_loop(self) -> None:
        while not self._stopped.wait(config.health_check_period_s):
            if self._recovering:
                continue  # reconciliation window: agents get time to return
            now = time.monotonic()
            dead = []
            with self._lock:
                for nid, n in self._nodes.items():
                    if n["alive"] and now - n["last_heartbeat"] > config.health_check_timeout_s:
                        dead.append(nid)
                n_dead = sum(
                    1 for n in self._nodes.values() if not n["alive"]
                ) + len(dead)
            if core_metrics.ENABLED:
                core_metrics.cluster_nodes_dead.set(float(n_dead))
            for nid in dead:
                logger.warning("node %s missed heartbeats; marking dead", nid[:8])
                self._mark_node_dead(nid, "heartbeat timeout")

    def _mark_node_dead(self, node_id: str, reason: str,
                        only_if_unreconciled: bool = False) -> None:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or not node["alive"]:
                return
            if only_if_unreconciled and node.get("reconciled", True):
                return  # re-attached between the stale scan and this call
            self._apply("node_dead", node_id)
            self._view_version += 1
            affected_actors = [
                a["actor_id"] for a in self._actors.values()
                if a.get("node_id") == node_id
                and a["state"] in (ActorState.ALIVE, ActorState.PENDING_CREATION)
            ]
            # PGs with a bundle on the dead node drop ONLY the lost bundle
            # locations and go back to PENDING for partial re-placement
            # (reference: GcsPlacementGroupManager reschedules on node
            # death); survivors' bundles — and the actors in them — keep
            # running. Without this, leases against the PG fail forever
            # with "bundle not found".
            replaced_pgs = []
            for pg in self._pgs.values():
                if pg["state"] != PGState.CREATED:
                    continue
                lost = [
                    i for i, nid in pg["bundle_locations"].items()
                    if nid == node_id
                ]
                if lost:
                    self._apply("pg_drop_locations", pg["pg_id"], lost)
                    self._apply(
                        "pg_update", pg["pg_id"], {"state": PGState.PENDING}
                    )
                    replaced_pgs.append(pg["pg_id"])
        self.publish("node", {"event": "removed", "node_id": node_id, "reason": reason})
        for actor_id in affected_actors:
            self._on_actor_worker_lost(actor_id, f"node died: {reason}")
        for pg_id in replaced_pgs:
            self._sched_enqueue(("pg", pg_id))

    # ------------------------------------------------------------------
    # jobs
    # ------------------------------------------------------------------

    def rpc_register_job(self, conn, driver_address: str, metadata: Dict[str, Any]):
        with self._lock:
            return self._apply("job_add", driver_address, metadata, time.time())

    def rpc_finish_job(self, conn, job_id: str):
        with self._lock:
            if job_id in self._jobs:
                self._apply("job_finish", job_id, time.time())
        # Non-detached actors owned by the job die with it.
        with self._lock:
            doomed = [
                a["actor_id"] for a in self._actors.values()
                if a.get("job_id") == job_id
                and a.get("lifetime") != "detached"
                and a["state"] not in (ActorState.DEAD,)
            ]
        self._kill_actors_internal(doomed, "job finished", no_restart=True)
        return True

    def rpc_list_jobs(self, conn):
        with self._lock:
            return list(self._jobs.values())

    # ------------------------------------------------------------------
    # actors (reference C2: GcsActorManager + GcsActorScheduler)
    # ------------------------------------------------------------------

    def rpc_register_actor(self, conn, spec: Dict[str, Any]):
        """Register + asynchronously schedule an actor.

        spec: actor_id, job_id, class_blob_key, init args (by value or refs),
        resources, name/namespace, lifetime, max_restarts, max_concurrency,
        scheduling_strategy, owner_address.
        """
        with self._lock:
            err = self._register_actor_locked(spec)
        if err is not None:
            raise ValueError(err)
        self._sched_enqueue(("actor", spec["actor_id"]))
        return True

    def rpc_register_actors(self, conn, specs: List[Dict[str, Any]]):
        """Bulk registration (ISSUE 14): one RPC + ONE dispatcher wakeup
        for a whole batch of actor specs. Results are per-record — a bad
        spec (e.g. name conflict) reports its error without poisoning its
        siblings. Each record still logs an individual `actor_register`
        WAL op through _apply, so replay is identical whether specs
        arrived batched or one at a time."""
        results: List[Dict[str, Any]] = []
        accepted: List[str] = []
        with self._lock:
            for spec in specs:
                try:
                    err = self._register_actor_locked(spec)
                except Exception as e:  # noqa: BLE001 — malformed spec
                    err = f"{type(e).__name__}: {e}"
                if err is None:
                    accepted.append(spec["actor_id"])
                    results.append({"actor_id": spec.get("actor_id"), "ok": True})
                else:
                    results.append({
                        "actor_id": spec.get("actor_id"), "ok": False,
                        "error": err,
                    })
        if accepted:
            self._sched_enqueue(("actors", accepted))
        return results

    def _register_actor_locked(self, spec: Dict[str, Any]) -> Optional[str]:
        """Validate + apply one registration under the store lock. Returns
        an error string (None = registered). Re-registering an existing
        actor_id is idempotent-ok, so a retried batch cannot fail on the
        records its first attempt already landed."""
        actor_id = spec["actor_id"]
        if actor_id in self._actors:
            return None  # duplicate delivery of a retried batch
        name = spec.get("name")
        ns = spec.get("namespace", "default")
        if name:
            key = (ns, name)
            if key in self._named_actors:
                existing = self._named_actors[key]
                if self._actors[existing]["state"] != ActorState.DEAD:
                    return (
                        f"actor name {name!r} already taken in namespace {ns!r}"
                    )
        record = {
            **spec,
            "state": ActorState.PENDING_CREATION,
            "num_restarts": 0,
            "node_id": None,
            "worker_address": None,
            "death_cause": None,
        }
        self._apply("actor_register", record)
        return None

    # -- scheduling queue (reference: GcsActorScheduler + PG scheduler on
    # -- the GCS io-service; one dispatcher, async RPC continuations) ----

    def _sched_enqueue(self, item: tuple) -> None:
        # queue entries carry their enqueue time so the dispatcher can
        # report queue-wait (rt_sched_dispatch_latency_s) — the "which
        # queue is the bottleneck" signal at pod scale
        self._sched_q.put((time.monotonic(), item))
        if core_metrics.ENABLED:
            core_metrics.sched_queue_depth.set(self._sched_q.qsize())

    def _sched_retry(self, item: tuple, key: tuple) -> None:
        """Re-enqueue after this key's (exponential, capped) backoff.
        The 10s cap is a background anti-entropy poll, not the wake-up
        path: capacity_freed kicks requeue parked items the moment a
        lease frees, so thousands of unplaceable actors idle at ~0.1
        pass/s each instead of hammering the dispatcher at the old 2s
        cap (0.5 pass/s x 2000 pending saturated it)."""
        with self._sched_retry_lock:
            backoff = self._sched_backoff.get(key, 0.05)
            self._sched_backoff[key] = min(backoff * 2, 10.0)
            heapq.heappush(
                self._sched_retries,
                (time.monotonic() + backoff, next(self._sched_seq), item),
            )

    def _sched_kick(self) -> None:
        """Cluster capacity changed (node joined / lease freed / worker
        spawned): retry everything now, and reset the kicked keys' backoff
        so a retry that races the freed capacity (e.g. replacement worker
        still booting) re-polls at 50ms instead of the 2s cap."""
        with self._sched_retry_lock:
            items = [it for _, _, it in self._sched_retries]
            self._sched_retries.clear()
            for it in items:
                # HALVE (not clear) the backoff: the kick itself is the
                # immediate retry, and a later capacity event kicks again
                # — but a permanently-unplaceable item on a high-churn
                # cluster must keep re-climbing toward the cap instead of
                # running a full placement pass per kick at the 50ms floor
                key = tuple(it[:2])
                if key in self._sched_backoff:
                    self._sched_backoff[key] = max(
                        0.05, self._sched_backoff[key] / 2
                    )
        for it in items:
            self._sched_enqueue(it)

    def _sched_purge(self, keys: set) -> None:
        """Drop parked retry entries (and backoff state) for keys whose
        entities just died. Without this a bulk kill leaves thousands of
        dead actors' entries in the retry heap, and every subsequent
        capacity kick (each lease grant/release fires one) re-enqueues
        the whole pile — unrelated work (e.g. a PG bench right after a
        kill drain) then queues FIFO behind hundreds of thousands of
        no-op placement passes."""
        with self._sched_retry_lock:
            if self._sched_retries:
                kept = [
                    e for e in self._sched_retries
                    if tuple(e[2][:2]) not in keys
                ]
                if len(kept) != len(self._sched_retries):
                    self._sched_retries[:] = kept
                    heapq.heapify(self._sched_retries)
            for key in keys:
                self._sched_backoff.pop(key, None)

    def _sched_loop(self) -> None:
        while not self._stopped.is_set():
            now = time.monotonic()
            ready = []
            with self._sched_retry_lock:
                while self._sched_retries and self._sched_retries[0][0] <= now:
                    _, _, item = heapq.heappop(self._sched_retries)
                    ready.append(item)
                timeout = 0.5
                if self._sched_retries:
                    timeout = min(timeout, self._sched_retries[0][0] - now)
            for item in ready:
                self._sched_enqueue(item)
            try:
                enq_ts, item = self._sched_q.get(timeout=max(timeout, 0.005))
            except queue.Empty:
                continue
            # Pipelined drain (ISSUE 14): take everything already queued
            # in the same pass instead of one wakeup per item — under a
            # burst (bulk register, mass kill) the per-wakeup overhead
            # (metrics, retry-heap scan, queue round trip) amortizes over
            # the burst instead of multiplying with it.
            batch = [(enq_ts, item)]
            while len(batch) < _SCHED_DRAIN_MAX:
                try:
                    batch.append(self._sched_q.get_nowait())
                except queue.Empty:
                    break
            if core_metrics.ENABLED:
                core_metrics.sched_queue_depth.set(self._sched_q.qsize())
                now = time.monotonic()
                for enq_ts, item in batch:
                    core_metrics.sched_dispatch_latency_s.observe(
                        now - enq_ts, tags={"kind": str(item[0])}
                    )
            for _, item in batch:
                try:
                    self._process_sched(item)
                except Exception:  # noqa: BLE001 — scheduler must survive
                    logger.exception("scheduler item %r failed", item)
                    # never DROP a pending entity on a scheduling crash:
                    # retry with the key's backoff (capped), so a transient
                    # error (node died mid-pass) can't orphan an actor/PG
                    if item and item[0] in ("actor", "pg"):
                        self._sched_retry(item, tuple(item[:2]))
                    elif item and item[0] == "actors":
                        for aid in item[1]:
                            self._sched_retry(("actor", aid), ("actor", aid))

    def _process_sched(self, item: tuple) -> None:
        kind = item[0]
        if self._recovering and kind in ("actor", "pg", "actors"):
            # reconciliation window: placement decisions wait until live
            # agents have re-asserted their leases/bundles — scheduling
            # against a half-reconciled view would double-place actors
            if kind == "actors":
                for aid in item[1]:
                    self._sched_retry(("actor", aid), ("actor", aid))
            else:
                self._sched_retry(item, tuple(item[:2]))
            return
        if kind == "actor":
            self._sched_actor_place(item[1])
        elif kind == "actors":
            # batched arrival (rpc_register_actors): one wakeup schedules
            # the whole batch. Cap the async lease fan-out per pass — each
            # fired place spawns a handler thread agent-side — and park
            # the overflow in the retry heap, where capacity kicks and
            # lease completions pull it forward (today's steady state).
            ids = item[1]
            for aid in ids[:_SCHED_BATCH_FANOUT]:
                self._sched_actor_place(aid)
            for aid in ids[_SCHED_BATCH_FANOUT:]:
                self._sched_retry(("actor", aid), ("actor", aid))
        elif kind == "actor_lease":
            self._sched_actor_leased(*item[1:])
        elif kind == "actor_created":
            self._sched_actor_created(*item[1:])
        elif kind == "pg":
            pg_id = item[1]
            with self._lock:
                if pg_id in self._pg_running:
                    # a pass for this PG is already on the pool: coalesce
                    # (it re-enqueues itself on progress/backoff)
                    self._sched_retry(("pg", pg_id), ("pg", pg_id))
                    return
                self._pg_running.add(pg_id)

            def run(pg_id=pg_id):
                again = False
                try:
                    again = bool(self._schedule_pg_once(pg_id))
                finally:
                    with self._lock:
                        self._pg_running.discard(pg_id)
                    if again:
                        # enqueue only AFTER leaving _pg_running: enqueueing
                        # inside the pass would hit the coalesce branch and
                        # defer the (usually final) CREATED transition by a
                        # backoff cycle
                        self._sched_enqueue(("pg", pg_id))

            self._pg_pool.submit(run)
        elif kind == "kick":
            self._sched_kick()

    def _sched_actor_place(self, actor_id: str) -> None:
        """Step 1: pick a node and fire an async lease request."""
        with self._lock:
            record = self._actors.get(actor_id)
            if record is None or record["state"] in (
                ActorState.DEAD, ActorState.ALIVE,
            ):
                return
            view = self._cluster_view_locked()
            strategy = record.get("scheduling_strategy")
            resources = record.get("resources", {})
        node_id = scheduling.pick_node(
            view, resources, strategy, self._pgs, self._lock
        )
        if node_id is None or node_id not in view:
            # not in view: a PG-bundle pick can name a node that died
            # after the snapshot — retry (the PG re-places its bundle)
            # rather than KeyError-ing the item out of the queue
            self._sched_retry(("actor", actor_id), ("actor", actor_id))
            return
        agent_addr = view[node_id]["address"]
        try:
            pend = self._agents.get(agent_addr).call_async(
                "lease_worker",
                resources=resources,
                bundle=scheduling.pg_bundle_of(strategy),
                wait_s=0.0,
                # actor leases are store-managed: a transient store->agent
                # reconnect must not reap every actor on the node
                bind_to_conn=False,
                runtime_env=record.get("runtime_env"),
                # this node was picked from the GLOBAL view above; the
                # agent re-consulting the store for spillback would turn
                # a capacity-freed retry burst into a get_cluster_view
                # storm that parks every other RPC behind it
                spillback=False,
            )
        except RpcError as e:
            logger.warning(
                "actor %s lease on %s failed: %s", actor_id[:8], node_id[:8], e
            )
            self._sched_retry(("actor", actor_id), ("actor", actor_id))
            return
        pend.add_done_callback(
            lambda p: self._sched_enqueue(
                ("actor_lease", actor_id, node_id, agent_addr, p)
            )
        )

    def _sched_actor_leased(self, actor_id, node_id, agent_addr, pend) -> None:
        """Step 2: lease reply arrived; fire async actor creation."""
        try:
            lease = pend.wait(0)
        except RpcError as e:
            logger.warning("actor %s lease failed: %s", actor_id[:8], e)
            self._sched_retry(("actor", actor_id), ("actor", actor_id))
            return
        if not lease.get("granted"):
            self._sched_retry(("actor", actor_id), ("actor", actor_id))
            return
        worker_addr = lease["worker_address"]
        with self._lock:
            record = self._actors.get(actor_id)
            if record is None or record["state"] == ActorState.DEAD:
                # killed while scheduling; return the lease
                try:
                    self._agents.get(agent_addr).call_oneway(
                        "release_worker", lease_id=lease["lease_id"], kill=False
                    )
                except RpcError:
                    pass
                return
            spec = dict(record)
        try:
            pend2 = self._workers.get(worker_addr).call_async(
                "create_actor", spec=spec
            )
        except RpcError as e:
            logger.warning(
                "actor %s creation on %s failed: %s", actor_id[:8], worker_addr, e
            )
            try:
                self._agents.get(agent_addr).call_oneway(
                    "release_worker", lease_id=lease["lease_id"], kill=True
                )
            except RpcError:
                pass
            self._sched_retry(("actor", actor_id), ("actor", actor_id))
            return
        pend2.add_done_callback(
            lambda p: self._sched_enqueue(
                ("actor_created", actor_id, node_id, agent_addr, lease, p)
            )
        )

    def _sched_actor_created(
        self, actor_id, node_id, agent_addr, lease, pend
    ) -> None:
        """Step 3: creation reply arrived; finalize ALIVE/DEAD/retry."""
        try:
            created = pend.wait(0)
        except RpcError as e:
            # transport failure: worker unusable, retry elsewhere
            logger.warning(
                "actor %s creation push failed: %s", actor_id[:8], e
            )
            try:
                self._agents.get(agent_addr).call_oneway(
                    "release_worker", lease_id=lease["lease_id"], kill=True
                )
            except RpcError:
                pass
            self._sched_retry(("actor", actor_id), ("actor", actor_id))
            return
        if not created.get("ok"):
            # __init__ raised: permanent, surface the error to callers
            try:
                self._agents.get(agent_addr).call_oneway(
                    "release_worker", lease_id=lease["lease_id"], kill=True
                )
            except RpcError:
                pass
            with self._lock:
                if actor_id in self._actors:
                    self._apply("actor_update", actor_id, {
                        "state": ActorState.DEAD,
                        "death_cause": str(created.get("error")),
                    })
            self._sched_backoff.pop(("actor", actor_id), None)
            self.publish(f"actor:{actor_id}", self._public_actor(actor_id))
            self.publish("actor", self._public_actor(actor_id))
            return
        with self._lock:
            record = self._actors.get(actor_id)
            if record is None:
                return
            if record["state"] == ActorState.DEAD:
                # killed while the creation push was in flight: the reply
                # must NOT resurrect it — tear the fresh worker down
                # (kill_actor found no worker_address to clean up yet)
                dead = True
            else:
                dead = False
                self._apply("actor_update", actor_id, {
                    "state": ActorState.ALIVE,
                    "node_id": node_id,
                    "worker_address": lease["worker_address"],
                    "lease_id": lease["lease_id"],
                    "agent_address": agent_addr,
                })
        if dead:
            try:
                self._agents.get(agent_addr).call_oneway(
                    "release_worker", lease_id=lease["lease_id"], kill=True
                )
            except RpcError:
                pass
            return
        self._sched_backoff.pop(("actor", actor_id), None)
        self.publish(f"actor:{actor_id}", self._public_actor(actor_id))
        self.publish("actor", self._public_actor(actor_id))

    def rpc_get_actor_info(self, conn, actor_id: str):
        with self._lock:
            if actor_id not in self._actors:
                return None
            return self._public_actor(actor_id)

    def rpc_wait_actor_alive(self, conn, actor_id: str, wait_s: float = 60.0):
        # sliced server-side: clients loop (worker._resolve_actor_address)
        wait_s = min(wait_s, float(config.dispatch_wait_slice_s))
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            with self._lock:
                record = self._actors.get(actor_id)
                if record is None:
                    return None
                if record["state"] in (ActorState.ALIVE, ActorState.DEAD):
                    return self._public_actor(actor_id)
            time.sleep(0.02)
        with self._lock:
            return self._public_actor(actor_id) if actor_id in self._actors else None

    def rpc_get_named_actor(self, conn, name: str, namespace: str = "default"):
        with self._lock:
            actor_id = self._named_actors.get((namespace, name))
            if actor_id is None:
                return None
            record = self._actors.get(actor_id)
            if record is None or record["state"] == ActorState.DEAD:
                return None
            return self._public_actor(actor_id)

    def rpc_list_actors(self, conn):
        with self._lock:
            return [self._public_actor(aid) for aid in self._actors]

    def rpc_report_actor_death(self, conn, actor_id: str, reason: str,
                               expected: bool = False):
        """Called by agents/workers when an actor's worker process exits."""
        if expected:
            self._kill_actor_internal(actor_id, reason, no_restart=True)
        else:
            self._on_actor_worker_lost(actor_id, reason)
        return True

    def rpc_report_worker_failure(self, conn, worker_address: str, node_id: str,
                                  reason: str):
        """A worker process died; fail over any actor it hosted."""
        with self._lock:
            affected = [
                a["actor_id"] for a in self._actors.values()
                if a.get("worker_address") == worker_address
                and a["state"] in (ActorState.ALIVE, ActorState.PENDING_CREATION)
            ]
        self._workers.drop(worker_address)
        for actor_id in affected:
            self._on_actor_worker_lost(actor_id, reason)
        self.publish("worker", {"event": "died", "worker_address": worker_address,
                                "node_id": node_id, "reason": reason})
        return True

    def rpc_kill_actor(self, conn, actor_id: str, no_restart: bool = True):
        self._kill_actor_internal(actor_id, "ray_tpu_torch.kill", no_restart=no_restart)
        return True

    def rpc_kill_actors(self, conn, actor_ids: List[str],
                        no_restart: bool = True):
        """Bulk kill (ISSUE 14): one lock pass applies every DEAD
        transition (the `actor_update` mutations batch under a single
        lock acquisition), then teardown RPCs fan out across node agents
        on the bounded kill pool instead of the serial per-actor loop.
        Per-record results; unknown/already-dead ids report ok (a retried
        batch must be idempotent)."""
        results = self._kill_actors_internal(
            actor_ids, "ray_tpu_torch.kill", no_restart=no_restart
        )
        return results

    def _kill_actors_internal(self, actor_ids: List[str], reason: str,
                              no_restart: bool) -> List[Dict[str, Any]]:
        results: List[Dict[str, Any]] = []
        doomed: List[Tuple[str, Any, Any, Any]] = []
        with self._lock:
            for actor_id in actor_ids:
                record = self._actors.get(actor_id)
                if record is None or record["state"] == ActorState.DEAD:
                    results.append(
                        {"actor_id": actor_id, "ok": True, "changed": False}
                    )
                    continue
                if no_restart:
                    self._apply("actor_update", actor_id, {
                        "state": ActorState.DEAD, "death_cause": reason,
                    })
                doomed.append((
                    actor_id,
                    record.get("worker_address"),
                    record.get("agent_address"),
                    record.get("lease_id"),
                ))
                results.append(
                    {"actor_id": actor_id, "ok": True, "changed": True}
                )
        if no_restart:
            self._sched_purge({("actor", a) for a in actor_ids})
        self._teardown_workers(doomed)
        for actor_id, _, _, _ in doomed:
            if no_restart:
                self.publish(f"actor:{actor_id}", self._public_actor(actor_id))
                self.publish("actor", self._public_actor(actor_id))
            else:
                self._on_actor_worker_lost(actor_id, reason)
        return results

    def _teardown_workers(
        self, doomed: List[Tuple[str, Any, Any, Any]]
    ) -> None:
        """Fan worker teardown out on the bounded kill pool: one
        exit_worker oneway per worker, and the lease releases GROUPED per
        agent into one bulk release_workers RPC. The submitting thread
        never waits on an agent — in-flight is bounded by the pool size
        (config.actor_kill_fanout), and a hung agent costs one pool slot
        for the call timeout, not the whole drain."""
        by_agent: Dict[str, List[str]] = {}
        for _actor_id, worker_addr, agent_addr, lease_id in doomed:
            if worker_addr:
                self._submit_teardown(self._exit_worker_quiet, worker_addr)
            if agent_addr and lease_id:
                by_agent.setdefault(agent_addr, []).append(lease_id)
        for agent_addr, lease_ids in by_agent.items():
            self._submit_teardown(
                self._release_leases_quiet, agent_addr, lease_ids
            )

    def _submit_teardown(self, fn, *args) -> None:
        try:
            self._kill_pool.submit(fn, *args)
        except RuntimeError:  # pool shut down: store is stopping
            pass

    def _exit_worker_quiet(self, worker_addr: str) -> None:
        try:
            self._workers.get(worker_addr).call_oneway("exit_worker")
        except RpcError:
            pass
        self._workers.drop(worker_addr)

    def _release_leases_quiet(self, agent_addr: str, lease_ids: List[str]) -> None:
        try:
            self._agents.get(agent_addr).call(
                "release_workers", lease_ids=lease_ids, kill=True,
                timeout_s=10.0,
            )
        except RpcError as e:
            # agent dead/hung: its health-check death reaps the leases
            logger.warning(
                "bulk release of %d lease(s) on %s failed: %s",
                len(lease_ids), agent_addr, e,
            )

    def rpc_actor_handle_dropped(self, conn, actor_id: str):
        """The original handle went out of scope: GC the actor unless it is
        detached (parity: GcsActorManager handle-count GC)."""
        with self._lock:
            record = self._actors.get(actor_id)
            if record is None or record.get("lifetime") == "detached":
                return False
        self._kill_actor_internal(
            actor_id, "all handles to the actor went out of scope",
            no_restart=True,
        )
        return True

    def _kill_actor_internal(self, actor_id: str, reason: str, no_restart: bool) -> None:
        with self._lock:
            record = self._actors.get(actor_id)
            if record is None or record["state"] == ActorState.DEAD:
                return
            worker_addr = record.get("worker_address")
            agent_addr = record.get("agent_address")
            lease_id = record.get("lease_id")
            if no_restart:
                self._apply("actor_update", actor_id, {
                    "state": ActorState.DEAD, "death_cause": reason,
                })
        if no_restart:
            self._sched_purge({("actor", actor_id)})
        if worker_addr:
            try:
                self._workers.get(worker_addr).call_oneway("exit_worker")
            except RpcError:
                pass
            self._workers.drop(worker_addr)
        if agent_addr and lease_id:
            try:
                self._agents.get(agent_addr).call_oneway(
                    "release_worker", lease_id=lease_id, kill=True
                )
            except RpcError:
                pass
        if no_restart:
            self.publish(f"actor:{actor_id}", self._public_actor(actor_id))
            self.publish("actor", self._public_actor(actor_id))
        else:
            self._on_actor_worker_lost(actor_id, reason)

    def _on_actor_worker_lost(self, actor_id: str, reason: str) -> None:
        """Restart-or-die decision (reference gcs_actor_manager.cc:1477)."""
        with self._lock:
            record = self._actors.get(actor_id)
            if record is None or record["state"] == ActorState.DEAD:
                return
            max_restarts = record.get("max_restarts", 0)
            if max_restarts == -1 or record["num_restarts"] < max_restarts:
                self._apply("actor_update", actor_id, {
                    "num_restarts": record["num_restarts"] + 1,
                    "state": ActorState.RESTARTING,
                    "worker_address": None,
                    "node_id": None,
                })
                restart = True
            else:
                self._apply("actor_update", actor_id, {
                    "state": ActorState.DEAD, "death_cause": reason,
                })
                restart = False
        if not restart:
            self._sched_purge({("actor", actor_id)})
        self.publish(f"actor:{actor_id}", self._public_actor(actor_id))
        self.publish("actor", self._public_actor(actor_id))
        if restart:
            self._sched_enqueue(("actor", actor_id))

    def _public_actor(self, actor_id: str) -> Dict[str, Any]:
        r = self._actors[actor_id]
        return {
            "actor_id": actor_id,
            "state": r["state"],
            "node_id": r.get("node_id"),
            "worker_address": r.get("worker_address"),
            "name": r.get("name"),
            "namespace": r.get("namespace", "default"),
            "class_name": r.get("class_name"),
            "method_names": r.get("method_names", []),
            "num_restarts": r.get("num_restarts", 0),
            "max_restarts": r.get("max_restarts", 0),
            "max_task_retries": r.get("max_task_retries", 0),
            "death_cause": r.get("death_cause"),
            "job_id": r.get("job_id"),
            "lifetime": r.get("lifetime"),
        }

    # ------------------------------------------------------------------
    # placement groups (reference C3: 2PC prepare/commit)
    # ------------------------------------------------------------------

    def rpc_create_placement_group(self, conn, pg_id: str, bundles: List[Dict[str, float]],
                                   strategy: str, name: Optional[str] = None,
                                   job_id: Optional[str] = None):
        with self._lock:
            self._apply("pg_add", {
                "pg_id": pg_id,
                "bundles": bundles,
                "strategy": strategy,
                "name": name,
                "job_id": job_id,
                "state": PGState.PENDING,
                # bundle index -> node_id hex
                "bundle_locations": {},
            })
        self._sched_enqueue(("pg", pg_id))
        return True

    def _schedule_pg_once(self, pg_id: str) -> bool:
        """One placement pass of a PG's missing bundles via 2PC (runs on
        the scheduler thread; infeasible/failed passes re-enqueue with
        backoff instead of parking a thread). Returns True when the caller
        should run another pass immediately (progress was made).

        Handles partial placement: only indices absent from
        bundle_locations are placed, so node-death recovery re-places the
        lost bundles while surviving bundles (and the actors in them) keep
        running — mirroring the reference GcsPlacementGroupManager's
        rescheduling of individual bundles.
        """
        key = ("pg", pg_id)
        with self._lock:
            pg = self._pgs.get(pg_id)
            if pg is None or pg["state"] in (PGState.CREATED, PGState.REMOVED):
                self._sched_backoff.pop(key, None)
                return
            bundles = pg["bundles"]
            strategy = pg["strategy"]
            locations = {int(k): v for k, v in pg["bundle_locations"].items()}
            view = self._cluster_view_locked()
        missing = [i for i in range(len(bundles)) if i not in locations]
        if not missing:
            with self._lock:
                pg = self._pgs.get(pg_id)
                if pg is None or pg["state"] == PGState.REMOVED:
                    return
                self._apply("pg_update", pg_id, {"state": PGState.CREATED})
                self._pg_cv.notify_all()
            self._sched_backoff.pop(key, None)
            self.publish(f"pg:{pg_id}", {"pg_id": pg_id, "state": PGState.CREATED})
            return
        place_view = view
        if strategy == "STRICT_SPREAD" and locations:
            survivors = set(locations.values())
            place_view = {
                nid: n for nid, n in view.items() if nid not in survivors
            }
        sub = scheduling.place_bundles(
            place_view, [bundles[i] for i in missing], strategy
        )
        if sub is None:
            self._sched_retry(("pg", pg_id), key)
            return
        placement = {missing[pos]: nid for pos, nid in sub.items()}
        # Phase 1: PREPARE on every involved agent.
        by_node: Dict[str, List[int]] = {}
        for idx, node_id in placement.items():
            by_node.setdefault(node_id, []).append(idx)
        ok = True
        for node_id, idxs in by_node.items():
            addr = view[node_id]["address"]
            try:
                res = self._agents.get(addr).call(
                    "prepare_bundles", pg_id=pg_id,
                    bundles={i: bundles[i] for i in idxs},
                )
            except RpcError:
                res = False
            if not res:
                ok = False
                break
        if not ok:
            # Roll back EVERY node in the attempted placement (by its
            # attempted indices), not just the ones that acked prepare:
            # a node whose prepare reply was lost may still hold the
            # reservation, and return_bundles on a node that never
            # prepared those indices is a no-op. Synchronous call so a
            # retried placement can't race its own rollback.
            self._rollback_bundles(view, by_node, pg_id)
            self._sched_retry(("pg", pg_id), key)
            return
        # Phase 2: COMMIT. A node that misses COMMIT would refuse
        # bundle leases forever (raylet requires state=="committed"),
        # so any commit failure rolls this placement back and retries.
        commit_ok = True
        for node_id, idxs in by_node.items():
            try:
                res = self._agents.get(view[node_id]["address"]).call(
                    "commit_bundles", pg_id=pg_id
                )
            except RpcError:
                res = False
            if not res:
                logger.warning("pg %s commit failed on %s", pg_id[:8], node_id[:8])
                commit_ok = False
        if not commit_ok:
            self._rollback_bundles(view, by_node, pg_id)
            self._sched_retry(("pg", pg_id), key)
            return
        with self._lock:
            pg = self._pgs.get(pg_id)
            if pg is None:
                return False
            self._apply("pg_merge_locations", pg_id, placement)
        # go around once more: recompute missing (usually empty -> CREATED)
        return True

    def _rollback_bundles(
        self, view, by_node: Dict[str, List[int]], pg_id: str
    ) -> None:
        """Synchronously return the given bundle indices on each node (a
        one-way send could race a subsequent re-placement's prepare)."""
        for node_id, idxs in by_node.items():
            try:
                self._agents.get(view[node_id]["address"]).call(
                    "return_bundles", pg_id=pg_id, idxs=idxs
                )
            except RpcError:
                pass

    def rpc_get_placement_group(self, conn, pg_id: str):
        with self._lock:
            pg = self._pgs.get(pg_id)
            return dict(pg) if pg else None

    def rpc_wait_placement_group(self, conn, pg_id: str, wait_s: float = 60.0):
        # sliced server-side: clients loop (placement.PlacementGroup.wait)
        wait_s = min(wait_s, float(config.dispatch_wait_slice_s))
        deadline = time.monotonic() + wait_s
        with self._lock:
            while True:
                pg = self._pgs.get(pg_id)
                if pg is None:
                    return None
                if pg["state"] in (PGState.CREATED, PGState.REMOVED):
                    return dict(pg)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return dict(pg)
                # CV, not a sleep-poll: a poll interval quantizes EVERY
                # wait that arrives before the 2PC finishes to a full
                # tick (200 PGs x 20ms was half the many-PGs bench)
                self._pg_cv.wait(remaining)

    def rpc_remove_placement_group(self, conn, pg_id: str):
        with self._lock:
            pg = self._pgs.get(pg_id)
            if pg is None:
                return False
            self._apply("pg_update", pg_id, {"state": PGState.REMOVED})
            self._pg_cv.notify_all()
            locations = dict(pg["bundle_locations"])
            view = self._cluster_view_locked()
        for node_id in set(locations.values()):
            node = view.get(node_id)
            if node:
                try:
                    self._agents.get(node["address"]).call_oneway(
                        "return_bundles", pg_id=pg_id
                    )
                except RpcError:
                    pass
        self.publish(f"pg:{pg_id}", {"pg_id": pg_id, "state": PGState.REMOVED})
        return True

    def rpc_list_placement_groups(self, conn):
        with self._lock:
            return [dict(pg) for pg in self._pgs.values()]

    # ------------------------------------------------------------------

    def _cluster_view_locked(self) -> Dict[str, Dict[str, Any]]:
        return {
            nid: {
                "address": n["address"],
                "resources_total": n["resources_total"],
                "resources_available": n["resources_available"],
                "labels": n.get("labels", {}),
                "alive": True,
            }
            for nid, n in self._nodes.items()
            if n["alive"]
        }

"""Serve controller — desired-state reconciler.

Parity: the reference ServeController actor
(python/ray/serve/_private/controller.py:123) with its
DeploymentStateManager reconcile loop (deployment_state.py:2203,3627),
SLO-driven autoscaling (serve/autoscale/policy.py replaces the naive
requests-per-replica count), and replica health checking. Routing
tables are served with a version number so routers poll cheaply
(long-poll-lite, reference long_poll.py:253).

Scale-down is session-aware: a victim replica moves to the
deployment's ``draining`` set — out of the routing table (the HRW
session router re-pins its sessions to survivors on the next refresh)
but still probed — and is killed only once its in-flight work,
streaming included, hits zero (plus a settle period covering requests
already routed) or the drain deadline fires.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.replica import ServeReplica

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "SERVE_CONTROLLER"
RECONCILE_PERIOD_S = 0.5
# A drained replica must stay up at least this long after leaving the
# table: routers refresh within ROUTE_REFRESH_S (1 s) and requests they
# routed in the stale window still have to land and count in the next
# health probe before "ongoing == 0" means quiescent.
DRAIN_SETTLE_S = 2.0


@ray_tpu_torch.remote
class ServeController:
    def __init__(self, http_port: Optional[int] = None):
        # name -> deployment record
        self._deployments: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._version = 0
        self._http_port = http_port
        self._proxies: Dict[str, Any] = {}  # node_id -> proxy handle
        self._policy = None  # SLOPolicy, built lazily on first tick
        self._collector = None  # SignalCollector, ditto
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._reconcile_loop, name="serve-reconcile", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------
    # control API
    # ------------------------------------------------------------------

    def deploy(
        self,
        name: str,
        callable_blob: bytes,
        init_args: tuple,
        init_kwargs: dict,
        num_replicas: int,
        route_prefix: Optional[str],
        max_concurrency: int,
        autoscaling: Optional[Dict[str, Any]],
        resources: Optional[Dict[str, float]],
        max_queued_requests: Optional[int] = None,
    ) -> bool:
        old_replicas = []
        with self._lock:
            existing = self._deployments.get(name)
            next_replica = 0
            if existing is not None:
                # Redeploy: new code/config replaces the old replicas.
                # Keep the replica counter so actor names never collide,
                # and kill the old replicas (outside the lock) so the
                # reconciler starts fresh ones from the new blob.
                next_replica = existing["next_replica"]
                old_replicas = list(existing["replicas"].values())
                old_replicas.extend(existing["draining"].values())
            self._deployments[name] = {
                "name": name,
                "callable_blob": callable_blob,
                "init_args": init_args,
                "init_kwargs": init_kwargs,
                "target_replicas": num_replicas,
                "route_prefix": route_prefix or f"/{name}",
                "max_concurrency": max_concurrency,
                # {min_replicas, max_replicas, target_ongoing_requests}
                "autoscaling": autoscaling,
                "resources": resources or {},
                # per-deployment proxy admission bound (None = global
                # RT_SERVE_ADMISSION_MAX_INFLIGHT); ships in the routing
                # table so every proxy enforces it without a config hop
                "max_queued_requests": max_queued_requests,
                "replicas": {},  # replica_id -> {handle, healthy}
                "stats": {},  # replica_id -> last stats
                # replica_id -> {handle, handle_info, since, deadline,
                # ongoing}: out of the table, finishing live streams
                "draining": {},
                "drain_deadline_s": None,  # per-deployment override
                "last_decision": None,  # last up/down autoscale decision
                "last_signals": None,  # most recent Signals.describe()
                "next_replica": next_replica,
                "deleting": False,
            }
            self._version += 1
        if self._policy is not None:
            self._policy.forget(name)  # fresh hysteresis for new code
        for rec in old_replicas:
            self._kill_silently(rec["handle"])
        return True

    def delete_deployment(self, name: str) -> bool:
        with self._lock:
            dep = self._deployments.get(name)
            if dep is None:
                return False
            dep["deleting"] = True
            dep["target_replicas"] = 0
            self._version += 1
        if self._policy is not None:
            self._policy.forget(name)
        return True

    def get_routing_table(self, known_version: int = -1, wait_s: float = 0.0):
        """Routing table + version. With wait_s > 0, blocks until the
        TOPOLOGY version changes (long-poll-lite). With wait_s == 0 the
        current table is always returned — replica `ongoing` counts change
        continuously without bumping the version, and routers need them
        fresh (pow-2 would otherwise route on frozen queue lengths).

        The wait is SLICED server-side (dispatcher-block discipline):
        routers re-issue slices forever (router._topology_longpoll), so a
        long caller deadline must not hold an actor thread here."""
        from ray_tpu_torch.utils.config import config

        wait_s = min(wait_s, float(config.dispatch_wait_slice_s))
        deadline = time.monotonic() + wait_s
        while True:
            with self._lock:
                if self._version != known_version or wait_s <= 0:
                    table = {
                        name: {
                            "route_prefix": dep["route_prefix"],
                            "max_queued_requests": dep["max_queued_requests"],
                            "replicas": [
                                {
                                    "replica_id": rid,
                                    "ongoing": dep["stats"].get(rid, {}).get(
                                        "ongoing", 0
                                    ),
                                    "model_ids": dep["stats"].get(
                                        rid, {}
                                    ).get("model_ids", []),
                                    "handle_info": rec["handle_info"],
                                }
                                for rid, rec in dep["replicas"].items()
                                if rec["healthy"]
                            ],
                        }
                        for name, dep in self._deployments.items()
                        if not dep["deleting"]
                    }
                    return {"version": self._version, "table": table}
            if time.monotonic() >= deadline:
                return {"version": known_version, "table": None}
            time.sleep(0.05)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                name: {
                    "target": dep["target_replicas"],
                    "running": sum(
                        1 for r in dep["replicas"].values() if r["healthy"]
                    ),
                    "draining": len(dep["draining"]),
                    "route_prefix": dep["route_prefix"],
                    "autoscaling": dep["autoscaling"],
                    "last_decision": dep["last_decision"],
                }
                for name, dep in self._deployments.items()
            }

    def set_target_replicas(
        self,
        name: str,
        num_replicas: int,
        drain_deadline_s: Optional[float] = None,
    ) -> bool:
        """Manual scale (`serve.scale`). On an autoscaling deployment the
        policy re-evaluates from here next tick; on a manual one this IS
        the desired state. ``drain_deadline_s`` overrides the
        RT_SERVE_AUTOSCALE_DRAIN_DEADLINE_S force-kill bound for this
        deployment's subsequent drains."""
        with self._lock:
            dep = self._deployments.get(name)
            if dep is None or dep["deleting"]:
                return False
            old = dep["target_replicas"]
            dep["target_replicas"] = max(0, int(num_replicas))
            if drain_deadline_s is not None:
                dep["drain_deadline_s"] = float(drain_deadline_s)
            new = dep["target_replicas"]
        if new != old:
            direction = "up" if new > old else "down"
            self._record_decision(name, old, new, direction, "manual")
        return True

    def autoscale_status(self) -> Dict[str, Any]:
        """Control-loop visibility (`state.autoscale_status`, `rt top`):
        per-deployment replica counts, drain progress, the last scale
        decision and the signals behind it."""
        now = time.monotonic()
        with self._lock:
            return {
                name: {
                    "target": dep["target_replicas"],
                    "running": sum(
                        1 for r in dep["replicas"].values() if r["healthy"]
                    ),
                    "draining": {
                        rid: {
                            "ongoing": rec["ongoing"],
                            "age_s": round(now - rec["since"], 3),
                            "deadline_in_s": round(rec["deadline"] - now, 3),
                        }
                        for rid, rec in dep["draining"].items()
                    },
                    "autoscaling": dep["autoscaling"],
                    "last_decision": dep["last_decision"],
                    "last_signals": dep["last_signals"],
                }
                for name, dep in self._deployments.items()
                if not dep["deleting"]
            }

    def ready(self, name: str, timeout_s: float = 60.0) -> bool:
        """Sliced like get_routing_table: returns False at the slice
        bound and clients (serve.run) re-issue until their own
        deadline."""
        from ray_tpu_torch.utils.config import config

        timeout_s = min(timeout_s, float(config.dispatch_wait_slice_s))
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                dep = self._deployments.get(name)
                if dep is not None:
                    healthy = sum(
                        1 for r in dep["replicas"].values() if r["healthy"]
                    )
                    if healthy >= max(1, dep["target_replicas"]):
                        return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)

    def shutdown(self) -> bool:
        self._stop.set()
        with self._lock:
            deps = list(self._deployments.values())
            proxies = list(self._proxies.values())
            self._deployments.clear()
            self._proxies.clear()
        for dep in deps:
            for rec in dep["replicas"].values():
                self._kill_silently(rec["handle"])
            for rec in dep["draining"].values():
                self._kill_silently(rec["handle"])
        for p in proxies:
            self._kill_silently(p)
        return True

    @staticmethod
    def _kill_silently(handle) -> None:
        try:
            ray_tpu_torch.kill(handle)
        except Exception:  # noqa: BLE001
            pass

    # ------------------------------------------------------------------
    # reconcile loop
    # ------------------------------------------------------------------

    def _reconcile_loop(self) -> None:
        from ray_tpu_torch.utils.config import config

        last_autoscale = 0.0
        while not self._stop.wait(RECONCILE_PERIOD_S):
            try:
                self._check_health()
                now = time.monotonic()
                interval = float(config.serve_autoscale_interval_s)
                if now - last_autoscale >= max(interval, RECONCILE_PERIOD_S):
                    self._autoscale()
                    self._publish_status()
                    last_autoscale = now
                self._reconcile()
                self._ensure_proxies()
            except Exception:  # noqa: BLE001 — keep the loop alive
                logger.exception("serve reconcile iteration failed")

    def _check_health(self) -> None:
        """Probe replicas; collect queue stats; drop dead ones.

        Probes hit the hosting worker's RPC layer (rpc_actor_queue_stats),
        NOT the replica's execution queue, so a saturated replica still
        answers instantly and `ongoing` counts queued + running requests —
        the reference replica's out-of-band queue-length probe. Transient
        RPC timeouts tolerate several misses; a dead worker (connection
        refused / actor lookup failure) removes the replica immediately."""
        from ray_tpu_torch.core import worker as worker_mod
        from ray_tpu_torch.core.exceptions import ActorDiedError
        from ray_tpu_torch.utils.rpc import RpcConnectionError, RpcError

        w = worker_mod.global_worker()
        with self._lock:
            probes = [
                (dep, rid, rec, False)
                for dep in self._deployments.values()
                for rid, rec in list(dep["replicas"].items())
            ]
            # draining replicas stay probed: "ongoing == 0" is the drain
            # completion signal, and a drainer that dies mid-drain must
            # be reaped, not waited on until its deadline
            probes.extend(
                (dep, rid, rec, True)
                for dep in self._deployments.values()
                for rid, rec in list(dep["draining"].items())
            )
        for dep, rid, rec, draining in probes:
            dead = False
            try:
                addr = w._resolve_actor_address(
                    rec["handle"]._actor_id, timeout_s=5.0
                )
                stats = w.workers.get(addr).call(
                    "actor_queue_stats", timeout_s=5.0
                )
                if stats is None:
                    raise RpcConnectionError("worker hosts no actor")
                with self._lock:
                    if draining:
                        rec["ongoing"] = stats["queued"] + stats["running"]
                        continue
                    dep["stats"][rid] = {
                        "ongoing": stats["queued"] + stats["running"],
                        "model_ids": stats.get("multiplexed_model_ids", []),
                    }
                    rec["probe_misses"] = 0
                    if not rec["healthy"]:
                        rec["healthy"] = True
                        self._version += 1
                continue
            except ActorDiedError:
                dead = True  # control plane confirms death: remove now
            except RpcConnectionError:
                # connection loss is ambiguous (worker rebinding, network
                # blip, or real death) — weigh it heavier than a timeout
                # but do not kill a healthy replica on one strike. Drop the
                # cached address so the next probe re-resolves: a replica
                # that restarted at a NEW address must not be probed at the
                # old one forever (and a truly dead one resolves to
                # ActorDiedError next round for immediate removal).
                w._actor_addr_cache.pop(rec["handle"]._actor_id, None)
                with self._lock:
                    rec["probe_misses"] = rec.get("probe_misses", 0) + 3
                    dead = rec["probe_misses"] >= 6
            except Exception:  # noqa: BLE001 — slow or dying
                with self._lock:
                    rec["probe_misses"] = rec.get("probe_misses", 0) + 1
                    dead = rec["probe_misses"] >= 6  # ~30s unresponsive
            if not dead:
                continue
            with self._lock:
                if draining:
                    dep["draining"].pop(rid, None)
                else:
                    if rec["healthy"]:
                        rec["healthy"] = False
                    self._version += 1
                    dep["replicas"].pop(rid, None)
                    dep["stats"].pop(rid, None)
            self._kill_silently(rec["handle"])
            logger.warning(
                "replica %s of %s failed health check; removed%s",
                rid, dep["name"], " (was draining)" if draining else "",
            )

    def _autoscale(self) -> None:
        """SLO-driven policy (serve/autoscale/policy.py): windowed TTFT
        p95 / KV occupancy / queue depth from the head's metrics history
        plus the burn-rate alert state, folded over the ongoing-count
        baseline with hysteresis, cooldowns and min/max bounds. Every
        up/down decision is stamped as a timeline event, counted in
        rt_serve_autoscale_decisions_total, and published to the head KV
        for state.autoscale_status() / `rt top`."""
        from ray_tpu_torch.core import worker as worker_mod
        from ray_tpu_torch.serve.autoscale.policy import SignalCollector, SLOPolicy

        if self._policy is None:
            self._policy = SLOPolicy()
        if self._collector is None:
            self._collector = SignalCollector(
                worker_mod.global_worker().control.call
            )
        with self._lock:
            deps = list(self._deployments.values())
        for dep in deps:
            auto = dep["autoscaling"]
            if not auto or dep["deleting"]:
                continue
            name = dep["name"]
            with self._lock:
                total_ongoing = sum(
                    s.get("ongoing", 0) for s in dep["stats"].values()
                )
                model_ids = sorted({
                    m
                    for s in dep["stats"].values()
                    for m in s.get("model_ids", [])
                })
                current = dep["target_replicas"]
            signals = self._collector.collect(name, model_ids, total_ongoing)
            decision = self._policy.decide(name, current, signals, auto)
            with self._lock:
                # re-read under the lock: a set_target_replicas/redeploy
                # may have moved the target while signals were collected
                if self._deployments.get(name) is not dep:
                    continue
                dep["last_signals"] = signals.describe()
                if dep["target_replicas"] != current:
                    continue
                if decision.direction == "hold":
                    continue
                dep["target_replicas"] = decision.target
            logger.info(
                "autoscaling %s: %d -> %d (%s)",
                name, current, decision.target, decision.reason,
            )
            self._record_decision(
                name, current, decision.target, decision.direction,
                decision.reason,
            )

    def _record_decision(
        self, name: str, old: int, new: int, direction: str, reason: str
    ) -> None:
        """One scale decision: dep record (for status), timeline instant
        (for `rt timeline`), decision counter (for history/alerts)."""
        from ray_tpu_torch.observability import core_metrics, tracing

        decision = {
            "from": old, "to": new, "direction": direction,
            "reason": reason, "ts": time.time(),
        }
        with self._lock:
            dep = self._deployments.get(name)
            if dep is not None:
                dep["last_decision"] = decision
        if tracing.ENABLED:
            tracing.emit({
                "type": "autoscale",
                "deployment": name,
                "from": old,
                "to": new,
                "direction": direction,
                "reason": reason,
                "ts_us": tracing.now_us(),
                "pid": os.getpid(),
            })
        if core_metrics.ENABLED:
            core_metrics.serve_autoscale_decisions.inc(
                tags={"deployment": name, "direction": direction}
            )

    def _publish_status(self) -> None:
        """Replica gauges + the autoscale_status snapshot into the head
        KV (ns="serve"), the same side channel the cluster autoscaler
        uses for infeasible demand: state.autoscale_status() and `rt
        top` read it without an extra controller round-trip."""
        from ray_tpu_torch.core import worker as worker_mod
        from ray_tpu_torch.observability import core_metrics

        status = self.autoscale_status()
        if core_metrics.ENABLED:
            for name, st in status.items():
                tags = {"deployment": name}
                core_metrics.serve_replicas_running.set(
                    float(st["running"]), tags=tags
                )
                core_metrics.serve_replicas_target.set(
                    float(st["target"]), tags=tags
                )
                core_metrics.serve_replicas_draining.set(
                    float(len(st["draining"])), tags=tags
                )
        try:
            worker_mod.global_worker().control.call(
                "kv_put", ns="serve", key="autoscale_status",
                value=json.dumps(  # inband: ok — ~1 KiB status record
                    {"deployments": status, "ts": time.time()}
                ).encode(),
                timeout_s=5.0,
            )
        except Exception:  # noqa: BLE001 — status publish must not kill the loop
            pass

    def _reconcile(self) -> None:
        """Start/drain/stop replicas to match target."""
        from ray_tpu_torch.utils.config import config

        with self._lock:
            deps = list(self._deployments.values())
        for dep in deps:
            now = time.monotonic()
            with self._lock:
                current = len(dep["replicas"])
                target = dep["target_replicas"]
                deleting = dep["deleting"]
                # scale-up resurrects drainers first: their KV cache and
                # prefix blocks are hot, and un-draining is free — back
                # into the table, sessions re-pin to them again
                while current < target and dep["draining"] and not deleting:
                    rid, rec = max(
                        dep["draining"].items(), key=lambda kv: kv[1]["since"]
                    )
                    dep["draining"].pop(rid)
                    dep["replicas"][rid] = {
                        "handle": rec["handle"],
                        "handle_info": rec["handle_info"],
                        "healthy": True,
                    }
                    self._version += 1
                    current += 1
                    logger.info("replica %s un-drained (scale-up)", rid)
            for _ in range(current, target):
                self._start_replica(dep)
            if deleting:
                # teardown is not a drain: delete_deployment means stop
                # now, streams included (old behavior)
                with self._lock:
                    victims = list(dep["replicas"].items())
                    victims += list(dep["draining"].items())
                    dep["replicas"].clear()
                    dep["draining"].clear()
                    dep["stats"].clear()
                    if victims:
                        self._version += 1
                for _, rec in victims:
                    self._kill_silently(rec["handle"])
            elif current > target:
                with self._lock:
                    # session-aware drain: victims leave the table
                    # (routers re-pin within ROUTE_REFRESH_S) but keep
                    # running until their streams finish. Fewest-ongoing
                    # first: drains finish fastest and the fewest
                    # sessions remap.
                    ranked = sorted(
                        dep["replicas"].items(),
                        key=lambda kv: dep["stats"].get(kv[0], {}).get(
                            "ongoing", 0
                        ),
                    )
                    deadline_s = dep["drain_deadline_s"]
                    if deadline_s is None:
                        deadline_s = float(
                            config.serve_autoscale_drain_deadline_s
                        )
                    for rid, rec in ranked[: current - target]:
                        dep["replicas"].pop(rid, None)
                        stats = dep["stats"].pop(rid, None) or {}
                        dep["draining"][rid] = {
                            "handle": rec["handle"],
                            "handle_info": rec["handle_info"],
                            "since": now,
                            "deadline": now + deadline_s,
                            "ongoing": stats.get("ongoing", 0),
                        }
                        logger.info(
                            "replica %s draining (ongoing=%d, "
                            "deadline %.1fs)",
                            rid, stats.get("ongoing", 0), deadline_s,
                        )
                    self._version += 1
            # drain completion: quiescent (after the settle period that
            # covers requests routed from a stale table) or past the
            # deadline — then, and only then, the actor dies
            finished = []
            with self._lock:
                for rid, rec in list(dep["draining"].items()):
                    if (
                        rec["ongoing"] <= 0
                        and now - rec["since"] >= DRAIN_SETTLE_S
                    ):
                        finished.append((rid, rec, "drained"))
                    elif now >= rec["deadline"]:
                        finished.append((rid, rec, "drain deadline"))
                for rid, _rec, _why in finished:
                    dep["draining"].pop(rid, None)
            for rid, rec, why in finished:
                self._kill_silently(rec["handle"])
                logger.info("replica %s stopped (%s)", rid, why)
            if deleting:
                with self._lock:
                    empty = not dep["replicas"] and not dep["draining"]
                    name = dep["name"]
                if empty:
                    with self._lock:
                        self._deployments.pop(name, None)
                        self._version += 1

    def _start_replica(self, dep: Dict[str, Any]) -> None:
        with self._lock:
            rid = f"{dep['name']}#{dep['next_replica']}"
            dep["next_replica"] += 1
        res = dict(dep["resources"])
        handle = ServeReplica.options(
            name=f"SERVE_REPLICA::{rid}",
            max_concurrency=dep["max_concurrency"],
            num_cpus=res.pop("CPU", 1),
            num_gpus=(res.pop("GPU", 0) + res.pop("num_gpus", 0)) or None,
            resources=res or None,
        ).remote(
            dep["name"], dep["callable_blob"], dep["init_args"],
            dep["init_kwargs"],
        )
        with self._lock:
            # A redeploy may have replaced the record while this replica
            # was starting: registering into the orphaned dict would leak
            # a live actor nothing tracks.
            if self._deployments.get(dep["name"]) is not dep:
                stale = True
            else:
                stale = False
                dep["replicas"][rid] = {
                    "handle": handle,
                    # (actor_id, class_name, method_meta): routers rebuild
                    # a borrower ActorHandle from this (handles are plain
                    # pickleable records, actor.py __reduce__)
                    "handle_info": (
                        handle._actor_id, handle._class_name,
                        handle._method_meta,
                    ),
                    "healthy": True,
                }
                self._version += 1
        if stale:
            self._kill_silently(handle)
            return
        logger.info("started replica %s", rid)

    # ------------------------------------------------------------------
    # proxies (one per node, reference proxy.py:1176)
    # ------------------------------------------------------------------

    def _ensure_proxies(self) -> None:
        if self._http_port is None:
            return
        from ray_tpu_torch.core.api import NodeAffinitySchedulingStrategy, nodes
        from ray_tpu_torch.serve.proxy import ServeProxy

        alive = {n["node_id"]: n for n in nodes() if n.get("alive", True)}
        with self._lock:
            missing = [nid for nid in alive if nid not in self._proxies]
            gone = [nid for nid in self._proxies if nid not in alive]
            for nid in gone:
                self._proxies.pop(nid, None)
        for nid in missing:
            proxy = ServeProxy.options(
                name=f"SERVE_PROXY::{nid[:8]}",
                scheduling_strategy=NodeAffinitySchedulingStrategy(nid),
                num_cpus=0,
            ).remote(self._http_port)
            with self._lock:
                self._proxies[nid] = proxy

    def refresh_proxy_routes(self) -> int:
        """Every proxy takes the current routing table (serve.run, once a
        deployment is ready); a proxy that does not answer is skipped.
        Returns how many did."""
        with self._lock:
            proxies = list(self._proxies.values())
        done = 0
        for p in proxies:
            try:
                ray_tpu_torch.get(p.refresh_routes.remote(), timeout=30)
                done += 1
            except Exception:  # noqa: BLE001
                pass
        return done

    def proxy_addresses(self) -> List[str]:
        with self._lock:
            proxies = list(self._proxies.values())
        addrs = []
        for p in proxies:
            try:
                addrs.append(ray_tpu_torch.get(p.address.remote(), timeout=10))
            except Exception:  # noqa: BLE001
                pass
        return addrs

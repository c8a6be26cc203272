"""Cluster state API.

Parity: ray.util.state (reference python/ray/util/state/api.py) + the
`ray timeline` exporter (scripts.py:2171): list nodes/actors/jobs/
placement groups/workers/tasks, aggregate metrics, and dump a
Chrome-trace timeline of task execution events collected from every
worker's event buffer.

Functions accept an explicit control-store address, or use the connected
runtime's when omitted.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ray_tpu_torch.utils.rpc import ClientPool, RpcConnectionError, RpcError

# Pooled connections: the dashboard's 5s auto-refresh page renders several
# state calls per view — dialing and closing a fresh socket per call would
# hammer the control store.
_pool = ClientPool("state-api")


def _control(address: Optional[str]):
    if address is None:
        from ray_tpu_torch.core import worker as worker_mod

        w = worker_mod.global_worker_or_none()
        if w is None:
            raise RuntimeError(
                "not connected: pass address= or call ray_tpu_torch.init() first"
            )
        address = w.control_address
    return _pool.get(address)


def _with_control(address, fn):
    return fn(_control(address))


def list_nodes(address: Optional[str] = None) -> List[Dict[str, Any]]:
    return _with_control(
        address, lambda c: c.call("get_nodes", alive_only=False)
    )


def list_actors(address: Optional[str] = None) -> List[Dict[str, Any]]:
    return _with_control(address, lambda c: c.call("list_actors"))


def list_jobs(address: Optional[str] = None) -> List[Dict[str, Any]]:
    return _with_control(address, lambda c: c.call("list_jobs"))


def list_placement_groups(address: Optional[str] = None) -> List[Dict[str, Any]]:
    return _with_control(address, lambda c: c.call("list_placement_groups"))


def _agent_states(address: Optional[str]) -> List[Dict[str, Any]]:
    nodes = [n for n in list_nodes(address) if n.get("alive", True)]
    out = []
    for n in nodes:
        try:
            out.append(
                _pool.get(n["address"]).call("get_state", timeout_s=10.0)
            )
        except RpcConnectionError:
            _pool.drop(n["address"])  # dead connection: rebuild next time
        except RpcError:
            pass  # slow, not dead: dropping would break concurrent users
    return out


def list_workers(address: Optional[str] = None) -> List[Dict[str, Any]]:
    out = []
    for st in _agent_states(address):
        for wid, w in st.get("workers", {}).items():
            out.append({"worker_id": wid, "node_id": st["node_id"], **w})
    return out


def cluster_status(address: Optional[str] = None) -> Dict[str, Any]:
    """`rt status` summary: nodes, resources, stores, actors, jobs."""
    nodes = list_nodes(address)
    agents = _agent_states(address)
    actors = list_actors(address)
    infeasible = None
    try:
        raw = _control(address).call(
            "kv_get", ns="autoscaler", key="infeasible", timeout_s=5.0
        )
        if raw:
            rec = json.loads(bytes(raw).decode())
            if time.time() - rec.get("ts", 0) < 60.0:  # recent only
                infeasible = rec
    except Exception:  # noqa: BLE001 — status must not fail on extras
        pass
    total: Dict[str, float] = {}
    avail: Dict[str, float] = {}
    for st in agents:
        for k, v in st["resources_total"].items():
            total[k] = total.get(k, 0.0) + v
        for k, v in st["resources_available"].items():
            avail[k] = avail.get(k, 0.0) + v
    head_ha = None
    try:
        head_ha = _control(address).call("ha_status", timeout_s=5.0)
    except Exception:  # noqa: BLE001 — status must not fail on extras
        pass
    return {
        "nodes_alive": sum(1 for n in nodes if n.get("alive", True)),
        "nodes_dead": sum(1 for n in nodes if not n.get("alive", True)),
        # head fault-tolerance posture (durable log / reconciliation)
        "head_ha": head_ha,
        "resources_total": total,
        "resources_available": avail,
        "actors": {
            "ALIVE": sum(1 for a in actors if a["state"] == "ALIVE"),
            "DEAD": sum(1 for a in actors if a["state"] == "DEAD"),
            "other": sum(
                1 for a in actors if a["state"] not in ("ALIVE", "DEAD")
            ),
        },
        "workers": sum(len(st.get("workers", {})) for st in agents),
        # demand no launchable node type can ever satisfy (autoscaler
        # shape-aware scheduler; reference autoscaler/v2 reports the same
        # through `ray status`'s "infeasible requests" section)
        "infeasible_demand": infeasible,
        "object_store": {
            "used_bytes": sum(st["store_usage"][0] for st in agents),
            "capacity_bytes": sum(st["store_usage"][1] for st in agents),
            "spilled_objects": sum(
                st.get("spill_stats", {}).get("spilled_objects", 0)
                for st in agents
            ),
            "spilled_bytes": sum(
                st.get("spill_stats", {}).get("spilled_bytes", 0)
                for st in agents
            ),
        },
    }


def _worker_addresses(
    address: Optional[str],
    agents: Optional[List[Dict[str, Any]]] = None,
) -> List[str]:
    if agents is None:
        agents = _agent_states(address)
    addrs = []
    for st in agents:
        for w in st.get("workers", {}).values():
            addrs.append(w["address"])
    # drivers execute nothing but OWN events (submit/dispatch lifecycle
    # instants) and metrics: reach them through the job registry so
    # out-of-process consumers (rt summary, a standalone dashboard) see
    # owner-side data, not just executor slices
    try:
        for job in list_jobs(address):
            if job.get("alive") and job.get("driver_address"):
                addrs.append(job["driver_address"])
    except (RpcError, RuntimeError):
        pass
    from ray_tpu_torch.core import worker as worker_mod

    w = worker_mod.global_worker_or_none()
    if w is not None:
        addrs.append(w.address)
    # dedup (an in-process driver is also a live job) preserving order
    return list(dict.fromkeys(addrs))


def _collect_task_events(
    address: Optional[str],
    types: Optional[List[str]] = None,
) -> Tuple[List[Dict[str, Any]], int]:
    """Gather every worker's event ring. Returns (events, dropped_total)
    — dropped counts ring evictions, so a truncated timeline is
    detectable instead of silently missing its head. ``types`` filters
    worker-side (rpc_get_task_events), so periodic consumers (the
    metrics-history sampler) don't ship full rings every tick."""
    events: List[Dict[str, Any]] = []
    dropped = 0
    for addr in _worker_addresses(address):
        try:
            reply = _pool.get(addr).call(
                "get_task_events", types=types, timeout_s=10.0
            )
        except RpcConnectionError:
            _pool.drop(addr)
            continue
        except RpcError:
            continue
        if isinstance(reply, dict):
            events.extend(reply.get("events", ()))
            dropped += int(reply.get("dropped", 0))
        else:  # legacy list shape
            events.extend(reply)
    return events, dropped


def task_events(address: Optional[str] = None) -> List[Dict[str, Any]]:
    """Collect task execution + lifecycle events from every live worker."""
    return _collect_task_events(address)[0]


def timeline(address: Optional[str] = None,
             out_path: Optional[str] = None) -> Any:
    """Chrome-trace (chrome://tracing / perfetto) of task executions
    (parity: `ray timeline`, reference scripts.py:2171).

    Execution events render as "X" duration slices. Lifecycle events
    (observability/tracing.py) add cross-process causality: each task
    with a "submitted" instant on its owner and an execution slice on a
    worker emits a flow arrow (``ph:"s"`` on the owner pid →
    ``ph:"f"`` binding to the execution slice on the executor pid), plus
    an owner-side "submit:" slice spanning submit → dispatch so the
    arrow has a visible anchor."""
    events = task_events(address)
    trace: List[Dict[str, Any]] = []
    exec_slices: Dict[str, Dict[str, Any]] = {}
    submits: Dict[str, Dict[str, Any]] = {}
    dispatches: Dict[str, Dict[str, Any]] = {}
    request_spans: Dict[str, List[Dict[str, Any]]] = {}
    for e in events:
        etype = e.get("type")
        if etype == "request":
            # serve request leg: one slice per component, joined below
            # into a cross-pid flow by trace id
            args = {"trace_id": e["trace_id"]}
            for k in ("queue_us", "status", "model", "cached", "ttft_us",
                      "tokens", "kv_bytes"):
                if k in e:
                    args[k] = e[k]
            trace.append({
                "name": f"{e['component']}:{e.get('deployment', '')}",
                "cat": "request",
                "ph": "X",
                "ts": e["ts_us"],
                "dur": max(int(e.get("dur_us", 0)), 1),
                "pid": e.get("worker") or e.get("pid", 0),
                "tid": e.get("pid", 0),
                "args": args,
            })
            request_spans.setdefault(e["trace_id"], []).append(e)
            continue
        if etype == "pipeline":
            trace.append({
                "name": f"stage{e['stage']}:{e['kind']}",
                "cat": "pipeline",
                "ph": "X",
                "ts": e["ts_us"],
                "dur": max(int(e.get("dur_us", 0)), 1),
                "pid": e.get("worker") or e.get("pid", 0),
                "tid": e.get("pid", 0),
                "args": {k: e[k] for k in
                         ("step", "microbatch", "bubble_frac", "schedule")
                         if k in e},
            })
            continue
        if etype == "collective":
            trace.append({
                "name": f"collective:{e['op']}",
                "cat": "collective",
                "ph": "X",
                "ts": e["ts_us"],
                "dur": max(int(e.get("dur_us", 0)), 1),
                "pid": e.get("worker") or e.get("pid", 0),
                "tid": e.get("pid", 0),
                "args": {"nbytes": e.get("nbytes", 0)},
            })
            continue
        if etype == "alert":
            # alert transitions render as global instants so a FIRING
            # marker lines up against the request spans that caused it
            trace.append({
                "name": f"alert:{e.get('rule', '?')}:{e.get('state', '?')}",
                "cat": "alert",
                "ph": "i",
                "s": "g",
                "ts": e["ts_us"],
                "pid": e.get("worker") or e.get("pid", 0),
                "tid": e.get("pid", 0),
                "args": {
                    k: e[k]
                    for k in ("rule", "state", "metric", "severity", "value")
                    if e.get(k) is not None
                },
            })
            continue
        if etype == "autoscale":
            # serve autoscaler decisions: global instants so a scale-up
            # marker lines up against the TTFT spans that triggered it
            trace.append({
                "name": (
                    f"autoscale:{e.get('deployment', '?')}:"
                    f"{e.get('direction', '?')}"
                ),
                "cat": "autoscale",
                "ph": "i",
                "s": "g",
                "ts": e["ts_us"],
                "pid": e.get("worker") or e.get("pid", 0),
                "tid": e.get("pid", 0),
                "args": {
                    k: e[k]
                    for k in ("deployment", "from", "to", "direction",
                              "reason")
                    if e.get(k) is not None
                },
            })
            continue
        if etype == "stall":
            # stall watchdog marker: a process-scoped instant carrying
            # the stuck thread's stack, joinable by task_id
            trace.append({
                "name": f"stall:{e.get('name', '?')}",
                "cat": "stall",
                "ph": "i",
                "s": "p",
                "ts": e["ts_us"],
                "pid": e.get("worker") or e.get("pid", 0),
                "tid": e.get("pid", 0),
                "args": {
                    k: e[k]
                    for k in ("task_id", "name", "elapsed_s", "stack")
                    if k in e
                },
            })
            continue
        if etype == "lifecycle":
            if e["phase"] == "submitted":
                submits[e["task_id"]] = e
            elif e["phase"] == "dispatched":
                dispatches[e["task_id"]] = e
            elif e["phase"] == "lease_granted":
                # lease churn as thread-scoped instants: correlates pool
                # growth with the queue spikes that caused it
                trace.append({
                    "name": f"lease_granted:{e.get('target', '')}",
                    "cat": "lease",
                    "ph": "i",
                    "s": "t",
                    "ts": e["ts_us"],
                    "pid": e["worker"],
                    "tid": e.get("pid", 0),
                    "args": {"lease_id": e["task_id"]},
                })
            continue
        slice_ev = {
            "name": e["name"],
            "cat": "actor_task" if e.get("actor_id") else "task",
            "ph": "X",
            "ts": e["ts_us"],
            "dur": e["dur_us"],
            "pid": e["worker"],
            "tid": e.get("pid", 0),
            "args": {"task_id": e["task_id"]},
        }
        trace.append(slice_ev)
        exec_slices[e["task_id"]] = e
    for task_id, sub in submits.items():
        exec_e = exec_slices.get(task_id)
        disp = dispatches.get(task_id)
        # owner-side anchor slice: submit -> dispatch (or a 1us tick)
        anchor_end = disp["ts_us"] if disp else sub["ts_us"] + 1
        trace.append({
            "name": f"submit:{sub['name']}",
            "cat": "task_submit",
            "ph": "X",
            "ts": sub["ts_us"],
            "dur": max(anchor_end - sub["ts_us"], 1),
            "pid": sub["worker"],
            "tid": sub.get("pid", 0),
            "args": {"task_id": task_id},
        })
        if exec_e is None:
            continue
        flow = {
            "name": sub["name"],
            "cat": "task_flow",
            "id": task_id,
        }
        trace.append({
            **flow, "ph": "s", "ts": sub["ts_us"],
            "pid": sub["worker"], "tid": sub.get("pid", 0),
        })
        trace.append({
            # bp:"e" binds the flow end to the ENCLOSING slice — the
            # execution "X" beginning at the same ts on this pid/tid
            **flow, "ph": "f", "bp": "e", "ts": exec_e["ts_us"],
            "pid": exec_e["worker"], "tid": exec_e.get("pid", 0),
        })
    # request flow: one arrow chain per trace id, hop by hop through the
    # components in time order (proxy → router → replica → engine),
    # binding each step to the enclosing component slice
    for trace_id, spans in request_spans.items():
        if len(spans) < 2:
            continue
        spans = sorted(spans, key=lambda s: s["ts_us"])
        flow = {"name": "request", "cat": "request_flow", "id": trace_id}
        for i, s in enumerate(spans):
            ph = "s" if i == 0 else ("f" if i == len(spans) - 1 else "t")
            step = {
                **flow, "ph": ph, "ts": s["ts_us"],
                "pid": s.get("worker") or s.get("pid", 0),
                "tid": s.get("pid", 0),
            }
            if ph == "f":
                step["bp"] = "e"
            trace.append(step)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(trace, f)
        return out_path
    return trace


def _percentiles(values: List[float]) -> Dict[str, float]:
    vs = sorted(values)
    n = len(vs)

    def pick(q: float) -> float:
        return vs[min(n - 1, int(q * n))]

    return {
        "p50": pick(0.50), "p95": pick(0.95), "p99": pick(0.99),
        "mean": sum(vs) / n, "max": vs[-1],
    }


def _latency_entry(splits: Dict[str, List[float]],
                   count_key: str) -> Dict[str, Any]:
    """Shared rollup for task_summary/request_summary: one count (taken
    from count_key's split — the one every sample contributes to) plus
    p50/p95/p99/mean/max for each non-empty split."""
    entry: Dict[str, Any] = {"count": len(splits.get(count_key, ()))}
    for key, vals in splits.items():
        if vals:
            entry[key] = _percentiles(vals)
    return entry


def task_summary(address: Optional[str] = None) -> Dict[str, Any]:
    """Per-task-name latency summary joined across processes: queue wait
    (owner "submitted" instant → executor slice start) and execution
    time, each as p50/p95/p99/mean/max seconds. The "where does time go
    between submit and run" view (reference `ray summary tasks`)."""
    events, dropped = _collect_task_events(address)
    submits: Dict[str, int] = {}
    for e in events:
        if e.get("type") == "lifecycle" and e["phase"] == "submitted":
            submits[e["task_id"]] = e["ts_us"]
    per_name: Dict[str, Dict[str, List[float]]] = {}
    for e in events:
        if e.get("type") is not None:
            continue  # lifecycle/request/pipeline/collective events
        rec = per_name.setdefault(
            e["name"], {"queue_wait_s": [], "exec_s": []}
        )
        rec["exec_s"].append(e["dur_us"] / 1e6)
        sub_ts = submits.get(e["task_id"])
        if sub_ts is not None:
            # clamp: submit/exec stamps come from different processes'
            # wall clocks; sub-ms skew must not produce negative waits
            rec["queue_wait_s"].append(max(e["ts_us"] - sub_ts, 0) / 1e6)
    tasks = {}
    for name, rec in sorted(per_name.items()):
        tasks[name] = _latency_entry(rec, "exec_s")
    return {"tasks": tasks, "events_dropped": dropped}


def request_summary(address: Optional[str] = None) -> Dict[str, Any]:
    """Per-deployment serve-request latency summary from the request
    spans stamped along the proxy → router → replica → engine path:
    end-to-end (proxy span), queue (router span: pick + wait for a
    replica assignment), and execution (replica span), each as
    p50/p95/p99/mean/max seconds. Engine spans additionally split
    time-to-first-token by prefix-cache outcome (ttft_cached_s vs
    ttft_cold_s), and disaggregated deployments contribute prefill_s /
    transfer_s legs, so a hot-vs-cold or remote-prefill regression is
    visible without raw span spelunking."""
    events, dropped = _collect_task_events(address, types=["request"])
    per_dep: Dict[str, Dict[str, List[float]]] = {}
    for e in events:
        if e.get("type") != "request":
            continue
        rec = per_dep.setdefault(e.get("deployment") or "?", {
            "e2e_s": [], "queue_s": [], "exec_s": [],
        })
        dur_s = e.get("dur_us", 0) / 1e6
        comp = e.get("component")
        if comp == "proxy":
            rec["e2e_s"].append(dur_s)
        elif comp == "router":
            rec["queue_s"].append(dur_s)
        elif comp == "replica":
            rec["exec_s"].append(dur_s)
        elif comp == "engine":
            ttft_us = e.get("ttft_us")
            if ttft_us:
                key = "ttft_cached_s" if e.get("cached") else "ttft_cold_s"
                rec.setdefault(key, []).append(ttft_us / 1e6)
        elif comp == "prefill":
            rec.setdefault("prefill_s", []).append(dur_s)
        elif comp == "transfer":
            rec.setdefault("transfer_s", []).append(dur_s)
    deployments = {}
    for dep, rec in sorted(per_dep.items()):
        deployments[dep] = _latency_entry(rec, "e2e_s")
    return {"deployments": deployments, "events_dropped": dropped}


def tasks(address: Optional[str] = None) -> List[Dict[str, Any]]:
    """Task-level state listing (parity: `ray list tasks`) built from the
    workers' task-event rings: one record per task_id with the inferred
    state — QUEUED (submitted, not dispatched), RUNNING (dispatched, no
    execution slice yet), FINISHED (execution slice recorded). Bounded by
    the rings: evicted history is absent, so this is a window, not an
    archive."""
    events, _dropped = _collect_task_events(address)
    recs: Dict[str, Dict[str, Any]] = {}

    def rec(task_id: str) -> Dict[str, Any]:
        return recs.setdefault(task_id, {
            "task_id": task_id, "name": None, "state": "UNKNOWN",
            "owner": None, "worker": None, "actor_id": None,
            "submitted_ts_us": None, "dispatched_ts_us": None,
            "start_ts_us": None, "dur_us": None,
        })

    for e in events:
        etype = e.get("type")
        if etype not in (None, "lifecycle"):
            continue  # request/pipeline/collective spans carry no task_id
        if etype == "lifecycle":
            if e["phase"] == "lease_granted":
                continue  # lease churn, not a task transition
            r = rec(e["task_id"])
            r["name"] = r["name"] or e.get("name")
            if e["phase"] == "submitted":
                r["submitted_ts_us"] = e["ts_us"]
                r["owner"] = e.get("worker")
            elif e["phase"] == "dispatched":
                r["dispatched_ts_us"] = e["ts_us"]
        else:
            r = rec(e["task_id"])
            r["name"] = e["name"]
            r["worker"] = e.get("worker")
            r["actor_id"] = e.get("actor_id")
            r["start_ts_us"] = e["ts_us"]
            r["dur_us"] = e["dur_us"]
    for r in recs.values():
        if r["dur_us"] is not None:
            r["state"] = "FINISHED"
        elif r["dispatched_ts_us"] is not None:
            r["state"] = "RUNNING"
        elif r["submitted_ts_us"] is not None:
            r["state"] = "QUEUED"
    return sorted(
        recs.values(),
        key=lambda r: r["submitted_ts_us"] or r["start_ts_us"] or 0,
    )


def objects(address: Optional[str] = None) -> List[Dict[str, Any]]:
    """Object-level state listing (parity: `ray list objects` /
    `ray memory`): every node's shm/spill store inventory, annotated with
    owner-side reference state (remote borrows + in-flight pins) so a
    leaked borrow shows up as an old pinned object. Owner-only objects
    (small values in a memory store) appear with location "owner" when
    they hold borrows."""
    out: List[Dict[str, Any]] = []
    for n in list_nodes(address):
        if not n.get("alive", True):
            continue
        try:
            reply = _pool.get(n["address"]).call("list_objects", timeout_s=10.0)
        except RpcConnectionError:
            _pool.drop(n["address"])
            continue
        except RpcError:
            continue
        for o in reply["objects"]:
            out.append({**o, "node_id": reply["node_id"], "location": "store",
                        "borrows": 0, "inflight_pins": 0, "owner": None})
    # borrow/pin state is OBJECT-scoped (it lives at the owner): annotate
    # every replica row of the id, not an arbitrary one — an object may
    # sit in several nodes' stores at once
    by_id: Dict[str, List[Dict[str, Any]]] = {}
    for r in out:
        by_id.setdefault(r["object_id"], []).append(r)
    for addr in _worker_addresses(address):
        try:
            stats = _pool.get(addr).call("borrow_stats", timeout_s=10.0)
        except RpcConnectionError:
            _pool.drop(addr)
            continue
        except (RpcError, RuntimeError):
            continue
        pins = stats.get("inflight_pins", {})
        borrows = stats.get("borrows", {})
        for oid in set(borrows) | set(pins):
            recs = by_id.get(oid)
            if recs is None:
                rec = {
                    "object_id": oid, "node_id": None, "location": "owner",
                    "size": None, "sealed": None, "state": "memory",
                    "borrows": 0, "inflight_pins": 0, "owner": None,
                }
                by_id[oid] = [rec]
                out.append(rec)
                recs = [rec]
            for rec in recs:
                rec["owner"] = stats.get("address", addr)
                rec["borrows"] += int(borrows.get(oid, 0))
                pin = pins.get(oid)
                if pin:
                    rec["inflight_pins"] += int(pin["count"])
                    rec["oldest_pin_age_s"] = max(
                        rec.get("oldest_pin_age_s", 0.0),
                        pin["oldest_age_s"],
                    )
    return out


def worker_logs(address: Optional[str] = None,
                tail_bytes: int = 4096) -> List[Dict[str, Any]]:
    """Tails of every worker's captured stdout/stderr across the cluster
    (`rt logs`): the minimal path from a `print()` inside a task to the
    driver machine."""
    logs: List[Dict[str, Any]] = []
    for n in list_nodes(address):
        if not n.get("alive", True):
            continue
        try:
            logs.extend(_pool.get(n["address"]).call(
                "tail_worker_logs", tail_bytes=tail_bytes, timeout_s=10.0
            ))
        except RpcConnectionError:
            _pool.drop(n["address"])
        except RpcError:
            pass
    return logs


def _copy_metric(m: Dict) -> Dict:
    """Deep-enough copy of one metric snapshot: the merge mutates series
    state in place, and the caller's input must survive unchanged."""
    series = {}
    for k, v in m["series"].items():
        series[k] = (
            dict(v, buckets=list(v["buckets"])) if isinstance(v, dict) else v
        )
    return dict(m, series=series)


def _merge_snapshot_into(merged: Dict[str, Dict], snap: Dict[str, Dict]) -> None:
    """Merge one process's metric snapshot into the aggregate: counters
    and histograms sum, gauges keep the latest per series."""
    for name, m in snap.items():
        cur = merged.get(name)
        if cur is None:
            # copy on adoption: later snapshots merge INTO this entry,
            # and mutating the first process's reply in place would
            # corrupt the caller's data (and double-count on re-merge)
            merged[name] = _copy_metric(m)
            continue
        for k, v in m["series"].items():
            if m["kind"] == "counter":
                cur["series"][k] = cur["series"].get(k, 0.0) + v
            elif m["kind"] == "gauge":
                cur["series"][k] = v
            else:  # histogram
                if tuple(m.get("boundaries", ())) != tuple(
                    cur.get("boundaries", ())
                ):
                    # divergent boundaries across workers: bucket-wise
                    # merge would be meaningless and render a corrupt
                    # Prometheus histogram (le="+Inf" < _count). Keep
                    # count/sum, drop bucket detail for the metric.
                    cur["boundaries"] = ()
                    for st in cur["series"].values():
                        st["buckets"] = []
                prev = cur["series"].get(k)
                if prev is None:
                    cur["series"][k] = (
                        v if cur.get("boundaries")
                        else dict(v, buckets=[])
                    )
                else:
                    prev["sum"] += v["sum"]
                    prev["count"] += v["count"]
                    prev["buckets"] = [
                        a + b
                        for a, b in zip(prev["buckets"], v["buckets"])
                    ]


def merge_metric_snapshots(
    snapshots: Iterable[Dict[str, Dict]],
) -> Dict[str, Dict]:
    """Pure aggregation over per-process snapshot_all() dicts (exposed
    for direct testing of the merge semantics)."""
    merged: Dict[str, Dict] = {}
    for snap in snapshots:
        _merge_snapshot_into(merged, snap)
    return merged


def metrics_history(
    name: Optional[str] = None,
    tags: Optional[Dict[str, str]] = None,
    window_s: Optional[float] = None,
    step_s: Optional[float] = None,
    address: Optional[str] = None,
) -> Dict[str, Any]:
    """Query the head's retained metric time series
    (observability/history.py). ``name=None`` returns the store
    inventory + sampler stats ({"enabled": False} when the sampler is
    off). With a name: aggregated ring points — gauges as
    ``{"ts","value"}``, counters as reset-aware ``{"ts","delta","rate"}``,
    histograms as per-window bucket deltas — at the finest resolution
    tier covering ``window_s`` (or the tier matching ``step_s``)."""
    return _with_control(address, lambda c: c.call(
        "metrics_history", name=name, tags=tags, window_s=window_s,
        step_s=step_s, timeout_s=10.0,
    ))


def alerts(address: Optional[str] = None) -> Dict[str, Any]:
    """Current alert-rule states from the head's alert engine
    (observability/alerts.py): one entry per rule with its definition,
    state (ok/pending/firing), last evaluated value, and how long it has
    been in that state."""
    return _with_control(
        address, lambda c: c.call("alerts", timeout_s=10.0)
    )


def autoscale_status(address: Optional[str] = None) -> Dict[str, Any]:
    """Serve control-loop snapshot the controller publishes to the head
    KV each reconcile tick (serve/controller.py _publish_status): per
    deployment the replica targets, running/draining counts with
    per-drainer progress, the last autoscale decision and the signals
    behind it. Returns {} when no controller is publishing (or the
    snapshot is stale — controller gone > 60s)."""
    try:
        raw = _control(address).call(
            "kv_get", ns="serve", key="autoscale_status", timeout_s=5.0
        )
    except Exception:  # noqa: BLE001 — no head / no serve: empty
        return {}
    if not raw:
        return {}
    try:
        rec = json.loads(bytes(raw).decode())
    except (ValueError, UnicodeDecodeError):
        return {}
    if time.time() - rec.get("ts", 0) > 60.0:  # controller gone: stale
        return {}
    return rec.get("deployments", {})


def _fleet_addresses(
    address: Optional[str],
    node: Optional[str] = None,
) -> List[str]:
    """Every profile/stack-dump target: control store + node agents +
    workers (+ live drivers). A ``node`` id prefix narrows to that
    node's agent and workers."""
    agents = _agent_states(address)
    if node:
        agents = [
            st for st in agents if st["node_id"].startswith(node)
        ]
        addrs = [st["address"] for st in agents]
        for st in agents:
            addrs.extend(
                w["address"] for w in st.get("workers", {}).values()
            )
    else:
        addrs = []
        try:
            addrs.append(_control(address).address)
        except RuntimeError:
            pass
        addrs.extend(st["address"] for st in agents)
        addrs.extend(_worker_addresses(address, agents=agents))
    return list(dict.fromkeys(addrs))


def profile(
    duration_s: float = 5.0,
    hz: float = 99.0,
    address: Optional[str] = None,
) -> Dict[str, Any]:
    """Fleet-wide sampling profile (`rt profile`): fan ``rpc_profile``
    to the control store, every node agent and every worker
    concurrently, then merge the folded stacks. Replies carry a
    per-process token, so the single-node case (head + agent + driver
    in one process) counts each process once. The merged dict has
    ``folded`` (stack -> samples), ``subsystems`` (subsystem ->
    samples) and sampling totals."""
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch.observability import profiler as profiler_mod

    addrs = _fleet_addresses(address)

    def one(addr: str):
        try:
            return _pool.get(addr).call(
                "profile", duration_s=duration_s, hz=hz,
                timeout_s=float(duration_s) + 30.0,
            )
        except RpcConnectionError:
            _pool.drop(addr)
            return None
        except RpcError:
            return None

    with ThreadPoolExecutor(
        max_workers=min(max(len(addrs), 1), 32),
        thread_name_prefix="profile-fan",
    ) as fan:
        replies = list(fan.map(one, addrs))
    merged = profiler_mod.merge(replies)
    merged["targets"] = len(addrs)
    merged["replies"] = sum(1 for r in replies if r)
    merged["duration_s"] = float(duration_s)
    merged["hz"] = float(hz)
    return merged


def stacks(
    address: Optional[str] = None,
    node: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """All-thread stack dumps from every live process in the fleet
    (`rt stacks`), deduped by process token; ``node`` (node-id prefix)
    narrows to one node's agent + workers."""
    dumps: List[Dict[str, Any]] = []
    seen: set = set()
    for addr in _fleet_addresses(address, node=node):
        try:
            dump = _pool.get(addr).call("stack_dump", timeout_s=10.0)
        except RpcConnectionError:
            _pool.drop(addr)
            continue
        except RpcError:
            continue
        token = dump.get("token") if isinstance(dump, dict) else None
        if token and token in seen:
            continue
        if token:
            seen.add(token)
        dump["address"] = addr
        dumps.append(dump)
    return dumps


def crash_reports(
    address: Optional[str] = None,
    pid: Optional[int] = None,
    node: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """Crash artifacts (black boxes + faulthandler crash files) from
    every node's session crash dir (`rt postmortem`), dead processes
    included — that is the point."""
    out: List[Dict[str, Any]] = []
    for n in list_nodes(address):
        if not n.get("alive", True):
            continue
        if node and not n["node_id"].startswith(node):
            continue
        try:
            reply = _pool.get(n["address"]).call(
                "crash_reports", pid=pid, timeout_s=10.0
            )
        except RpcConnectionError:
            _pool.drop(n["address"])
            continue
        except RpcError:
            continue
        for rec in reply.get("reports", []):
            out.append({**rec, "node_id": reply.get("node_id")})
    return out


def cluster_metrics(address: Optional[str] = None) -> Dict[str, Dict]:
    """Aggregate metrics (utils/metrics.py) across the whole cluster —
    every worker, every node agent, and the control store — so the
    built-in core metrics (scheduler/lease/object-store series that live
    in daemon processes) surface alongside user metrics. Replies carry a
    per-process token: on the head, control store + agent + driver share
    ONE process and must be counted once, not three times."""
    addrs: List[str] = [a for a in [address] if a is not None]
    if not addrs:
        try:
            addrs.append(_control(None).address)
        except RuntimeError:
            pass
    agents = _agent_states(address)
    addrs.extend(st["address"] for st in agents)
    addrs.extend(_worker_addresses(address, agents=agents))
    merged: Dict[str, Dict] = {}
    seen_tokens = set()
    for addr in addrs:
        try:
            reply = _pool.get(addr).call("get_metrics", timeout_s=10.0)
        except RpcConnectionError:
            _pool.drop(addr)
            continue
        except RpcError:
            continue
        if isinstance(reply, dict) and "metrics" in reply and "token" in reply:
            token, snap = reply["token"], reply["metrics"]
            if token in seen_tokens:
                continue
            seen_tokens.add(token)
        else:  # legacy shape: a bare snapshot, no process identity
            snap = reply
        _merge_snapshot_into(merged, snap)
    return merged

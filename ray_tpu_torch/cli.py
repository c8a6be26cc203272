"""rt — the cluster CLI.

Parity: the `ray` CLI's observability commands (reference
python/ray/scripts/scripts.py — status, list, timeline :2171). Run as
`python -m ray_tpu_torch.cli <cmd>` (or `python -m ray_tpu_torch <cmd>`); point it
at a cluster with --address or RT_ADDRESS.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _fmt_table(rows: List[dict], columns: List[str]) -> str:
    if not rows:
        return "(none)"
    widths = {
        c: max(len(c), *(len(str(r.get(c, ""))) for r in rows)) for c in columns
    }
    head = "  ".join(c.upper().ljust(widths[c]) for c in columns)
    lines = [head, "-" * len(head)]
    for r in rows:
        lines.append(
            "  ".join(str(r.get(c, "")).ljust(widths[c]) for c in columns)
        )
    return "\n".join(lines)


# Single shared interpolation (utils/metrics.py): the renderer, state
# rollups, history store, and alert engine must all agree on quantile
# math.
from ray_tpu_torch.utils.metrics import hist_quantile as _hist_quantile  # noqa: E402

_SPARK_GLYPHS = "▁▂▃▄▅▆▇█"


def _sparkline(vals: List[float], width: int = 12) -> str:
    """Render the trailing ``width`` values as a unicode sparkline."""
    vals = [v for v in vals if v is not None][-width:]
    if not vals:
        return "-"
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(
        _SPARK_GLYPHS[min(
            int((v - lo) / span * (len(_SPARK_GLYPHS) - 1) + 0.5),
            len(_SPARK_GLYPHS) - 1,
        )]
        for v in vals
    )


def _router_deps(mx: dict) -> List[str]:
    m = mx.get("rt_serve_router_requests_total") or {}
    deps = set()
    for k in m.get("series", {}):
        deps.add(dict(zip(m.get("tag_keys", ()), k)).get("deployment") or "?")
    return sorted(deps)


def _top_history(state_mod, addr, since: float, deps: List[str]):
    """History-derived `rt top` view: per-deployment TTFT percentiles
    over the trailing ``since`` window plus a QPS sparkline, from the
    head's metrics-history store. None when the sampler is disabled."""
    try:
        root = state_mod.metrics_history(address=addr)
    except Exception:  # noqa: BLE001 — older head / no handler
        return None
    if not isinstance(root, dict) or not root.get("enabled"):
        return None
    out = {"window_s": since, "deployments": {}}
    for dep in deps:
        entry: dict = {}
        try:
            h = state_mod.metrics_history(
                "rt_serve_ttft_s", tags={"deployment": dep},
                window_s=since, address=addr,
            )
            pts = [p for p in h.get("points", ()) if p.get("buckets")]
            if pts and h.get("boundaries"):
                buckets = [0.0] * max(len(p["buckets"]) for p in pts)
                for p in pts:
                    for i, b in enumerate(p["buckets"]):
                        buckets[i] += b
                entry["ttft_p50_s"] = _hist_quantile(
                    h["boundaries"], buckets, 0.5
                )
                entry["ttft_p95_s"] = _hist_quantile(
                    h["boundaries"], buckets, 0.95
                )
            q = state_mod.metrics_history(
                "rt_serve_router_requests_total", tags={"deployment": dep},
                window_s=since, address=addr,
            )
            rates = [p.get("rate", 0.0) for p in q.get("points", ())]
            if rates:
                entry["qps_points"] = rates
                entry["qps_avg"] = sum(rates) / len(rates)
        except Exception:  # noqa: BLE001 — a hiccup must not kill a frame
            pass
        if entry:
            out["deployments"][dep] = entry
    return out


def _render_top(mx: dict, reqs: dict, qps: Optional[dict],
                alerts_rep: Optional[dict] = None,
                hist: Optional[dict] = None,
                ascale: Optional[dict] = None) -> str:
    """One `rt top` frame from a state.cluster_metrics() aggregate and a
    state.request_summary() rollup. ``qps`` maps deployment -> req/s
    computed by the caller from successive router-counter frames (None
    on the first frame / --once). ``alerts_rep`` / ``hist`` (state.alerts
    and the metrics-history view) add the FIRING banner and the windowed
    sparkline/percentile columns when the head-side sampler is on.
    ``ascale`` (state.autoscale_status) adds the control-loop columns:
    replicas as running/target(+Nd draining), shed counts, and the last
    autoscale decision with its reason."""

    def metric(name: str) -> dict:
        return mx.get(name) or {"series": {}, "tag_keys": ()}

    def tags(m: dict, key) -> dict:
        return dict(zip(m.get("tag_keys", ()), key))

    def scalar_sum(name: str) -> float:
        return sum(metric(name)["series"].values())

    def by_tag(name: str, tag: str) -> dict:
        """Sum a counter/gauge's series per value of one tag."""
        m = metric(name)
        out: dict = {}
        for k, v in m["series"].items():
            t = tags(m, k).get(tag) or "?"
            out[t] = out.get(t, 0.0) + v
        return out

    def hist_by_tag(name: str, tag: str) -> dict:
        """Per-tag merged (bounds, buckets, count, sum) for a histogram."""
        m = metric(name)
        bounds = m.get("boundaries", ())
        out: dict = {}
        for k, v in m["series"].items():
            t = tags(m, k).get(tag) or "?"
            cur = out.setdefault(
                t, {"bounds": bounds, "buckets": [0] * len(v["buckets"]),
                    "count": 0, "sum": 0.0},
            )
            cur["count"] += v["count"]
            cur["sum"] += v["sum"]
            cur["buckets"] = [
                a + b for a, b in zip(cur["buckets"], v["buckets"])
            ] or list(v["buckets"])
        return out

    def ms(v: Optional[float]) -> str:
        return f"{v * 1e3:.1f}" if v is not None else "-"

    out = []
    firing = [
        a for a in (alerts_rep or {}).get("alerts", ())
        if a.get("state") == "firing"
    ]
    if firing:
        out.append("!! FIRING: " + ", ".join(
            f"{a['name']}"
            + (f" ({a['value']:.3g})" if a.get("value") is not None else "")
            for a in firing
        ))
        out.append("")
    out.append(
        f"sched queue {scalar_sum('rt_sched_queue_depth'):g}  |  "
        f"object store {int(scalar_sum('rt_object_store_used_bytes')):,} B  |  "
        f"channel write blocks {scalar_sum('rt_channel_write_blocks_total'):g}"
        f"  |  events dropped "
        f"{scalar_sum('rt_task_events_dropped_total'):g}"
    )
    # -- profiling / forensics status (one line; "off" when the
    # continuous sampler isn't running anywhere) --
    hz_series = metric("rt_profiler_hz")["series"].values()
    cont_hz = max(hz_series, default=0.0)
    samples = scalar_sum("rt_profile_samples_total")
    stalls = scalar_sum("rt_task_stalls_total")
    prof = (
        f"continuous @ {cont_hz:g} Hz, {int(samples):,} samples"
        if cont_hz > 0 else "continuous off"
    )
    out.append(
        f"profiling: {prof}  |  task stalls {int(stalls)}"
        + ("  <-- hung tasks flagged; run `rt stacks`" if stalls else "")
    )
    # -- bucketed grad sync (one line; only once a grad_sync has run) --
    overlap = metric("rt_collective_overlap_hidden_frac")["series"].values()
    ov_count = sum(v["count"] for v in overlap)
    ov_sum = sum(v["sum"] for v in overlap)
    bucket_b = scalar_sum("rt_collective_bucket_bytes_total")
    inter_b = scalar_sum("rt_collective_inter_host_bytes_total")
    if ov_count or bucket_b or inter_b:
        hidden = f"{ov_sum / ov_count * 100:.0f}%" if ov_count else "-"
        out.append(
            f"collectives: comm hidden {hidden} avg  |  bucket bytes "
            f"{int(bucket_b):,}  |  inter-host bytes {int(inter_b):,}"
        )

    # -- serve: one row per deployment --
    rows: dict = {}

    def row(dep: str) -> dict:
        return rows.setdefault(dep, {"deployment": dep})

    for dep, v in by_tag("rt_serve_router_requests_total",
                         "deployment").items():
        row(dep)["reqs"] = int(v)
    for dep, v in by_tag("rt_serve_tokens_generated_total",
                         "deployment").items():
        row(dep)["tokens"] = int(v)
    for dep, v in by_tag("rt_serve_kv_slots_occupied", "deployment").items():
        row(dep)["kv_slots"] = f"{v:g}"
    # paged engines: occupied/total pages + sealed prefix residents
    pg_occ = by_tag("rt_serve_kv_pages_occupied", "deployment")
    pg_tot = by_tag("rt_serve_kv_pages_total", "deployment")
    pg_res = by_tag("rt_serve_kv_pages_prefix_resident", "deployment")
    for dep in set(pg_occ) | set(pg_tot):
        cell = f"{pg_occ.get(dep, 0.0):g}"
        if pg_tot.get(dep):
            cell += f"/{pg_tot[dep]:g}"
        if dep in pg_res:
            cell += f" ({pg_res[dep]:g}pfx)"
        row(dep)["kv_pages"] = cell
    for dep, v in by_tag("rt_serve_queued_requests", "deployment").items():
        row(dep)["queued"] = f"{v:g}"
    for dep, h in hist_by_tag("rt_serve_ttft_s", "deployment").items():
        r = row(dep)
        r["ttft_p50_ms"] = ms(_hist_quantile(h["bounds"], h["buckets"], 0.5))
        r["ttft_p95_ms"] = ms(_hist_quantile(h["bounds"], h["buckets"], 0.95))
    for dep, h in hist_by_tag("rt_serve_inter_token_s", "deployment").items():
        row(dep)["itl_p50_ms"] = ms(
            _hist_quantile(h["bounds"], h["buckets"], 0.5)
        )
    for dep, h in hist_by_tag("rt_serve_decode_host_gap_s", "deployment").items():
        # host time the device sat idle between decode dispatches: ~0
        # when the async decode pipeline keeps a lookahead chunk in
        # flight, the per-chunk Python overhead when it does not
        row(dep)["host_gap_p95_ms"] = ms(
            _hist_quantile(h["bounds"], h["buckets"], 0.95)
        )
    for dep, h in hist_by_tag("rt_serve_batch_fill", "deployment").items():
        if h["count"]:
            row(dep)["batch_fill"] = f"{h['sum'] / h['count']:.1f}"
    hits = by_tag("rt_serve_prefix_cache_hits_total", "deployment")
    misses = by_tag("rt_serve_prefix_cache_misses_total", "deployment")
    for dep in set(hits) | set(misses):
        total = hits.get(dep, 0.0) + misses.get(dep, 0.0)
        if total:
            pct = f"{100.0 * hits.get(dep, 0.0) / total:.0f}%"
            row(dep)["cache_hit"] = pct
            # paged engines match PAGES, not host blocks: surface the
            # same ratio under the page-hit name next to kv_pages
            if dep in pg_occ or dep in pg_tot:
                row(dep)["page_hit"] = pct
    for dep, v in by_tag("rt_serve_shed_total", "deployment").items():
        if v:
            row(dep)["shed"] = int(v)
    for dep, st in (ascale or {}).items():
        r = row(dep)
        running = st.get("running", 0)
        target = st.get("target", 0)
        draining = len(st.get("draining") or {})
        rep = f"{running}/{target}"
        if draining:
            rep += f"(+{draining}d)"
        r["replicas"] = rep
        dec = st.get("last_decision") or {}
        if dec.get("direction") in ("up", "down"):
            r["last_scale"] = (
                f"{dec['direction']} {dec.get('from', '?')}->"
                f"{dec.get('to', '?')} {dec.get('reason', '')}"
            ).strip()
    for dep, r in rows.items():
        r["qps"] = (
            f"{qps.get(dep, 0.0):.1f}" if qps is not None else "-"
        )
    columns = ["deployment", "replicas", "reqs", "qps", "ttft_p50_ms",
               "ttft_p95_ms", "itl_p50_ms", "host_gap_p95_ms", "tokens",
               "kv_slots", "kv_pages", "queued", "shed", "batch_fill",
               "cache_hit",
               "page_hit", "last_scale"]
    if hist is not None:
        # windowed view from the history store: TTFT p95 over the last
        # --since seconds (not since boot) + a QPS sparkline
        win = hist.get("window_s", 60)
        for dep, h in hist.get("deployments", {}).items():
            r = row(dep)
            r[f"ttft_p95_{win:g}s_ms"] = ms(h.get("ttft_p95_s"))
            r["qps_hist"] = _sparkline(h.get("qps_points") or [])
        columns[columns.index("ttft_p95_ms") + 1:
                columns.index("ttft_p95_ms") + 1] = [
            f"ttft_p95_{hist.get('window_s', 60):g}s_ms", "qps_hist",
        ]
    out.append("")
    out.append("serve")
    out.append(_fmt_table([rows[d] for d in sorted(rows)], columns))

    # -- request summary: e2e / queue / exec percentiles per deployment --
    rrows = []
    for dep, entry in sorted((reqs.get("deployments") or {}).items()):
        e2e = entry.get("e2e_s") or {}
        rrows.append({
            "deployment": dep,
            "count": entry.get("count", 0),
            "e2e_p50_ms": ms(e2e.get("p50")),
            "e2e_p95_ms": ms(e2e.get("p95")),
            "e2e_p99_ms": ms(e2e.get("p99")),
            "queue_p50_ms": ms((entry.get("queue_s") or {}).get("p50")),
            "exec_p50_ms": ms((entry.get("exec_s") or {}).get("p50")),
        })
    out.append("")
    out.append("requests (traced)")
    out.append(_fmt_table(rrows, [
        "deployment", "count", "e2e_p50_ms", "e2e_p95_ms", "e2e_p99_ms",
        "queue_p50_ms", "exec_p50_ms",
    ]))

    # -- pipeline: bubble fraction + busy time per stage/schedule --
    m = metric("rt_pipeline_bubble_fraction")
    busy = hist_by_tag("rt_pipeline_stage_busy_s", "stage")
    prow: dict = {}
    for k, v in m["series"].items():
        t = tags(m, k)
        key = (t.get("stage") or "?", t.get("schedule") or "?")
        cur = prow.setdefault(
            key, {"stage": key[0], "schedule": key[1], "steps": 0,
                  "_sum": 0.0},
        )
        cur["steps"] += v["count"]
        cur["_sum"] += v["sum"]
    prows = []
    for key in sorted(prow):
        r = prow[key]
        r["bubble_pct"] = (
            f"{100.0 * r['_sum'] / r['steps']:.1f}" if r["steps"] else "-"
        )
        b = busy.get(r["stage"])
        r["busy_p50_ms"] = ms(
            _hist_quantile(b["bounds"], b["buckets"], 0.5) if b else None
        )
        prows.append(r)
    out.append("")
    out.append("pipeline")
    out.append(_fmt_table(prows, [
        "stage", "schedule", "steps", "bubble_pct", "busy_p50_ms",
    ]))
    if reqs.get("events_dropped"):
        out.append(
            f"warning: {reqs['events_dropped']} events dropped from "
            f"bounded buffers"
        )
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="rt", description="ray_tpu_torch cluster CLI"
    )
    from ray_tpu_torch.utils.config import config

    parser.add_argument(
        "--address", default=(config.address or None),
        help="control store host:port (default: $RT_ADDRESS)",
    )
    parser.add_argument("--json", action="store_true", dest="as_json")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("status", help="cluster summary")
    listp = sub.add_parser("list", help="list cluster entities")
    listp.add_argument(
        "what",
        choices=["nodes", "actors", "jobs", "workers", "placement-groups"],
    )
    tl = sub.add_parser("timeline", help="dump a Chrome-trace timeline")
    tl.add_argument("--out", default="timeline.json")
    head = sub.add_parser("head", help="run / manage a standalone head")
    headsub = head.add_subparsers(dest="head_cmd", required=True)
    hs = headsub.add_parser("start", help="run the head in the foreground")
    hs.add_argument("--host", default="127.0.0.1")
    hs.add_argument("--port", type=int, default=0,
                    help="fix the port to make the head restartable in place")
    hs.add_argument("--session-id", default=None)
    hs.add_argument("--persist", default=None,
                    help="durable-log base path (snapshot + .wal)")
    hs.add_argument("--address-file", default=None,
                    help="publish the head address here for re-attach")
    sub.add_parser(
        "head-restart",
        help="bounce a standalone head in place (persist, re-exec, "
             "reconcile) — requires rt head start --persist + --port",
    )
    mem = sub.add_parser(
        "memory", help="per-node object-store contents + owner borrow "
                       "state (leaked-borrow triage)",
    )
    mem.add_argument("--min-bytes", type=int, default=0,
                     help="hide objects smaller than this")
    logs = sub.add_parser(
        "logs", help="tail worker stdout/stderr across the cluster",
    )
    logs.add_argument("job_id", nargs="?", default=None,
                      help="job to attribute (informational; all worker "
                           "logs of the session are shown)")
    logs.add_argument("--tail-bytes", type=int, default=4096)
    sub.add_parser(
        "summary",
        help="per-task queue-wait / exec latency percentiles",
    )
    sub.add_parser("metrics", help="aggregated metrics (Prometheus text)")
    sub.add_parser(
        "alerts",
        help="alert-rule states (SLO burn-rate / threshold rules over "
             "the head's metrics history); exits 2 while any rule fires",
    )
    top = sub.add_parser(
        "top",
        help="live serving / pipeline SLO view (QPS, TTFT, KV occupancy, "
             "bubble fraction, queue depths)",
    )
    top.add_argument("--interval", type=float, default=2.0,
                     help="refresh period in seconds")
    top.add_argument("--once", action="store_true",
                     help="render a single frame and exit (no screen "
                          "clearing; scriptable)")
    top.add_argument("--since", type=float, default=60.0,
                     help="trailing window (s) for the history-derived "
                          "columns (windowed TTFT p95, QPS sparkline)")
    prof = sub.add_parser(
        "profile",
        help="fleet-wide sampling profile: capture stacks on every live "
             "process for --duration seconds, merge, and report the "
             "per-subsystem split (+ folded stacks / flamegraph files)",
    )
    prof.add_argument("--duration", type=float, default=10.0,
                      help="capture window in seconds (server-capped by "
                           "RT_PROFILER_MAX_DURATION_S)")
    prof.add_argument("--hz", type=float, default=99.0,
                      help="sampling rate per process")
    prof.add_argument("--out", default="profile.folded",
                      help="write merged folded stacks here ('' to skip)")
    prof.add_argument("--html", default="profile.html",
                      help="write a self-contained flamegraph here "
                           "('' to skip)")
    stacks = sub.add_parser(
        "stacks",
        help="dump every thread's Python stack from every live process "
             "(hang triage; no restart, no signals)",
    )
    stacks.add_argument("--node", default=None,
                        help="node-id prefix: only that node's agent "
                             "and workers")
    pm = sub.add_parser(
        "postmortem",
        help="render crash flight-recorder black boxes (periodic "
             "snapshot of events/tasks/rss survives kill -9) and "
             "faulthandler crash files for dead processes",
    )
    pm.add_argument("target", nargs="?", default=None,
                    help="a pid or a node-id prefix (default: all)")
    pm.add_argument("--all", action="store_true", dest="show_alive",
                    help="include live processes, not just dead ones")
    dash = sub.add_parser("dashboard", help="serve the HTTP dashboard")
    dash.add_argument("--port", type=int, default=8265)
    dash.add_argument(
        "--host", default="127.0.0.1",
        help="bind host (default loopback; the APIs are unauthenticated)",
    )
    job = sub.add_parser("job", help="submit / inspect cluster jobs")
    jobsub = job.add_subparsers(dest="job_cmd", required=True)
    js = jobsub.add_parser("submit")
    js.add_argument("entrypoint", nargs=argparse.REMAINDER,
                    help="command to run, e.g. -- python train.py")
    js.add_argument("--wait", action="store_true")
    for name in ("status", "logs", "stop"):
        p = jobsub.add_parser(name)
        p.add_argument("submission_id")
    jobsub.add_parser("list")
    args = parser.parse_args(argv)

    from ray_tpu_torch import state

    addr = args.address
    if args.cmd == "head":
        if args.head_cmd == "start":
            from ray_tpu_torch.core import head_main

            argv = ["--host", args.host, "--port", str(args.port)]
            if args.session_id:
                argv += ["--session-id", args.session_id]
            if args.persist:
                argv += ["--persist", args.persist]
            if args.address_file:
                argv += ["--address-file", args.address_file]
            head_main.main(argv)
            return 0
        return 1
    if args.cmd == "head-restart":
        from ray_tpu_torch.utils.rpc import RemoteError, RpcClient

        if not addr:
            print("--address (or $RT_ADDRESS) required", file=sys.stderr)
            return 2
        client = RpcClient(addr, name="head-restart")
        try:
            client.call("head_restart", timeout_s=15.0)
            print(f"head at {addr} restarting (reconciliation follows)")
            return 0
        except RemoteError as e:
            if "no handler" in str(e):
                print(
                    "head-restart needs a standalone head "
                    "(`rt head start --persist ... --port ...`); this head "
                    "runs inside a driver process", file=sys.stderr,
                )
            else:
                print(f"head refused restart: {e}", file=sys.stderr)
            return 1
        finally:
            client.close()
    if args.cmd == "status":
        st = state.cluster_status(addr)
        if args.as_json:
            print(json.dumps(st, indent=2))
        else:
            res = st["resources_total"]
            avail = st["resources_available"]
            print(f"nodes: {st['nodes_alive']} alive, {st['nodes_dead']} dead")
            print(f"workers: {st['workers']}")
            ha = st.get("head_ha") or {}
            if ha.get("enabled"):
                line = (
                    f"head HA: durable log on (epoch {ha.get('epoch', 0)}, "
                    f"{ha.get('wal_since_snapshot', 0)} WAL entries since "
                    f"snapshot)"
                )
                if ha.get("recovering"):
                    line += (
                        f"; RECONCILING ({len(ha.get('unreconciled_nodes', []))} "
                        f"nodes pending, {ha.get('reconcile_remaining_s', 0):.1f}s "
                        f"left in window)"
                    )
                print(line)
            else:
                print("head HA: off (in-memory control store)")
            print(
                "actors: "
                + ", ".join(f"{k}={v}" for k, v in st["actors"].items())
            )
            for k in sorted(res):
                print(f"  {k}: {avail.get(k, 0.0):g}/{res[k]:g} available")
            obj = st["object_store"]
            print(
                f"object store: {obj['used_bytes']:,}/"
                f"{obj['capacity_bytes']:,} bytes used, "
                f"{obj['spilled_objects']} objects "
                f"({obj['spilled_bytes']:,} bytes) spilled"
            )
        return 0
    if args.cmd == "list":
        what = args.what
        fetch = {
            "nodes": (state.list_nodes, ["node_id", "address", "alive"]),
            "actors": (
                state.list_actors,
                ["actor_id", "class_name", "state", "name", "num_restarts"],
            ),
            "jobs": (state.list_jobs, ["job_id", "driver_address", "alive"]),
            "workers": (
                state.list_workers, ["worker_id", "node_id", "pid", "state"],
            ),
            "placement-groups": (
                state.list_placement_groups, ["pg_id", "strategy", "state"],
            ),
        }[what]
        rows = fetch[0](addr)
        if args.as_json:
            print(json.dumps(rows, indent=2, default=str))
        else:
            print(_fmt_table(rows, fetch[1]))
        return 0
    if args.cmd == "timeline":
        path = state.timeline(addr, out_path=args.out)
        print(f"wrote {path} (open in chrome://tracing or ui.perfetto.dev)")
        return 0
    if args.cmd == "memory":
        objs = [
            o for o in state.objects(addr)
            if (o.get("size") or 0) >= args.min_bytes or o.get("borrows")
            or o.get("inflight_pins")
        ]
        if args.as_json:
            print(json.dumps(objs, indent=2))
            return 0
        rows = []
        for o in objs:
            rows.append({
                "object_id": o["object_id"][:16],
                "node": (o.get("node_id") or "-")[:8],
                "location": o.get("location", "-"),
                "size": o.get("size") if o.get("size") is not None else "-",
                "state": o.get("state", "-"),
                "borrows": o.get("borrows", 0),
                "pins": o.get("inflight_pins", 0),
                "oldest_pin_s": (
                    f"{o['oldest_pin_age_s']:.1f}"
                    if o.get("oldest_pin_age_s") else "-"
                ),
            })
        print(_fmt_table(rows, [
            "object_id", "node", "location", "size", "state",
            "borrows", "pins", "oldest_pin_s",
        ]))
        leaked = {
            o["object_id"] for o in objs
            if o.get("oldest_pin_age_s", 0) > 60.0 and o.get("inflight_pins")
        }
        if leaked:
            print(
                f"warning: {len(leaked)} object(s) held by in-flight pins "
                f"older than 60s — likely leaked borrows"
            )
        return 0
    if args.cmd == "logs":
        logs = state.worker_logs(addr, tail_bytes=args.tail_bytes)
        if args.as_json:
            print(json.dumps(logs, indent=2))
            return 0
        if args.job_id:
            print(f"# worker logs (cluster-wide; job {args.job_id})")
        for entry in logs:
            if not entry["tail"]:
                continue
            who = entry.get("worker_id", entry["file"])
            print(
                f"==> node {entry['node_id'][:8]} {who} "
                f"[{entry['stream']}] <=="
            )
            print(entry["tail"], end="" if entry["tail"].endswith("\n") else "\n")
        return 0
    if args.cmd == "summary":
        summary = state.task_summary(addr)
        if args.as_json:
            print(json.dumps(summary, indent=2))
            return 0
        rows = []
        for name, entry in summary["tasks"].items():
            qw = entry.get("queue_wait_s")
            ex = entry["exec_s"]

            def ms(v):
                return f"{v * 1e3:.2f}"

            rows.append({
                "name": name,
                "count": entry["count"],
                "queue_p50_ms": ms(qw["p50"]) if qw else "-",
                "queue_p95_ms": ms(qw["p95"]) if qw else "-",
                "queue_p99_ms": ms(qw["p99"]) if qw else "-",
                "exec_p50_ms": ms(ex["p50"]),
                "exec_p95_ms": ms(ex["p95"]),
                "exec_p99_ms": ms(ex["p99"]),
            })
        print(_fmt_table(rows, [
            "name", "count", "queue_p50_ms", "queue_p95_ms",
            "queue_p99_ms", "exec_p50_ms", "exec_p95_ms", "exec_p99_ms",
        ]))
        if summary["events_dropped"]:
            print(
                f"warning: {summary['events_dropped']} events dropped from "
                f"bounded buffers — percentiles cover a truncated window"
            )
        return 0
    if args.cmd == "metrics":
        from ray_tpu_torch.utils import metrics as metrics_mod

        print(metrics_mod.prometheus_text(state.cluster_metrics(addr)), end="")
        return 0
    if args.cmd == "alerts":
        from ray_tpu_torch.utils.rpc import RemoteError

        try:
            rep = state.alerts(addr)
        except RemoteError:
            rep = {"enabled": False, "alerts": []}
        if args.as_json:
            print(json.dumps(rep, indent=2, default=str))
        elif not rep.get("enabled"):
            print("alerting disabled (RT_METRICS_SAMPLE_INTERVAL_S=0, "
                  "RT_ALERTS_ENABLED=0, or observability off)")
        else:
            rows = []
            for a in rep["alerts"]:
                rows.append({
                    "rule": a["name"],
                    "state": a["state"].upper()
                    if a["state"] == "firing" else a["state"],
                    "severity": a["severity"],
                    "metric": a["metric"],
                    "value": (
                        f"{a['value']:.4g}" if a.get("value") is not None
                        else "-"
                    ),
                    "since_s": (
                        f"{a['since_s']:.0f}" if a.get("since_s") is not None
                        else "-"
                    ),
                })
            print(_fmt_table(rows, [
                "rule", "state", "severity", "metric", "value", "since_s",
            ]))
        # scriptable: non-zero while anything fires (cron/CI gating)
        return 2 if any(
            a.get("state") == "firing" for a in rep.get("alerts", ())
        ) else 0
    if args.cmd == "top":
        import time as _time

        from ray_tpu_torch.observability.history import counter_delta
        from ray_tpu_torch.utils.rpc import RemoteError

        def frame(qps):
            mx = state.cluster_metrics(addr)
            reqs = state.request_summary(addr)
            try:
                alerts_rep = state.alerts(addr)
            except (RemoteError, RuntimeError):
                alerts_rep = {"enabled": False, "alerts": []}
            hist = _top_history(state, addr, args.since, _router_deps(mx))
            try:
                ascale = state.autoscale_status(addr)
            except Exception:  # noqa: BLE001 — no serve controller
                ascale = {}
            if args.as_json:
                return mx, json.dumps(
                    {"metrics": {
                        name: dict(m, series={
                            ",".join(k): v for k, v in m["series"].items()
                        }) for name, m in mx.items()
                    }, "requests": reqs, "alerts": alerts_rep,
                        "history": hist, "autoscale": ascale},
                    indent=2, default=str,
                )
            return mx, _render_top(mx, reqs, qps, alerts_rep=alerts_rep,
                                   hist=hist, ascale=ascale)

        if args.once:
            print(frame(None)[1])
            return 0
        prev: Optional[dict] = None
        prev_t = 0.0
        qps: Optional[dict] = None
        try:
            while True:
                mx, text = frame(qps)
                # QPS = reset-aware router-counter delta over the frame
                # gap (a restarted replica's counter going backwards
                # counts as a fresh start, not a zero-QPS frame)
                m = mx.get("rt_serve_router_requests_total") or {}
                cur = {}
                for k, v in m.get("series", {}).items():
                    dep = dict(
                        zip(m.get("tag_keys", ()), k)
                    ).get("deployment") or "?"
                    cur[dep] = cur.get(dep, 0.0) + v
                now = _time.monotonic()
                if prev is not None and now > prev_t:
                    qps = {
                        d: counter_delta(prev.get(d), v) / (now - prev_t)
                        for d, v in cur.items()
                    }
                prev, prev_t = cur, now
                sys.stdout.write("\x1b[2J\x1b[H" + text + "\n")
                sys.stdout.flush()
                _time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0
    if args.cmd == "profile":
        from ray_tpu_torch.observability import profiler as profiler_mod

        merged = state.profile(
            duration_s=args.duration, hz=args.hz, address=addr
        )
        if args.as_json:
            print(json.dumps(merged, indent=2))
            return 0
        print(
            f"profiled {merged['processes']}/{merged['targets']} processes "
            f"for {merged['duration_s']:g}s @ {merged['hz']:g} Hz — "
            f"{merged['samples']} thread samples"
        )
        print()
        print(profiler_mod.subsystem_table(merged["subsystems"]))
        if args.out:
            with open(args.out, "w") as f:
                f.write(profiler_mod.folded_text(merged["folded"]))
            print(f"\nwrote {args.out} (collapsed stacks; flamegraph.pl "
                  f"/ speedscope compatible)")
        if args.html:
            with open(args.html, "w") as f:
                f.write(profiler_mod.flamegraph_html(
                    merged["folded"],
                    title=f"rt profile — {merged['samples']} samples",
                ))
            print(f"wrote {args.html} (self-contained flamegraph)")
        return 0
    if args.cmd == "stacks":
        from ray_tpu_torch.observability import forensics as forensics_mod

        dumps = state.stacks(address=addr, node=args.node)
        if args.as_json:
            print(json.dumps(dumps, indent=2))
            return 0
        if not dumps:
            print("no live processes reachable")
            return 1
        for dump in dumps:
            print(f"==> {dump.get('role', '?')} pid {dump.get('pid')} "
                  f"@ {dump.get('address')} <==")
            print(forensics_mod.format_stack_dump(dump))
            print()
        return 0
    if args.cmd == "postmortem":
        from ray_tpu_torch.observability import forensics as forensics_mod

        pid = node = None
        if args.target:
            if args.target.isdigit():
                pid = int(args.target)
            else:
                node = args.target
        try:
            reports = state.crash_reports(address=addr, pid=pid, node=node)
        except RuntimeError:
            # no cluster reachable — scan this host's crash dirs directly
            # (the dead-cluster case is exactly when postmortems matter)
            reports = forensics_mod.list_crash_reports(pid=pid)
        if not args.show_alive:
            dead = [r for r in reports if not r.get("alive")]
            # with an explicit pid target show it regardless of liveness
            reports = reports if (pid is not None and not dead) else dead
        if args.as_json:
            print(json.dumps(reports, indent=2, default=str))
            return 0
        if not reports:
            print("no crash artifacts found"
                  + ("" if args.show_alive else " for dead processes "
                     "(--all includes live ones)"))
            return 0
        for rec in reports:
            print(forensics_mod.render_report(rec))
            print()
        return 0
    if args.cmd == "dashboard":
        import time as _time

        from ray_tpu_torch.dashboard import Dashboard

        if not addr:
            print("--address (or $RT_ADDRESS) required", file=sys.stderr)
            return 2
        d = Dashboard(addr, host=args.host, port=args.port)
        d.start()
        print(f"dashboard serving on http://{d.address} (ctrl-c to stop)")
        try:
            while True:
                _time.sleep(3600)
        except KeyboardInterrupt:
            d.stop()
        return 0
    if args.cmd == "job":
        from ray_tpu_torch.job_submission import JobSubmissionClient

        client = JobSubmissionClient(addr)
        if args.job_cmd == "submit":
            import shlex

            entry = list(args.entrypoint)
            if entry and entry[0] == "--":  # strip ONLY the separator
                entry = entry[1:]
            if not entry:
                print("no entrypoint given", file=sys.stderr)
                return 2
            # shlex.join preserves quoting through the supervisor's shell
            sid = client.submit_job(entrypoint=shlex.join(entry))
            print(sid)
            if args.wait:
                status = client.wait_until_finished(sid)
                print(status)
                return 0 if status == "SUCCEEDED" else 1
            return 0
        if args.job_cmd == "status":
            print(client.get_job_status(args.submission_id))
            return 0
        if args.job_cmd == "logs":
            print(client.get_job_logs(args.submission_id), end="")
            return 0
        if args.job_cmd == "stop":
            print(client.stop_job(args.submission_id))
            return 0
        if args.job_cmd == "list":
            if args.as_json:
                print(json.dumps(client.list_jobs(), indent=2))
            else:
                print(_fmt_table(
                    client.list_jobs(),
                    ["submission_id", "status", "entrypoint"],
                ))
            return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())

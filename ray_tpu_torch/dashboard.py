"""Dashboard — HTTP view of the cluster.

Parity: the reference dashboard head (python/ray/dashboard/head.py) at
its observability core: JSON APIs over the state aggregator plus a
self-refreshing HTML summary. Heavy UI, per-node agents, and Grafana
provisioning are out of scope — the state API (state.py) carries the
same data to programmatic consumers.

Endpoints: /           HTML summary (auto-refresh)
           /api/status /api/nodes /api/actors /api/jobs /api/workers
           /api/placement_groups /api/timeline /api/alerts
           /api/profile?duration_s=&hz= (fleet sampling profile, merged)
           /api/stacks?node= (all-thread dumps)  /api/crash_reports
           /api/metrics/history?name=&window_s=&step_s=&tags={...}
           /metrics (Prometheus text)
"""

from __future__ import annotations

import html
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qsl, urlparse

from ray_tpu_torch import state
from ray_tpu_torch.utils import metrics as metrics_mod

_PAGE = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title>
<meta http-equiv="refresh" content="5">
<style>
 body {{ font-family: monospace; margin: 2em; }}
 table {{ border-collapse: collapse; margin: 1em 0; }}
 td, th {{ border: 1px solid #999; padding: 4px 10px; text-align: left; }}
 h2 {{ margin-top: 1.5em; }}
</style></head><body>
<h1>ray_tpu_torch cluster</h1>
<pre>{status}</pre>
<h2>nodes</h2>{nodes}
<h2>actors</h2>{actors}
<h2>jobs</h2>{jobs}
<p>APIs: /api/status /api/nodes /api/actors /api/jobs /api/workers
/api/placement_groups /api/timeline /api/task_summary
/api/request_summary /api/alerts
/api/profile?duration_s=&amp;hz= /api/stacks?node=
/api/crash_reports?pid=&amp;node=
/api/metrics/history?name=&amp;window_s=&amp;step_s=&amp;tags= /metrics</p>
</body></html>"""


def _table(rows, columns) -> str:
    head = "".join(f"<th>{html.escape(c)}</th>" for c in columns)
    body = "".join(
        "<tr>" + "".join(
            f"<td>{html.escape(str(r.get(c, '')))}</td>" for c in columns
        ) + "</tr>"
        for r in rows
    )
    return f"<table><tr>{head}</tr>{body}</table>"


class Dashboard:
    def __init__(self, control_address: str, host: str = "127.0.0.1",
                 port: int = 0):
        # loopback by default: the JSON APIs are unauthenticated (the
        # reference dashboard binds localhost for the same reason);
        # exposing beyond the host is an explicit host= opt-in
        self.control_address = control_address
        dash = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _respond(self, status, ctype, body):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    status, ctype, body = dash._route(self.path)
                except Exception as e:  # noqa: BLE001
                    status, ctype = 500, "application/json"
                    body = json.dumps({"error": str(e)}).encode()
                self._respond(status, ctype, body)

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    payload = self.rfile.read(length) if length else b""
                    status, ctype, body = dash._route_post(
                        self.path, payload
                    )
                except Exception as e:  # noqa: BLE001
                    status, ctype = 500, "application/json"
                    body = json.dumps({"error": str(e)}).encode()
                self._respond(status, ctype, body)

            def do_DELETE(self):
                # DELETE /api/jobs/<sid> deletes a terminal job's record
                # (reference job API; stopping a running job is POST
                # .../stop)
                try:
                    status, ctype, body = dash._route_post(
                        self.path.rstrip("/") + "/delete", b""
                    )
                except Exception as e:  # noqa: BLE001
                    status, ctype = 500, "application/json"
                    body = json.dumps({"error": str(e)}).encode()
                self._respond(status, ctype, body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self._server.server_address[:2]
        if host in ("0.0.0.0", "::"):  # wildcard bind isn't connectable
            host = "127.0.0.1"
        return f"{host}:{port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="dashboard", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # ------------------------------------------------------------------

    def _route(self, path: str):
        addr = self.control_address
        # split the query string: /api/metrics/history takes parameters,
        # and exact-path matching must not break on "?…" suffixes
        parsed = urlparse(path)
        path = parsed.path
        qs = dict(parse_qsl(parsed.query))
        apis = {
            "/api/status": lambda: state.cluster_status(addr),
            "/api/nodes": lambda: state.list_nodes(addr),
            "/api/actors": lambda: state.list_actors(addr),
            "/api/jobs": lambda: state.list_jobs(addr),
            "/api/workers": lambda: state.list_workers(addr),
            "/api/placement_groups": lambda: state.list_placement_groups(addr),
            "/api/timeline": lambda: state.timeline(addr),
            "/api/task_summary": lambda: state.task_summary(addr),
            "/api/request_summary": lambda: state.request_summary(addr),
            "/api/alerts": lambda: state.alerts(addr),
            "/api/profile": lambda: state.profile(
                duration_s=(
                    float(qs["duration_s"]) if qs.get("duration_s") else 5.0
                ),
                hz=float(qs["hz"]) if qs.get("hz") else 99.0,
                address=addr,
            ),
            "/api/stacks": lambda: state.stacks(
                address=addr, node=qs.get("node"),
            ),
            "/api/crash_reports": lambda: state.crash_reports(
                address=addr,
                pid=int(qs["pid"]) if qs.get("pid") else None,
                node=qs.get("node"),
            ),
            "/api/metrics/history": lambda: state.metrics_history(
                name=qs.get("name"),
                tags=json.loads(qs["tags"]) if qs.get("tags") else None,
                window_s=float(qs["window_s"]) if qs.get("window_s") else None,
                step_s=float(qs["step_s"]) if qs.get("step_s") else None,
                address=addr,
            ),
        }
        if path in apis:
            return (
                200, "application/json",
                json.dumps(apis[path](), default=str).encode(),
            )
        if path.startswith("/api/jobs/"):
            return self._route_job_get(path)
        if path == "/metrics":
            text = metrics_mod.prometheus_text(state.cluster_metrics(addr))
            return 200, "text/plain; version=0.0.4", text.encode()
        if path in ("/", "/index.html"):
            st = state.cluster_status(addr)
            page = _PAGE.format(
                status=html.escape(json.dumps(st, indent=2)),
                nodes=_table(
                    state.list_nodes(addr),
                    ["node_id", "address", "alive", "active_leases",
                     "pending_leases"],
                ),
                actors=_table(
                    state.list_actors(addr),
                    ["actor_id", "class_name", "state", "name"],
                ),
                jobs=_table(
                    state.list_jobs(addr), ["job_id", "alive"],
                ),
            )
            return 200, "text/html", page.encode()
        return 404, "application/json", b'{"error": "not found"}'

    # -- job submission REST API (reference dashboard job module:
    # python/ray/dashboard/modules/job/job_manager.py:62 — submit/
    # status/logs/stop over HTTP, so `curl` and CI drive jobs with no
    # in-process client) -----------------------------------------------

    def _job_client(self):
        from ray_tpu_torch.job_submission import JobSubmissionClient

        if getattr(self, "_jobs_client", None) is None:
            self._jobs_client = JobSubmissionClient()
        return self._jobs_client

    def _route_job_get(self, path: str):
        parts = [p for p in path.split("/") if p]  # api, jobs, sid, [sub]
        client = self._job_client()
        if parts == ["api", "jobs", "submissions"]:
            return (
                200, "application/json",
                json.dumps(client.list_jobs(), default=str).encode(),
            )
        sid = parts[2]
        if len(parts) == 3:
            return (
                200, "application/json",
                json.dumps(client.get_job_info(sid), default=str).encode(),
            )
        if len(parts) == 4 and parts[3] == "logs":
            return (
                200, "application/json",
                json.dumps({"logs": client.get_job_logs(sid)}).encode(),
            )
        return 404, "application/json", b'{"error": "not found"}'

    def _route_post(self, path: str, payload: bytes):
        parts = [p for p in path.split("/") if p]
        if parts[:2] != ["api", "jobs"]:
            return 404, "application/json", b'{"error": "not found"}'
        client = self._job_client()
        if len(parts) == 2:  # POST /api/jobs — submit
            body = json.loads(payload or b"{}")
            entrypoint = body.get("entrypoint")
            if not entrypoint:
                return (
                    400, "application/json",
                    b'{"error": "entrypoint required"}',
                )
            sid = client.submit_job(
                entrypoint=entrypoint,
                submission_id=body.get("submission_id"),
                runtime_env=body.get("runtime_env"),
            )
            return (
                200, "application/json",
                json.dumps({"submission_id": sid}).encode(),
            )
        if len(parts) == 4 and parts[3] == "stop":
            stopped = client.stop_job(parts[2])
            return (
                200, "application/json",
                json.dumps({"stopped": bool(stopped)}).encode(),
            )
        if len(parts) == 4 and parts[3] == "delete":
            deleted = client.delete_job(parts[2])
            return (
                200, "application/json",
                json.dumps({"deleted": bool(deleted)}).encode(),
            )
        return 404, "application/json", b'{"error": "not found"}'


def start_dashboard(control_address: Optional[str] = None,
                    port: int = 0) -> Dashboard:
    if control_address is None:
        from ray_tpu_torch.core import worker as worker_mod

        control_address = worker_mod.global_worker().control_address
    dash = Dashboard(control_address, port=port)
    dash.start()
    return dash

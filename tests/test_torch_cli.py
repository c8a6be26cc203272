"""The port's CLI and dashboard (``ray_tpu_torch/cli.py``, ``dashboard.py``,
``__main__.py``: pinned copies of the JAX package's) on one port cluster:
the twins of ``tests/test_observability.py::test_cli_smoke`` and
``::test_dashboard_endpoints``, ``tests/test_profiler.py::
test_cli_profile_writes_artifacts`` and
``::test_dashboard_profile_and_stacks_routes``, and
``tests/test_forensics.py::test_rt_stacks_cli_shows_fleet``; and
``python -m ray_tpu_torch status`` in a process of its own, with the
cluster's declared card and its NVLink domain's head."""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import pytest

import ray_tpu_torch
from ray_tpu_torch.core import cluster_utils
from ray_tpu_torch.core import worker as worker_mod

ROOT = Path(__file__).resolve().parent.parent
HEAD = "GPU-H100-80GB-HBM3-1-head"  # the declared card's domain head


@pytest.fixture(scope="module")
def rt():
    cluster_utils.sweep_stale_runtime()
    ray_tpu_torch.init(num_cpus=2, num_gpus=1, resources={HEAD: 1})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _addr() -> str:
    return worker_mod.global_worker().control_address


def test_cli_smoke(rt, tmp_path, capsys):
    from ray_tpu_torch.cli import main

    # a task for the summary to count (the JAX file's earlier tests ran some)
    assert ray_tpu_torch.get(ray_tpu_torch.remote(lambda: 1).remote()) == 1
    addr = _addr()
    assert main(["--address", addr, "status"]) == 0
    out = capsys.readouterr().out
    assert "nodes: " in out and "object store:" in out
    assert "  GPU: 1/1 available" in out and f"  {HEAD}: 1/1 available" in out
    assert main(["--address", addr, "list", "nodes"]) == 0
    assert "NODE_ID" in capsys.readouterr().out
    assert main(["--address", addr, "--json", "list", "actors"]) == 0
    json.loads(capsys.readouterr().out)
    tl = str(tmp_path / "t.json")
    assert main(["--address", addr, "timeline", "--out", tl]) == 0
    capsys.readouterr()
    json.load(open(tl))
    assert main(["--address", addr, "metrics"]) == 0
    capsys.readouterr()
    assert main(["--address", addr, "summary"]) == 0
    out = capsys.readouterr().out
    assert "QUEUE_P50_MS" in out and "EXEC_P99_MS" in out
    assert main(["--address", addr, "--json", "summary"]) == 0
    parsed = json.loads(capsys.readouterr().out)
    assert "tasks" in parsed and "events_dropped" in parsed
    assert main(["--address", addr, "memory"]) == 0
    out = capsys.readouterr().out
    assert "OBJECT_ID" in out or "(none)" in out
    assert main(["--address", addr, "--json", "memory"]) == 0
    json.loads(capsys.readouterr().out)
    assert main(["--address", addr, "logs"]) == 0
    capsys.readouterr()


def test_python_m_runs_the_ports_cli(rt):
    """``python -m ray_tpu_torch`` is the port's CLI, in a process that
    joins the cluster by its address alone."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("RT_ADDRESS", None)
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "--address", _addr(),
                          "--json", "status"], capture_output=True, text=True, timeout=120,
                         env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    st = json.loads(out.stdout)
    assert st["resources_total"]["GPU"] == 1.0 and st["resources_total"][HEAD] == 1.0
    assert st["nodes_alive"] == 1


def test_dashboard_endpoints(rt):
    from ray_tpu_torch.dashboard import start_dashboard

    @ray_tpu_torch.remote
    def tiny():
        return 1

    assert ray_tpu_torch.get(tiny.remote()) == 1
    dash = start_dashboard(port=0)
    try:
        host_port = dash.address.replace("0.0.0.0", "127.0.0.1")

        def fetch(path):
            with urllib.request.urlopen(f"http://{host_port}{path}", timeout=30) as resp:
                return resp.status, resp.read()

        status, body = fetch("/api/status")
        assert status == 200
        st = json.loads(body)
        assert st["nodes_alive"] >= 1 and st["resources_total"]["GPU"] == 1.0
        status, body = fetch("/api/nodes")
        nodes = json.loads(body)
        assert status == 200 and nodes
        assert any(n["resources_total"].get(HEAD) == 1.0 for n in nodes), nodes
        status, body = fetch("/api/timeline")
        assert status == 200
        assert any(e["name"] == "tiny" for e in json.loads(body))
        status, body = fetch("/api/task_summary")
        assert status == 200
        assert "tiny" in json.loads(body)["tasks"]
        status, body = fetch("/")
        assert status == 200 and b"ray_tpu_torch cluster" in body
        status, body = fetch("/metrics")
        assert status == 200
        rt_series = {
            line.split("{")[0].split(" ")[0]
            for line in body.decode().splitlines()
            if line.startswith("rt_") and not line.startswith("#")
        }
        assert len(rt_series) >= 8, f"built-in series seen: {rt_series}"
        with pytest.raises(urllib.error.HTTPError) as e:
            fetch("/nope")
        assert e.value.code == 404
    finally:
        dash.stop()


def test_cli_profile_writes_artifacts(rt, tmp_path, capsys):
    from ray_tpu_torch import cli

    folded_path = tmp_path / "p.folded"
    html_path = tmp_path / "p.html"
    rc = cli.main([
        "--address", _addr(), "profile", "--duration", "0.5", "--hz", "50",
        "--out", str(folded_path), "--html", str(html_path),
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "SUBSYSTEM" in out and "processes" in out
    folded = folded_path.read_text()
    assert folded and all(ln.rsplit(" ", 1)[1].isdigit() for ln in folded.splitlines())
    assert html_path.read_text().startswith("<!doctype html>")


def test_dashboard_profile_and_stacks_routes(rt):
    from ray_tpu_torch.dashboard import Dashboard

    d = Dashboard(_addr())
    try:
        status, ctype, body = d._route("/api/profile?duration_s=0.3&hz=50")
        assert status == 200 and ctype == "application/json"
        prof = json.loads(body)
        assert prof["samples"] > 0 and prof["subsystems"]
        status, _, body = d._route("/api/stacks")
        assert status == 200
        dumps = json.loads(body)
        assert dumps and all("threads" in rec for rec in dumps)
        status, _, body = d._route("/api/crash_reports")
        assert status == 200
        assert isinstance(json.loads(body), list)
    finally:
        d._server.server_close()


def test_rt_stacks_cli_shows_fleet(rt, capsys):
    from ray_tpu_torch import cli

    @ray_tpu_torch.remote
    class Pinned:
        def ok(self):
            return True

    a = Pinned.remote()  # at least one live worker process
    assert ray_tpu_torch.get(a.ok.remote())
    rc = cli.main(["--address", _addr(), "stacks"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "thread MainThread" in out
    assert out.count("==>") >= 2  # this process + at least one worker

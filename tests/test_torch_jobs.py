"""The port's job submission (``ray_tpu_torch/job_submission.py``) and the
dashboard's job routes (``ray_tpu_torch/dashboard.py``), pinned copies of
the JAX package's: the six tests of ``tests/test_jobs.py`` on one port
cluster. A job's supervisor is a CPU actor, so its entrypoint runs with
``CUDA_VISIBLE_DEVICES`` empty, as the JAX package's runs with
``JAX_PLATFORMS=cpu``: the test that joins the cluster checks it."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.core import cluster_utils
from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient


@pytest.fixture(scope="module")
def client():
    cluster_utils.sweep_stale_runtime()
    ray_tpu_torch.init(num_cpus=4)
    yield JobSubmissionClient()
    ray_tpu_torch.shutdown()


def test_job_succeeds_with_logs(client):
    sid = client.submit_job(
        entrypoint="python -c \"print('hello from job'); print(6*7)\"",
    )
    status = client.wait_until_finished(sid, timeout_s=120)
    assert status == JobStatus.SUCCEEDED
    logs = client.get_job_logs(sid)
    assert "hello from job" in logs and "42" in logs
    info = client.get_job_info(sid)
    assert info["returncode"] == 0


def test_job_joins_cluster(client):
    """The submitted script connects back to THIS cluster via RT_ADDRESS
    and runs a task on it."""
    script = (
        "import os, ray_tpu_torch; "
        "print('cards', repr(os.environ.get('CUDA_VISIBLE_DEVICES'))); "
        "ray_tpu_torch.init(address=os.environ['RT_ADDRESS']); "
        "f = ray_tpu_torch.remote(lambda: 'in-cluster'); "
        "print(ray_tpu_torch.get(f.remote()))"
    )
    sid = client.submit_job(entrypoint=f'python -c "{script}"')
    assert client.wait_until_finished(sid, timeout_s=180) == JobStatus.SUCCEEDED
    logs = client.get_job_logs(sid)
    assert "in-cluster" in logs
    assert "cards ''" in logs, logs  # the entrypoint sees no card


def test_job_failure_reported(client):
    sid = client.submit_job(entrypoint="python -c \"raise SystemExit(3)\"")
    assert client.wait_until_finished(sid, timeout_s=120) == JobStatus.FAILED
    assert client.get_job_info(sid)["returncode"] == 3


def test_job_stop(client):
    sid = client.submit_job(entrypoint="python -c \"import time; time.sleep(600)\"")
    deadline = time.monotonic() + 60
    while client.get_job_status(sid) != JobStatus.RUNNING:
        assert time.monotonic() < deadline
        time.sleep(0.2)
    assert client.stop_job(sid)
    assert client.wait_until_finished(sid, timeout_s=60) == JobStatus.STOPPED


def test_job_list(client):
    jobs = client.list_jobs()
    assert len(jobs) >= 4
    assert all("submission_id" in j for j in jobs)


def test_job_rest_api(client):
    """HTTP job API on the dashboard port (reference
    dashboard/modules/job/job_manager.py:62): submit/status/logs/stop via
    plain HTTP — what `curl` or CI would drive."""
    import json
    import urllib.request

    from ray_tpu_torch.dashboard import start_dashboard

    dash = start_dashboard()
    try:
        base = f"http://{dash.address}"

        def call(path, payload=None, method=None):
            data = json.dumps(payload).encode() if payload is not None else None
            req = urllib.request.Request(base + path, data=data, method=method)
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        # free the CPUs held by earlier tests' finished-job supervisors
        for j in call("/api/jobs/submissions"):
            if j.get("status") in ("SUCCEEDED", "FAILED", "STOPPED"):
                call(f"/api/jobs/{j['submission_id']}/delete", method="POST")

        sid = call("/api/jobs", {"entrypoint": "python -c \"print('rest-ok')\""})[
            "submission_id"
        ]
        deadline = time.monotonic() + 120
        while True:
            info = call(f"/api/jobs/{sid}")
            if info["status"] in ("SUCCEEDED", "FAILED", "STOPPED"):
                break
            assert time.monotonic() < deadline
            time.sleep(0.5)
        assert info["status"] == "SUCCEEDED"
        assert "rest-ok" in call(f"/api/jobs/{sid}/logs")["logs"]
        subs = call("/api/jobs/submissions")
        assert any(j.get("submission_id") == sid for j in subs)

        # stop flow: long job submitted over REST, stopped over REST
        sid2 = call(
            "/api/jobs",
            {"entrypoint": "python -c \"import time; time.sleep(600)\""},
        )["submission_id"]
        deadline = time.monotonic() + 60
        while call(f"/api/jobs/{sid2}")["status"] != "RUNNING":
            assert time.monotonic() < deadline
            time.sleep(0.2)
        assert call(f"/api/jobs/{sid2}/stop", method="POST")["stopped"]
        deadline = time.monotonic() + 60
        while call(f"/api/jobs/{sid2}")["status"] == "RUNNING":
            assert time.monotonic() < deadline
            time.sleep(0.2)
        assert call(f"/api/jobs/{sid2}")["status"] == "STOPPED"
    finally:
        dash.stop()

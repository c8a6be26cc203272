"""Job submission — run driver scripts on the cluster.

Parity: the reference job-submission stack (python/ray/dashboard/modules/
job/job_manager.py:62 + per-job JobSupervisor actor job_supervisor.py:57
+ the `ray job` CLI/SDK): submit_job starts a DETACHED supervisor actor
that runs the entrypoint command in a subprocess with RT_ADDRESS set (so
the script's ray_tpu_torch.init(address=...) joins this cluster), captures its
output, and serves status/logs. Detached lifetime means the job outlives
the submitting client.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"


@ray_tpu_torch.remote
class _JobSupervisor:
    """Owns one submitted job's subprocess (reference job_supervisor.py)."""

    def __init__(self, submission_id: str, entrypoint: str,
                 env_vars: Dict[str, str], control_address: str):
        self.submission_id = submission_id
        self.entrypoint = entrypoint
        self.env_vars = env_vars
        self.control_address = control_address
        self.status = JobStatus.PENDING
        self.returncode: Optional[int] = None
        self._proc = None
        self._log_chunks: List[str] = []
        import threading

        self._lock = threading.Lock()

    def start(self) -> bool:
        import os
        import subprocess
        import threading

        env = dict(os.environ)
        env.update(self.env_vars)
        env["RT_ADDRESS"] = self.control_address
        with self._lock:
            self.status = JobStatus.RUNNING
        self._proc = subprocess.Popen(
            self.entrypoint, shell=True, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True,
        )

        def pump():
            for line in self._proc.stdout:
                with self._lock:
                    self._log_chunks.append(line)
                    if len(self._log_chunks) > 100_000:
                        del self._log_chunks[:50_000]
            rc = self._proc.wait()
            with self._lock:
                self.returncode = rc
                if self.status != JobStatus.STOPPED:
                    self.status = (
                        JobStatus.SUCCEEDED if rc == 0 else JobStatus.FAILED
                    )

        threading.Thread(target=pump, name="job-pump", daemon=True).start()
        return True

    def get_status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "submission_id": self.submission_id,
                "entrypoint": self.entrypoint,
                "status": self.status,
                "returncode": self.returncode,
            }

    def get_logs(self) -> str:
        with self._lock:
            return "".join(self._log_chunks)

    def stop(self) -> bool:
        import os
        import signal

        if self._proc is not None and self._proc.poll() is None:
            with self._lock:
                self.status = JobStatus.STOPPED
            try:
                os.killpg(os.getpgid(self._proc.pid), signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
            return True
        return False


class JobSubmissionClient:
    """Parity: ray.job_submission.JobSubmissionClient."""

    def __init__(self, address: Optional[str] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address)
        from ray_tpu_torch.core import worker as worker_mod

        self._control_address = worker_mod.global_worker().control_address

    def submit_job(
        self,
        *,
        entrypoint: str,
        submission_id: Optional[str] = None,
        runtime_env: Optional[Dict[str, Any]] = None,
    ) -> str:
        submission_id = submission_id or f"rtjob_{uuid.uuid4().hex[:10]}"
        env_vars = dict((runtime_env or {}).get("env_vars") or {})
        sup = _JobSupervisor.options(
            name=f"JOB_SUP::{submission_id}",
            lifetime="detached",
            num_cpus=1,
            max_concurrency=4,  # status/logs answer while the job runs
        ).remote(
            submission_id, entrypoint, env_vars, self._control_address
        )
        ray_tpu_torch.get(sup.start.remote(), timeout=120)
        from ray_tpu_torch.core import worker as worker_mod

        worker_mod.global_worker().control.call(
            "kv_put", ns="job_submissions", key=submission_id,
            value=submission_id.encode(), retryable=True,
        )
        return submission_id

    def _sup(self, submission_id: str):
        return ray_tpu_torch.get_actor(f"JOB_SUP::{submission_id}")

    def get_job_status(self, submission_id: str) -> str:
        return ray_tpu_torch.get(
            self._sup(submission_id).get_status.remote(), timeout=30
        )["status"]

    def get_job_info(self, submission_id: str) -> Dict[str, Any]:
        return ray_tpu_torch.get(
            self._sup(submission_id).get_status.remote(), timeout=30
        )

    def get_job_logs(self, submission_id: str) -> str:
        return ray_tpu_torch.get(
            self._sup(submission_id).get_logs.remote(), timeout=30
        )

    def stop_job(self, submission_id: str) -> bool:
        return ray_tpu_torch.get(
            self._sup(submission_id).stop.remote(), timeout=30
        )

    def delete_job(self, submission_id: str) -> bool:
        """Remove a finished submission: kill its (detached) supervisor —
        freeing the CPU it holds for status/logs serving — and drop the
        registry entry (reference JobSubmissionClient.delete_job)."""
        status = self.get_job_status(submission_id)
        if status == JobStatus.RUNNING:
            raise RuntimeError(
                f"job {submission_id} is RUNNING; stop it first"
            )
        try:
            ray_tpu_torch.kill(self._sup(submission_id))
        except Exception:  # noqa: BLE001 — already gone
            pass
        from ray_tpu_torch.core import worker as worker_mod

        worker_mod.global_worker().control.call(
            "kv_del", ns="job_submissions", key=submission_id,
        )
        return True

    def list_jobs(self) -> List[Dict[str, Any]]:
        from ray_tpu_torch.core import worker as worker_mod

        control = worker_mod.global_worker().control
        ids = control.call("kv_keys", ns="job_submissions", prefix="")
        out = []
        for sid in ids:
            try:
                out.append(self.get_job_info(sid))
            except Exception:  # noqa: BLE001 — supervisor gone
                out.append({"submission_id": sid, "status": "UNKNOWN"})
        return out

    def wait_until_finished(self, submission_id: str,
                            timeout_s: float = 600.0) -> str:
        import time

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            status = self.get_job_status(submission_id)
            if status in (JobStatus.SUCCEEDED, JobStatus.FAILED,
                          JobStatus.STOPPED):
                return status
            time.sleep(0.5)
        raise TimeoutError(f"job {submission_id} still running")

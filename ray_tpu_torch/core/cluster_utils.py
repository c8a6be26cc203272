"""Multi-node-on-one-machine test harness.

Parity: python/ray/cluster_utils.py:135 ``Cluster`` — the linchpin of the
reference's distributed test strategy (SURVEY.md §4): start a control store
plus N node agents as separate processes on one machine, each with its own
resource spec; kill/restart nodes for fault-tolerance tests.
"""

from __future__ import annotations

import atexit
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.control_store import ControlStore
from ray_tpu_torch.utils.config import config
from ray_tpu_torch.utils.rpc import RpcClient

# Every daemon spawned through _spawn_with_handshake, for the atexit
# sweep: a test/bench run that dies without Cluster.shutdown() (assertion
# mid-fixture, Ctrl-C) must not leave node_main/head_main process groups
# — and their workers' /dev/shm segments — behind.
_SPAWNED: List[subprocess.Popen] = []
_atexit_registered = False

_DAEMON_MARKERS = (
    "ray_tpu_torch.core.node_main",
    "ray_tpu_torch.core.head_main",
    "ray_tpu_torch.core.worker_main",
)
# The port's own prefixes (rtt*, not the JAX runtime's rt*) and spill
# dirs under its temp_dir: neither runtime's sweep matches the other's files.
_SHM_DEBRIS_GLOBS = (
    "/dev/shm/rttshm_*", "/dev/shm/rttpool_*", "/dev/shm/rttchan_*",
)


def _kill_group(pid: int, sig: int = signal.SIGKILL) -> None:
    try:
        os.killpg(os.getpgid(pid), sig)
    except (ProcessLookupError, PermissionError):
        try:
            os.kill(pid, sig)
        except (ProcessLookupError, PermissionError):
            pass


def _atexit_sweep() -> None:
    for proc in _SPAWNED:
        if proc.poll() is None:
            _kill_group(proc.pid, signal.SIGTERM)
    deadline = time.monotonic() + 3.0
    for proc in _SPAWNED:
        while proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        if proc.poll() is None:
            _kill_group(proc.pid, signal.SIGKILL)


def _track_spawned(proc: subprocess.Popen) -> None:
    global _atexit_registered
    if not _atexit_registered:
        atexit.register(_atexit_sweep)
        _atexit_registered = True
    _SPAWNED.append(proc)
    # completed daemons need no tracking; stop the list growing unbounded
    # in long sessions (autoscaler churn spawns many short-lived agents)
    if len(_SPAWNED) > 256:
        _SPAWNED[:] = [p for p in _SPAWNED if p.poll() is None]


def sweep_stale_runtime(min_debris_age_s: float = 10.0) -> Dict[str, int]:
    """Reap debris a SIGKILLed previous run left behind: orphaned
    ray_tpu_torch daemon processes (node_main/head_main/worker_main whose
    spawning driver is gone — they reparent to pid 1) and their shm/spill
    files (/dev/shm/rttshm_* segments, rttpool_* recycle pools, rttchan_*
    compiled-graph channels, <temp_dir>/rttspill_* spill dirs).

    Call at test-session / bench start: leaked node_main processes hold
    CPU and ports that cascade-fail late test_serve runs and depress
    serve/RPC benches. Concurrent-run safety, in order: only ORPHANS die
    (a daemon whose parent — another live pytest/bench/driver — still
    exists is left alone); files mapped by ANY live process
    (/proc/*/maps scan — mmap writes never touch st_mtime, so age alone
    can't prove staleness) are skipped; files carrying the session
    prefix of a surviving daemon are skipped; and the
    ``min_debris_age_s`` gate protects clusters mid-boot whose files
    exist but are not yet mapped.

    Returns {"killed": n_processes, "removed": n_paths}."""
    killed = 0
    live_sessions: set = set()
    mapped_paths: set = set()
    for pid_dir in glob.glob("/proc/[0-9]*"):
        try:
            pid = int(os.path.basename(pid_dir))
            if pid == os.getpid():
                continue
            with open(os.path.join(pid_dir, "cmdline"), "rb") as f:
                argv = f.read().split(b"\x00")
            cmdline = b" ".join(argv).decode(errors="replace")
            if any(m in cmdline for m in _DAEMON_MARKERS):
                with open(os.path.join(pid_dir, "stat")) as f:
                    # field 4 of /proc/pid/stat is ppid; comm (field 2)
                    # may contain spaces but is parenthesized — split
                    # after ')'
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
                if ppid == 1 or not os.path.exists(f"/proc/{ppid}"):
                    _kill_group(pid, signal.SIGKILL)
                    killed += 1
                    continue
                # surviving daemon: remember its session so its files
                # (incl. never-mapped recycle-pool segments) are spared
                args = [a.decode(errors="replace") for a in argv]
                if "--session-id" in args:
                    sid = args[args.index("--session-id") + 1]
                    live_sessions.add(sid[:8])
            # any live process's mappings protect the files it holds
            with open(os.path.join(pid_dir, "maps")) as f:
                for line in f:
                    if "/dev/shm/rtt" in line or "/rttspill_" in line:
                        mapped_paths.add(
                            line.split(None, 5)[-1].strip()
                            .replace(" (deleted)", "")
                        )
        except (OSError, ValueError, IndexError):
            continue  # process vanished mid-scan
    removed = 0
    cutoff = time.time() - min_debris_age_s
    spill_glob = os.path.join(str(config.temp_dir), "rttspill_*")
    for pattern in _SHM_DEBRIS_GLOBS + (spill_glob,):
        for path in glob.glob(pattern):
            try:
                name = os.path.basename(path)
                session8 = (
                    name.split("_")[1][:8] if "_" in name else ""
                )
                if path in mapped_paths or session8 in live_sessions:
                    continue  # a live run owns it
                if os.lstat(path).st_mtime >= cutoff:
                    continue
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    os.unlink(path)
                removed += 1
            except OSError:
                continue
    return {"killed": killed, "removed": removed}


def _spawn_with_handshake(
    cmd: List[str],
    session_id: str,
    log_prefix: str,
    startup_timeout_s: float = 60.0,
    env: Optional[Dict[str, str]] = None,
):
    """Spawn a cluster daemon and wait for its one-line JSON startup
    handshake — THE spawn protocol, shared by node agents and standalone
    heads (it must not fork per call site)."""
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env["RT_CONFIG_SNAPSHOT"] = config.snapshot()
    # stderr goes to a FILE, not a pipe: nothing drains daemon logs for
    # the process's lifetime, and a filled 64KB pipe would block it
    log_dir = os.path.join(config.temp_dir, f"session_{session_id[:8]}", "logs")
    os.makedirs(log_dir, exist_ok=True)
    stderr_path = os.path.join(
        log_dir, f"{log_prefix}-{uuid.uuid4().hex[:8]}.err"
    )
    stderr_f = open(stderr_path, "wb")
    try:
        proc = subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=stderr_f,
            start_new_session=True,
        )
    finally:
        stderr_f.close()
    _track_spawned(proc)
    import selectors

    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    try:
        ready = sel.select(timeout=startup_timeout_s)
    finally:
        sel.close()
    line = proc.stdout.readline().decode().strip() if ready else ""
    if not line:
        # EOF (startup crash) or hang: reap and surface the real cause
        try:
            proc.kill()
            proc.wait(timeout=10)
        except Exception:  # noqa: BLE001
            pass
        try:
            with open(stderr_path, "rb") as f:
                tail = f.read()[-2000:].decode(errors="replace")
        except OSError:
            tail = ""
        raise RuntimeError(
            f"{log_prefix} spawn failed (rc={proc.returncode}): {tail}"
        )
    return proc, json.loads(line)


def spawn_node_agent(
    control_address: str,
    session_id: str,
    resources: Dict[str, float],
    labels: Optional[Dict[str, str]] = None,
    startup_timeout_s: float = 60.0,
    env: Optional[Dict[str, str]] = None,
):
    """Start a node agent process (shared by the test Cluster and the
    autoscaler's node providers); ``env`` sets variables in its environment
    only."""
    return _spawn_with_handshake(
        [
            sys.executable, "-m", "ray_tpu_torch.core.node_main",
            "--control-address", control_address,
            "--session-id", session_id,
            "--resources", json.dumps(resources),
            "--labels", json.dumps(labels or {}),
        ],
        session_id, "node", startup_timeout_s, env=env,
    )


def spawn_head(
    session_id: str,
    host: str = "127.0.0.1",
    port: int = 0,
    persistence_path: Optional[str] = None,
    address_file: Optional[str] = None,
    startup_timeout_s: float = 60.0,
):
    """Start a standalone head process (core/head_main.py) — the harness
    for head fault-tolerance tests (kill -9 the head, spawn it again on
    the same port + durable log) and for `rt head start`."""
    cmd = [
        sys.executable, "-m", "ray_tpu_torch.core.head_main",
        "--host", host, "--port", str(port),
        "--session-id", session_id,
    ]
    if persistence_path:
        cmd += ["--persist", persistence_path]
    if address_file:
        cmd += ["--address-file", address_file]
    return _spawn_with_handshake(cmd, session_id, "head", startup_timeout_s)


class ClusterNode:
    def __init__(self, node_id: str, address: str, proc: subprocess.Popen):
        self.node_id = node_id
        self.address = address
        self.proc = proc


class Cluster:
    """external_head=True runs the control store as its own process (via
    spawn_head) so tests can kill -9 and restart it; the default keeps
    the store in-process (fast, no failover surface)."""

    def __init__(self, external_head: bool = False,
                 persistence_path: Optional[str] = None,
                 address_file: Optional[str] = None):
        self.session_id = uuid.uuid4().hex
        self.persistence_path = persistence_path
        self.address_file = address_file
        self.control: Optional[ControlStore] = None
        self.head_proc: Optional[subprocess.Popen] = None
        self.gateway = None
        if external_head:
            self.head_proc, info = spawn_head(
                self.session_id,
                persistence_path=persistence_path,
                address_file=address_file,
            )
            self._address = info["address"]
            self._head_host, head_port = self._address.rsplit(":", 1)
            self._head_port = int(head_port)
        else:
            self.control = ControlStore(
                self.session_id, persistence_path=persistence_path
            )
            self.control.start()
            from ray_tpu_torch.utils.gateway import Gateway

            self.gateway = Gateway(self.control.address)
            self.gateway.start()
            self._address = self.control.address
        self.nodes: List[ClusterNode] = []

    @property
    def address(self) -> str:
        return self._address

    # -- head fault-tolerance harness (external_head only) --

    def kill_head(self) -> None:
        """SIGKILL the head process — the failure HA must survive."""
        assert self.head_proc is not None, "kill_head needs external_head"
        try:
            os.killpg(os.getpgid(self.head_proc.pid), 9)
        except (ProcessLookupError, PermissionError):
            self.head_proc.kill()
        self.head_proc.wait()

    def restart_head(self, wait_ready_s: float = 60.0) -> None:
        """Respawn the head on the SAME address + durable log and wait
        until its control store answers."""
        self.head_proc, info = spawn_head(
            self.session_id,
            host=self._head_host,
            port=self._head_port,
            persistence_path=self.persistence_path,
            address_file=self.address_file,
        )
        assert info["address"] == self._address, (
            f"head restarted at {info['address']}, expected {self._address}"
        )
        client = RpcClient(self._address, name="head-wait")
        deadline = time.monotonic() + wait_ready_s
        try:
            while time.monotonic() < deadline:
                try:
                    client.call("ha_status", timeout_s=5.0)
                    return
                except Exception:  # noqa: BLE001 — still booting
                    time.sleep(0.1)
            raise TimeoutError("restarted head did not become ready")
        finally:
            client.close()

    def add_node(
        self,
        num_cpus: float = 1,
        num_gpus: float = 0,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        wait: bool = True,
    ) -> ClusterNode:
        res = dict(resources or {})
        res["CPU"] = float(num_cpus)
        res["GPU"] = float(num_gpus)
        proc, info = spawn_node_agent(
            self.address, self.session_id, res, labels
        )
        node = ClusterNode(info["node_id"], info["address"], proc)
        self.nodes.append(node)
        if wait:
            self.wait_for_nodes(len(self.nodes))
        return node

    def wait_for_nodes(self, count: Optional[int] = None, timeout_s: float = 30.0) -> None:
        count = count if count is not None else len(self.nodes)
        client = RpcClient(self.address, name="cluster-wait")
        deadline = time.monotonic() + timeout_s
        try:
            while time.monotonic() < deadline:
                nodes = client.call("get_nodes")
                if len(nodes) >= count:
                    return
                time.sleep(0.05)
            raise TimeoutError(f"cluster did not reach {count} nodes")
        finally:
            client.close()

    def kill_node(self, node: ClusterNode) -> None:
        """Hard-kill a node agent AND its workers for FT tests. Workers
        run in their own sessions (start_new_session), so killing the
        agent's group alone would leave them orphaned and split-brain
        until their agent-watchdog fires — a real machine death takes
        everything down at once, and so must this simulation."""
        worker_pids: List[int] = []
        try:
            out = subprocess.run(
                ["pgrep", "-P", str(node.proc.pid)],
                capture_output=True, text=True, timeout=5,
            ).stdout
            worker_pids = [int(p) for p in out.split()]
        except Exception:  # noqa: BLE001
            pass
        try:
            os.killpg(os.getpgid(node.proc.pid), 9)
        except (ProcessLookupError, PermissionError):
            node.proc.kill()
        for pid in worker_pids:
            try:
                os.killpg(os.getpgid(pid), 9)
            except (ProcessLookupError, PermissionError):
                try:
                    os.kill(pid, 9)
                except ProcessLookupError:
                    pass
        node.proc.wait()
        client = RpcClient(self.address, name="cluster-kill")
        try:
            client.call("drain_node", node_id=node.node_id)
        except Exception:  # noqa: BLE001
            pass
        finally:
            client.close()
        self.nodes = [n for n in self.nodes if n is not node]

    def list_state(self) -> List[Dict[str, Any]]:
        client = RpcClient(self.address, name="cluster-state")
        try:
            return client.call("get_nodes")
        finally:
            client.close()

    def shutdown(self) -> None:
        if self.gateway is not None:
            try:
                self.gateway.stop()
            except Exception:  # noqa: BLE001
                pass
        for node in list(self.nodes):
            try:
                os.killpg(os.getpgid(node.proc.pid), 15)
            except (ProcessLookupError, PermissionError):
                node.proc.terminate()
        for node in self.nodes:
            try:
                node.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                node.proc.kill()
        self.nodes.clear()
        if self.control is not None:
            self.control.stop()
        if self.head_proc is not None and self.head_proc.poll() is None:
            try:
                os.killpg(os.getpgid(self.head_proc.pid), 15)
            except (ProcessLookupError, PermissionError):
                self.head_proc.terminate()
            try:
                self.head_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.head_proc.kill()

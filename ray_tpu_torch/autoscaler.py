"""Autoscaler — demand-driven node provisioning.

Parity: the reference autoscaler v2 (python/ray/autoscaler/v2/
autoscaler.py:50 — read cluster state, bin-pack pending demand,
reconcile instances through a NodeProvider). Demand here is the
pending-lease count each agent reports on its heartbeat (the role the
reference's resource_load syncer data plays); the provider abstraction
keeps cloud/k8s TPU-pod providers pluggable, with LocalNodeProvider
(subprocess node agents, the Cluster harness's mechanism) as the
in-repo implementation used by tests and single-host elasticity.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.utils.config import config
from ray_tpu_torch.utils.rpc import RpcClient, RpcError

logger = logging.getLogger(__name__)


class NodeProvider:
    """Pluggable node lifecycle (reference: autoscaler node providers)."""

    def create_node(self) -> str:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError

    def node_resources(self) -> Optional[Dict[str, float]]:
        """Resource shape of the node type this provider launches (the
        bin-packing target; reference autoscaler/v2/scheduler.py matches
        demand shapes to node types). None = unknown shape: providers
        that don't declare one keep the pre-shape-aware behavior (all
        demand counts as feasible) rather than having >1-CPU demand
        silently classified infeasible."""
        return None

    def shutdown(self) -> None:
        pass


class LocalNodeProvider(NodeProvider):
    """Spawns node agents as local processes (single-host elasticity and
    the test tier; a cloud provider would call instance APIs instead)."""

    def __init__(self, control_address: str, session_id: str,
                 resources: Optional[Dict[str, float]] = None):
        self.control_address = control_address
        self.session_id = session_id
        self.resources = dict(resources or {"CPU": 1.0})
        self._procs: Dict[str, subprocess.Popen] = {}

    def create_node(self) -> str:
        from ray_tpu_torch.core.cluster_utils import spawn_node_agent

        proc, info = spawn_node_agent(
            self.control_address, self.session_id, self.resources
        )
        self._procs[info["node_id"]] = proc
        logger.info("autoscaler launched node %s", info["node_id"][:8])
        return info["node_id"]

    def terminate_node(self, node_id: str) -> None:
        proc = self._procs.pop(node_id, None)
        if proc is None:
            return
        try:
            os.killpg(os.getpgid(proc.pid), 15)
        except (ProcessLookupError, PermissionError):
            proc.terminate()
        logger.info("autoscaler terminated node %s", node_id[:8])

    def node_resources(self) -> Dict[str, float]:
        return dict(self.resources)

    def shutdown(self) -> None:
        for nid in list(self._procs):
            self.terminate_node(nid)


# >>> ported: NVLink-domain provider
class GpuDomainProvider(NodeProvider):
    """NVLink-domain provider, the counterpart of the JAX package's
    ``TpuPodProvider``: provisions WHOLE domains as atoms. A domain is one
    host of N cards joined by NVLink (``accelerators/gpu.py``:
    ``domain_type`` names it by card and count, e.g. "H100-80GB-HBM3-2");
    the host carries ``GPU-<domain>-head`` once, which bundle 0 of each of
    a ``SlicePlacementGroup``'s groups claims, so ``hosts_per_slice`` is 1.

    ``card_sets`` lists the sets of card ids, N each, that the provider may
    hand out, e.g. ``[["0", "1"], ["2", "3"]]``: the machine's cards are
    its pool, as the JAX provider's mock backend spawns local agents shaped
    like slice hosts (a cloud provider would create an instance instead). A
    domain's node agent is spawned with its set as ``CUDA_VISIBLE_DEVICES``
    in its own environment, detects those cards and advertises the domain
    head itself; terminating the domain gives the set back. With no free
    set, ``create_slice`` provisions nothing. Without ``card_sets`` (a host
    with no cards: the CPU tests) each domain's agent declares N GPUs and
    the head resource."""

    def __init__(self, control_address: str, session_id: str, domain: str,
                 card_sets: Optional[List[List[str]]] = None):
        from ray_tpu_torch.accelerators.gpu import domain_head_resource

        self.control_address = control_address
        self.session_id = session_id
        self.domain = domain
        self.cards_per_host = int(domain.rsplit("-", 1)[1])
        self.head_resource = domain_head_resource(domain)
        # a CPU a card and one for the host's own tasks
        self.cpus_per_host = float(self.cards_per_host + 1)
        self.hosts_per_slice = 1
        self._free: Optional[List[List[str]]] = None
        if card_sets is not None:
            self._free = [[str(i) for i in s] for s in card_sets]
            ids = [i for s in self._free for i in s]
            if (any(len(s) != self.cards_per_host for s in self._free)
                    or len(set(ids)) != len(ids)):
                raise ValueError(
                    f"card_sets {card_sets}: each set must name "
                    f"{self.cards_per_host} cards of {domain}, no card twice"
                )
        self._lock = threading.Lock()
        self._slices: Dict[str, List[tuple]] = {}  # slice_id -> [(nid, proc)]
        self._cards: Dict[str, Optional[List[str]]] = {}  # slice_id -> its set
        self._next_slice = 0

    def node_resources(self) -> Dict[str, float]:
        return {"GPU": float(self.cards_per_host), "CPU": self.cpus_per_host}

    @property
    def free_card_sets(self) -> Optional[List[List[str]]]:
        """The sets not in use (None without ``card_sets``)."""
        with self._lock:
            return None if self._free is None else [list(s) for s in self._free]

    def create_slice(self) -> List[str]:
        """Provision one domain: its node id, in a list (hosts_per_slice of
        them), or an empty list when no card set is free."""
        from ray_tpu_torch.core.cluster_utils import spawn_node_agent

        with self._lock:
            if self._free is not None and not self._free:
                logger.info("no free card set for another %s domain", self.domain)
                return []
            cards = self._free.pop(0) if self._free is not None else None
            slice_id = f"{self.domain}-{self._next_slice}"
            self._next_slice += 1
        res: Dict[str, float] = {"CPU": self.cpus_per_host}
        env = None
        if cards is None:  # declared cards, and the head a host of them carries
            res.update({"GPU": float(self.cards_per_host), self.head_resource: 1.0})
        else:  # the agent sees only its set, and finds the domain itself
            env = {"CUDA_VISIBLE_DEVICES": ",".join(cards)}
        try:
            proc, info = spawn_node_agent(
                self.control_address, self.session_id, res,
                labels={"gpu-domain-type": self.domain, "gpu-domain": slice_id},
                env=env,
            )
        except Exception:
            if cards is not None:
                with self._lock:
                    self._free.insert(0, cards)
            raise
        with self._lock:
            self._slices[slice_id] = [(info["node_id"], proc)]
            self._cards[slice_id] = cards
        logger.info("provisioned NVLink domain %s (cards %s)", slice_id, cards)
        return [info["node_id"]]

    def create_node(self) -> Optional[str]:
        # a host request provisions a whole domain (the provider's atom);
        # None when no card set is free
        ids = self.create_slice()
        return ids[0] if ids else None

    def slice_of(self, node_id: str) -> Optional[str]:
        with self._lock:
            for sid, members in self._slices.items():
                if any(nid == node_id for nid, _ in members):
                    return sid
        return None

    def slice_members(self, slice_id: str) -> List[str]:
        with self._lock:
            return [nid for nid, _ in self._slices.get(slice_id, [])]

    def all_slice_members(self) -> List[str]:
        with self._lock:
            return [nid for members in self._slices.values() for nid, _ in members]

    def terminate_slice(self, slice_id: str) -> None:
        """Stop the domain's agent (it stops its workers) and wait for it
        to exit; then the domain leaves the provider's books and its card
        set goes back to the pool, in one step."""
        with self._lock:
            members = list(self._slices.get(slice_id, []))
        if not members:
            return
        for _, proc in members:
            try:
                os.killpg(os.getpgid(proc.pid), 15)
            except (ProcessLookupError, PermissionError):
                proc.terminate()
        for _, proc in members:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        with self._lock:
            if self._slices.pop(slice_id, None) is None:
                return  # another caller terminated it meanwhile
            cards = self._cards.pop(slice_id, None)
            if cards is not None:
                self._free.append(cards)
        logger.info("terminated NVLink domain %s", slice_id)

    def terminate_node(self, node_id: str) -> None:
        sid = self.slice_of(node_id)
        if sid is not None:
            self.terminate_slice(sid)

    def shutdown(self) -> None:
        with self._lock:
            sids = list(self._slices)
        for sid in sids:
            self.terminate_slice(sid)


def pending_domain_demand(pgs: List[Dict[str, Any]],
                          host_shape: Dict[str, float],
                          head_resource: str) -> int:
    """Hosts of ``host_shape`` that the PENDING (or RESCHEDULING)
    placement groups of this provider's domain need: one a group. A slice
    group of ``accelerators/slice_pg.py`` is one STRICT_PACK group a
    domain, bundle 0 claiming ``head_resource``; a group counts when its
    bundle 0 names that head, no bundle names another domain's head, and
    its bundles together fit one host (the head once, the rest within
    ``host_shape``). Any other group, a group of another domain type or
    one no host of this type could take, is not this provider's demand."""
    hosts = 0
    for pg in pgs:
        if pg.get("state") not in ("PENDING", "RESCHEDULING"):
            continue
        bundles = pg.get("bundles") or []
        if not bundles or bundles[0].get(head_resource, 0) <= 0:
            continue
        heads = {k for b in bundles for k, v in b.items()
                 if k.startswith("GPU-") and k.endswith("-head") and v > 0}
        if heads != {head_resource}:
            continue
        total: Dict[str, float] = {}
        for b in bundles:
            for k, v in b.items():
                total[k] = total.get(k, 0.0) + v
        if all(v <= (1.0 if k == head_resource else host_shape.get(k, 0.0))
               for k, v in total.items() if v > 0):
            hosts += 1  # STRICT_PACK: the whole group on one host
    return hosts
# <<< ported


class Autoscaler:
    """Scale up while any node reports pending leases; scale an idle
    autoscaler-launched node down after idle_timeout_s."""

    def __init__(
        self,
        control_address: str,
        provider: NodeProvider,
        min_nodes: int = 1,
        max_nodes: int = 4,
        idle_timeout_s: float = 30.0,
        poll_period_s: float = 1.0,
        upscale_cooldown_s: float = 3.0,
    ):
        self.control_address = control_address
        self.provider = provider
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.idle_timeout_s = idle_timeout_s
        self.poll_period_s = poll_period_s
        self.upscale_cooldown_s = upscale_cooldown_s
        self._launched: List[str] = []  # node_ids we created (LIFO down-scale)
        self._idle_since: Dict[str, float] = {}
        self._last_upscale = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="autoscaler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)
        self.provider.shutdown()

    def _loop(self) -> None:
        client = RpcClient(self.control_address, name="autoscaler")
        try:
            while not self._stop.wait(self.poll_period_s):
                try:
                    self._step(client)
                except Exception:  # noqa: BLE001 — keep reconciling
                    logger.exception("autoscaler step failed")
        finally:
            client.close()

    def _step_slices(self, client: RpcClient, nodes, n_alive: int) -> None:
        """Slice-atom scale-up: pending SlicePlacementGroup demand maps
        to WHOLE slices — a v5e-16 PG asks the provider for exactly its 4
        hosts, never CPU fillers (reference: the GKE provider adds a
        multi-host node pool per slice)."""
        provider = self.provider
        alive_ids = {n["node_id"] for n in nodes}
        booting = [
            nid for nid in provider.all_slice_members()
            if nid not in alive_ids
        ]
        if booting:
            # a previously-provisioned slice is still registering: wait
            # for it before judging demand again, or one pending PG
            # double-provisions every cooldown
            return
        try:
            pgs = client.call("list_placement_groups", timeout_s=10.0)
        except RpcError:
            return
        hosts_needed = pending_domain_demand(
            pgs, provider.node_resources(),
            head_resource=provider.head_resource,
        )
        if hosts_needed <= 0:
            return
        now = time.monotonic()
        if now - self._last_upscale < self.upscale_cooldown_s:
            return
        per_slice = provider.hosts_per_slice
        slices = -(-hosts_needed // per_slice)  # ceil
        budget = max(0, self.max_nodes - n_alive) // per_slice
        slices = min(slices, budget)
        if slices <= 0:
            return
        self._last_upscale = now
        for _ in range(slices):
            for nid in provider.create_slice():
                self._launched.append(nid)

    def _publish_infeasible(
        self, client: RpcClient, infeasible: List[Dict[str, float]],
        tmpl: Dict[str, float],
    ) -> None:
        """Surface truly-unschedulable demand in the control store KV so
        `rt status` can report it instead of the cluster silently scaling
        (or never scaling)."""
        if not infeasible:
            return  # last report ages out (status filters by timestamp)
        try:
            client.call(
                "kv_put", ns="autoscaler", key="infeasible",
                value=json.dumps(
                    {"shapes": infeasible, "node_type": tmpl,
                     "ts": time.time()}
                ).encode(),
            )
        except RpcError:
            pass

    def _step(self, client: RpcClient) -> None:
        try:
            nodes = client.call("get_nodes", alive_only=True, timeout_s=10.0)
        except RpcError:
            return
        n_alive = len(nodes)
        if hasattr(self.provider, "create_slice"):
            launched = len(self._launched)
            self._step_slices(client, nodes, n_alive)
            if len(self._launched) > launched:
                # the new slices registered after this step's view of the
                # nodes was read: judged against it, they would be dropped
                # from _launched below and never scaled down
                return
        demand = sum(int(n.get("pending_leases", 0)) for n in nodes)
        # Shape-aware demand (reference autoscaler/v2/scheduler.py
        # bin-packs pending shapes into node types): upscale only when a
        # pending shape would actually FIT the provider's node type —
        # "any pending lease → +1 node" scaled to max_nodes forever on a
        # task no node size could ever serve.
        shapes: List[Dict[str, float]] = []
        for n in nodes:
            shapes.extend(n.get("pending_shapes") or [])
        tmpl = self.provider.node_resources()
        if tmpl is None:  # provider with an undeclared node shape
            feasible, infeasible = list(shapes), []
        else:
            feasible = [
                s for s in shapes
                if all(tmpl.get(k, 0.0) >= v for k, v in s.items() if v > 0)
            ]
            infeasible = [
                s for s in shapes
                if not all(tmpl.get(k, 0.0) >= v for k, v in s.items() if v > 0)
            ]
        self._publish_infeasible(client, infeasible, tmpl)
        # demand without shape info (older agents / flickering counters)
        # counts as feasible — the pre-shape behavior
        has_feasible_demand = bool(feasible) or (demand > 0 and not shapes)
        now = time.monotonic()
        if (
            has_feasible_demand
            and n_alive < self.max_nodes
            and now - self._last_upscale >= self.upscale_cooldown_s
        ):
            self._last_upscale = now
            node_id = self.provider.create_node()
            self._launched.append(node_id)
            return
        demand = demand if has_feasible_demand else 0
        # scale down: only nodes WE launched, newest first, when the whole
        # cluster has no demand and the node itself is idle
        alive_ids = {n["node_id"] for n in nodes}
        busy_ids = {
            n["node_id"] for n in nodes
            if n.get("active_leases", 0) or n.get("pending_leases", 0)
        }
        for nid in list(self._launched):
            if nid not in alive_ids:
                self._launched.remove(nid)
                self._idle_since.pop(nid, None)
                continue
            if demand > 0 or nid in busy_ids or n_alive <= self.min_nodes:
                self._idle_since.pop(nid, None)
                continue
            if hasattr(self.provider, "slice_of"):
                # slice atoms: terminate_node tears down the WHOLE slice,
                # so an idle host whose slice SIBLING is busy must wait —
                # never destroy a running actor on host 0 because host 3
                # went quiet
                sid = self.provider.slice_of(nid)
                members = (
                    set(self.provider.slice_members(sid)) if sid else set()
                )
                if members & busy_ids:
                    self._idle_since.pop(nid, None)
                    continue
            first = self._idle_since.setdefault(nid, now)
            if now - first >= self.idle_timeout_s:
                # heartbeat lease counts can be up to a period stale: ask
                # the agent DIRECTLY before killing, so a just-granted
                # lease is never torn down (two-phase drain)
                addr = next(
                    (n["address"] for n in nodes if n["node_id"] == nid), None
                )
                if addr:
                    probe = RpcClient(addr, name="autoscaler-probe")
                    try:
                        st = probe.call("get_state", timeout_s=5.0)
                        # a placement group's bundles reserved there hold
                        # the node too: a gang between its reservation and
                        # its workers' leases is not idle
                        if st.get("leases") or st.get("bundles"):
                            self._idle_since[nid] = now  # busy after all
                            continue
                    except RpcError:
                        pass  # unreachable: fall through and reap it
                    finally:
                        probe.close()
                try:
                    client.call("drain_node", node_id=nid, timeout_s=10.0)
                except RpcError:
                    pass
                self.provider.terminate_node(nid)
                self._launched.remove(nid)
                self._idle_since.pop(nid, None)
                n_alive -= 1

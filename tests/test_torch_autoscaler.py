"""The port's autoscaler (``ray_tpu_torch/autoscaler.py``: a pinned copy of
the JAX package's, but for its NVLink-domain provider and the domain
demand, written for the port) on one port ``Cluster`` whose head node has
no card: the first three tests of ``tests/test_autoscaler.py``, and
``test_tpu_pod_provider_scales_slice_for_pg`` as a domain test
(``GpuDomainProvider`` over declared cards, a gang of two 2-card domains);
the provider's card sets; and the domain demand on hand-built groups, held
to the JAX package's ``pending_slice_demand`` where the two mean the same.

Each test stops its autoscaler and waits until the nodes it launched are
gone before the next one starts; at most two extra agents run at once."""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from chip_smoke import agent_environ
from ray_tpu_torch.accelerators.gpu import domain_head_resource, domain_type
from ray_tpu_torch.autoscaler import (
    Autoscaler,
    GpuDomainProvider,
    LocalNodeProvider,
    pending_domain_demand,
)
from ray_tpu_torch.core import cluster_utils
from ray_tpu_torch.core.cluster_utils import Cluster
from ray_tpu_torch.utils.rpc import RpcClient, RpcError

CARD = "NVIDIA H100 80GB HBM3"
DOMAIN = domain_type(CARD, 2)  # "H100-80GB-HBM3-2"
HEAD = domain_head_resource(DOMAIN)


@pytest.fixture(scope="module")
def cluster():
    cluster_utils.sweep_stale_runtime()
    c = Cluster()
    try:
        c.add_node(num_cpus=1)  # the head node: no card, no domain head
        ray_tpu_torch.init(address=c.address)
        yield c
    finally:
        try:
            ray_tpu_torch.shutdown()
        finally:
            c.shutdown()


def _alive():
    return [n for n in ray_tpu_torch.nodes() if n.get("alive", True)]


def _wait_alive(n: int, timeout_s: float = 60.0) -> list:
    deadline = time.monotonic() + timeout_s
    alive = _alive()
    while len(alive) != n and time.monotonic() < deadline:
        time.sleep(0.2)
        alive = _alive()
    return alive


def _wait_idle(node_ids, deadline: float) -> None:
    """Wait, until ``deadline`` (``time.monotonic()``), for the agents of
    ``node_ids`` to hold no lease and no bundle, asked as the autoscaler
    asks before it drains a node (``get_state``); an agent that no longer
    answers has been reaped, idle. This is the teardown of killed actors
    and of a removed group, which the autoscaler does not drive: a failure
    here, not in the drain after it, says that teardown ran out the time."""
    addrs = {n["node_id"]: n["address"] for n in _alive() if n["node_id"] in node_ids}
    busy = set(addrs)
    while busy and time.monotonic() < deadline:
        for nid in sorted(busy):
            probe = RpcClient(addrs[nid], name="test-idle-probe")
            try:
                st = probe.call("get_state", timeout_s=5.0)
            except RpcError:
                st = {}
            finally:
                probe.close()
            if not st.get("leases") and not st.get("bundles"):
                busy.discard(nid)
        if busy:
            time.sleep(0.2)
    assert not busy, f"the domains {sorted(busy)} still hold leases or bundles at the deadline"


def _stop(scaler) -> None:
    """Stop the autoscaler (its provider terminates what it launched) and
    wait until the cluster is back to its head node."""
    if scaler is not None:
        scaler.stop()
    assert len(_wait_alive(1)) == 1, "launched nodes outlived their autoscaler"


def test_scale_up_on_demand_then_down(cluster):
    provider = LocalNodeProvider(cluster.address, cluster.session_id, resources={"CPU": 1.0})
    scaler = Autoscaler(cluster.address, provider, min_nodes=1, max_nodes=3,
                        idle_timeout_s=4.0, poll_period_s=0.5, upscale_cooldown_s=1.0)
    scaler.start()
    try:
        @ray_tpu_torch.remote
        def work(i):
            import time

            time.sleep(4)
            return i

        # 3 concurrent 4 s tasks on a 1-CPU cluster: pending leases force
        # scale-up; with 3 nodes the batch finishes far faster than 12 s
        t0 = time.monotonic()
        out = ray_tpu_torch.get([work.remote(i) for i in range(3)], timeout=120)
        elapsed = time.monotonic() - t0
        assert sorted(out) == [0, 1, 2]
        assert len(_alive()) >= 2, "autoscaler never launched a node"
        assert elapsed < 11.0, f"no speedup from scale-up ({elapsed:.1f}s)"
        # idle: launched nodes are drained and terminated back to min
        assert len(_wait_alive(1)) == 1, "autoscaler did not scale back down"
    finally:
        _stop(scaler)


def test_feasible_shape_still_scales(cluster):
    provider = LocalNodeProvider(cluster.address, cluster.session_id, resources={"CPU": 1.0})
    scaler = Autoscaler(cluster.address, provider, min_nodes=1, max_nodes=2,
                        idle_timeout_s=60.0, poll_period_s=0.3, upscale_cooldown_s=0.5)
    scaler.start()
    try:
        @ray_tpu_torch.remote
        def work():
            import time

            time.sleep(3)
            return 1

        assert ray_tpu_torch.get([work.remote() for _ in range(2)], timeout=90) == [1, 1]
        assert len(_alive()) >= 2, "feasible demand did not scale up"
    finally:
        _stop(scaler)


def test_domain_provider_scales_domains_for_gang(cluster):
    """A pending gang of two 2-card domains (``slice_placement_group(...,
    num_slices=2)``, one STRICT_PACK group a domain) makes the provider
    spawn exactly two agents, one a domain; the gang is reserved on them
    and a worker pinned to each domain's bundle runs there on a card of
    its own; within 30 s of ``remove()`` the killed workers' leases and
    the removed gang's bundles are gone (``_wait_idle``) and both domains
    are drained and terminated."""
    from ray_tpu_torch.accelerators import slice_placement_group

    provider = GpuDomainProvider(cluster.address, cluster.session_id, domain=DOMAIN)
    assert provider.hosts_per_slice == 1
    assert provider.node_resources() == {"GPU": 2.0, "CPU": 3.0}
    assert HEAD not in ray_tpu_torch.cluster_resources()
    scaler = Autoscaler(cluster.address, provider, min_nodes=1, max_nodes=3,
                        idle_timeout_s=2.0, poll_period_s=0.3, upscale_cooldown_s=0.5)
    scaler.start()
    try:
        spg = slice_placement_group(DOMAIN, num_slices=2)
        assert spg.wait(120), "the domains' groups never became ready"
        assert len(provider._slices) == 2
        assert all(len(members) == 1 for members in provider._slices.values())
        domain_nodes = {n["node_id"] for n in _alive()
                        if n.get("labels", {}).get("gpu-domain-type") == DOMAIN}
        assert len(domain_nodes) == 2 and domain_nodes == set(provider.all_slice_members())
        hosts = [pg.table()["bundle_locations"] for pg in spg.placement_groups]
        assert [set(locs.values()) <= domain_nodes and len(set(locs.values())) == 1
                for locs in hosts] == [True, True]
        assert len({next(iter(locs.values())) for locs in hosts}) == 2

        @ray_tpu_torch.remote(num_cpus=0, num_gpus=1)
        class DomainWorker:
            def where(self):
                import os

                return (ray_tpu_torch.get_runtime_context().get_node_id(),
                        os.environ.get("CUDA_VISIBLE_DEVICES"))

        workers = [DomainWorker.options(scheduling_strategy=spg.worker_strategy(s, 0)).remote()
                   for s in range(2)]
        seen = ray_tpu_torch.get([w.where.remote() for w in workers], timeout=120)
        assert {node for node, _ in seen} == domain_nodes
        assert all(card in ("0", "1") for _, card in seen), seen
        for w in workers:
            ray_tpu_torch.kill(w)
        procs = [proc for members in provider._slices.values() for _, proc in members]
        spg.remove()
        deadline = time.monotonic() + 30.0
        _wait_idle(domain_nodes, deadline)
        while ((provider._slices or any(p.poll() is None for p in procs))
               and time.monotonic() < deadline):
            time.sleep(0.2)
        assert not provider._slices, "the idle domains were not terminated"
        assert all(p.poll() is not None for p in procs), "a domain's agent is left"
        assert len(_wait_alive(1)) == 1
        assert provider._next_slice == 2, "a domain was provisioned twice"
    finally:
        _stop(scaler)


def test_domain_provider_hands_out_card_sets(cluster):
    """With card sets, each domain's agent is spawned with its set as
    CUDA_VISIBLE_DEVICES in its own environment (this process's stays as
    it was); with no free set the provider provisions nothing and raises
    nothing; a terminated domain's agent has exited and its set is back in
    the pool."""
    with pytest.raises(ValueError, match="card_sets"):
        GpuDomainProvider(cluster.address, cluster.session_id, DOMAIN, card_sets=[["0"]])
    with pytest.raises(ValueError, match="card_sets"):
        GpuDomainProvider(cluster.address, cluster.session_id, DOMAIN,
                          card_sets=[["0", "1"], ["1", "2"]])
    before = os.environ.get("CUDA_VISIBLE_DEVICES")
    provider = GpuDomainProvider(cluster.address, cluster.session_id, DOMAIN,
                                 card_sets=[["0", "1"], [2, 3]])
    try:
        first, second = provider.create_slice(), provider.create_slice()
        assert len(first) == len(second) == 1
        assert provider.create_slice() == [] and provider.create_node() is None
        assert provider.free_card_sets == []
        procs = {sid: members[0][1] for sid, members in provider._slices.items()}
        seen = sorted(agent_environ(p.pid)["CUDA_VISIBLE_DEVICES"] for p in procs.values())
        assert seen == ["0,1", "2,3"]
        assert os.environ.get("CUDA_VISIBLE_DEVICES") == before
        labels = {n["node_id"]: n.get("labels", {}) for n in _alive()}
        assert {labels[first[0]]["gpu-domain"], labels[second[0]]["gpu-domain"]} == set(procs)
        assert labels[first[0]]["gpu-domain-type"] == DOMAIN
        provider.terminate_node(first[0])
        sid = labels[first[0]]["gpu-domain"]
        assert procs[sid].poll() is not None
        assert provider.free_card_sets == [["0", "1"]]
        assert provider.slice_of(first[0]) is None and provider.slice_members(sid) == []
    finally:
        provider.shutdown()
    assert sorted(provider.free_card_sets) == [["0", "1"], ["2", "3"]]
    assert all(p.poll() is not None for p in procs.values())
    assert len(_wait_alive(1)) == 1


def test_infeasible_demand_reported_not_scaled(cluster):
    """A 4-CPU task on a cluster whose node type has 2 CPUs must not scale
    up forever; it is reported as infeasible. (Last in the module: its
    task stays pending until the cluster ends.)"""
    provider = LocalNodeProvider(cluster.address, cluster.session_id, resources={"CPU": 2.0})
    scaler = Autoscaler(cluster.address, provider, min_nodes=1, max_nodes=3,
                        idle_timeout_s=60.0, poll_period_s=0.3, upscale_cooldown_s=0.5)
    scaler.start()
    try:
        @ray_tpu_torch.remote(num_cpus=4)
        def big():
            return 1

        ref = big.remote()  # can never fit a 2-CPU node
        time.sleep(6.0)  # several autoscaler periods
        assert len(_alive()) == 1, "autoscaler launched nodes for infeasible demand"
        from ray_tpu_torch import state

        inf = state.cluster_status(cluster.address).get("infeasible_demand")
        assert inf and inf["shapes"], inf
        assert any(s.get("CPU") == 4.0 for s in inf["shapes"]), inf
        del ref
    finally:
        _stop(scaler)


# -- the domain demand -------------------------------------------------------


def _group(state, *bundles):
    return {"state": state, "bundles": [dict(b) for b in bundles]}


SHAPE = {"GPU": 2.0, "CPU": 3.0}


@pytest.mark.parametrize("case", [
    ("a pending gang's group is one host", [_group("PENDING", {HEAD: 1, "GPU": 1}, {"GPU": 1})], 1),
    ("rescheduling counts too", [_group("RESCHEDULING", {HEAD: 1, "GPU": 2})], 1),
    ("one host a group", [_group("PENDING", {HEAD: 1, "GPU": 1}, {"GPU": 1})] * 3, 3),
    ("a created group is no demand", [_group("CREATED", {HEAD: 1, "GPU": 2})], 0),
    ("a removed group is no demand", [_group("REMOVED", {HEAD: 1, "GPU": 2})], 0),
    ("another domain's head", [_group("PENDING", {domain_head_resource(domain_type(CARD, 4)): 1,
                                                  "GPU": 1})], 0),
    ("another domain's head in a later bundle",
     [_group("PENDING", {HEAD: 1, "GPU": 1}, {"GPU-A100-2-head": 1, "GPU": 1})], 0),
    ("more cards than the host has", [_group("PENDING", {HEAD: 1, "GPU": 2}, {"GPU": 1})], 0),
    ("the head twice", [_group("PENDING", {HEAD: 1, "GPU": 1}, {HEAD: 1, "GPU": 1})], 0),
    ("no head: not a domain's gang", [_group("PENDING", {"GPU": 1})], 0),
    ("the head not in bundle 0", [_group("PENDING", {"GPU": 1}, {HEAD: 1, "GPU": 1})], 0),
    ("CPU within the host", [_group("PENDING", {HEAD: 1, "GPU": 2, "CPU": 3})], 1),
    ("CPU beyond the host", [_group("PENDING", {HEAD: 1, "GPU": 2, "CPU": 4})], 0),
    ("a resource the host lacks", [_group("PENDING", {HEAD: 1, "GPU": 1, "TPU": 1})], 0),
    ("no groups", [], 0),
], ids=lambda c: c[0])
def test_domain_demand(case):
    _, pgs, hosts = case
    assert pending_domain_demand(pgs, SHAPE, HEAD) == hosts


def _to_jax(bundle: dict) -> dict:
    """A bundle's names mapped onto the JAX package's: GPU -> TPU, a
    domain's head GPU-<domain>-head -> TPU-<domain>-head."""
    return {("TPU" + k[3:] if k.startswith("GPU") else k): v for k, v in bundle.items()}


@pytest.mark.parametrize("seed", range(4))
def test_one_bundle_demand_agrees_with_the_jax_package(seed):
    """On one-bundle groups whose bundle names a domain head, the port's
    demand is the JAX package's ``pending_slice_demand`` on the same groups
    with the names mapped (a TPU slice group asks one host a bundle; a
    domain group, one host a group). A group with no head is left out: the
    JAX provider counts a bare TPU bundle as a host of its slice, and the
    port counts only a domain's gang."""
    from ray_tpu.autoscaler import pending_slice_demand

    rng = np.random.default_rng(seed)
    heads = [HEAD, domain_head_resource(domain_type(CARD, 4)), "GPU-A100-SXM4-40GB-2-head"]
    pgs = []
    for _ in range(40):
        bundle = {heads[rng.integers(len(heads))]: 1.0, "GPU": float(rng.integers(1, 4))}
        if rng.random() < 0.4:
            bundle["CPU"] = float(rng.integers(1, 5))
        pgs.append(_group(["PENDING", "RESCHEDULING", "CREATED", "REMOVED"][rng.integers(4)],
                          bundle))
    jax_shape, jax_head = _to_jax(SHAPE), "TPU" + HEAD[3:]
    each = [(pending_domain_demand([g], SHAPE, HEAD),
             pending_slice_demand([{**g, "bundles": [_to_jax(b) for b in g["bundles"]]}],
                                  jax_shape, head_resource=jax_head)) for g in pgs]
    assert [p for p, _ in each] == [j for _, j in each]
    assert 0 < sum(p for p, _ in each) < len(pgs)  # both outcomes occur

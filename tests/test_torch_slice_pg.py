"""The NVLink gang group (``ray_tpu_torch/accelerators/slice_pg.py``) on
the port's ``Cluster``, on the CPU: the twins of ``tests/test_slice_pg.py``.
A TPU slice spans hosts; an NVLink domain is one host's cards, so the
cluster here is two hosts of four declared cards, only the first carrying
its domain's head resource (as the first host of a slice does); and, for
several slices (``num_slices=2``), two hosts of two cards, each carrying
its own domain's head."""

import pytest

import ray_tpu_torch
from ray_tpu_torch.accelerators.gpu import domain_head_resource, domain_type
from ray_tpu_torch.core import cluster_utils
from ray_tpu_torch.core.cluster_utils import Cluster

DOMAIN = domain_type("NVIDIA H100 80GB HBM3", 4)


@pytest.fixture
def gpu_cluster():
    """Two hosts of 4 cards; the first carries the domain head."""
    cluster_utils.sweep_stale_runtime()
    c = Cluster()
    try:
        c.add_node(num_cpus=1, num_gpus=4, resources={domain_head_resource(DOMAIN): 1})
        c.add_node(num_cpus=1, num_gpus=4)
        ray_tpu_torch.init(address=c.address)
        yield c
    finally:
        try:
            ray_tpu_torch.shutdown()
        finally:
            c.shutdown()


def test_slice_reserved_as_gang(gpu_cluster):
    from ray_tpu_torch.accelerators import slice_placement_group

    assert DOMAIN == "H100-80GB-HBM3-4"
    spg = slice_placement_group(DOMAIN, cards_per_worker=1)
    assert spg.num_workers_per_slice == spg.num_workers == 4
    assert spg.wait(60), "domain not schedulable"
    locs = spg.placement_group.table()["bundle_locations"]
    # one bundle per card, all four on the head host
    head = gpu_cluster.nodes[0].node_id
    assert {locs[i] for i in range(4)} == {head}

    # a worker actor pinned to each bundle: one card each, all distinct
    @ray_tpu_torch.remote(num_cpus=0, num_gpus=1)
    class DomainWorker:
        def where(self):
            import os

            return (ray_tpu_torch.get_runtime_context().get_node_id(),
                    os.environ.get("CUDA_VISIBLE_DEVICES"))

    workers = [DomainWorker.options(scheduling_strategy=spg.worker_strategy(0, i)).remote()
               for i in range(4)]
    seen = ray_tpu_torch.get([w.where.remote() for w in workers], timeout=120)
    assert {node for node, _ in seen} == {head}
    assert sorted(card for _, card in seen) == ["0", "1", "2", "3"]
    env = spg.coordinator_env("domain_group", rank=0)
    assert env["WORLD_SIZE"] == "4" and env["RANK"] == "0" and int(env["MASTER_PORT"]) > 0
    assert "RT_SLICE_ID" not in env
    spg.remove()
    # two domains need two hosts carrying the head: with one, the second
    # slice's group stays pending
    two = slice_placement_group(DOMAIN, num_slices=2)
    assert two.num_workers == 8 and len(two.placement_groups) == 2
    with pytest.raises(ValueError, match="placement_groups"):
        two.placement_group
    assert not two.wait(1.5)
    two.remove()


def test_slice_infeasible_without_head(gpu_cluster):
    from ray_tpu_torch.accelerators import slice_placement_group

    # no host advertises an 8-card domain's head -> stays pending
    spg = slice_placement_group(domain_type("NVIDIA H100 80GB HBM3", 8), cards_per_worker=1)
    assert not spg.wait(1.5)
    spg.remove()


DOMAIN2 = domain_type("NVIDIA H100 80GB HBM3", 2)


@pytest.fixture
def two_domains():
    """Two hosts of 2 cards, each carrying its domain's head."""
    cluster_utils.sweep_stale_runtime()
    c = Cluster()
    try:
        for _ in range(2):
            c.add_node(num_cpus=1, num_gpus=2, resources={domain_head_resource(DOMAIN2): 1})
        ray_tpu_torch.init(address=c.address)
        yield c
    finally:
        try:
            ray_tpu_torch.shutdown()
        finally:
            c.shutdown()


def test_two_slices_a_domain_each(two_domains):
    """num_slices=2: each slice's bundles all on one host, the two slices on
    the two hosts (which host takes slice 0 is the scheduler's choice: both
    groups try the first host, the loser of its 2PC retries on the other),
    each pinned worker on its slice's host seeing one card of it; one
    coordinator, ranks domain-major."""
    from ray_tpu_torch.accelerators import slice_placement_group

    spg = slice_placement_group(DOMAIN2, cards_per_worker=1, num_slices=2)
    assert (spg.num_workers_per_slice, spg.num_workers) == (2, 4)
    assert spg.wait(60), "two domains not schedulable"
    hosts = []
    for pg in spg.placement_groups:
        locs = pg.table()["bundle_locations"]
        [host] = {locs[i] for i in range(2)}
        hosts.append(host)
    assert sorted(hosts) == sorted(n.node_id for n in two_domains.nodes)

    @ray_tpu_torch.remote(num_cpus=0, num_gpus=1)
    class DomainWorker:
        def where(self):
            import os

            return (ray_tpu_torch.get_runtime_context().get_node_id(),
                    os.environ.get("CUDA_VISIBLE_DEVICES"))

    workers = [[DomainWorker.options(scheduling_strategy=spg.worker_strategy(s, w)).remote()
                for w in range(2)] for s in range(2)]
    for s in range(2):
        seen = ray_tpu_torch.get([w.where.remote() for w in workers[s]], timeout=120)
        assert {node for node, _ in seen} == {hosts[s]}
        assert sorted(card for _, card in seen) == ["0", "1"]  # the host's two cards, one each
    envs = [spg.coordinator_env("two_domains", rank=r) for r in range(4)]
    assert len({(e["MASTER_ADDR"], e["MASTER_PORT"]) for e in envs}) == 1
    assert [(e["RANK"], e["WORLD_SIZE"], e["RT_NUM_SLICES"], e["RT_SLICE_ID"]) for e in envs] == [
        ("0", "4", "2", "0"), ("1", "4", "2", "0"), ("2", "4", "2", "1"), ("3", "4", "2", "1")]
    with pytest.raises(ValueError, match="worker 2 of a slice of 2"):
        spg.worker_strategy(0, 2)
    spg.remove()

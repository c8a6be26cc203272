"""Whole-domain gang scheduling: the NVLink domains of hosts' cards
reserved as one gang.

Counterpart of ``ray_tpu/accelerators/slice_pg.py:29-102``, where a TPU
slice (hosts joined by ICI) is reserved as one atom and ``num_slices``
slices are joined over the data-center network. On NVIDIA cards a domain
is one host's NVLink-connected cards: the host advertises its domain's
head resource once (``GPU-<domain>-head``, ``accelerators/__init__.py``).

A slice here is one domain: a placement group of one bundle per worker,
bundle 0 claiming the domain head beside its cards and every other bundle
claiming cards, under ``STRICT_PACK``, so all of a slice's bundles sit on
the host whose head bundle 0 took. ``num_slices`` domains are
``num_slices`` such groups behind the one ``SlicePlacementGroup`` (the JAX
package spreads one bundle a host with ``STRICT_SPREAD``; a domain packs
its workers onto one host and the domains onto different ones, which one
strategy cannot say). Each group claims one head resource, and a host has
one, so the slices land on different hosts. For the gang:

  - ``placement_groups``: the groups, slice s's at index s;
    ``placement_group`` is the one group of a single slice (it raises for
    several);
  - ``wait(timeout)``: True once every slice's group is created, within one
    deadline for all of them;
  - ``ready()``: an ObjectRef that resolves to the group once it is
    created; with several slices, one such ref a slice, in a list;
  - ``remove()``: removes every slice's group;
  - ``worker_strategy(s, w)`` pins slice s's worker w to bundle w of slice
    s's group; the worker's lease then takes its own cards from its node
    (``core/node_agent.py``) and the worker sees only them;
  - ``coordinator_env(group, rank)``: the ``torch.distributed`` env of
    worker ``rank`` of ``num_workers`` (``process_group.coordinator_env``),
    ranks domain-major (slice s's workers are ranks s W .. (s+1) W - 1), so
    a mesh's outermost axis, ``dcn``, falls on the domain boundary.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch.accelerators.gpu import domain_head_resource
from ray_tpu_torch.core.placement import (
    PlacementGroup,
    PlacementGroupSchedulingStrategy,
    placement_group,
)


class SlicePlacementGroup:
    """``num_slices`` reserved NVLink domains: per domain one placement
    group of one bundle per worker, ``cards_per_worker`` cards each, all on
    the domain's host.

    ``domain`` is the hosts' domain type (``gpu.domain_type``: the card
    type and the count, e.g. "H100-80GB-HBM3-4")."""

    def __init__(
        self,
        domain: str,
        cards_per_worker: int = 1,
        num_slices: int = 1,
        name: Optional[str] = None,
    ):
        if num_slices < 1:
            raise ValueError(f"num_slices must be at least 1, got {num_slices}")
        self.domain = domain
        self.cards_per_worker = cards_per_worker
        self.num_slices = num_slices
        cards = int(domain.rsplit("-", 1)[1])
        self.num_workers_per_slice = max(1, cards // cards_per_worker)
        bundles: List[Dict[str, float]] = [
            {domain_head_resource(domain): 1.0, "GPU": float(cards_per_worker)}
        ]
        bundles.extend(
            {"GPU": float(cards_per_worker)}
            for _ in range(self.num_workers_per_slice - 1)
        )
        self.placement_groups: List[PlacementGroup] = [
            placement_group(bundles, strategy="STRICT_PACK",
                            name=name if name is None or num_slices == 1 else f"{name}-{s}")
            for s in range(num_slices)
        ]

    @property
    def placement_group(self) -> PlacementGroup:
        if self.num_slices != 1:
            raise ValueError(f"{self.num_slices} slices have a group each: use "
                             "placement_groups[slice_id]")
        return self.placement_groups[0]

    @property
    def num_workers(self) -> int:
        return self.num_slices * self.num_workers_per_slice

    def wait(self, timeout_seconds: float = 120.0) -> bool:
        deadline = time.monotonic() + timeout_seconds
        return all(pg.wait(max(0.0, deadline - time.monotonic()))
                   for pg in self.placement_groups)

    def ready(self):
        refs = [pg.ready() for pg in self.placement_groups]
        return refs[0] if self.num_slices == 1 else refs

    def worker_strategy(
        self, slice_id: int, worker_id: int
    ) -> PlacementGroupSchedulingStrategy:
        """Scheduling strategy pinning worker ``worker_id`` of slice
        ``slice_id`` to its bundle (bundle 0 of each slice holds its domain
        head)."""
        if not 0 <= worker_id < self.num_workers_per_slice:
            raise ValueError(f"worker {worker_id} of a slice of {self.num_workers_per_slice}")
        return PlacementGroupSchedulingStrategy(
            placement_group=self.placement_groups[slice_id],
            placement_group_bundle_index=worker_id,
        )

    def coordinator_env(self, group_name: str, rank: int) -> Dict[str, str]:
        """The ``torch.distributed`` env of worker ``rank`` (domain-major)
        joining the gang's one process group, with the slice count and its
        slice id (``process_group.coordinator_env``)."""
        from ray_tpu_torch.collective.process_group import coordinator_env

        return coordinator_env(group_name, rank, self.num_workers, self.num_slices,
                               rank // self.num_workers_per_slice)

    def remove(self) -> None:
        from ray_tpu_torch.core.placement import remove_placement_group

        for pg in self.placement_groups:
            remove_placement_group(pg)


def slice_placement_group(
    domain: str,
    cards_per_worker: int = 1,
    num_slices: int = 1,
    name: Optional[str] = None,
) -> SlicePlacementGroup:
    """Reserve ``num_slices`` whole NVLink domains of type ``domain``,
    ``cards_per_worker`` cards a worker (parity:
    ray.util.tpu.slice_placement_group)."""
    return SlicePlacementGroup(domain, cards_per_worker, num_slices, name)

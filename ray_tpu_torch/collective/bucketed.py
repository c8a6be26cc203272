"""Overlapped bucketed gradient allreduce + hierarchical two-level
collectives (the DP training loop's ``grad_sync``).

The per-leaf DP pattern — full backward, then one blocking allreduce per
pytree leaf — serializes compute and comm and pays per-op bookkeeping
for every tiny bias vector (the MLPerf TPU-pod study, arxiv 1909.09756,
is the scale argument). This module replaces it with:

- **Bucketing**: the gradient pytree is flattened and packed into
  per-dtype byte buckets of ``RT_COLLECTIVE_BUCKET_BYTES`` (4 MiB
  default) in REVERSE leaf order (backward produces output-side grads
  first, so with incremental ``push()`` the last layers ship earliest).
  Tiny leaves (< collective_p2p_min_bytes) coalesce into shared buckets
  instead of each paying its own KV round trip; a bucket that still
  lands under the p2p floor rides the KV fallback as ONE exchange.

- **Overlap**: each closed bucket is submitted to a background comm
  lane (one daemon thread per group, FIFO — every rank processes
  buckets in the same order) whose ring allreduce rides the existing
  p2p.send_async/reap machinery. The caller keeps producing bucket i+1
  (next microbatch, next pipeline stage) while bucket i is on the wire,
  and only blocks in ``join()`` at optimizer apply. The comm-hidden
  fraction — bucket comm spans joined against the window before join()
  — lands in rt_collective_overlap_hidden_frac.

- **Hierarchical two-level mode** (EQuARX-style topology, arxiv
  2506.17615): when the group spans >1 host, each bucket reduces
  intra-host to a designated leader, the ring runs over leaders ONLY,
  and leaders broadcast back — bytes crossing hosts drop from
  O(ranks·bucket) to O(hosts·bucket). Host identity comes from the p2p
  rendezvous record (RT_COLLECTIVE_HOST_ID models multi-host placement
  on one box for tests/bench).

- **Per-bucket quant="int8"**: float buckets reuse the blockwise codec
  (p2p._quant_int8) on their ring phase; non-float buckets and the KV
  fallback stay exact. The PR 7 contract holds per bucket: every rank
  adopts the identical reduced tensor.

Failure semantics are unchanged: a dead rank poisons the ring, every
in-flight and queued bucket errors, and ``join()`` raises ONE
CollectiveError — never a hang. ``RT_COLLECTIVE_BUCKETED=0`` restores
the per-leaf blocking path behind the same ``grad_sync`` API.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.collective import collective as coll_mod
from ray_tpu_torch.collective import p2p
from ray_tpu_torch.core.exceptions import CollectiveError
from ray_tpu_torch.observability import core_metrics, tracing
from ray_tpu_torch.utils import serialization
from ray_tpu_torch.utils.config import config

_LEAF = "leaf"


def bucket_bytes() -> int:
    return int(config.collective_bucket_bytes)


def enabled() -> bool:
    return bool(config.collective_bucketed)


# ---------------------------------------------------------------------------
# pytree flatten/unflatten (dict / list / tuple containers)
# ---------------------------------------------------------------------------


def _flatten(tree) -> Tuple[List[Any], Any]:
    """Deterministic flatten over dict (sorted keys) / list / tuple
    nesting — the same traversal on every rank yields the same leaf
    order, which the bucket schedule depends on."""
    leaves: List[Any] = []

    def rec(node):
        if isinstance(node, dict):
            return ("dict", [(k, rec(node[k])) for k in sorted(node)])
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return (kind, [rec(v) for v in node])
        leaves.append(node)
        return (_LEAF, len(leaves) - 1)

    spec = rec(tree)
    return leaves, spec


def _unflatten(spec, leaves: List[Any]):
    kind, payload = spec
    if kind == _LEAF:
        return leaves[payload]
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in payload}
    vals = [_unflatten(s, leaves) for s in payload]
    return vals if kind == "list" else tuple(vals)


# ---------------------------------------------------------------------------
# bucket scheduler
# ---------------------------------------------------------------------------


class _Bucket:
    """One wire unit: same-dtype leaf segments, concatenated 1-D."""

    __slots__ = ("dtype", "parts", "nbytes")

    def __init__(self, dtype: np.dtype):
        self.dtype = dtype
        self.parts: List[Tuple[int, np.ndarray]] = []  # (slot id, flat leaf)
        self.nbytes = 0

    def concat(self) -> np.ndarray:
        if len(self.parts) == 1:
            return self.parts[0][1]
        return np.concatenate([flat for _, flat in self.parts])


class _Packer:
    """Greedy reverse-order packer: leaves register slots in original
    order (for unflatten) but fill buckets back-to-front, one open
    bucket per dtype; a bucket closes the moment it reaches the byte
    limit. A leaf never splits across buckets, so an oversize leaf gets
    a bucket to itself."""

    def __init__(self, limit: int):
        self.limit = max(1, int(limit))
        self.slots: List[Tuple[tuple, np.dtype]] = []  # (shape, dtype)
        self._open: Dict[str, _Bucket] = {}

    def add_leaves(self, arrs: List[np.ndarray]) -> List[_Bucket]:
        base = len(self.slots)
        flats = []
        for a in arrs:
            self.slots.append((a.shape, a.dtype))
            flats.append(np.ascontiguousarray(a).reshape(-1))
        closed: List[_Bucket] = []
        for i in range(len(flats) - 1, -1, -1):
            flat = flats[i]
            key = flat.dtype.str
            b = self._open.get(key)
            if b is None:
                b = self._open[key] = _Bucket(flat.dtype)
            b.parts.append((base + i, flat))
            b.nbytes += flat.nbytes
            if b.nbytes >= self.limit:
                closed.append(b)
                del self._open[key]
        return closed

    def flush(self) -> List[_Bucket]:
        out = [b for b in self._open.values() if b.parts]
        self._open.clear()
        return out


def pack_buckets(leaves, limit: Optional[int] = None):
    """Pack a flat leaf list into buckets (tests use this directly for
    the boundary property: every leaf in exactly one bucket, bit-exact
    round trip). Returns (buckets, slots)."""
    packer = _Packer(limit or bucket_bytes())
    closed = packer.add_leaves([coll_mod._host_array(x) for x in leaves])
    return closed + packer.flush(), packer.slots


# ---------------------------------------------------------------------------
# hierarchical two-level topology
# ---------------------------------------------------------------------------


def _resolve_two_level(pg, hierarchy: Optional[str]):
    """(my leader, my host's ranks, all leaders) when the two-level path
    applies, else None (flat ring). Peers are rank-ordered identically
    on every member, so the derived topology is group-consistent."""
    if hierarchy == "flat":
        return None
    if hierarchy is None and not config.collective_hierarchical:
        return None
    hosts: Dict[str, List[int]] = {}
    for r, peer in enumerate(pg.peers):
        hosts.setdefault(peer[2], []).append(r)
    if len(hosts) < 2 or len(hosts) >= pg.world_size:
        return None  # one host, or one rank per host: two-level = flat
    members = hosts[pg.peers[pg.rank][2]]
    leaders = sorted(ranks[0] for ranks in hosts.values())
    return members[0], members, leaders


def hier_allreduce(pg, arr: np.ndarray, op: str, tag: str, topo,
                   quant: Optional[str] = None,
                   timeout_s: Optional[float] = None) -> np.ndarray:
    """Two-level allreduce: intra-host reduce to the leader (loopback,
    never counted as inter-host bytes), ring allreduce over leaders
    only (the ONLY phase that crosses hosts — quant applies here), then
    intra-host broadcast back. All ranks return the identical tensor."""
    leader, members, leaders = topo
    deadline = p2p._deadline(timeout_s)
    shape, dtype = arr.shape, arr.dtype
    flat = np.ascontiguousarray(arr).reshape(-1)
    if pg.rank != leader:
        p2p.send_now(pg, leader, f"{tag}/up/{pg.rank}", flat, deadline,
                     op="allreduce")
        out = np.asarray(p2p.recv(pg, f"{tag}/dn/{pg.rank}", deadline))
        return out.astype(dtype, copy=False).reshape(shape)
    acc = flat.copy()
    red = p2p._INPLACE_REDUCERS[op]
    for r in members:
        if r == leader:
            continue
        red(acc, np.asarray(p2p.recv(pg, f"{tag}/up/{r}", deadline)))
    if len(leaders) > 1:
        acc = p2p.ring_allreduce(pg, acc, op, f"{tag}/x", quant=quant,
                                 timeout_s=timeout_s, ring=leaders)
    handles = [
        p2p.send_async(pg, r, f"{tag}/dn/{r}", acc, op="allreduce")
        for r in members if r != leader
    ]
    if handles:
        p2p.reap(pg, handles, deadline)
    return acc.astype(dtype, copy=False).reshape(shape)


# ---------------------------------------------------------------------------
# comm lane (one background thread per group, FIFO bucket order)
# ---------------------------------------------------------------------------


class _Lane:
    def __init__(self, group_name: str):
        self.group_name = group_name
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._stop = False
        self.thread = threading.Thread(
            target=self._run, name=f"rt-coll-lane-{group_name}", daemon=True
        )
        self.thread.start()

    def submit(self, handle: "_BucketHandle", fn) -> None:
        with self._cv:
            if self._stop:
                handle.error = CollectiveError(
                    f"collective group {self.group_name!r} destroyed"
                )
                handle.event.set()
                return
            self._q.append((handle, fn))
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait(0.5)
                if not self._q:
                    return  # stopped and drained
                _, fn = self._q.popleft()
            fn()

    def shutdown(self, join_timeout_s: float = 5.0) -> None:
        with self._cv:
            self._stop = True
            drained = list(self._q)
            self._q.clear()
            self._cv.notify_all()
        for handle, _ in drained:
            handle.error = CollectiveError(
                f"collective group {self.group_name!r} destroyed with "
                f"bucket {handle.tag} still queued"
            )
            handle.event.set()
        self.thread.join(join_timeout_s)


_lanes: Dict[str, _Lane] = {}
_lanes_lock = threading.Lock()


def _lane_for(group_name: str) -> _Lane:
    with _lanes_lock:
        lane = _lanes.get(group_name)
        if lane is None or not lane.thread.is_alive():
            lane = _lanes[group_name] = _Lane(group_name)
        return lane


def shutdown_lane(group_name: str) -> None:
    """Stop and drain the group's comm lane (destroy_collective_group
    calls this — queued buckets error, the thread exits; nothing
    leaks)."""
    with _lanes_lock:
        lane = _lanes.pop(group_name, None)
    if lane is not None:
        lane.shutdown()


def live_lane_threads() -> int:
    """Alive comm-lane threads in this process (leak tests)."""
    return sum(
        1 for t in threading.enumerate()
        if t.name.startswith("rt-coll-lane-") and t.is_alive()
    )


# ---------------------------------------------------------------------------
# grad_sync
# ---------------------------------------------------------------------------


class _BucketHandle:
    __slots__ = ("arr", "tag", "parts", "nbytes", "event", "result",
                 "error", "t_start", "t_end", "transport")

    def __init__(self, arr: np.ndarray, tag: str, parts):
        self.arr = arr
        self.tag = tag
        self.parts = parts
        self.nbytes = arr.nbytes
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t_start: Optional[float] = None
        self.t_end: Optional[float] = None
        self.transport = ""


class GradSync:
    """Handle for one overlapped gradient sync.

    ``push(grads)`` packs a pytree's leaves into buckets and launches
    every bucket that closed; call it once per microbatch/stage (or let
    ``grad_sync(grads)`` do a single push). ``join()`` — at optimizer
    apply — flushes the last partial buckets, blocks until every bucket
    reduced, and returns the reduced pytree (a list of pytrees after
    multiple pushes). ``stats`` afterwards holds buckets/bytes/comm_s/
    hidden_frac for the sync."""

    def __init__(self, group_name: Optional[str] = "default", *,
                 op: str = "sum", average: bool = True,
                 quant: Optional[str] = None,
                 bucket_bytes: Optional[int] = None,
                 hierarchy: Optional[str] = None,
                 timeout_s: Optional[float] = None):
        if hierarchy not in (None, "flat", "two_level"):
            raise ValueError(f"unknown hierarchy mode {hierarchy!r}")
        self._group = (
            coll_mod._groups[group_name] if group_name is not None else None
        )
        self._world = self._group.world_size if self._group else 1
        self._op = op
        self._average = average
        self._quant = quant
        self._hierarchy = hierarchy
        self._timeout_s = timeout_s
        self._use_buckets = (
            self._group is not None and self._world > 1 and enabled()
        )
        self._packer = _Packer(
            bucket_bytes if bucket_bytes is not None
            else int(config.collective_bucket_bytes)
        )
        self._legacy: List[np.ndarray] = []  # kill-switch / local path
        self._pushes: List[Tuple[Any, int, int]] = []  # (spec, base, count)
        self._nleaves = 0
        self._handles: List[_BucketHandle] = []
        self._t0 = time.monotonic()
        self._closed = False
        self._joined = False
        self.stats: Dict[str, Any] = {}

    # -- producing side --

    def push(self, grads) -> "GradSync":
        if self._closed:
            raise RuntimeError("grad_sync handle already closed")
        leaves, spec = _flatten(grads)
        arrs = [coll_mod._host_array(x) for x in leaves]
        self._pushes.append((spec, self._nleaves, len(arrs)))
        self._nleaves += len(arrs)
        if not self._use_buckets:
            self._legacy.extend(arrs)
            return self
        for bucket in self._packer.add_leaves(arrs):
            self._submit(bucket)
        return self

    def close(self) -> "GradSync":
        if self._closed:
            return self
        self._closed = True
        if self._use_buckets:
            for bucket in self._packer.flush():
                self._submit(bucket)
        return self

    def _submit(self, bucket: _Bucket) -> None:
        arr = bucket.concat()
        tag = coll_mod._next_tag(self._group, "grad_bucket")
        h = _BucketHandle(arr, tag, bucket.parts)
        self._handles.append(h)
        if arr.size == 0:
            h.result = arr
            h.t_start = h.t_end = time.monotonic()
            h.event.set()
            return
        _lane_for(self._group.name).submit(h, lambda: self._run_bucket(h))

    # -- comm lane side --

    def _run_bucket(self, h: _BucketHandle) -> None:
        g = self._group
        h.t_start = time.monotonic()
        transport = "kv"
        try:
            pg = coll_mod._active_p2p(g)
            quant = (
                self._quant
                if self._quant and h.arr.dtype.kind == "f" else None
            )
            if pg is not None and h.arr.nbytes >= p2p.min_bytes():
                topo = _resolve_two_level(pg, self._hierarchy)
                if topo is not None:
                    transport = "p2p_2l"
                    out = hier_allreduce(pg, h.arr, self._op, h.tag, topo,
                                         quant=quant,
                                         timeout_s=self._timeout_s)
                else:
                    transport = "p2p"
                    out = p2p.ring_allreduce(pg, h.arr, self._op, h.tag,
                                             quant=quant,
                                             timeout_s=self._timeout_s)
            else:
                # coalesced KV fallback: ONE head exchange for the whole
                # bucket, not one per tiny leaf
                payload = serialization.pack(h.arr)
                parts = coll_mod._exchange(
                    g, payload, h.tag, timeout_s=self._timeout_s or 120.0
                )
                arrays = [serialization.unpack(parts[r])
                          for r in sorted(parts)]
                out = coll_mod._REDUCERS[self._op](arrays)
            h.result = out
        except BaseException as e:  # noqa: BLE001 — surfaced at join()
            h.error = e
        finally:
            h.t_end = time.monotonic()
            h.transport = transport
            if core_metrics.ENABLED:
                core_metrics.collective_bucket_bytes.inc(
                    h.nbytes, tags={"transport": transport}
                )
            if tracing.ENABLED:
                ts = tracing.mono_us(h.t_start)
                tracing.emit(tracing.collective_span(
                    "grad_bucket", ts,
                    int((h.t_end - h.t_start) * 1e6),
                    nbytes=h.nbytes, transport=transport, tag=h.tag,
                ))
            h.event.set()

    # -- joining side --

    def wait(self):
        return self.join()

    def join(self):
        """Block until every bucket reduced; return the synced pytree
        (list of pytrees if push() ran more than once). Raises ONE
        CollectiveError if any bucket failed (dead rank, destroyed
        group, deadline)."""
        if self._joined:
            raise RuntimeError("grad_sync handle already joined")
        self.close()
        self._joined = True
        join_start = time.monotonic()
        if not self._use_buckets:
            results = self._join_legacy()
        else:
            results = self._join_buckets(join_start)
        if self._average and self._world > 1:
            results = [r / self._world for r in results]
        trees = [
            _unflatten(spec, results[base:base + count])
            for spec, base, count in self._pushes
        ]
        if not trees:
            return None
        return trees[0] if len(trees) == 1 else trees

    def _join_legacy(self) -> List[np.ndarray]:
        if self._group is None or self._world < 2:
            return list(self._legacy)
        out = []
        for arr in self._legacy:
            quant = (
                self._quant
                if self._quant and arr.dtype.kind == "f" else None
            )
            out.append(coll_mod.allreduce(
                arr, op=self._op, group_name=self._group.name,
                quant=quant, timeout_s=self._timeout_s,
            ))
        return out

    def _join_buckets(self, join_start: float) -> List[np.ndarray]:
        budget = (
            self._timeout_s if self._timeout_s is not None
            else float(config.collective_op_timeout_s)
        )
        failure: Optional[BaseException] = None
        nfailed = 0
        for h in self._handles:
            # lane runs buckets FIFO, so waits complete in order; each
            # bucket's op is internally bounded by the same deadline
            if not h.event.wait(budget + 30.0):
                failure = failure or CollectiveError(
                    f"bucket {h.tag} never completed within {budget}s"
                )
                nfailed += 1
                break
            if h.error is not None:
                failure = failure or h.error
                nfailed += 1
        if failure is not None:
            name = self._group.name if self._group else None
            raise CollectiveError(
                f"grad_sync on group {name!r}: {nfailed} bucket(s) "
                f"failed: {failure}"
            ) from failure
        results: List[Optional[np.ndarray]] = [None] * self._nleaves
        comm = 0.0
        hidden = 0.0
        total_bytes = 0
        for h in self._handles:
            self._unpack(h, results)
            if h.t_start is None or h.t_end is None:
                continue
            comm += max(0.0, h.t_end - h.t_start)
            hidden += max(
                0.0, min(h.t_end, join_start) - min(h.t_start, join_start)
            )
            total_bytes += h.nbytes
        frac = min(1.0, hidden / comm) if comm > 0 else 0.0
        self.stats = {
            "buckets": len(self._handles), "bytes": total_bytes,
            "comm_s": comm, "hidden_frac": frac,
            "join_wait_s": time.monotonic() - join_start,
        }
        if comm > 0:
            if core_metrics.ENABLED:
                core_metrics.collective_overlap_hidden_frac.observe(frac)
            if tracing.ENABLED:
                ts = tracing.mono_us(self._t0)
                tracing.emit(tracing.collective_span(
                    "grad_sync", ts, tracing.now_us() - ts,
                    nbytes=total_bytes, buckets=len(self._handles),
                    hidden_frac=round(frac, 4),
                ))
        return results  # type: ignore[return-value]

    def _unpack(self, h: _BucketHandle, results: List) -> None:
        flat = np.ascontiguousarray(np.asarray(h.result)).reshape(-1)
        off = 0
        for slot_id, part in h.parts:
            n = part.size
            shape, _ = self._packer.slots[slot_id]
            results[slot_id] = flat[off:off + n].reshape(shape)
            off += n


def grad_sync(grads=None, *, group_name: Optional[str] = "default",
              op: str = "sum", average: bool = True,
              quant: Optional[str] = None,
              bucket_bytes: Optional[int] = None,
              hierarchy: Optional[str] = None,
              timeout_s: Optional[float] = None) -> GradSync:
    """Start an overlapped bucketed gradient allreduce. With ``grads``
    it is a one-shot sync (push + close); call ``.join()`` at optimizer
    apply. Without ``grads`` it returns an open handle for incremental
    per-microbatch/per-stage ``push()`` — the overlap driver."""
    h = GradSync(group_name, op=op, average=average, quant=quant,
                 bucket_bytes=bucket_bytes, hierarchy=hierarchy,
                 timeout_s=timeout_s)
    if grads is not None:
        h.push(grads)
        h.close()
    return h


def allreduce_async(tensor, op: str = "sum",
                    group_name: str = "default",
                    quant: Optional[str] = None,
                    hierarchy: Optional[str] = None,
                    timeout_s: Optional[float] = None) -> GradSync:
    """Async allreduce of a single tensor on the group's comm lane;
    ``.wait()`` returns the reduced array."""
    h = GradSync(group_name, op=op, average=False, quant=quant,
                 hierarchy=hierarchy, timeout_s=timeout_s)
    h.push(tensor)
    h.close()
    return h

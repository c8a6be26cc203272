"""Host-tensor collectives: p2p ring transport with a control-store KV
fallback (the Gloo role).

Two transports, picked per op:

- **p2p ring** (collective/p2p.py, the default for data-sized payloads):
  ranks rendezvous ONCE per group through a small KV exchange of worker
  host/port — the only head traffic, independent of payload size — then
  move chunked tensor segments directly worker↔worker over the
  multi-segment RPC data plane (reduce-scatter + allgather ring
  phases, pipelined subchunks, optional int8 blockwise quantization for
  allreduce). Peer death surfaces as CollectiveError on every surviving
  rank via ring poison propagation, never a hang.

- **KV** (this module's legacy algorithm): each op gets a (group, seq)
  namespace; every rank publishes its contribution and awaits peers'
  via server-side blocking kv_wait RPCs issued CONCURRENTLY, then
  reduces locally. Retained for tiny payloads (< collective_p2p_min_bytes
  — a ring handshake costs more than one head round trip), for
  processes without a worker runtime, and as the RT_COLLECTIVE_P2P=0
  kill switch.

Routing is by local payload size for allreduce/reducescatter (ranks
must hold same-shape tensors, so the decision is group-consistent) and
send (the receiver dual-waits on both transports). broadcast and
allgather ride p2p whenever the group has it: only the source knows the
broadcast size and allgather sizes may differ per rank, so a
size-dependent choice could diverge across ranks and hang.

Intended for host tensors (rendezvous payloads, metrics, CPU-tier CI,
gradient exchange between hosts); device tensors should use in-graph
mesh collectives instead.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.collective import p2p
from ray_tpu_torch.core.exceptions import CollectiveError  # noqa: F401 — re-export
from ray_tpu_torch.observability import core_metrics, tracing
from ray_tpu_torch.utils import serialization


def _host_array(x) -> np.ndarray:
    """``x`` as a host array for the wire. A torch tensor, on either
    device, is detached and copied to the host (a copy on the CPU too:
    its owner may write into it while a bucket is on the wire), bf16
    widened to f32; the tensor itself stays where it is. Anything else
    goes through np.asarray, as in the JAX package."""
    import sys

    torch = sys.modules.get("torch")  # no tensor exists before torch is imported
    if torch is not None and isinstance(x, torch.Tensor):
        x = x.detach()
        dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
        return x.to("cpu", dtype, copy=True).numpy()
    return np.asarray(x)


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


_REDUCERS = {
    ReduceOp.SUM: lambda xs: sum(xs[1:], xs[0].copy()),
    ReduceOp.PRODUCT: lambda xs: np.prod(np.stack(xs), axis=0),
    ReduceOp.MIN: lambda xs: np.min(np.stack(xs), axis=0),
    ReduceOp.MAX: lambda xs: np.max(np.stack(xs), axis=0),
}


class _GroupState:
    def __init__(self, group_name: str, world_size: int, rank: int):
        self.name = group_name
        self.world_size = world_size
        self.rank = rank
        self.seq = 0
        # p2p streams get their own per-(src,dst) counters: collective seq
        # numbers only align across ranks when every rank runs every op.
        self.p2p_counts: Dict[tuple, int] = {}
        # my published keys, grouped PER OP, deleted with a 2-op lag
        # (peers of op N have all read its keys once op N+2 starts —
        # bounds control-store memory)
        self.gc_queue: List[List[str]] = []
        self.lock = threading.Lock()


_groups: Dict[str, _GroupState] = {}


def _control():
    from ray_tpu_torch.core import worker as worker_mod

    return worker_mod.global_worker().control


def _ns(group: _GroupState) -> str:
    return f"coll/{group.name}"


def _active_p2p(group: _GroupState) -> Optional["p2p._P2PGroup"]:
    """The group's ring transport, when usable: rendezvoused at init AND
    the kill switch is on (checked per op so a process can flip
    RT_COLLECTIVE_P2P / config.collective_p2p for A/B runs). Flips must
    be applied to EVERY rank of a group, as bench_core's A/B does — a
    one-rank mismatch diverges collective routing until the op deadline
    (recv alone tolerates it: it dual-waits both transports)."""
    if group.world_size < 2 or not p2p.enabled():
        return None
    return p2p.group_for(group.name)


def _observe(op: str, t0: float) -> None:
    if core_metrics.ENABLED:
        core_metrics.collective_op_latency_s.observe(
            time.monotonic() - t0, tags={"op": op}
        )
    if tracing.ENABLED:
        # timeline slice for the op, joining the already-counted byte
        # metrics into the same view as task/request/pipeline slices
        ts = tracing.mono_us(t0)
        tracing.emit(tracing.collective_span(op, ts, tracing.now_us() - ts))


def _count_kv_bytes(op: str, nbytes: int) -> None:
    if core_metrics.ENABLED:
        core_metrics.collective_bytes_sent.inc(
            nbytes, tags={"op": op, "transport": "kv"}
        )


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "cpu",
    group_name: str = "default",
) -> None:
    """Register this process as `rank` of a collective group.

    Called by every participating actor/task (parity: collective.py:171).
    With p2p enabled (the default) this also performs the ring
    rendezvous — one small KV record per rank — which doubles as the
    membership barrier; the KV barrier only runs on the fallback path.
    """
    if backend not in ("cpu", "xla"):
        raise ValueError(f"unsupported backend {backend!r}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world_size {world_size}")
    _groups[group_name] = _GroupState(group_name, world_size, rank)
    if world_size > 1 and p2p.enabled():
        try:
            p2p.setup_group(group_name, world_size, rank)
            return  # rendezvous doubles as the membership barrier
        except Exception:  # noqa: BLE001 — no worker runtime / peers on KV
            p2p.drop_group(group_name)
    # rendezvous barrier so all members see each other before first op
    barrier(group_name)


def destroy_collective_group(group_name: str = "default") -> None:
    """Drop group state and delete its KV namespace (required before a
    group name can be REUSED — stale keys from a prior incarnation would
    otherwise satisfy the new group's rendezvous). The ring incarnation
    token dies with it, so in-flight deliveries from old peers are
    dropped on arrival."""
    group = _groups.pop(group_name, None)
    from ray_tpu_torch.collective import bucketed  # local import — avoids cycle
    bucketed.shutdown_lane(group_name)
    p2p.drop_group(group_name)
    try:
        _control().call_oneway("kv_del_prefix", ns=f"coll/{group_name}", prefix="")
    except Exception:  # noqa: BLE001 — cluster may already be down
        pass


def get_rank(group_name: str = "default") -> int:
    return _groups[group_name].rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _groups[group_name].world_size


def _exchange(group: _GroupState, payload: Optional[bytes], tag: str,
              ranks: Optional[List[int]] = None,
              timeout_s: float = 120.0, gc: bool = True) -> Dict[int, bytes]:
    """Publish payload under (tag, my rank); collect peers' payloads.

    gc=True is only valid for full-participation ops (every rank publishes
    and reads every other): completing op N+1 then proves all peers read
    op N-1's keys, so each rank deletes its own keys with a 2-op lag.
    Broadcast/p2p keys are exempt (the publisher can finish before readers
    arrive) and are reclaimed by destroy_collective_group().
    """
    control = _control()
    ns = _ns(group)
    if payload is not None:
        _count_kv_bytes(tag.split("/", 1)[0], len(payload))
        control.call(
            "kv_put", ns=ns, key=f"{tag}/{group.rank}", value=payload,
            retryable=True,
        )
    if payload is not None and gc:
        _gc_publish(group, [f"{tag}/{group.rank}"])
    want = ranks if ranks is not None else list(range(group.world_size))
    out = _await_keys(
        control, ns, [f"{tag}/{r}" for r in want], timeout_s
    )
    missing = [r for r in want if out.get(f"{tag}/{r}") is None]
    if missing:
        raise TimeoutError(
            f"collective {tag} on group {group.name}: ranks {missing} "
            f"missing after {timeout_s}s"
        )
    return {r: out[f"{tag}/{r}"] for r in want}


def _await_keys(control, ns: str, keys: List[str],
                timeout_s: float) -> Dict[str, Optional[bytes]]:
    """Concurrent server-side blocking kv_waits, with reconnect-and-
    reissue on transient control-store failures (the old poll loop's
    retryable=True resilience, kept under the no-polling design).

    The server caps each kv_wait at dispatch_wait_slice_s (so a barrier
    fan-in can't strand the head's dispatcher pool); a None result
    before OUR deadline means the slice expired, not that the key is
    missing — re-issue until the key lands or time runs out."""
    import time as _time

    from ray_tpu_torch.utils.config import config
    from ray_tpu_torch.utils.rpc import RpcConnectionError, RpcTimeout

    deadline = _time.monotonic() + timeout_s
    out: Dict[str, Optional[bytes]] = {}
    remaining_keys = list(keys)
    while remaining_keys:
        remaining = max(0.5, deadline - _time.monotonic())
        wait_slice = min(remaining, float(config.dispatch_wait_slice_s))
        pending = {
            k: control.call_async("kv_wait", ns=ns, key=k, wait_s=wait_slice)
            for k in remaining_keys
        }
        retry = []
        reconnect = False
        for k, p in pending.items():
            try:
                val = p.wait(wait_slice + 30.0)
            except (RpcConnectionError, RpcTimeout):
                if _time.monotonic() < deadline:
                    retry.append(k)
                    reconnect = True
                else:
                    out[k] = None
                continue
            if val is None and _time.monotonic() < deadline:
                retry.append(k)  # server slice expired — re-issue
            else:
                out[k] = val
        remaining_keys = retry
        if reconnect:
            _time.sleep(0.2)  # let the client reconnect
    return out


def _gc_publish(group: _GroupState, keys: List[str]) -> None:
    """Record this op's published keys; delete the keys of ops at least
    2 behind (every peer provably read them by then)."""
    control = _control()
    ns = _ns(group)
    with group.lock:
        group.gc_queue.append(keys)
        stale_ops = group.gc_queue[:-2]
        group.gc_queue = group.gc_queue[-2:]
    for op_keys in stale_ops:
        for key in op_keys:
            try:
                control.call_oneway("kv_del", ns=ns, key=key)
            except Exception:  # noqa: BLE001
                pass


def _next_tag(group: _GroupState, op: str) -> str:
    with group.lock:
        group.seq += 1
        return f"{op}/{group.seq}"


def allreduce(tensor, op: str = ReduceOp.SUM, group_name: str = "default",
              quant: Optional[str] = None,
              timeout_s: Optional[float] = None):
    """Allreduce across the group. quant="int8" turns on blockwise
    quantized wire payloads (p2p transport, ReduceOp.SUM over floats
    only — ~4× fewer wire bytes at a small, bounded numerics delta);
    payloads that route to the KV fallback run exact regardless."""
    group = _groups[group_name]
    arr = np.ascontiguousarray(_host_array(tensor))
    t0 = time.monotonic()
    tag = _next_tag(group, "allreduce")
    pg = _active_p2p(group)
    if pg is not None and arr.nbytes >= p2p.min_bytes():
        out = p2p.ring_allreduce(pg, arr, op, tag, quant=quant,
                                 timeout_s=timeout_s)
    else:
        parts = _exchange(group, serialization.pack(arr), tag,  # inband: ok — KV fallback stores contiguous blobs
                          timeout_s=timeout_s or 120.0)
        arrays = [serialization.unpack(parts[r]) for r in sorted(parts)]
        out = _REDUCERS[op](arrays)
    _observe("allreduce", t0)
    return out


def allgather(tensor, group_name: str = "default",
              timeout_s: Optional[float] = None) -> List[np.ndarray]:
    group = _groups[group_name]
    t0 = time.monotonic()
    tag = _next_tag(group, "allgather")
    pg = _active_p2p(group)
    if pg is not None:
        # always p2p when the ring exists: per-rank sizes may differ, so
        # a size-dependent transport choice could diverge across ranks
        out = p2p.ring_allgather(pg, _host_array(tensor), tag,
                                 timeout_s=timeout_s)
    else:
        parts = _exchange(group, serialization.pack(_host_array(tensor)),  # inband: ok — KV fallback
                          tag, timeout_s=timeout_s or 120.0)
        out = [serialization.unpack(parts[r]) for r in sorted(parts)]
    _observe("allgather", t0)
    return out


def reducescatter(tensor, op: str = ReduceOp.SUM,
                  group_name: str = "default",
                  timeout_s: Optional[float] = None):
    """Reduce across ranks, return this rank's 1/world_size slice (dim 0).

    p2p: ring reduce-scatter (O(tensor/world) wire bytes per step, no
    head traffic). KV fallback: chunk-scatter — each rank publishes ONLY
    the chunk destined for each peer and reads only its own n source
    chunks."""
    group = _groups[group_name]
    arr = _host_array(tensor)
    t0 = time.monotonic()
    tag = _next_tag(group, "reducescatter")
    pg = _active_p2p(group)
    if pg is not None and arr.nbytes >= p2p.min_bytes():
        out = p2p.ring_reducescatter(pg, arr, op, tag, timeout_s=timeout_s)
        _observe("reducescatter", t0)
        return out
    n = group.world_size
    if arr.shape[0] % n != 0:
        raise ValueError(
            f"dim 0 ({arr.shape[0]}) not divisible by world size {n}"
        )
    chunk = arr.shape[0] // n
    control = _control()
    ns = _ns(group)
    for dst in range(n):
        payload = serialization.pack(
            np.ascontiguousarray(arr[dst * chunk:(dst + 1) * chunk])
        )
        _count_kv_bytes("reducescatter", len(payload))
        control.call(  # inband: ok — KV fallback stores contiguous blobs
            "kv_put", ns=ns,
            key=f"{tag}/{dst}/{group.rank}",
            value=payload,
            retryable=True,
        )
    got = _await_keys(
        control, ns, [f"{tag}/{group.rank}/{src}" for src in range(n)],
        timeout_s or 120.0,
    )
    parts = []
    for src in range(n):
        val = got.get(f"{tag}/{group.rank}/{src}")
        if val is None:
            raise TimeoutError(
                f"reducescatter on {group.name}: rank {src} missing"
            )
        parts.append(serialization.unpack(val))
    _gc_publish(group, [f"{tag}/{dst}/{group.rank}" for dst in range(n)])
    out = _REDUCERS[op](parts)
    _observe("reducescatter", t0)
    return out


def broadcast(tensor, src_rank: int = 0, group_name: str = "default",
              timeout_s: Optional[float] = None):
    group = _groups[group_name]
    t0 = time.monotonic()
    tag = _next_tag(group, "broadcast")
    pg = _active_p2p(group)
    if pg is not None:
        # always p2p when the ring exists: only the source knows the
        # payload size, so a size-dependent choice could diverge
        arr = _host_array(tensor) if group.rank == src_rank else None
        out = p2p.ring_broadcast(pg, arr, src_rank, tag,
                                 timeout_s=timeout_s)
    else:
        payload = (
            serialization.pack(_host_array(tensor))
            if group.rank == src_rank else None
        )
        parts = _exchange(group, payload, tag, ranks=[src_rank], gc=False,
                          timeout_s=timeout_s or 120.0)
        out = serialization.unpack(parts[src_rank])
    _observe("broadcast", t0)
    return out


def barrier(group_name: str = "default") -> None:
    group = _groups[group_name]
    tag = _next_tag(group, "barrier")
    _exchange(group, b"1", tag)


def _p2p_tag(group: _GroupState, src: int, dst: int) -> str:
    with group.lock:
        n = group.p2p_counts.get((src, dst), 0) + 1
        group.p2p_counts[(src, dst)] = n
        return f"p2p/{src}/{dst}/{n}"


def send(tensor, dst_rank: int, group_name: str = "default",
         timeout_s: Optional[float] = None) -> None:
    """Point-to-point send. Payloads ≥ collective_p2p_min_bytes ride the
    direct worker↔worker transport; smaller ones ride KV (recv waits on
    both, so the split is invisible to the receiver)."""
    group = _groups[group_name]
    arr = np.ascontiguousarray(_host_array(tensor))
    t0 = time.monotonic()
    tag = _p2p_tag(group, group.rank, dst_rank)
    pg = _active_p2p(group)
    if pg is not None and arr.nbytes >= p2p.min_bytes():
        p2p.p2p_send(pg, dst_rank, tag, arr, timeout_s=timeout_s)
    else:
        payload = serialization.pack(arr)
        _count_kv_bytes("send", len(payload))
        _control().call(  # inband: ok — KV fallback stores one contiguous blob
            "kv_put", ns=_ns(group), key=f"{tag}/{group.rank}",
            value=payload, retryable=True,
        )
    _observe("send", t0)


def recv(src_rank: int, group_name: str = "default", timeout_s: float = 120.0):
    group = _groups[group_name]
    t0 = time.monotonic()
    tag = _p2p_tag(group, src_rank, group.rank)
    # dual-wait whenever ring state EXISTS, even with the local p2p flag
    # off: the SENDER's flag decides where the payload goes, and a
    # receiver that stopped watching its mailbox after a local-only flag
    # flip would strand a p2p-delivered tensor until timeout
    pg = p2p.group_for(group.name) if group.world_size > 1 else None
    if pg is None:
        parts = _exchange(group, None, tag, ranks=[src_rank],
                          timeout_s=timeout_s)
        out = serialization.unpack(parts[src_rank])
    else:
        out = _recv_either(group, pg, tag, src_rank, timeout_s)
    _observe("recv", t0)
    return out


def _recv_either(group: _GroupState, pg, tag: str, src_rank: int,
                 timeout_s: float):
    """The SENDER picks the transport by payload size, so the receiver
    waits on BOTH: the p2p mailbox (short bounded waits) and a
    server-side blocking kv_wait (issued async, reissued if it expires
    empty or the connection hiccups)."""
    control = _control()
    ns = _ns(group)
    key = f"{tag}/{src_rank}"
    deadline = time.monotonic() + timeout_s
    pending = None
    while True:
        got, payload = p2p.try_recv(pg, tag, wait_s=0.05)
        if got:
            return np.asarray(payload)
        if pending is None:
            try:
                # short server-side slices, reissued while time remains:
                # a payload that arrives via p2p abandons the kv leg, and
                # an abandoned full-deadline kv_wait would strand a head
                # dispatcher thread per recv for up to the whole timeout
                pending = control.call_async(
                    "kv_wait", ns=ns, key=key,
                    wait_s=min(2.0, max(0.5, deadline - time.monotonic())),
                )
            except Exception:  # noqa: BLE001 — reconnect next loop
                pending = None
        elif pending.event.is_set():
            try:
                val = pending.wait(0)
            except Exception:  # noqa: BLE001 — conn hiccup: reissue
                val = None
            pending = None
            if val is not None:
                return serialization.unpack(val)
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"recv from rank {src_rank} on group {group.name}: "
                f"nothing after {timeout_s}s"
            )

"""Peer-to-peer ring transport for host collectives.

The KV path (collective.py) relays every payload byte through the
control store: each rank kv_puts its full tensor and kv_waits everyone
else's — O(world²·payload) through one head process, capped at whatever
a single KV server can relay. This module moves collective bytes
DIRECTLY worker↔worker over the multi-segment RPC data plane
(utils/rpc.py): ranks rendezvous once per group through a small
control-store KV exchange (worker host/port + an incarnation token per
rank — the ONLY head traffic, independent of payload size), then stream
chunked tensor segments around the ring.

Transport: every worker process already runs an RpcServer
(core/worker.py) and keeps a worker↔worker client pool; ring chunk
sends are ``coll_deliver`` RPCs whose ndarray payloads ride as raw
out-of-band segments — vectored sendmsg on the sender, recv_into
preallocated buffers on the receiver, never re-pickled in-band
(tools/check_inband_payloads.py pins this). Delivery is idempotent
(tag-deduplicated mailbox), so sends retry safely across connection
drops.

Algorithms (ring/reduce-scatter structure is what makes large-world
collectives scale — MLPerf TPU-pod study, arxiv 1909.09756):

  allreduce     reduce-scatter phase + allgather phase; each ring chunk
                splits into pipeline subchunks (collective_chunk_bytes)
                so subchunk k+1 is on the wire while k reduces in place
  reducescatter the matching single phase (rank r ends owning chunk r)
  allgather     ring forwarding, world-1 hops
  broadcast     chunk-pipelined chain forward from the source rank
  send/recv     direct dial (collective.py routes payloads ≥
                collective_p2p_min_bytes here; smaller ones stay on KV)

Quantized allreduce (EQuARX, arxiv 2506.17615): ``quant="int8"``
quantizes each subchunk blockwise on the SENDING host (int8 payload +
one f32 scale per collective_quant_block elements), accumulates in f32,
and dequantizes once per received chunk — the allgather phase forwards
received quantized payloads VERBATIM, so a fully-reduced chunk is
quantized exactly once (by its owner) no matter how many hops it rides.
~4× fewer wire bytes at a bounded, tested numerics delta
(tests/test_collective_p2p.py pins the per-dtype error bound).

Failure: a rank that cannot deliver to a peer — or times out waiting —
poisons the ring with a tiny ``coll_deliver`` poison message forwarded
neighbor-to-neighbor (deduplicated by poison id, no head traffic), so
every surviving rank raises CollectiveError promptly instead of
hanging. destroy + init_collective_group re-rendezvouses a fresh
incarnation; deliveries from the old one are dropped by token mismatch.

Kill switch: RT_COLLECTIVE_P2P=0 routes everything back through the KV
path (collective.py checks it before dispatching here).
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.core.exceptions import CollectiveError
from ray_tpu_torch.observability import core_metrics
from ray_tpu_torch.utils import rpc as rpc_mod
from ray_tpu_torch.utils import serialization
from ray_tpu_torch.utils.config import config

# Per-process transport statistics. Tests and bench_core read these
# through actor methods (each rank is its own process) to pin wire-byte
# claims — quantized vs f32, p2p-vs-KV routing — independent of the
# metrics pipeline; core metrics mirror the send side when enabled.
stats = {"bytes_sent": 0, "bytes_recv": 0, "sends": 0, "delivers": 0,
         "bytes_sent_inter": 0}
_stats_lock = threading.Lock()

_DELIVER = "coll_deliver"
_MISSING = object()
# Test hook: called as _step_hook(phase, step) at the top of every ring
# step (failure tests arm it to kill this process deterministically
# MID-ring, between chunk exchanges). None on the hot path.
_step_hook = None
# delivered-tag memory per group (duplicate suppression for retried
# sends); trimmed FIFO so a long-lived group cannot grow unbounded
_SEEN_CAP = 8192


def reset_stats() -> Dict[str, int]:
    """Snapshot-and-zero the per-process transport counters (tests)."""
    with _stats_lock:
        snap = dict(stats)
        for k in stats:
            stats[k] = 0
    return snap


def snapshot_stats() -> Dict[str, int]:
    with _stats_lock:
        return dict(stats)


class _P2PGroup:
    """Per-process ring state for one collective group incarnation."""

    def __init__(self, name: str, world_size: int, rank: int, token: str):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.token = token  # my incarnation id (published at rendezvous)
        # rank -> (worker rpc address, incarnation token, host id)
        self.peers: List[Tuple[str, str, str]] = []
        self.mailbox: Dict[str, Any] = {}
        self.seen: set = set()
        self.seen_order: deque = deque()
        self.cv = threading.Condition()
        self.failed: Optional[str] = None
        self.poisons: set = set()


_groups: Dict[str, _P2PGroup] = {}
_groups_lock = threading.Lock()


def _worker():
    from ray_tpu_torch.core import worker as worker_mod

    return worker_mod.global_worker()


def enabled() -> bool:
    return bool(config.collective_p2p)


def min_bytes() -> int:
    return int(config.collective_p2p_min_bytes)


def group_for(name: str) -> Optional[_P2PGroup]:
    with _groups_lock:
        return _groups.get(name)


def host_id() -> str:
    """This process's host identity for collective topology: the
    collective_host_id override (tests/bench model multi-host placement
    on one box with it) or the worker address host."""
    hid = str(config.collective_host_id or "")
    if hid:
        return hid
    addr = getattr(_worker(), "address", "") or ""
    return addr.rsplit(":", 1)[0] or "localhost"


def host_of(g: _P2PGroup, rank: int) -> str:
    return g.peers[rank][2]


# ---------------------------------------------------------------------------
# rendezvous / teardown
# ---------------------------------------------------------------------------


def setup_group(name: str, world_size: int, rank: int,
                timeout_s: Optional[float] = None) -> _P2PGroup:
    """One small KV exchange per member: publish (worker address,
    incarnation token), await every peer's. This — plus destroy's key
    cleanup — is the only control-store traffic a p2p collective ever
    generates: O(world) values of ~100 bytes, independent of payload
    size. Doubles as the group rendezvous barrier (all members are
    provably up once it returns)."""
    from ray_tpu_torch.collective import collective as coll_mod

    w = _worker()
    timeout_s = timeout_s or float(config.collective_op_timeout_s)
    token = uuid.uuid4().hex
    g = _P2PGroup(name, world_size, rank, token)
    # register the mailbox BEFORE publishing: a peer that finishes its
    # rendezvous first may start delivering the instant our record is
    # visible, and an unregistered group would bounce those deliveries
    # as stale (the sender treats a bounce as a dead incarnation)
    with _groups_lock:
        _groups[name] = g
    ns = f"coll/{name}"
    payload = serialization.dumps((w.address, token, host_id()))
    try:
        w.control.call(  # inband: ok — ~100 B rendezvous record, not data
            "kv_put", ns=ns, key=f"p2p/{rank}", value=payload,
            retryable=True,
        )
        out = coll_mod._await_keys(
            w.control, ns, [f"p2p/{r}" for r in range(world_size)],
            timeout_s,
        )
        peers: List[Tuple[str, str, str]] = []
        missing = []
        for r in range(world_size):
            val = out.get(f"p2p/{r}")
            if val is None:
                missing.append(r)
            else:
                peers.append(serialization.loads(val))
        if missing:
            raise TimeoutError(
                f"collective group {name!r} p2p rendezvous: ranks "
                f"{missing} missing after {timeout_s}s"
            )
    except BaseException:
        drop_group(name)
        raise
    g.peers = peers
    return g


def drop_group(name: str) -> None:
    """Forget this process's ring state for a group; any thread blocked
    in a mailbox wait raises. Deliveries addressed to the old
    incarnation token are dropped on arrival from now on."""
    with _groups_lock:
        g = _groups.pop(name, None)
    if g is not None:
        with g.cv:
            if g.failed is None:
                g.failed = "group destroyed"
            g.cv.notify_all()


# ---------------------------------------------------------------------------
# delivery (the worker's rpc_coll_deliver lands here)
# ---------------------------------------------------------------------------


def deliver(group: str, token: str, tag: str, payload=None,
            poison: Optional[str] = None) -> bool:
    g = group_for(group)
    if g is None or token != g.token:
        return False  # stale incarnation / unknown group: drop silently
    if poison is not None:
        _poison_local(g, tag, poison)
        return True
    nbytes = _payload_nbytes(payload)
    with _stats_lock:
        stats["bytes_recv"] += nbytes
        stats["delivers"] += 1
    with g.cv:
        if tag in g.seen:
            return True  # duplicate from a sender retry: already have it
        g.seen.add(tag)
        g.seen_order.append(tag)
        while len(g.seen_order) > _SEEN_CAP:
            g.seen.discard(g.seen_order.popleft())
        g.mailbox[tag] = payload
        g.cv.notify_all()
    return True


def _poison_local(g: _P2PGroup, poison_id: str, reason: str) -> None:
    """Record a ring failure and forward it to both neighbors exactly
    once (dedup by poison id stops the echo) — failure propagation with
    zero head traffic."""
    with g.cv:
        if poison_id in g.poisons:
            return
        g.poisons.add(poison_id)
        if g.failed is None:
            g.failed = reason
        g.cv.notify_all()
    if not g.peers:
        return  # poisoned before rendezvous finished: nothing to dial
    world = g.world_size
    for nb in {(g.rank + 1) % world, (g.rank - 1) % world}:
        if nb == g.rank:
            continue
        try:
            _client(g, nb).call_oneway(
                _DELIVER, group=g.name, token=g.peers[nb][1],
                tag=poison_id, poison=reason,
            )
        except Exception:  # noqa: BLE001 — neighbor may be the dead one
            pass


def poison_group(g: _P2PGroup, reason: str) -> None:
    _poison_local(g, f"__poison__/{uuid.uuid4().hex}", reason)


# ---------------------------------------------------------------------------
# send / recv primitives
# ---------------------------------------------------------------------------


def _client(g: _P2PGroup, rank: int) -> rpc_mod.RpcClient:
    return _worker().workers.get(g.peers[rank][0])


def _payload_nbytes(payload) -> int:
    if isinstance(payload, np.ndarray):
        return payload.nbytes
    if isinstance(payload, tuple):
        return sum(
            p.nbytes for p in payload if isinstance(p, np.ndarray)
        )
    if payload is None:
        return 0
    try:
        return len(payload)
    except TypeError:
        return 0


def send_async(g: _P2PGroup, dst: int, tag: str, payload,
               op: str = "p2p"):
    """Fire one chunk delivery at ``dst``; the frame is on the wire when
    this returns (call_async semantics), so issuing all of a step's
    subchunks back-to-back pipelines the wire against the receiver's
    reduce. Returns a handle for reap(). ndarray / (int8, scales) tuple
    payloads ride as raw out-of-band segments."""
    nbytes = _payload_nbytes(payload)
    # hierarchical-mode accounting: a delivery whose destination host
    # differs from ours crossed a host boundary (with collective_host_id
    # overrides this models multi-host placement even on one box)
    inter = bool(g.peers) and g.peers[dst][2] != g.peers[g.rank][2]
    with _stats_lock:
        stats["bytes_sent"] += nbytes
        stats["sends"] += 1
        if inter:
            stats["bytes_sent_inter"] += nbytes
    if core_metrics.ENABLED:
        core_metrics.collective_bytes_sent.inc(
            nbytes, tags={"op": op, "transport": "p2p"}
        )
        if inter:
            core_metrics.collective_inter_bytes.inc(nbytes, tags={"op": op})
    # chaos parity with RpcClient.call: call_async has no injection
    # point, so the collective transport rolls its own. An injected
    # request drop models a torn send the SENDER sees immediately — the
    # sane transport response is to resend on the spot (a frame that
    # never left cannot be waited out by the receiver, and leaving it to
    # the end-of-step reap could make a full ring of simultaneous drops
    # circular-wait until the op deadline).
    for _ in range(20):
        try:
            rpc_mod.maybe_inject_request_failure(_DELIVER)
            break
        except rpc_mod.RpcConnectionError:
            continue
    try:
        pending = _client(g, dst).call_async(
            _DELIVER, group=g.name, token=g.peers[dst][1], tag=tag,
            payload=payload,
        )
    except (rpc_mod.RpcError, OSError):
        # dial failed: hand reap() a pending-less handle — its retry
        # ladder redials, and poisons the ring if the peer stays dead
        pending = None
    return (dst, tag, payload, pending)


def reap(g: _P2PGroup, handles, deadline: float) -> None:
    """Await delivery acks; failed sends retry synchronously (delivery
    is idempotent, so a resend after a lost ack is harmless). The retry
    ladder is bounded by the OP deadline, not just per-call timeouts —
    each redial to a dead peer burns up to rpc_connect_timeout_s, and a
    stuck op must surface as ring poison within the op budget, not after
    an attempts×connect-timeout stall."""
    for dst, tag, payload, pending in handles:
        last: Optional[Exception] = None
        bounced = False
        if pending is not None:
            try:
                ack = pending.wait(max(0.1, deadline - time.monotonic()))
                rpc_mod.maybe_inject_response_failure(_DELIVER)
                if ack is not False:
                    continue
                bounced = True  # receiver dropped it: stale incarnation
            except rpc_mod.RpcError as e:
                last = e
        delivered = False
        for attempt in range(3):
            if bounced or (attempt and time.monotonic() >= deadline):
                break
            try:
                ack = _client(g, dst).call(
                    _DELIVER, group=g.name, token=g.peers[dst][1],
                    tag=tag, payload=payload,
                    timeout_s=max(0.5, deadline - time.monotonic()),
                    retryable=False,
                )
                if ack is False:
                    bounced = True
                    break
                delivered = True
                break
            except rpc_mod.RpcError as e:
                last = e
        if delivered:
            continue
        reason = (
            f"rank {g.rank} could not deliver {tag} to rank {dst} "
            f"({g.peers[dst][0]}): "
            + ("receiver dropped it (group destroyed or re-initialized "
               "with a new incarnation)" if bounced
               else f"{type(last).__name__}: {last}")
        )
        poison_group(g, reason)
        raise CollectiveError(reason) from last


def send_now(g: _P2PGroup, dst: int, tag: str, payload,
             deadline: float, op: str = "p2p") -> None:
    """Fire-and-ack a single delivery (send/recv and poison-free small
    control messages)."""
    reap(g, [send_async(g, dst, tag, payload, op=op)], deadline)


def recv(g: _P2PGroup, tag: str, deadline: float):
    """Block until ``tag`` lands in the mailbox. Raises CollectiveError
    if the ring is poisoned or the deadline passes (and poisons the ring
    on timeout — a stuck op is broken for everyone)."""
    fail: Optional[str] = None
    with g.cv:
        while True:
            payload = g.mailbox.pop(tag, _MISSING)
            if payload is not _MISSING:
                return payload
            if g.failed is not None:
                fail = g.failed
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            g.cv.wait(min(remaining, 0.5))
    if fail is not None:
        raise CollectiveError(f"collective group {g.name!r}: {fail}")
    reason = (
        f"rank {g.rank} timed out waiting for {tag} on group {g.name!r}"
    )
    poison_group(g, reason)
    raise CollectiveError(reason)


def try_recv(g: _P2PGroup, tag: str, wait_s: float) -> Tuple[bool, Any]:
    """Bounded mailbox wait: (True, payload) if ``tag`` arrived, (False,
    None) if not yet. Raises CollectiveError if the ring is poisoned
    (collective.recv's dual KV/p2p wait loop uses this)."""
    deadline = time.monotonic() + wait_s
    with g.cv:
        while True:
            payload = g.mailbox.pop(tag, _MISSING)
            if payload is not _MISSING:
                return True, payload
            if g.failed is not None:
                raise CollectiveError(
                    f"collective group {g.name!r}: {g.failed}"
                )
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False, None
            g.cv.wait(remaining)


# ---------------------------------------------------------------------------
# chunking + int8 blockwise quantization (EQuARX-style)
# ---------------------------------------------------------------------------


def _subchunks(view: np.ndarray) -> List[np.ndarray]:
    """Split a 1-D contiguous view into pipeline subchunks of about
    collective_chunk_bytes each (always at least one, possibly empty for
    zero-size chunks so send/recv tag counts still match)."""
    step = max(1, int(config.collective_chunk_bytes) // max(1, view.itemsize))
    if view.size <= step:
        return [view]
    return [view[i:i + step] for i in range(0, view.size, step)]


def _quant_int8(x: np.ndarray) -> Tuple[int, np.ndarray, np.ndarray]:
    """Blockwise int8 quantization: one f32 scale per
    collective_quant_block elements, scale = blockmax/127 so values
    never clip. Returns (block, int8 payload, f32 scales)."""
    block = max(1, int(config.collective_quant_block))
    n = x.size
    nb = max(1, -(-n // block))
    pad = nb * block - n
    xb = x if not pad else np.concatenate(
        [x, np.zeros(pad, dtype=x.dtype)]
    )
    xb = xb.reshape(nb, block)
    scales = (np.abs(xb).max(axis=1) / 127.0).astype(np.float32)
    safe = np.where(scales > 0.0, scales, np.float32(1.0)).astype(np.float32)
    q = np.rint(xb / safe[:, None]).astype(np.int8).reshape(-1)
    return block, q[:n], safe


def _dequant_int8(block: int, q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    n = q.size
    nb = scales.size
    xf = q.astype(np.float32)
    pad = nb * block - n
    if pad:
        xf = np.concatenate([xf, np.zeros(pad, dtype=np.float32)])
    xf = (xf.reshape(nb, block) * scales[:, None]).reshape(-1)
    return xf[:n]


def _encode(sub: np.ndarray, quant: Optional[str]):
    if quant is None:
        return sub  # contiguous view: pickles as a zero-copy oob buffer
    block, q, scales = _quant_int8(sub)
    return ("q8", block, q, scales)


def _decode(incoming, quant: Optional[str]) -> np.ndarray:
    if quant is None:
        return incoming
    _, block, q, scales = incoming
    return _dequant_int8(block, q, scales)


_INPLACE_REDUCERS = {
    "sum": lambda a, b: np.add(a, b, out=a, casting="unsafe"),
    "product": lambda a, b: np.multiply(a, b, out=a, casting="unsafe"),
    "min": lambda a, b: np.minimum(a, b, out=a),
    "max": lambda a, b: np.maximum(a, b, out=a),
}


# ---------------------------------------------------------------------------
# ring collectives
# ---------------------------------------------------------------------------


def _deadline(timeout_s: Optional[float]) -> float:
    return time.monotonic() + (
        timeout_s if timeout_s is not None
        else float(config.collective_op_timeout_s)
    )


def _flat_chunks(acc: np.ndarray, world: int) -> List[np.ndarray]:
    per = acc.size // world
    return [acc[i * per:(i + 1) * per] for i in range(world)]


def ring_allreduce(g: _P2PGroup, arr: np.ndarray, op: str, tag: str,
                   quant: Optional[str] = None,
                   timeout_s: Optional[float] = None,
                   ring: Optional[List[int]] = None) -> np.ndarray:
    """Pipelined ring allreduce: reduce-scatter then allgather, each
    ring chunk split into subchunks so the wire and the local reduce
    overlap. With quant="int8" (SUM over floats only) every wire payload
    is blockwise-int8; accumulation stays f32 and forwarded allgather
    payloads are passed on verbatim, so each final chunk is quantized
    exactly once.

    ``ring`` restricts the op to an ordered subset of the group's ranks
    (every member must pass the SAME list, and this rank must be in it)
    — the hierarchical two-level mode runs its inter-host phase as a
    ring over host leaders only this way."""
    deadline = _deadline(timeout_s)
    shape, dtype = arr.shape, arr.dtype
    members = ring if ring is not None else list(range(g.world_size))
    world = len(members)
    pos = members.index(g.rank)
    if quant is not None:
        if quant != "int8":
            raise ValueError(f"unsupported quant mode {quant!r}")
        if op != "sum":
            raise ValueError("quantized allreduce supports ReduceOp.SUM only")
        if dtype.kind != "f":
            raise ValueError(
                f"quantized allreduce needs a float tensor, got {dtype}"
            )
        acc = np.ascontiguousarray(arr).reshape(-1).astype(
            np.float32, copy=True
        )
    else:
        acc = np.ascontiguousarray(arr).reshape(-1).copy()
    if world < 2:
        return acc.astype(dtype, copy=False).reshape(shape)
    n0 = acc.size
    pad = (-n0) % world
    if pad:
        acc = np.concatenate([acc, np.zeros(pad, dtype=acc.dtype)])
    chunks = _flat_chunks(acc, world)
    nxt = members[(pos + 1) % world]
    red = _INPLACE_REDUCERS[op]

    # phase 1: reduce-scatter — after world-1 steps ring position p owns
    # the fully-reduced chunk (p+1) % world
    for step in range(world - 1):
        if _step_hook is not None:
            _step_hook("rs", step)
        si = (pos - step) % world
        ri = (pos - step - 1) % world
        handles = [
            send_async(g, nxt, f"{tag}/rs{step}/{j}",
                       _encode(sub, quant), op="allreduce")
            for j, sub in enumerate(_subchunks(chunks[si]))
        ]
        for j, sub in enumerate(_subchunks(chunks[ri])):
            incoming = _decode(
                recv(g, f"{tag}/rs{step}/{j}", deadline), quant
            )
            red(sub, incoming)
        reap(g, handles, deadline)

    # phase 2: allgather — forward received payloads VERBATIM (quantized
    # chunks are quantized once by their owner, dequantized once here)
    carry = []
    for sub in _subchunks(chunks[(pos + 1) % world]):
        payload = _encode(sub, quant)
        if quant is not None:
            # the owner adopts the same quantization loss it ships:
            # allreduce must leave every rank with the IDENTICAL tensor
            # (data-parallel replicas diverge otherwise), so the exact
            # f32 chunk is replaced by its own dequantized image
            np.copyto(sub, _decode(payload, quant), casting="unsafe")
        carry.append(payload)
    for step in range(world - 1):
        ri = (pos - step) % world
        handles = [
            send_async(g, nxt, f"{tag}/ag{step}/{j}", payload,
                       op="allreduce")
            for j, payload in enumerate(carry)
        ]
        carry = []
        for j, sub in enumerate(_subchunks(chunks[ri])):
            incoming = recv(g, f"{tag}/ag{step}/{j}", deadline)
            np.copyto(sub, _decode(incoming, quant), casting="unsafe")
            carry.append(incoming)
        reap(g, handles, deadline)

    out = acc[:n0] if pad else acc
    return out.astype(dtype, copy=False).reshape(shape)


def ring_reducescatter(g: _P2PGroup, arr: np.ndarray, op: str, tag: str,
                       timeout_s: Optional[float] = None) -> np.ndarray:
    """Ring reduce-scatter along dim 0: rank r returns the fully-reduced
    r-th 1/world slice. Chunk traversal is shifted by one vs allreduce's
    phase 1 so the final owned chunk index equals the rank."""
    deadline = _deadline(timeout_s)
    world = g.world_size
    if arr.shape[0] % world != 0:
        raise ValueError(
            f"dim 0 ({arr.shape[0]}) not divisible by world size {world}"
        )
    acc = np.ascontiguousarray(arr).copy()
    rows = arr.shape[0] // world
    flat = acc.reshape(-1)
    chunks = _flat_chunks(flat, world)
    nxt = (g.rank + 1) % world
    red = _INPLACE_REDUCERS[op]
    for step in range(world - 1):
        si = (g.rank - step - 1) % world
        ri = (g.rank - step - 2) % world
        handles = [
            send_async(g, nxt, f"{tag}/rs{step}/{j}", sub,
                       op="reducescatter")
            for j, sub in enumerate(_subchunks(chunks[si]))
        ]
        for j, sub in enumerate(_subchunks(chunks[ri])):
            red(sub, recv(g, f"{tag}/rs{step}/{j}", deadline))
        reap(g, handles, deadline)
    return acc[g.rank * rows:(g.rank + 1) * rows]


def ring_allgather(g: _P2PGroup, arr: np.ndarray, tag: str,
                   timeout_s: Optional[float] = None) -> List[np.ndarray]:
    """Ring allgather: world-1 hops, each forwarding the array received
    the hop before (shapes may differ per rank, so whole arrays travel
    as single out-of-band payloads)."""
    deadline = _deadline(timeout_s)
    world = g.world_size
    nxt = (g.rank + 1) % world
    local = np.ascontiguousarray(arr)
    out: List[Optional[np.ndarray]] = [None] * world
    out[g.rank] = local
    carry: Any = local
    for step in range(world - 1):
        handles = [send_async(g, nxt, f"{tag}/ag{step}", carry,
                              op="allgather")]
        src = (g.rank - step - 1) % world
        carry = recv(g, f"{tag}/ag{step}", deadline)
        out[src] = np.asarray(carry)
        reap(g, handles, deadline)
    return out  # type: ignore[return-value]


def ring_broadcast(g: _P2PGroup, arr: Optional[np.ndarray], src: int,
                   tag: str,
                   timeout_s: Optional[float] = None) -> np.ndarray:
    """Chunk-pipelined chain broadcast: the source streams subchunks to
    its ring successor; every other rank forwards each subchunk as soon
    as it lands (unless the successor is the source), so the extra
    latency per hop is one subchunk, not one tensor."""
    deadline = _deadline(timeout_s)
    world = g.world_size
    nxt = (g.rank + 1) % world
    if g.rank == src:
        flat = np.ascontiguousarray(arr).reshape(-1)
        subs = _subchunks(flat)
        header = ("hdr", arr.shape, arr.dtype.str, len(subs))
        if world > 1:
            handles = [send_async(g, nxt, f"{tag}/h", header,
                                  op="broadcast")]
            handles += [
                send_async(g, nxt, f"{tag}/b{j}", sub, op="broadcast")
                for j, sub in enumerate(subs)
            ]
            reap(g, handles, deadline)
        return np.asarray(arr)
    header = recv(g, f"{tag}/h", deadline)
    _, shape, dtype_str, nsubs = header
    forward = nxt != src
    handles = []
    if forward:
        handles.append(send_async(g, nxt, f"{tag}/h", header,
                                  op="broadcast"))
    parts = []
    for j in range(nsubs):
        sub = recv(g, f"{tag}/b{j}", deadline)
        parts.append(np.asarray(sub))
        if forward:
            handles.append(send_async(g, nxt, f"{tag}/b{j}", sub,
                                      op="broadcast"))
    reap(g, handles, deadline)
    flat = parts[0] if len(parts) == 1 else np.concatenate(parts)
    return flat.astype(np.dtype(dtype_str), copy=False).reshape(shape)


def p2p_send(g: _P2PGroup, dst: int, tag: str, arr: np.ndarray,
             timeout_s: Optional[float] = None) -> None:
    """Point-to-point send of one whole array as a single out-of-band
    delivery (collective.send routes payloads ≥ collective_p2p_min_bytes
    here)."""
    send_now(g, dst, tag, np.ascontiguousarray(arr),
             _deadline(timeout_s), op="send")

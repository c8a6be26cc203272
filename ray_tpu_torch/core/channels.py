"""Mutable shared-memory channels — the compiled-graph data plane.

Parity: the reference's experimental mutable-object channels
(python/ray/experimental/channel/shared_memory_channel.py over
src/ray/core_worker/experimental_mutable_object_manager.cc): a
pre-allocated shm segment REUSED for every message, so a static actor
loop (e.g. pipeline microbatches between co-located stages) pays one
mmap once and then a memcpy + seqlock flip per message instead of
object-store create/seal/get RPCs.

Single-writer single-reader. Ring layout (v2 — ``slots`` messages can
be in flight so a compiled pipeline streams rounds without a
per-message rendezvous):

  [seq u64][ack u64][nslots u64][slot_cap u64]        32-byte header
  slot i at 32 + i*(8+slot_cap): [len u64][payload]

``seq`` counts messages PUBLISHED, ``ack`` messages CONSUMED; message k
lives in slot k % nslots. The writer bumps seq AFTER the payload is
fully written and BLOCKS while seq - ack == nslots (ring full); the
reader consumes strictly in order and publishes ack after copying out —
flow control, so a compiled DAG (ray_tpu_torch/dag.py) can run producers up
to ``slots`` rounds ahead of consumers without losing messages.
``slots=1`` reproduces the original one-in-flight seqlock semantics.

Values travel via :meth:`write_value` / :meth:`read_value`:
pickle-5 serialize yields (meta, out-of-band buffer views) and the
views are scatter-gather-copied STRAIGHT into the shm slot — exactly
one host copy per message, never an intermediate join
(tools/check_inband_payloads.py pins the call sites).

Waiting is hybrid: a short busy-spin on the shm header (single-digit µs
wakeups when reader and writer run on different cores — the reference's
compiled-graph regime), then a blocking poll on a FIFO doorbell so a
core-starved box (or an idle DAG) parks in the kernel instead of
burning the core the peer needs. The doorbell is only a hint; the shm
header is the ground truth. The native core (native/src/
channel_core.cpp) shares the layout — native and Python peers
interoperate, and Python rides its begin/commit entry points so even
the fallback-free path publishes through futex-waking atomics.

Cross-host tier: :class:`RpcChannel` — same write/read surface, but
messages ride one worker↔worker ``chan_push`` RPC each, with payloads
≥ 32 KiB wrapped in ``serialization.maybe_frame`` so they travel as
raw out-of-band multiseg segments (utils/rpc.py), never re-pickled
in-band. Flow control is a bounded receiver mailbox (``slots`` deep):
a full mailbox bounces the push and the writer retries until its
deadline. A compiled pipeline places ShmChannel on same-host stage
edges and RpcChannel on cross-host ones (parallel/pipeline.py).
"""

from __future__ import annotations

import ctypes
import mmap
import os
import select
import struct
import tempfile
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

from ray_tpu_torch.observability import core_metrics
from ray_tpu_torch.utils import serialization

_HDR = struct.Struct("<QQQQ")  # seq, ack, nslots, slot_cap
_SHM_DIR = "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()

def _spin_window_s() -> float:
    """How long to busy-poll the header before parking on the doorbell.
    On a single-core box spinning only steals the cycles the peer needs
    to produce the message — go straight to the kernel wait."""
    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cores = os.cpu_count() or 1
    return 0.0001 if cores > 1 else 0.0


_SPIN_S = _spin_window_s()

# Below this total, a native write joins its parts and ships through ONE
# rt_chan_write call; at/above it, the scatter-gather begin/commit path
# copies each pickle-5 buffer straight into the slot (no join). Matches
# serialization.FRAME_OOB_MIN: the same payload-size regime where
# out-of-band starts beating in-band.
_SG_WRITE_MIN = 32 * 1024


class ShmChannel:
    def __init__(self, path: str, capacity: int, create: bool = False,
                 slots: int = 1):
        if slots < 1:
            raise ValueError(f"channel needs >= 1 slot, got {slots}")
        if capacity < 1:
            raise ValueError(f"channel needs capacity >= 1, got {capacity}")
        # round the slot capacity up to 8B so every slot's length word
        # (at 32 + i*(8+cap)) stays naturally aligned for the native
        # core's atomic u64 accesses — an unaligned atomic is UB
        # (SIGBUS on ARM, torn on a split cache line). The handle
        # carries the rounded value, so peers always agree.
        capacity = (capacity + 7) & ~7
        self.path = path
        self.capacity = capacity  # per-slot payload capacity
        self.slots = slots
        # Native core (C++ seqlock + futex handoff, native/src/
        # channel_core.cpp): same shm layout, so native and Python peers
        # interoperate; Python below is the fallback tier.
        self._native = None
        from ray_tpu_torch import native as native_mod

        lib = native_mod.channel_lib()
        if lib is not None:
            handle = ctypes.c_void_p()
            rc = lib.rt_chan_open(
                path.encode(), capacity, slots, 1 if create else 0,
                ctypes.byref(handle),
            )
            if rc == 0:
                self._native = (lib, handle)
                return
            raise OSError(-rc, f"rt_chan_open({path!r}) failed")
        total = _HDR.size + slots * (8 + capacity)
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        fd = os.open(path, flags, 0o600)
        try:
            if create:
                os.ftruncate(fd, total)
            self._mm = mmap.mmap(fd, total)
        finally:
            os.close(fd)
        if create:
            self._mm[: _HDR.size] = _HDR.pack(0, 0, slots, capacity)
            for suffix in (".d", ".a"):
                try:
                    os.mkfifo(path + suffix, 0o600)
                except FileExistsError:
                    pass
        elif (self._u64(16), self._u64(24)) != (slots, capacity):
            self._mm.close()
            raise ValueError(
                f"channel {path}: geometry mismatch — creator wrote "
                f"(slots={self._u64(16)}, cap={self._u64(24)}), attach "
                f"asked (slots={slots}, cap={capacity})"
            )
        # O_RDWR so neither side blocks in open() waiting for a peer
        self._dbell = os.open(path + ".d", os.O_RDWR | os.O_NONBLOCK)
        self._abell = os.open(path + ".a", os.O_RDWR | os.O_NONBLOCK)
        # a reader resumes from what has been CONSUMED (ack), not from the
        # latest seq — messages written before the reader attached (e.g.
        # dag.execute racing the exec loop's channel attach) must still be
        # delivered, in order
        self._last_read = self._u64(8)

    @classmethod
    def create(cls, capacity: int = 4 * 1024 * 1024,
               slots: int = 1) -> "ShmChannel":
        path = os.path.join(_SHM_DIR, f"rttchan_{uuid.uuid4().hex[:16]}")
        return cls(path, capacity, create=True, slots=slots)

    @classmethod
    def attach(cls, path: str, capacity: int, slots: int = 1) -> "ShmChannel":
        return cls(path, capacity, create=False, slots=slots)

    def handle(self):
        """Picklable (path, capacity, slots) to hand to the peer actor."""
        return {"path": self.path, "capacity": self.capacity,
                "slots": self.slots}

    @classmethod
    def from_handle(cls, handle) -> "ShmChannel":
        return cls.attach(handle["path"], handle["capacity"],
                          handle.get("slots", 1))

    def _u64(self, off: int) -> int:
        return int.from_bytes(self._mm[off: off + 8], "little")

    def _slot_off(self, msg: int) -> int:
        return _HDR.size + (msg % self.slots) * (8 + self.capacity)

    @staticmethod
    def _ring(fd: int) -> None:
        try:
            os.write(fd, b"\x01")
        except BlockingIOError:
            pass  # fifo full: peer has plenty of pending wakeups already

    @staticmethod
    def _drain(fd: int) -> None:
        try:
            os.read(fd, 64)
        except BlockingIOError:
            pass

    def _await(self, ready, bell_fd: int,
               deadline: Optional[float], what: str) -> None:
        """Hybrid wait for ``ready()``: spin on the shm header, then park
        on the doorbell fifo."""
        spin_until = time.monotonic() + _SPIN_S if _SPIN_S else 0.0
        while not ready():
            if _SPIN_S and time.monotonic() < spin_until:
                continue
            remaining = 0.05
            if deadline is not None:
                remaining = min(remaining, deadline - time.monotonic())
                if remaining <= 0:
                    raise TimeoutError(f"channel {self.path}: {what}")
            r, _, _ = select.select([bell_fd], [], [], max(remaining, 0.0))
            if r:
                self._drain(bell_fd)

    # -- writer --------------------------------------------------------

    def write(self, payload, timeout_s: Optional[float] = 60.0) -> None:
        self.write_views([payload], timeout_s)

    def write_views(self, parts: List[Any],
                    timeout_s: Optional[float] = 60.0) -> None:
        """Scatter-gather write: copy each buffer of ``parts`` into the
        next ring slot back-to-back (ONE host copy total — no join),
        then publish. Blocks while all ``slots`` slots hold unconsumed
        messages (the backpressure contract compiled DAGs rely on)."""
        views = serialization.byte_views(parts)
        total = sum(v.nbytes for v in views)
        if total > self.capacity:
            raise ValueError(
                f"payload {total} > channel slot capacity {self.capacity}"
            )
        if self._native is not None:
            lib, handle = self._native
            native_timeout = -1.0 if timeout_s is None else float(timeout_s)
            if total < _SG_WRITE_MIN:
                # small-message fast path: one native call beats the
                # begin/from_address/commit round trip, and the join of
                # a few KiB costs less than the extra ctypes hops (the
                # compiled_dag_call regime — scatter-gather only pays
                # once payloads carry real out-of-band buffers)
                data = b"".join(views) if len(views) != 1 else views[0]
                if not isinstance(data, bytes):
                    data = bytes(data)  # memoryview/bytearray → c_char_p
                rc = lib.rt_chan_write(handle, data, total, native_timeout)
            else:
                ptr = ctypes.c_void_p()
                rc = lib.rt_chan_write_begin(
                    handle, total, native_timeout, ctypes.byref(ptr),
                )
                if rc == 0:
                    dst = memoryview(
                        (ctypes.c_ubyte * total).from_address(ptr.value)
                    ).cast("B")
                    off = 0
                    for v in views:
                        dst[off: off + v.nbytes] = v
                        off += v.nbytes
                    rc = lib.rt_chan_write_commit(handle, total)
            if rc == -1:
                if core_metrics.ENABLED:
                    core_metrics.channel_write_blocks.inc(
                        tags={"transport": "shm"}
                    )
                raise TimeoutError(
                    f"channel {self.path}: ring full — reader never "
                    f"consumed (slots={self.slots})"
                )
            if rc != 0:
                raise ValueError(f"channel {self.path}: write error {rc}")
            return
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        seq = self._u64(0)  # single writer: only we advance it
        if core_metrics.ENABLED and not (seq - self._u64(8) < self.slots):
            # about to block on a full ring: writer-side backpressure
            core_metrics.channel_write_blocks.inc(tags={"transport": "shm"})
        # flow control: block while every slot holds an unconsumed message
        self._await(
            lambda: seq - self._u64(8) < self.slots, self._abell, deadline,
            f"ring full — reader never consumed (slots={self.slots})",
        )
        off = self._slot_off(seq)
        pos = off + 8
        for v in views:
            self._mm[pos: pos + v.nbytes] = v
            pos += v.nbytes
        self._mm[off: off + 8] = total.to_bytes(8, "little")
        # publish: bump seq last (release on x86/ARM via GIL + mmap)
        self._mm[0:8] = (seq + 1).to_bytes(8, "little")
        self._ring(self._dbell)

    def write_value(self, value: Any,
                    timeout_s: Optional[float] = 60.0) -> None:
        """Serialize ``value`` (pickle-5) and write its frame parts
        straight into the slot — header, meta and every out-of-band
        buffer land in shm with one copy each, no intermediate join.
        The reader's ``read_value`` (or ``serialization.unpack`` on a
        raw ``read``) inverts it."""
        meta, views = serialization.serialize(value)
        self.write_views(serialization.frame_parts(meta, views), timeout_s)

    # -- reader --------------------------------------------------------

    def read(self, timeout_s: Optional[float] = 30.0) -> bytes:
        """Block until the next unconsumed message arrives; messages are
        delivered strictly in publish order."""
        if self._native is not None:
            lib, handle = self._native
            ptr = ctypes.c_void_p()
            n = lib.rt_chan_read_begin(
                handle, -1.0 if timeout_s is None else float(timeout_s),
                ctypes.byref(ptr),
            )
            if n == -1:
                raise TimeoutError(f"channel {self.path}: no message")
            if n < 0:
                raise ValueError(f"channel {self.path}: read error {n}")
            # one copy out of the slot (the slot is recycled after commit,
            # so the caller must not alias it)
            data = ctypes.string_at(ptr.value, int(n)) if n else b""
            lib.rt_chan_read_commit(handle)
            return data
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        self._await(
            lambda: self._u64(0) > self._last_read, self._dbell, deadline,
            "no message",
        )
        off = self._slot_off(self._last_read)
        length = int.from_bytes(self._mm[off: off + 8], "little")
        data = bytes(self._mm[off + 8: off + 8 + length])
        self._last_read += 1
        self._mm[8:16] = self._last_read.to_bytes(8, "little")  # ack
        self._ring(self._abell)
        return data

    def read_value(self, timeout_s: Optional[float] = 30.0) -> Any:
        return serialization.unpack(self.read(timeout_s))

    def close(self, unlink: bool = False) -> None:
        """Idempotent: fds are nulled after the first close so a second
        call can never close an unrelated fd that reused the number."""
        if self._native is not None:
            lib, handle = self._native
            self._native = None
            lib.rt_chan_close(handle)
        elif hasattr(self, "_mm"):
            try:
                self._mm.close()
            except (BufferError, ValueError):
                pass
            for fd in (self._dbell, self._abell):
                if fd >= 0:
                    try:
                        os.close(fd)
                    except OSError:
                        pass
            self._dbell = self._abell = -1
        if unlink:
            unlink_channel(self.path)


def unlink_channel(path: str) -> None:
    """Remove a channel's shm segment and doorbell fifos (idempotent)."""
    for p in (path, path + ".d", path + ".a"):
        try:
            os.unlink(p)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Cross-host tier: RpcChannel (bounded mailbox over worker<->worker RPC)
# ---------------------------------------------------------------------------


class _RpcMailbox:
    """Receiver-side bounded queue for one RpcChannel."""

    __slots__ = ("q", "enq_seq", "consumed", "slots", "cv", "closed")

    def __init__(self, slots: int):
        self.q: deque = deque()
        self.enq_seq = 0  # highest seq accepted (writer seqs start at 1)
        self.consumed = 0
        self.slots = slots
        self.cv = threading.Condition()
        self.closed = False


_rpc_mailboxes: Dict[str, _RpcMailbox] = {}
_rpc_mailboxes_lock = threading.Lock()
# closed-channel tombstones: a writer retry racing close_rpc_mailbox
# must get a "closed" bounce, not a silently-recreated open mailbox
# that swallows its message. Trimmed FIFO so a long-lived process
# cannot grow unbounded (chan ids are one-shot uuids).
_rpc_closed: set = set()
_rpc_closed_order: deque = deque()
_RPC_CLOSED_CAP = 4096


def _mailbox(chan_id: str, slots: int) -> Optional[_RpcMailbox]:
    """Get-or-create: a writer's first push may land before the reader
    attaches (compiled-pipeline stage loops start in any order), so the
    mailbox materializes on first contact from either side. Returns
    None for a tombstoned (closed) channel."""
    with _rpc_mailboxes_lock:
        if chan_id in _rpc_closed:
            return None
        mb = _rpc_mailboxes.get(chan_id)
        if mb is None:
            mb = _RpcMailbox(slots)
            _rpc_mailboxes[chan_id] = mb
        return mb


def rpc_channel_deliver(chan_id: str, seq: int, payload,
                        slots: int) -> Dict[str, Any]:
    """The worker's ``rpc_chan_push`` lands here. Idempotent per seq
    (a writer retry after a lost ack re-sends the same seq); a full
    mailbox bounces with ``full`` and the writer retries — that bounce
    IS the cross-host backpressure."""
    mb = _mailbox(chan_id, slots)
    if mb is None:
        return {"status": "closed"}
    with mb.cv:
        if mb.closed:
            return {"status": "closed"}
        if seq <= mb.enq_seq:
            return {"status": "ok"}  # duplicate from a writer retry
        if len(mb.q) >= mb.slots:
            return {"status": "full"}
        mb.q.append(payload)
        mb.enq_seq = seq
        mb.cv.notify_all()
        return {"status": "ok"}


def close_rpc_mailbox(chan_id: str) -> None:
    with _rpc_mailboxes_lock:
        mb = _rpc_mailboxes.pop(chan_id, None)
        if chan_id not in _rpc_closed:
            _rpc_closed.add(chan_id)
            _rpc_closed_order.append(chan_id)
            while len(_rpc_closed_order) > _RPC_CLOSED_CAP:
                _rpc_closed.discard(_rpc_closed_order.popleft())
    if mb is not None:
        with mb.cv:
            mb.closed = True
            mb.cv.notify_all()


def rpc_channel_handle(reader_addr: str, capacity: int,
                       slots: int) -> Dict[str, Any]:
    """Mint a cross-host channel handle: the reader's worker RPC address
    plus geometry. No resource exists until the reader attaches or the
    writer's first push materializes the mailbox."""
    return {
        "kind": "rpc",
        "chan_id": f"rtchan_{uuid.uuid4().hex[:16]}",
        "addr": reader_addr,
        "capacity": capacity,
        "slots": slots,
    }


class RpcChannel:
    """Cross-host channel: same surface as ShmChannel, one ``chan_push``
    worker↔worker RPC per message. Payloads ≥ the multiseg floor ride
    as raw out-of-band segments via ``serialization.maybe_frame`` —
    the pipeline's stage-boundary activations never re-pickle in-band.
    Single writer, single reader; the reader must live in the process
    whose worker address is in the handle."""

    def __init__(self, handle: Dict[str, Any], role: str):
        if role not in ("read", "write"):
            raise ValueError(f"RpcChannel role must be read/write, not {role}")
        self._h = dict(handle)
        self.chan_id = handle["chan_id"]
        self.capacity = handle["capacity"]
        self.slots = handle["slots"]
        self.addr = handle["addr"]
        self.role = role
        self._seq = 0
        self._mb = None
        if role == "read":
            self._mb = _mailbox(self.chan_id, self.slots)
            if self._mb is None:
                raise ValueError(
                    f"channel {self.chan_id}: already closed (chan ids "
                    f"are one-shot)"
                )
        self._client = None

    # the handle mints attachments for either side
    def handle(self) -> Dict[str, Any]:
        return dict(self._h)

    def _rpc(self):
        if self._client is None:
            from ray_tpu_torch.core import worker as worker_mod

            self._client = worker_mod.global_worker().workers.get(self.addr)
        return self._client

    # -- writer --------------------------------------------------------

    def write(self, payload, timeout_s: Optional[float] = 60.0) -> None:
        view = serialization.as_view(payload)
        if view.nbytes > self.capacity:
            raise ValueError(
                f"payload {view.nbytes} > channel capacity {self.capacity}"
            )
        deadline = (
            None if timeout_s is None else time.monotonic() + timeout_s
        )
        self._seq += 1
        wrapped = serialization.maybe_frame(
            payload if isinstance(payload, (bytes, bytearray)) else bytes(view)
        )
        backoff = 0.002
        while True:
            remaining = 30.0
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"channel {self.chan_id}: mailbox full — reader "
                        f"never consumed (slots={self.slots})"
                    )
            resp = self._rpc().call(
                "chan_push", chan_id=self.chan_id, seq=self._seq,
                payload=wrapped, slots=self.slots,
                timeout_s=max(1.0, min(remaining, 30.0)), retryable=False,
            )
            status = resp["status"]
            if status == "ok":
                return
            if status == "closed":
                raise ValueError(
                    f"channel {self.chan_id}: closed by the reader"
                )
            # full: bounded-mailbox backpressure. Back off exponentially
            # so a long consumer stall costs ~20 polls/s, not a 500/s
            # RPC storm against the receiver's dispatcher pool.
            if core_metrics.ENABLED:
                core_metrics.channel_write_blocks.inc(
                    tags={"transport": "rpc"}
                )
            time.sleep(backoff)
            backoff = min(backoff * 2, 0.05)

    def write_views(self, parts: List[Any],
                    timeout_s: Optional[float] = 60.0) -> None:
        # cross-host: one contiguous frame per message (the join is the
        # price of the RPC tier; the frame itself still rides out-of-band)
        self.write(b"".join(serialization.byte_views(parts)), timeout_s)

    def write_value(self, value: Any,
                    timeout_s: Optional[float] = 60.0) -> None:
        meta, views = serialization.serialize(value)
        self.write_views(serialization.frame_parts(meta, views), timeout_s)

    # -- reader --------------------------------------------------------

    def read(self, timeout_s: Optional[float] = 30.0):
        """Returns bytes or a Frame (big payloads arrive out-of-band);
        ``serialization.unpack``/``as_view`` accept both."""
        mb = self._mb
        if mb is None:
            raise RuntimeError("write-side RpcChannel cannot read")
        deadline = (
            None if timeout_s is None else time.monotonic() + timeout_s
        )
        with mb.cv:
            while not mb.q:
                if mb.closed:
                    raise ValueError(
                        f"channel {self.chan_id}: closed"
                    )
                remaining = 1.0
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"channel {self.chan_id}: no message"
                        )
                mb.cv.wait(min(remaining, 1.0))
            payload = mb.q.popleft()
            mb.consumed += 1
        return payload

    def read_value(self, timeout_s: Optional[float] = 30.0) -> Any:
        return serialization.unpack(self.read(timeout_s))

    def close(self, unlink: bool = False) -> None:
        if self.role == "read":
            close_rpc_mailbox(self.chan_id)


def open_channel(handle: Dict[str, Any], role: str = "read"):
    """Attach to a channel from its handle — shm (same-host) or rpc
    (cross-host); compiled loops don't care which tier an edge rides."""
    if handle.get("kind") == "rpc":
        return RpcChannel(handle, role)
    return ShmChannel.from_handle(handle)

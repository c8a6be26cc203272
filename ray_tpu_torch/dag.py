"""Compiled graphs: static actor DAGs over pre-allocated shm channels.

Parity: Ray Compiled Graphs (aDAG) — reference
python/ray/dag/compiled_dag_node.py:805 (``experimental_compile``),
``execute`` :2546, DAG nodes python/ray/dag/dag_node.py, channels
python/ray/experimental/channel/shared_memory_channel.py.

The per-call RPC path (submit → lease → push → reply) costs ~ms; a
static inference/pipeline loop re-running the same actor methods can
amortize all of it away. Compiling a DAG:

- allocates one :class:`ray_tpu_torch.core.channels.ShmChannel` per
  cross-process edge (driver→actor, actor→actor, actor→driver) — a
  mutable shm RING of ``channel_slots`` message slots reused every call
  (one mmap, then one scatter-gather copy + seqlock flip per message),
  so exec loops stream up to ``channel_slots`` rounds ahead of their
  consumers;
- parks a persistent exec loop on every participating actor (a system
  actor task, ``__rt_dag_exec_loop__``): each round it reads its input
  channels, runs its bound methods in topological order, and writes
  results downstream — no scheduler, no lease, no RPC framing on the
  hot path;
- ``dag.execute(x)`` = write the input channel(s), read the output
  channel(s): µs-scale per call (bench_core.py measures the ratio vs
  ``actor.f.remote()`` + ``get``).

Same-host only (shm channels), like the reference's default channel
tier; the compiled loop occupies one executor slot on each actor until
``teardown()``. Usage:

    with InputNode() as inp:
        dag = b.g.bind(a.f.bind(inp))
    cdag = dag.experimental_compile()
    out = cdag.execute(5).get()
    cdag.teardown()
"""

from __future__ import annotations

import itertools
import logging
import threading
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.channels import ShmChannel
from ray_tpu_torch.utils import serialization

logger = logging.getLogger(__name__)

_STOP = b"__rt_dag_stop__"
_node_counter = itertools.count()


def _is_stop(frame) -> bool:
    """A raw channel frame is the teardown sentinel (RpcChannel reads
    can surface Frame-wrapped payloads; the sentinel is tiny and always
    arrives as plain bytes)."""
    return isinstance(frame, (bytes, bytearray)) and frame == _STOP


def send_value(channels, value: Any,
               timeout_s: Optional[float] = 60.0) -> None:
    """Serialize once, scatter-gather the frame into every channel —
    pickle-5 out-of-band buffers are copied straight into each shm slot
    (or ride as multiseg segments on an RpcChannel), never joined into
    an intermediate in-band blob."""
    meta, views = serialization.serialize(value)
    parts = serialization.frame_parts(meta, views)
    for ch in channels:
        ch.write_views(parts, timeout_s=timeout_s)


class DAGNode:
    def __init__(self):
        self._id = next(_node_counter)

    def experimental_compile(
        self,
        channel_capacity: int = 4 * 1024 * 1024,
        max_inflight: int = 2,
        channel_slots: Optional[int] = None,
    ) -> "CompiledDAG":
        """Compile the static graph: allocate channels, park exec loops.

        Backpressure contract: at most ``max_inflight`` ``execute()``
        rounds may be unconsumed (``get()`` not yet called) — the next
        ``execute()`` past that raises instead of blocking (parity:
        ``RayCgraphCapacityExceeded``). Every channel is a ring of
        ``channel_slots`` message slots (default: ``max_inflight``), so
        exec loops stream that many rounds ahead before a write blocks
        on its consumer; with the default sizing the driver-side
        ``max_inflight`` check always trips BEFORE an input ring can
        fill, so ``execute()`` never blocks inside its lock. Passing
        ``channel_slots < max_inflight`` is allowed but re-introduces
        writer-side blocking once the smaller ring fills. Each slot
        holds one message of up to ``channel_capacity`` bytes.
        """
        return CompiledDAG(self, channel_capacity, max_inflight,
                           channel_slots)


class InputNode(DAGNode):
    """The driver-supplied input (one per DAG)."""

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        return None


class ClassMethodNode(DAGNode):
    """``actor.method.bind(*args)`` — one actor method invocation in the
    static graph. Args may be DAGNodes or plain (constant) values."""

    def __init__(self, actor_handle, method_name: str, args: Tuple[Any, ...]):
        super().__init__()
        self.actor = actor_handle
        self.method_name = method_name
        self.args = args


class MultiOutputNode(DAGNode):
    """Terminal node returning several leaves as a list."""

    def __init__(self, nodes: List[DAGNode]):
        super().__init__()
        self.nodes = list(nodes)


def _topo_collect(root: DAGNode) -> List[DAGNode]:
    """Topological order of the DAG reachable from ``root``."""
    order: List[DAGNode] = []
    seen: Dict[int, bool] = {}

    def visit(n: DAGNode):
        if n._id in seen:
            return
        seen[n._id] = True
        if isinstance(n, ClassMethodNode):
            for a in n.args:
                if isinstance(a, DAGNode):
                    visit(a)
        elif isinstance(n, MultiOutputNode):
            for c in n.nodes:
                visit(c)
        order.append(n)

    visit(root)
    return order


class CompiledDAGRef:
    """Result handle for one ``execute`` round (FIFO: rounds must be
    consumed in submission order — each output channel holds one
    in-flight message, which is also the backpressure bound)."""

    def __init__(self, cdag: "CompiledDAG", seq: int):
        self._cdag = cdag
        self._seq = seq
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._done = False

    def get(self, timeout_s: Optional[float] = 60.0) -> Any:
        if not self._done:
            try:
                self._value = self._cdag._read_output(self._seq, timeout_s)
            except Exception as e:  # noqa: BLE001 — cache for re-gets
                self._error = e
                raise
            finally:
                self._done = True
        if self._error is not None:
            raise self._error
        return self._value


class CompiledDAG:
    """The compiled form: channels allocated, exec loops parked."""

    def __init__(self, root: DAGNode, channel_capacity: int,
                 max_inflight: int = 2,
                 channel_slots: Optional[int] = None):
        from ray_tpu_torch.core import worker as worker_mod

        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if channel_slots is None:
            channel_slots = max_inflight
        if channel_slots < 1:
            raise ValueError(
                f"channel_slots must be >= 1, got {channel_slots}"
            )
        self._w = worker_mod.global_worker()
        self._capacity = channel_capacity
        self._slots = channel_slots
        self._lock = threading.Lock()
        self._exec_seq = 0
        self._read_seq = 0
        # FIFO backpressure bound: each channel rings channel_slots
        # messages, so unconsumed rounds beyond max_inflight would block
        # execute() inside the lock once the ring fills (reference raises
        # RayCgraphCapacityExceeded for the same reason) — surface a
        # clear error instead.
        self._max_inflight = max_inflight
        self._torn_down = False
        self._broken = False

        nodes = _topo_collect(root)
        inputs = [n for n in nodes if isinstance(n, InputNode)]
        if len(inputs) > 1:
            raise ValueError("a DAG takes exactly one InputNode")
        self._input = inputs[0] if inputs else None
        if isinstance(root, MultiOutputNode):
            self._outputs = root.nodes
            self._multi = True
        else:
            self._outputs = [root]
            self._multi = False
        for out in self._outputs:
            if not isinstance(out, ClassMethodNode):
                raise ValueError("DAG outputs must be actor method nodes")
        self._method_nodes = [n for n in nodes if isinstance(n, ClassMethodNode)]
        if not self._method_nodes:
            raise ValueError("DAG has no actor method calls")

        # group nodes by actor, preserving topological order
        self._actors: Dict[str, Any] = {}
        per_actor: Dict[str, List[ClassMethodNode]] = {}
        for n in self._method_nodes:
            aid = n.actor._actor_id
            self._actors[aid] = n.actor
            per_actor.setdefault(aid, []).append(n)

        node_actor = {n._id: n.actor._actor_id for n in self._method_nodes}

        # channels: one per (producer node or input) × consuming actor,
        # plus one per output node back to the driver
        self._input_channels: List[ShmChannel] = []   # driver writes
        self._output_channels: List[ShmChannel] = []  # driver reads
        plans: Dict[str, Dict[str, Any]] = {
            aid: {"in": {}, "steps": [], "out": {}} for aid in per_actor
        }
        chan_for: Dict[Tuple[int, str], ShmChannel] = {}

        def edge_channel(producer_id: int, consumer_aid: str) -> ShmChannel:
            """One channel per (producer, consumer-actor) EDGE — a node
            consumed twice by the same actor shares the channel (the
            consumer's per-round cache reads it once), and the producer
            registers exactly one out-handle for it."""
            key = (producer_id, consumer_aid)
            ch = chan_for.get(key)
            if ch is None:
                ch = ShmChannel.create(self._capacity, slots=self._slots)
                chan_for[key] = ch
                plans[consumer_aid]["in"][producer_id] = ch.handle()
                if producer_id == -1:
                    self._input_channels.append(ch)
                elif producer_id >= 0:
                    plans[node_actor[producer_id]]["out"].setdefault(
                        str(producer_id), []
                    ).append(ch.handle())
            return ch

        for n in self._method_nodes:
            aid = node_actor[n._id]
            arg_specs: List[Tuple[str, Any]] = []
            for a in n.args:
                if isinstance(a, InputNode):
                    edge_channel(-1, aid)
                    arg_specs.append(("chan", -1))
                elif isinstance(a, ClassMethodNode):
                    if node_actor[a._id] == aid:
                        arg_specs.append(("local", a._id))
                    else:
                        edge_channel(a._id, aid)
                        arg_specs.append(("chan", a._id))
                elif isinstance(a, DAGNode):
                    raise ValueError(f"unsupported DAG node arg {type(a)}")
                else:
                    arg_specs.append(("const", a))
            plans[aid]["steps"].append({
                "node_id": n._id,
                "method": n.method_name,
                "args": arg_specs,
            })

        for out in self._outputs:
            ch = ShmChannel.create(self._capacity, slots=self._slots)
            self._output_channels.append(ch)
            plans[node_actor[out._id]]["out"].setdefault(
                str(out._id), []
            ).append(ch.handle())

        # the driver owns EVERY channel's shm lifetime (actor→actor edges
        # included): teardown unlinks them all, so a wedged exec loop
        # cannot strand /dev/shm/rtchan_* debris for sweep_stale_runtime
        self._edge_channels = [
            ch for (pid, _), ch in chan_for.items() if pid >= 0
        ]

        # park the exec loops (their replies arrive at teardown)
        self._loop_refs = []
        for aid, plan in plans.items():
            refs = self._w.submit_actor_task(
                aid, "__rt_dag_exec_loop__",
                (serialization.pack(plan),), {}, num_returns=1,
            )
            self._loop_refs.extend(refs)

    # -- driver-side hot path ------------------------------------------

    def execute(self, *args) -> CompiledDAGRef:
        with self._lock:
            if self._torn_down:
                raise RuntimeError("compiled DAG was torn down")
            if self._broken:
                raise RuntimeError(
                    "compiled DAG stream desynced (an earlier round failed "
                    "mid-write); teardown and recompile"
                )
            if self._exec_seq - self._read_seq >= self._max_inflight:
                raise RuntimeError(
                    f"compiled DAG has {self._exec_seq - self._read_seq} "
                    f"unconsumed executions (max_inflight="
                    f"{self._max_inflight}); get() earlier results first"
                )
            if self._input is not None:
                meta, views = serialization.serialize(
                    args[0] if len(args) == 1 else args
                )
                parts = serialization.frame_parts(meta, views)
                for i, ch in enumerate(self._input_channels):
                    try:
                        ch.write_views(parts)
                    except Exception:
                        if i > 0:
                            # earlier channels already hold this round's
                            # payload: actors would pair inputs across
                            # rounds — poison the DAG so later calls fail
                            # loudly instead of silently desyncing
                            self._broken = True
                        raise
            self._exec_seq += 1
            return CompiledDAGRef(self, self._exec_seq)

    def _read_output(self, seq: int, timeout_s: Optional[float]) -> Any:
        with self._lock:
            if self._broken:
                raise RuntimeError(
                    "compiled DAG stream desynced (an earlier read timed "
                    "out mid-round); teardown and recompile"
                )
            if seq != self._read_seq + 1:
                raise RuntimeError(
                    "compiled DAG results must be consumed in order "
                    f"(expected round {self._read_seq + 1}, got {seq})"
                )
            outs = []
            for i, ch in enumerate(self._output_channels):
                try:
                    frame = ch.read(timeout_s)
                except TimeoutError:
                    if i > 0:
                        # earlier channels of this round were consumed:
                        # leaves would pair across rounds — poison the DAG
                        self._broken = True
                    raise
                if _is_stop(frame):
                    raise RuntimeError("compiled DAG torn down mid-read")
                outs.append(serialization.unpack(frame))
            self._read_seq = seq
        for o in outs:
            if isinstance(o, Exception):
                raise o
        return outs if self._multi else outs[0]

    def teardown(self, timeout_s: float = 60.0) -> None:
        import time as _time

        with self._lock:
            if self._torn_down:
                return
            self._torn_down = True
        # Exec loops may be BLOCKED writing an output the driver never
        # consumed (execute() without get()): keep draining the
        # driver-facing output channels while the _STOP propagates, so
        # every blocked writer unwedges and reaches its input read.
        from ray_tpu_torch.core import api

        pending = list(self._loop_refs)
        stop_sent = [False] * len(self._input_channels)
        deadline = _time.monotonic() + timeout_s
        while pending and _time.monotonic() < deadline:
            for i, ch in enumerate(self._input_channels):
                if not stop_sent[i]:
                    try:
                        ch.write(_STOP, timeout_s=0.2)
                        stop_sent[i] = True
                    except (TimeoutError, ValueError):
                        pass  # input slot still full: drain + retry
            for ch in self._output_channels:
                try:
                    ch.read(timeout_s=0.05)
                except Exception:  # noqa: BLE001 — empty/closed: fine
                    pass
            try:
                _, pending = api.wait(
                    pending, num_returns=len(pending), timeout=0.3
                )
            except Exception:  # noqa: BLE001 — actor may already be dead
                pending = []
                break
        if pending:
            # a wedged exec loop (stage blocked in user code, actor
            # half-dead) outlived the drain deadline: say so loudly —
            # the channels are unlinked below regardless, so no
            # /dev/shm/rtchan_* debris survives for sweep_stale_runtime,
            # but the actor's executor slot stays occupied until the
            # loop dies with its process.
            logger.warning(
                "compiled DAG teardown: %d exec loop(s) still running "
                "after the %.0fs drain deadline; unlinking all %d "
                "channel(s) anyway (wedged loops keep their actors' "
                "executor slots until the actor dies)",
                len(pending), timeout_s,
                len(self._input_channels) + len(self._output_channels)
                + len(self._edge_channels),
            )
        for ch in (self._input_channels + self._output_channels
                   + self._edge_channels):
            ch.close(unlink=True)


def _actor_exec_loop(instance, plan_blob: bytes) -> int:
    """The per-actor compiled loop (runs as a system actor task and
    occupies one executor slot until teardown). Reads input channels
    lazily per step (cached per round), executes bound methods in topo
    order, pushes results downstream. Returns the round count."""
    plan = serialization.unpack(plan_blob)
    in_ch = {
        pid: ShmChannel.from_handle(h) for pid, h in plan["in"].items()
    }
    out_ch = {
        nid: [ShmChannel.from_handle(h) for h in handles]
        for nid, handles in plan["out"].items()
    }
    rounds = 0
    stopping = False
    while not stopping:
        cache: Dict[int, Any] = {}
        produced: Dict[int, Any] = {}

        def read_chan(pid: int):
            nonlocal stopping
            if pid in cache:
                return cache[pid]
            frame = in_ch[pid].read(timeout_s=None)
            if _is_stop(frame):
                stopping = True
                return None
            value = serialization.unpack(frame)
            cache[pid] = value
            return value

        for step in plan["steps"]:
            argv = []
            failed: Optional[Exception] = None
            for kind, ref in step["args"]:
                if kind == "const":
                    argv.append(ref)
                    continue
                if kind == "local":
                    value = produced[ref]
                else:
                    value = read_chan(ref)
                    if stopping:
                        break
                if isinstance(value, Exception):
                    failed = value  # propagate upstream errors downstream
                argv.append(value)
            if stopping:
                break
            if failed is not None:
                result: Any = failed
            else:
                try:
                    result = getattr(instance, step["method"])(*argv)
                except Exception as e:  # noqa: BLE001 — ship to consumer
                    result = e
            produced[step["node_id"]] = result
            send_value(out_ch.get(str(step["node_id"]), ()), result,
                       timeout_s=None)
        rounds += 1
    for ch in list(in_ch.values()):
        ch.close()
    # propagate the stop downstream so every loop unblocks
    for chans in out_ch.values():
        for ch in chans:
            try:
                ch.write(_STOP, timeout_s=1.0)
            except (TimeoutError, ValueError):
                pass
            ch.close()
    return rounds

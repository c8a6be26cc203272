"""Pipeline parallelism — stage-per-actor microbatching, RPC or compiled.

Two execution tiers over the same :class:`PipelineStage` actors:

**RPC tier** (:class:`Pipeline`, the original): the driver submits the
microbatch forward chain and the reverse backward chain as ordered actor
calls; per-actor FIFO queues yield the GPipe overlap, activations flow
as ObjectRefs through the shm object plane. Every microbatch hop pays
the full submit→lease→push→reply RPC path (~1 ms class).

**Compiled tier** (:class:`CompiledPipeline`, via ``Pipeline.compile``):
the stage graph is compiled ONCE — a persistent exec loop parks on each
stage actor (``__rt_pipe_exec_loop__``, like dag.py's compiled-graph
loops) and all microbatch traffic rides native seqlock ring channels
(ray_tpu_torch.core.channels.ShmChannel): one memcpy + atomic flip per
message, no scheduler, no lease, no RPC framing. Cross-host stage
boundaries ride :class:`~ray_tpu_torch.core.channels.RpcChannel` instead —
one worker↔worker RPC per activation, ≥32 KiB payloads as raw
out-of-band multiseg segments. This is the workload compiled graphs
exist for (parity: python/ray/dag/compiled_dag_node.py:805 driving PP
microbatch loops; "Exploring the limits of Concurrency in ML Training
on Google TPUs", arxiv 2011.03641 — remove per-step host scheduling,
overlap transfer with compute).

Schedules (compiled tier):

- ``"gpipe"``: every stage runs all n forwards, then all n backwards.
  Peak saved activations per stage: O(n_microbatches).
- ``"1f1b"``: stage i runs ``min(n, S-1-i)`` warmup forwards, then
  alternates one-forward-one-backward to the steady state, then drains
  the remaining backwards. Peak saved activations per stage:
  O(min(n, S - i)) — the classic PipeDream-flush/1F1B memory win.
  Backwards run in the same microbatch order as GPipe at every stage,
  so accumulated gradients are BIT-IDENTICAL between the two schedules
  (pinned by tests).

Training semantics: forward keeps each microbatch's autograd graph;
backward runs ``torch.autograd.grad`` on it and sums the parameter
grads into an accumulator in arrival order; apply() runs the
optimizer on the accumulated (averaged) grads and clears them.
Gradients are mathematically identical to the unpipelined model, which
the tests assert. Activations and gradients cross between stages as
host arrays (:class:`HostTensor`), copied off one card and onto the
next.
"""

from __future__ import annotations

import logging
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.observability import core_metrics, tracing
from ray_tpu_torch.utils import serialization
from ray_tpu_torch.utils.config import config

logger = logging.getLogger(__name__)


# >>> ported: the wire format between stages, and PipelineStage on torch autograd
class HostTensor:
    """A tensor between stages: a host numpy array and the name of the
    torch dtype it holds. numpy has no bfloat16, so a bf16 tensor travels
    as its uint16 bits. Pickled as (array, dtype), so that under pickle-5
    the array's buffer goes out of band, straight into a channel slot or
    an object-store segment: never an in-band pickle of a torch storage."""

    __slots__ = ("array", "dtype")

    def __init__(self, array: np.ndarray, dtype: str):
        self.array = array
        self.dtype = dtype

    def __reduce__(self):
        return HostTensor, (self.array, self.dtype)

    @classmethod
    def of(cls, t: torch.Tensor) -> "HostTensor":
        """``t`` copied off its device, once."""
        t = t.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return cls(t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16")
        return cls(t.cpu().numpy(), str(t.dtype).removeprefix("torch."))

    def to(self, device) -> torch.Tensor:
        """A new tensor on ``device``: one copy, onto the card."""
        if self.dtype == "bfloat16":
            return _from_numpy(self.array.view(np.int16)).view(torch.bfloat16).to(
                device, copy=True)
        return _from_numpy(self.array).to(device, copy=True)

    def __array__(self, dtype=None, copy=None):
        """The values as numpy (bfloat16 widened to float32)."""
        arr = self.to("cpu").float().numpy() if self.dtype == "bfloat16" else self.array
        return arr if dtype is None else arr.astype(dtype)


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    # A buffer unpickled out of band is read-only; every caller copies the
    # tensor before anything could write to it.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


def _on(device: torch.device, x):
    """A stage's input on its device: a HostTensor or a numpy array (the
    first stage's tokens, the last stage's targets) copied on; anything
    else as it is."""
    if isinstance(x, HostTensor):
        return x.to(device)
    if isinstance(x, np.ndarray):
        return _from_numpy(np.ascontiguousarray(x)).to(device, copy=True)
    return x


def _off(y):
    """A stage's output for the wire: a tensor as a HostTensor."""
    return HostTensor.of(y) if isinstance(y, torch.Tensor) else y


@ray_tpu_torch.remote
class PipelineStage:
    """One pipeline stage: params + fn(params, x) -> y, on ``device``.

    ``params`` is a dict of arrays. The stage holds them on ``device``
    (None: ``cuda``) as leaf tensors, the floating ones requiring grad, and
    ``fn`` takes that dict (a stage built on ``nn.Module``s calls
    ``torch.func.functional_call`` with it). ``optimizer`` is a factory
    applied once to the parameter list, such as
    ``functools.partial(torch.optim.AdamW, lr=...)``; like optax's update
    it ignores ``apply``'s lr. Without one, ``apply`` takes an SGD step."""

    def __init__(self, stage_fn_blob: bytes, params: Dict[str, Any],
                 loss_fn_blob: Optional[bytes] = None,
                 optimizer_blob: Optional[bytes] = None,
                 device: Optional[str] = None):
        from ray_tpu_torch.device import resolve_device

        self._device = resolve_device(device)
        self._fn = serialization.loads(stage_fn_blob)
        self._loss_fn = (
            serialization.loads(loss_fn_blob) if loss_fn_blob else None
        )
        self.params: Dict[str, torch.Tensor] = {}
        for name, value in params.items():
            t = torch.tensor(np.asarray(value), device=self._device)
            self.params[name] = t.requires_grad_(t.is_floating_point())
        self._trained = [n for n, p in self.params.items() if p.requires_grad]
        self._opt = (
            serialization.loads(optimizer_blob)(
                [self.params[n] for n in self._trained])
            if optimizer_blob else None
        )
        # mb_id -> (the input as the graph saw it, the output): the
        # microbatch's autograd graph, kept from forward to backward
        self._graphs: Dict[int, Tuple[Any, torch.Tensor]] = {}
        self._grad_acc: Optional[Dict[str, torch.Tensor]] = None
        self._n_acc = 0

    def _input(self, x):
        x = _on(self._device, x)
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            x.requires_grad_()  # a fresh copy: a leaf of this graph
        return x

    def forward(self, mb_id: int, x):
        x = self._input(x)
        with torch.enable_grad():
            y = self._fn(self.params, x)
        self._graphs[mb_id] = (x, y)
        return _off(y)

    def forward_loss(self, mb_id: int, x, target):
        """Last stage: fn then loss; keeps the graph of both."""
        x = self._input(x)
        with torch.enable_grad():
            loss = self._loss_fn(self._fn(self.params, x),
                                 _on(self._device, target))
        self._graphs[mb_id] = (x, loss)
        return float(loss)

    def backward(self, mb_id: int, gy):
        x, y = self._graphs.pop(mb_id)
        return self._backprop(x, y, _on(self._device, gy))

    def backward_from_loss(self, mb_id: int, scale: float = 1.0):
        x, loss = self._graphs.pop(mb_id)
        return self._backprop(x, loss, torch.full_like(loss, scale))

    def _backprop(self, x, y: torch.Tensor, gy: torch.Tensor):
        """Sums the parameters' grads into the accumulator and returns the
        input's grad for the wire: None for an input that takes none (the
        first stage's integer tokens), so that stage ships nothing back."""
        wrt = [self.params[n] for n in self._trained]
        takes_grad = isinstance(x, torch.Tensor) and x.requires_grad
        if takes_grad:
            wrt.append(x)
        grads = torch.autograd.grad(y, wrt, grad_outputs=gy, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g for w, g in zip(wrt, grads)]
        self._accumulate(dict(zip(self._trained, grads)))
        return HostTensor.of(grads[-1]) if takes_grad else None

    def _accumulate(self, gp: Dict[str, torch.Tensor]):
        # the first assigned, the rest added in arrival order: GPipe and
        # 1F1B run backwards in the same order, so their sums are bitwise
        # equal
        if self._grad_acc is None:
            self._grad_acc = gp
        else:
            self._grad_acc = {
                n: a + gp[n] for n, a in self._grad_acc.items()
            }
        self._n_acc += 1

    def apply(self, lr: float = 1e-2):
        """Optimizer step on the accumulated (averaged) microbatch grads."""
        if self._grad_acc is None:
            return False
        grads = {n: g / self._n_acc for n, g in self._grad_acc.items()}
        with torch.no_grad():
            if self._opt is not None:
                for n, g in grads.items():
                    self.params[n].grad = g
                self._opt.step()
                for n in grads:
                    self.params[n].grad = None
            else:
                for n, g in grads.items():
                    self.params[n].sub_(lr * g)
        self._grad_acc = None
        self._n_acc = 0
        return True

    def predict(self, x):
        """Forward without keeping a graph (inference path)."""
        with torch.no_grad():
            return _off(self._fn(self.params, _on(self._device, x)))

    def get_params(self):
        """The parameters as host numpy arrays, by name."""
        return {n: p.detach().cpu().numpy() for n, p in self.params.items()}

    def reset_step(self):
        """Drop kept graphs and partial grad accumulation (a failed
        compiled step leaves the stage mid-flight; the next step must
        start clean)."""
        self._graphs.clear()
        self._grad_acc = None
        self._n_acc = 0
        return True

    # <<< ported

    def transport_info(self):
        """Where this stage's process lives — the compiled tier places
        ShmChannel on same-node stage edges and RpcChannel on
        cross-node ones."""
        from ray_tpu_torch.core import worker as worker_mod

        w = worker_mod.global_worker()
        return {"node_id": w.node_id_hex, "address": w.address}

    def pid(self):
        """This stage's worker process id (chaos tests SIGKILL it)."""
        import os

        return os.getpid()


class Pipeline:
    """Driver-side GPipe coordinator over PipelineStage actors."""

    def __init__(
        self,
        stage_fns: Sequence[Callable],
        stage_params: Sequence[Any],
        loss_fn: Callable,
        optimizer=None,
        resources: Optional[Sequence[Dict[str, float]]] = None,
        device: Optional[str] = None,
    ):
        if len(stage_fns) != len(stage_params):
            raise ValueError("one params pytree per stage fn")
        n = len(stage_fns)
        opt_blob = serialization.dumps_function(optimizer) if optimizer else None
        self.stages: List[Any] = []
        for i, (fn, params) in enumerate(zip(stage_fns, stage_params)):
            opts = dict(resources[i]) if resources else {}
            self.stages.append(
                PipelineStage.options(**opts).remote(
                    serialization.dumps_function(fn),
                    params,
                    serialization.dumps_function(loss_fn)
                    if i == n - 1 else None,
                    opt_blob,
                    device,
                )
            )

    def train_step(
        self, microbatches: Sequence[Any], targets: Sequence[Any],
        lr: float = 1e-2,
    ) -> float:
        """One GPipe step: all microbatch forwards chained through the
        stages, then the reverse backward chains, then apply. Returns the
        mean microbatch loss."""
        if len(microbatches) != len(targets):
            raise ValueError("need one target per microbatch")
        last = self.stages[-1]
        loss_refs = []
        for i, (mb, tgt) in enumerate(zip(microbatches, targets)):
            h = mb
            for s in self.stages[:-1]:
                h = s.forward.remote(i, h)
            loss_refs.append(last.forward_loss.remote(i, h, tgt))
        grad_tails = []
        for i in range(len(microbatches)):
            g = last.backward_from_loss.remote(i)
            for s in reversed(self.stages[:-1]):
                g = s.backward.remote(i, g)
            grad_tails.append(g)
        losses = ray_tpu_torch.get(loss_refs)
        ray_tpu_torch.get(grad_tails)  # ensure all grads accumulated
        ray_tpu_torch.get([s.apply.remote(lr) for s in self.stages])
        return sum(losses) / len(losses)

    def forward(self, x) -> Any:
        """Inference through the pipeline (single batch, no VJPs saved)."""
        h = x
        for s in self.stages:
            h = s.predict.remote(h)
        return ray_tpu_torch.get(h)

    def get_params(self) -> List[Any]:
        return ray_tpu_torch.get([s.get_params.remote() for s in self.stages])

    def compile(self, **kwargs) -> "CompiledPipeline":
        """Compile the stage graph once: park exec loops, stream every
        microbatch over seqlock channels. See :class:`CompiledPipeline`."""
        return CompiledPipeline(self, **kwargs)

    def shutdown(self) -> None:
        for s in self.stages:
            try:
                ray_tpu_torch.kill(s)
            except Exception:  # noqa: BLE001
                pass


# ---------------------------------------------------------------------------
# Compiled tier: stage loops + seqlock channels (GPipe and 1F1B)
# ---------------------------------------------------------------------------

SCHEDULES = ("gpipe", "1f1b")


def _schedule_ops(schedule: str, n_stages: int, stage: int,
                  n_mb: int) -> List[Tuple[str, int]]:
    """The static per-stage op list for one training step.

    GPipe: all forwards, then all backwards. 1F1B: ``min(n_mb,
    n_stages-1-stage)`` warmup forwards, then one-forward-one-backward
    to steady state, then the backward drain. Both run backwards in
    microbatch order 0..n-1 at every stage, so gradient accumulation
    order — and therefore the accumulated gradient bits — are identical
    across schedules."""
    if schedule == "gpipe":
        return (
            [("F", k) for k in range(n_mb)]
            + [("B", k) for k in range(n_mb)]
        )
    if schedule != "1f1b":
        raise ValueError(
            f"unknown pipeline schedule {schedule!r}; expected one of "
            f"{SCHEDULES}"
        )
    warmup = min(n_mb, n_stages - 1 - stage)
    ops = [("F", k) for k in range(warmup)]
    nf, nb = warmup, 0
    while nb < n_mb:
        if nf < n_mb:
            ops.append(("F", nf))
            nf += 1
        ops.append(("B", nb))
        nb += 1
    return ops


def _max_live_activations(schedule: str, n_stages: int, stage: int,
                          n_mb: int) -> int:
    """Peak number of saved VJPs a stage holds under a schedule (the
    1F1B memory claim; README documents, tests pin)."""
    live = peak = 0
    for op, _ in _schedule_ops(schedule, n_stages, stage, n_mb):
        live += 1 if op == "F" else -1
        peak = max(peak, live)
    return peak


def _stage_exec_loop(instance, plan_blob: bytes) -> int:
    """The per-stage compiled loop (runs as a system actor task via
    ``__rt_pipe_exec_loop__`` and occupies one executor slot until
    teardown). Parks on the command channel; each ``step`` command runs
    the schedule's op list, streaming activations/gradients through the
    stage-boundary channels, then applies the optimizer and acks.

    Every channel op inside a step carries the op deadline, so a dead
    neighbor surfaces as a TimeoutError shipped to the driver on the ack
    channel (or, if the ack write itself cannot complete, as the
    driver's own step deadline) — never a wedged loop that teardown
    cannot drain."""
    from ray_tpu_torch.core.channels import open_channel
    from ray_tpu_torch.dag import _is_stop

    plan = serialization.unpack(plan_blob)
    idx, n_stages = plan["stage"], plan["n_stages"]
    op_t = plan["op_timeout_s"]
    last = idx == n_stages - 1

    def opt(name, role):
        h = plan.get(name)
        return open_channel(h, role) if h is not None else None

    cmd = open_channel(plan["cmd"], "read")
    ack = open_channel(plan["ack"], "write")
    fwd_in = open_channel(plan["fwd_in"], "read")
    fwd_out = opt("fwd_out", "write")
    bwd_in = opt("bwd_in", "read")
    bwd_out = opt("bwd_out", "write")
    tgt_in = opt("tgt", "read")
    loss_out = opt("loss", "write")

    steps = 0
    stopping = False
    while not stopping:
        frame = cmd.read(timeout_s=None)
        if _is_stop(frame):
            break
        command = serialization.unpack(frame)
        if command[0] == "get_params":
            # same ship-don't-die contract as a failed step: params too
            # big for the ack ring (or a dead driver) must not kill the
            # parked loop silently
            try:
                ack.write_value(instance.get_params(), timeout_s=op_t)
            except Exception as e:  # noqa: BLE001 — ship to the driver
                try:
                    ack.write_value(e, timeout_s=5.0)
                except Exception:  # noqa: BLE001 — driver gone too
                    pass
            continue
        _, schedule, n_mb, lr = command
        # per-step observability: input-channel wait counts as idle,
        # compute+output-write as busy; bubble fraction = idle/(idle+busy)
        obs = tracing.ENABLED or core_metrics.ENABLED
        idle_us = busy_us = 0
        step_t0 = tracing.now_us() if obs else 0
        try:
            for op, k in _schedule_ops(schedule, n_stages, idx, n_mb):
                t0 = tracing.now_us() if obs else 0
                if op == "F":
                    x = fwd_in.read(timeout_s=op_t)
                    if _is_stop(x):
                        stopping = True
                        break
                    x = serialization.unpack(x)
                    t1 = tracing.now_us() if obs else 0
                    if last:
                        target = tgt_in.read_value(timeout_s=op_t)
                        loss_out.write_value(
                            instance.forward_loss(k, x, target),
                            timeout_s=op_t,
                        )
                    else:
                        fwd_out.write_value(
                            instance.forward(k, x), timeout_s=op_t
                        )
                else:
                    if last:
                        t1 = t0
                        g = instance.backward_from_loss(k)
                    else:
                        g_in = bwd_in.read_value(timeout_s=op_t)
                        t1 = tracing.now_us() if obs else 0
                        g = instance.backward(k, g_in)
                    if bwd_out is not None:
                        bwd_out.write_value(g, timeout_s=op_t)
                if obs:
                    t2 = tracing.now_us()
                    idle_us += t1 - t0
                    busy_us += t2 - t1
                    if tracing.ENABLED:
                        if t1 > t0:
                            tracing.emit(tracing.pipeline_slice(
                                idx, "idle", t0, t1 - t0, steps,
                                microbatch=k,
                            ))
                        tracing.emit(tracing.pipeline_slice(
                            idx, "fwd" if op == "F" else "bwd", t1,
                            t2 - t1, steps, microbatch=k,
                            schedule=schedule,
                        ))
            if stopping:
                break
            instance.apply(lr)
            ack.write_value(("ok", n_mb), timeout_s=op_t)
            if obs:
                wall_us = max(tracing.now_us() - step_t0, 1)
                bubble = idle_us / max(idle_us + busy_us, 1)
                if tracing.ENABLED:
                    tracing.emit(tracing.pipeline_slice(
                        idx, "step", step_t0, wall_us, steps,
                        bubble_frac=bubble, schedule=schedule,
                        n_microbatches=n_mb,
                    ))
                if core_metrics.ENABLED:
                    core_metrics.pipeline_stage_busy_s.observe(
                        busy_us / 1e6, tags={"stage": str(idx)}
                    )
                    core_metrics.pipeline_bubble_fraction.observe(
                        bubble, tags={"stage": str(idx),
                                      "schedule": schedule}
                    )
            steps += 1
        except Exception as e:  # noqa: BLE001 — ship to the driver
            instance.reset_step()
            try:
                ack.write_value(e, timeout_s=5.0)
            except Exception:  # noqa: BLE001 — driver gone too
                pass
    for ch in (cmd, ack, fwd_in, fwd_out, bwd_in, bwd_out, tgt_in,
               loss_out):
        if ch is not None:
            try:
                ch.close()
            except Exception:  # noqa: BLE001 — best-effort reclaim
                pass
    return steps


class CompiledPipeline:
    """The compiled form of a :class:`Pipeline`: channels allocated,
    stage loops parked, every microbatch streamed over seqlock rings.

    Channels per stage boundary (driver counts as both ends):

    - forward activation channel stage i-1 → i (ring of
      ``channel_slots`` slots × ``channel_capacity`` bytes);
    - backward gradient channel stage i+1 → i (same geometry);
    - driver → last-stage target channel, last-stage → driver loss
      channel (loss ring holds ``max_microbatches`` slots so the last
      stage NEVER blocks publishing a loss — that bound is what makes
      the streaming schedule deadlock-free for any microbatch count up
      to the cap);
    - per-stage command/ack channels (tiny commands down, step acks /
      shipped exceptions / fetched params up).

    Same-node edges ride ShmChannel; cross-node edges ride RpcChannel
    (``RT_PIPELINE_FORCE_RPC_CHANNELS=1`` forces the RPC tier
    everywhere — the cross-host test/A-B lever).

    Failure contract: every channel op inside ``train_step`` carries
    the step deadline — a SIGKILLed stage or a wedged neighbor raises
    within ``step_timeout_s`` (a stage-shipped exception is re-raised
    verbatim), never hangs; the pipeline is then broken and must be
    torn down. ``teardown()`` drains and unlinks every channel it
    created, wedged loops or not."""

    def __init__(
        self,
        pipeline: Pipeline,
        schedule: str = "1f1b",
        channel_capacity: int = 4 * 1024 * 1024,
        channel_slots: int = 2,
        max_microbatches: int = 256,
        step_timeout_s: float = 60.0,
    ):
        from ray_tpu_torch.core import worker as worker_mod
        from ray_tpu_torch.core.channels import (
            RpcChannel, ShmChannel, rpc_channel_handle,
        )

        if schedule not in SCHEDULES:
            raise ValueError(
                f"unknown pipeline schedule {schedule!r}; expected one "
                f"of {SCHEDULES}"
            )
        if channel_slots < 1:
            raise ValueError("channel_slots must be >= 1")
        self._pipe = pipeline
        self.schedule = schedule
        self._n = len(pipeline.stages)
        self._capacity = channel_capacity
        self._slots = channel_slots
        self._max_mb = max_microbatches
        self._timeout = step_timeout_s
        self._broken = False
        self._torn_down = False

        self._w = worker_mod.global_worker()
        infos = ray_tpu_torch.get(
            [s.transport_info.remote() for s in pipeline.stages],
            timeout=step_timeout_s,
        )
        driver = {"node_id": self._w.node_id_hex, "address": self._w.address}
        force_rpc = bool(config.pipeline_force_rpc_channels)

        self._shm_channels: List[ShmChannel] = []

        def make(writer, reader, capacity, slots):
            """One stage-boundary channel: shm when both ends live on
            THE DRIVER'S node (the driver creates the segment, so a
            same-node pair on a remote host could not attach it — those
            edges ride the RPC tier too), RPC mailbox on the reader's
            worker otherwise."""
            if (not force_rpc
                    and writer["node_id"] == reader["node_id"]
                    == driver["node_id"]):
                ch = ShmChannel.create(capacity, slots=slots)
                self._shm_channels.append(ch)
                return ch.handle()
            return rpc_channel_handle(reader["address"], capacity, slots)

        self._rpc_readers: List[RpcChannel] = []

        def driver_end(handle, role):
            if handle.get("kind") == "rpc":
                ch = RpcChannel(handle, role)
                if role == "read":
                    self._rpc_readers.append(ch)
                return ch
            for ch in self._shm_channels:
                if ch.path == handle["path"]:
                    return ch
            raise RuntimeError("driver end of an unknown channel")

        S = self._n
        parked_cmds: List[Any] = []
        try:
            x_h = [
                make(driver if i == 0 else infos[i - 1], infos[i],
                     channel_capacity, channel_slots)
                for i in range(S)
            ]
            g_h = [
                make(infos[i + 1], infos[i], channel_capacity,
                     channel_slots)
                for i in range(S - 1)
            ]
            tgt_h = make(driver, infos[S - 1], channel_capacity,
                         channel_slots)
            # losses are tiny; a slot per microbatch makes the last
            # stage's loss publish non-blocking (see class docstring)
            loss_h = make(infos[S - 1], driver, 16 * 1024,
                          max_microbatches)
            cmd_h = [make(driver, infos[i], 64 * 1024, 2)
                     for i in range(S)]
            # acks also carry fetched params / shipped exceptions
            ack_h = [make(infos[i], driver, channel_capacity, 2)
                     for i in range(S)]

            self._x0 = driver_end(x_h[0], "write")
            self._tgt = driver_end(tgt_h, "write")
            self._loss = driver_end(loss_h, "read")
            self._cmd = [driver_end(h, "write") for h in cmd_h]
            self._ack = [driver_end(h, "read") for h in ack_h]

            # park the stage loops (their returns arrive at teardown)
            self._loop_refs = []
            for i, stage in enumerate(pipeline.stages):
                plan = {
                    "stage": i,
                    "n_stages": S,
                    "op_timeout_s": step_timeout_s,
                    "cmd": cmd_h[i],
                    "ack": ack_h[i],
                    "fwd_in": x_h[i],
                    "fwd_out": x_h[i + 1] if i < S - 1 else None,
                    "bwd_in": g_h[i] if i < S - 1 else None,
                    "bwd_out": g_h[i - 1] if i > 0 else None,
                    "tgt": tgt_h if i == S - 1 else None,
                    "loss": loss_h if i == S - 1 else None,
                }
                refs = self._w.submit_actor_task(
                    stage._actor_id, "__rt_pipe_exec_loop__",
                    (serialization.pack(plan),), {}, num_returns=1,
                )
                self._loop_refs.extend(refs)
                parked_cmds.append(cmd_h[i])
        except BaseException:
            from ray_tpu_torch.core.channels import open_channel
            from ray_tpu_torch.dag import _STOP

            # a stage died mid-compile (or a channel failed to open):
            # the half-built object is unreachable, so unwedge every
            # ALREADY-PARKED loop (else it holds its actor's executor
            # slot forever) and reclaim every channel NOW — no
            # /dev/shm/rtchan_* debris from a failed compile
            for h in parked_cmds:
                try:
                    wch = open_channel(h, "write")
                    try:
                        wch.write(_STOP, timeout_s=1.0)
                    finally:
                        wch.close()
                except Exception:  # noqa: BLE001 — best-effort
                    pass
            for ch in self._shm_channels:
                try:
                    ch.close(unlink=True)
                except Exception:  # noqa: BLE001 — best-effort
                    pass
            for ch in self._rpc_readers:
                try:
                    ch.close()
                except Exception:  # noqa: BLE001 — best-effort
                    pass
            raise

    # -- driver-side hot path ------------------------------------------

    def _check_usable(self):
        if self._torn_down:
            raise RuntimeError("compiled pipeline was torn down")
        if self._broken:
            raise RuntimeError(
                "compiled pipeline is broken (an earlier step failed "
                "mid-stream); teardown and recompile"
            )

    def _sniff_stage_error(self) -> Optional[BaseException]:
        """Non-blocking scan of the ack channels for a shipped stage
        exception (a failed mid-pipeline stage cannot reach the loss
        channel, so the driver's loss read times out — the real cause
        is waiting on that stage's ack channel)."""
        for ch in self._ack:
            try:
                got = ch.read_value(timeout_s=0.0)
            except Exception:  # noqa: BLE001 — empty/closed: keep looking
                continue
            if isinstance(got, BaseException):
                return got
        return None

    def train_step(
        self,
        microbatches: Sequence[Any],
        targets: Sequence[Any],
        lr: float = 1e-2,
        schedule: Optional[str] = None,
    ) -> float:
        """One pipelined training step over the compiled channels.
        Streams each microbatch (and its target) as soon as the input
        ring has a free slot, collects the per-microbatch losses, then
        waits for every stage's apply ack. Returns the mean loss."""
        self._check_usable()
        if len(microbatches) != len(targets):
            raise ValueError("need one target per microbatch")
        n_mb = len(microbatches)
        if n_mb > self._max_mb:
            raise ValueError(
                f"{n_mb} microbatches > max_microbatches={self._max_mb} "
                f"(the loss ring is sized at compile time)"
            )
        sched = schedule or self.schedule
        if sched not in SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {sched!r}")
        deadline = time.monotonic() + self._timeout

        def remaining():
            rem = deadline - time.monotonic()
            if rem <= 0:
                raise TimeoutError("pipeline step deadline exceeded")
            return rem

        losses: List[float] = []
        try:
            command = ("step", sched, n_mb, lr)
            for ch in self._cmd:
                ch.write_value(command, timeout_s=remaining())
            for mb, tv in zip(microbatches, targets):
                self._x0.write_value(mb, timeout_s=remaining())
                self._tgt.write_value(tv, timeout_s=remaining())
                # opportunistic drain: losses stream back while later
                # microbatches are still being fed
                while len(losses) < n_mb:
                    try:
                        losses.append(self._loss.read_value(timeout_s=0.0))
                    except TimeoutError:
                        break
            while len(losses) < n_mb:
                losses.append(
                    self._loss.read_value(timeout_s=remaining())
                )
            for ch in self._ack:
                got = ch.read_value(timeout_s=remaining())
                if isinstance(got, BaseException):
                    raise got
        except BaseException as e:
            self._broken = True
            if isinstance(e, TimeoutError):
                shipped = self._sniff_stage_error()
                if shipped is not None:
                    raise shipped from None
                raise RuntimeError(
                    f"compiled pipeline step did not complete within "
                    f"{self._timeout}s — a stage actor likely died "
                    f"mid-step; teardown() and recompile"
                ) from e
            raise
        return sum(losses) / n_mb

    def get_params(self) -> List[Any]:
        """Fetch every stage's params through the command/ack channels
        (the parked loops occupy the actors' executor slots, so plain
        RPC would queue until teardown). A failure mid-fetch breaks the
        pipeline: a late params reply left in an ack ring would
        otherwise be misread as the next step's ack."""
        self._check_usable()
        deadline = time.monotonic() + self._timeout
        out = []
        try:
            for ch in self._cmd:
                ch.write_value(("get_params",),
                               timeout_s=deadline - time.monotonic())
            for ch in self._ack:
                got = ch.read_value(
                    timeout_s=max(0.1, deadline - time.monotonic())
                )
                if isinstance(got, BaseException):
                    raise got
                out.append(got)
        except BaseException:
            self._broken = True
            raise
        return out

    def teardown(self, timeout_s: float = 60.0) -> None:
        """Stop the stage loops and reclaim every channel. Mirrors
        CompiledDAG.teardown: keep draining driver-facing channels while
        the stop sentinel propagates (a loop may be blocked writing a
        loss/ack the driver never consumed), then unlink all shm
        segments and close all RPC mailboxes — debris-free even when a
        loop outlives the drain deadline (which is surfaced, loudly)."""
        from ray_tpu_torch.core import api
        from ray_tpu_torch.dag import _STOP

        if self._torn_down:
            return
        self._torn_down = True
        pending = list(self._loop_refs)
        stop_sent = [False] * len(self._cmd)
        deadline = time.monotonic() + timeout_s
        while pending and time.monotonic() < deadline:
            for i, ch in enumerate(self._cmd):
                if not stop_sent[i]:
                    try:
                        ch.write(_STOP, timeout_s=0.2)
                        stop_sent[i] = True
                    except Exception:  # noqa: BLE001 — full/dead: retry
                        pass
            for ch in (self._loss, *self._ack):
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
            logger.warning(
                "compiled pipeline teardown: %d stage loop(s) still "
                "running after the %.0fs drain deadline; unlinking all "
                "channels anyway",
                len(pending), timeout_s,
            )
        for ch in self._shm_channels:
            ch.close(unlink=True)
        for ch in self._rpc_readers:
            ch.close()  # driver-side mailboxes (shm ends closed above)

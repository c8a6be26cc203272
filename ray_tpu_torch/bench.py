"""The train step that ``bench.py`` measures, set up once for every script
that runs it, and the twin of ``bench.py``'s main.

Counterpart of ``bench.py``'s train loop (``bench.py:73-119``): gpt2-small
with flash attention, the fused CE head, no remat, AdamW (lr 3e-4, weight
decay 0.01), B=32, T=1024, tokens drawn as ``bench.py``'s pipeline draws
them. ``chip_smoke.py`` and ``profile_train_step`` both take their model,
optimizer and batches from ``setup``, so they run the same step.

``python3 -m ray_tpu_torch.bench`` is ``bench.py``'s main on the card: the
runtime (``init(num_cpus=2)``), the ``ray_tpu_torch.data`` token pipeline
(``token_pipeline``), the batches double-buffered onto the card
(``device_batches``), one warm-up step and the timed steps
(``pipeline_steps``), then one JSON line with ``bench.py``'s keys.
``--device cpu --model gpt2-tiny --batch 8 --seq 64 --steps 3`` is its CI
mode.

Also how a run of that step is timed and its launches counted
(``timed_steps``, for ``chip_smoke.py`` and ``sharded_cards``), the
agreement rule that ``chip_smoke.py`` and the CUDA tests hold a kernel to
against its plain version (``disagreement``), the timer of a call on the
card (``time_ms``), its device busy time under torch.profiler
(``busy_ms``), that time split between named kernels and the rest
(``device_split``), whether a trace measures the card
(``measured_kernels``) and whether the profiler records device time at all
(``profiler_ready``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import statistics
import subprocess
import time
from typing import Callable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.ops import flash_attention as fa

MODEL, BATCH, SEQ = "gpt2-small", 32, 1024


def config(model: str = MODEL) -> gpt2.GPT2Config:
    """bench.py's training configuration of ``model`` (bench.py:73-77).
    Its TPU-tuned ``loss_chunk=256`` and ``scan_unroll`` are not carried
    over: the port keeps the default chunk of 128."""
    return dataclasses.replace(gpt2.CONFIGS[model], attn_impl="flash", loss_impl="fused",
                               remat=False)


def batch_tokens(step: int, vocab: int, batch: int = BATCH, seq: int = SEQ) -> np.ndarray:
    """Rows step*batch .. step*batch+batch-1 as bench.py's token pipeline
    draws them (bench.py:50-53): one generator per block of rows, seeded
    with the block's first row id + 1."""
    rng = np.random.default_rng(step * batch + 1)
    return rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)


class TrainRun(NamedTuple):
    cfg: gpt2.GPT2Config
    model: gpt2.GPT2
    step: Callable[[torch.Tensor], torch.Tensor]  # one AdamW step on the model
    batches: List[torch.Tensor]
    optimizer: torch.optim.Optimizer  # the step's AdamW (its state for a checkpoint)


def setup(n_batches: int, model: str = MODEL, batch: int = BATCH, seq: int = SEQ,
          device: DeviceLike = None, place=None, **overrides) -> TrainRun:
    """A model from the port's random init (a generator on ``device``
    seeded with 0), its AdamW train step, and the first ``n_batches`` token
    batches [batch, seq+1] on ``device``. ``overrides`` replace fields of
    the configuration (``remat``, ``remat_policy``, ...); ``place``, if
    given, takes the initialised model and returns it placed on a mesh
    (``parallel.shard_model``) before the optimizer is made."""
    device = resolve_device(device)
    cfg = dataclasses.replace(config(model), **overrides)
    net = gpt2.init(torch.Generator(device=device).manual_seed(0), cfg, device)
    if place is not None:
        net = place(net)
    opt = torch.optim.AdamW(net.parameters(), lr=3e-4, weight_decay=0.01,
                            betas=(0.9, 0.999), eps=1e-8)
    batches = [torch.from_numpy(batch_tokens(i, cfg.vocab_size, batch, seq)).to(device)
               for i in range(n_batches)]
    return TrainRun(cfg, net, gpt2.make_train_step(net, opt), batches, opt)


def timed_steps(run: TrainRun, batches, warmup: int, profile: bool = True) -> tuple:
    """The train step on ``warmup`` batches, then timed on the rest (host
    clock around steps that end in a synchronise), then one more step on
    the last batch, under torch.profiler if ``profile``: (ms of each timed
    step, launches of each kernel per timed step, peak memory over the
    timed steps in GiB, device busy ms of the last step). The launch
    counts are set to 0 just before the timed steps. On the CPU, where the
    kernels' plain versions run, the peak and the busy time are nan."""
    cuda = batches[0].is_cuda
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for tokens in batches[:warmup]:
        run.step(tokens)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for counts in (fa.launches, fa.launches_f32):
        counts.update(dict.fromkeys(counts, 0))
    times = []
    for tokens in batches[warmup:]:
        sync()
        t0 = time.perf_counter()
        run.step(tokens)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    per_step = {name: n / len(times) for name, n in fa.launches.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
    last = lambda: run.step(batches[-1])  # noqa: E731
    if cuda and profile:
        busy = busy_ms(last)
    else:
        last()
        busy = float("nan")
    return times, per_step, peak, busy


# ---------------------------------------------------------------------------
# bench.py's main: the step fed by the runtime's streaming pipeline
# ---------------------------------------------------------------------------

# Dense bf16 peak FLOP/s by the card's name (NVIDIA's data sheet; H100 SXM,
# whose name ends in "80GB HBM3"). A card not listed has no MFU.
PEAK_BF16_FLOPS = {"H100 80GB HBM3": 989e12}


def token_pipeline(total_rows: int, batch: int, seq: int, vocab: int, parallelism: int):
    """Streaming token batches [batch, seq+1] through ray_tpu_torch.data
    (``bench.py:41-56``): ``range`` cut into ``parallelism`` blocks, each
    block's tokens drawn in a worker by ``map_batches`` from
    ``default_rng(first row id + 1)``, then ``iter_batches`` with a prefetch
    of 2. With blocks of exactly ``batch`` rows, batch i is
    ``batch_tokens(i)``. ``make_tokens`` is a closure and so is pickled by
    value: the workers import numpy, not this module (and so not torch)."""
    from ray_tpu_torch import data as rtd

    width = seq + 1

    def make_tokens(b):
        import numpy as np

        ids = b["id"]
        rng = np.random.default_rng(int(ids[0]) + 1)
        return {"tokens": rng.integers(0, vocab, (len(ids), width), dtype=np.int32)}

    ds = rtd.range(total_rows, parallelism=parallelism).map_batches(make_tokens)
    return ds.iter_batches(batch_size=batch, prefetch_batches=2, drop_last=True)


def device_batches(host_batches, device: torch.device,
                   stage_ms: List[float]) -> Iterator[Tuple[np.ndarray, torch.Tensor]]:
    """(host tokens, tokens on ``device``) for each pipeline batch, batch
    t+1 copied while step t runs (``bench.py:96-106``). On the card a batch
    goes into one of two pinned buffers, used in turn, and onto the card by
    a ``non_blocking`` copy on a side stream; it is handed out only after
    the next batch's copy is queued. The consuming stream waits on the
    copy's event, and the tensor is recorded on that stream for the
    allocator. A buffer is refilled once the copy that last read it is done
    (its event), two batches later. On the CPU a batch is copied.
    ``stage_ms`` gets each batch's staging time on the host."""
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    pinned: List[Optional[torch.Tensor]] = [None, None]
    copied: List[Optional[torch.cuda.Event]] = [None, None]
    pending = None
    for i, b in enumerate(host_batches):
        host = b["tokens"]
        t = time.perf_counter()
        if cuda:
            k = i % 2
            if copied[k] is not None:
                copied[k].synchronize()
            if pinned[k] is None or pinned[k].shape != host.shape:
                pinned[k] = torch.empty(host.shape, dtype=torch.int32, pin_memory=True)
            pinned[k].numpy()[...] = host
            with torch.cuda.stream(side):
                dev = pinned[k].to(device, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(side)
            copied[k] = ready
        else:
            dev, ready = torch.from_numpy(np.array(host, dtype=np.int32)), None
        stage_ms.append((time.perf_counter() - t) * 1e3)
        if pending is not None:
            yield _handed_out(*pending)
        pending = (host, dev, ready)
    if pending is not None:
        yield _handed_out(*pending)


def _handed_out(host, dev: torch.Tensor, ready):
    if ready is not None:
        stream = torch.cuda.current_stream(dev.device)
        stream.wait_event(ready)
        dev.record_stream(stream)
    return host, dev


class PipelineRun(NamedTuple):
    steps: int  # timed steps, after the warm-up step
    seconds: float  # host clock over the timed steps, ending in a synchronise
    loss: float  # the last step's
    step_ms: List[float]  # each timed step: from the previous step's end to its own
    wait_ms: List[float]  # each timed step: the host's wait in next() for its batch
    fetch_ms: List[float]  # each host batch: of that, the wait on the data iterator
    stage_ms: List[float]  # each host batch: of that, its staging (pinned buffer, copy queued)
    losses: List[float]  # with record: every step's, the warm-up first
    tokens: List[np.ndarray]  # with record: every batch's host tokens, in order


def pipeline_steps(run: TrainRun, host_batches, record: bool = False) -> PipelineRun:
    """``bench.py``'s loop (``bench.py:107-119``): the train step on the
    pipeline's first batch (warm-up), then on every other batch, the host
    reading no value until the end. A step's time runs from the end of the
    step before (CUDA events on the compute stream; the host clock on the
    CPU), so a stall of the pipeline shows in it. A step's wait in next()
    covers the data iterator's next batch (timed apart, ``fetch_ms``) and
    its staging onto the card (``stage_ms``). ``record`` keeps each step's loss (read
    after the loop) and a copy of each batch."""
    device = next(run.model.parameters()).device
    cuda = device.type == "cuda"
    fetch_ms: List[float] = []
    stage_ms: List[float] = []

    def fetched(it):
        it = iter(it)
        while True:
            t = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                return
            fetch_ms.append((time.perf_counter() - t) * 1e3)
            yield b

    batches = device_batches(fetched(host_batches), device, stage_ms)
    losses, tokens = [], []

    def mark():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    host, first = next(batches)
    loss = run.step(first)
    if record:
        losses.append(loss)
        tokens.append(np.array(host))
    float(loss)  # the warm-up ends on the host
    ends, wait_ms = [mark()], []
    t0 = time.perf_counter()
    while True:
        w0 = time.perf_counter()
        try:
            host, b = next(batches)
        except StopIteration:
            break
        wait_ms.append((time.perf_counter() - w0) * 1e3)
        loss = run.step(b)
        ends.append(mark())
        if record:
            losses.append(loss)
            tokens.append(np.array(host))
    last = float(loss)
    seconds = time.perf_counter() - t0
    if cuda:
        step_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
    else:
        step_ms = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
    return PipelineRun(len(wait_ms), seconds, last, step_ms, wait_ms, fetch_ms, stage_ms,
                       [float(x) for x in losses], tokens)


def card() -> Tuple[Optional[str], Optional[str]]:
    """(name, power limit) of card 0 as nvidia-smi gives them; (None, None)
    without one."""
    if not torch.cuda.is_available():
        return None, None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    name, _, limit = out.strip().splitlines()[0].partition(",")
    return name.strip(), limit.strip()


def result_line(run: TrainRun, res: PipelineRun, model: str, batch: int, seq: int) -> dict:
    """``bench.py``'s JSON line (``bench.py:121-153``) for ``res``; MFU
    against the card's bf16 dense peak, null where that is unknown."""
    device = next(run.model.parameters()).device
    name, limit = card() if device.type == "cuda" else (None, None)
    tokens_per_sec = batch * seq * res.steps / res.seconds
    n_params = sum(p.numel() for p in run.model.parameters())
    peak = next((v for k, v in PEAK_BF16_FLOPS.items() if name and name.endswith(k)), None)
    mfu = tokens_per_sec * 6.0 * n_params / peak if peak else None
    return {
        "metric": "gpt2_train_tokens_per_sec_per_chip",
        "value": tokens_per_sec,
        "unit": "tokens/s/chip",
        "vs_baseline": mfu / 0.40 if mfu is not None else None,
        "detail": {
            "model": model,
            "params": n_params,
            "batch": batch,
            "seq": seq,
            "steps": res.steps,
            "loss": res.loss,
            "mfu": mfu,
            "backend": device.type,
            "device": name or device.type,
            "power_limit": limit,
            "input": "ray_tpu_torch.data streaming pipeline",
            "baseline_note": (
                "vs_baseline = MFU / 0.40 (an efficient DDP/NCCL GPT-2 pretrain's typical "
                "MFU); MFU = tokens/s x 6 x params over the card's dense bf16 peak "
                "(H100 SXM: 989 TFLOP/s, NVIDIA's data sheet), null where the peak is "
                "unknown (the CPU)."
            ),
        },
    }


def main(argv=None) -> None:
    import argparse

    import ray_tpu_torch

    ap = argparse.ArgumentParser(description="bench.py's train step on the port, fed by "
                                 "the ray_tpu_torch.data pipeline; prints one JSON line")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--model", default=MODEL)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)

    run = setup(0, args.model, args.batch, args.seq, args.device)
    ray_tpu_torch.init(num_cpus=2)
    try:
        host = token_pipeline(args.batch * (args.steps + 1), args.batch, args.seq,
                              run.cfg.vocab_size, parallelism=args.steps + 1)
        res = pipeline_steps(run, host)
    finally:
        ray_tpu_torch.shutdown()
    print(json.dumps(result_line(run, res, args.model, args.batch, args.seq)))


# ---------------------------------------------------------------------------
# Agreement of a kernel with its plain version
# ---------------------------------------------------------------------------

# The kernels and their plain versions take the same bf16 inputs and round
# to bf16 at the same places (p and dS before their products, the outputs),
# but sum in other orders and round p against a running max rather than the
# final one. So an output element may differ by a few bf16 roundings (bf16
# keeps 8 bits: 2^-8 = 3.9e-3 per rounding) of the terms it sums, whose
# scale is that of its row: the rows of a causal output differ in scale by
# far more than that (row 0 of o is v_0; late rows average ~T values). Every
# element is held to
#     |got - want| <= RTOL |want| + ATOL_RMS rms(row of want) + ABS_FLOOR,
# a row being the last axis (one query's or one key's head vector); the
# absolute part covers elements that cancel to near zero, and ABS_FLOOR
# outputs that are zero in exact arithmetic (dS at T = 1). The whole tensor
# is held to ||got - want|| <= RELNORM_TOL ||want||.
RTOL = 2.0 ** -6
ATOL_RMS = 2e-2
RELNORM_TOL = 1e-2
ABS_FLOOR = 1e-5


def disagreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How far ``got`` is from ``want``: ``max_abs`` (max |got - want|),
    ``atol_rms`` (the least ATOL_RMS under which every element would pass
    the rule above), ``relnorm`` (||got - want|| / ||want||) and ``ok``
    (both within their limits; False on any NaN)."""
    g, w = got.detach().float(), want.detach().float()
    err = (g - w).abs()
    row_rms = w.square().mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    atol_rms = ((err - RTOL * w.abs() - ABS_FLOOR) / row_rms).max().item()
    norm = w.norm().item()
    relnorm = (g - w).norm().item() / norm if norm > 0 else 0.0
    max_abs = err.max().item()
    ok = bool(atol_rms <= ATOL_RMS and (relnorm <= RELNORM_TOL or max_abs <= ABS_FLOOR))
    return {"max_abs": max_abs, "atol_rms": atol_rms, "relnorm": relnorm, "ok": ok}


def relnorms(got: dict, want: dict) -> dict:
    """||got[n] - want[n]|| / ||want[n]|| for every tensor of ``want`` whose
    norm is not 0 (gradients by parameter name, say)."""
    return {n: ((got[n].float() - w.float()).norm() / w.float().norm()).item()
            for n, w in want.items() if w.float().norm().item() > 0}


def union_us(intervals) -> float:
    """Length of the union of [start, end) intervals (microseconds)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_kernels(prof) -> list:
    """The device events of a torch.profiler trace that are kernels, copies
    or fills: a record_function range also shows up mirrored on the device
    over the kernels it launched, under its host event's name, and is
    dropped (kernel names never match a host event's)."""
    from torch.autograd import DeviceType

    events = prof.events()
    host = {ev.name for ev in events if ev.device_type == DeviceType.CPU}
    return [ev for ev in events if ev.device_type == DeviceType.CUDA and ev.name not in host]


# Launches of a kernel of the trace's own (torch.cuda._sleep's spin kernel)
# that open each ``card_trace`` window before the work it measures.
PAD_KERNELS = 16
PAD_KERNEL = "spin_kernel"


@contextlib.contextmanager
def card_trace():
    """A torch.profiler window (host and card) around its body, opened by
    PAD_KERNELS launches of the pad kernel, which ``measured_kernels``
    leaves out. Traces on some H100 machines lost the first 7-9 kernels of
    every window, whether or not the card had idled 50 ms in it first: the
    pads are there to be what is lost."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()


def measured_kernels(prof) -> Tuple[list, str]:
    """(the kernels, copies and fills of a ``card_trace`` window but its
    pads, "") where the trace measures the card: it holds a pad and a
    kernel for every other kernel launch the host made in it. Else ([],
    why not). On some H100 machines a process's profiler has recorded no
    device time, or lost some of a window's kernels; a caller then writes
    "not measured" where it would give a device time, and its CUDA-event
    times stand."""
    from torch.autograd import DeviceType

    traced = device_kernels(prof)
    kernels = [ev for ev in traced if PAD_KERNEL not in ev.name]
    if len(kernels) == len(traced):
        return [], "no pad kernel" if kernels else "no device time"
    launched = sorted(ev.time_range.start for ev in prof.events()
                      if ev.device_type == DeviceType.CPU and "LaunchKernel" in ev.name)[PAD_KERNELS:]
    ran = [ev.time_range.start for ev in kernels if not ev.name.startswith(("Memcpy", "Memset"))]
    if len(ran) < len(launched):
        return [], (f"{len(ran)} kernels for {len(launched)} launches (the first kernel starts "
                    f"{(min(ran, default=0) - launched[0]) / 1e3:.3f} ms after the first launch)")
    return kernels, ""


def device_trace(fn: Callable[[], object]) -> list:
    """The kernels, copies and fills of one call of ``fn`` on the card under
    torch.profiler (``card_trace``), or [] where the trace does not measure
    the card (``measured_kernels``)."""
    with card_trace() as prof:
        fn()
    return measured_kernels(prof)[0]


def profiler_ready(windows: int = 3, device: DeviceLike = "cuda") -> int:
    """Profile one small kernel up to ``windows`` times, until a trace
    measures the card (``measured_kernels``): the number of that window (1
    for the first), or 0 if none did."""
    x = torch.ones(1024, device=device)
    for window in range(1, windows + 1):
        if device_trace(lambda: x.mul_(1.0)):
            return window
    return 0


def busy_ms(fn: Callable[[], object]) -> float:
    """Device busy time of one call of ``fn`` on the card: the union of its
    kernels' intervals under torch.profiler, in ms; nan (not measured) if
    the trace does not measure the card (``measured_kernels``)."""
    kernels = device_trace(fn)
    if not kernels:
        return float("nan")
    return union_us([(ev.time_range.start, ev.time_range.end) for ev in kernels]) / 1e3


# The three flash kernels' names, bf16 or f32 operands (``device_split``).
FLASH_KERNELS = r"flash_(f32_)?(fwd|dq|dkv)_kernel"


def device_split(fn: Callable[[], object], pattern: str = FLASH_KERNELS) -> tuple:
    """One call of ``fn`` on the card under torch.profiler: (device ms in the
    kernels whose name matches ``pattern``, device ms in every other kernel,
    copy and fill, the four largest of those as (name, ms)); (nan, nan, [])
    (not measured) if the trace does not measure the card
    (``measured_kernels``)."""
    kernels = device_trace(fn)
    if not kernels:
        return float("nan"), float("nan"), []
    matched, by_name = 0.0, {}
    for ev in kernels:
        ms = ev.time_range.elapsed_us() / 1e3
        if re.search(pattern, ev.name):
            matched += ms
        else:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return matched, sum(by_name.values()), top


def time_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` on the card, CUDA events
    around each call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


if __name__ == "__main__":
    main()

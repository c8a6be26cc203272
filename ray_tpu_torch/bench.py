"""The train step that ``bench.py`` measures, set up once for every script that runs it.

Counterpart of ``bench.py``'s train loop (``bench.py:73-119``): gpt2-small
with flash attention, the fused CE head, no remat, AdamW (lr 3e-4, weight
decay 0.01), B=32, T=1024, tokens drawn as ``bench.py``'s pipeline draws
them. ``chip_smoke.py`` and ``profile_train_step`` both take their model,
optimizer and batches from ``setup``, so they run the same step.

Also how a run of that step is timed and its launches counted
(``timed_steps``, for ``chip_smoke.py`` and ``sharded_cards``), the
agreement rule that ``chip_smoke.py`` and the CUDA tests hold a kernel to
against its plain version (``disagreement``), the timer of a call on the
card (``time_ms``) and its device busy time under torch.profiler
(``busy_ms``).
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, List, NamedTuple

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
    return TrainRun(cfg, net, gpt2.make_train_step(net, opt), batches)


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


def busy_ms(fn: Callable[[], object]) -> float:
    """Device busy time of one call of ``fn`` on the card: the union of its
    kernels' intervals under torch.profiler, in ms. Raises if the trace
    holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    return union_us([(ev.time_range.start, ev.time_range.end) for ev in kernels]) / 1e3


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

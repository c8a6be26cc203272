"""Where the time of a GPT-2 train step goes on the card.

    python3 -m ray_tpu_torch.profile_train_step

Runs the train step that chip_smoke.py drives (``ray_tpu_torch.bench``:
gpt2-small, B=32, T=1024, flash attention, fused CE, no remat, AdamW lr
3e-4 and weight decay 0.01, from the same seeded init and token batches),
warms up for two steps, then traces three steps with torch.profiler.
Prints, per step: the wall time, the device's busy and idle shares of it,
device time by kernel group and the slowest kernels by name. Only kernels,
copies and fills count as device time: the device-side mirrors of
``record_function`` ranges (``Optimizer.step#AdamW.step`` and the like)
span kernels and are dropped. Exits non-zero if the trace holds no device
time.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch import bench
from ray_tpu_torch.models import gpt2

# First match wins; kernel names are matched in lower case.
GROUPS = [
    ("flash attention (this port's kernels)", ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma", "cublas", "sm90_")),
    ("optimizer (AdamW)", ("multi_tensor_apply", "adam")),
    ("layernorm", ("layer_norm",)),
    ("reductions and softmax", ("reduce_kernel", "softmax", "scatter", "gather")),
    ("elementwise and copies", ("elementwise", "vectorized", "copy", "memcpy", "memset", "fill", "cat")),
]


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


WARMUP, STEPS = 2, 3


def main() -> None:
    run = bench.setup(WARMUP + STEPS)
    cfg, model, step, tokens = run.cfg, run.model, run.step, run.batches
    for t in tokens[:WARMUP]:
        step(t)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in tokens[WARMUP:]:
            step(t)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    events = prof.events()
    # A record_function range shows up twice: on the host, and mirrored on
    # the device over the kernels it launched. Kernel names never match a
    # host event's name (those are aten ops, runtime calls and labels).
    host_names = {ev.name for ev in events if ev.device_type == DeviceType.CPU}
    by_name, intervals, dropped = defaultdict(float), [], defaultdict(float)
    for ev in events:
        if ev.device_type != DeviceType.CUDA:
            continue
        if ev.name in host_names:
            dropped[ev.name] += ev.time_range.elapsed_us()
            continue
        dur = ev.time_range.elapsed_us()
        by_name[ev.name] += dur
        intervals.append((ev.time_range.start, ev.time_range.end))
    if not by_name:
        raise SystemExit("the profiler recorded no device time")

    n = STEPS
    device_us = sum(by_name.values())
    busy = bench.union_us(intervals)
    print(f"{torch.cuda.get_device_name(0)}; {bench.MODEL} B={bench.BATCH} T={bench.SEQ}, "
          f"{n} traced steps")
    print(f"step wall {wall_us / n / 1e3:.3f} ms, device busy {busy / n / 1e3:.3f} ms "
          f"({100 * busy / wall_us:.1f}% busy, {100 * (1 - busy / wall_us):.1f}% idle), "
          f"kernel time {device_us / n / 1e3:.3f} ms")
    print("device-side annotation ranges left out (ms/step): "
          + (", ".join(f"{name} {us / n / 1e3:.3f}" for name, us in sorted(dropped.items()))
             or "none"))
    by_group = defaultdict(float)
    for name, us in by_name.items():
        by_group[_group(name)] += us
    print("device time by group (ms/step, share of kernel time):")
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {us / n / 1e3:9.3f}  {100 * us / device_us:5.1f}%  {group}")
    print("slowest kernels (ms/step, share of kernel time):")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {us / n / 1e3:9.3f}  {100 * us / device_us:5.1f}%  {name[:110]}")
    print(f"loss head alone (tied-head matmuls and the fused CE, forward + backward): "
          f"{_head_ms(model, cfg, tokens[0]):.3f} ms")


def _head_ms(model, cfg, tokens, iters: int = 5) -> float:
    """Median device time (CUDA events) of the loss head on the step's
    shapes: gpt2.loss_fn less the backbone, forward and backward."""
    B, T = tokens.shape[0], tokens.shape[1] - 1
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(B, T, cfg.d_model, device="cuda", dtype=cfg.dtype, generator=g)
    x.requires_grad_()
    targets = tokens[:, 1:].long()
    times = []
    for _ in range(iters + 1):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        loss = gpt2.head_loss(x, model.wte.to(cfg.dtype), targets, cfg)
        loss.backward()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times[1:]))


if __name__ == "__main__":
    main()

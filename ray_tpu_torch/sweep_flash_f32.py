"""Time design variants of the f32-operand flash kernels on the card.

    python3 -m ray_tpu_torch.sweep_flash_f32 [--rounds 2] [--variants NAME ...]
    python3 -m ray_tpu_torch.sweep_flash_f32 --variants slices
    python3 -m ray_tpu_torch.sweep_flash_f32 --variants fwd32 fwd16

``csrc/flash_attention_f32.cu`` splits every f32 operand into two tf32
parts in shared memory before its 3xTF32 products; the split pass runs on
every stage's path. Its choices (how many warpgroups split, how tf32 is
rounded, whether TMA loads land in raw slots ahead of the ring; for the
forward also its block of 128 q rows, both consumer warpgroups on every
stage, against 64 rows on alternate stages, its keys a stage and ring
depth) were settled by timing variants of the source against one another.
This rebuilds the library once per variant of ``VARIANTS`` (text edits of
the current ``.cu`` and ``hopper.cuh``, copied into the ignored build
directory; an edit that no longer applies is reported and the variant
skipped), prints nvcc's spill lines for each, holds each variant's
forward (o within 1e-5 in relative norm, lse within 1e-5 absolute) and dQ
and dK/dV (1e-4 relative norm) against the plain versions (f32, TF32
off), and times the three kernels at ``SHAPES`` in turns, ``--rounds``
times: median of 20 calls with CUDA events around each call (which
includes the host's launch when it is slower than the kernel), and the
device time of the kernels alone from ``torch.profiler``, side by side.
``--variants`` runs only the variants whose names start with one of those
given ("chosen" always runs; "raw" picks head dim 256's). Each variant
runs in a process of its own with a time limit, so a variant that hangs
the card is reported, not waited for. Needs one NVIDIA card; the builds run at once (about 15 s).

The variants named from "slices" on edit the dQ and dK/dV above head dim
256 (``SliceTiles``: clusters of 128-column slices that sum their partial
scores through distributed shared memory). They build the mixed library
too and run at ``SLICE_SHAPES`` instead (the chosen source with them):
each held there against the plain versions (f32 outputs at 1e-4
relative norm, 16-bit ones by the bf16 rule, each output's gap printed),
dQ's bits twice, then dQ and dK/dV timed beside SDPA's backward on the
same inputs (cast to f32 for a mix); at ``SLICE_CHECKS`` (the widest
clusters) checked only. Those that take a part of the exchange out are
timed only (``TIMING_ONLY``); "slices off" runs the column windows of
``flash_wide.cuh`` at every head dim above 256, the route before the
slices, on the same inputs.

The variants named from "fwd32" on edit the forward above head dim 256
(``FwdSliceTiles`` of the f32 source: clusters of 128-column slices that
sum their partial scores S through distributed shared memory), those from
"fwd16" on the 16-bit forward's (``FwdSliceTiles`` of
``flash_attention.cu``, its counterpart for bf16 and f16 operands). They
build the f32 and mixed libraries, or the bf16 and f16 ones, and run at
``FWD32_SHAPES`` or ``FWD16_SHAPES`` (the cases of the forward that
chip_smoke.py times, in PERF.md's column-window table): each variant's
forward held there and at ``FWD_CHECKS`` (ragged, non-causal, the widest
clusters) against the plain version (f32 outputs of f32 operands at 1e-5
relative norm, others by the bf16 rule; lse; o's bits twice), then timed
beside SDPA's forward on the same inputs (cast to f32 for a mix). Those
that take a part of the exchange out are timed only; "fwd32 off" and
"fwd16 off" run the column windows of ``flash_wide.cuh`` (the route before
the clusters) on the same inputs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from ray_tpu_torch import bench
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as fa

SOURCE, HEADER, MIXED_SOURCE = "flash_attention_f32.cu", "hopper.cuh", "flash_attention_mixed.cu"
SOURCE16, F16_SOURCE = "flash_attention.cu", "flash_attention_f16.cu"  # the 16-bit forward's
TRAITS = {  # F32Tiles<D> as the .cu has them, the text the variants edit
    16: "DQ_BK = 64, DQ_STAGES = 4, DQ_RAW = 2, DKV_BQ = 32, DKV_STAGES = 4, DKV_RAW = 2;\n"
        "  static constexpr int LOADER_WGS = 3;\n"
        "  static constexpr int FWD_ROWS = 128, FWD_BK = 64, FWD_STAGES = 4, FWD_RAW = 2, FWD_LOADER_WGS = 3;\n"
        "  static constexpr int A_SPLIT = 1, DKV_PASSES = 1;",
    32: "DQ_BK = 64, DQ_STAGES = 3, DQ_RAW = 2, DKV_BQ = 32, DKV_STAGES = 4, DKV_RAW = 2;\n"
        "  static constexpr int LOADER_WGS = 3;\n"
        "  static constexpr int FWD_ROWS = 64, FWD_BK = 64, FWD_STAGES = 3, FWD_RAW = 2, FWD_LOADER_WGS = 3;\n"
        "  static constexpr int A_SPLIT = 1, DKV_PASSES = 1;",
    64: "DQ_BK = 32, DQ_STAGES = 3, DQ_RAW = 0, DKV_BQ = 32, DKV_STAGES = 2, DKV_RAW = 2;\n"
        "  static constexpr int LOADER_WGS = 3;\n"
        "  static constexpr int FWD_ROWS = 128, FWD_BK = 64, FWD_STAGES = 2, FWD_RAW = 0, FWD_LOADER_WGS = 2;\n"
        "  static constexpr int A_SPLIT = 1, DKV_PASSES = 1;",
    128: "DQ_BK = 16, DQ_STAGES = 2, DQ_RAW = 0, DKV_BQ = 8, DKV_STAGES = 2, DKV_RAW = 2;\n"
         "  static constexpr int LOADER_WGS = 2;\n"
         "  static constexpr int FWD_ROWS = 128, FWD_BK = 16, FWD_STAGES = 2, FWD_RAW = 2, FWD_LOADER_WGS = 2;\n"
         "  static constexpr int A_SPLIT = 1, DKV_PASSES = 1;",
    256: "DQ_BK = 8, DQ_STAGES = 2, DQ_RAW = 0, DKV_BQ = 8, DKV_STAGES = 2, DKV_RAW = 0;\n"
         "  static constexpr int LOADER_WGS = 1;\n"
         "  static constexpr int FWD_ROWS = 128, FWD_BK = 8, FWD_STAGES = 2, FWD_RAW = 0, FWD_LOADER_WGS = 1;\n"
         "  static constexpr int A_SPLIT = 0, DKV_PASSES = 2;",
}
# The instances whose block rows are split in shared memory: the variants
# below are about their layout (head dim 256 keeps its rows raw, at the
# smallest stages its shared memory allows).
SPLIT_DIMS = (16, 32, 64, 128)
CVT_RNA = ('  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;',
           '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n  return r;')


def _trait(d: int, name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+)", TRAITS[d])[1])


def _set(d: int, **values) -> tuple:
    """An edit of head dim d's traits: each NAME to its value."""
    text = TRAITS[d]
    for name, value in values.items():
        text = re.sub(rf"\b{name} = \d+", f"{name} = {value}", text)
    return (SOURCE, TRAITS[d], text)


def _edits(**per_dim) -> list:
    """Edits of several head dims' traits ({"d64": {...}, ...}), those that change the text."""
    edits = [_set(int(key[1:]), **values) for key, values in per_dim.items()]
    return [e for e in edits if e[1] != e[2]]


def _every(**values) -> list:
    return _edits(**{f"d{d}": values for d in SPLIT_DIMS})


# SliceTiles as the .cu has it (the slices above head dim 256), the text
# the "slices" variants edit; and the exchange's wait and reads.
SLICE_TRAITS = ("  static constexpr int DQ_BK = 16, DQ_STAGES = 2, DQ_RAW = 0, DKV_BQ = 8, DKV_STAGES = 3, DKV_RAW = 0;\n"
                "  static constexpr int LOADER_WGS = 2, READ_BLOCKS = 4, SCORE_STEPS = 2;")
SLICE_WAIT = "  mbar_wait_cluster(full, parity);\n"
SLICE_READS = "  auto add_group = [&](int r0) {"


def _slices(**values) -> list:
    """An edit of SliceTiles' traits: each NAME to its value."""
    text = SLICE_TRAITS
    for name, value in values.items():
        text = re.sub(rf"\b{name} = \d+", f"{name} = {value}", text)
    return [(SOURCE, SLICE_TRAITS, text)]


# FwdSliceTiles as the f32 and the 16-bit sources have them (the forward's
# clusters above head dim 256), the text the "fwd32" and "fwd16" variants edit.
FWD32_TRAITS = ("  static constexpr int SLICE = 128, MAX_SLICES = 8;\n"
                "  static constexpr int BK = 32, STAGES = 2, LOADER_WGS = 2, READ_BLOCKS = 4, SCORE_STEPS = 2;")
FWD16_TRAITS = ("  static constexpr int SLICE = 256, MAX_SLICES = 4;\n"
                "  static constexpr int ROWS = 128, BK = 64, STAGES = 2, READ_BLOCKS = 1;")


def _fwd(bits: int, **values) -> list:
    """An edit of the f32 (bits 32) or 16-bit forward's FwdSliceTiles: each NAME to its value."""
    old = FWD32_TRAITS if bits == 32 else FWD16_TRAITS
    text = old
    for name, value in values.items():
        text = re.sub(rf"\b{name} = \d+", f"{name} = {value}", text)
    return [(SOURCE if bits == 32 else SOURCE16, old, text)]


# name: (what it tries, [(file, old text, new text), ...])
VARIANTS = {
    "chosen": ("the .cu as it is", []),
    "one loading warpgroup": ("96 threads split (three warps) in the backward", _every(LOADER_WGS=1)),
    "two loading warpgroups": ("224 threads split in the backward at head dims 16-64",
                               _edits(d16={"LOADER_WGS": 2}, d32={"LOADER_WGS": 2}, d64={"LOADER_WGS": 2})),
    "cvt.rna rounding": ("tf32 rounding by cvt.rna.tf32.f32 instead of two integer instructions",
                         [(HEADER, *CVT_RNA)]),
    "no raw slots": ("TMA into the stage and the split in place in the backward (head dim 128's dK/dV ring 3 "
                     "deep)", _edits(**{f"d{d}": {"DQ_RAW": 0, "DKV_RAW": 0} for d in (16, 32, 64)},
                                     d128={"DQ_RAW": 0, "DKV_RAW": 0, "DKV_STAGES": 3})),
    "forward 64-row blocks": ("the forward's consumers on alternate stages of one 64-row block, (m, l, O) "
                              "merged at the end", _every(FWD_ROWS=64)),
    "forward 64-row blocks, deeper rings": (
        "64-row blocks with the room Q gives up (head dim 64 at 32 keys a stage, 4 deep), 4 stages at Dh 32",
        _edits(d16={"FWD_ROWS": 64}, d32={"FWD_STAGES": 4},
               d64={"FWD_ROWS": 64, "FWD_BK": 32, "FWD_STAGES": 4, "FWD_RAW": 2},
               d128={"FWD_ROWS": 64, "FWD_STAGES": 3})),
    "forward 128-row blocks at Dh 32": ("both consumers on every stage at head dim 32 too",
                                        _edits(d32={"FWD_ROWS": 128})),
    "forward half the keys a stage": ("FWD_BK halved (64 -> 32, 16 -> 8)",
                                      _edits(**{f"d{d}": {"FWD_BK": _trait(d, "FWD_BK") // 2} for d in SPLIT_DIMS})),
    "forward 32 keys a stage at Dh 64, three loading warpgroups": (
        "head dim 64 at 32 keys a stage, 3 stages behind 2 raw slots, 168 registers a consumer thread",
        _edits(d64={"FWD_BK": 32, "FWD_STAGES": 3, "FWD_RAW": 2, "FWD_LOADER_WGS": 3})),
    "forward 64 keys a stage at Dh 64, three loading warpgroups": (
        "168 registers a consumer thread: too few for 64 keys' P fragments (spills)",
        _edits(d64={"FWD_LOADER_WGS": 3})),
    "forward two-stage ring": ("FWD_STAGES 2 at every head dim", _every(FWD_STAGES=2)),
    "forward no raw slots": ("the forward's TMA into the stage, K split in place, V landing in a fifth tile",
                             _every(FWD_RAW=0)),
    "forward two loading warpgroups": ("224 threads split in the forward at head dims 16 and 32",
                                       _edits(d16={"FWD_LOADER_WGS": 2}, d32={"FWD_LOADER_WGS": 2})),
    "raw rows two k-steps at a time": ("head dim 256's register fragments of the block's raw rows split and "
                                       "waited for two k-steps at a time, not four",
                                       [(SOURCE, "  constexpr int G = 4;", "  constexpr int G = 2;")]),
    "raw rows, loaders at 48 registers": ("one loading warpgroup (head dim 256) at the others' 48 registers",
                                          [(SOURCE, "LOADER_REGS = LOADER_WGS == 1 ? 56 : 48;",
                                            "LOADER_REGS = 48;")]),
    "slices dQ 8 keys a stage": ("dQ's stages of 8 keys (score products of N 8), three of them",
                                 _slices(DQ_BK=8, DQ_STAGES=3)),
    "slices dQ 8 keys a stage, four stages": ("... and four: two a consumer", _slices(DQ_BK=8, DQ_STAGES=4)),
    "slices dK/dV two stages behind raw slots": ("dK/dV's ring two deep, TMA landing in two raw slots",
                                                 _slices(DKV_STAGES=2, DKV_RAW=2)),
    "slices two blocks read at once": ("a consumer reads two blocks' partials at a time, not four",
                                       _slices(READ_BLOCKS=2)),
    "slices scores a k-step a partial": ("the partial scores added in f32 every k-step", _slices(SCORE_STEPS=1)),
    "slices scores 4 k-steps a partial": ("... every four", _slices(SCORE_STEPS=4)),
    "slices scores chained": ("the partial scores chained in the tensor cores' accumulator over the whole slice",
                              _slices(SCORE_STEPS=16)),
    "slices no wait": ("timing only: the partials read without waiting for the other blocks'",
                       [(HEADER, SLICE_WAIT, "")]),
    "slices no reads": ("timing only: each block keeps its own partial (no distributed shared memory read)",
                        [(HEADER, SLICE_READS, "  auto add_group = [&](int r0) {\n    return;")]),
    "slices off": ("the column windows at every head dim above 256 (the route before the slices)",
                   [(SOURCE, "struct SliceTiles {\n  static constexpr int SLICE = 128, MAX_SLICES = 8;",
                     "struct SliceTiles {\n  static constexpr int SLICE = 128, MAX_SLICES = 2;")]),
    "fwd32 16 keys a stage, three stages": ("stages of 16 keys, the ring three deep", _fwd(32, BK=16, STAGES=3)),
    "fwd32 two blocks read at once": ("a consumer reads two blocks' partials at a time, not four",
                                      _fwd(32, READ_BLOCKS=2)),
    "fwd32 scores 4 k-steps a partial": ("the partial scores added in f32 every four k-steps, not two",
                                         _fwd(32, SCORE_STEPS=4)),
    "fwd32 no wait": ("timing only: the partials read without waiting for the other blocks'",
                      [(HEADER, SLICE_WAIT, "")]),
    "fwd32 no reads": ("timing only: each block keeps its own partial (no distributed shared memory read)",
                       [(HEADER, SLICE_READS, "  auto add_group = [&](int r0) {\n    return;")]),
    "fwd32 off": ("the column windows at every head dim above 256 (their earlier route)", _fwd(32, MAX_SLICES=2)),
    "fwd16 32 keys a stage, three stages": ("stages of 32 keys, the ring three deep", _fwd(16, BK=32, STAGES=3)),
    "fwd16 32 keys a stage, four stages": ("... four deep", _fwd(16, BK=32, STAGES=4)),
    "fwd16 slices of 128": ("blocks of 128 columns (twice the blocks and reads), one consumer warpgroup of 64 rows "
                            "(K holds one partial), clusters of up to eight", _fwd(16, SLICE=128, ROWS=64, MAX_SLICES=8)),
    "fwd16 two blocks read at once": ("a consumer reads two blocks' partials at a time, not one",
                                      _fwd(16, READ_BLOCKS=2)),
    "fwd16 no wait": ("timing only: the partials read without waiting for the other blocks'",
                      [(HEADER, SLICE_WAIT, "")]),
    "fwd16 no reads": ("timing only: each block keeps its own partial (no distributed shared memory read)",
                       [(HEADER, SLICE_READS, "  auto add_group = [&](int r0) {\n    return;")]),
    "fwd16 off": ("the column windows at every head dim above 256 (their earlier route)", _fwd(16, MAX_SLICES=1)),
}
TIMING_ONLY = ("slices no wait", "slices no reads", "fwd32 no wait", "fwd32 no reads", "fwd16 no wait",
               "fwd16 no reads")
# (B, T, H, Dh, causal): gpt2-small in f32 at B 8 (phase 14's attention),
# its width as 6 heads of 128, the f32 ring's Dh 32 diagonal and earlier
# blocks, and its width as 3 heads of 256 (phase 14's f32 Dh 256 run).
SHAPES = [(8, 1024, 12, 64, True), (8, 1024, 6, 128, True), (2, 1024, 4, 32, True), (2, 1024, 4, 32, False),
          (8, 1024, 3, 256, True)]
CHECK_SHAPES = [(1, 200, 2, 64, True), (1, 200, 2, 128, True), (1, 130, 2, 32, False), (1, 130, 4, 16, True),
                (2, 16, 4, 32, True), (1, 200, 2, 256, True)]
F32, MIX = (torch.float32,) * 3, (torch.bfloat16, torch.float32, torch.bfloat16)
# (B, T, H, Dh, causal, (q, k, v) dtypes with dO in q's) of the "slices"
# variants: chip_smoke.py's timed WIDE_CASES that reach the slices (f32 at
# 384 and 512, the mix at 320), and f32 at 320 (the mix's width unrounded);
# checked only: clusters of 5, 6 and 8 blocks.
SLICE_SHAPES = [(8, 1024, 2, 384, True, F32), (8, 1024, 2, 512, True, F32), (8, 1024, 2, 320, True, MIX),
                (8, 1024, 2, 320, True, F32)]
SLICE_CHECKS = [(2, 200, 2, 520, False, F32), (2, 256, 1, 768, False, F32), (1, 256, 1, 1024, True, F32)]
BF16, F16 = (torch.bfloat16,) * 3, (torch.float16,) * 3
# (B, T, Tk, H, Dh, causal, (q, k, v) dtypes, f32 outputs) of the forward
# variants: the forward cases chip_smoke.py times (PERF.md's column-window table),
# f32 and mixed, or 16-bit; checked only: ragged, non-causal and the widest
# clusters.
FWD32_SHAPES = [(8, 1024, 1024, 2, 384, True, F32, False), (8, 1024, 1024, 2, 512, True, F32, False),
                (8, 1024, 1024, 2, 320, True, MIX, False)]
FWD16_SHAPES = [(32, 1024, 1024, 3, 264, True, BF16, False), (32, 1024, 1024, 2, 384, True, BF16, False),
                (32, 1024, 1024, 1, 768, True, BF16, False), (8, 1024, 1024, 2, 512, True, BF16, False),
                (8, 1024, 1024, 1, 1024, True, BF16, False), (32, 1024, 1024, 2, 384, True, F16, False),
                (32, 1024, 1024, 2, 384, True, BF16, True)]
FWD_CHECKS = {32: [(2, 200, 333, 2, 520, False, F32, False), (1, 256, 256, 1, 1024, True, F32, False),
                   (1, 300, 300, 2, 768, True, MIX, False)],
              16: [(2, 200, 333, 2, 384, False, BF16, False), (1, 256, 256, 1, 1024, True, BF16, False),
                   (2, 1000, 1000, 2, 264, True, F16, True), (2, 300, 1100, 2, 264, False, BF16, False)]}
GRAD_RELNORM = 1e-4
FWD_RELNORM, LSE_TOL = 1e-5, 1e-5
VARIANT_SECONDS = 180


def sources(name: str) -> dict:
    """The variant's source files {file name: text}; raises KeyError on an
    edit that does not apply to the current sources."""
    files = {f.name: f.read_text() for f in [*sorted(_build.CSRC.glob("*.cu")), *sorted(_build.CSRC.glob("*.cuh"))]}
    for f, old, new in VARIANTS[name][1]:
        if old not in files[f]:
            raise KeyError(f"{name}: the text to edit is not in {f}: {old[:60]!r}")
        files[f] = files[f].replace(old, new)
    return files


def _dir(name: str) -> Path:
    return _build.BUILD_DIR / "sweep_f32" / re.sub(r"[^\w-]", "_", name)


# The libraries a variant of each family builds: (file, source, library name).
TARGETS = {"instances": [("lib.so", SOURCE, "flash_attention_f32")],
           "slices": [("lib.so", SOURCE, "flash_attention_f32"), ("mixed.so", MIXED_SOURCE, "flash_attention_mixed")],
           "fwd32": [("lib.so", SOURCE, "flash_attention_f32"), ("mixed.so", MIXED_SOURCE, "flash_attention_mixed")],
           "fwd16": [("bf16.so", SOURCE16, "flash_attention"), ("f16.so", F16_SOURCE, "flash_attention_f16")]}


def build(name: str, families=("instances",)) -> str:
    """Compile the variant into its own directory, the libraries of its
    ``families`` at once (TARGETS); returns nvcc's spill lines (or its
    error), and the slices kernels' register lines."""
    d = _dir(name)
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f, text in sources(name).items():
        (d / f).write_text(text)
    targets = list(dict.fromkeys((so, src) for fam in families for so, src, _ in TARGETS[fam]))
    slices = any(fam != "instances" for fam in families)
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / so), str(d / src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for so, src in targets]
    outs = [proc.communicate()[0] for proc in procs]
    for proc, out in zip(procs, outs):
        if proc.returncode:
            return "build failed: " + out[-2000:]
    lines, kernel = [], None
    for (so, _), out in zip(targets, outs):
        for line in out.splitlines():
            if "Compiling entry" in line or "Function properties for" in line:
                kernel = re.search(r"flash_(?:f32_)?(fwd|dq|dkv)_slices_kernel", line)
            if ("spill" in line and " 0 bytes spill stores" not in line) or "C751" in line:
                lines.append(line.strip())
            elif slices and kernel and "registers" in line:
                lines.append(f"{so} {kernel[1]} slices: {line.split(':', 1)[-1].strip()}")
    return "; ".join(lines)


def _inputs(B, T, H, D, causal, seed=5):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(B * H, T, D, device="cuda", generator=g) for _ in range(4))
    o, lse = fa.flash_fwd_reference(q, k, v, causal)
    return q, k, v, do, lse, (do * o).sum(-1)


def _device_ms(calls: dict, kernel_names: str) -> dict:
    """Device ms per call of each of ``calls`` ({kernel: call}) from one
    torch.profiler window of 10 rounds: the kernels whose names match
    ``kernel_names`` (a pattern with {kernel} in it), added up per call."""
    from torch.profiler import ProfilerActivity, profile

    rounds = 10
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for call in calls.values():
                call()
        torch.cuda.synchronize()
    totals = dict.fromkeys(calls, 0.0)  # a call's kernels added up (dK/dV's two passes at Dh 256)
    for ev in prof.key_averages():
        for kernel in calls:
            if re.search(kernel_names.format(kernel=kernel), ev.key):
                totals[kernel] += getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
    return {kernel: total / rounds / 1e3 for kernel, total in totals.items()}


def measure_slices(name: str) -> dict:
    """In this process: the variant's dQ and dK/dV above head dim 256
    against the plain versions at SLICE_CHECKS and SLICE_SHAPES (each
    output's relative norm under "gaps"), dQ's bits twice, then at
    SLICE_SHAPES their event and device ms and SDPA's backward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {lib: ctypes.CDLL(str(_dir(name) / so))
            for lib, so in (("flash_attention_f32", "lib.so"), ("flash_attention_mixed", "mixed.so"))}
    real = _build.load
    _build.load = lambda n, defines=(): libs.get(n) or real(n, defines)
    out = {"relnorm": 0.0, "fwd relnorm": 0.0, "lse": 0.0, "rule": True, "gaps": {}}
    for B, T, H, D, causal, dtypes in SLICE_CHECKS + SLICE_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(D)
        q, k, v, do = (torch.randn(B * H, T, D, device="cuda", generator=g).to(t) for t in (*dtypes, dtypes[0]))
        o, lse = fa.flash_fwd_reference(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1)
        got = [fa.flash_dq(q, k, v, do, lse, delta, causal), *fa.flash_dkv(q, k, v, do, lse, delta, causal)]
        out["rule"] &= torch.equal(got[0], fa.flash_dq(q, k, v, do, lse, delta, causal))
        key = f"d{D} {'mixed' if len(set(dtypes)) > 1 else 'f32'}{'' if causal else ' full'}"
        out["gaps"][key] = {}
        for n, a, b in zip(("dq", "dk", "dv"), got, fa.flash_bwd_reference(q, k, v, do, lse, delta, causal)):
            gap = bench.disagreement(a, b)
            out["gaps"][key][n] = gap["relnorm"]
            if a.dtype == torch.float32:
                out["relnorm"] = max(out["relnorm"], gap["relnorm"])
            else:
                out["rule"] &= gap["ok"]
        if (B, T, H, D, causal, dtypes) in SLICE_CHECKS:
            continue
        calls = {"dq": lambda: fa.flash_dq(q, k, v, do, lse, delta, causal),
                 "dkv": lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal)}
        for kernel, call in calls.items():
            out[f"{kernel} {key} ms"] = bench.time_ms(call)
        for kernel, ms in _device_ms(calls, r"flash_(f32|wide)_{kernel}_(slices_)?kernel").items():
            out[f"{kernel} {key} device ms"] = ms
        out[f"dq + dkv {key} ms"] = out[f"dq {key} ms"] + out[f"dkv {key} ms"]
        qs, ks, vs = (x.float().view(B, H, T, D).detach().requires_grad_() for x in (q, k, v))
        att = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        dos = do.float().view(B, H, T, D)
        out[f"SDPA backward {key} ms"] = bench.time_ms(
            lambda: torch.autograd.grad(att, (qs, ks, vs), dos, retain_graph=True))
        del q, k, v, do, lse, delta, got, qs, ks, vs, att, dos
    _build.load = real
    return out


def measure_fwd(name: str, bits: int) -> dict:
    """In this process: the variant's forward above head dim 256 against
    the plain version at FWD_CHECKS and the FWD<bits>_SHAPES, o's bits
    twice, then at the shapes its event and device ms and SDPA's forward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    family = f"fwd{bits}"
    libs = {lib: ctypes.CDLL(str(_dir(name) / so)) for so, _, lib in TARGETS[family]}
    real = _build.load
    _build.load = lambda n, defines=(): libs.get(n) or real(n, defines)
    shapes = FWD32_SHAPES if bits == 32 else FWD16_SHAPES
    # lse: the f32 kernels' limit, or the 16-bit ones' (chip_smoke.py's)
    out = {"relnorm": 0.0, "fwd relnorm": 0.0, "lse": 0.0, "lse_tol": LSE_TOL if bits == 32 else 1e-4, "rule": True,
           "gaps": {}}
    for B, T, Tk, H, D, causal, dtypes, out_f32 in FWD_CHECKS[bits] + shapes:
        g = torch.Generator(device="cuda").manual_seed(D)
        q = torch.randn(B * H, T, D, device="cuda", generator=g).to(dtypes[0])
        k, v = (torch.randn(B * H, Tk, D, device="cuda", generator=g).to(t) for t in dtypes[1:])
        o, lse = fa.flash_fwd(q, k, v, causal, out_f32=out_f32)
        again = fa.flash_fwd(q, k, v, causal, out_f32=out_f32)[0]
        out["rule"] &= torch.equal(o, again)
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, out_f32)
        gap = bench.disagreement(o, o_ref)
        key = (f"d{D} {'mixed' if len(set(dtypes)) > 1 else str(dtypes[0]).removeprefix('torch.')}"
               f"{'->f32' if out_f32 else ''}{'' if causal else ' full'} B{B} H{H}")
        out["gaps"][key] = {"o": gap["relnorm"]}
        if o.dtype == torch.float32 and dtypes[2] == torch.float32:
            out["fwd relnorm"] = max(out["fwd relnorm"], gap["relnorm"])
        else:
            out["rule"] &= gap["ok"]
        out["lse"] = max(out["lse"], (lse - lse_ref).abs().max().item())
        if (B, T, Tk, H, D, causal, dtypes, out_f32) in FWD_CHECKS[bits]:
            continue
        call = lambda: fa.flash_fwd(q, k, v, causal, out_f32=out_f32)  # noqa: E731
        out[f"fwd {key} ms"] = bench.time_ms(call)
        out[f"fwd {key} device ms"] = _device_ms({"fwd": call}, r"flash_(f32_|wide_)?{kernel}_(slices_)?kernel")["fwd"]
        like = torch.float32 if len(set(dtypes)) > 1 else dtypes[0]
        qs, ks, vs = (x.to(like).view(B, H, -1, D) for x in (q, k, v))
        with torch.no_grad():
            out[f"SDPA forward {key} ms"] = bench.time_ms(
                lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal))
        del q, k, v, o, again, o_ref, lse, lse_ref, qs, ks, vs
    _build.load = real
    return out


def measure(name: str) -> dict:
    """In this process: the variant's forward and gradients against the
    plain versions, then each kernel's event and device ms at SHAPES."""
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = ctypes.CDLL(str(_dir(name) / "lib.so"))
    real = _build.load
    _build.load = lambda n, defines=(): lib if n == "flash_attention_f32" else real(n, defines)
    out = {"relnorm": 0.0, "fwd relnorm": 0.0, "lse": 0.0}
    for B, T, H, D, causal in CHECK_SHAPES:
        q, k, v, do, lse, delta = _inputs(B, T, H, D, causal)
        got = [fa.flash_dq(q, k, v, do, lse, delta, causal), *fa.flash_dkv(q, k, v, do, lse, delta, causal)]
        ref = fa.flash_bwd_reference(q, k, v, do, lse, delta, causal)
        out["relnorm"] = max(out["relnorm"], *(bench.disagreement(a, b)["relnorm"] for a, b in zip(got, ref)))
        o, lse_k = fa.flash_fwd(q, k, v, causal)
        o_ref, _ = fa.flash_fwd_reference(q, k, v, causal)
        out["fwd relnorm"] = max(out["fwd relnorm"], bench.disagreement(o, o_ref)["relnorm"])
        out["lse"] = max(out["lse"], (lse_k - lse).abs().max().item())
    for B, T, H, D, causal in SHAPES:
        q, k, v, do, lse, delta = _inputs(B, T, H, D, causal)
        calls = {"fwd": lambda: fa.flash_fwd(q, k, v, causal),
                 "dq": lambda: fa.flash_dq(q, k, v, do, lse, delta, causal),
                 "dkv": lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal)}
        for kernel, call in calls.items():
            out[f"{kernel} Dh {D}{'' if causal else ' full'} ms"] = bench.time_ms(call)
        for kernel, ms in _device_ms(calls, "flash_f32_{kernel}_kernel").items():
            out[f"{kernel} Dh {D}{'' if causal else ' full'} device ms"] = ms
        del q, k, v, do, lse, delta
    return out


CHECKS = ("relnorm", "fwd relnorm", "lse", "lse_tol", "rule", "gaps")


def _ok(res: dict) -> bool:
    return (res["relnorm"] <= GRAD_RELNORM and res["fwd relnorm"] <= FWD_RELNORM
            and res["lse"] <= res.get("lse_tol", LSE_TOL) and res.get("rule", True))


def _family(name: str) -> str:
    return next((f for f in ("slices", "fwd32", "fwd16") if name.startswith(f)), "instances")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", nargs="*", default=None,
                    help="run only the variants whose names start with one of these (and the chosen one)")
    ap.add_argument("--measure", help=argparse.SUPPRESS)  # one variant, in a child process
    ap.add_argument("--family", default="instances", help=argparse.SUPPRESS)  # its shapes: "instances", "slices"
    args = ap.parse_args(argv)
    if args.measure:
        if args.family in ("fwd32", "fwd16"):
            res = measure_fwd(args.measure, int(args.family[3:]))
        else:
            res = measure_slices(args.measure) if args.family == "slices" else measure(args.measure)
        print(json.dumps(res), flush=True)
        return
    if not torch.cuda.is_available():
        sys.exit("sweep_flash_f32 needs an NVIDIA card")
    print(", ".join(bench.card()), flush=True)
    names = [n for n in VARIANTS if n == "chosen" or args.variants is None
             or any(n.startswith(prefix) for prefix in args.variants)]
    families = sorted({_family(n) for n in names if n != "chosen"}) or ["instances"]
    runs = [(n, f) for n in names for f in families if n == "chosen" or f == _family(n)]
    built = {n: [f for m, f in runs if m == n] for n in names}
    with ThreadPoolExecutor(len(names)) as pool:
        reports = dict(zip(names, pool.map(lambda n: build(n, built[n]), names)))
    for name, report in reports.items():
        print(f"build {name!r} ({VARIANTS[name][0]}): {report or 'no spill'}", flush=True)
    best = {}
    for rnd in range(args.rounds):
        for name, family in runs:
            if reports[name].startswith("build failed"):
                continue
            try:
                proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch.sweep_flash_f32", "--measure", name,
                                       "--family", family], capture_output=True, text=True, timeout=VARIANT_SECONDS)
                res = json.loads(proc.stdout.strip().splitlines()[-1]) if proc.returncode == 0 else None
            except subprocess.TimeoutExpired:
                print(f"round {rnd} {name!r}: no answer in {VARIANT_SECONDS} s", flush=True)
                continue
            if res is None:
                print(f"round {rnd} {name!r}: failed: {proc.stderr[-1500:]}", flush=True)
                continue
            ok = _ok(res)
            verdict = "timing only" if name in TIMING_ONLY else "ok" if ok else "WRONG"
            gaps = "; ".join(f"{case} " + ", ".join(f"{n} {g:.3e}" for n, g in per.items())
                             for case, per in res.get("gaps", {}).items())
            print(f"round {rnd} {name!r}: max relnorm of f32 outputs {res['relnorm']:.3e}, o {res['fwd relnorm']:.3e}, "
                  f"lse max abs {res['lse']:.3e}" + (f", relnorm {gaps}" if gaps else "")
                  + (f", 16-bit outputs by the rule and dQ's bits twice {res['rule']}" if "rule" in res else "")
                  + f" ({verdict}); " + ", ".join(f"{k} {v:.4f}" for k, v in res.items() if k not in CHECKS),
                  flush=True)
            for k, v in res.items():
                if (ok or name in TIMING_ONLY) and k not in CHECKS:
                    best[(name, k)] = min(best.get((name, k), math.inf), v)
    for name in reports:
        row = {k: v for (n, k), v in best.items() if n == name}
        if row:
            print(f"best {name!r}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)


if __name__ == "__main__":
    main()

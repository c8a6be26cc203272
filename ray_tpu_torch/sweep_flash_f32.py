"""Time design variants of the f32-operand flash kernels on the card.

    python3 -m ray_tpu_torch.sweep_flash_f32 [--rounds 2] [--variants NAME ...]

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

from ray_tpu_torch import bench
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as fa

SOURCE, HEADER = "flash_attention_f32.cu", "hopper.cuh"
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
}
# (B, T, H, Dh, causal): gpt2-small in f32 at B 8 (phase 14's attention),
# its width as 6 heads of 128, the f32 ring's Dh 32 diagonal and earlier
# blocks, and its width as 3 heads of 256 (phase 14's f32 Dh 256 run).
SHAPES = [(8, 1024, 12, 64, True), (8, 1024, 6, 128, True), (2, 1024, 4, 32, True), (2, 1024, 4, 32, False),
          (8, 1024, 3, 256, True)]
CHECK_SHAPES = [(1, 200, 2, 64, True), (1, 200, 2, 128, True), (1, 130, 2, 32, False), (1, 130, 4, 16, True),
                (2, 16, 4, 32, True), (1, 200, 2, 256, True)]
GRAD_RELNORM = 1e-4
FWD_RELNORM, LSE_TOL = 1e-5, 1e-5
VARIANT_SECONDS = 180


def sources(name: str) -> dict:
    """The variant's source files {file name: text}; raises KeyError on an
    edit that does not apply to the current sources."""
    files = {f.name: f.read_text() for f in [_build.CSRC / SOURCE, *sorted(_build.CSRC.glob("*.cuh"))]}
    for f, old, new in VARIANTS[name][1]:
        if old not in files[f]:
            raise KeyError(f"{name}: the text to edit is not in {f}: {old[:60]!r}")
        files[f] = files[f].replace(old, new)
    return files


def _dir(name: str) -> Path:
    return _build.BUILD_DIR / "sweep_f32" / name.replace(" ", "_").replace(".", "_")


def build(name: str) -> str:
    """Compile the variant into its own directory; returns nvcc's spill
    lines (or its error)."""
    d = _dir(name)
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f, text in sources(name).items():
        (d / f).write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode:
        return "build failed: " + (proc.stdout + proc.stderr)[-2000:]
    return "; ".join(line.strip() for line in (proc.stdout + proc.stderr).splitlines()
                     if ("spill" in line and " 0 bytes spill stores" not in line) or "C751" in line)


def _inputs(B, T, H, D, causal, seed=5):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(B * H, T, D, device="cuda", generator=g) for _ in range(4))
    o, lse = fa.flash_fwd_reference(q, k, v, causal)
    return q, k, v, do, lse, (do * o).sum(-1)


def measure(name: str) -> dict:
    """In this process: the variant's forward and gradients against the
    plain versions, then each kernel's event and device ms at SHAPES."""
    from torch.profiler import ProfilerActivity, profile

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
        rounds = 10
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(rounds):
                for call in calls.values():
                    call()
            torch.cuda.synchronize()
        totals = dict.fromkeys(calls, 0.0)  # a call's kernels added up (dK/dV's two passes at Dh 256)
        for ev in prof.key_averages():
            for kernel in calls:
                if f"flash_f32_{kernel}_kernel" in ev.key:
                    totals[kernel] += getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        for kernel, total in totals.items():
            out[f"{kernel} Dh {D}{'' if causal else ' full'} device ms"] = total / rounds / 1e3
        del q, k, v, do, lse, delta
    return out


def _ok(res: dict) -> bool:
    return res["relnorm"] <= GRAD_RELNORM and res["fwd relnorm"] <= FWD_RELNORM and res["lse"] <= LSE_TOL


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", nargs="*", default=None,
                    help="run only the variants whose names start with one of these (and the chosen one)")
    ap.add_argument("--measure", help=argparse.SUPPRESS)  # one variant, in a child process
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure(args.measure)), flush=True)
        return
    if not torch.cuda.is_available():
        sys.exit("sweep_flash_f32 needs an NVIDIA card")
    print(", ".join(bench.card()), flush=True)
    names = [n for n in VARIANTS if n == "chosen" or args.variants is None
             or any(n.startswith(prefix) for prefix in args.variants)]
    with ThreadPoolExecutor(len(names)) as pool:
        reports = dict(zip(names, pool.map(build, names)))
    for name, report in reports.items():
        print(f"build {name!r} ({VARIANTS[name][0]}): {report or 'no spill'}", flush=True)
    best = {}
    for rnd in range(args.rounds):
        for name, report in reports.items():
            if report.startswith("build failed"):
                continue
            try:
                proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch.sweep_flash_f32", "--measure", name],
                                      capture_output=True, text=True, timeout=VARIANT_SECONDS)
                res = json.loads(proc.stdout.strip().splitlines()[-1]) if proc.returncode == 0 else None
            except subprocess.TimeoutExpired:
                print(f"round {rnd} {name!r}: no answer in {VARIANT_SECONDS} s", flush=True)
                continue
            if res is None:
                print(f"round {rnd} {name!r}: failed: {proc.stderr[-1500:]}", flush=True)
                continue
            ok = _ok(res)
            checks = ("relnorm", "fwd relnorm", "lse")
            print(f"round {rnd} {name!r}: max relnorm dq/dk/dv {res['relnorm']:.3e}, o {res['fwd relnorm']:.3e}, "
                  f"lse max abs {res['lse']:.3e} ({'ok' if ok else 'WRONG'}); "
                  + ", ".join(f"{k} {v:.4f}" for k, v in res.items() if k not in checks), flush=True)
            for k, v in res.items():
                if ok and k not in checks:
                    best[(name, k)] = min(best.get((name, k), math.inf), v)
    for name in reports:
        row = {k: v for (n, k), v in best.items() if n == name}
        if row:
            print(f"best {name!r}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)


if __name__ == "__main__":
    main()

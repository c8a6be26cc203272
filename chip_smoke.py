"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. name the card and its power limit (nvidia-smi); build the CUDA kernels
     from ray_tpu_torch/ops/csrc with nvcc; count each kernel's wgmma
     (HGMMA) and TMA load (UTMALDG) instructions in the library's SASS
     (cuobjdump -sass), for each output type it is built for (bf16, f32),
     and fail if any of the three kernels lacks either in either;
  2. hold each kernel against its plain PyTorch version on the card, on bf16
     inputs from a seeded generator, at the train step's shape, at head dim
     16, at a ragged T, non-causal with Tk != Tq, and non-causal with Tk
     spanning more key tiles than the ring has stages (the ring wraps) and a
     ragged last tile, element by element
     (ray_tpu_torch.bench.disagreement); call dQ twice at the train step's
     shape and fail unless both give the same bits (no atomics, no
     dependence on run order); hold the autograd Function at the
     train step's [B, T, H, Dh] against reference attention; time each
     kernel at the train step's shape beside its bound, its plain version
     and the library's attention (F.scaled_dot_product_attention, a
     yardstick only);
  3. train gpt2-small at full width through the port's entry points
     (ray_tpu_torch.bench.setup: random init from a seeded generator,
     AdamW, flash attention, fused CE, B=32, T=1024): first hold step 0's
     loss and every parameter's gradient against the same model and batch
     with reference attention, then take a few steps: losses finite, step 0
     near ln(vocab), 12 launches of each kernel per step. Then the remat
     policies: the same model (fresh, the same seed) with no remat and under
     each of the four policies (full, dots, dots_saveable, attn_out): step
     0's loss and every gradient against no remat's (bitwise equal or not,
     and within the gradient limit), the median of 3 steps after a warm-up
     step, the device busy time of one more step (torch.profiler), peak
     memory and each kernel's launches per step, which must be the design's
     (12 of each without remat; under every policy the forward runs again
     in the backward: 24 forward, 12 dQ, 12 dK/dV);
  4. serve gpt2-small at full width and depth (bf16, random init from a
     seeded generator) through the port's LLMServer with the engine's
     default flags (paged KV, async decode, chunked prefill; pages of 64
     tokens, max_batch_size 8: 129 pages, 32 decode rows). First hold
     prefill plus 32 decode steps (slot and paged functions) against
     GPT2.forward at the same positions, in bf16 and in f32, and check
     that the f32 limit sees a planted fault (one paged step through a
     page table reversed after prefill). Then 24 requests at once from
     threads (prompts of 64-896 tokens from a seeded generator, 8 sharing a
     512-token prefix, 64 new tokens each, 4 at temperature 0.8, 2
     streaming): every answer has 64 tokens in the vocabulary, and every
     greedy token is within a margin of its position's maximum logit under
     GPT2.forward on the same sequence. Then, request by request on fresh
     engines: sync and async streams equal, paged and slot greedy streams
     equal (or a near tie under the same margin at the first divergence),
     a prefix hit equal to the cold run with no block copy; the drained
     pool holds only sealed prefix pages before unload. Prints TTFT p50
     and p95, output tokens/s, the decode step's wall, CUDA-event and
     device-busy times (torch.profiler) and peak memory. Serving launches
     none of the three kernels: the phase checks that their counts stay 0;
  5. context and expert parallelism: each kernel's f32-output instantiation
     (ring attention's block entries) against its plain version at the
     ring's block shapes (B 2, 4,096 q rows, H 12: the causal diagonal
     block, an earlier non-causal block, a ragged one with 1,000 keys, and
     Dh 16), timed beside the bf16 instantiation; ring attention over 4
     ranks emulated on the card at gpt2-small's attention widths (B 2, T
     16,384, H 12, Dh 64, bf16, causal) through the ring's step functions,
     held against the monolithic flash attention, with 10 f32 launches of
     each kernel (4 diagonal + 6 earlier blocks); attention(impl="ring") on
     a real NCCL group of one rank; moe_block on that group against
     moe_block_local at gpt2-small's MLP widths (D 768, F 3,072, 8 experts,
     top-2, 4,096 tokens, capacity 1,280), forward and the gradients of all
     four inputs. Prints the ring's forward and backward times (CUDA
     events), their device time in and outside the kernels (torch.profiler),
     the monolithic flash attention's and SDPA's at T 16,384, and
     moe_block's;
  6. the sharded train step: gpt2-small at full width (phase 3's model,
     batch and optimizer) through build_mesh, shard_model (gpt_rules) and
     make_train_step on a mesh of one rank over NCCL (every axis of size 1;
     a file store in a temporary directory, destroyed after): step 0's loss
     and every parameter after one AdamW step against the unsharded step on
     the same init and batch, then 3 steps: the median, device busy time and
     peak memory beside phase 3's unsharded figures, and 12 launches of each
     kernel per step. One card takes one NCCL rank, so dp, fsdp and tp above 1 are
     held only by the CPU tests (tests/test_torch_sharded_step.py, gloo);
  7. print the kernel line (one JSON object; beside the contract's keys,
     each kernel's SASS counts from phase 1 for both output types, and its
     f32 instantiation's gap, times and ring launches from phase 5: every
     number in it was measured or, for bound_ms, computed in this run, and
     launches come from phase 3);
  8. print the contract line (one JSON object, the last line).

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# Published dense peaks of an H100 SXM (NVIDIA data sheet; the card at its
# full 700 W power limit): bf16 tensor-core FLOP/s and HBM3 bytes/s.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# (B, T, Tk, H, Dh, causal): the train step's shape first.
MAIN_CASE = (32, 1024, 1024, 12, 64, True)
CASES = [MAIN_CASE, (4, 512, 512, 4, 16, True), (2, 1000, 1000, 12, 64, True),
         (2, 200, 333, 4, 64, False), (2, 300, 1100, 4, 64, False)]
# Kernels vs plain versions: every output element by the rule of
# ray_tpu_torch.bench (RTOL relative, ATOL_RMS x the row's rms absolute,
# RELNORM_TOL on the whole tensor). On an H100 the cases below need at most
# 9.5e-3 of the row rms (limit 2e-2) and 2.0e-3 in relative norm (limit
# 1e-2). lse is f32 in both, summed in other orders: within LSE_TOL
# absolute (the gap measured there is 9.5e-7).
LSE_TOL = 1e-4

N_STEPS = 5
# Flash vs reference attention on one init and batch, both bf16: step 0's
# loss within LOSS_REF_TOL (gap measured on an H100: 6.4e-5), each
# parameter's gradient within GRAD_RELNORM_TOL of the reference's in
# relative norm (measured: median 9.0e-3, max 1.40e-2; the two round
# attention differently and the difference grows through 12 layers).
LOSS_REF_TOL = 5e-4
GRAD_RELNORM_TOL = 2e-2
LOSS_INIT_TOL = 0.5   # step-0 loss vs ln(vocab): random init is near uniform

KERNELS = {
    "flash_fwd": "ray_tpu/ops/flash_attention.py:72",
    "flash_dq": "ray_tpu/ops/flash_attention.py:135",
    "flash_dkv": "ray_tpu/ops/flash_attention.py:168",
}
SOURCE = "ray_tpu_torch/ops/csrc/flash_attention.cu"
# The first versions' times at the train step's shape, before the Hopper
# redesign (chip_smoke.py phase 2, median of 20 calls; PERF.md section 6,
# NVIDIA H100 80GB HBM3 at 700 W). Recorded, not measured here: printed as
# text beside this run's times, and kept out of the kernel line.
BEFORE_REDESIGN_MS = {"flash_fwd": 0.5302, "flash_dq": 0.6775, "flash_dkv": 1.0951}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _zero_launches() -> None:
    """Set every kernel launch count to 0: just before a path is driven."""
    from ray_tpu_torch.ops import flash_attention as fa

    for counts in (fa.launches, fa.launches_f32):
        for name in counts:
            counts[name] = 0


def _launch_counts() -> tuple:
    """(launches, f32 launches) per kernel: read just after the path."""
    from ray_tpu_torch.ops import flash_attention as fa

    return dict(fa.launches), dict(fa.launches_f32)


def _device_kernels(prof, what: str) -> list:
    """The kernels, copies and fills of a torch.profiler trace
    (``bench.device_kernels``); fails if there are none."""
    from ray_tpu_torch import bench

    kernels = bench.device_kernels(prof)
    if not kernels:
        fail(f"the profiler recorded no device time for {what}")
    return kernels


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------


def identify() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    return smi


def build() -> dict:
    """Build the kernels, print nvcc's register and spill report, and return
    each kernel's SASS instruction counts (``sass_counts``)."""
    import ray_tpu_torch
    from ray_tpu_torch.ops import _build

    if Path(ray_tpu_torch.__file__).resolve().parent.parent != Path(__file__).resolve().parent:
        fail(f"ray_tpu_torch comes from {ray_tpu_torch.__file__}, not from this checkout")
    t0 = time.perf_counter()
    path = _build.build("flash_attention")
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    log = path.with_name(path.name + ".log")
    for line in log.read_text().splitlines() if log.exists() else []:
        if any(w in line for w in ("registers", "spill", "Compiling entry", "warning", "setmaxnreg")):
            print(f"  {line.strip()}")
    counts = sass_counts(path)
    for name, by_type in counts.items():
        for out, c in by_type.items():
            print(f"sass {name} ({out} output): HGMMA {c['hgmma']}, UTMALDG {c['utmaldg']}",
                  flush=True)
    for name in KERNELS:  # every kernel is a Hopper one: wgmma fed by TMA, in both instantiations
        for out, c in counts[name].items():
            if not (c["hgmma"] > 0 and c["utmaldg"] > 0):
                fail(f"{name} ({out} output) issues no wgmma or no TMA load in its SASS: {c}")
    return counts


SASS_OPS = {"hgmma": "HGMMA", "utmaldg": "UTMALDG"}
OUT_TYPES = {"13__nv_bfloat16": "bf16", "f": "f32"}  # the output type's mangled name


def sass_counts(lib: Path) -> dict:
    """HGMMA and UTMALDG instructions per kernel and output type (both
    head-dim instances summed) in the SASS of the built library, read with
    cuobjdump: {name: {"bf16": {...}, "f32": {...}}}."""
    from ray_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts = {name: {out: dict.fromkeys(SASS_OPS, 0) for out in OUT_TYPES.values()}
              for name in KERNELS}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.search(rf"({'|'.join(KERNELS)})_kernelILi\d+E({'|'.join(OUT_TYPES)})E", line)
            current = counts[found[1]][OUT_TYPES[found[2]]] if found else None
        elif current is not None:
            for key, op in SASS_OPS.items():
                current[key] += bool(re.search(rf"\b{op}\b", line))
    return counts


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------


def _visible_pairs(Tq: int, Tk: int, causal: bool) -> int:
    return Tq * (Tq + 1) // 2 if causal else Tq * Tk


def bounds(B, T, Tk, H, D, causal, out_bytes=2):
    """Least time (ms) for each kernel's work on this card's published
    peaks: (ms, "bytes" | "operations"). Each input (bf16) read once, each
    output (``out_bytes`` per element: 2 for bf16, 4 for f32) written once;
    products counted over the (q, k) pairs the mask keeps."""
    BH, pairs = B * H, _visible_pairs(T, Tk, causal)
    q_bytes, kv_bytes, row_bytes = BH * T * D * 2, BH * Tk * D * 2, BH * T * 4
    q_out, kv_out = q_bytes * out_bytes // 2, kv_bytes * out_bytes // 2
    work = {  # name: (flops, bytes)
        "flash_fwd": (4 * BH * pairs * D, q_bytes + 2 * kv_bytes + q_out + row_bytes),
        "flash_dq": (6 * BH * pairs * D, 2 * q_bytes + 2 * kv_bytes + q_out + 2 * row_bytes),
        "flash_dkv": (8 * BH * pairs * D, 2 * q_bytes + 2 * kv_bytes + 2 * kv_out + 2 * row_bytes),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def check_kernels(card: str) -> dict:
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import flash_attention as fa

    results = {}
    for case in CASES:
        B, T, Tk, H, D, causal = case
        g = torch.Generator(device="cuda").manual_seed(1234)
        bf = dict(device="cuda", dtype=torch.bfloat16, generator=g)
        q = torch.randn(B * H, T, D, **bf)
        k = torch.randn(B * H, Tk, D, **bf)
        v = torch.randn(B * H, Tk, D, **bf)
        do = torch.randn(B * H, T, D, **bf)

        o, lse = fa.flash_fwd(q, k, v, causal)
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
        delta = (do.float() * o_ref.float()).sum(-1)
        dq = fa.flash_dq(q, k, v, do, lse_ref, delta, causal)
        dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, causal)
        dq_ref, dk_ref, dv_ref = fa.flash_bwd_reference(q, k, v, do, lse_ref, delta, causal)
        torch.cuda.synchronize()

        where = f"B={B} T={T} Tk={Tk} H={H} Dh={D} causal={causal}"
        gaps = {name: bench.disagreement(got, ref) for name, got, ref in
                [("o", o, o_ref), ("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)]}
        errs = {name: g["max_abs"] for name, g in gaps.items()}
        lse_err = (lse - lse_ref).abs().max().item()
        print(f"kernels vs plain at {where}: " + _gap_text(gaps) + f"; lse max abs {lse_err:.3e}",
              flush=True)
        bad = [name for name, g in gaps.items() if not g["ok"]]
        if bad:
            fail(f"{', '.join(bad)} disagree with the plain version at {where} "
                 f"(limits: {_rule()})")
        if not lse_err <= LSE_TOL:  # also catches NaN
            fail(f"lse disagrees at {where}: max abs err {lse_err:.3e} > {LSE_TOL}")

        if case != MAIN_CASE:
            continue
        again = fa.flash_dq(q, k, v, do, lse_ref, delta, causal)
        if not torch.equal(dq, again):
            fail(f"two flash_dq calls at {where} differ: "
                 f"{(dq.float() - again.float()).abs().max().item():.3e} max abs")
        print(f"flash_dq at {where}: two calls give the same bits", flush=True)
        del again
        bnd = bounds(*case)
        ms = {
            "flash_fwd": bench.time_ms(lambda: fa.flash_fwd(q, k, v, causal)),
            "flash_dq": bench.time_ms(lambda: fa.flash_dq(q, k, v, do, lse, delta, causal)),
            "flash_dkv": bench.time_ms(lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal)),
        }
        plain_ms = {
            "flash_fwd": bench.time_ms(lambda: fa.flash_fwd_reference(q, k, v, causal), iters=5),
            "flash_dq": bench.time_ms(lambda: fa.flash_dq_reference(q, k, v, do, lse, delta, causal), iters=5),
            "flash_dkv": bench.time_ms(lambda: fa.flash_dkv_reference(q, k, v, do, lse, delta, causal), iters=5),
        }
        # The library's attention on the same inputs, [B, H, T, Dh] views.
        qs, ks, vs = (x.view(B, H, -1, D).detach().requires_grad_() for x in (q, k, v))
        dos = do.view(B, H, T, D)
        with torch.no_grad():
            sdpa_fwd = bench.time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        sdpa_bwd = bench.time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True))
        sdpa_both = bench.time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal), (qs, ks, vs), dos))
        library = {"flash_fwd": sdpa_fwd, "flash_dq": sdpa_bwd, "flash_dkv": sdpa_bwd}
        err_of = {"flash_fwd": errs["o"], "flash_dq": errs["dq"],
                  "flash_dkv": max(errs["dk"], errs["dv"])}
        for name in KERNELS:
            results[name] = {
                "max_abs_err": err_of[name], "ms": ms[name], "plain_ms": plain_ms[name],
                "bound_ms": bnd[name][0], "bound_by": bnd[name][1], "library_ms": library[name],
            }
            print(f"time {name} at B={B} T={T} H={H} Dh={D} causal: kernel {ms[name]:.4f} ms, "
                  f"bound {bnd[name][0]:.4f} ms ({bnd[name][1]}), plain {plain_ms[name]:.4f} ms, "
                  f"library {library[name]:.4f} ms"
                  + (f", before the redesign {BEFORE_REDESIGN_MS[name]:.4f} ms "
                     "(PERF.md, not this run)" if name in BEFORE_REDESIGN_MS else "")
                  + f" [{card}]", flush=True)
        print(f"library: sdpa forward {sdpa_fwd:.4f} ms, backward (dq, dk and dv in one call) "
              f"{sdpa_bwd:.4f} ms, forward+backward {sdpa_both:.4f} ms [{card}]", flush=True)
        del qs, ks, vs, out
        check_autograd(q, k, v, do, B, H)
    return results


def _gap_text(gaps: dict) -> str:
    return ", ".join(f"{n} max abs {g['max_abs']:.3e} atol/rms {g['atol_rms']:.2e} "
                     f"relnorm {g['relnorm']:.2e}" for n, g in gaps.items())


def check_autograd(q, k, v, do, B: int, H: int) -> None:
    """The autograd Function (fold, kernels, delta, unfold) at the train
    step's [B, T, H, Dh] layout against reference attention's autograd, on
    the same bf16 inputs. The reference rounds at other places (normalised
    p to bf16, dP to bf16 in the backward), so elements that cancel differ
    by more than the kernels' rule allows: each output is held to it in
    relative norm only (RELNORM_TOL)."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops.attention import attention

    def model_layout(x):  # [B*H, T, Dh] -> [B, T, H, Dh], a leaf
        return x.view(B, H, -1, x.shape[-1]).transpose(1, 2).detach().requires_grad_()

    outs = {}
    for impl in ("flash", "reference"):
        qs, ks, vs = (model_layout(x) for x in (q, k, v))
        out = attention(qs, ks, vs, causal=True, impl=impl)
        out.backward(do.view(B, H, -1, do.shape[-1]).transpose(1, 2))
        outs[impl] = (out.detach(), qs.grad, ks.grad, vs.grad)
        del qs, ks, vs, out
    gaps = {name: bench.disagreement(got, want) for name, got, want in
            zip(("o", "dq", "dk", "dv"), outs["flash"], outs["reference"])}
    print("flash_attention (autograd) vs reference attention at [B, T, H, Dh] = "
          f"{list(outs['flash'][0].shape)}: " + _gap_text(gaps), flush=True)
    bad = [name for name, g in gaps.items() if not g["relnorm"] <= bench.RELNORM_TOL]
    if bad:
        fail(f"flash_attention's {', '.join(bad)} disagree with reference attention "
             f"(relnorm > {bench.RELNORM_TOL})")


def _rule() -> str:
    from ray_tpu_torch import bench

    return (f"|err| <= {bench.RTOL:.3e} |ref| + {bench.ATOL_RMS} rms(ref), "
            f"relnorm <= {bench.RELNORM_TOL}")


# ---------------------------------------------------------------------------
# Phase 3
# ---------------------------------------------------------------------------


def check_gradients(run, card: str) -> float:
    """Step 0's loss and every parameter's gradient through the flash
    kernels against the same model and batch with reference attention.
    Leaves the model's gradients unset. Returns the flash path's loss."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import gpt2

    model, tokens = run.model, run.batches[0]
    losses, grads = {}, {}
    for impl in ("flash", "reference"):
        model.zero_grad(set_to_none=True)
        loss = gpt2.loss_fn(model, tokens, dataclasses.replace(run.cfg, attn_impl=impl))
        loss.backward()
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    rel = bench.relnorms(grads["flash"], grads["reference"])
    worst = sorted(rel.items(), key=lambda kv: -kv[1])
    print(f"step 0 flash vs reference attention: loss {losses['flash']:.6f} vs "
          f"{losses['reference']:.6f} (gap {abs(losses['flash'] - losses['reference']):.3e}); "
          f"gradient relnorm over {len(rel)} leaves: max {worst[0][1]:.3e} ({worst[0][0]}), "
          f"median {statistics.median(rel.values()):.3e} [{card}]", flush=True)
    print("  largest: " + ", ".join(f"{n} {r:.3e}" for n, r in worst[:6]))
    if not abs(losses["flash"] - losses["reference"]) <= LOSS_REF_TOL:
        fail(f"step-0 loss {losses['flash']} vs reference attention {losses['reference']}: "
             f"> {LOSS_REF_TOL}")
    zero = [n for n, g in grads["flash"].items() if n not in rel and g.norm().item() > 0]
    bad = [n for n, r in rel.items() if not r <= GRAD_RELNORM_TOL] + zero
    if bad:
        fail(f"gradients of {bad} disagree with reference attention "
             f"(relnorm > {GRAD_RELNORM_TOL})")
    return losses["flash"]


def train(card: str) -> dict:
    from ray_tpu_torch import bench

    run = bench.setup(N_STEPS)
    cfg, B, T = run.cfg, bench.BATCH, bench.SEQ
    n_params = sum(p.numel() for p in run.model.parameters())
    flash_loss = check_gradients(run, card)

    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    losses, times = [], []
    for tokens in run.batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = run.step(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts, counts_f32 = _launch_counts()

    print(f"train {bench.MODEL} B={B} T={T} ({n_params} params): losses "
          + ", ".join(f"{x:.5f}" for x in losses)
          + f"; step 0 in the gradient check {flash_loss:.5f}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > LOSS_INIT_TOL:
        fail(f"step-0 loss {losses[0]} far from ln(vocab) = {math.log(cfg.vocab_size):.4f}")
    want = cfg.n_layer * N_STEPS
    for name, n in counts.items():
        if n != want:
            fail(f"{name} launched {n} times in {N_STEPS} steps, expected {want}")
    if any(counts_f32.values()):
        fail(f"the train step launched f32 instances: {counts_f32}")
    step_ms = statistics.median(times[1:]) * 1e3
    tok_s = B * T / (step_ms / 1e3)
    print(f"train step: median {step_ms:.2f} ms over steps 1..{N_STEPS - 1} (step 0 "
          f"{times[0] * 1e3:.2f} ms), {tok_s:.1f} tokens/s, launches {counts}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)
    return counts


# The remat runs: None is no remat. Each takes a fresh model (the same seed)
# through a gradient check on batch 0, a warm-up step (the optimizer's state
# is made at its first step) and REMAT_STEPS timed steps.
REMAT_RUNS = (None, "full", "dots", "dots_saveable", "attn_out")
REMAT_STEPS = 3


def design_launches(cfg, remat: bool) -> dict:
    """Each kernel's launches per train step by the port's design: one
    forward, dQ and dK/dV per layer, and under every remat policy the
    forward once more in the backward (no policy keeps its lse)."""
    L = cfg.n_layer
    return {"flash_fwd": 2 * L if remat else L, "flash_dq": L, "flash_dkv": L}


def remat_policies(card: str) -> dict:
    """Phase 3's remat table. Returns {run: (median step ms, peak GiB, busy ms)}."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import gpt2

    base, table = None, {}
    for policy in REMAT_RUNS:
        label = policy or "no remat"
        run = bench.setup(REMAT_STEPS + 2, remat=policy is not None, remat_policy=policy or "full")
        loss = gpt2.loss_fn(run.model, run.batches[0])
        loss.backward()
        grads = {n: p.grad for n, p in run.model.named_parameters()}
        run.model.zero_grad(set_to_none=True)
        loss = loss.item()
        if base is None:
            base = (loss, grads)
            check = "the reference"
        else:
            rel = bench.relnorms(grads, base[1])
            bitwise = loss == base[0] and all(torch.equal(grads[n], g) for n, g in base[1].items())
            worst = max(rel.items(), key=lambda kv: kv[1])
            check = (f"vs no remat: loss gap {abs(loss - base[0]):.3e}, gradients bitwise equal "
                     f"{bitwise}, largest relnorm {worst[1]:.3e} ({worst[0]})")
            if not abs(loss - base[0]) <= LOSS_REF_TOL:
                fail(f"remat {label}: step-0 loss {loss} vs no remat {base[0]}")
            bad = [n for n, r in rel.items() if not r <= GRAD_RELNORM_TOL]
            if bad or len(rel) != len(base[1]):
                fail(f"remat {label}: gradients of {bad} disagree with no remat's "
                     f"(relnorm > {GRAD_RELNORM_TOL})")
        times, per_step, peak, busy = bench.timed_steps(run, run.batches[1:], warmup=1)
        want = design_launches(run.cfg, policy is not None)
        med = statistics.median(times)
        print(f"remat {label}: step 0 loss {loss:.6f} ({check}); median of {REMAT_STEPS} steps "
              f"{med:.2f} ms ({', '.join(f'{t:.2f}' for t in times)}); device busy {busy:.2f} ms "
              f"of a profiled step ({100 * (1 - busy / med):.1f}% of the median idle); peak memory "
              f"{peak:.2f} GiB; launches per step {per_step} [{card}]", flush=True)
        if per_step != want:
            fail(f"remat {label} launched {per_step} per step; the design says {want}")
        table[label] = (med, peak, busy)
        del run, grads
        torch.cuda.empty_cache()
    return table


# ---------------------------------------------------------------------------
# Phase 4
# ---------------------------------------------------------------------------

SERVE_MODEL, SERVE_SEED = "gpt2-small", 0
SERVE_BATCH = 8  # LLMConfig.max_batch_size: 8 x 16 pages + scratch, 32 decode rows
N_REQUESTS, MAX_NEW = 24, 64
SHARED_PREFIX, N_SHARED = 512, 8
N_SAMPLED, SAMPLED_TEMP, N_STREAMING = 4, 0.8, 2
CHECK_PROMPT, CHECK_STEPS = 200, 32
# Decode functions vs GPT2.forward at the same positions, held per position
# in relative norm over the vocabulary's logits, on the same weights in each
# compute dtype. In bf16 the decode attention rounds its scores to bf16 and
# the forward's reference attention keeps them in f32: on an H100 the slot
# and the paged functions both read 1.21e-2. In f32 only the order of the
# sums differs, so the limit can be tight enough to see a wrong KV read,
# which moves the logits of the random init little: the f32 pass also
# decodes one step through the page table reversed after prefill (a planted
# fault) and fails unless that reading exceeds the limit.
LOGITS_RELNORM_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
# A greedy token's logit under GPT2.forward on the same sequence may fall
# below its position's maximum by at most this much (absolute; the logits
# of the random init are of order 1): the two paths round differently, so
# a near tie may resolve either way. On an H100, 4 of 1280 greedy tokens
# were not the forward's argmax, the largest margin 8.97e-3. The same
# margin decides whether a paged/slot divergence was a near tie.
GREEDY_MARGIN = 3e-2
DECODE_TIMED_STEPS, DECODE_PROFILED_STEPS = 20, 5


def serving_traffic(vocab: int) -> list:
    """The phase's 24 requests, from a seeded generator, in submission
    order."""
    rng = np.random.default_rng(SERVE_SEED)
    prefix = rng.integers(0, vocab, SHARED_PREFIX).tolist()
    reqs = []
    for i in range(N_REQUESTS):
        if i < N_SHARED:
            n = int(rng.integers(SHARED_PREFIX + 1, 897))
            prompt = prefix + rng.integers(0, vocab, n - SHARED_PREFIX).tolist()
        else:
            prompt = rng.integers(0, vocab, int(rng.integers(64, 897))).tolist()
        reqs.append({"prompt_tokens": prompt, "max_new_tokens": MAX_NEW, "temperature": 0.0})
    for i in rng.choice(N_REQUESTS, N_SAMPLED, replace=False):
        reqs[i]["temperature"] = SAMPLED_TEMP
    for i in rng.choice(N_REQUESTS, N_STREAMING, replace=False):
        reqs[i]["stream"] = True
    return [reqs[i] for i in rng.permutation(N_REQUESTS)]


def ask(srv, req: dict) -> list:
    res = srv(dict(req))
    return [ev["token"] for ev in res] if req.get("stream") else res["tokens"]


def make_server(**kw):
    from ray_tpu_torch.serve.llm import LLMConfig, LLMServer

    return LLMServer(LLMConfig(model_id=SERVE_MODEL, max_batch_size=SERVE_BATCH, **kw))


def stop_server(srv) -> None:
    srv.unload()
    srv._thread.join(timeout=60)
    if srv._thread.is_alive():
        fail("the engine thread did not stop after unload")


def check_decode_functions(model, cfg, card: str) -> None:
    """prefill plus CHECK_STEPS decode steps, through the slot functions and
    the paged ones (two prefill chunks), against GPT2.forward's logits at
    the same positions, in bf16 and in f32; and a planted fault, one paged
    step through a wrong page table, that the f32 limit must see."""
    from ray_tpu_torch.models import gpt2_decode as dec

    P, N = CHECK_PROMPT, CHECK_STEPS
    seq = torch.from_numpy(np.random.default_rng(SERVE_SEED + 1).integers(
        0, cfg.vocab_size, P + N)).cuda()
    padded = torch.zeros(1, 256, dtype=torch.long, device="cuda")
    padded[0, :P] = seq[:P]

    def relnorm(got, want):  # per position, the largest
        return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()

    for dt, limit in LOGITS_RELNORM_TOL.items():
        dcfg = dataclasses.replace(cfg, dtype=dt, remat=False)
        with torch.inference_mode():
            want = model(seq[None], dcfg)[0, P - 1:, :cfg.vocab_size]  # positions P-1 .. P+N-1
            ck, cv = dec.init_cache(dcfg, 1, cfg.n_positions, "cuda")
            slot = [dec.prefill(dcfg, model, padded, P, ck, cv, 0)[None]]
            B, max_pages = 64, cfg.n_positions // 64
            pk, pv = dec.init_paged_cache(dcfg, max_pages + 1, B, "cuda")
            table = torch.arange(max_pages, 0, -1, device="cuda")  # pages in reverse order
            paged = [None]
            for start, n in ((0, 128), (128, P - 128)):
                chunk = torch.zeros(1, 128, dtype=torch.long, device="cuda")
                chunk[0, :n] = seq[start:start + n]
                paged[0] = dec.prefill_paged(dcfg, model, chunk, start, n, pk, pv, table)[None]
            # the planted fault: step 0 reads the prefill's pages through the
            # table reversed (the prompt's KV comes from empty pages)
            planted = dec._decode_paged_impl(dcfg, model, seq[P:P + 1],
                                             torch.full((1,), P, device="cuda"), pk.clone(),
                                             pv.clone(), table.flip(0)[None])
            for i in range(N):
                last, length = seq[P + i:P + i + 1], torch.full((1,), P + i, device="cuda")
                slot.append(dec.decode_step(dcfg, model, last, length, ck, cv))
                paged.append(dec._decode_paged_impl(dcfg, model, last, length, pk, pv,
                                                    table[None]))
        for name, got in (("slot", slot), ("paged", paged)):
            rel = relnorm(torch.cat(got), want)
            print(f"decode functions ({name}, {dt}: prefill of {P} tokens + {N} decode steps) "
                  f"vs GPT2.forward: max relnorm over positions {rel:.3e} (limit {limit}) "
                  f"[{card}]", flush=True)
            if not rel <= limit:
                fail(f"{name} decode logits disagree with GPT2.forward in {dt}: "
                     f"relnorm {rel:.3e}")
        rel = relnorm(planted, want[1:2])
        print(f"  planted fault ({dt}: page table reversed after prefill): relnorm {rel:.3e} "
              f"(limit {limit}; the f32 check must exceed it)", flush=True)
        if dt == torch.float32 and not rel > limit:
            fail(f"the f32 decode check misses a wrong page table: relnorm {rel:.3e}")


def greedy_margins(model, cfg, prompt: list, gen: list) -> torch.Tensor:
    """max logit - logit of each generated token, GPT2.forward teacher-forced
    on prompt + gen."""
    fwd = dataclasses.replace(cfg, remat=False)
    seq = torch.tensor([prompt + gen[:-1]], device="cuda")
    with torch.inference_mode():
        logits = model(seq, fwd)[0, len(prompt) - 1:, :cfg.vocab_size]
    g = torch.tensor(gen, device="cuda")
    return logits.max(-1).values - logits.gather(1, g[:, None])[:, 0]


def time_decode_step(model, cfg, lengths: list, card: str) -> None:
    """decode_paged_and_sample at the engine's shape (32 rows over a
    129-page pool, virtual rows of 1024): host clock over back-to-back
    steps, CUDA events per step, and the device's busy time per step from
    torch.profiler, whose share of the wall time says how far the host holds
    the card back (eager PyTorch, one launch per op)."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import bench
    from ray_tpu_torch.models import gpt2_decode as dec

    S, B, max_pages = 4 * SERVE_BATCH, 64, cfg.n_positions // 64
    pk, pv = dec.init_paged_cache(cfg, SERVE_BATCH * max_pages + 1, B, "cuda")
    tables = (torch.arange(S * max_pages, device="cuda") % (SERVE_BATCH * max_pages) + 1).view(
        S, max_pages)
    lens = torch.tensor((lengths * S)[:S], device="cuda")
    last = torch.zeros(S, dtype=torch.long, device="cuda")
    temps = torch.full((S,), 1e-6, device="cuda")
    greedy = torch.ones(S, dtype=torch.bool, device="cuda")

    def step():
        return dec.decode_paged_and_sample(cfg, model, last, lens, pk, pv, tables, temps, greedy,
                                           1, 0)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DECODE_TIMED_STEPS):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / DECODE_TIMED_STEPS
    event_ms = bench.time_ms(step, iters=DECODE_TIMED_STEPS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(DECODE_PROFILED_STEPS):
            step()
        torch.cuda.synchronize()
        traced_us = (time.perf_counter() - t0) * 1e6
    kernels = _device_kernels(prof, "the decode step")
    busy_ms = bench.union_us([(ev.time_range.start, ev.time_range.end) for ev in kernels]) / 1e3
    busy_ms /= DECODE_PROFILED_STEPS
    print(f"decode step ({SERVE_MODEL}, {S} rows, virtual rows of {max_pages * B}): wall "
          f"{wall_ms:.3f} ms ({S / wall_ms * 1e3:.1f} decode tokens/s), CUDA events "
          f"{event_ms:.3f} ms, device busy {busy_ms:.3f} ms ({100 * (1 - busy_ms / wall_ms):.1f}% "
          f"of the wall idle; the profiled steps took {traced_us / DECODE_PROFILED_STEPS / 1e3:.3f} "
          f"ms each), {len(kernels) / DECODE_PROFILED_STEPS:.0f} kernels per step [{card}]",
          flush=True)
    by_name = {}
    for ev in kernels:
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print("  largest kernels (ms per step): " + "; ".join(
        f"{us / DECODE_PROFILED_STEPS / 1e3:.3f} {name[:70]}" for name, us in top), flush=True)


def compare_streams(name_a: str, a: list, name_b: str, b: list, reqs: list, model, cfg,
                    near_ties: bool) -> None:
    """Fail unless the streams are equal; with ``near_ties``, a greedy
    stream may diverge where GPT2.forward puts both tokens within
    GREEDY_MARGIN of the maximum."""
    for req, x, y in zip(reqs, a, b):
        if x == y:
            continue
        j = next(i for i, (p, q) in enumerate(zip(x, y)) if p != q) if len(x) == len(y) else 0
        where = (f"{name_a} vs {name_b}, prompt of {len(req['prompt_tokens'])} tokens, "
                 f"temperature {req['temperature']}: first divergence at token {j} "
                 f"({x[j:j + 4]} vs {y[j:j + 4]})")
        if not (near_ties and req["temperature"] == 0 and len(x) == len(y)):
            fail(where)
        gaps = [greedy_margins(model, cfg, req["prompt_tokens"], s[:j + 1])[-1].item()
                for s in (x, y)]
        print(f"  {where}: margins {gaps[0]:.3e} and {gaps[1]:.3e} under GPT2.forward "
              f"(limit {GREEDY_MARGIN})", flush=True)
        if not max(gaps) <= GREEDY_MARGIN:
            fail(f"{where} is not a near tie")
    print(f"streams {name_a} and {name_b}: {sum(x == y for x, y in zip(a, b))} of {len(a)} "
          "equal", flush=True)


def serve(card: str) -> None:
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.serve import prefix_cache

    _zero_launches()
    from ray_tpu_torch.models import gpt2

    reqs = serving_traffic(gpt2.CONFIGS[SERVE_MODEL].vocab_size)

    torch.cuda.reset_peak_memory_stats()
    srv = make_server()
    model, cfg = srv.model, srv.model_cfg
    check_decode_functions(model, cfg, card)

    with ThreadPoolExecutor(max_workers=N_REQUESTS) as pool:
        t0 = time.perf_counter()
        outs = list(pool.map(lambda r: ask(srv, r), reqs))
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = srv.batch_stats()
    bad = [i for i, o in enumerate(outs)
           if len(o) != MAX_NEW or not all(0 <= t < cfg.vocab_size for t in o)]
    if bad:
        fail(f"requests {bad} did not return {MAX_NEW} tokens in the vocabulary")
    n_tok = sum(len(o) for o in outs)
    pst = st["prefix"]
    print(f"serve {SERVE_MODEL} ({sum(p.numel() for p in model.parameters())} params, bf16, "
          f"{pst['pages_total']} pages of {pst['block_tokens']} tokens + scratch): "
          f"{N_REQUESTS} requests at once, {n_tok} tokens in {wall:.3f} s, {n_tok / wall:.1f} "
          f"output tokens/s; TTFT p50 {st['ttft_s']['p50'] * 1e3:.2f} ms, p95 "
          f"{st['ttft_s']['p95'] * 1e3:.2f} ms; {st['batches']} decode dispatches, mean batch "
          f"{st['mean_batch']:.2f}, max {st['max_batch']}; prefix hits {pst['hits']}, misses "
          f"{pst['misses']}, copies {pst['copies']}; peak memory {peak:.2f} GiB [{card}]",
          flush=True)

    margins = torch.cat([greedy_margins(model, cfg, r["prompt_tokens"], o)
                         for r, o in zip(reqs, outs) if r["temperature"] == 0])
    print(f"greedy tokens vs GPT2.forward teacher-forced: {margins.numel()} tokens, "
          f"{(margins == 0).sum().item()} the argmax, largest margin {margins.max().item():.3e} "
          f"(limit {GREEDY_MARGIN})", flush=True)
    if not margins.max().item() <= GREEDY_MARGIN:
        fail("a greedy token is not within the margin of its position's maximum")

    pst = srv.batch_stats()["prefix"]
    with srv._prefix_pool._lock:
        pinned = sum(pg.refs for pg in srv._prefix_pool._pages)
    print(f"drained pool: {pst['pages_free']} pages free, {pst['pages_occupied']} occupied, "
          f"{pst['prefix_resident']} sealed prefix pages, {pinned} pins", flush=True)
    if pinned or pst["pages_occupied"] != pst["prefix_resident"]:
        fail("the drained engine still holds pages beyond its sealed prefix pages")
    stop_server(srv)
    if srv._prefix_pool in prefix_cache.live_pools():
        fail("the pool outlived unload")
    time_decode_step(model, cfg, [len(r["prompt_tokens"]) + MAX_NEW // 2 for r in reqs], card)

    # request by request on fresh engines: the same step numbers in each
    plain = [i for i, r in enumerate(reqs) if r["temperature"] == 0 and not r.get("stream")]
    sample = [r for i, r in enumerate(reqs)
              if r.get("stream") or r["temperature"] > 0 or i in plain[:2]]
    streams = {}
    for name, kw in (("async", {}), ("sync", {"async_decode": False}),
                     ("slot", {"paged_kv": False})):
        eng = make_server(**kw)
        streams[name] = [ask(eng, r) for r in sample]
        if name == "sync":
            check_prefix_hit(eng, cfg, card)
        stop_server(eng)
    compare_streams("async", streams["async"], "sync", streams["sync"], sample, model, cfg,
                    near_ties=False)
    greedy = [i for i, r in enumerate(sample) if r["temperature"] == 0]
    compare_streams("paged", [streams["async"][i] for i in greedy], "slot",
                    [streams["slot"][i] for i in greedy], [sample[i] for i in greedy], model,
                    cfg, near_ties=True)
    if any(fa.launches.values()):
        fail(f"serving launched flash kernels: {dict(fa.launches)}")
    print(f"serving launched no flash kernel: {dict(fa.launches)}", flush=True)


def check_prefix_hit(srv, cfg, card: str) -> None:
    """A cold prompt of 512 + 50 tokens and the same prompt again, admitted
    from the 8 pages the first sealed: the same tokens, 8 more hits, no
    block copy. The hit prefills the 50-token tail at position 512, where
    the cold run's second prefill chunk started, so both compute it alike."""
    rng = np.random.default_rng(SERVE_SEED + 2)
    req = {"prompt_tokens": rng.integers(0, cfg.vocab_size, SHARED_PREFIX + 50).tolist(),
           "max_new_tokens": MAX_NEW, "temperature": 0.0}
    pool = srv._prefix_pool
    cold = ask(srv, req)
    before = pool.stats()
    hot = ask(srv, req)
    after = pool.stats()
    hits = after["hits"] - before["hits"]
    print(f"prefix hit vs cold ({len(req['prompt_tokens'])}-token prompt): equal {hot == cold}, "
          f"{hits} pages hit, {after['copies'] - before['copies']} block copies [{card}]",
          flush=True)
    if hot != cold or hits != SHARED_PREFIX // 64 or after["copies"] != before["copies"]:
        fail("the prefix hit differs from the cold run or copied blocks")


# ---------------------------------------------------------------------------
# Phase 5: context and expert parallelism
# ---------------------------------------------------------------------------

# The f32 block kernels at the ring's block shapes, one rank's quarter of
# gpt2-small's attention over 16,384 tokens (B, Tq, Tk, H, Dh, causal): the
# diagonal block, an earlier block, a ragged earlier block and Dh 16.
BLOCK_CASES = [(2, 4096, 4096, 12, 64, True), (2, 4096, 4096, 12, 64, False),
               (2, 4096, 1000, 12, 64, False), (2, 4096, 4096, 12, 16, True)]
RING_RANKS = 4
RING_SHAPE = (2, 16384, 12, 64)  # B, T, H, Dh of the whole sequence; bf16, causal
RING_LAUNCHES = RING_RANKS * (RING_RANKS + 1) // 2  # 4 diagonal + 6 earlier blocks, per kernel
# gpt2-small's MLP widths as 8 experts, top-2 routing, bf16 tokens, f32 weights
MOE_TOKENS, MOE_D, MOE_F, MOE_E, MOE_TOP_K, MOE_CAPACITY = 4096, 768, 3072, 8, 2, 1280
# moe_block on a group of one against moe_block_local: the dryrun leg's 1e-3
# on the loss (relative); each gradient within 1e-3 in relative norm (the
# same f32 arithmetic, the exchange a copy).
MOE_LOSS_RTOL, MOE_GRAD_RELNORM = 1e-3, 1e-3


def _bf16(gen, *shape):
    return torch.randn(*shape, device="cuda", dtype=torch.bfloat16, generator=gen)


def check_f32_blocks(card: str) -> dict:
    """Each kernel's f32 instantiation against its plain version (f32
    outputs, the same bf16 operands) at the ring's block shapes, by phase
    2's rule, lse within LSE_TOL; then both instantiations timed at the
    diagonal and the earlier block. Returns the kernel line's "f32" entries."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import flash_attention as fa

    info = {name: {"max_abs_err": 0.0, "ms": {}, "bf16_ms": {}, "bound_ms": {}} for name in KERNELS}
    for B, T, Tk, H, D, causal in BLOCK_CASES:
        g = torch.Generator(device="cuda").manual_seed(4321)
        q, k, v, do = _bf16(g, B * H, T, D), _bf16(g, B * H, Tk, D), _bf16(g, B * H, Tk, D), \
            _bf16(g, B * H, T, D)
        o, lse = fa.flash_fwd(q, k, v, causal, out_f32=True)
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, out_f32=True)
        delta = (do.float() * o_ref.to(torch.bfloat16).float()).sum(-1)
        dq = fa.flash_dq(q, k, v, do, lse_ref, delta, causal, out_f32=True)
        dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, causal, out_f32=True)
        refs = fa.flash_bwd_reference(q, k, v, do, lse_ref, delta, causal, out_f32=True)
        torch.cuda.synchronize()
        where = f"B={B} Tq={T} Tk={Tk} H={H} Dh={D} causal={causal}, f32 outputs"
        if any(t.dtype != torch.float32 for t in (o, dq, dk, dv)):
            fail(f"an f32 instantiation returned {[t.dtype for t in (o, dq, dk, dv)]} at {where}")
        gaps = {name: bench.disagreement(got, ref) for name, got, ref in
                [("o", o, o_ref), ("dq", dq, refs[0]), ("dk", dk, refs[1]), ("dv", dv, refs[2])]}
        lse_err = (lse - lse_ref).abs().max().item()
        print(f"f32 kernels vs plain at {where}: " + _gap_text(gaps)
              + f"; lse max abs {lse_err:.3e}", flush=True)
        bad = [name for name, gap in gaps.items() if not gap["ok"]]
        if bad:
            fail(f"{', '.join(bad)} (f32) disagree with the plain version at {where} "
                 f"(limits: {_rule()})")
        if not lse_err <= LSE_TOL:
            fail(f"lse disagrees at {where}: max abs err {lse_err:.3e} > {LSE_TOL}")
        for name, err in (("flash_fwd", gaps["o"]["max_abs"]), ("flash_dq", gaps["dq"]["max_abs"]),
                          ("flash_dkv", max(gaps["dk"]["max_abs"], gaps["dv"]["max_abs"]))):
            info[name]["max_abs_err"] = max(info[name]["max_abs_err"], err)
        del o_ref, refs
        if D != 64 or Tk != T:
            continue
        block = "diagonal" if causal else "earlier"
        calls = {
            "flash_fwd": lambda f32: fa.flash_fwd(q, k, v, causal, out_f32=f32),
            "flash_dq": lambda f32: fa.flash_dq(q, k, v, do, lse, delta, causal, out_f32=f32),
            "flash_dkv": lambda f32: fa.flash_dkv(q, k, v, do, lse, delta, causal, out_f32=f32),
        }
        bnd = bounds(B, T, Tk, H, D, causal, out_bytes=4)
        for name, call in calls.items():
            f32_ms = bench.time_ms(lambda: call(True))
            bf16_ms = bench.time_ms(lambda: call(False))
            info[name]["ms"][block], info[name]["bf16_ms"][block] = f32_ms, bf16_ms
            info[name]["bound_ms"][block] = bnd[name][0]
            print(f"time {name} at the ring's {block} block ({where}): f32 output {f32_ms:.4f} ms, "
                  f"bf16 output {bf16_ms:.4f} ms ({100 * (f32_ms / bf16_ms - 1):+.1f}%), bound "
                  f"{bnd[name][0]:.4f} ms ({bnd[name][1]}) [{card}]", flush=True)
    return info


def _device_split(fn) -> tuple:
    """One profiled call of ``fn``: device ms in the three flash kernels, and
    in everything else (the merges, accumulations, folds and casts), with the
    largest of the rest by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = _device_kernels(prof, "the ring")
    ours = lambda ev: any(f"{name}_kernel" in ev.name for name in KERNELS)
    flash = sum(ev.time_range.elapsed_us() for ev in kernels if ours(ev)) / 1e3
    by_name = {}
    for ev in kernels:
        if not ours(ev):
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return flash, sum(by_name.values()), top


def check_ring(card: str) -> tuple:
    """The ring of RING_RANKS ranks emulated on the card at RING_SHAPE,
    forward and backward through ring_attention's step functions, against
    the monolithic flash attention (the train path's bf16 kernels) by phase
    2's rule; every block through an f32 kernel. Then the world-1 NCCL ring,
    MoE, and the times. Returns the ring's launch counts and its inputs."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops.ring_attention import ring_attention_emulated

    B, T, H, D = RING_SHAPE
    g = torch.Generator(device="cuda").manual_seed(5)
    x = {name: _bf16(g, B, T, H, D) for name in ("q", "k", "v", "do")}
    shards = {name: list(t.chunk(RING_RANKS, dim=1)) for name, t in x.items()}
    _zero_launches()
    ring = ring_attention_emulated(shards["q"], shards["k"], shards["v"], shards["do"], causal=True)
    torch.cuda.synchronize()
    counts, counts_f32 = _launch_counts()
    want = dict.fromkeys(KERNELS, RING_LAUNCHES)
    print(f"emulated ring ({RING_RANKS} ranks, [B, T, H, Dh] = {list(RING_SHAPE)}, bf16, causal): "
          f"launches {counts}, of them f32 {counts_f32}", flush=True)
    if counts != want or counts_f32 != want:
        fail(f"the emulated ring launched {counts} (f32: {counts_f32}); expected {want}, all f32")

    leaves = [x[name].clone().requires_grad_() for name in ("q", "k", "v")]
    mono_out = fa.flash_attention(*leaves, True)
    mono_out.backward(x["do"])
    mono = [mono_out.detach()] + [t.grad for t in leaves]
    gaps = {name: bench.disagreement(torch.cat(parts, dim=1), want_t) for name, parts, want_t in
            zip(("o", "dq", "dk", "dv"), ring, mono)}
    print("emulated ring vs monolithic flash attention: " + _gap_text(gaps), flush=True)
    bad = [name for name, gap in gaps.items() if not gap["ok"]]
    if bad:
        fail(f"the emulated ring's {', '.join(bad)} disagree with flash attention ({_rule()})")
    del ring
    time_ring(x, shards, leaves, card)
    return counts_f32, x, mono


def time_ring(x: dict, shards: dict, leaves: list, card: str) -> None:
    """Median of 20 calls (CUDA events) of the emulated ring's forward and
    forward+backward, the monolithic flash attention's and SDPA's on the
    same inputs; one profiled call of each ring pass splits its device
    time between the kernels and the rest."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops.ring_attention import ring_attention_emulated

    B, T, H, D = RING_SHAPE
    ring_fwd = lambda: ring_attention_emulated(shards["q"], shards["k"], shards["v"], causal=True)
    ring_all = lambda: ring_attention_emulated(shards["q"], shards["k"], shards["v"], shards["do"],
                                               causal=True)
    mono_fwd = lambda: fa.flash_attention(*leaves, True)
    mono_all = lambda: torch.autograd.grad(fa.flash_attention(*leaves, True), leaves, x["do"])
    sq, sk, sv = (t.detach().transpose(1, 2).requires_grad_() for t in leaves)  # [B, H, T, Dh]
    sdo = x["do"].transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
    sdpa_all = lambda: torch.autograd.grad(sdpa(), (sq, sk, sv), sdo)
    ms = {name: bench.time_ms(fn) for name, fn in (
        ("ring_fwd", ring_fwd), ("ring_all", ring_all), ("mono_fwd", mono_fwd),
        ("mono_all", mono_all), ("sdpa_fwd", sdpa), ("sdpa_all", sdpa_all))}
    bnd = bounds(B, T, T, H, D, True)
    bound_fwd, bound_bwd = bnd["flash_fwd"][0], bnd["flash_dq"][0] + bnd["flash_dkv"][0]
    for label, fn, wall, bound in (("forward", ring_fwd, ms["ring_fwd"], bound_fwd),
                                   ("forward+backward", ring_all, ms["ring_all"],
                                    bound_fwd + bound_bwd)):
        flash, rest, top = _device_split(fn)
        print(f"emulated ring {label}: {wall:.3f} ms (CUDA events), device time in the flash "
              f"kernels {flash:.3f} ms, outside them {rest:.3f} ms ({100 * rest / (flash + rest):.1f}% "
              f"of the device time; merges, accumulations, folds, casts), bound {bound:.3f} ms "
              f"[{card}]", flush=True)
        print("  largest outside the kernels (ms): " + "; ".join(
            f"{t:.3f} {name[:60]}" for name, t in top), flush=True)
    print(f"monolithic flash attention at T={T}: forward {ms['mono_fwd']:.3f} ms, forward+backward "
          f"{ms['mono_all']:.3f} ms; SDPA (library, not called by the port): forward "
          f"{ms['sdpa_fwd']:.3f} ms, forward+backward {ms['sdpa_all']:.3f} ms; emulated ring "
          f"backward {ms['ring_all'] - ms['ring_fwd']:.3f} ms, monolithic "
          f"{ms['mono_all'] - ms['mono_fwd']:.3f} ms [{card}]", flush=True)


def check_group_paths(x: dict, mono: list, card: str) -> None:
    """attention(impl="ring") and moe_block on a real NCCL group of one
    rank (this card), initialised from a file store in a temporary
    directory and destroyed after."""
    import tempfile

    import torch.distributed as dist

    from ray_tpu_torch import bench
    from ray_tpu_torch.ops.attention import attention

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            group = dist.group.WORLD
            leaves = [x[name].clone().requires_grad_() for name in ("q", "k", "v")]
            _zero_launches()
            out = attention(*leaves, causal=True, impl="ring", group=group)
            out.backward(x["do"])
            torch.cuda.synchronize()
            counts, counts_f32 = _launch_counts()
            one = dict.fromkeys(KERNELS, 1)
            gaps = {name: bench.disagreement(got, want) for name, got, want in
                    zip(("o", "dq", "dk", "dv"), [out] + [t.grad for t in leaves], mono)}
            print(f"attention(impl='ring') on an NCCL group of 1 ({dist.get_backend(group)}), "
                  f"[B, T, H, Dh] = {list(RING_SHAPE)}: launches {counts}, f32 {counts_f32}; vs "
                  f"monolithic flash attention: " + _gap_text(gaps), flush=True)
            if counts != one or counts_f32 != one:
                fail(f"the world-1 ring launched {counts} (f32: {counts_f32}); expected {one}")
            bad = [name for name, gap in gaps.items() if not gap["ok"]]
            if bad:
                fail(f"the world-1 ring's {', '.join(bad)} disagree with flash attention")
            del out, leaves
            check_moe(group, card)
        finally:
            dist.destroy_process_group()


def check_moe(group, card: str) -> None:
    """moe_block on ``group`` (one rank: the exchanges are copies) against
    moe_block_local, forward and the gradients of all four inputs, then
    moe_block's times."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops.moe import moe_block, moe_block_local, router_dispatch

    g = torch.Generator(device="cuda").manual_seed(6)
    f32 = dict(device="cuda", generator=g)
    inputs = [_bf16(g, MOE_TOKENS, MOE_D), torch.randn(MOE_D, MOE_E, **f32) * 0.02,
              torch.randn(MOE_E, MOE_D, MOE_F, **f32) * 0.02,
              torch.randn(MOE_E, MOE_F, MOE_D, **f32) * 0.02]
    fns = {"moe_block": lambda *a: moe_block(*a, MOE_CAPACITY, group, MOE_TOP_K),
           "moe_block_local": lambda *a: moe_block_local(*a, MOE_CAPACITY, MOE_TOP_K)}
    res = {}
    for name, fn in fns.items():
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        loss = (out.float() ** 2).sum()
        loss.backward()
        res[name] = (out.detach(), loss.item(), [t.grad for t in leaves])
    (out, loss, grads), (out_l, loss_l, grads_l) = res["moe_block"], res["moe_block_local"]
    gap = bench.disagreement(out, out_l)
    rel = [((a.float() - b.float()).norm() / b.float().norm()).item() for a, b in zip(grads, grads_l)]
    dispatch, _ = router_dispatch(inputs[0], inputs[1], MOE_CAPACITY, MOE_TOP_K)
    kept = dispatch.sum().item() / (MOE_TOKENS * MOE_TOP_K)
    print(f"moe_block on an NCCL group of 1 vs moe_block_local ({MOE_TOKENS} tokens, D {MOE_D}, "
          f"F {MOE_F}, E {MOE_E}, top-{MOE_TOP_K}, capacity {MOE_CAPACITY}; {100 * kept:.1f}% of "
          f"the choices kept): out max abs {gap['max_abs']:.3e} relnorm {gap['relnorm']:.2e}; loss "
          f"{loss:.6f} vs {loss_l:.6f}; gradient relnorm x {rel[0]:.2e}, wg {rel[1]:.2e}, w_in "
          f"{rel[2]:.2e}, w_out {rel[3]:.2e}", flush=True)
    if not gap["ok"] or not abs(loss - loss_l) <= MOE_LOSS_RTOL * max(1.0, abs(loss_l)):
        fail("moe_block's output or loss disagrees with moe_block_local")
    if not all(r <= MOE_GRAD_RELNORM for r in rel):
        fail(f"moe_block's gradients disagree with moe_block_local's (relnorm > {MOE_GRAD_RELNORM})")
    leaves = [t.clone().requires_grad_() for t in inputs]
    fwd = lambda: fns["moe_block"](*leaves)
    both = lambda: torch.autograd.grad((fns["moe_block"](*leaves).float() ** 2).sum(), leaves)
    fwd_ms, both_ms = bench.time_ms(fwd), bench.time_ms(both)
    print(f"moe_block: forward {fwd_ms:.3f} ms, forward+backward {both_ms:.3f} ms (CUDA events, "
          f"median of 20) [{card}]", flush=True)


def parallel(card: str) -> dict:
    """Phase 5. Returns the kernel line's "f32" entry of each kernel."""
    info = check_f32_blocks(card)
    ring_launches, x, mono = check_ring(card)
    for name in KERNELS:
        info[name]["ring_launches"] = ring_launches[name]
    check_group_paths(x, mono, card)
    return info


# ---------------------------------------------------------------------------
# Phase 6: the sharded train step on a mesh of one
# ---------------------------------------------------------------------------

SHARD_STEPS = 3
# The sharded step on a mesh of one against the unsharded step, on the same
# init and batch: the JAX package's limits for its sharded step against one
# device (tests/test_parallel.py): the loss within 1e-5 relative, every
# parameter after one AdamW step within rtol 2e-4 and atol 2e-5.
SHARD_LOSS_RTOL, SHARD_PARAM_RTOL, SHARD_PARAM_ATOL = 1e-5, 2e-4, 2e-5


def sharded_step(card: str, unsharded: tuple) -> None:
    """``unsharded``: phase 3's (median step ms, peak GiB, busy ms) without remat."""
    import tempfile

    import torch.distributed as dist

    from ray_tpu_torch import bench
    from ray_tpu_torch.parallel import MeshConfig, build_mesh, shard_model
    from ray_tpu_torch.parallel.mesh import AXIS_ORDER
    from ray_tpu_torch.parallel.sharding import full_parameters, gpt_rules

    ref = bench.setup(1)
    ref_loss = ref.step(ref.batches[0]).item()
    want = {n: p.detach().clone() for n, p in ref.model.named_parameters()}
    del ref
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            mesh = build_mesh(MeshConfig(dp=1))
            run = bench.setup(SHARD_STEPS + 1, place=lambda m: shard_model(m, mesh, gpt_rules()))
            _zero_launches()
            loss = run.step(run.batches[0]).item()
            torch.cuda.synchronize()
            counts, _ = _launch_counts()
            got = full_parameters(run.model)
            close = {n: torch.isclose(got[n], w, rtol=SHARD_PARAM_RTOL,
                                      atol=SHARD_PARAM_ATOL).all().item() for n, w in want.items()}
            gap = max((got[n] - w).abs().max().item() for n, w in want.items())
            bitwise = loss == ref_loss and all(torch.equal(got[n], w) for n, w in want.items())
            sizes = dict(zip(AXIS_ORDER, mesh.shape))
            print(f"sharded step on a mesh of one ({dist.get_backend()}, {sizes}, gpt_rules): step 0 "
                  f"loss {loss:.6f} vs unsharded {ref_loss:.6f}; parameters after one AdamW step: "
                  f"max abs gap {gap:.3e}, all within rtol {SHARD_PARAM_RTOL} atol "
                  f"{SHARD_PARAM_ATOL}: {all(close.values())}; bitwise equal {bitwise}; launches "
                  f"{counts} [{card}]", flush=True)
            if not abs(loss - ref_loss) <= SHARD_LOSS_RTOL * abs(ref_loss):
                fail(f"sharded step-0 loss {loss} vs unsharded {ref_loss}")
            if not all(close.values()):
                fail(f"parameters {[n for n, ok in close.items() if not ok]} after the sharded "
                     "step disagree with the unsharded step's")
            design = design_launches(run.cfg, remat=False)
            if counts != design:
                fail(f"the sharded step launched {counts}; the design says {design}")
            del got
            times, per_step, peak, busy = bench.timed_steps(run, run.batches[1:], warmup=0)
            print(f"sharded step: median of {SHARD_STEPS} steps {statistics.median(times):.2f} ms "
                  f"({', '.join(f'{t:.2f}' for t in times)}), device busy {busy:.2f} ms, peak memory "
                  f"{peak:.2f} GiB; unsharded (phase 3, no remat): {unsharded[0]:.2f} ms, device busy "
                  f"{unsharded[2]:.2f} ms, {unsharded[1]:.2f} GiB; launches per step {per_step} "
                  f"[{card}]", flush=True)
            if per_step != design:
                fail(f"the sharded step launched {per_step} per step; the design says {design}")
            del run
        finally:
            dist.destroy_process_group()


def main() -> None:
    card = identify()
    sass = build()
    results = check_kernels(card)
    counts = train(card)
    remat = remat_policies(card)
    serve(card)
    f32 = parallel(card)
    sharded_step(card, remat["no remat"])
    kernels = [dict(name=name, route="cuda", source=SOURCE, replaces=KERNELS[name],
                    launches=counts[name], **results[name], held_at=["bf16", "f32"],
                    f32=f32[name], sass=sass[name]) for name in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. name the card and its power limit (nvidia-smi); build the CUDA kernels
     from ray_tpu_torch/ops/csrc with nvcc; count each kernel's wgmma
     (HGMMA) and TMA load (UTMALDG) instructions in the library's SASS
     (cuobjdump -sass), and fail if any of the three kernels lacks either;
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
     near ln(vocab), 12 launches of each kernel per step;
  4. print the kernel line (one JSON object; beside the contract's keys,
     each kernel's SASS counts from phase 1: every number in it was
     measured or, for bound_ms, computed in this run);
  5. print the contract line (one JSON object, the last line).

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
from pathlib import Path

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
    for name, c in counts.items():
        print(f"sass {name}: HGMMA {c['hgmma']}, UTMALDG {c['utmaldg']}", flush=True)
    for name in KERNELS:  # every kernel is a Hopper one: wgmma fed by TMA
        if not (counts[name]["hgmma"] > 0 and counts[name]["utmaldg"] > 0):
            fail(f"{name} issues no wgmma or no TMA load in its SASS: {counts[name]}")
    return counts


SASS_OPS = {"hgmma": "HGMMA", "utmaldg": "UTMALDG"}


def sass_counts(lib: Path) -> dict:
    """HGMMA and UTMALDG instructions per kernel (all head-dim instances
    summed) in the SASS of the built library, read with cuobjdump."""
    from ray_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts = {name: dict.fromkeys(SASS_OPS, 0) for name in KERNELS}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((n for n in KERNELS if f"{n}_kernel" in line), None)
        elif current is not None:
            for key, op in SASS_OPS.items():
                counts[current][key] += bool(re.search(rf"\b{op}\b", line))
    return counts


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------


def _visible_pairs(Tq: int, Tk: int, causal: bool) -> int:
    return Tq * (Tq + 1) // 2 if causal else Tq * Tk


def bounds(B, T, Tk, H, D, causal):
    """Least time (ms) for each kernel's work on this card's published
    peaks: (ms, "bytes" | "operations"). Each input read once, each output
    written once; products counted over the (q, k) pairs the mask keeps."""
    BH, pairs = B * H, _visible_pairs(T, Tk, causal)
    q_bytes, kv_bytes, row_bytes = BH * T * D * 2, BH * Tk * D * 2, BH * T * 4
    work = {  # name: (flops, bytes)
        "flash_fwd": (4 * BH * pairs * D, 2 * q_bytes + 2 * kv_bytes + row_bytes),
        "flash_dq": (6 * BH * pairs * D, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
        "flash_dkv": (8 * BH * pairs * D, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
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
    rel = {n: ((grads["flash"][n] - g).norm() / g.norm()).item()
           for n, g in grads["reference"].items() if g.norm().item() > 0}
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
    from ray_tpu_torch.ops import flash_attention as fa

    run = bench.setup(N_STEPS)
    cfg, B, T = run.cfg, bench.BATCH, bench.SEQ
    n_params = sum(p.numel() for p in run.model.parameters())
    flash_loss = check_gradients(run, card)

    torch.cuda.reset_peak_memory_stats()
    for name in fa.launches:
        fa.launches[name] = 0
    losses, times = [], []
    for tokens in run.batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = run.step(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = dict(fa.launches)

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
    step_ms = statistics.median(times[1:]) * 1e3
    tok_s = B * T / (step_ms / 1e3)
    print(f"train step: median {step_ms:.2f} ms over steps 1..{N_STEPS - 1} (step 0 "
          f"{times[0] * 1e3:.2f} ms), {tok_s:.1f} tokens/s, launches {counts}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)
    return counts


def main() -> None:
    card = identify()
    sass = build()
    results = check_kernels(card)
    counts = train(card)
    kernels = [dict(name=name, route="cuda", source=SOURCE, replaces=KERNELS[name],
                    launches=counts[name], **results[name], **sass[name]) for name in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

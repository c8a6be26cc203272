"""The sharded GPT-2 train step, ring attention and the MoE block across
the cards of one machine.

    python3 -m ray_tpu_torch.sharded_cards

Starts one process per card (rank r on card r, NCCL, joined at
tcp://localhost on a free port). Every rank builds every mesh of
``OP_MESHES`` and ``MESHES`` (world 4), then:

  1. for each mesh of ``OP_MESHES``, the ops that exchange along one axis,
     each leg forward and backward on inputs that every rank makes from one
     seed on its own card, sliced to its shard by its mesh coordinates; the
     outputs and gradients are gathered onto rank 0 and held there to a
     reference on one card:
       - on a cp mesh, ``ring_attention_sharded`` (``RING_LEGS``: bf16 at
         gpt2-small's attention over 16,384 tokens against the monolithic
         flash attention by ``bench.disagreement``; f32 at Dh 32 against
         reference attention at ``RING_F32_TOL`` and ``RING_F32_GRAD_TOL``;
         on ``dp 2 x cp 2`` the JAX dryrun's leg against its einsum oracle
         at ``DRYRUN_LOSS_RTOL`` and ``DRYRUN_GRAD_ATOL``), with each kernel's
         launches, summed over the ranks and per rank: cp coordinate c
         launches c + 1 of each, all through f32-output or f32-operand
         instances;
       - on an ep mesh, ``moe_block_sharded`` (``MOE_LEGS``: phase 5's
         widths, 8 experts split over ep, each rank's own tokens, against
         ``moe_block_local`` on each rank's tokens with all 8 experts, the
         loss sum(out^2) within ``MOE_LOSS_RTOL`` and every gradient within
         ``MOE_GRAD_RELNORM`` in relative norm; the router's gradient summed
         over every rank, an expert's over its data-parallel replicas; on
         ``ep 4`` also the dryrun's leg at its limits), with no launch;
     and on the card each leg timed: the median of ``OP_TIMED`` calls of the
     forward and of the forward and backward on every rank (a barrier
     before each call, CUDA events), the slowest rank's median as the
     reading, one profiled call a rank split into device time in the flash
     kernels (the ring) or NCCL's (the MoE) and outside them, the bytes each
     exchange sends, and the one-card op on rank 0 beside it;
  2. takes the unsharded step's loss and gradients on its own card, from
     the port's random init (seed 0) and batch 0 (the reference; every
     rank computes the same);
  3. for each mesh of ``MESHES``: places a fresh model of the same init with
     ``shard_model(model, mesh, gpt_rules())``, takes the loss (averaged
     over the data axes) and the gradients (gathered whole) on batch 0 and
     holds them to the reference: the loss within ``LOSS_TOL``, every
     gradient within ``GRAD_RELNORM_TOL`` in relative norm; then runs
     ``bench.timed_steps``: ``WARMUP`` steps of ``make_train_step``,
     ``STEPS`` timed steps (host clock around steps that end in a
     synchronise) with each kernel's launches per step, which must be one
     per layer, and one more step under torch.profiler on rank 0, whose
     device busy time against the median says how long the card waits
     (for its host or the others).

Rank 0 prints one line per mesh and leg with the card's name and power
limit; a disagreement, a launch count off the design or a rank that fails
exits non-zero. ``--device cpu`` (gloo, four processes) with a smaller
``--model``, ``--batch`` and ``--seq`` rehearses the same path on the CPU,
the ops at ``RING_LEGS["cpu"]`` and ``MOE_LEGS["cpu"]``, where the
kernels' plain versions run (no launch) and nothing is timed as the card's.
"""

from __future__ import annotations

import argparse
import math
import socket
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ray_tpu_torch import bench
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.moe import moe_block, moe_block_local, moe_block_sharded
from ray_tpu_torch.ops.ring_attention import ring_attention_sharded
from ray_tpu_torch.parallel import MeshConfig, build_mesh, shard_model
from ray_tpu_torch.parallel.mesh import AXIS_ORDER, data_parallel_meshes, rank_layout
from ray_tpu_torch.parallel.sharding import full_parameters, gpt_rules

WORLD = 4
# Meshes over the four cards: data parallelism alone, ZeRO-3 alone, tensor
# parallelism alone (3 of gpt2-small's 12 heads a card), and the JAX
# dryrun's two-axis meshes.
MESHES = {
    "dp 4": dict(dp=4),
    "fsdp 4": dict(dp=1, fsdp=4),
    "tp 4": dict(dp=1, tp=4),
    "dp 2 x tp 2": dict(dp=2, tp=2),
    "fsdp 2 x tp 2": dict(dp=1, fsdp=2, tp=2),
    "dcn 2 x tp 2": dict(dcn=2, dp=1, tp=2),
}
WARMUP, STEPS = 2, 5
# chip_smoke.py's limits for a change of rounding through 12 bf16 layers
# (flash against reference attention): tp sums its partial products in
# bf16 over the group, the unsharded step inside one product.
LOSS_TOL, GRAD_RELNORM_TOL = 5e-4, 2e-2

# Meshes of the ops that exchange along one axis: the ring over cp, the
# MoE's all-to-all over ep (the JAX dryrun's dp 4 x cp 2 and dp 2 x ep 4,
# at four cards).
OP_MESHES = {
    "dp 2 x cp 2": dict(dp=2, cp=2),
    "cp 4": dict(dp=1, cp=4),
    "dp 2 x ep 2": dict(dp=2, ep=2),
    "ep 4": dict(dp=1, ep=4),
}
# Ring legs: (label, [B, T, H, Dh] of the whole sequence, operand dtype),
# causal. On the card chip_smoke.py's RING_SHAPE (gpt2-small's attention
# over 16,384 tokens, bf16) and RING_F32_SHAPES (f32 at Dh 32: the JAX ring
# test's 16-row blocks on cp 4, and blocks of many tiles); on the CPU the
# same kinds at small sizes.
RING_LEGS = {
    "cuda": [("bf16", (2, 16384, 12, 64), torch.bfloat16),
             ("f32", (2, 64, 4, 32), torch.float32),
             ("f32", (2, 4096, 4, 32), torch.float32)],
    "cpu": [("bf16", (2, 128, 4, 16), torch.bfloat16),
            ("f32", (2, 64, 4, 32), torch.float32),
            ("f32", (2, 256, 4, 32), torch.float32)],
}
# chip_smoke.py's limits for the f32 ring against reference attention in
# f32 (the JAX ring test's): the output within rtol = atol = RING_F32_TOL,
# the gradients of sum(out^2) within rtol, atol RING_F32_GRAD_TOL.
RING_F32_TOL = 2e-5
RING_F32_GRAD_TOL = (5e-4, 5e-5)
# The JAX dryrun's ring leg (__graft_entry__.py:222-280): dp 2 x cp 2 (its
# dp 4 x cp 2 at four cards), f32, B 2, T 32, H 4, Dh 16, the loss
# sum(out^2) against its einsum oracle: the loss within DRYRUN_LOSS_RTOL
# (relative to max(1, |loss|)), every gradient within DRYRUN_GRAD_ATOL max
# abs. Its MoE leg (:282-340) on ep 4 at the same limits.
DRYRUN_RING = ("dp 2 x cp 2", (2, 32, 4, 16))
DRYRUN_LOSS_RTOL, DRYRUN_GRAD_ATOL = 1e-3, 1e-2
# MoE legs: (label, tokens a rank, D, F, experts, top-k, capacity, token
# dtype, weight scale); weights f32. On the card chip_smoke.py phase 5's
# (gpt2-small's MLP widths as 8 experts, top-2); the dryrun's leg on ep 4.
MOE_LEGS = {
    "cuda": [("bf16", 4096, 768, 3072, 8, 2, 1280, torch.bfloat16, 0.02)],
    "cpu": [("bf16", 64, 32, 64, 8, 2, 32, torch.bfloat16, 0.02)],
}
DRYRUN_MOE = ("ep 4", ("dryrun f32", 8, 16, 32, 8, 2, 8, torch.float32, 0.1))
# chip_smoke.py's limits for moe_block against moe_block_local: the loss
# within 1e-3 relative, every gradient within 1e-3 in relative norm.
MOE_LOSS_RTOL, MOE_GRAD_RELNORM = 1e-3, 1e-3
OP_TIMED = 20  # calls timed a leg, after 3 warm-up calls
# The emulated ring's times at RING_SHAPE (chip_smoke.py phase 5; PERF.md
# section 5, NVIDIA H100 80GB HBM3 at 700 W): recorded, printed as text.
EMULATED_RING_MS = "forward 3.08-3.10 ms, forward+backward 9.92-10.00 ms"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _check_mesh(name, mesh, args, device, ref_loss, ref_grads) -> str:
    """One mesh: the gradient check, then the timed steps. Returns rank
    0's line; raises on a disagreement."""
    run = bench.setup(1 + WARMUP + STEPS, model=args.model, batch=args.batch, seq=args.seq,
                      device=device, place=lambda m: shard_model(m, mesh, gpt_rules()))
    loss = gpt2.loss_fn(run.model, gpt2.local_rows(run.model, run.batches[0]))
    loss.backward()
    loss = gpt2.data_mean(run.model, loss).item()
    grads = full_parameters(run.model, grads=True)
    run.model.zero_grad(set_to_none=True)
    rel = bench.relnorms(grads, ref_grads)
    worst = max(rel.items(), key=lambda kv: kv[1])
    if not abs(loss - ref_loss) <= LOSS_TOL:
        raise RuntimeError(f"{name}: loss {loss} vs unsharded {ref_loss}")
    bad = [n for n, r in rel.items() if not r <= GRAD_RELNORM_TOL]
    if bad:
        raise RuntimeError(f"{name}: gradients of {bad} disagree with the unsharded step's")
    del grads
    return (f"{name}: loss {loss:.6f} (unsharded {ref_loss:.6f}, gap {abs(loss - ref_loss):.3e}); "
            f"gradients vs unsharded: largest relnorm {worst[1]:.3e} ({worst[0]}), median "
            f"{statistics.median(rel.values()):.3e}; "
            + _time_steps(run, run.batches[1:], device, args.batch * args.seq))


def _time_steps(run, batches, device, tokens_per_step: int) -> str:
    """``bench.timed_steps`` on ``batches`` (profiled on rank 0), the
    launch counts checked against the design. Returns the reading."""
    times, per_step, peak, busy = bench.timed_steps(
        run, batches, WARMUP, profile=dist.get_rank() == 0)
    design = dict.fromkeys(per_step, run.cfg.n_layer if device.type == "cuda" else 0)
    if per_step != design:
        raise RuntimeError(f"launches per step {per_step}, the design says {design}")
    med = statistics.median(times)
    return (f"median of {STEPS} steps {med:.2f} ms ({', '.join(f'{t:.2f}' for t in times)}), "
            f"{tokens_per_step / med * 1e3:.1f} tokens/s; on rank 0: device busy {busy:.2f} ms of "
            f"a profiled step ({100 * (1 - busy / med):.1f}% of the median idle), peak memory "
            f"{peak:.2f} GiB, launches per step {per_step}")


DATA_AXES = ("dcn", "dp", "fsdp")


def _block(axes: dict, rank: int, over: tuple) -> tuple:
    """(index, count) of ``rank``'s block of a dimension split over the mesh
    axes ``over`` (the first varying slowest) on the mesh of ``axes``."""
    sizes = MeshConfig(**axes).resolve(WORLD)
    layout = rank_layout(MeshConfig(**axes), list(range(WORLD)))
    coord = dict(zip(AXIS_ORDER, np.argwhere(layout == rank)[0].tolist()))
    index = 0
    for a in over:
        index = index * sizes[a] + coord[a]
    return index, math.prod(sizes[a] for a in over)


def _gather(t: torch.Tensor) -> list:
    """Every rank's ``t`` (equal shapes), in rank order, in f32 (exact for
    bf16; gloo gathers no bf16)."""
    t = t.detach().float().contiguous()
    parts = [torch.empty_like(t) for _ in range(WORLD)]
    dist.all_gather(parts, t)
    return parts


def _assemble(parts: list, axes: dict, split: dict) -> torch.Tensor:
    """The whole tensor from every rank's block: ``split`` maps a dimension
    to the mesh axes it is split over; ranks that hold the same block (its
    replicas) give one copy."""
    dims = sorted(split)
    blocks = {}
    for r, t in enumerate(parts):
        blocks.setdefault(tuple(_block(axes, r, split[d])[0] for d in dims), t)
    counts = [_block(axes, 0, split[d])[1] for d in dims]

    def cat(prefix: tuple) -> torch.Tensor:
        if len(prefix) == len(dims):
            return blocks[prefix]
        level = len(prefix)
        return torch.cat([cat(prefix + (i,)) for i in range(counts[level])], dim=dims[level])

    return cat(())


def _gather_values(values: list, device) -> list:
    """Every rank's list of numbers (equal lengths), in rank order."""
    t = torch.tensor(values, dtype=torch.float64, device=device)
    return [p.tolist() for p in _gather(t)]


def _rule_ratio(gap: dict) -> float:
    """``bench.disagreement``'s verdict as one number, <= 1 when it passes."""
    return max(gap["atol_rms"] / bench.ATOL_RMS,
               min(gap["relnorm"] / bench.RELNORM_TOL, gap["max_abs"] / bench.ABS_FLOOR))


def _tol_ratio(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """max |got - want| / (atol + rtol |want|): <= 1 when every element passes."""
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def _zero_launches() -> None:
    for counts in (fa.launches, fa.launches_f32):
        for name in counts:
            counts[name] = 0


def _launches(device) -> list:
    """[this rank's launches per kernel, of them f32-output or f32-operand],
    gathered from every rank."""
    mine = [fa.launches[k] for k in fa.launches] + [fa.launches_f32[k] for k in fa.launches]
    return [[int(c) for c in counts] for counts in _gather_values(mine, device)]


def _check_launches(where: str, per_rank: list, design: list) -> str:
    """Each rank's launches against ``design`` (one count a rank, the same
    for each kernel and all of them f32-output or f32-operand). Returns the
    text; raises off the design."""
    kernels = list(fa.launches)
    want = [[d] * (2 * len(kernels)) for d in design]
    total = dict(zip(kernels, (sum(r[i] for r in per_rank) for i in range(len(kernels)))))
    total_f32 = dict(zip(kernels, (sum(r[len(kernels) + i] for r in per_rank)
                                   for i in range(len(kernels)))))
    text = (f"launches summed over ranks {total} (design {dict.fromkeys(kernels, sum(design))}), "
            f"of them f32-output or f32-operand {total_f32}, per rank "
            f"{[r[:len(kernels)] for r in per_rank]}")
    if per_rank != want:
        raise RuntimeError(f"{where}: launches per rank {per_rank} (kernels {kernels}, then the "
                           f"f32 ones), the design says {want}")
    return text


def _time_calls(fns: dict, pattern: str, device) -> dict:
    """On the card: each of ``fns`` (name -> call) timed on every rank, the
    median of OP_TIMED calls with a barrier before each (CUDA events), then
    one profiled call split into device ms in the kernels matching
    ``pattern`` and outside them. Returns per name every rank's
    [median, in, outside] and the slowest rank's largest kernels outside."""
    got = {}
    for name, fn in fns.items():
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(OP_TIMED):
            torch.cuda.synchronize()
            dist.barrier()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        med = statistics.median(a.elapsed_time(b) for a, b in pairs)
        dist.barrier()
        inside, outside, top = bench.device_split(fn, pattern)
        ranks = _gather_values([med, inside, outside], device)
        tops = [None] * WORLD
        dist.all_gather_object(tops, top)
        slowest = max(range(WORLD), key=lambda r: ranks[r][0])
        got[name] = (ranks, slowest, tops[slowest])
    return got


def _times_text(got: dict, inside: str) -> str:
    parts = []
    for name, (ranks, slowest, top) in got.items():
        parts.append(
            f"{name}: slowest rank {ranks[slowest][0]:.3f} ms (rank {slowest}; every rank's median "
            f"{', '.join(f'{r[0]:.3f}' for r in ranks)}), device ms in {inside} / outside them a "
            f"rank {', '.join(f'{r[1]:.3f}/{r[2]:.3f}' for r in ranks)}, largest outside on rank "
            f"{slowest}: " + "; ".join(f"{t:.3f} {n[:50]}" for n, t in top))
    return "; ".join(parts)


def _ring_leg(name: str, mesh, axes: dict, label: str, shape: tuple, dtype, device, card: str,
              dryrun: bool = False) -> None:
    """One ring leg on ``mesh`` (see the module's docstring); rank 0 prints
    its line, and its times on the card."""
    rank, cuda = dist.get_rank(), device.type == "cuda"
    B, T, H, D = shape
    (bi, nb), (ci, nc) = _block(axes, rank, DATA_AXES), _block(axes, rank, ("cp",))
    rows, cols = slice(bi * B // nb, (bi + 1) * B // nb), slice(ci * T // nc, (ci + 1) * T // nc)
    g = torch.Generator(device=device).manual_seed(5)
    x = {n: torch.randn(B, T, H, D, generator=g, device=device, dtype=dtype) for n in "qkv"}
    whole = [x[n].clone().requires_grad_() for n in "qkv"]
    leaves = [x[n][rows, cols].contiguous().requires_grad_() for n in "qkv"]
    ring = lambda: ring_attention_sharded(*leaves, mesh, causal=True, head_axis=None)
    if dryrun:
        s = torch.einsum("bthd,bshd->bhts", *whole[:2]) / math.sqrt(D)
        s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool, device=device).tril(), -math.inf)
        ref = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), whole[2])
        ref_name = "the dryrun's einsum oracle (f32)"
    elif dtype == torch.float32:
        ref = attention(*whole, causal=True, impl="reference")
        ref_name = "reference attention (f32)"
    else:
        ref = fa.flash_attention(*whole, True)
        ref_name = "the monolithic flash attention on rank 0"
    # the cotangent: the bf16 leg's from the seed; the f32 legs' 2 x the
    # reference's output (sum(out^2)'s at the reference), every rank the same
    do = (torch.randn(B, T, H, D, generator=g, device=device, dtype=dtype) if dtype != torch.float32
          else 2 * ref.detach())
    do_mine = do[rows, cols].contiguous()

    _zero_launches()
    out = ring()
    if dryrun:
        loss = (out.float() ** 2).sum()
        loss.backward()
        loss = loss.detach().clone()
        dist.all_reduce(loss)
    else:
        out.backward(do_mine)
    per_rank = _launches(device)
    split = {0: DATA_AXES, 1: ("cp",)}
    got = [_assemble(_gather(t), axes, split) for t in [out] + [t.grad for t in leaves]]
    if rank == 0:
        if dryrun:
            ref_loss = (ref.float() ** 2).sum()
            ref_loss.backward()
        else:
            ref.backward(do)
        want = [ref.detach()] + [t.grad for t in whole]
        names = ("o", "dq", "dk", "dv")
        if dryrun:
            dloss = abs(loss.item() - ref_loss.item()) / max(1.0, abs(ref_loss.item()))
            dgrad = max((a - b.float()).abs().max().item() for a, b in zip(got[1:], want[1:]))
            ratio = max(dloss / DRYRUN_LOSS_RTOL, dgrad / DRYRUN_GRAD_ATOL)
            gaps = (f"loss {loss.item():.4f} vs {ref_loss.item():.4f}, relative {dloss:.2e} (limit "
                    f"{DRYRUN_LOSS_RTOL}); gradients max abs {dgrad:.2e} (limit "
                    f"{DRYRUN_GRAD_ATOL})")
        elif dtype == torch.float32:
            ratios = [_tol_ratio(a, b, *tol) for a, b, tol in zip(
                got, want, [(RING_F32_TOL, RING_F32_TOL)] + [RING_F32_GRAD_TOL] * 3)]
            ratio = max(ratios)
            gaps = ", ".join(f"{n} max abs {(a - b).abs().max().item():.3e}"
                             for n, a, b in zip(names, got, want))
            gaps += (f" (limits: o rtol=atol={RING_F32_TOL}, gradients rtol {RING_F32_GRAD_TOL[0]} "
                     f"atol {RING_F32_GRAD_TOL[1]})")
        else:
            dis = {n: bench.disagreement(a, b) for n, a, b in zip(names, got, want)}
            ratio = max(_rule_ratio(d) for d in dis.values())
            gaps = ", ".join(f"{n} max abs {d['max_abs']:.3e} relnorm {d['relnorm']:.2e}"
                             for n, d in dis.items())
        where = f"{name}: ring {label} [B, T, H, Dh] = {list(shape)}"
        launches = _check_launches(where, per_rank, [
            _block(axes, r, ("cp",))[0] + 1 if cuda else 0 for r in range(WORLD)])
        print(f"{where}, causal ({nb} x B {B // nb}, {nc} x {T // nc} rows a rank): vs {ref_name}: "
              f"{gaps}; worst gap/limit {ratio:.3e}; {launches} [{card}]", flush=True)
        if not ratio <= 1.0:
            raise RuntimeError(f"{where}: the ring disagrees with {ref_name} (gap/limit {ratio})")
    del got, out
    if not cuda:
        return
    fwd = torch.no_grad()(ring)
    if dryrun:
        both = lambda: torch.autograd.grad((ring().float() ** 2).sum(), leaves)
    else:
        both = lambda: torch.autograd.grad(ring(), leaves, do_mine)
    times = _time_calls({"forward": fwd, "forward+backward": both}, bench.FLASH_KERNELS, device)
    if rank == 0:
        whole = [t.detach().clone().requires_grad_() for t in whole]
        mono_fwd = bench.time_ms(lambda: fa.flash_attention(*whole, True))
        mono_all = bench.time_ms(
            lambda: torch.autograd.grad(fa.flash_attention(*whole, True), whole, do))
        kv = 2 * B // nb * T // nc * H * D * torch.finfo(dtype).bits // 8
        acc = 2 * B // nb * T // nc * H * D * 4
        print(f"{name}: ring {label} {list(shape)} times: "
              f"{_times_text(times, 'the flash kernels')}; "
              f"a rotation sends {kv} B of K and V to the next card ({nc - 1} a forward, {nc - 1} "
              f"a backward) and the backward's {nc} rotations of dK and dV {acc} B each (f32); "
              f"the monolithic flash attention on rank 0's card, the whole sequence: forward "
              f"{mono_fwd:.3f} ms, forward+backward {mono_all:.3f} ms"
              + (f"; the emulated ring of 4 on one card (recorded, chip_smoke.py phase 5): "
                 f"{EMULATED_RING_MS}" if shape == RING_LEGS["cuda"][0][1] else "")
              + f" [{card}]", flush=True)
    dist.barrier()


def _moe_leg(name: str, mesh, axes: dict, leg: tuple, device, card: str, solo) -> None:
    """One MoE leg on ``mesh`` (see the module's docstring); rank 0 prints
    its line, and its times on the card. ``solo``: a group of rank 0 alone."""
    label, tokens, D, F, E, top_k, C, xdtype, scale = leg
    rank, cuda = dist.get_rank(), device.type == "cuda"
    dryrun = label.startswith("dryrun")
    bi, nb = _block(axes, rank, DATA_AXES + ("ep",))
    ei, ne = _block(axes, rank, ("ep",))
    El = E // ne
    g = torch.Generator(device=device).manual_seed(6)
    f32 = dict(device=device, generator=g)
    whole = [torch.randn(nb * tokens, D, **f32).to(xdtype), torch.randn(D, E, **f32) * scale,
             torch.randn(E, D, F, **f32) * scale, torch.randn(E, F, D, **f32) * scale]
    mine = [slice(bi * tokens, (bi + 1) * tokens), slice(None), slice(ei * El, (ei + 1) * El),
            slice(ei * El, (ei + 1) * El)]
    leaves = [t[s].clone().requires_grad_() for t, s in zip(whole, mine)]
    run = lambda: moe_block_sharded(*leaves, mesh, C, top_k=top_k)

    _zero_launches()
    out = run()
    loss = (out.float() ** 2).sum()
    loss.backward()
    per_rank = _launches(device)
    loss = loss.detach().clone()
    dist.all_reduce(loss)
    gx, gwg, gwin, gwout = (t.grad for t in leaves)
    dist.all_reduce(gwg)  # the router's gradient: every rank's tokens
    replicas = data_parallel_meshes(mesh)[1].get_group()  # an expert's data-parallel copies
    dist.all_reduce(gwin, group=replicas)
    dist.all_reduce(gwout, group=replicas)
    tokens_split, experts_split = {0: DATA_AXES + ("ep",)}, {0: ("ep",)}
    got = [_assemble(_gather(out), axes, tokens_split), _assemble(_gather(gx), axes, tokens_split),
           gwg.float(), _assemble(_gather(gwin), axes, experts_split),
           _assemble(_gather(gwout), axes, experts_split)]
    if rank == 0:
        ref_leaves = [t.clone().requires_grad_() for t in whole]
        ref = torch.cat([moe_block_local(ref_leaves[0][b * tokens:(b + 1) * tokens],
                                         *ref_leaves[1:], C, top_k) for b in range(nb)])
        ref_loss = (ref.float() ** 2).sum()
        ref_loss.backward()
        want = [ref.detach()] + [t.grad for t in ref_leaves]
        dloss = abs(loss.item() - ref_loss.item()) / max(1.0, abs(ref_loss.item()))
        names = ("x", "wg", "w_in", "w_out")
        if dryrun:
            dgrad = max((a - b.float()).abs().max().item() for a, b in zip(got[1:], want[1:]))
            ratio = max(dloss / DRYRUN_LOSS_RTOL, dgrad / DRYRUN_GRAD_ATOL)
            gaps = (f"loss relative {dloss:.2e} (limit {DRYRUN_LOSS_RTOL}); gradients max abs "
                    f"{dgrad:.2e} (limit {DRYRUN_GRAD_ATOL})")
        else:
            gap = bench.disagreement(got[0], want[0])
            rel = [((a - b.float()).norm() / b.float().norm()).item()
                   for a, b in zip(got[1:], want[1:])]
            ratio = max([_rule_ratio(gap), dloss / MOE_LOSS_RTOL]
                        + [r / MOE_GRAD_RELNORM for r in rel])
            gaps = (f"out max abs {gap['max_abs']:.3e} relnorm {gap['relnorm']:.2e}; loss relative "
                    f"{dloss:.2e} (limit {MOE_LOSS_RTOL}); gradient relnorm "
                    + ", ".join(f"{n} {r:.2e}" for n, r in zip(names, rel))
                    + f" (limit {MOE_GRAD_RELNORM})")
        where = f"{name}: moe {label} ({tokens} tokens a rank, D {D}, F {F}, E {E}, top-{top_k}, " \
                f"capacity {C})"
        launches = _check_launches(where, per_rank, [0] * WORLD)
        print(f"{where}, {El} experts a card: loss {loss.item():.6f} vs {ref_loss.item():.6f}; vs "
              f"moe_block_local on each rank's tokens: {gaps}; worst gap/limit {ratio:.3e}; "
              f"{launches} [{card}]", flush=True)
        if not ratio <= 1.0:
            raise RuntimeError(f"{where}: moe_block disagrees with moe_block_local "
                               f"(gap/limit {ratio})")
    del got, out
    if not cuda:
        return
    fwd = torch.no_grad()(run)
    both = lambda: torch.autograd.grad((run().float() ** 2).sum(), leaves)
    times = _time_calls({"forward": fwd, "forward+backward": both}, r"(?i)nccl", device)
    if rank == 0:
        alone = [whole[0][:tokens].clone().requires_grad_()] + \
            [t.clone().requires_grad_() for t in whole[1:]]
        one = lambda: moe_block(*alone, C, solo, top_k)
        one_fwd = bench.time_ms(torch.no_grad()(one))
        one_all = bench.time_ms(lambda: torch.autograd.grad((one().float() ** 2).sum(), alone))
        sent = ne * El * C * D * 4
        print(f"{name}: moe {label} times: {_times_text(times, 'NCCL kernels')}; each all-to-all "
              f"moves {sent} B of f32 a rank ({sent * (ne - 1) // ne} B off the card; 2 a forward, "
              f"2 more a backward); moe_block on a group of one on rank 0's card, one rank's "
              f"{tokens} tokens and all {E} experts: forward {one_fwd:.3f} ms, forward+backward "
              f"{one_all:.3f} ms [{card}]", flush=True)
    dist.barrier()


def _check_ops(meshes: dict, args, device, solo) -> None:
    """Part 1 (see the module's docstring): every leg on each mesh of
    OP_MESHES."""
    for name, axes in OP_MESHES.items():
        mesh = meshes[name]
        if axes.get("cp", 1) > 1:
            for label, shape, dtype in RING_LEGS[device.type]:
                _ring_leg(name, mesh, axes, label, shape, dtype, device, args.card)
            if name == DRYRUN_RING[0]:
                _ring_leg(name, mesh, axes, "dryrun f32", DRYRUN_RING[1], torch.float32, device,
                          args.card, dryrun=True)
        else:
            for leg in MOE_LEGS[device.type]:
                _moe_leg(name, mesh, axes, leg, device, args.card, solo)
            if name == DRYRUN_MOE[0]:
                _moe_leg(name, mesh, axes, DRYRUN_MOE[1], device, args.card, solo)
        if device.type == "cuda":
            torch.cuda.empty_cache()


def _rank_main(rank: int, port: int, args) -> None:
    if args.device == "cuda":
        torch.cuda.set_device(rank)
        device, backend = torch.device("cuda", rank), "nccl"
    else:
        torch.set_num_threads(1)
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=WORLD,
                            rank=rank)
    try:
        # every rank builds every mesh and group, in the same order: a mesh
        # creates groups
        t0 = time.perf_counter()
        meshes = {name: build_mesh(MeshConfig(**axes), device_type=args.device)
                  for name, axes in {**OP_MESHES, **MESHES}.items()}
        solo = dist.new_group([0])
        dist.barrier()
        if rank == 0:
            print(f"{len(meshes)} meshes and their groups built in "
                  f"{time.perf_counter() - t0:.2f} s [{args.card}]", flush=True)
        _check_ops(meshes, args, device, solo)
        ref = bench.setup(1, model=args.model, batch=args.batch, seq=args.seq, device=device)
        loss = gpt2.loss_fn(ref.model, ref.batches[0])
        loss.backward()
        ref_loss = loss.item()
        ref_grads = {n: p.grad for n, p in ref.model.named_parameters()}
        del ref, loss
        # each card alone at a quarter of the batch (what dp 4 gives it), no mesh
        part = args.batch // WORLD
        alone = bench.setup(WARMUP + STEPS, model=args.model, batch=part, seq=args.seq,
                            device=device)
        line = _time_steps(alone, alone.batches, device, part * args.seq)
        del alone
        if rank == 0:
            print(f"unsharded, every card alone at B {part}: {line} [{args.card}]", flush=True)
        for name in MESHES:
            line = _check_mesh(name, meshes[name], args, device, ref_loss, ref_grads)
            if rank == 0:
                print(f"{line} [{args.card}]", flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--model", default=bench.MODEL)
    parser.add_argument("--batch", type=int, default=bench.BATCH)
    parser.add_argument("--seq", type=int, default=bench.SEQ)
    args = parser.parse_args(argv)
    if args.device == "cuda":
        if torch.cuda.device_count() < WORLD:
            sys.exit(f"needs {WORLD} cards, found {torch.cuda.device_count()}")
        args.card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
        print(f"{WORLD} x {args.card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
              flush=True)
        t0 = time.perf_counter()
        libraries = [fa.OPERAND_DTYPES[torch.bfloat16], fa.OPERAND_DTYPES[torch.float32]]  # the ones it runs
        with ThreadPoolExecutor(len(libraries)) as pool:  # one nvcc a library, at once
            list(pool.map(_build.build, libraries))
        print(f"kernel libraries built in {time.perf_counter() - t0:.2f} s", flush=True)
    else:
        args.card = "CPU rehearsal, gloo: no time here is the card's"
    mp.start_processes(_rank_main, args=(_free_port(), args), nprocs=WORLD,
                       start_method="spawn")
    print("sharded step and ops across cards: every mesh held to its one-card reference",
          flush=True)


if __name__ == "__main__":
    main()

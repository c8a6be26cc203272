"""The sharded GPT-2 train step across the cards of one machine.

    python3 -m ray_tpu_torch.sharded_cards

Starts one process per card (rank r on card r, NCCL, joined at
tcp://localhost on a free port) and runs ``bench.py``'s train step
(``ray_tpu_torch.bench``: gpt2-small, B 32, T 1024, flash attention, fused
CE, no remat, AdamW) on each mesh of ``MESHES`` (world 4). Every rank:

  1. takes the unsharded step's loss and gradients on its own card, from
     the port's random init (seed 0) and batch 0 (the reference; every
     rank computes the same);
  2. for each mesh: places a fresh model of the same init with
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

Rank 0 prints one line per mesh with the card's name and power limit; a
disagreement, a launch count off the design or a rank that fails exits
non-zero. ``--device cpu`` (gloo, four processes) with a smaller
``--model``, ``--batch`` and ``--seq`` rehearses the same path on the CPU,
where the kernels' plain versions run and nothing is timed as the card's.
"""

from __future__ import annotations

import argparse
import socket
import statistics
import subprocess
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ray_tpu_torch import bench
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.parallel import MeshConfig, build_mesh, shard_model
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
        # every rank builds every mesh, in the same order: a mesh creates groups
        meshes = {name: build_mesh(MeshConfig(**axes), device_type=args.device)
                  for name, axes in MESHES.items()}
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
        for name, mesh in meshes.items():
            line = _check_mesh(name, mesh, args, device, ref_loss, ref_grads)
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
    else:
        args.card = "CPU rehearsal, gloo: no time here is the card's"
    mp.start_processes(_rank_main, args=(_free_port(), args), nprocs=WORLD,
                       start_method="spawn")
    print("sharded step across cards: every mesh held to the unsharded step", flush=True)


if __name__ == "__main__":
    main()

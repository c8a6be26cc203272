"""GPT-2 small's train, pipeline and serving paths, each worker on a card of
its own, placed by the runtime's GPU-aware scheduling.

    python3 placed_cards.py          (four cards; from the repository root)

Every worker here is a process the node agent spawns seeing only its
lease's cards (``CUDA_VISIBLE_DEVICES``; ``core/node_agent.py``). At
gpt2-small's full width and depth (12 layers, d 768, B 32, T 1024, flash
attention, fused CE, AdamW, seeded init, ``bench.py``'s tokens):

  1. the one-card yardstick, in this process on card 0: the unsharded step
     (``bench.timed_steps``, median of ``STEPS`` after ``WARMUP``);
  2. ``TorchTrainer`` with ``ScalingConfig(num_workers=n, use_gpu=True)``
     for n = 2 and 4: every worker reports its ``CUDA_VISIBLE_DEVICES`` and
     the one device it sees, and joins one NCCL process group of n; it
     takes the unsharded step's loss and gradients on its card (the
     reference), builds the data-parallel mesh of n (``build_mesh``,
     ``shard_model`` with ``gpt_rules``), holds the mesh step's loss and
     every gradient to the reference (``LOSS_TOL``, ``GRAD_RELNORM_TOL``:
     the sharded-step limits), times ``STEPS`` steps with each kernel's
     launches a step (one per layer), then takes the unsharded model's
     gradients on its B/n rows (497,903,616 bytes of f32) and times
     ``grad_sync`` over the trainer's host collective group beside
     ``dist.all_reduce`` of the same gradients over its NCCL group,
     holding the two means to each other (``SYNC_RELNORM_TOL``);
  3. ``chip_smoke.py``'s phase 8 with each of the two stages on a card of
     its own (``num_gpus`` 1): RPC, compiled and 1F1B bitwise equal, the
     step, each stage's bubble and a 12 MiB hop between the cards;
  4. two OpenAI replicas of ``serve.llm.deploy``, a card each
     (``ray_actor_options={"num_gpus": 1}``), phase 10's 24 requests at once
     over SSE: TTFT p50 and p95 at the first SSE event, output tokens/s,
     every greedy text held to an in-process engine's;
  5. two NVLink domains on the one machine: two node agents of a
     ``Cluster``, one seeing cards 0 and 1, the other cards 2 and 3
     (``CUDA_VISIBLE_DEVICES``, so each leases only its own), a
     ``slice_placement_group`` of the two-card domain with ``num_slices=2``,
     and one ``num_gpus=1`` actor pinned to each bundle
     (``worker_strategy``); each joins one NCCL group of four through
     ``coordinator_env`` and ``initialize_process_group`` (ranks
     domain-major), reports its slice id, rank and the one card it sees,
     and runs the step on ``build_mesh(MeshConfig(dcn=2, dp=1, tp=2))``,
     whose dcn axis is the domain boundary: held to the unsharded step as
     in part 2 and timed, beside ``sharded_cards``' "dcn 2 x tp 2" (the
     same mesh over one group of four processes, recorded);
  6. Tune on the four cards: six trials of ``chip_smoke.py`` phase 15's
     trainable (gpt2-small's step at the trial's lr, ``tune.report`` after
     each of 5 steps) over an lr grid at ``{"GPU": 1}`` with
     ``max_concurrent_trials=6``: at most four run at once, those running
     at once see distinct single cards, every card is used, the last two
     start only once a card is freed, each trial launches each kernel once
     a layer a step; then the same search under ``ASHAScheduler`` (the
     trials 200 steps long): a stopped trial's card goes back and a waiting
     trial takes it;
  7. the autoscaler with two domains: a ``Cluster`` whose head node sees no
     card, an ``Autoscaler`` over ``GpuDomainProvider`` with the card sets
     0,1 and 2,3; a pending ``slice_placement_group(..., num_slices=2)``
     makes exactly two domains, one agent each seeing only its set, the
     gang is reserved on them, and part 5's workers run ``dcn 2 x tp 2``
     over the provisioned agents, held and timed as in part 5; after
     ``remove()`` both domains are terminated and their sets are back.

Prints each reading with the card's name and power limit, then one JSON
line of the numbers (the last line); a disagreement, a launch count off
the design, a worker that sees other than its own card, or a failed run
exits non-zero. ``--device cpu`` rehearses parts 2, 5 and 7 on the CPU:
four cards declared on a host that has none, each worker's bundle asking
for one through ``resources_per_worker`` (``DataParallelTrainer``, whose
workers join gloo when ``gpus_per_worker`` is 0); then two hosts of two
declared cards, each with its domain's head, the slice workers joining
gloo; then the provider's domains declaring their two cards and head (no
card sets); a smaller ``--model``, ``--batch`` and ``--seq``; nothing is
timed as the card's. It shares phases 8, 10 and 15 with ``chip_smoke.py``,
beside it at the repository root.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from chip_smoke import AS_IDLE_S, AS_TERMINATE_S, autoscaled_domains
from ray_tpu_torch import bench

WORLDS = (2, 4)
CARDS = 4
WARMUP, STEPS = 2, 5
# The sharded-step limits (sharded_cards.py, chip_smoke.py): a change of
# rounding through 12 bf16 layers.
LOSS_TOL, GRAD_RELNORM_TOL = 5e-4, 2e-2
# grad_sync's mean against all_reduce's: the same f32 sums in another order.
SYNC_RELNORM_TOL = 1e-6
SYNC_TIMED = 3  # all_reduce calls timed after one that builds NCCL's communicator
RECORDS = "placed_cards"  # the workers' records in the control store KV
# Part 5: two NVLink domains of two cards each on the four-card machine,
# and the mesh whose outermost axis spans them.
SLICES, SLICE_CARDS = 2, 2
SLICE_MESH = dict(dcn=2, dp=1, tp=2)
CPU_CARD_NAME = "NVIDIA H100 80GB HBM3"  # the cards the CPU rehearsal declares
# Part 6: six trials over an lr grid, a card each; the ASHA search's trials
# run ASHA_STEPS steps (by device), long enough that the controller, which
# polls each trial in turn, reads a rung's report while the trial still runs.
TUNE_LRS = (1e-4, 2e-4, 3e-4, 6e-4, 1e-3, 2e-3)
ASHA_STEPS = {"cuda": 200, "cpu": 600}
# sharded_cards' "dcn 2 x tp 2" (the same mesh over one group of four
# processes, gpt2-small, B 32, T 1024) on four NVIDIA H100 80GB HBM3 at
# 700 W, the run before this script's in one call: recorded, printed as
# text beside part 5's reading.
SHARDED_DCN_TP_MS = ("median of 5 steps 158.53 ms (158.53, 189.46, 157.58, 135.58, 439.11), "
                     "rank 0 device busy 63.97 ms of a profiled step")


def _relnorm(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def _mesh_step(mesh, kw: dict, rank: int) -> dict:
    """This rank's part of one mesh's check: the unsharded step on this card
    (the whole batch: the reference), then the mesh step (``shard_model``
    with ``gpt_rules``) held to it, then ``STEPS`` timed steps with each
    kernel's launches a step (profiled on rank 0 of a card). Returns the
    record's numbers."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import shard_model
    from ray_tpu_torch.parallel.sharding import full_parameters, gpt_rules

    ref = bench.setup(1, **kw)
    loss = gpt2.loss_fn(ref.model, ref.batches[0])
    loss.backward()
    ref_loss = loss.item()
    ref_grads = {n: p.grad for n, p in ref.model.named_parameters()}
    del ref, loss
    run = bench.setup(1 + WARMUP + STEPS, **kw, place=lambda m: shard_model(m, mesh, gpt_rules()))
    loss = gpt2.loss_fn(run.model, gpt2.local_rows(run.model, run.batches[0]))
    loss.backward()
    rec = {"loss": gpt2.data_mean(run.model, loss).item(), "ref_loss": ref_loss}
    rel = bench.relnorms(full_parameters(run.model, grads=True), ref_grads)
    run.model.zero_grad(set_to_none=True)
    del ref_grads
    worst = max(rel.items(), key=lambda kv: kv[1])
    rec.update(worst_relnorm=worst[1], worst_leaf=worst[0],
               median_relnorm=statistics.median(rel.values()), leaves=len(rel))
    cuda = kw["device"].type == "cuda"
    times, per_step, peak, busy = bench.timed_steps(run, run.batches[1:], WARMUP,
                                                    profile=cuda and rank == 0)
    rec.update(step_ms=times, launches=per_step, peak_gib=peak, busy_ms=busy)
    return rec


def train_fn(config: dict) -> None:
    """One TorchTrainer worker of part 2 (see the module's docstring). Its
    record goes to the control store KV under ``<world>/<rank>``."""
    import torch.distributed as dist

    import ray_tpu_torch.train as train
    from ray_tpu_torch import collective
    from ray_tpu_torch.collective import process_group
    from ray_tpu_torch.core import worker as worker_mod
    from ray_tpu_torch.parallel import MeshConfig, build_mesh

    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    device = torch.device(config["device"])
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if not cuda:
        torch.set_num_threads(1)
    kw = dict(model=config["model"], batch=config["batch"], seq=config["seq"], device=device)
    rec = {"rank": rank, "pid": os.getpid(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "cards": torch.cuda.device_count(), "backend": dist.get_backend(),
           "world": dist.get_world_size(), "pg_init_ms": process_group.last_init_s * 1e3}
    if cuda:
        rec["uuid"] = str(getattr(torch.cuda.get_device_properties(0), "uuid", ""))

    mesh = build_mesh(MeshConfig(dp=world), device_type=device.type)
    rec.update(_mesh_step(mesh, kw, rank))
    if cuda:
        torch.cuda.empty_cache()

    # grad_sync (host collectives) beside all_reduce (NCCL) on the same
    # gradients: the unsharded model on this rank's rows of batch 0
    one = bench.setup(1, **kw)
    rows = config["batch"] // world
    one.model.loss(one.batches[0][rank * rows:(rank + 1) * rows]).backward()
    grads = {n: p.grad for n, p in one.model.named_parameters()}
    rec["grad_bytes"] = sum(g.numel() * g.element_size() for g in grads.values())
    sync()
    collective.barrier(ctx.collective_group)
    t0 = time.perf_counter()
    handle = collective.grad_sync(grads, group_name=ctx.collective_group)
    synced = handle.join()
    rec["grad_sync_ms"] = (time.perf_counter() - t0) * 1e3
    rec["grad_sync_hidden"] = handle.stats.get("hidden_frac")
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    ar_ms = []
    for i in range(1 + SYNC_TIMED):
        out = flat.clone()
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        dist.all_reduce(out)
        out /= world
        sync()
        if i:
            ar_ms.append((time.perf_counter() - t0) * 1e3)
    rec["all_reduce_ms"] = ar_ms
    host = torch.cat([torch.from_numpy(synced[n]).reshape(-1) for n in grads])
    rec["sync_vs_all_reduce"] = _relnorm(host, out.cpu())
    worker_mod.global_worker().control.call(
        "kv_put", ns=RECORDS, key=f"{world}/{rank}", value=json.dumps(rec).encode(),
        retryable=True)
    train.report({"rank": rank})


def _fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def trainers(args, card: str, one_card_ms: float) -> dict:
    """Part 2: TorchTrainer on each world of WORLDS. Returns the numbers."""
    import ray_tpu_torch
    from ray_tpu_torch.core import worker as worker_mod
    from ray_tpu_torch.train import DataParallelTrainer, RunConfig, ScalingConfig, TorchTrainer

    cuda = args.device == "cuda"
    design = bench.config(args.model).n_layer if cuda else 0
    out = {}
    base = tempfile.mkdtemp(prefix="placed_cards_")
    # on the CPU, four cards declared on a host that has none
    ray_tpu_torch.init(num_cpus=CARDS + 2, **({} if cuda else {"num_gpus": CARDS}))
    try:
        control = worker_mod.global_worker().control
        for world in WORLDS:
            if cuda:  # a card a worker, NCCL
                trainer, scaling = TorchTrainer, ScalingConfig(num_workers=world, use_gpu=True)
            else:  # a declared card a worker, gloo
                trainer, scaling = DataParallelTrainer, ScalingConfig(
                    num_workers=world, use_gpu=True, resources_per_worker={"GPU": 1.0})
            t0 = time.perf_counter()
            result = trainer(
                train_fn, train_loop_config=dict(device=args.device, model=args.model,
                                                 batch=args.batch, seq=args.seq),
                scaling_config=scaling,
                run_config=RunConfig(name=f"dp{world}", storage_path=base)).fit()
            fit_s = time.perf_counter() - t0
            if result.error is not None:
                _fail(f"TorchTrainer on {world} workers: {result.error}")
            recs = [json.loads(control.call("kv_get", ns=RECORDS, key=f"{world}/{r}"))
                    for r in range(world)]
            out[world] = _check_world(world, recs, design, card, fit_s, one_card_ms, args)
    finally:
        ray_tpu_torch.shutdown()
    return out


def _check_world(world: int, recs: list, design: int, card: str, fit_s: float,
                 one_card_ms: float, args) -> dict:
    seen = [r["visible"] for r in recs]
    print(f"TorchTrainer, {world} workers (ScalingConfig(num_workers={world}, use_gpu=True)), "
          f"fit() {fit_s:.1f} s: process group {recs[0]['backend']} of {recs[0]['world']}; "
          f"each worker's CUDA_VISIBLE_DEVICES {seen}, devices seen "
          f"{[r['cards'] for r in recs]}, pids {[r['pid'] for r in recs]}, the group's join "
          f"{', '.join(f'{r['pg_init_ms']:.0f}' for r in recs)} ms [{card}]", flush=True)
    cuda = args.device == "cuda"
    if len(set(seen)) != world or (cuda and (any(r["cards"] != 1 for r in recs)
                                             or len({r["uuid"] for r in recs}) != world)):
        _fail(f"{world} workers did not each see one card of their own: {recs}")
    if any(r["backend"] != ("nccl" if cuda else "gloo") or r["world"] != world for r in recs):
        _fail(f"the workers' process groups: {[(r['backend'], r['world']) for r in recs]}")
    for r in recs:
        if not abs(r["loss"] - r["ref_loss"]) <= LOSS_TOL or not r["worst_relnorm"] <= GRAD_RELNORM_TOL:
            _fail(f"rank {r['rank']} of {world}: loss {r['loss']} vs {r['ref_loss']}, gradient "
                  f"{r['worst_leaf']} relnorm {r['worst_relnorm']}")
        if r["launches"] != dict.fromkeys(r["launches"], design) or not r["launches"]:
            _fail(f"rank {r['rank']} of {world} launched {r['launches']} a step; the design says "
                  f"{design} of each")
        if not r["sync_vs_all_reduce"] <= SYNC_RELNORM_TOL:
            _fail(f"rank {r['rank']} of {world}: grad_sync's mean and all_reduce's differ by "
                  f"{r['sync_vs_all_reduce']}")
    r0 = recs[0]
    step = statistics.median(statistics.median(r["step_ms"]) for r in recs)
    tokens = args.batch * args.seq
    sync_ms = [r["grad_sync_ms"] for r in recs]
    ar = [statistics.median(r["all_reduce_ms"]) for r in recs]
    print(f"  dp {world}: loss {r0['loss']:.6f} (unsharded {r0['ref_loss']:.6f}, gap "
          f"{abs(r0['loss'] - r0['ref_loss']):.3e}, limit {LOSS_TOL}); gradients over "
          f"{r0['leaves']} leaves, the worst of the ranks' largest relnorms "
          f"{max(r['worst_relnorm'] for r in recs):.3e} ({r0['worst_leaf']} on rank 0), median "
          f"{r0['median_relnorm']:.3e} (limit {GRAD_RELNORM_TOL}); step: median over ranks of "
          f"each rank's median of {STEPS} {step:.2f} ms ({tokens / step * 1e3:.1f} tokens/s, "
          f"{tokens / step * 1e3 / world:.1f} a card; one card alone {one_card_ms:.2f} ms, "
          f"{tokens / one_card_ms * 1e3:.1f} tokens/s); rank 0: steps "
          f"{', '.join(f'{t:.2f}' for t in r0['step_ms'])}, device busy {r0['busy_ms']:.2f} ms "
          f"of a profiled step, peak {r0['peak_gib']:.2f} GiB; launches a step per worker "
          f"{r0['launches']} [{card}]", flush=True)
    print(f"  dp {world}: gradients of {r0['grad_bytes']} bytes: grad_sync (host collectives, "
          f"p2p ring) {', '.join(f'{t:.1f}' for t in sync_ms)} ms a rank (hidden "
          f"{', '.join(str(r['grad_sync_hidden']) for r in recs)}); dist.all_reduce over the "
          f"trainer's {r0['backend']} group, median of {SYNC_TIMED}: "
          f"{', '.join(f'{t:.2f}' for t in ar)} ms a rank; the two means' relnorm "
          f"{max(r['sync_vs_all_reduce'] for r in recs):.3e} (limit {SYNC_RELNORM_TOL}) "
          f"[{card}]", flush=True)
    return {"visible": seen, "step_ms": step, "tokens_s": tokens / step * 1e3,
            "tokens_s_per_card": tokens / step * 1e3 / world, "loss_gap": abs(r0["loss"] - r0["ref_loss"]),
            "worst_relnorm": max(r["worst_relnorm"] for r in recs),
            "launches_a_step_per_worker": r0["launches"], "busy_ms_rank0": r0["busy_ms"],
            "grad_bytes": r0["grad_bytes"], "grad_sync_ms": sync_ms, "all_reduce_ms": ar,
            "pg_init_ms": [r["pg_init_ms"] for r in recs]}


class SliceWorker:
    """One worker of part 5, pinned to its bundle of a slice's group."""

    def run(self, config: dict, rank: int, slice_id: int) -> dict:
        """Join the gang's process group as ``rank`` of slice ``slice_id``
        and run the mesh step; returns the record."""
        import torch.distributed as dist

        import ray_tpu_torch
        from ray_tpu_torch.collective import process_group
        from ray_tpu_torch.parallel import MeshConfig, build_mesh

        device = torch.device(config["device"])
        cuda = device.type == "cuda"
        if not cuda:
            torch.set_num_threads(1)
        world = SLICES * SLICE_CARDS
        env = process_group.coordinator_env(config["group"], rank, world, SLICES, slice_id)
        os.environ.update(env)
        process_group.initialize_process_group(config["group"], rank, world,
                                               "nccl" if cuda else "gloo")
        try:
            mesh = build_mesh(MeshConfig(**SLICE_MESH), device_type=device.type)
            rec = {"rank": rank, "slice": int(os.environ[process_group.SLICE_ID_ENV]),
                   "dcn": mesh.get_coordinate()[0], "pid": os.getpid(),
                   "coordinator": f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                   "node": ray_tpu_torch.get_runtime_context().get_node_id(),
                   "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                   "cards": torch.cuda.device_count(), "backend": dist.get_backend(),
                   "world": dist.get_world_size(), "pg_init_ms": process_group.last_init_s * 1e3}
            if cuda:
                rec["uuid"] = str(getattr(torch.cuda.get_device_properties(0), "uuid", ""))
            kw = dict(model=config["model"], batch=config["batch"], seq=config["seq"],
                      device=device)
            rec.update(_mesh_step(mesh, kw, rank))
        finally:
            dist.destroy_process_group()
        return rec


def multislice(args, card: str) -> dict:
    """Part 5: two NVLink domains, a slice each, one process group. Returns
    the numbers."""
    import ray_tpu_torch
    from ray_tpu_torch.accelerators import slice_placement_group
    from ray_tpu_torch.accelerators.gpu import domain_head_resource, domain_type
    from ray_tpu_torch.core.cluster_utils import Cluster

    cuda = args.device == "cuda"
    domain = domain_type(torch.cuda.get_device_name(0) if cuda else CPU_CARD_NAME, SLICE_CARDS)
    c = Cluster()
    try:
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        try:
            for s in range(SLICES):
                if cuda:  # the agent sees, and leases, only its domain's cards
                    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(
                        str(s * SLICE_CARDS + i) for i in range(SLICE_CARDS))
                    c.add_node(num_cpus=SLICE_CARDS + 1, num_gpus=SLICE_CARDS)
                else:  # declared cards, and the head a host of them carries
                    c.add_node(num_cpus=SLICE_CARDS + 1, num_gpus=SLICE_CARDS,
                               resources={domain_head_resource(domain): 1})
        finally:
            if saved is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved
        ray_tpu_torch.init(address=c.address)
        heads = ray_tpu_torch.cluster_resources().get(domain_head_resource(domain))
        spg = slice_placement_group(domain, cards_per_worker=1, num_slices=SLICES)
        t0 = time.perf_counter()
        if not spg.wait(120):
            _fail(f"{SLICES} domains of {domain} not reserved in 120 s (heads: {heads})")
        reserve_s = time.perf_counter() - t0
        recs, run_s = _slice_workers(spg, args, "placed_cards_slices")
        spg.remove()
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
    design = bench.config(args.model).n_layer if cuda else 0
    return _check_slices(recs, design, card, domain, reserve_s, run_s, args)


def _slice_workers(spg, args, group: str) -> tuple:
    """A ``num_gpus=1`` SliceWorker pinned to each bundle of the reserved
    gang, all joining one process group ``group``: (their records, the
    seconds they took)."""
    import ray_tpu_torch

    worker = ray_tpu_torch.remote(num_gpus=1, num_cpus=0)(SliceWorker)
    config = dict(device=args.device, model=args.model, batch=args.batch, seq=args.seq,
                  group=group)
    # the handles stay in this list until the records are in: a dropped
    # handle kills its actor
    actors = [worker.options(scheduling_strategy=spg.worker_strategy(s, w)).remote()
              for s in range(spg.num_slices) for w in range(spg.num_workers_per_slice)]
    refs = [a.run.remote(config, rank, rank // spg.num_workers_per_slice)
            for rank, a in enumerate(actors)]
    t0 = time.perf_counter()
    recs = ray_tpu_torch.get(refs, timeout=900)
    run_s = time.perf_counter() - t0
    for a in actors:
        ray_tpu_torch.kill(a)
    return recs, run_s


def _check_slices(recs: list, design: int, card: str, domain: str, reserve_s: float,
                  run_s: float, args) -> dict:
    cuda = args.device == "cuda"
    world = SLICES * SLICE_CARDS
    agents = "agents on cards 0,1 and 2,3" if cuda else "two hosts of declared cards"
    print(f"two NVLink domains ({domain} x {SLICES}; {agents}): "
          f"slice_placement_group(num_slices={SLICES}) reserved in {reserve_s:.2f} s, the workers "
          f"ran in {run_s:.1f} s; each worker (slice, rank, CUDA_VISIBLE_DEVICES, devices seen, "
          f"dcn coordinate): "
          + ", ".join(f"({r['slice']}, {r['rank']}, {r['visible']}, {r['cards']}, {r['dcn']})"
                      for r in recs)
          + f"; process group {recs[0]['backend']} of {recs[0]['world']} at one coordinator "
          f"{sorted({r['coordinator'] for r in recs})}, joined in "
          f"{', '.join(f'{r['pg_init_ms']:.0f}' for r in recs)} ms [{card}]", flush=True)
    by_slice = {}
    for r in recs:
        by_slice.setdefault(r["slice"], []).append(r)
    if any(r["slice"] != r["rank"] // SLICE_CARDS or r["dcn"] != r["slice"] for r in recs):
        _fail(f"ranks are not domain-major or the dcn axis is not the domain boundary: {recs}")
    if len({r["coordinator"] for r in recs}) != 1 or any(
            r["world"] != world or r["backend"] != ("nccl" if cuda else "gloo") for r in recs):
        _fail(f"the workers did not join one group of {world}: {recs}")
    if len({r["node"] for r in recs}) != SLICES or any(
            len({r["node"] for r in rs}) != 1 for rs in by_slice.values()):
        _fail(f"each slice is not on one host of its own: {recs}")
    seen = {s: sorted(r["visible"] for r in rs) for s, rs in by_slice.items()}
    # on the card each agent's own cards: one domain 0,1, the other 2,3
    domains = sorted(seen.values())
    want = ([[str(s * SLICE_CARDS + i) for i in range(SLICE_CARDS)] for s in range(SLICES)]
            if cuda else [[str(i) for i in range(SLICE_CARDS)]] * SLICES)
    if domains != want or (cuda and (any(r["cards"] != 1 for r in recs)
                                     or len({r["uuid"] for r in recs}) != world)):
        _fail(f"the slices' workers did not each see one card of their own domain: {seen}")
    for r in recs:
        if not (abs(r["loss"] - r["ref_loss"]) <= LOSS_TOL
                and r["worst_relnorm"] <= GRAD_RELNORM_TOL):
            _fail(f"rank {r['rank']}: loss {r['loss']} vs {r['ref_loss']}, gradient "
                  f"{r['worst_leaf']} relnorm {r['worst_relnorm']}")
        if r["launches"] != dict.fromkeys(r["launches"], design) or not r["launches"]:
            _fail(f"rank {r['rank']} launched {r['launches']} a step; the design says {design} "
                  f"of each")
    r0 = min(recs, key=lambda r: r["rank"])
    meds = [statistics.median(r["step_ms"]) for r in sorted(recs, key=lambda r: r["rank"])]
    tokens = args.batch * args.seq
    slowest = max(meds)
    print(f"  dcn 2 x tp 2 across the two domains: loss {r0['loss']:.6f} (unsharded "
          f"{r0['ref_loss']:.6f}, gap {abs(r0['loss'] - r0['ref_loss']):.3e}, limit {LOSS_TOL}); "
          f"gradients over {r0['leaves']} leaves, the worst of the ranks' largest relnorms "
          f"{max(r['worst_relnorm'] for r in recs):.3e} (limit {GRAD_RELNORM_TOL}); step: every "
          f"rank's median of {STEPS} {', '.join(f'{m:.2f}' for m in meds)} ms, the slowest "
          f"{slowest:.2f} ms ({tokens / slowest * 1e3:.1f} tokens/s); rank 0: device busy "
          f"{r0['busy_ms']:.2f} ms of a profiled step, peak {r0['peak_gib']:.2f} GiB; launches a "
          f"step per worker {r0['launches']}; sharded_cards' dcn 2 x tp 2 (recorded): "
          f"{SHARDED_DCN_TP_MS} [{card}]", flush=True)
    return {"slices": {str(s): v for s, v in seen.items()}, "step_ms": meds,
            "slowest_step_ms": slowest, "loss_gap": abs(r0["loss"] - r0["ref_loss"]),
            "worst_relnorm": max(r["worst_relnorm"] for r in recs),
            "launches_a_step_per_worker": r0["launches"], "busy_ms_rank0": r0["busy_ms"],
            "pg_init_ms": [r["pg_init_ms"] for r in recs], "reserve_s": reserve_s}


def _intervals_overlap(a: dict, b: dict) -> bool:
    return a["start"] < b["end"] and b["start"] < a["end"]


def _trials(grid, cards: list, design: int, cuda: bool, card: str, what: str) -> list:
    """Each trial of a search as a record (lr, card, start, end, reports),
    in start order, after the checks every search of part 6 shares: no
    error, finite losses, every trial's step 0 the same loss, each kernel
    ``design`` launches a step, and each trial's worker seeing one card."""
    if grid.num_errors:
        _fail(f"{what}: {[r.error for r in grid if r.error]}")
    recs = []
    for r in grid:
        reps = r.all_reports
        if not reps or not all(math.isfinite(x["loss"]) for x in reps):
            _fail(f"{what}: trial lr {r.config['lr']:g} reported {reps}")
        recs.append({"lr": r.config["lr"], "visible": reps[0]["visible"], "uuid": reps[0]["uuid"],
                     "cards": reps[0]["cards"], "start": reps[0]["start"], "end": reps[-1]["t"],
                     "stopped": r.stopped_early, "reports": reps})
    recs.sort(key=lambda x: x["start"])
    loss0 = {x["reports"][0]["loss"] for x in recs}
    if max(loss0) - min(loss0) > LOSS_TOL:
        _fail(f"{what}: the trials' step-0 losses differ: {sorted(loss0)}")
    for x in recs:
        if x["visible"] not in cards or x["cards"] != (1 if cuda else 0):
            _fail(f"{what}: trial lr {x['lr']:g} saw {x['visible']!r} ({x['cards']} cards)")
        if any(rep["launches"] != dict.fromkeys(rep["launches"], design) or not rep["launches"]
               for rep in x["reports"]):
            _fail(f"{what}: trial lr {x['lr']:g} launched "
                  f"{[rep['launches'] for rep in x['reports']]}; the design says {design} of each")
    # the trials running at any one moment: at most one a card, each on
    # a card of its own
    for x in recs:
        at_start = [y for y in recs if y["start"] <= x["start"] < y["end"]]
        if len(at_start) > len(cards):
            _fail(f"{what}: {len(at_start)} trials at once on {len(cards)} cards")
    for i, x in enumerate(recs):
        for y in recs[i + 1:]:
            if _intervals_overlap(x, y) and (x["visible"] == y["visible"]
                                             or (cuda and x["uuid"] == y["uuid"])):
                _fail(f"{what}: trials lr {x['lr']:g} and {y['lr']:g} ran at once on one "
                      f"card ({x['visible']}, {x['uuid']})")
    t0 = recs[0]["start"]
    for x in recs:
        ms = statistics.median(rep["ms"] for rep in x["reports"][1:])
        print(f"  {what}: lr {x['lr']:g} on CUDA_VISIBLE_DEVICES {x['visible']!r} from "
              f"{x['start'] - t0:.2f} s to {x['end'] - t0:.2f} s, {len(x['reports'])} steps "
              f"(median {ms:.2f} ms), stopped early {x['stopped']}, launches a step "
              f"{x['reports'][-1]['launches']} [{card}]", flush=True)
    return recs


def tune_on_cards(args, card: str) -> dict:
    """Part 6: six trials at {"GPU": 1} on the four cards, under FIFO and
    under ASHA. Returns the numbers."""
    import chip_smoke
    import ray_tpu_torch
    from ray_tpu_torch import tune

    cuda = args.device == "cuda"
    design = bench.config(args.model).n_layer if cuda else 0
    cards = [str(i) for i in range(CARDS)]
    setup = {} if cuda else dict(model=args.model, batch=args.batch, seq=args.seq, device="cpu")
    base = tempfile.mkdtemp(prefix="placed_cards_tune_")
    ray_tpu_torch.init(num_cpus=CARDS + 2, **({} if cuda else {"num_gpus": CARDS}))
    out = {}
    try:
        for name, steps, scheduler in (
                ("fifo", chip_smoke.N_STEPS, None),
                ("asha", ASHA_STEPS[args.device],
                 tune.ASHAScheduler(metric="loss", mode="min", max_t=ASHA_STEPS[args.device] + 1,
                                    grace_period=1, reduction_factor=2))):
            t0 = time.perf_counter()
            grid = tune.Tuner(
                tune.with_resources(chip_smoke.tune_trainable, {"GPU": 1}),
                param_space={"lr": tune.grid_search(list(TUNE_LRS)), "steps": steps,
                             "setup": setup},
                tune_config=tune.TuneConfig(metric="loss", mode="min",
                                            max_concurrent_trials=len(TUNE_LRS),
                                            scheduler=scheduler),
                run_dir=os.path.join(base, name)).fit()
            fit_s = time.perf_counter() - t0
            what = f"tune {name}, {len(TUNE_LRS)} trials on {CARDS} cards"
            print(f"{what}: fit() {fit_s:.1f} s [{card}]", flush=True)
            recs = _trials(grid, cards, design, cuda, card, what)
            if len(recs) != len(TUNE_LRS) or {x["visible"] for x in recs} != set(cards):
                _fail(f"{what}: {len(recs)} trials on cards {sorted({x['visible'] for x in recs})}")
            if cuda and len({x["uuid"] for x in recs}) != CARDS:
                _fail(f"{what}: the trials' cards {sorted({x['uuid'] for x in recs})}")
            late = recs[CARDS:]
            for x in late:  # it waited for a card that a trial before it gave back
                freed = [y for y in recs if y["end"] <= x["start"] and y["visible"] == x["visible"]]
                if not freed:
                    _fail(f"{what}: trial lr {x['lr']:g} started on {x['visible']} before a "
                          f"trial gave that card back")
            if name == "fifo":
                if any(x["stopped"] or len(x["reports"]) != steps for x in recs):
                    _fail(f"{what}: a trial stopped early or short")
            else:
                stopped = [x for x in recs if x["stopped"]]
                took = [(y, x) for x in late for y in stopped
                        if y["end"] <= x["start"] and y["visible"] == x["visible"]]
                print(f"  {what}: {len(stopped)} stopped early (lr "
                      f"{[y['lr'] for y in stopped]}); a waiting trial took a stopped trial's "
                      f"card: {[(y['lr'], x['lr'], x['visible']) for y, x in took]} [{card}]",
                      flush=True)
                if not stopped or not took:
                    _fail(f"{what}: no stopped trial's card went to a waiting trial")
            best = grid.get_best_result()
            out[name] = {"fit_s": fit_s, "best_lr": best.config["lr"],
                         "cards": {str(x["lr"]): x["visible"] for x in recs},
                         "stopped": [x["lr"] for x in recs if x["stopped"]],
                         "step_ms": {str(x["lr"]): statistics.median(
                             rep["ms"] for rep in x["reports"][1:]) for x in recs},
                         "launches_a_step": recs[0]["reports"][-1]["launches"]}
    finally:
        ray_tpu_torch.shutdown()
    return out


def autoscaled_slices(args, card: str) -> dict:
    """Part 7: the autoscaler provisions two NVLink domains for a pending
    gang of two (``chip_smoke.autoscaled_domains``), part 5's workers run
    on them, and the domains go after ``remove()``. Returns the numbers."""
    from ray_tpu_torch.accelerators.gpu import domain_type

    cuda = args.device == "cuda"
    domain = domain_type(torch.cuda.get_device_name(0) if cuda else CPU_CARD_NAME, SLICE_CARDS)
    sets = [[str(s * SLICE_CARDS + i) for i in range(SLICE_CARDS)] for s in range(SLICES)]
    # on the CPU, no card sets: each domain declares its cards and head
    d = autoscaled_domains(domain, sets if cuda else None, SLICES,
                           lambda spg: _slice_workers(spg, args, "placed_cards_autoscaled"))
    seen, (recs, run_s) = d["agents_visible"], d["result"]
    print(f"autoscaler: {d['made']} domains of {domain} provisioned for a pending gang of "
          f"{SLICES}, registered {d['registered_s']:.2f} s and reserved {d['reserved_s']:.2f} s "
          f"after the gang's creation; the agents' CUDA_VISIBLE_DEVICES {seen} [{card}]",
          flush=True)
    if d["made"] != SLICES or len(d["nodes"]) != SLICES or d["locs"] != set(d["nodes"]):
        _fail(f"the autoscaler made {d['made']} domains for a gang of {SLICES}: {d}")
    if cuda and seen != [",".join(cs) for cs in sets]:
        _fail(f"the domains' agents did not each see only their set: {seen}")
    print(f"autoscaler: after remove() both domains were terminated in {d['gone_s']:.2f} s "
          f"(idle timeout {AS_IDLE_S} s); free card sets {d['free']} [{card}]", flush=True)
    if d["gone_s"] >= AS_TERMINATE_S or (cuda and sorted(d["free"]) != sets):
        _fail(f"the removed gang's domains did not go: {d['gone_s']:.2f} s, free sets "
              f"{d['free']}")
    design = bench.config(args.model).n_layer if cuda else 0
    got = _check_slices(recs, design, card, domain, d["reserved_s"], run_s, args)
    return dict(got, terminated_s=d["gone_s"], agents_visible=seen)


def one_card_step(args, card: str) -> float:
    """Part 1: the unsharded step on card 0 of this process. Returns its
    median ms."""
    run = bench.setup(WARMUP + STEPS, model=args.model, batch=args.batch, seq=args.seq)
    times, per_step, peak, busy = bench.timed_steps(run, run.batches, WARMUP)
    med = statistics.median(times)
    print(f"one card: the unsharded step ({args.model}, B {args.batch}, T {args.seq}) median of "
          f"{STEPS} {med:.2f} ms ({', '.join(f'{t:.2f}' for t in times)}), "
          f"{args.batch * args.seq / med * 1e3:.1f} tokens/s, device busy {busy:.2f} ms, peak "
          f"{peak:.2f} GiB, launches a step {per_step} [{card}]", flush=True)
    del run
    torch.cuda.empty_cache()
    return med


def serve_on_cards(card: str) -> dict:
    """Part 4: two OpenAI replicas, a card each, phase 10's burst."""
    import chip_smoke as cs
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve import llm
    from ray_tpu_torch.serve.openai.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    cfg = gpt2.CONFIGS[cs.SERVE_MODEL]
    traffic = cs.front_traffic(cfg.vocab_size)
    greedy = [r for r in traffic if r["temperature"] == 0]
    models = {cs.SERVE_MODEL: llm.LLMConfig(model_id=cs.SERVE_MODEL,
                                            max_batch_size=cs.SERVE_BATCH)}
    ray_tpu_torch.init(num_cpus=4)
    try:
        serve.start(http_port=0)
        t0 = time.perf_counter()
        llm.deploy(models, name=cs.FRONT_NAME, num_replicas=cs.FRONT_REPLICAS,
                   ray_actor_options={"num_gpus": 1})
        addr = cs.proxy_address()
        fingerprints, users = set(), 0
        while len(fingerprints) < cs.FRONT_REPLICAS and users < 64:
            st, body = cs.http_json(addr, "/v1/completions", {
                "model": cs.SERVE_MODEL, "prompt": "warm", "max_tokens": 1, "temperature": 0,
                "user": f"warm-{users}"})
            if st != 200:
                _fail(f"a completion answered {st}: {body}")
            fingerprints.add(body.get("system_fingerprint"))
            users += 1
        startup_s = time.perf_counter() - t0
        placed = cs.replica_cards(cs.serve_processes())
        print(f"serve: {cs.FRONT_REPLICAS} replicas, a card each, warm {startup_s:.2f} s after "
              f"deploy; their CUDA_VISIBLE_DEVICES {placed} [{card}]", flush=True)
        if len(placed) != cs.FRONT_REPLICAS or len(set(placed.values())) != cs.FRONT_REPLICAS:
            _fail(f"the replicas did not each see a card of their own: {placed}")
        texts, ttfts, rate = cs.front_burst(addr, traffic)
        ref_srv = cs.make_server()
        try:
            prompts = [tok.encode(r["prompt"]) for r in greedy]
            refs = [cs.ask(ref_srv, {"prompt_tokens": p, "max_new_tokens": cs.MAX_NEW,
                                     "temperature": 0.0}) for p in prompts]
            cs.check_front_texts("the SSE burst on two cards (greedy) vs the in-process engine",
                                 [t for t, r in zip(texts, traffic) if r["temperature"] == 0],
                                 refs, prompts, tok, ref_srv.model, cfg)
        finally:
            cs.stop_server(ref_srv)
        got = {"p50": cs._percentile_ms(ttfts, 50), "p95": cs._percentile_ms(ttfts, 95),
               "tok_s": rate, "visible": sorted(placed.values())}
        print(f"{len(traffic)} requests at once, front door, {cs.FRONT_REPLICAS} replicas on a "
              f"card each: TTFT p50 {got['p50']:.2f} ms, p95 {got['p95']:.2f} ms, "
              f"{rate:.1f} output tokens/s [{card}]", flush=True)
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    return got


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--model", default=bench.MODEL)
    parser.add_argument("--batch", type=int, default=bench.BATCH)
    parser.add_argument("--seq", type=int, default=bench.SEQ)
    args = parser.parse_args(argv)
    summary = {}
    if args.device == "cuda":
        if torch.cuda.device_count() < CARDS:
            sys.exit(f"needs {CARDS} cards, found {torch.cuda.device_count()}")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
        print(f"{CARDS} x {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
        summary["one_card_step_ms"] = one = one_card_step(args, card)
        summary["train"] = trainers(args, card, one)
        import chip_smoke

        pipe = {}
        launches = chip_smoke.pipeline_parallel(card, one, stage_gpus=1, summary=pipe)
        summary["pipeline"] = dict(pipe, launches_a_step_per_stage=launches)
        summary["serve"] = serve_on_cards(card)
        summary["multislice"] = multislice(args, card)
        summary["tune"] = tune_on_cards(args, card)
    else:
        card = "CPU rehearsal, gloo: no time here is the card's"
        summary["train"] = trainers(args, card, float("nan"))
        summary["multislice"] = multislice(args, card)
    summary["autoscaled"] = autoscaled_slices(args, card)
    print("every path placed a worker a card, held to its one-card reference", flush=True)
    print(json.dumps({"card": card, **summary}, default=str))


if __name__ == "__main__":
    main()

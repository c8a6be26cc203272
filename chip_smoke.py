"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. name the card and its power limit (nvidia-smi); turn TF32 off for f32
     products (matmul and cuDNN); build the four kernel libraries from
     ray_tpu_torch/ops/csrc with nvcc at once (bf16 operands:
     flash_attention.cu; f16: flash_attention_f16.cu, the same kernels for
     f16; f32: flash_attention_f32.cu; mixed dtypes:
     flash_attention_mixed.cu, the f32 kernels rounding P and dS), print the
     build's seconds beside the two-library build's and each instance's
     registers and spills; count each 16-bit instance's wgmma (HGMMA) and TMA
     load (UTMALDG) instructions in the library's SASS (cuobjdump -sass), per
     head dim (16, 32, 64, 128, 256; dK/dV's 256 as its dV and dK passes),
     operand type (bf16, f16) and output type (the operands', f32), and each
     f32 and mixed instance's (all three kernels are 3xTF32 on tf32 wgmma
     fed by TMA), and each column-window kernel's (head dims above 256,
     csrc/flash_wide.cuh, in every library) mma.sync (HMMA) and cp.async
     (LDGSTS) instructions, and fail if an instance lacks them, an f32,
     mixed or column-window instance spills or a head dim has no instance;
  2. hold each kernel against its plain PyTorch version on the card, on bf16
     inputs from a seeded generator, at the train step's shape, at head dim
     16, at a ragged T, non-causal with Tk != Tq, and non-causal with Tk
     spanning more key tiles than the ring has stages (the ring wraps) and a
     ragged last tile, element by element
     (ray_tpu_torch.bench.disagreement); the same at gpt2-small's width as
     H 6 x Dh 128 and H 24 x Dh 32 (B 32, T 1024, causal), ragged causal
     (T 1000), non-causal (Tq 200, Tk 333) and wrapping (Tq 300, Tk 1100),
     in both output types; the head dims between and above those
     instances (REACH_DIMS: 8, 20, 40, 48, 80, 96, 160, 192, 256; 20 by the
     padding copy) causal, ragged causal, non-causal and wrapping, in both
     output types, and at phase 14's shapes (8 heads of 96, 16 of 48, 3 of
     256, B 32) and gpt2-large's width as 16 heads of 80 (B 8); call dQ
     twice at each timed shape and fail unless both give the same bits (no
     atomics, no dependence on run order); hold the autograd Function at
     the train step's [B, T, H, Dh] against reference attention; time each
     kernel at the seven timed shapes beside its bound (of the head dim's
     own work), its plain version and the library's attention
     (F.scaled_dot_product_attention, a yardstick only), and a padded
     route's times beside its padded share and its instance's own time
     scaled by heads; the padding copy's time beside its kernels' (bf16 Dh
     20, f32 Dh 6) with their bounds, plain versions and SDPA's on the
     same inputs; head dim 264 run on the column-window kernels (one
     launch of each), head dim 0, f64 and int32 operands refused with
     nothing launched. Then the f32 kernels (f32 operands) against their
     plain versions in f32 (TF32 off, printed): gpt2-small's attention in
     f32 at B 8, the f32 ring's Dh 32 blocks, Dh 128, ragged and Dh 16,
     held at 1e-5 relnorm (o), 1e-4 (dq, dk, dv) and 1e-5 on lse; dQ twice
     at B 8 for the same bits; all three timed at B 8, at Dh 128 and at the
     f32 ring's Dh 32 blocks beside the bound at the 3xTF32 rate and SDPA on
     the same f32 inputs, with each kernel's device time (torch.profiler)
     beside its CUDA-event time; the same reach head dims in f32 (6 by the
     padding copy) and gpt2-small's width as 3 heads of 256 at B 8, timed.
     Then the f16 instances against their plain versions on f16 inputs
     (F16_CASES: every instance head dim, 96 and 48 between them, 20 by the
     padding copy, ragged causal, non-causal and wrapping, at T up to
     1,024) in both output types by the bf16 rule, only f16 instances
     launched, dQ twice for the same bits, timed at the train step's shape
     and at Dh 128 (B 32, H 6) beside their bounds, the plain versions,
     SDPA in f16 and the bf16 instance's time in this run. Then operands
     of mixed dtypes, (q, k, v) = (bf16, f32, bf16), (f32, bf16, bf16),
     (f16, bf16, f16) and (f16, f16, f32) with dO in q's dtype, at Dh 64
     and 48, causal, ragged and non-causal, forward and backward against
     the plain versions: each output in its operand's dtype, 16-bit ones by
     the bf16 rule, f32 ones at 1e-5 (o) and 1e-4 (dq, dk, dv) relnorm
     (o by the bf16 rule where v is 16-bit: see MIXES), lse within 1e-5,
     only mixed instances launched; the mixed route timed at B 8, H 12, Dh
     64 ((q, k, v) bf16/f32/bf16) beside its bound, plain versions and
     SDPA on the operands cast to f32. Then head dims above 256, the
     column-window kernels (WIDE_CASES): gpt2-small's width as 3 heads of
     264, 2 of 384 and 1 of 768 (B 32, T 1024, causal), gpt2-medium's as 2
     of 512 and 1 of 1024 (B 8), f16 at 384, f32 at 384 and 512, a mix at
     320, f32 outputs of bf16 operands at 384, ragged causal, non-causal
     and wrapping, each held by its operands' gates with one launch of its
     window instance a call, dQ twice for the same bits, the first ten
     timed beside their bounds (the function's FLOPs, not the windows'
     recompute), plain versions and SDPA with the backend it took; and the
     window check: at Dh 512 with columns 256-511 of q, k, v and dO copied
     from 0-255, each output's halves bitwise equal;
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
     device-busy times (torch.profiler) and peak memory. Then the recompute
     engine (engine="recompute", no KV: a full GPT2.forward per token) on 8
     of the greedy requests at once, its streams held to the kv engine's on
     the same 8 (equal, or a near tie), each engine's output tokens/s
     printed. Serving launches none of the three kernels: the phase checks
     that their counts stay 0;
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
     four inputs; the ring once more in f32 at Dh 32 (the JAX ring test's B
     2, T 64, H 4, and T 4,096) against reference attention in f32 at that
     test's limits (output 2e-5; gradients of sum(out^2) rtol 5e-4, atol
     5e-5), with 10 f32-operand launches of each kernel and no other.
     Prints the ring's forward and backward times (CUDA
     events), their device time in and outside the kernels (torch.profiler),
     the monolithic flash attention's and SDPA's at T 16,384, and
     moe_block's; the same times for the f32 ring at T 4,096; and each
     kernel's f32-output instance for f16 operands (the f16 ring's blocks)
     at the block shapes above, by phase 2's rule;
  6. the sharded train step: gpt2-small at full width (phase 3's model,
     batch and optimizer) through build_mesh, shard_model (gpt_rules) and
     make_train_step on a mesh of one rank over NCCL (every axis of size 1;
     a file store in a temporary directory, destroyed after): step 0's loss
     and every parameter after one AdamW step against the unsharded step on
     the same init and batch, then 3 steps: the median, device busy time and
     peak memory beside phase 3's unsharded figures, and 12 launches of each
     kernel per step. One card takes one NCCL rank, so dp, fsdp and tp above 1 are
     held only by the CPU tests (tests/test_torch_sharded_step.py, gloo);
  7. the runtime and bench.py's main path: ray_tpu_torch.init(num_cpus=2)
     (cluster_resources must show GPU 1), then bench.py's loop
     (ray_tpu_torch.bench.pipeline_steps) on the model bench.setup gives,
     fed by the ray_tpu_torch.data token pipeline (map tasks in the
     cluster's workers, the batches double-buffered onto the card): a
     warm-up step and 20 timed steps at gpt2-small, B=32, T=1024. Every
     batch equals bench.batch_tokens(i) bitwise; steps 0-4 are held to
     phase 3's five losses on the same batches (1e-5 relative, and whether
     bitwise equal); 12 launches of each kernel per step. Prints tokens/s,
     the median step, the host's wait in next() per step (median and max)
     beside phase 3's median step; after shutdown() no worker process of
     the session is alive and none of its shm or spill files remain;
  8. pipeline parallelism: gpt2-small (phase 3's init and batches, 4
     microbatches of 8) in two PipelineStage actors of six blocks each
     (stage 0: wte, wpe, blocks 0-5; stage 1: blocks 6-11, ln_f and a head
     that starts as a copy of wte), both stage processes on this card
     (each asks for half of it, num_gpus 0.5, and sees it alone in its
     CUDA_VISIBLE_DEVICES), through ray_tpu_torch.parallel.pipeline after
     ray_tpu_torch.init: one
     SGD step (RPC tier, GPipe) held to the unsharded model (step 0's loss
     within LOSS_REF_TOL of GPT2.loss's mean over the microbatches, each
     gradient read as (p - p')/lr, the two wte copies summed, within
     GRAD_RELNORM_TOL); a compiled graph of inference (InputNode ->
     stage0.predict -> stage1.predict) against GPT2.backbone on 8 rows;
     the same step under the compiled tier, GPipe and 1F1B, bitwise equal
     to it; then AdamW, a warm-up step and 5 timed steps under each of
     RPC/GPipe, compiled/GPipe and compiled/1F1B: step ms and tokens/s
     beside phase 3's, each stage's busy ms and bubble fraction (the stage
     loop's own tracing slices), peak memory, 24 launches of each kernel a
     step in each stage process (read there, by the stage functions), the
     loss on batch 0 lower 12 steps later; one 12 MiB activation's hop
     from process to process (off the card, the channel, onto the card);
     test_dag's per-call ratio of the RPC path to a compiled graph; after
     teardown() and shutdown() no stage process, shm segment or channel
     segment is left;
  9. the Train library: (a) in this process, the oracle: gpt2-medium
     (BASELINE.md config 3; d 1024, 24 layers, 16 heads) from bench.setup
     (B 32, T 1024, flash, fused CE, AdamW, seed 0), 6 steps: losses, the
     median step (CUDA events), peak memory; then the card is freed. (b)
     ray_tpu_torch.init, then TorchTrainer with ScalingConfig(num_workers=1,
     use_gpu=True) and FailureConfig(max_failures=1): the train worker, on
     the card its lease gives it, joins an NCCL process group of one, builds the same model on a mesh of one
     (build_mesh, shard_model with gpt_rules), takes the same 6 steps,
     reports each step's loss and launch counts (read in the worker),
     writes a checkpoint after step 2 (the model's and AdamW's full state
     dicts, torch.save into the rank directory, copied by report()), and on
     the first attempt exits after step 3 (os._exit, the flag claimed in the
     control store KV). The retry must restore the checkpoint and resume at
     step 3; steps 3-5's losses within 1e-5 relative of the oracle's
     (whether bitwise equal is printed); 24 launches of each kernel a step.
     Prints the worker's median step beside the oracle's, the process
     group's init, the checkpoint's bytes, write and copy ms, the restore
     ms, the seconds from the crash to the end of the first resumed step,
     the worker's peak memory. (c) data-parallel sync through the host
     collectives: two actors on this card (num_gpus 0.5 each), each with
     its own CUDA context,
     in a collective group (backend "cpu"), each takes forward and backward
     of gpt2-small (phase 3's init) on its 16 rows of batch 0 and calls
     grad_sync(grads).join() (bucketed, p2p ring, default buckets): the two
     ranks' reduced leaves bitwise equal, each within SYNC_GRAD_RELNORM_TOL
     of the full batch's gradients computed in this process, 12 launches of
     each kernel per rank; prints grad_sync's wall ms, its bytes on the wire
     (p2p counters) and its hidden fraction. After shutdown() no train
     worker, controller or actor process of the session is alive, none of
     its shm or spill files remain, and the run directory (under TMPDIR) is
     gone;
 10. the serve deployment, the OpenAI front door over HTTP:
     ray_tpu_torch.init, serve.start(http_port=0), then
     serve.llm.deploy of gpt2-small (phase 4's engine and flags, bf16, the
     seeded init of every replica) on two OpenAI replicas, each with its
     engine on this card (ray_actor_options num_gpus 0.5: both see it in
     CUDA_VISIBLE_DEVICES, read from their /proc environ): the seconds from
     deploy to the first answer; the controller and the proxy have not
     loaded torch (no libtorch in their /proc maps). Phase 4's 24 requests as ASCII text (64-896 bytes, 8
     sharing a 512-byte prefix, 64 tokens each, 4 at temperature 0.8) at
     once over SSE to /v1/completions: every answer's usage counts 64
     tokens; 4 greedy ones again unary; 4 of one OpenAI user land on one
     replica; 8 greedy ones one at a time. Every greedy text equals the
     byte decode of a fresh in-process LLMServer's tokens on the same
     prompt, or leaves it at a near tie (the reference's top-2 logit gap
     under GREEDY_MARGIN at the first differing token); the same 8 through
     a build_llm_deployment handle, held by token id. Then the deployment
     is replaced by a prefill tier and one decode replica
     (disaggregated=True): the 8 one at a time and the 24 at once, their
     greedy texts held the same way; every KV shipment is 2 x L x n x H x
     Dh x 2 bytes, the rows in the cache's dtype, bf16 (the prefill spans). The engines' TTFT histogram counts
     every request, the page gauges are set, the token counter covers the
     tokens returned (the workers' metrics, read through the port's state
     API: state.cluster_metrics, and the spans through state.timeline).
     Prints TTFT p50 and p95 at the first SSE event and output tokens/s of
     both deployments beside phase 4's, the PREFILL and TRANSFER spans'
     ms, and the TTFT the shipment adds one request at a time; then
     state.request_summary() per deployment, state.autoscale_status(), and
     the metrics history's TTFT series over the phase's window (fails if
     the history or the alert engine is off, or the series is empty).
     After serve.shutdown() and shutdown() no
     replica, controller or proxy process of the session is alive and
     none of its shm or spill files remain;
 11. GPU-aware placement: ray_tpu_torch.init, the card as GPU 1 with its
     NVLink domain's head resource; a task of num_gpus=1 runs in a worker
     that sees exactly this card (CUDA_VISIBLE_DEVICES its id, one device,
     its UUID this process's card's, a product computed on it); two actors
     of num_gpus=0.5 see the same card in two processes; while they hold
     it a second whole-card request stays unplaced (it waits; it never runs
     on the CPU) and a task without num_gpus sees no card; once the halves
     are killed the request runs on the card, and every share is back in
     the node's free set; no process or file of the session is left;
 12. device objects (RDT) for CUDA tensors: ray_tpu_torch.init, a producer
     and a consumer actor at num_gpus 0.5 each. The producer returns,
     under tensor_transport="device", a 12 MiB bf16 CUDA tensor (phase 8's
     activation) and gpt2-small's bf16 state dict (all its leaves, from a
     seeded init), 5 times each, and the consumer takes each ref as an
     argument: its leaves are the producer's bits (sha256 of names, dtypes,
     shapes and bytes) on its card; the owner holds a DeviceValue; a
     same-actor round trip gets the stored tensor itself (data_ptr equal);
     the driver's get of each payload is its bits on the card; after each
     ref is dropped the producer's store holds 0 objects and, after the
     first of each payload, its memory_allocated fell by at least the
     payload's bytes. Prints the median handoff (from the producer's return
     to the consumer's card; GB/s for the state dict), the driver's get,
     the export's D2H through pinned buffers, its pwrite into shm and the
     two overlapped, the upload from a fresh mapping (device_put, and its
     copy into pinned memory and H2D), beside phase 8's hop. No flash
     launch in the driver, the producer or the consumer;
 13. the PPO learner: ray_tpu_torch.init, then one minibatch update of the
     learner on the card held to plain torch on the CPU (same init and
     batch, f32: loss 1e-5 relative, each update 1e-4 and each Adam moment
     1e-5 relnorm); PPOConfig(num_env_runners=2, seed=3) trained 15
     iterations, the learner on the card and two CPU env runners, under
     tests/test_rllib.py's gates (best return >= max(60, 2 x first), the
     greedy policy survives >= 100 steps). Prints the seconds per
     iteration split into SGD and the rest, the ms per minibatch update,
     and what train()'s float(loss) after each update costs against one
     read at the end. No flash launch;
 14. the train step at other head dims and dtypes: gpt2-small's widths as
     6 heads of 128, 24 of 32, 8 of 96, 16 of 48, 3 of 256, 2 of 384 and 1
     of 768 (bf16, B=32, T=1024; the last two on the column-window
     kernels), gpt2-small in f32 at 12 heads of 64, 3 of 256 and 2 of 384
     (B=8, T=1024), and gpt2-small in f16 (12 heads of 64, B=32, T=1024: the f16
     instances on the train path), each from phase 3's seeded init and
     tokens: step 0's loss and every gradient against reference attention
     on the same init and batch (bf16: phase 3's limits; f32: the loss
     within 1e-5 relative, each gradient within 1e-4 relnorm; f16: under a
     static loss scale of 2^12, the loss within 1e-4, each gradient within
     5e-3 relnorm, the unscaled gaps printed beside), a warm-up
     step, 3 timed steps (median beside phase 3's), and 12 calls a step
     of each kernel's own instance (the head dim asked and the instance
     that ran, and the operand dtype) and no other: 12 launches, 24 for
     dK/dV at head dim 256 (a dV pass and a dK pass a call), 12 of each
     column-window instance above 256 (its windows in one launch); the
     f16 step 12 of each f16 instance;
 15. the library and control-plane modules. (a) Tune: ray_tpu_torch.init on
     the card, then tune.Tuner(tune.with_resources(trainable, {"GPU": 1}))
     over lr in (1e-4, 3e-4, 1e-3) with max_concurrent_trials=3, each trial
     gpt2-small from phase 3's init and tokens (B 32, T 1024) for 5 steps
     at its lr, tune.report after each: the trials ran one at a time (the
     card gates them: their workers' start and end times do not overlap),
     each worker saw exactly this card (CUDA_VISIBLE_DEVICES one id, one
     device, this card's UUID), step 0's loss within LOSS_REF_TOL of phase
     3's, losses finite, 12 launches of each kernel a step,
     get_best_result() the lowest final loss; prints each worker's start,
     ms a step beside phase 3's and wall. (b) python -m ray_tpu_torch
     status in a process of its own (exit 0, GPU 1 and the domain head),
     and a job submitted through JobSubmissionClient whose entrypoint
     joins through RT_ADDRESS, sees no card, and runs one num_gpus=1 task
     taking phase 3's first step (SUCCEEDED; the loss and 12 launches of
     each kernel in its log). (c) The dashboard on a free port:
     /api/status and /api/nodes show the card and its head,
     /api/metrics/history answers. (d) The autoscaler: a Cluster whose
     head node's agent sees no card (no GPU before the autoscaler starts),
     an Autoscaler over GpuDomainProvider with the card as its one set: a
     pending slice_placement_group makes exactly one domain, whose agent
     was started seeing card 0 only, and is reserved on it, a num_gpus=1
     worker pinned to its bundle sees card 0 and takes phase 3's first
     step, and after remove() the domain is terminated within
     AS_TERMINATE_S, its set back in the pool and its agent gone (the
     launch counts of each step of (a), (b) and (d) are set to 0 just
     before it, in the worker that takes it); prints the seconds from the
     group's creation to the domain's registration and to the
     reservation, and from removal to termination;
 16. print the kernel line (one JSON object; beside the contract's keys,
     each kernel's SASS counts per instance from phase 1, held_at (every
     head dim and operand->output type a check held it at in this run, the
     f16 instances and the mixed route among them), the times of each timed
     instance (Dh 64, 128, 32, 96, 48, 256 and 80 bf16, the padded ones with
     their padded share; Dh 64, 128, 32 and 256 f32; Dh 64 and 128 f16;
     the mixed route at Dh 64; the column-window kernels at Dh 264, 384,
     768, 512 and 1024 bf16, 384 f16, 384 and 512 f32, 320 mixed and 384
     bf16 -> f32, with SDPA's backend and the windows)
     with their bounds, plain and library times, the f16 step's launches
     a step, its f32-output
     instantiation's gap, times and ring launches from phase 5 and the f32
     ring's launches, its launches a step in each stage process from phase
     8, in the train worker and a grad_sync rank from phase 9 and in phase
     14's steps, in phase 15's trials, the job's task and the domain's
     worker: every number in it was measured or, for bound_ms, computed
     in this run, and launches come from phase 3);
 17. print the contract line (one JSON object, the last line).

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
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
# full 700 W power limit): bf16 and TF32 tensor-core FLOP/s and HBM3
# bytes/s. The f32 kernels' bound is taken at PEAK_TF32_FLOPS / 3: all
# three (the forward, replacing _fwd_kernel at
# ray_tpu/ops/flash_attention.py:72, dQ and dK/dV) keep f32 accuracy as
# three TF32 products on the tensor cores (3xTF32), so the least time the
# card could take for their f32-accurate work is their FLOPs (4, 6 and 8
# per kept (q, key) pair and head-dim element) at that rate: 0.0782 ms for
# the forward at F32_MAIN.
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_ACCURATE_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES = 3.35e12

# (B, T, Tk, H, Dh, causal): the train step's shape first, then a pipeline
# stage's microbatch (phase 8: 8 rows, BH 96); then gpt2-small's width as
# 6 heads of 128 and as 24 heads of 32 (the train step's FLOPs and bytes at
# head dims 128 and 32, phase 14), each also ragged causal and non-causal;
# then the other head dims.
MAIN_CASE = (32, 1024, 1024, 12, 64, True)
MAIN_D128 = (32, 1024, 1024, 6, 128, True)
MAIN_D32 = (32, 1024, 1024, 24, 32, True)
# Phase 14's head dims between and above the first instances, at
# gpt2-small's width (B 32, T 1024): 8 heads of 96 and 16 of 48 (on the 128
# and 64 instances, their tiles padded with zeros in shared memory) and 3
# heads of 256; and gpt2-large's width, 1280, as 16 heads of 80 (B 8).
MAIN_D96 = (32, 1024, 1024, 8, 96, True)
MAIN_D48 = (32, 1024, 1024, 16, 48, True)
MAIN_D256 = (32, 1024, 1024, 3, 256, True)
LARGE_D80 = (8, 1024, 1024, 16, 80, True)
TIMED_CASES = (MAIN_CASE, MAIN_D128, MAIN_D32, MAIN_D96, MAIN_D48, MAIN_D256, LARGE_D80)
# Every head dim the instances' widths leave between them, and 256, each
# causal, ragged causal, non-causal with Tk != Tq and wrapping (more key
# tiles than any ring has stages); 20 takes the padding copy (its rows are
# not 16-byte strided).
REACH_DIMS = (8, 20, 40, 48, 80, 96, 160, 192, 256)
REACH_SHAPES = ((2, 512, 512, 4, True), (2, 1000, 1000, 2, True), (2, 200, 333, 2, False),
                (2, 300, 1100, 2, False))
CASES = [MAIN_CASE, (8, 1024, 1024, 12, 64, True), (4, 512, 512, 4, 16, True),
         (2, 1000, 1000, 12, 64, True), (2, 200, 333, 4, 64, False),
         (2, 300, 1100, 4, 64, False),
         MAIN_D128, (2, 1000, 1000, 6, 128, True), (2, 200, 333, 2, 128, False),
         (2, 300, 1100, 2, 128, False),
         MAIN_D32, (2, 1000, 1000, 24, 32, True), (2, 200, 333, 8, 32, False),
         (2, 300, 1100, 8, 32, False),
         MAIN_D96, MAIN_D48, MAIN_D256, LARGE_D80,
         *[(B, T, Tk, H, D, causal) for D in REACH_DIMS for B, T, Tk, H, causal in REACH_SHAPES]]
# The padding copy's cost beside the kernels' (bf16 Dh 20, f32 Dh 6 at B 8,
# T 1024, 12 heads): the route of a head dim whose rows are not 16-byte
# strided.
PAD_TIMED = ((8, 1024, 1024, 12, 20, True, torch.bfloat16), (8, 1024, 1024, 12, 6, True, torch.float32))
# f32 operands (the f32 kernels): gpt2-small in f32 at phase 14's B 8; the
# blocks of phase 5's f32 rings at Dh 32 (the JAX ring test's 16-row block
# and the multi-tile ring's 1,024-row one, diagonal and earlier); Dh 128;
# ragged causal; non-causal at Dh 16. Held to the plain versions in f32
# (TF32 off) at the JAX package's own limits for its f32 kernels
# (tests/test_ring_attention.py:104, 1e-5 forward and 1e-4 gradients): o within
# F32_FWD_RELNORM, dq, dk, dv within F32_GRAD_RELNORM in relative norm, lse
# within F32_LSE_TOL absolute.
F32_MAIN = (8, 1024, 1024, 12, 64, True)
F32_D256 = (8, 1024, 1024, 3, 256, True)  # phase 14's f32 run at 3 heads of 256
F32_CASES = [F32_MAIN, (2, 16, 16, 4, 32, True), (2, 16, 16, 4, 32, False),
             (2, 1024, 1024, 4, 32, True), (2, 1024, 1024, 4, 32, False),
             (2, 1024, 1024, 6, 128, True), (8, 1024, 1024, 6, 128, True),
             (2, 1000, 1000, 12, 64, True), (2, 200, 333, 4, 16, False), F32_D256,
             *[(B, T, Tk, 2, D, causal) for D in (6, *[d for d in REACH_DIMS if d != 20])
               for B, T, Tk, _, causal in REACH_SHAPES]]
F32_FWD_RELNORM, F32_GRAD_RELNORM, F32_LSE_TOL = 1e-5, 1e-4, 1e-5
# Timed beside their bounds, all three kernels: F32_MAIN, Dh 128 at
# gpt2-small's width (B 8, 6 heads), and the f32 ring's Dh 32 blocks (phase
# 5: 1,024 rows, the diagonal's causal and an earlier block's full).
F32_TIMED = {F32_MAIN: "d64 f32", (8, 1024, 1024, 6, 128, True): "d128 f32",
             (2, 1024, 1024, 4, 32, True): "d32 f32", (2, 1024, 1024, 4, 32, False): "d32 f32 earlier",
             F32_D256: "d256 f32"}
# Each kernel's (head dim, operands->outputs) instances that a check held
# to its plain version in this run: the kernel line's held_at.
HELD_AT = {}
# Kernels vs plain versions: every output element by the rule of
# ray_tpu_torch.bench (RTOL relative, ATOL_RMS x the row's rms absolute,
# RELNORM_TOL on the whole tensor). On an H100 the cases below need at most
# 9.5e-3 of the row rms (limit 2e-2) and 2.0e-3 in relative norm (limit
# 1e-2). lse is f32 in both, summed in other orders: within LSE_TOL
# absolute (the gap measured there is 9.5e-7).
LSE_TOL = 1e-4

N_STEPS = 5
# f16 (phase 14, under a loss scale: GRAD_LOSS_SCALE): f16 carries three more
# mantissa bits than bf16; measured on an H100 0.96e-6 (loss) and at most
# 1.8e-3 (gradients).
F16_LOSS_REF_TOL = 1e-4
F16_GRAD_RELNORM_TOL = 5e-3
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
F32_SOURCE = "ray_tpu_torch/ops/csrc/flash_attention_f32.cu"  # the kernels for f32 operands
F16_SOURCE = "ray_tpu_torch/ops/csrc/flash_attention_f16.cu"  # SOURCE's kernels for f16 operands
MIXED_SOURCE = "ray_tpu_torch/ops/csrc/flash_attention_mixed.cu"  # F32_SOURCE's, rounding, for mixes
# The first versions' times at the train step's shape, before the Hopper
# redesign (chip_smoke.py phase 2, median of 20 calls; PERF.md section 6,
# NVIDIA H100 80GB HBM3 at 700 W). Recorded, not measured here: printed as
# text beside this run's times, and kept out of the kernel line.
BEFORE_REDESIGN_MS = {"flash_fwd": 0.5302, "flash_dq": 0.6775, "flash_dkv": 1.0951}
# The f32 kernels' times at F32_MAIN before their 3xTF32 redesign (f32 FMAs;
# PERF.md section 6, same card): printed as text beside this run's times.
F32_BEFORE_REDESIGN_MS = {"flash_fwd": 0.6467, "flash_dq": 0.9051, "flash_dkv": 1.1923}


_phase: list = []  # the running phase's label (timed_phase), for fail()'s line on stderr


def fail(msg: str) -> None:
    """Print the failed check on both streams (a caller that keeps only the
    end of stderr still reads which check it was) and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    where = f" (phase {_phase[0]})" if _phase else ""
    print(f"FAIL{where}: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _zero_launches() -> None:
    """Set every kernel launch count to 0: just before a path is driven."""
    from ray_tpu_torch.ops import flash_attention as fa

    for counts in (fa.launches, fa.launches_f32):
        for name in counts:
            counts[name] = 0
    fa.launches_by_instance.clear()


def _instance_counts() -> dict:
    """Launches per kernel instance ("flash_fwd d128 bfloat16", ...): read
    just after the path."""
    from ray_tpu_torch.ops import flash_attention as fa

    return dict(fa.launches_by_instance)


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
    from ray_tpu_torch import bench

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    smi = ", ".join(bench.card())
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    # f32 products in full f32 everywhere in this run: the f32 kernels'
    # plain versions and references are held at 1e-5
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    return smi


# The kernel libraries, one nvcc each, built at once: bf16 operands
# (flash_attention.cu), f16 (flash_attention_f16.cu: the same kernels for
# f16), f32 (flash_attention_f32.cu) and mixed dtypes (flash_attention_mixed.cu:
# the f32 kernels with rounding).
LIBRARIES = ("flash_attention", "flash_attention_f16", "flash_attention_f32", "flash_attention_mixed")
# The build's seconds before the f16 and mixed libraries (the bf16 and f32
# libraries at once; chip_smoke.py phase 1 on an NVIDIA H100 80GB HBM3 at
# 700 W, PERF.md section 6): printed as text beside this run's.
BUILD_S_TWO_LIBRARIES = 52.32
# A kernel's mangled name in the ptxas log and the SASS: the kernel, its head
# dim, then the 16-bit kernels' operand type and output type (the output
# type written as a back-reference when it is the operand type), dK/dV's
# pass, and the f32 kernels' rounding flag (1: the mixed library's).
KERNEL_NAME = (r"(flash_(?:f32_)?(?:fwd|dq|dkv)_kernel)ILi(\d+)E(?:(13__nv_bfloat16|6__half)"
               r"(13__nv_bfloat16|6__half|f|S\d*_))?(?:Li(\d)E)?(?:Lb([01])E)?E")
ELEMENT_TYPES = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}  # mangled types
# The column-window kernels (head dims above 256, csrc/flash_wide.cuh; in
# every library): the kernel, its operand type, its output type (a
# back-reference when it is the operand type) and its rounding flag (1: the
# mixed library's).
WIDE_KERNEL_NAME = (r"(flash_wide_(?:fwd|dq|dkv)_kernel)I(13__nv_bfloat16|6__half|f)"
                    r"(13__nv_bfloat16|6__half|f|S\d*_)Lb([01])E")


def _instance_name(found) -> str:
    """"d<D> <operands>-><outputs>[ pass <n>]" of a KERNEL_NAME match."""
    if found[3]:  # a 16-bit kernel: its operand type, then f32 or the same type
        ops = ELEMENT_TYPES[found[3]]
        outs = ELEMENT_TYPES.get(found[4], ops)
    else:
        ops, outs = ("mixed" if found[6] == "1" else "f32"), "f32"
    return f"d{found[2]} {ops}->{outs}" + (f" pass {found[5]}" if found[5] not in (None, "0") else "")


WIDE_SOURCE = "ray_tpu_torch/ops/csrc/flash_wide.cuh"  # the column-window kernels, in every library


def wide_smem_plans(elem: int) -> dict:
    """Each column-window kernel's dynamic shared memory in bytes for
    operands of ``elem`` bytes (2 or 4), from WIDE_SOURCE's constants: two
    chunk buffers of every operand's rows (128-byte chunks padded by 16),
    then the value tiles (a window of each row, padded by 16)."""
    text = (Path(__file__).resolve().parent / WIDE_SOURCE).read_text()
    c = {name: int(value) for name, value in re.findall(r"\b([A-Z][A-Z0-9_]*) = (\d+)", text)}
    chunk, rows = c["CHUNK_BYTES"] + 16, c["ROWS"]
    fwd_bk = c["FWD_BK_F32"] if elem == 4 else c["FWD_BK"]  # fwd_bk<E>()
    value = lambda win: win * elem + 16  # noqa: E731
    return {
        "flash_fwd": 2 * (rows + fwd_bk) * chunk + fwd_bk * value(c["FWD_WIN"]),
        "flash_dq": 2 * (2 * rows + 2 * c["DQ_BK"]) * chunk + c["DQ_BK"] * value(c["DQ_WIN"]),
        "flash_dkv": 2 * (2 * rows + 2 * c["DKV_BQ"]) * chunk + 2 * c["DKV_BQ"] * value(c["DKV_WIN"]),
    }


def _wide_instance_name(found) -> str:
    """"wide <operands>-><outputs>" of a WIDE_KERNEL_NAME match."""
    ops = "mixed" if found[4] == "1" else ELEMENT_TYPES[found[2]]
    return f"wide {ops}->{ELEMENT_TYPES.get(found[3], 'f32' if ops == 'mixed' else ops)}"


def _kernel_entry(line: str):
    """(kernel name, instance name) of the kernel a ptxas or SASS line
    names, or None."""
    found = re.search(KERNEL_NAME, line)
    if found:
        return found[1], _instance_name(found)
    found = re.search(WIDE_KERNEL_NAME, line)
    return (found[1], _wide_instance_name(found)) if found else None


def build() -> dict:
    """Build the four kernel libraries (one nvcc each, at once), print nvcc's
    register and spill report of every instance, and return each kernel's
    SASS instruction counts per instance (``sass_counts``)."""
    import ray_tpu_torch
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa

    if Path(ray_tpu_torch.__file__).resolve().parent.parent != Path(__file__).resolve().parent:
        fail(f"ray_tpu_torch comes from {ray_tpu_torch.__file__}, not from this checkout")
    if set(LIBRARIES) != set(fa.LIBRARIES):
        fail(f"the wrappers load {fa.LIBRARIES}; this phase builds {LIBRARIES}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        paths = dict(zip(LIBRARIES, pool.map(_build.build, LIBRARIES)))
    print(f"build: {time.perf_counter() - t0:.2f} s ({len(LIBRARIES)} libraries at once; the bf16 and f32 "
          f"libraries alone took {BUILD_S_TWO_LIBRARIES} s before the f16 and mixed ones, PERF.md, not this run)",
          flush=True)
    spills = []
    for lib, path in paths.items():
        log = path.with_name(path.name + ".log")
        entry = None
        for line in log.read_text().splitlines() if log.exists() else []:
            if "Compiling entry" in line:
                found = _kernel_entry(line)
                entry = found and f"{found[0]}<{found[1]}>"
            elif entry and ("registers" in line or "spill" in line):
                print(f"  {lib} {entry}: {line.split(':', 1)[-1].strip()}")
                if re.search(r"[1-9]\d* bytes spill", line):
                    spills.append(f"{entry}: {line.strip()}")
            elif "warning" in line or "C751" in line:
                print(f"  {lib}: {line.strip()}")
    print(f"spills: {'; '.join(spills) if spills else 'none in any instance of any library'}", flush=True)
    print("column-window kernels' shared memory (bytes, 16-bit / f32 operands): " + ", ".join(
        f"{name} {wide_smem_plans(2)[name]} / {wide_smem_plans(4)[name]}" for name in KERNELS), flush=True)
    if any(entry.startswith(("flash_f32_", "flash_wide_")) for entry in spills):
        fail(f"an f32, mixed or column-window instance spills: {spills}")
    counts = {name: {} for name in KERNELS}
    with ThreadPoolExecutor(len(paths)) as pool:  # one cuobjdump each, at once
        per_library = list(pool.map(lambda path: sass_counts(path, SASS_OPS), paths.values()))
    for got in per_library:
        for name, insts in got.items():
            counts[name].update(insts)
    operands = ("bf16->bf16", "bf16->f32", "f16->f16", "f16->f32", "f32->f32", "mixed->f32")
    for name in KERNELS:
        # every instanced kernel of every library is a Hopper one: wgmma
        # (bf16, f16, or tf32 for 3xTF32) fed by TMA; the column-window
        # kernels (above 256) run mma.sync (HMMA) fed by cp.async (LDGSTS)
        for inst, c in counts[name].items():
            wide = inst.startswith("wide ")
            ops = ("hmma", "ldgsts") if wide else ("hgmma", "utmaldg")
            print(f"sass {name} {inst}: " + ", ".join(f"{SASS_OPS[o]} {c[o]}" for o in ops), flush=True)
            if not all(c[o] > 0 for o in ops):
                fail(f"{name} {inst} lacks {' or '.join(SASS_OPS[o] for o in ops)} in its SASS: {c}")
        wide = {inst for inst in counts[name] if inst.startswith("wide ")}
        if wide != {f"wide {ops}" for ops in operands}:
            fail(f"{name}: the libraries hold column-window instances {sorted(wide)}; expected {operands}")
        # every head dim's instance, in every operand and output type; dK/dV's
        # head dim 256 as its two passes
        want = {f"d{d} {ops}" for d in fa.HEAD_DIMS for ops in operands}
        got = {" ".join(inst.split()[:2]) for inst in counts[name] if inst not in wide}
        passes = {inst for inst in counts[name] if "pass" in inst}
        want_passes = ({f"d256 {ops} pass {k}" for ops in operands for k in (1, 2)}
                       if name == "flash_dkv" else set())
        if got != want or passes != want_passes:
            fail(f"{name}: the libraries hold instances {sorted(counts[name])}; expected every head dim of "
                 f"{fa.HEAD_DIMS} in {operands} (dK/dV's 256 in two passes)")
    return counts


SASS_OPS = {"hgmma": "HGMMA", "utmaldg": "UTMALDG", "hmma": "HMMA", "ldgsts": "LDGSTS"}


def sass_counts(lib: Path, ops: dict) -> dict:
    """Instructions ``ops`` ({key: SASS opcode}) per kernel and instance in
    the SASS of a built library, read with cuobjdump: {name: {"d<D>
    <operands>-><outputs>": {key: count}}}, kernels named by KERNEL_NAME; an
    instance of a pass other than 0 is keyed with " pass <n>"; the
    column-window kernels (WIDE_KERNEL_NAME) as "wide <operands>-><outputs>"."""
    from ray_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts = {name: {} for name in KERNELS}
    lines_with = {key: re.compile(rf"^.*\b{op}\b", re.M) for key, op in ops.items()}
    # a function's SASS runs from its "Function :" line to the next one;
    # each op is counted by the lines of the body that hold it
    for function in sass.split("Function :")[1:]:
        head, _, body = function.partition("\n")
        found = _kernel_entry("Function :" + head)
        if found:
            name = found[0].replace("_f32", "").replace("_wide", "").removesuffix("_kernel")
            current = counts[name].setdefault(found[1], dict.fromkeys(ops, 0))
            for key, pattern in lines_with.items():
                current[key] += len(pattern.findall(body))
    return counts


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------


def _visible_pairs(Tq: int, Tk: int, causal: bool) -> int:
    return Tq * (Tq + 1) // 2 if causal else Tq * Tk


def bounds(B, T, Tk, H, D, causal, out_bytes=2, in_bytes=2, peak=PEAK_BF16_FLOPS):
    """Least time (ms) for each kernel's work on this card's published
    peaks: (ms, "bytes" | "operations"). Each input read once and each
    output written once at its bytes per element (``in_bytes``,
    ``out_bytes``: one number for every operand, 2 for bf16 and 4 for f32,
    or one each for q, k and v, where dO, o and dq take q's, dk k's and dv
    v's), lse and delta f32; products counted over the (q, k) pairs the
    mask keeps, at ``peak`` FLOP/s (the bf16 tensor cores, or
    PEAK_F32_ACCURATE_FLOPS for the f32-operand kernels)."""
    qb, kb, vb = in_bytes if isinstance(in_bytes, tuple) else (in_bytes,) * 3
    oq, ok, ov = out_bytes if isinstance(out_bytes, tuple) else (out_bytes,) * 3
    BH, pairs = B * H, _visible_pairs(T, Tk, causal)
    q_rows, kv_rows, row_bytes = BH * T * D, BH * Tk * D, BH * T * 4
    work = {  # name: (flops, bytes)
        "flash_fwd": (4 * BH * pairs * D, q_rows * (qb + oq) + kv_rows * (kb + vb) + row_bytes),
        "flash_dq": (6 * BH * pairs * D, q_rows * (2 * qb + oq) + kv_rows * (kb + vb) + 2 * row_bytes),
        "flash_dkv": (8 * BH * pairs * D, 2 * q_rows * qb + kv_rows * (kb + vb + ok + ov) + 2 * row_bytes),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


SHORT = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32", "mixed": "mixed"}


def _held(name: str, D: int, operands, out_f32: bool) -> None:
    """Record that ``name`` was held at head dim D on ``operands`` (a torch
    dtype, or "mixed") with f32 outputs or not: the kernel line's held_at."""
    dt = SHORT[operands]
    HELD_AT.setdefault(name, set()).add(f"d{D} {dt}->{'f32' if out_f32 or dt in ('f32', 'mixed') else dt}")


def _instance_key(D: int, operands: torch.dtype) -> str:
    return f"d{D} {SHORT[operands]}"


def _inputs(case, dtype, seed=1234) -> tuple:
    """q, k, v, dO [B*H, T, Dh] of ``case`` from a seeded generator on the card."""
    B, T, Tk, H, D, _ = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", dtype=dtype, generator=g)
    return (torch.randn(B * H, T, D, **kw), torch.randn(B * H, Tk, D, **kw),
            torch.randn(B * H, Tk, D, **kw), torch.randn(B * H, T, D, **kw))


def time_instance(case, q, k, v, do, lse, delta, gaps, card, peak=PEAK_BF16_FLOPS, kernels=tuple(KERNELS),
                  before=None) -> dict:
    """``kernels`` at ``case`` on these inputs, timed (median of 20 calls,
    CUDA events) beside their bounds (products at ``peak``), their plain
    versions and the library's attention (F.scaled_dot_product_attention
    on the same inputs, a yardstick only); ``before`` ({kernel: ms},
    recorded in PERF.md) printed beside as text. Returns {kernel: the
    kernel line's numbers}."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import flash_attention as fa

    B, T, Tk, H, D, causal = case
    in_bytes = q.element_size()
    bnd = bounds(*case, out_bytes=in_bytes, in_bytes=in_bytes, peak=peak)
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal),
                      lambda: fa.flash_fwd_reference(q, k, v, causal)),
        "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, causal),
                     lambda: fa.flash_dq_reference(q, k, v, do, lse, delta, causal)),
        "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal),
                      lambda: fa.flash_dkv_reference(q, k, v, do, lse, delta, causal)),
    }
    ms = {name: bench.time_ms(calls[name][0]) for name in kernels}
    plain_ms = {name: bench.time_ms(calls[name][1], iters=5) for name in kernels}
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
    err_of = {"flash_fwd": gaps["o"]["max_abs"], "flash_dq": gaps["dq"]["max_abs"],
              "flash_dkv": max(gaps["dk"]["max_abs"], gaps["dv"]["max_abs"])}
    results = {}
    for name in kernels:
        results[name] = {
            "max_abs_err": err_of[name], "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": bnd[name][0], "bound_by": bnd[name][1], "library_ms": library[name],
        }
        print(f"time {name} at B={B} T={T} Tk={Tk} H={H} Dh={D} causal={causal}, {q.dtype} operands: "
              f"kernel {ms[name]:.4f} ms, bound {bnd[name][0]:.4f} ms ({bnd[name][1]}, "
              f"{peak / 1e12:.0f} TFLOP/s), plain {plain_ms[name]:.4f} ms, library {library[name]:.4f} ms"
              + (f", before the redesign {before[name]:.4f} ms (PERF.md, not this run)"
                 if before and name in before else "")
              + f" [{card}]", flush=True)
    print(f"library at B={B} T={T} H={H} Dh={D}, {q.dtype}: sdpa forward {sdpa_fwd:.4f} ms, "
          f"backward (dq, dk and dv in one call) {sdpa_bwd:.4f} ms, forward+backward "
          f"{sdpa_both:.4f} ms [{card}]", flush=True)
    return results


def check_kernels(card: str) -> dict:
    """Phase 2's bf16 operands. Returns the kernel line's numbers of
    MAIN_CASE per kernel, with an "instances" entry per timed head dim."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import flash_attention as fa

    results = {name: {"instances": {}} for name in KERNELS}
    for case in CASES:
        B, T, Tk, H, D, causal = case
        q, k, v, do = _inputs(case, torch.bfloat16)
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
        delta = (do.float() * o_ref.float()).sum(-1)
        # bf16 outputs; f32 outputs too at head dims 32 and 128 and at every
        # reach head dim's check shapes
        both = D in (32, 128) or (D in REACH_DIMS and case not in TIMED_CASES)
        for out_f32 in (False, True) if both else (False,):
            o, lse = fa.flash_fwd(q, k, v, causal, out_f32=out_f32)
            dq = fa.flash_dq(q, k, v, do, lse_ref, delta, causal, out_f32=out_f32)
            dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, causal, out_f32=out_f32)
            o_want = fa.flash_fwd_reference(q, k, v, causal, out_f32=out_f32)[0] if out_f32 else o_ref
            dq_ref, dk_ref, dv_ref = fa.flash_bwd_reference(q, k, v, do, lse_ref, delta, causal,
                                                            out_f32=out_f32)
            torch.cuda.synchronize()

            where = (f"B={B} T={T} Tk={Tk} H={H} Dh={D} causal={causal}"
                     + (", f32 outputs" if out_f32 else ""))
            gaps = {name: bench.disagreement(got, ref) for name, got, ref in
                    [("o", o, o_want), ("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)]}
            lse_err = (lse - lse_ref).abs().max().item()
            print(f"kernels vs plain at {where}: " + _gap_text(gaps)
                  + f"; lse max abs {lse_err:.3e}", flush=True)
            bad = [name for name, g in gaps.items() if not g["ok"]]
            if bad:
                fail(f"{', '.join(bad)} disagree with the plain version at {where} "
                     f"(limits: {_rule()})")
            if not lse_err <= LSE_TOL:  # also catches NaN
                fail(f"lse disagrees at {where}: max abs err {lse_err:.3e} > {LSE_TOL}")
            for name in KERNELS:
                _held(name, D, q.dtype, out_f32)
            if not out_f32:
                kept = (lse, dq, gaps)  # the bf16 outputs': timed and checked below
            del o, o_want, dq, dk, dv, dq_ref, dk_ref, dv_ref
        if case not in TIMED_CASES:
            continue
        lse, dq, gaps = kept
        where = f"B={B} T={T} Tk={Tk} H={H} Dh={D} causal={causal}"
        again = fa.flash_dq(q, k, v, do, lse_ref, delta, causal)
        if not torch.equal(dq, again):
            fail(f"two flash_dq calls at {where} differ: "
                 f"{(dq.float() - again.float()).abs().max().item():.3e} max abs")
        print(f"flash_dq at {where}: two calls give the same bits", flush=True)
        del again, o_ref
        timed = time_instance(case, q, k, v, do, lse, delta, gaps, card,
                              before=BEFORE_REDESIGN_MS if case == MAIN_CASE else None)
        for name in KERNELS:
            if case == MAIN_CASE:
                results[name].update(timed[name])
            results[name]["instances"][_instance_key(D, q.dtype)] = timed[name]
        if D not in fa.HEAD_DIMS:
            padded_route(case, timed, results, card)
        if case == MAIN_CASE:
            check_autograd(q, k, v, do, B, H)
    time_pad_copy(card)
    check_wide_head_dim_runs()
    check_refused_dtypes()
    return results


def padded_route(case, timed: dict, results: dict, card: str) -> None:
    """A head dim that runs on a wider instance: its padded share (the
    instance's width over the head dim: the products' share the zero columns
    add; its bound counts the head dim's own work) and, beside its times,
    the instance's own timed case in this run scaled by heads and batch (the
    padded route should cost about that)."""
    from ray_tpu_torch.ops import flash_attention as fa

    B, T, Tk, H, D, causal = case
    width = fa.instance_head_dim(D)
    own = next((c for c in TIMED_CASES if c[4] == width and c[1:3] == (T, Tk) and c[5] == causal), None)
    for name in KERNELS:
        line = (f"padded route {name} Dh {D} on the {width} instance at B={B} H={H}: {timed[name]['ms']:.4f} ms, "
                f"bound at Dh {D} {timed[name]['bound_ms']:.4f} ms, padded share {width}/{D} = {width / D:.3f}")
        if own is not None:
            ref = results[name]["instances"][_instance_key(width, torch.bfloat16)]["ms"] * (B * H) / (own[0] * own[3])
            line += (f"; the {width} instance's own time at B={own[0]} H={own[3]} scaled to B={B} H={H}: "
                     f"{ref:.4f} ms (this route {timed[name]['ms'] / ref:.2f}x that)")
        print(line + f" [{card}]", flush=True)


def time_pad_copy(card: str) -> None:
    """The padding copy's cost: at PAD_TIMED, each wrapper's time (the copy
    into zero-padded tensors, the kernel and the slice back), the copy of
    q, k, v (and dO) alone and the slice of one output alone, CUDA events,
    median of 20 calls."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import flash_attention as fa

    for B, T, Tk, H, D, causal, dtype in PAD_TIMED:
        q, k, v, do = _inputs((B, T, Tk, H, D, causal), dtype, seed=9)
        o, lse = fa.flash_fwd(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1)
        width = fa.kernel_head_dim(D, dtype)
        wide = fa._widen(q, k, v, do)
        calls = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, causal),
                 "flash_dq": lambda: fa.flash_dq(q, k, v, do, lse, delta, causal),
                 "flash_dkv": lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal),
                 "copy q, k, v": lambda: fa._widen(q, k, v),
                 "copy q, k, v, dO": lambda: fa._widen(q, k, v, do),
                 "slice one output": lambda: fa._narrow(wide[0], D)}
        ms = {name: bench.time_ms(call) for name, call in calls.items()}
        print(f"padding copy at B={B} T={T} H={H} Dh {D} -> {width} ({dtype} operands, on the "
              f"{fa.instance_head_dim(D)} instance): " + ", ".join(f"{n} {t:.4f} ms" for n, t in ms.items())
              + f" [{card}]", flush=True)
        # beside them: each kernel's bound at the true head dim (f32 at the
        # 3xTF32 rate), its plain version and the library's attention on the
        # same inputs
        plain = {"flash_fwd": lambda: fa.flash_fwd_reference(q, k, v, causal),
                 "flash_dq": lambda: fa.flash_dq_reference(q, k, v, do, lse, delta, causal),
                 "flash_dkv": lambda: fa.flash_dkv_reference(q, k, v, do, lse, delta, causal)}
        plain_ms = {name: bench.time_ms(call, iters=5) for name, call in plain.items()}
        in_bytes = q.element_size()
        bnd = bounds(B, T, Tk, H, D, causal, out_bytes=in_bytes, in_bytes=in_bytes,
                     peak=PEAK_BF16_FLOPS if in_bytes == 2 else PEAK_F32_ACCURATE_FLOPS)
        qs, ks, vs = (x.view(B, H, -1, D).detach().requires_grad_() for x in (q, k, v))
        with torch.no_grad():
            sdpa_fwd = bench.time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        sdpa_bwd = bench.time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do.view(B, H, T, D),
                                                             retain_graph=True))
        print(f"padding copy at B={B} T={T} H={H} Dh {D} ({dtype}): bounds at Dh {D} "
              + ", ".join(f"{n} {b:.4f} ms ({by})" for n, (b, by) in bnd.items())
              + "; plain " + ", ".join(f"{n} {t:.4f} ms" for n, t in plain_ms.items())
              + f"; library (sdpa) forward {sdpa_fwd:.4f} ms, backward (dq, dk and dv) {sdpa_bwd:.4f} ms [{card}]",
              flush=True)
        del q, k, v, do, o, lse, delta, wide, qs, ks, vs, out


WIDE_RUN_HEAD_DIM = 264  # above the widest instance, 16-byte strided rows: no padding copy


def check_wide_head_dim_runs() -> None:
    """Head dim 264 (above the widest instance) on the card: each wrapper
    launches its column-window kernel once, counted under its window
    instance, and returns outputs of the head dim; head dim 0 raises in
    each wrapper with nothing launched (no fallback to the plain version)."""
    from ray_tpu_torch.ops import flash_attention as fa

    q = torch.randn(2, 128, WIDE_RUN_HEAD_DIM, device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros(2, 128, device="cuda")
    _zero_launches()
    outs = [fa.flash_fwd(q, q, q, True)[0], fa.flash_dq(q, q, q, q, lse, lse, True),
            *fa.flash_dkv(q, q, q, q, lse, lse, True)]
    torch.cuda.synchronize()
    counts, by_instance = _launch_counts()[0], _instance_counts()
    want = {fa.instance(name, WIDE_RUN_HEAD_DIM, torch.bfloat16): 1 for name in KERNELS}
    print(f"head dim {WIDE_RUN_HEAD_DIM} on the card: launches {counts}, by instance {by_instance}", flush=True)
    if by_instance != want or any(o.shape != q.shape or not torch.isfinite(o.float()).all() for o in outs):
        fail(f"head dim {WIDE_RUN_HEAD_DIM} launched {by_instance} (expected {want}) or gave wrong outputs")
    empty = torch.zeros(2, 128, 0, device="cuda", dtype=torch.bfloat16)
    _zero_launches()
    refused = 0
    for call in (lambda: fa.flash_fwd(empty, empty, empty, True),
                 lambda: fa.flash_dq(empty, empty, empty, empty, lse, lse, True),
                 lambda: fa.flash_dkv(empty, empty, empty, empty, lse, lse, True)):
        try:
            call()
        except ValueError as e:
            refused += "head dim" in str(e)
    counts, by_instance = _launch_counts()[0], _instance_counts()
    print(f"head dim 0 on the card: {refused} of 3 wrappers raised; launches {counts}, by instance "
          f"{by_instance}", flush=True)
    if refused != 3 or any(counts.values()) or by_instance:
        fail("head dim 0 was not refused by every wrapper, or launched a kernel")


def check_f32_operands(card: str) -> dict:
    """Phase 2's f32 operands: each f32 kernel against its plain version in
    f32 at F32_CASES (TF32 off), o within F32_FWD_RELNORM, dq, dk and dv
    within F32_GRAD_RELNORM in relative norm and lse within F32_LSE_TOL;
    two dQ calls give the same bits; the F32_TIMED cases timed beside their
    bounds at PEAK_F32_ACCURATE_FLOPS (3xTF32), each kernel's profiler
    device time beside its CUDA-event time (at the ring's small blocks the
    host's launch takes longer than the kernel). Returns {kernel:
    {F32_TIMED's key: the kernel line's numbers}}."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import flash_attention as fa

    print(f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}, "
          f"torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = "
          f"{torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction}", flush=True)
    results = {name: {} for name in KERNELS}
    for case in F32_CASES:
        B, T, Tk, H, D, causal = case
        q, k, v, do = _inputs(case, torch.float32, seed=77)
        o, lse = fa.flash_fwd(q, k, v, causal)
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
        delta = (do * o_ref).sum(-1)
        dq = fa.flash_dq(q, k, v, do, lse_ref, delta, causal)
        dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, causal)
        refs = fa.flash_bwd_reference(q, k, v, do, lse_ref, delta, causal)
        torch.cuda.synchronize()
        where = f"B={B} T={T} Tk={Tk} H={H} Dh={D} causal={causal}, f32 operands"
        if any(t.dtype != torch.float32 for t in (o, dq, dk, dv)):
            fail(f"the f32 kernels returned {[t.dtype for t in (o, dq, dk, dv)]} at {where}")
        gaps = {name: bench.disagreement(got, ref) for name, got, ref in
                [("o", o, o_ref), ("dq", dq, refs[0]), ("dk", dk, refs[1]), ("dv", dv, refs[2])]}
        lse_err = (lse - lse_ref).abs().max().item()
        print(f"f32 kernels vs plain (f32) at {where}: " + _gap_text(gaps)
              + f"; lse max abs {lse_err:.3e}", flush=True)
        limits = {"o": F32_FWD_RELNORM, "dq": F32_GRAD_RELNORM, "dk": F32_GRAD_RELNORM,
                  "dv": F32_GRAD_RELNORM}
        bad = [n for n, g in gaps.items() if not g["relnorm"] <= limits[n]]
        if bad or not lse_err <= F32_LSE_TOL:
            fail(f"the f32 kernels' {bad or 'lse'} disagree with the plain version at {where} "
                 f"(relnorm limits {limits}, lse {F32_LSE_TOL})")
        for name in KERNELS:
            _held(name, D, q.dtype, True)
        del refs
        if case not in F32_TIMED:
            continue
        again = fa.flash_dq(q, k, v, do, lse_ref, delta, causal)
        if not torch.equal(dq, again):
            fail(f"two f32 flash_dq calls at {where} differ")
        print(f"flash_dq at {where}: two calls give the same bits", flush=True)
        timed = time_instance(case, q, k, v, do, lse, delta, gaps, card, peak=PEAK_F32_ACCURATE_FLOPS,
                              before=F32_BEFORE_REDESIGN_MS if case == F32_MAIN else None)
        for name, numbers in timed.items():
            results[name][F32_TIMED[case]] = numbers
        device = _device_ms({
            "flash_fwd": lambda: fa.flash_fwd(q, k, v, causal),
            "flash_dq": lambda: fa.flash_dq(q, k, v, do, lse, delta, causal),
            "flash_dkv": lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal)}, D)
        print(f"f32 kernels at {where}, CUDA events against the profiler's device time per call: " + ", ".join(
            f"{n} {timed[n]['ms']:.4f} / {device[n]:.4f} ms" for n in KERNELS) + f" [{card}]", flush=True)
        fwd = timed["flash_fwd"]
        print(f"f32 forward at {where}: {fwd['ms']:.4f} ms, SDPA's forward {fwd['library_ms']:.4f} ms "
              f"({fwd['ms'] / fwd['library_ms']:.2f}x), bound {fwd['bound_ms']:.4f} ms; "
              f"dQ + dK/dV {timed['flash_dq']['ms'] + timed['flash_dkv']['ms']:.4f} ms, "
              f"SDPA's backward (dq, dk and dv) {timed['flash_dq']['library_ms']:.4f} ms [{card}]", flush=True)
    return results


# f16 operands (the f16 instances): every instance head dim (16, 32, 64, 128,
# 256), ragged causal, non-causal with Tk != Tq and wrapping, head dims
# between instances (96, 48) and one the padding copy takes (20), each in
# both output types; at T 1024, where P is small and dS often subnormal in
# f16. Held by phase 2's rule, lse within LSE_TOL. F16_TIMED: timed, beside
# the bf16 instance's time at the same case in this run.
F16_CASES = [MAIN_CASE, MAIN_D128, (4, 512, 512, 4, 16, True), (2, 1000, 1000, 24, 32, True),
             (2, 200, 333, 4, 64, False), (2, 300, 1100, 2, 128, False), (2, 1024, 1024, 3, 256, True),
             (2, 1000, 1000, 8, 96, True), (2, 200, 333, 4, 48, False), (2, 512, 512, 4, 20, True)]
F16_TIMED = (MAIN_CASE, MAIN_D128)
# Mixed operand dtypes, (q, k, v) with dO in q's dtype (the autograd
# Function's), at Dh 64 and 48, causal (T 1024, ragged T 1000) and
# non-causal with Tk != Tq. Outputs in a 16-bit dtype by phase 2's rule;
# f32 outputs at the f32 limits (F32_FWD_RELNORM on o, F32_GRAD_RELNORM on
# dq, dk, dv), except o where v is 16-bit: the forward rounds P to v's dtype
# against its running row max, the plain version against the final one, so
# P's elements may round to neighbouring 16-bit values, as with the 16-bit
# kernels (held by phase 2's rule; an H100 measured relnorm 7.9e-4 to 1.3e-3 there);
# lse within F32_LSE_TOL (the f32 kernels).
MIXES = ((torch.bfloat16, torch.float32, torch.bfloat16), (torch.float32, torch.bfloat16, torch.bfloat16),
         (torch.float16, torch.bfloat16, torch.float16), (torch.float16, torch.float16, torch.float32))
MIXED_CASES = ((2, 1024, 1024, 4, 64, True), (2, 1000, 1000, 4, 48, True), (2, 200, 333, 4, 64, False))


def check_f16_operands(card: str, bf16: dict) -> dict:
    """Phase 2's f16 operands: each kernel's f16 instances against their
    plain versions at F16_CASES, in both output types, by phase 2's rule
    (lse within LSE_TOL), nothing but f16 instances launched; two dQ calls
    give the same bits at F16_TIMED, which are timed beside their bounds
    (f16's dense rate is bf16's), the plain versions, SDPA in f16 and the
    bf16 instance's time in this run (``bf16``: check_kernels' results).
    Returns {kernel: {"d<D> f16": the kernel line's numbers}}."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import flash_attention as fa

    results = {name: {} for name in KERNELS}
    _zero_launches()
    for case in F16_CASES:
        B, T, Tk, H, D, causal = case
        q, k, v, do = _inputs(case, torch.float16, seed=16)
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
        delta = (do.float() * o_ref.float()).sum(-1)
        for out_f32 in (False, True):
            o, lse = fa.flash_fwd(q, k, v, causal, out_f32=out_f32)
            dq = fa.flash_dq(q, k, v, do, lse_ref, delta, causal, out_f32=out_f32)
            dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, causal, out_f32=out_f32)
            o_want = fa.flash_fwd_reference(q, k, v, causal, out_f32=True)[0] if out_f32 else o_ref
            refs = fa.flash_bwd_reference(q, k, v, do, lse_ref, delta, causal, out_f32=out_f32)
            torch.cuda.synchronize()
            where = f"B={B} T={T} Tk={Tk} H={H} Dh={D} causal={causal}, f16 operands, {'f32' if out_f32 else 'f16'} outputs"
            want_dtype = torch.float32 if out_f32 else torch.float16
            if any(t.dtype != want_dtype for t in (o, dq, dk, dv)):
                fail(f"the f16 instances returned {[t.dtype for t in (o, dq, dk, dv)]} at {where}")
            gaps = {name: bench.disagreement(got, ref) for name, got, ref in
                    [("o", o, o_want), ("dq", dq, refs[0]), ("dk", dk, refs[1]), ("dv", dv, refs[2])]}
            lse_err = (lse - lse_ref).abs().max().item()
            print(f"f16 kernels vs plain at {where}: " + _gap_text(gaps) + f"; lse max abs {lse_err:.3e}",
                  flush=True)
            bad = [name for name, g in gaps.items() if not g["ok"]]
            if bad or not lse_err <= LSE_TOL:
                fail(f"the f16 instances' {bad or 'lse'} disagree with the plain version at {where} "
                     f"(limits: {_rule()}, lse {LSE_TOL})")
            for name in KERNELS:
                _held(name, D, torch.float16, out_f32)
            if not out_f32:
                kept = (lse, dq, gaps)
            del o, o_want, dq, dk, dv, refs
        if case not in F16_TIMED:
            continue
        lse, dq, gaps = kept
        where = f"B={B} T={T} Tk={Tk} H={H} Dh={D} causal={causal}, f16 operands"
        if not torch.equal(dq, fa.flash_dq(q, k, v, do, lse_ref, delta, causal)):
            fail(f"two f16 flash_dq calls at {where} differ")
        print(f"flash_dq at {where}: two calls give the same bits", flush=True)
        timed = time_instance(case, q, k, v, do, lse, delta, gaps, card)
        for name in KERNELS:
            results[name][_instance_key(D, torch.float16)] = timed[name]
            same = bf16[name]["instances"][_instance_key(D, torch.bfloat16)]["ms"]
            print(f"f16 against bf16 at {where}: {name} {timed[name]['ms']:.4f} ms, the bf16 instance "
                  f"{same:.4f} ms in this run ({timed[name]['ms'] / same:.3f}x) [{card}]", flush=True)
        del q, k, v, do, o_ref, lse_ref, delta, lse, dq
    by_instance = _instance_counts()
    print(f"f16 checks' launches by instance: {by_instance}", flush=True)
    if not by_instance or any(not key.endswith(" float16") for key in by_instance):
        fail(f"the f16 checks launched other instances than f16 ones: {by_instance}")
    return results


def check_mixed_operands(card: str) -> None:
    """Phase 2's mixed operand dtypes: each MIXES set at MIXED_CASES,
    forward and backward (the wrappers cast the operands to f32 and run the
    mixed library, which rounds P and dS as the Pallas kernels do), against
    the plain versions on the same operands (which round per operand), each
    output in its operand's dtype, by the limits above; only mixed
    instances launched."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import flash_attention as fa

    _zero_launches()
    for dtypes in MIXES:
        names = "/".join(SHORT[t] for t in dtypes)
        for case in MIXED_CASES:
            B, T, Tk, H, D, causal = case
            q, k, v, do = (x.to(t) for x, t in zip(_inputs(case, torch.float32, seed=5), (*dtypes, dtypes[0])))
            o, lse = fa.flash_fwd(q, k, v, causal)
            o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
            delta = (do.float() * o_ref.float()).sum(-1)
            dq = fa.flash_dq(q, k, v, do, lse_ref, delta, causal)
            dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, causal)
            refs = fa.flash_bwd_reference(q, k, v, do, lse_ref, delta, causal)
            torch.cuda.synchronize()
            where = f"B={B} T={T} Tk={Tk} H={H} Dh={D} causal={causal}, (q, k, v, dO) {names}/{SHORT[dtypes[0]]}"
            outs = {"o": (o, o_ref), "dq": (dq, refs[0]), "dk": (dk, refs[1]), "dv": (dv, refs[2])}
            if any(got.dtype != want.dtype for got, want in outs.values()):
                fail(f"the mixed route returned {[g.dtype for g, _ in outs.values()]} at {where}; the plain "
                     f"versions {[w.dtype for _, w in outs.values()]}")
            f32_limits = {"o": F32_FWD_RELNORM if v.dtype == torch.float32 else None, "dq": F32_GRAD_RELNORM,
                          "dk": F32_GRAD_RELNORM, "dv": F32_GRAD_RELNORM}
            gaps, bad = {}, []
            for name, (got, want) in outs.items():
                gaps[name] = bench.disagreement(got, want)
                limit = f32_limits[name] if got.dtype == torch.float32 else None
                if not (gaps[name]["relnorm"] <= limit if limit is not None else gaps[name]["ok"]):
                    bad.append(name)
            lse_err = (lse - lse_ref).abs().max().item()
            print(f"mixed route vs plain at {where}: " + _gap_text(gaps) + f"; lse max abs {lse_err:.3e}; "
                  f"output dtypes {[SHORT[g.dtype] for g, _ in outs.values()]}", flush=True)
            if bad or not lse_err <= F32_LSE_TOL:
                fail(f"the mixed route's {bad or 'lse'} disagree with the plain version at {where} "
                     f"(f32 outputs: relnorm {f32_limits}, 16-bit: {_rule()}; lse {F32_LSE_TOL})")
            for name in KERNELS:
                _held(name, D, "mixed", True)
            del q, k, v, do, o, lse, o_ref, lse_ref, delta, dq, dk, dv, refs, outs
    by_instance = _instance_counts()
    print(f"mixed checks' launches by instance: {by_instance}", flush=True)
    want = {fa.instance(name, case[4], "mixed"): len(MIXES) * sum(c[4] == case[4] for c in MIXED_CASES)
            for name in KERNELS for case in MIXED_CASES}
    if by_instance != want:
        fail(f"the mixed checks launched {by_instance}; expected {want}")


def check_refused_dtypes() -> None:
    """f64 and integer operands on the card raise in each wrapper, and
    nothing is launched (no fallback to the plain version)."""
    from ray_tpu_torch.ops import flash_attention as fa

    lse = torch.zeros(2, 128, device="cuda")
    _zero_launches()
    refused = 0
    for dtype in (torch.float64, torch.int32):
        q = torch.zeros(2, 128, 64, device="cuda", dtype=dtype)
        for call in (lambda: fa.flash_fwd(q, q, q, True), lambda: fa.flash_dq(q, q, q, q, lse, lse, True),
                     lambda: fa.flash_dkv(q, q, q, q, lse, lse, True)):
            try:
                call()
            except ValueError as e:
                refused += "operands" in str(e)
    torch.cuda.synchronize()
    counts, by_instance = _launch_counts()[0], _instance_counts()
    print(f"f64 and int32 operands on the card: {refused} of 6 wrapper calls raised; launches {counts}, "
          f"by instance {by_instance}", flush=True)
    if refused != 6 or any(counts.values()) or by_instance:
        fail("f64 or integer operands were not refused by every wrapper, or launched a kernel")


# Head dims above 256: the column-window kernels (csrc/flash_wide.cuh, in
# every library). (case, (q, k, v) dtypes with dO in q's, f32 outputs):
# gpt2-small's width as 3 heads of 264 (d 792), 2 of 384 and 1 of 768 (B 32,
# phase 14's); gpt2-medium's as 2 heads of 512 and 1 of 1024 (B 8); f16 at
# 384; f32 at 384 (phase 14's f32 run) and 512 (B 8); a mix at 320; 16-bit
# operands with f32 outputs (ring attention's block entries) at 384; then
# ragged causal, non-causal with Tk != Tq and wrapping, at widths the
# padding copy does not take and does (520; 260 in bf16). Held by the
# gates of their operands (phase 2's rule, f32's limits, a mix's), timed
# all but the last three.
BF16, F16, F32 = (torch.bfloat16,) * 3, (torch.float16,) * 3, (torch.float32,) * 3
WIDE_CASES = (
    ((32, 1024, 1024, 3, 264, True), BF16, False), ((32, 1024, 1024, 2, 384, True), BF16, False),
    ((32, 1024, 1024, 1, 768, True), BF16, False), ((8, 1024, 1024, 2, 512, True), BF16, False),
    ((8, 1024, 1024, 1, 1024, True), BF16, False), ((32, 1024, 1024, 2, 384, True), F16, False),
    ((8, 1024, 1024, 2, 384, True), F32, False), ((8, 1024, 1024, 2, 512, True), F32, False),
    ((8, 1024, 1024, 2, 320, True), (torch.bfloat16, torch.float32, torch.bfloat16), False),
    ((32, 1024, 1024, 2, 384, True), BF16, True),
    ((2, 1000, 1000, 2, 384, True), BF16, False), ((2, 200, 333, 2, 520, False), F32, False),
    ((2, 300, 1100, 2, 260, False), BF16, False),
)
WIDE_TIMED = 10  # the first ten cases
WIDE_WINDOW_CASE = (8, 1024, 1024, 2, 512, True)  # the window check's (bf16)


def sdpa_backend(q, k, v, causal: bool) -> str:
    """The backend F.scaled_dot_product_attention takes for these [B, H, T,
    Dh] inputs (torch._fused_sdp_choice, the choice its dispatcher makes):
    flash_attention, efficient_attention, cudnn_attention, or math (the
    plain fallback: no fused kernel takes the head dim)."""
    from torch.nn.attention import SDPBackend

    choice = torch._fused_sdp_choice(q, k, v, is_causal=causal)
    return next(n for n, m in SDPBackend.__members__.items() if int(m.value) == choice).lower()


def _case_inputs(case, dtypes, seed):
    """q, k, v, dO of ``case`` in ``dtypes`` (q, k, v; dO in q's), from one
    seeded f32 draw on the card."""
    return tuple(x.to(t) for x, t in zip(_inputs(case, torch.float32, seed=seed), (*dtypes, dtypes[0])))


def check_wide_head_dims(card: str) -> dict:
    """Phase 2's head dims above 256: each column-window kernel against its
    plain version at WIDE_CASES, by the gates of its operands (16-bit
    outputs by phase 2's rule, f32 outputs of f32 operands at F32_FWD_RELNORM
    and F32_GRAD_RELNORM in relative norm, a mix's by check_mixed_operands'
    limits; lse within LSE_TOL, F32_LSE_TOL for the f32 kernels), only the
    case's window instances launched (one launch a call); dQ twice for the
    same bits and each kernel timed (time_wide) at the first
    WIDE_TIMED cases, with the backend SDPA took; then the window check
    (window_check). Returns {kernel: {"d<D> <operands>[->f32]": the kernel
    line's numbers}}."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import flash_attention as fa

    results = {name: {} for name in KERNELS}
    for i, (case, dtypes, out_f32) in enumerate(WIDE_CASES):
        B, T, Tk, H, D, causal = case
        mixed = len(set(dtypes)) > 1
        operands = "mixed" if mixed else dtypes[0]
        f32_kernels = mixed or dtypes[0] == torch.float32
        q, k, v, do = _case_inputs(case, dtypes, seed=31 + D)
        _zero_launches()
        o, lse = fa.flash_fwd(q, k, v, causal, out_f32=out_f32)
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
        delta = (do.float() * o_ref.float()).sum(-1)
        dq = fa.flash_dq(q, k, v, do, lse_ref, delta, causal, out_f32=out_f32)
        dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, causal, out_f32=out_f32)
        torch.cuda.synchronize()
        by_instance = _instance_counts()
        want_launches = {fa.instance(name, D, operands): 1 for name in KERNELS}
        o_want = fa.flash_fwd_reference(q, k, v, causal, out_f32=True)[0] if out_f32 else o_ref
        refs = fa.flash_bwd_reference(q, k, v, do, lse_ref, delta, causal, out_f32=out_f32)
        where = (f"B={B} T={T} Tk={Tk} H={H} Dh={D} causal={causal}, (q, k, v) "
                 + "/".join(SHORT[t] for t in dtypes) + (", f32 outputs" if out_f32 else ""))
        outs = {"o": (o, o_want), "dq": (dq, refs[0]), "dk": (dk, refs[1]), "dv": (dv, refs[2])}
        if any(got.dtype != want.dtype or got.shape != want.shape for got, want in outs.values()):
            fail(f"the column-window kernels returned {[(g.dtype, tuple(g.shape)) for g, _ in outs.values()]} "
                 f"at {where}; the plain versions {[(w.dtype, tuple(w.shape)) for _, w in outs.values()]}")
        limits = {"o": F32_FWD_RELNORM if dtypes[2] == torch.float32 else None, "dq": F32_GRAD_RELNORM,
                  "dk": F32_GRAD_RELNORM, "dv": F32_GRAD_RELNORM}
        gaps, bad = {}, []
        for name, (got, want) in outs.items():
            gaps[name] = bench.disagreement(got, want)
            limit = limits[name] if got.dtype == torch.float32 and f32_kernels else None
            if not (gaps[name]["relnorm"] <= limit if limit is not None else gaps[name]["ok"]):
                bad.append(name)
        lse_err = (lse - lse_ref).abs().max().item()
        lse_tol = F32_LSE_TOL if f32_kernels else LSE_TOL
        print(f"column-window kernels vs plain at {where}: " + _gap_text(gaps) + f"; lse max abs {lse_err:.3e}; "
              f"launches {by_instance}", flush=True)
        if bad or not lse_err <= lse_tol:
            fail(f"the column-window kernels' {bad or 'lse'} disagree with the plain version at {where} "
                 f"(f32 outputs of the f32 kernels: relnorm {limits}, else {_rule()}; lse {lse_tol})")
        if by_instance != want_launches:
            fail(f"the checks at {where} launched {by_instance}; expected {want_launches}")
        for name in KERNELS:
            _held(name, D, operands, out_f32)
        del o_want, refs, outs
        if i >= WIDE_TIMED:
            continue
        again = fa.flash_dq(q, k, v, do, lse_ref, delta, causal, out_f32=out_f32)
        if not torch.equal(dq, again):
            fail(f"two flash_dq calls at {where} differ")
        print(f"flash_dq at {where}: two calls give the same bits", flush=True)
        del again
        key = _instance_key(D, dtypes[0]) if not mixed else f"d{D} mixed"
        key += "->f32" if out_f32 else ""
        timed = time_wide(case, q, k, v, do, lse, delta, gaps, card, dtypes, out_f32)
        for name in KERNELS:
            results[name][key] = timed[name]
        del q, k, v, do, o, lse, o_ref, lse_ref, delta, dq, dk, dv
    window_check()
    return results


def time_wide(case, q, k, v, do, lse, delta, gaps, card, dtypes, out_f32: bool) -> dict:
    """The three kernels at ``case`` (the wrappers, median of 20 calls, CUDA
    events) beside their bounds (each operand at its own size; the 3xTF32
    rate where one is f32), their plain versions and SDPA on the same
    inputs (cast to f32 for a mix) with the backend it took. Returns
    {kernel: the kernel line's numbers, with sdpa_backend}."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import flash_attention as fa

    B, T, Tk, H, D, causal = case
    in_bytes = tuple(t.itemsize for t in dtypes)
    bnd = bounds(*case, out_bytes=4 if out_f32 else in_bytes, in_bytes=in_bytes,
                 peak=PEAK_F32_ACCURATE_FLOPS if torch.float32 in dtypes else PEAK_BF16_FLOPS)
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal, out_f32=out_f32),
                      lambda: fa.flash_fwd_reference(q, k, v, causal, out_f32)),
        "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, causal, out_f32=out_f32),
                     lambda: fa.flash_dq_reference(q, k, v, do, lse, delta, causal, out_f32)),
        "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal, out_f32=out_f32),
                      lambda: fa.flash_dkv_reference(q, k, v, do, lse, delta, causal, out_f32)),
    }
    ms = {name: bench.time_ms(kernel) for name, (kernel, _) in calls.items()}
    plain_ms = {name: bench.time_ms(plain, iters=5) for name, (_, plain) in calls.items()}
    like = torch.float32 if len(set(dtypes)) > 1 else dtypes[0]
    qs, ks, vs = (x.to(like).view(B, H, -1, D).detach().requires_grad_() for x in (q, k, v))
    dos = do.to(like).view(B, H, T, D)
    backend = sdpa_backend(qs, ks, vs, causal)
    with torch.no_grad():
        sdpa_fwd = bench.time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    sdpa_bwd = bench.time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True))
    library = {"flash_fwd": sdpa_fwd, "flash_dq": sdpa_bwd, "flash_dkv": sdpa_bwd}
    err_of = {"flash_fwd": gaps["o"]["max_abs"], "flash_dq": gaps["dq"]["max_abs"],
              "flash_dkv": max(gaps["dk"]["max_abs"], gaps["dv"]["max_abs"])}
    results = {}
    for name in KERNELS:
        results[name] = {
            "max_abs_err": err_of[name], "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": bnd[name][0], "bound_by": bnd[name][1], "library_ms": library[name],
            "sdpa_backend": backend, "launches_a_call": fa.kernel_passes(name, D),
            "windows": fa.windows(name, D),
        }
        print(f"time {name} at B={B} T={T} Tk={Tk} H={H} Dh={D} causal={causal}, "
              + "/".join(SHORT[t] for t in dtypes) + (" -> f32" if out_f32 else "")
              + (f" ({fa.windows(name, D)} windows of {fa.WIDE_WINDOWS[name]})" if D > fa.HEAD_DIMS[-1] else "")
              + f": kernel {ms[name]:.4f} ms, bound "
              f"{bnd[name][0]:.4f} ms ({bnd[name][1]}), {ms[name] / bnd[name][0]:.1f}x; plain {plain_ms[name]:.4f} ms, "
              f"SDPA ({backend}, {'backward: dq, dk and dv in one call' if name != 'flash_fwd' else 'forward'}) "
              f"{library[name]:.4f} ms [{card}]", flush=True)
    del qs, ks, vs, dos, out
    return results


def window_check() -> None:
    """The windows compute the same scores: at WIDE_WINDOW_CASE (Dh 512,
    two windows of 256 for o and dQ, four of 128 for dK and dV) with
    columns 256-511 of q, k, v and dO copied from 0-255, each output's two
    halves are bitwise equal (every window recomputes S, P and dS over the
    whole head dim in one order, and the copied columns feed the same
    products in the same places)."""
    from ray_tpu_torch.ops import flash_attention as fa

    B, T, Tk, H, D, causal = WIDE_WINDOW_CASE
    q, k, v, do = _case_inputs(WIDE_WINDOW_CASE, BF16, seed=512)
    for x in (q, k, v, do):
        x[..., D // 2:] = x[..., :D // 2]
    o, lse = fa.flash_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    equal = {n: torch.equal(x[..., :D // 2], x[..., D // 2:]) for n, x in (("o", o), ("dq", dq), ("dk", dk),
                                                                           ("dv", dv))}
    print(f"window check at B={B} T={T} H={H} Dh={D}, columns 256-511 of q, k, v, dO copied from 0-255: "
          f"halves bitwise equal {equal}", flush=True)
    if not all(equal.values()):
        fail(f"the windows of the column-window kernels disagree: halves equal {equal}")


# The mixed route timed (bf16 q and v, f32 k, dO in q's), the library call
# SDPA on the operands cast to f32.
MIXED_TIMED = ((8, 1024, 1024, 12, 64, True), (torch.bfloat16, torch.float32, torch.bfloat16))


def time_mixed_operands(card: str) -> dict:
    """The mixed route at MIXED_TIMED: each kernel (the wrapper: the casts
    to f32, the f32 kernels rounding P and dS, the casts back) beside its
    bound, its plain version and SDPA on f32 casts. Returns
    {kernel: {"d64 mixed": the kernel line's numbers}}."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import flash_attention as fa

    case, dtypes = MIXED_TIMED
    q, k, v, do = _case_inputs(case, dtypes, seed=5)
    o_ref, lse = fa.flash_fwd_reference(q, k, v, case[5])
    delta = (do.float() * o_ref.float()).sum(-1)
    gaps = {n: bench.disagreement(got, want) for n, got, want in (
        ("o", fa.flash_fwd(q, k, v, case[5])[0], o_ref),
        ("dq", fa.flash_dq(q, k, v, do, lse, delta, case[5]), fa.flash_dq_reference(q, k, v, do, lse, delta, case[5])),
        *zip(("dk", "dv"), fa.flash_dkv(q, k, v, do, lse, delta, case[5]),
             fa.flash_dkv_reference(q, k, v, do, lse, delta, case[5])))}
    timed = time_wide(case, q, k, v, do, lse, delta, gaps, card, dtypes, False)
    return {name: {f"d{case[4]} mixed": timed[name]} for name in KERNELS}


def _device_ms(calls: dict, head_dim: int, rounds: int = 10) -> dict:
    """Device ms per call of each f32 kernel ({kernel: call} at
    ``head_dim``), from one torch.profiler window of ``rounds`` calls of
    each, which must show exactly the kernels those calls launch
    (fa.kernel_passes: dK/dV's two passes at head dim 256), added up per
    call."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.ops import flash_attention as fa

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for call in calls.values():
                call()
        torch.cuda.synchronize()
    kernels = _device_kernels(prof, "the f32 kernels")
    out = {}
    for name in calls:
        kernel = name.replace("flash_", "flash_f32_") + "_kernel"
        times = [ev.time_range.elapsed_us() for ev in kernels if kernel in ev.name]
        if len(times) != rounds * fa.kernel_passes(name, head_dim):
            fail(f"the profiler saw {len(times)} launches of {name}'s f32 kernel in {rounds} calls "
                 f"at head dim {head_dim} ({fa.kernel_passes(name, head_dim)} a call)")
        out[name] = sum(times) / rounds / 1e3
    return out


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


def check_gradients(run, card: str, loss_tol: float = LOSS_REF_TOL, loss_relative: bool = False,
                    grad_tol: float = GRAD_RELNORM_TOL, chunks: int = 1, loss_scale: float = 1.0,
                    gate: bool = True) -> float:
    """Step 0's loss and every parameter's gradient through the flash
    kernels against the same model and batch with reference attention:
    the loss within ``loss_tol`` (of the reference's loss if
    ``loss_relative``), each gradient within ``grad_tol`` in relative
    norm. With ``chunks`` > 1 each pass takes the batch's rows in that many
    equal chunks, each chunk's mean loss over ``chunks`` (the batch's mean
    loss and gradient, in less memory: reference attention keeps a [rows,
    H, T, T] score tensor per layer). ``loss_scale``: both passes
    differentiate the loss times it and divide the gradients by it (a static
    loss scale, which keeps an f16 backward's small gradients in f16's
    range). Without ``gate`` the gaps are printed and not held. Leaves the
    model's gradients unset. Returns the flash path's loss."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import gpt2

    model, tokens = run.model, run.batches[0]
    losses, grads = {}, {}
    for impl in ("flash", "reference"):
        model.zero_grad(set_to_none=True)
        cfg = dataclasses.replace(run.cfg, attn_impl=impl)
        losses[impl] = 0.0
        for part in tokens.chunk(chunks):
            loss = gpt2.loss_fn(model, part, cfg) / chunks
            (loss * loss_scale if loss_scale != 1.0 else loss).backward()
            losses[impl] += loss.item()
            del loss
        grads[impl] = {n: p.grad.detach().float() / loss_scale for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    rel = bench.relnorms(grads["flash"], grads["reference"])
    worst = sorted(rel.items(), key=lambda kv: -kv[1])
    print(f"step 0 flash vs reference attention{f', loss scale {loss_scale:g}' if loss_scale != 1.0 else ''}"
          f"{'' if gate else ' (not held)'}: loss {losses['flash']:.6f} vs "
          f"{losses['reference']:.6f} (gap {abs(losses['flash'] - losses['reference']):.3e}); "
          f"gradient relnorm over {len(rel)} leaves: max {worst[0][1]:.3e} ({worst[0][0]}), "
          f"median {statistics.median(rel.values()):.3e} [{card}]", flush=True)
    print("  largest: " + ", ".join(f"{n} {r:.3e}" for n, r in worst[:6]))
    if not gate:
        return losses["flash"]
    limit = loss_tol * (abs(losses["reference"]) if loss_relative else 1.0)
    if not abs(losses["flash"] - losses["reference"]) <= limit:
        fail(f"step-0 loss {losses['flash']} vs reference attention {losses['reference']}: "
             f"> {limit}")
    zero = [n for n, g in grads["flash"].items() if n not in rel and g.norm().item() > 0]
    bad = [n for n, r in rel.items() if not r <= grad_tol] + zero
    if bad:
        fail(f"gradients of {bad} disagree with reference attention (relnorm > {grad_tol})")
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
    return counts, losses, step_ms


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


def serve(card: str) -> dict:
    """Phase 4. Returns the 24 requests' TTFT p50 and p95 (ms) and output
    tokens/s."""
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
    recompute_engine([r for i, r in enumerate(reqs) if i in plain][:N_RECOMPUTE], model, cfg,
                     card)
    if any(fa.launches.values()):
        fail(f"serving launched flash kernels: {dict(fa.launches)}")
    print(f"serving launched no flash kernel: {dict(fa.launches)}", flush=True)
    return {"p50": st["ttft_s"]["p50"] * 1e3, "p95": st["ttft_s"]["p95"] * 1e3,
            "tok_s": n_tok / wall}


N_RECOMPUTE = 8  # requests for the recompute engine, at once: one batch of max_batch_size


def recompute_engine(reqs: list, model, cfg, card: str) -> None:
    """``reqs`` (greedy, unary) at once on a fresh recompute engine and on a
    fresh kv engine: the streams equal (or a near tie), each engine's output
    tokens/s. The recompute engine runs GPT2.forward with the model's
    attn_impl ("reference"), so no flash kernel."""
    from ray_tpu_torch.ops import flash_attention as fa

    if len(reqs) != N_RECOMPUTE or any(
            len(r["prompt_tokens"]) + MAX_NEW > cfg.n_positions for r in reqs):
        fail("the recompute engine's requests do not fit its batch or n_positions")
    streams, rates = {}, {}
    for name, kw in (("recompute", {"engine": "recompute"}), ("kv", {})):
        before = dict(fa.launches)
        eng = make_server(**kw)
        with ThreadPoolExecutor(max_workers=len(reqs)) as pool:
            t0 = time.perf_counter()
            streams[name] = list(pool.map(lambda r: ask(eng, r), reqs))
            wall = time.perf_counter() - t0
        st = eng.batch_stats()
        stop_server(eng)
        rates[name] = sum(len(o) for o in streams[name]) / wall
        print(f"{name} engine: {len(reqs)} requests at once (prompts of "
              f"{min(len(r['prompt_tokens']) for r in reqs)}-"
              f"{max(len(r['prompt_tokens']) for r in reqs)} tokens, {MAX_NEW} new each) in "
              f"{wall:.3f} s, {rates[name]:.1f} output tokens/s; {st['batches']} batches or "
              f"dispatches, max batch {st['max_batch']} [{card}]", flush=True)
        if name == "recompute" and dict(fa.launches) != before:
            fail(f"the recompute engine launched flash kernels: {dict(fa.launches)}")
    print(f"recompute vs kv engine: {rates['recompute']:.1f} vs {rates['kv']:.1f} output tokens/s "
          f"({rates['kv'] / rates['recompute']:.2f}x) [{card}]", flush=True)
    compare_streams("recompute", streams["recompute"], "kv", streams["kv"], reqs, model, cfg,
                    near_ties=True)


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
# The ring in f32 at Dh 32 (B, T, H, Dh of the whole sequence; causal): the
# JAX package's ring test's shape (tests/test_ring_attention.py: B 2, T 64,
# H 4, Dh 32, 4 ranks of 16 rows), and one whose blocks span many tiles.
# Held to reference attention in f32 at that test's limits: the output
# within RING_F32_TOL (rtol and atol), the gradients of sum(out^2) within
# rtol 5e-4, atol 5e-5.
RING_F32_SHAPES = [(2, 64, 4, 32), (2, 4096, 4, 32)]
RING_F32_TOL = 2e-5
RING_F32_GRAD_TOL = (5e-4, 5e-5)
# gpt2-small's MLP widths as 8 experts, top-2 routing, bf16 tokens, f32 weights
MOE_TOKENS, MOE_D, MOE_F, MOE_E, MOE_TOP_K, MOE_CAPACITY = 4096, 768, 3072, 8, 2, 1280
# moe_block on a group of one against moe_block_local: the dryrun leg's 1e-3
# on the loss (relative); each gradient within 1e-3 in relative norm (the
# same f32 arithmetic, the exchange a copy).
MOE_LOSS_RTOL, MOE_GRAD_RELNORM = 1e-3, 1e-3


def _bf16(gen, *shape):
    return torch.randn(*shape, device="cuda", dtype=torch.bfloat16, generator=gen)


def check_f32_blocks(card: str, operands: torch.dtype = torch.bfloat16) -> dict:
    """Each kernel's f32-output instantiation for 16-bit ``operands`` (bf16,
    or f16) against its plain version (f32 outputs, the same operands) at
    the ring's block shapes, by phase 2's rule, lse within LSE_TOL; then, for
    bf16, both instantiations timed at the diagonal and the earlier block.
    Returns the kernel line's "f32" entries."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import flash_attention as fa

    info = {name: {"max_abs_err": 0.0, "ms": {}, "bf16_ms": {}, "bound_ms": {}} for name in KERNELS}
    for B, T, Tk, H, D, causal in BLOCK_CASES:
        g = torch.Generator(device="cuda").manual_seed(4321)
        draw = lambda *shape: torch.randn(*shape, device="cuda", dtype=operands, generator=g)  # noqa: E731
        q, k, v, do = draw(B * H, T, D), draw(B * H, Tk, D), draw(B * H, Tk, D), draw(B * H, T, D)
        o, lse = fa.flash_fwd(q, k, v, causal, out_f32=True)
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, out_f32=True)
        delta = (do.float() * o_ref.to(operands).float()).sum(-1)
        dq = fa.flash_dq(q, k, v, do, lse_ref, delta, causal, out_f32=True)
        dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, causal, out_f32=True)
        refs = fa.flash_bwd_reference(q, k, v, do, lse_ref, delta, causal, out_f32=True)
        torch.cuda.synchronize()
        where = f"B={B} Tq={T} Tk={Tk} H={H} Dh={D} causal={causal}, {SHORT[operands]} operands, f32 outputs"
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
            _held(name, D, q.dtype, True)
        del o_ref, refs
        if D != 64 or Tk != T or operands != torch.bfloat16:
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
    largest of the rest by name (``bench.device_split``)."""
    from ray_tpu_torch import bench

    try:
        return bench.device_split(fn)
    except RuntimeError as e:
        fail(f"{e} for the ring")


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


def time_ring(x: dict, shards: dict, leaves: list, card: str, shape: tuple = RING_SHAPE,
              f32: bool = False) -> None:
    """Median of 20 calls (CUDA events) of the emulated ring's forward and
    forward+backward, the monolithic flash attention's and SDPA's on the
    same inputs; one profiled call of each ring pass splits its device
    time between the kernels and the rest. ``f32``: f32 operands, bounds
    at the 3xTF32 rate."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops.ring_attention import ring_attention_emulated

    B, T, H, D = shape
    what = "emulated ring in f32" if f32 else "emulated ring"
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
    bnd = (bounds(B, T, T, H, D, True, out_bytes=4, in_bytes=4, peak=PEAK_F32_ACCURATE_FLOPS) if f32
           else bounds(B, T, T, H, D, True))
    bound_fwd, bound_bwd = bnd["flash_fwd"][0], bnd["flash_dq"][0] + bnd["flash_dkv"][0]
    for label, fn, wall, bound in (("forward", ring_fwd, ms["ring_fwd"], bound_fwd),
                                   ("forward+backward", ring_all, ms["ring_all"],
                                    bound_fwd + bound_bwd)):
        flash, rest, top = _device_split(fn)
        print(f"{what} {label}: {wall:.3f} ms (CUDA events), device time in the flash "
              f"kernels {flash:.3f} ms, outside them {rest:.3f} ms ({100 * rest / (flash + rest):.1f}% "
              f"of the device time; merges, accumulations, folds, casts), bound {bound:.3f} ms "
              f"[{card}]", flush=True)
        print("  largest outside the kernels (ms): " + "; ".join(
            f"{t:.3f} {name[:60]}" for name, t in top), flush=True)
    print(f"monolithic flash attention at T={T}{', f32' if f32 else ''}: forward {ms['mono_fwd']:.3f} ms, "
          f"forward+backward {ms['mono_all']:.3f} ms; SDPA (library, not called by the port): forward "
          f"{ms['sdpa_fwd']:.3f} ms, forward+backward {ms['sdpa_all']:.3f} ms; {what} "
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


def check_ring_f32(card: str) -> dict:
    """The emulated ring of RING_RANKS ranks in f32 at each of
    RING_F32_SHAPES (causal) against reference attention in f32 (TF32 off):
    the output, and the gradients of sum(out^2) (the cotangent 2 out at the
    reference's output, handed to both), every block through the f32
    kernels; the longest ring then timed as time_ring times the bf16 one.
    Returns the f32-operand launches per kernel of the last ring."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops.attention import attention
    from ray_tpu_torch.ops.ring_attention import ring_attention_emulated

    launched = {}
    for B, T, H, D in RING_F32_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(8)
        x = {name: torch.randn(B, T, H, D, device="cuda", generator=g) for name in ("q", "k", "v")}
        leaves = [x[name].clone().requires_grad_() for name in ("q", "k", "v")]
        ref = attention(*leaves, causal=True, impl="reference")
        do = 2 * ref.detach()
        ref.backward(do)
        shards = {name: list(t.chunk(RING_RANKS, dim=1)) for name, t in x.items()}
        _zero_launches()
        ring = ring_attention_emulated(shards["q"], shards["k"], shards["v"],
                                       list(do.chunk(RING_RANKS, dim=1)), causal=True)
        torch.cuda.synchronize()
        by_instance = _instance_counts()
        launched = {name: by_instance.get(fa.instance(name, D, torch.float32), 0) for name in KERNELS}
        got = [torch.cat(parts, dim=1) for parts in ring]
        want = [ref.detach()] + [t.grad for t in leaves]
        gaps = {}
        for name, a, b, (rtol, atol) in zip(("o", "dq", "dk", "dv"), got, want,
                                            [(RING_F32_TOL, RING_F32_TOL)] + [RING_F32_GRAD_TOL] * 3):
            excess = ((a - b).abs() - atol - rtol * b.abs()).max().item()  # <= 0 passes
            gaps[name] = ((a - b).abs().max().item(), excess)
        print(f"emulated ring in f32 ({RING_RANKS} ranks, [B, T, H, Dh] = {[B, T, H, D]}, causal) "
              f"vs reference attention (f32): " + ", ".join(
                  f"{n} max abs {m:.3e}" for n, (m, _) in gaps.items())
              + f" (limits: o rtol=atol={RING_F32_TOL}, gradients rtol {RING_F32_GRAD_TOL[0]} atol "
              f"{RING_F32_GRAD_TOL[1]}); launches by instance {by_instance} [{card}]", flush=True)
        bad = [n for n, (_, excess) in gaps.items() if not excess <= 0]
        if bad:
            fail(f"the f32 ring's {', '.join(bad)} disagree with reference attention")
        want_launches = dict.fromkeys(KERNELS, RING_LAUNCHES)
        if launched != want_launches or sum(by_instance.values()) != 3 * RING_LAUNCHES:
            fail(f"the f32 ring launched {by_instance}; expected {want_launches} f32-operand "
                 f"launches at Dh {D} and no other")
        for name in KERNELS:
            _held(name, D, torch.float32, True)
        del ring, got, want
        if (B, T, H, D) == RING_F32_SHAPES[-1]:
            x["do"] = do
            shards["do"] = list(do.chunk(RING_RANKS, dim=1))
            time_ring(x, shards, leaves, card, shape=(B, T, H, D), f32=True)
        del leaves, ref
    return launched


def parallel(card: str) -> dict:
    """Phase 5. Returns the kernel line's "f32" entry of each kernel."""
    info = check_f32_blocks(card)
    f16 = check_f32_blocks(card, torch.float16)  # the f16 ring's blocks
    for name in KERNELS:
        info[name]["f16_operands_max_abs_err"] = f16[name]["max_abs_err"]
    ring_launches, x, mono = check_ring(card)
    for name in KERNELS:
        info[name]["ring_launches"] = ring_launches[name]
    check_group_paths(x, mono, card)
    f32_ring = check_ring_f32(card)
    for name in KERNELS:
        info[name]["f32_operand_ring_launches"] = f32_ring[name]
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


# ---------------------------------------------------------------------------
# Phase 7: the runtime, and bench.py's main path fed by the data pipeline
# ---------------------------------------------------------------------------

PIPE_STEPS = 20  # bench.py's timed steps (bench.py:77), after one warm-up step
PIPE_LOSS_RTOL = 1e-5  # steps 0-4 against phase 3's, relative


def session_leftovers(session_id: str) -> tuple:
    """(pids of the session's live worker processes, its shm and spill paths)."""
    pids = []
    for proc in Path("/proc").glob("[0-9]*"):
        try:
            args = (proc / "cmdline").read_bytes().decode(errors="replace").split("\0")
        except OSError:
            continue
        if ("ray_tpu_torch.core.worker_main" in args and "--session-id" in args
                and args[args.index("--session-id") + 1] == session_id):
            pids.append(int(proc.name))
    from ray_tpu_torch.utils.config import config

    tag = session_id[:8]
    files = [str(f) for f in Path("/dev/shm").glob(f"rtt*_{tag}*")]
    files += [str(f) for f in Path(config.temp_dir).glob(f"rttspill_{tag}*")]
    return pids, files


def pipeline_train(card: str, phase3: tuple) -> None:
    """``phase3``: (launch counts, the five losses, median step ms) of phase 3."""
    import ray_tpu_torch
    from ray_tpu_torch import bench
    from ray_tpu_torch.core import worker as worker_mod

    B, T = bench.BATCH, bench.SEQ
    ray_tpu_torch.init(num_cpus=2)
    session = worker_mod.global_worker().session_id
    try:
        total = ray_tpu_torch.cluster_resources()
        print(f"runtime: session {session[:8]}, cluster resources {total}", flush=True)
        if total.get("GPU") != 1:
            fail(f"cluster_resources() shows GPU {total.get('GPU')}, expected 1")
        run = bench.setup(0)
        host = bench.token_pipeline(B * (PIPE_STEPS + 1), B, T, run.cfg.vocab_size,
                                    parallelism=PIPE_STEPS + 1)
        _zero_launches()
        res = bench.pipeline_steps(run, host, record=True)
        torch.cuda.synchronize()
        counts, counts_f32 = _launch_counts()
        line = bench.result_line(run, res, bench.MODEL, B, T)
    finally:
        ray_tpu_torch.shutdown()

    if res.steps != PIPE_STEPS or len(res.tokens) != PIPE_STEPS + 1:
        fail(f"the pipeline gave {len(res.tokens)} batches, expected {PIPE_STEPS + 1}")
    differ = [i for i, tok in enumerate(res.tokens)
              if not np.array_equal(tok, bench.batch_tokens(i, run.cfg.vocab_size, B, T))]
    print(f"pipeline batches: {len(res.tokens)} of [{B}, {T + 1}] int32, equal to "
          f"bench.batch_tokens(i) bitwise: {not differ}", flush=True)
    if differ:
        fail(f"pipeline batches {differ} differ from bench.batch_tokens")
    want = phase3[1]
    got = res.losses[:len(want)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"pipeline-fed steps 0-{len(want) - 1}: losses {', '.join(f'{x:.6f}' for x in got)}; "
          f"phase 3 {', '.join(f'{x:.6f}' for x in want)}; bitwise equal {got == want}, largest "
          f"relative gap {rel:.3e} (limit {PIPE_LOSS_RTOL})", flush=True)
    if not rel <= PIPE_LOSS_RTOL:
        fail(f"the pipeline-fed losses {got} disagree with phase 3's {want}")
    steps = PIPE_STEPS + 1
    per_step = {name: n / steps for name, n in counts.items()}
    design = design_launches(run.cfg, remat=False)
    if per_step != design or any(counts_f32.values()):
        fail(f"the pipeline-fed step launched {counts} in {steps} steps (f32 {counts_f32}); the "
             f"design says {design} per step")
    med = statistics.median(res.step_ms)
    tok_s = B * T * res.steps / res.seconds
    print(f"pipeline-fed train step ({bench.MODEL}, B={B}, T={T}, {res.steps} timed steps after one "
          f"warm-up): {tok_s:.1f} tokens/s, median step {med:.2f} ms (CUDA events, end to end; "
          f"min {min(res.step_ms):.2f}, max {max(res.step_ms):.2f}); host wait in next() per step "
          f"median {statistics.median(res.wait_ms):.3f} ms, max {max(res.wait_ms):.3f} ms, of it on "
          f"the data iterator median {statistics.median(res.fetch_ms[2:]):.3f} ms, max "
          f"{max(res.fetch_ms[2:]):.3f} ms (first batch {res.fetch_ms[0]:.1f} ms), on its staging "
          f"(pinned buffer, copy queued) median {statistics.median(res.stage_ms[2:]):.3f} ms, max "
          f"{max(res.stage_ms[2:]):.3f} ms; phase 3 "
          f"(batches on the card already): median {phase3[2]:.2f} ms, {B * T / phase3[2] * 1e3:.1f} "
          f"tokens/s; launches per step {per_step} [{card}]", flush=True)
    print(f"bench.py's line for this run: {json.dumps(line)}", flush=True)

    deadline = time.monotonic() + 30
    while True:
        pids, files = session_leftovers(session)
        if not (pids or files) or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    print(f"after shutdown(): {len(pids)} worker processes of the session alive, {len(files)} of "
          f"its shm and spill paths left", flush=True)
    if pids or files:
        fail(f"the session left worker processes {pids} and files {files}")


# ---------------------------------------------------------------------------
# Phase 8: pipeline parallelism, gpt2-small in two stage actors on one card
# ---------------------------------------------------------------------------

PP_MB = 4  # bench.py's 32 rows as 4 microbatches of 8
PP_SPLIT = 6  # stage 0: wte, wpe, blocks 0-5; stage 1: blocks 6-11, ln_f, head
# The SGD step of the parity and bitwise checks. (p - p') / lr is then the
# gradient to well under the limit: p's f32 rounding is ~1e-7 of |p|.
PP_SGD_LR = 1.0
PP_TIMED = 5  # AdamW steps timed per tier, after one warm-up step
PP_TIERS = (("rpc", "gpipe"), ("compiled", "gpipe"), ("compiled", "1f1b"))
# A channel slot holds one activation, [8, 1024, 768] bf16 = 12,582,912
# bytes, plus its pickle header; the compiled graph's default of 4 MiB
# holds none.
PP_CAPACITY = 16 << 20
# The first step of a stage loads the kernel library (phase 1 built it).
PP_STEP_TIMEOUT_S = 300.0
PP_HOPS, PP_PINGS = 12, 200  # hop rounds (the first 2 not counted); test_dag's 200 calls
# Each stage process's share of the card (num_gpus): two halves of the one
# card here; placed_cards.py gives each stage a card of its own.
PP_STAGE_GPUS = 0.5


def pipeline_stage_fns(cfg, split: int):
    """The two stages' functions and the loss. Stage 0 maps tokens [b, T+1]
    to the hidden state after block split-1; stage 1 runs the other blocks
    and ln_f and returns (ln_f(x), head), or ln_f(x) alone with no grad
    (inference: the head is the loss's operand, not an output); the loss is
    the port's fused CE on that pair against tokens[:, 1:]. Both compute as
    GPT2.backbone and GPT2.loss do, through the port's Block. A string in
    place of the tokens or the activation is the smoke's probe of the stage
    process: "reset" zeroes its kernel launch counts and its peak memory,
    and either string returns them."""
    skeleton = {}

    def probe(what):
        import os

        from ray_tpu_torch.ops import flash_attention as fa

        if what == "reset":
            for counts in (fa.launches, fa.launches_f32):
                counts.update(dict.fromkeys(counts, 0))
            torch.cuda.reset_peak_memory_stats()
        return {"launches": dict(fa.launches), "f32": dict(fa.launches_f32), "pid": os.getpid(),
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "cards": torch.cuda.device_count()}

    def blocks(params, x, lo, hi):
        from ray_tpu_torch.models import gpt2

        if "block" not in skeleton:
            skeleton["block"] = gpt2.Block(cfg, "meta")
        for i in range(lo, hi):
            pre = f"blocks.{i}."
            own = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
            x = torch.func.functional_call(skeleton["block"], own, (x, cfg))
        return x

    def stage0(params, tokens):
        if isinstance(tokens, str):
            return probe(tokens)
        tokens = tokens[:, :-1].long()
        dt = cfg.dtype
        x = (F.embedding(tokens, params["wte"]).to(dt)
             + params["wpe"][:tokens.shape[1]].to(dt)[None])
        return blocks(params, x, 0, split)

    def stage1(params, x):
        if isinstance(x, str):
            return probe(x)
        x = blocks(params, x, split, cfg.n_layer)
        h = F.layer_norm(x.float(), (x.shape[-1],), params["ln_f.scale"].float(),
                         params["ln_f.bias"].float(), 1e-5).to(x.dtype)
        return (h, params["head"]) if torch.is_grad_enabled() else h

    def loss(pred, targets):
        from ray_tpu_torch.models import gpt2

        h, head = pred
        return gpt2.head_loss(h, head.to(cfg.dtype), targets.long(), cfg)

    return stage0, stage1, loss


def split_stage_params(named: dict, split: int) -> list:
    """GPT2.named_parameters' arrays as the two stages' dicts; the head
    starts as a copy of wte (the tied embedding held twice)."""
    s0 = {k: v for k, v in named.items() if k in ("wte", "wpe")
          or (k.startswith("blocks.") and int(k.split(".")[1]) < split)}
    s1 = {k: v for k, v in named.items() if k not in s0}
    s1["head"] = named["wte"]
    return [s0, s1]


def microbatches(tokens: np.ndarray) -> tuple:
    mbs = np.split(tokens, PP_MB)
    return mbs, [mb[:, 1:] for mb in mbs]


def stage_probe(pipe, what: str) -> list:
    import ray_tpu_torch

    return ray_tpu_torch.get([s.predict.remote(what) for s in pipe.stages], timeout=120)


def stage_slices(addresses: list) -> list:
    """Each stage's pipeline slices from its worker's event ring (emitted by
    _stage_exec_loop), cleared as they are read."""
    from ray_tpu_torch.core import worker as worker_mod

    w = worker_mod.global_worker()
    return [w.workers.get(a).call("get_task_events", types=["pipeline"], clear=True,
                                  timeout_s=30.0)["events"] for a in addresses]


def busy_and_bubble(events: list) -> tuple:
    """(median busy ms a step, median bubble fraction) over the timed steps
    (the loop's step 0 is the warm-up)."""
    steps = [e for e in events if e["kind"] == "step" and e["step"] >= 1]
    busy = [sum(e["dur_us"] for e in events if e["kind"] in ("fwd", "bwd")
                and e["step"] == s["step"]) / 1e3 for s in steps]
    if len(steps) != PP_TIMED:
        fail(f"the stage loop emitted {len(steps)} timed step slices, expected {PP_TIMED}")
    return statistics.median(busy), statistics.median(e["bubble_frac"] for e in steps)


def channel_paths(compiled) -> list:
    """The shm channel segments a compiled graph or pipeline created (the
    driver creates and unlinks every one of them)."""
    chans = getattr(compiled, "_shm_channels", None)
    if chans is None:
        chans = compiled._input_channels + compiled._output_channels + compiled._edge_channels
    return [ch.path for ch in chans]


def run_tier(pipe, tier: str, schedule: str, batches: list, lr: float,
             channels: list) -> tuple:
    """A step on each of ``batches`` under one tier: (losses, step seconds,
    each stage's slices or None for the RPC tier). The compiled tier is
    compiled first and torn down after; its channel paths go to
    ``channels``."""
    import ray_tpu_torch

    times, losses = [], []
    if tier == "rpc":
        for tokens in batches:
            t0 = time.perf_counter()
            losses.append(pipe.train_step(*microbatches(tokens), lr=lr))
            times.append(time.perf_counter() - t0)
        return losses, times, None
    addresses = [i["address"] for i in ray_tpu_torch.get(
        [s.transport_info.remote() for s in pipe.stages], timeout=60)]
    stage_slices(addresses)  # drop what earlier loops left
    cp = pipe.compile(schedule=schedule, channel_capacity=PP_CAPACITY,
                      step_timeout_s=PP_STEP_TIMEOUT_S)
    channels.extend(channel_paths(cp))
    try:
        for tokens in batches:
            t0 = time.perf_counter()
            losses.append(cp.train_step(*microbatches(tokens), lr=lr))
            times.append(time.perf_counter() - t0)
    finally:
        cp.teardown()
    return losses, times, stage_slices(addresses)


def sgd_step(stage_fns: tuple, init: list, tier: str, schedule: str, tokens: np.ndarray,
             channels: list, stage_gpus: float):
    """One SGD step of a fresh pipeline from ``init``, each stage asking for
    ``stage_gpus`` of a card: (loss, parameters of each stage after it, the
    pipeline, still up)."""
    from ray_tpu_torch.parallel.pipeline import Pipeline

    stage0, stage1, loss_fn = stage_fns
    pipe = Pipeline([stage0, stage1], init, loss_fn,
                    resources=[{"num_gpus": stage_gpus}] * 2)
    (loss,), _, _ = run_tier(pipe, tier, schedule, [tokens], PP_SGD_LR, channels)
    return loss, pipe.get_params(), pipe


def hop_and_ping(card: str, channels: list, gpus: float) -> float:
    """One 12 MiB activation from one process's card to another's, as a
    stage ships it (HostTensor off the card, a compiled graph's channel,
    onto the card), each process with ``gpus`` of a card, and test_dag's
    per-call ratio of the RPC path to the compiled path. The graphs'
    channel paths go to ``channels``. Returns the hop's median ms."""
    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote(num_gpus=gpus)
    class Hop:
        def __init__(self):
            self.x = torch.randn(8, 1024, 768, device="cuda").to(torch.bfloat16)

        def ping(self, i):
            return i + 1

        def send(self, i):
            from ray_tpu_torch.parallel.pipeline import HostTensor

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = HostTensor.of(self.x)
            return t0, time.perf_counter(), h

        def recv(self, msg):
            t0, t1, h = msg
            t2 = time.perf_counter()
            y = h.to("cuda")
            torch.cuda.synchronize()
            return t0, t1, t2, time.perf_counter(), y.numel() * y.element_size()

    a, b = Hop.remote(), Hop.remote()
    try:
        ray_tpu_torch.get([a.ping.remote(0), b.ping.remote(0)], timeout=120)
        t0 = time.perf_counter()
        for i in range(PP_PINGS):
            ray_tpu_torch.get(a.ping.remote(i))
        rpc_s = (time.perf_counter() - t0) / PP_PINGS
        with InputNode() as inp:
            ping = a.ping.bind(inp)
        cdag = ping.experimental_compile()
        channels.extend(channel_paths(cdag))
        try:
            cdag.execute(0).get()
            t0 = time.perf_counter()
            for i in range(PP_PINGS):
                cdag.execute(i).get()
            compiled_s = (time.perf_counter() - t0) / PP_PINGS
        finally:
            cdag.teardown()
        print(f"compiled graph vs RPC path, one actor call ({PP_PINGS} calls each, as "
              f"test_dag.py::test_compiled_path_beats_rpc_path): compiled {compiled_s * 1e6:.1f} us, "
              f"rpc {rpc_s * 1e6:.1f} us, ratio {rpc_s / compiled_s:.2f}x [{card}]", flush=True)

        with InputNode() as inp:
            hop = b.recv.bind(a.send.bind(inp))
        cdag = hop.experimental_compile(channel_capacity=PP_CAPACITY)
        channels.extend(channel_paths(cdag))
        try:
            rounds = [cdag.execute(i).get(timeout_s=120) for i in range(PP_HOPS)][2:]
        finally:
            cdag.teardown()
    finally:
        for actor in (a, b):
            ray_tpu_torch.kill(actor)
    nbytes = rounds[0][4]
    med = {name: statistics.median((r[j + 1] - r[j]) * 1e3 for r in rounds)
           for j, name in enumerate(("off the card", "the channel", "onto the card"))}
    total = statistics.median((r[3] - r[0]) * 1e3 for r in rounds)
    print(f"one activation ({nbytes} bytes, bf16 [8, 1024, 768]) from stage to stage "
          f"({gpus} of a card each), median of {len(rounds)}: {total:.3f} ms = "
          + ", ".join(f"{name} {ms:.3f}" for name, ms in med.items())
          + f" (the channel: pickle-5 into a {PP_CAPACITY >> 20} MiB shm slot, the exec loops' "
          f"handoff, the copy out and unpickle) [{card}]", flush=True)
    return total


def pipeline_parallel(card: str, phase3_step_ms: float, stage_gpus: float = PP_STAGE_GPUS,
                      summary: dict = None) -> dict:
    """Phase 8: each stage asks for ``stage_gpus`` of a card (two halves of
    this card; 1, a card each, from placed_cards.py). Returns
    each kernel's launches a step in each stage process (compiled, 1F1B);
    ``summary``, when given, gets each tier's step ms, the stages' bubbles
    and the hop's ms."""
    import functools

    import ray_tpu_torch
    from ray_tpu_torch import bench
    from ray_tpu_torch.core import worker as worker_mod
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.parallel.pipeline import Pipeline

    torch.cuda.empty_cache()  # phase 3-7's cached blocks: the stage processes share the card
    B, T = bench.BATCH, bench.SEQ
    cfg = bench.config()
    batches = [bench.batch_tokens(i, cfg.vocab_size, B, T) for i in range(PP_TIMED + 1)]
    mbs, targets = microbatches(batches[0])

    # the unsharded reference: phase 3's init, the mean loss and gradient
    # over batch 0's four microbatches
    ref = bench.setup(0).model
    ref_losses = []
    for mb in mbs:
        loss = ref.loss(torch.from_numpy(mb).cuda())
        (loss / PP_MB).backward()
        ref_losses.append(loss.item())
    ref_loss = sum(ref_losses) / PP_MB
    ref_grads = {n: p.grad.detach().cpu() for n, p in ref.named_parameters()}
    named = {n: p.detach().to("cpu", copy=True).numpy() for n, p in ref.named_parameters()}
    init = split_stage_params(named, PP_SPLIT)
    ref.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    fns = pipeline_stage_fns(cfg, PP_SPLIT)
    channels = []  # every shm channel segment this phase creates

    ray_tpu_torch.init(num_cpus=4, object_store_memory_mb=4096)
    session = worker_mod.global_worker().session_id
    try:
        # (a) parity, and (e) a compiled graph of inference on those stages
        t0 = time.perf_counter()
        loss_a, params_a, pipe = sgd_step(fns, init, "rpc", "gpipe", batches[0], channels,
                                          stage_gpus)
        try:
            print(f"pipeline: two stages started and one SGD step (RPC, GPipe) in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            with InputNode() as inp:
                dag = pipe.stages[1].predict.bind(pipe.stages[0].predict.bind(inp))
            cdag = dag.experimental_compile(channel_capacity=PP_CAPACITY)
            channels.extend(channel_paths(cdag))
            try:
                rows = batches[0][:B // PP_MB]
                out = cdag.execute(rows).get(timeout_s=PP_STEP_TIMEOUT_S).to("cuda")
            finally:
                cdag.teardown()
        finally:
            pipe.shutdown()
        after = {**params_a[0], **params_a[1]}
        got = {n: (named[n] - p) / PP_SGD_LR for n, p in after.items() if n != "head"}
        got["wte"] = got["wte"] + (named["wte"] - after["head"]) / PP_SGD_LR
        rel = bench.relnorms({n: torch.from_numpy(g) for n, g in got.items()}, ref_grads)
        worst = max(rel.items(), key=lambda kv: kv[1])
        print(f"pipeline step 0 (4 microbatches of {B // PP_MB}, RPC, GPipe, SGD lr {PP_SGD_LR}): "
              f"loss {loss_a:.6f} vs unsharded {ref_loss:.6f} (gap {abs(loss_a - ref_loss):.3e}, "
              f"limit {LOSS_REF_TOL}); gradients as (p - p')/lr, the two wte copies summed, vs "
              f"the unsharded model's over {len(rel)} leaves: max relnorm {worst[1]:.3e} "
              f"({worst[0]}), median {statistics.median(rel.values()):.3e} (limit "
              f"{GRAD_RELNORM_TOL}) [{card}]", flush=True)
        if not abs(loss_a - ref_loss) <= LOSS_REF_TOL:
            fail(f"pipeline step-0 loss {loss_a} vs unsharded {ref_loss}")
        bad = [n for n, r in rel.items() if not r <= GRAD_RELNORM_TOL]
        if bad:
            fail(f"pipeline gradients of {bad} disagree with the unsharded model's")
        for n, p in after.items():  # (e): the stages' parameters in the unsharded model
            if n != "head":
                ref.get_parameter(n).data.copy_(torch.from_numpy(p))
        with torch.no_grad():
            want = ref.backbone(torch.from_numpy(rows[:, :-1]).cuda().long())
        gap = bench.disagreement(out, want)
        print(f"compiled graph of inference (InputNode -> stage0.predict -> stage1.predict) on "
              f"{rows.shape[0]} rows vs the unsharded backbone: {list(out.shape)} {out.dtype}, "
              f"bitwise equal {torch.equal(out, want)}, max abs {gap['max_abs']:.3e}, "
              f"relnorm {gap['relnorm']:.3e} ({_rule()}) [{card}]", flush=True)
        if not (gap["ok"] and out.shape == want.shape and out.dtype == want.dtype):
            fail(f"the compiled inference graph disagrees with the backbone: {gap}")
        del ref, ref_grads, out, want
        torch.cuda.empty_cache()

        # (b) bitwise: compiled == RPC, 1F1B == GPipe
        runs = {("rpc", "gpipe"): (loss_a, params_a)}
        for schedule in ("gpipe", "1f1b"):
            loss, params, pipe = sgd_step(fns, init, "compiled", schedule, batches[0], channels,
                                          stage_gpus)
            pipe.shutdown()
            runs["compiled", schedule] = (loss, params)
        for (tier, schedule), (loss, params) in runs.items():
            same = loss == loss_a and all(
                a.keys() == b.keys() and all(np.array_equal(a[n], b[n]) for n in a)
                for a, b in zip(params, params_a))
            print(f"pipeline {tier}/{schedule}: step-0 loss {loss!r}, loss and every parameter "
                  f"after the step bitwise equal to rpc/gpipe: {same}", flush=True)
            if not same:
                fail(f"pipeline {tier}/{schedule} is not bitwise equal to rpc/gpipe")

        # (c), (d): AdamW, a warm-up step and PP_TIMED timed steps per tier
        adamw = functools.partial(torch.optim.AdamW, lr=3e-4, weight_decay=0.01,
                                  betas=(0.9, 0.999), eps=1e-8)
        pipe = Pipeline(list(fns[:2]), init, fns[2], optimizer=adamw,
                        resources=[{"num_gpus": stage_gpus}] * 2)
        per_step, tier_ms, first_loss, bubbles = {}, {}, {}, {}
        try:
            for tier, schedule in PP_TIERS:
                stage_probe(pipe, "reset")
                # AdamW's lr is the factory's: apply ignores its own
                losses, times, slices = run_tier(pipe, tier, schedule, batches, 0.0, channels)
                probes = stage_probe(pipe, "launches")
                name = f"{tier}/{schedule}"
                step_ms = statistics.median(times[1:]) * 1e3
                tier_ms[name], first_loss[name] = step_ms, losses[0]
                stages = []
                for i, pr in enumerate(probes):
                    n = {k: v / len(batches) for k, v in pr["launches"].items()}
                    per_step[name, i] = n
                    if slices:
                        bubbles[name, i] = busy_and_bubble(slices[i])
                    busy = (" busy %.2f ms a step, bubble %.3f," % bubbles[name, i]
                            if slices else " busy and bubble not measured (no stage loop),")
                    stages.append(f"stage {i} (pid {pr['pid']}, CUDA_VISIBLE_DEVICES "
                                  f"{pr['visible']}, {pr['cards']} card seen):{busy} peak memory "
                                  f"{pr['peak_gib']:.2f} GiB, launches a step {n}")
                    if any(pr["f32"].values()):
                        fail(f"stage {i} launched f32 instances: {pr['f32']}")
                seen = [pr["visible"] for pr in probes]
                if any(pr["cards"] != 1 for pr in probes) or (len(set(seen)) == 1) != (
                        stage_gpus < 1):
                    fail(f"stages of {stage_gpus} card each saw {seen} "
                         f"({[pr['cards'] for pr in probes]} cards)")
                print(f"pipeline {name} (AdamW, {PP_MB} microbatches of {B // PP_MB}): median "
                      f"step {step_ms:.2f} ms over {PP_TIMED} steps ("
                      + ", ".join(f"{t * 1e3:.2f}" for t in times[1:])
                      + f"; warm-up {times[0] * 1e3:.2f}), {B * T / step_ms * 1e3:.1f} tokens/s; "
                      f"losses {', '.join(f'{x:.5f}' for x in losses)}; phase 3's unpipelined "
                      f"step {phase3_step_ms:.2f} ms, {B * T / phase3_step_ms * 1e3:.1f} tokens/s; "
                      + ("both stages time-slice the one card (no MPS)" if stage_gpus < 1
                         else "a card each") + f" [{card}]", flush=True)
                print("  " + "; ".join(stages), flush=True)
        finally:
            pipe.shutdown()
        print(f"pipeline step ratio RPC / compiled (GPipe): "
              f"{tier_ms['rpc/gpipe'] / tier_ms['compiled/gpipe']:.3f}x; 1F1B / GPipe (compiled): "
              f"{tier_ms['compiled/1f1b'] / tier_ms['compiled/gpipe']:.3f}x", flush=True)
        want = {name: PP_MB * PP_SPLIT for name in KERNELS}
        bad = {k: n for k, n in per_step.items() if n != want}
        if bad:
            fail(f"stage launches a step {bad}; the design says {want} in each stage")
        # the same batch 0, 12 AdamW steps apart
        if not first_loss["compiled/1f1b"] < first_loss["rpc/gpipe"]:
            fail(f"AdamW did not lower batch 0's loss: {first_loss}")
        hop_ms = hop_and_ping(card, channels, stage_gpus)
        if summary is not None:
            summary.update(step_ms=tier_ms, bubble={f"{k[0]} stage {k[1]}": v[1]
                                                    for k, v in bubbles.items()},
                           hop_ms=hop_ms)
    finally:
        ray_tpu_torch.shutdown()

    # (f) nothing left behind
    deadline = time.monotonic() + 30
    while True:
        pids, files = session_leftovers(session)
        chans = [c for c in channels if os.path.exists(c)]
        if not (pids or files or chans) or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    print(f"after teardown() and shutdown(): {len(pids)} stage or worker processes of the session "
          f"alive, {len(files)} of its shm and spill paths and {len(chans)} channel segments "
          f"left of the {len(channels)} it created", flush=True)
    if pids or files or chans:
        fail(f"the pipeline left processes {pids}, files {files}, channels {chans}")
    if not channels:
        fail("the pipeline phase recorded no shm channel: the channel check saw nothing")
    return {name: {f"stage{i}": per_step["compiled/1f1b", i][name] for i in range(2)}
            for name in KERNELS}


# ---------------------------------------------------------------------------
# Phase 9: the Train library. GPT-2-medium trained by TorchTrainer in a train
# worker, checkpointed, crashed and resumed; data-parallel gradient sync of
# gpt2-small over the host collectives between two actors on the card
# ---------------------------------------------------------------------------

TRAIN_MODEL = "gpt2-medium"  # BASELINE.md config 3, at full width and depth (d 1024, 24 layers)
TRAIN_STEPS = 6
TRAIN_CKPT_STEP = 2   # the checkpoint is written after step 2: the state steps 0-2 leave
TRAIN_CRASH_STEP = 3  # the first attempt exits after step 3, before its report
# Steps 3-5 of the resumed run against the oracle's, relative: the mesh of
# one is the unsharded step (phase 6), and the checkpoint restores the
# model and AdamW's state bit for bit.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_NS = "chip_smoke_train"  # the train worker's per-step records in the control store KV
SYNC_MODEL = "gpt2-small"  # phase 3's init and batch 0, its 32 rows split over the ranks
SYNC_RANKS = 2
SYNC_GPUS = 0.5  # each sync rank's share of the one card
# Each rank's half-batch gradients, averaged by grad_sync, against the
# full-batch gradients: each reduced leaf within this relative norm. The
# two round bf16 products over 16 and 32 rows differently; the gap
# measured on an H100 (NVIDIA H100 80GB HBM3, 700 W): max 2.476e-3, median
# 2.309e-3.
SYNC_GRAD_RELNORM_TOL = 1e-2


def _timed(fn) -> tuple:
    """(fn(), its ms by CUDA events around it)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _wall(fn) -> tuple:
    """(fn(), its ms on the host clock, the card's queue drained on both sides):
    for work that is mostly the host's (a checkpoint's write or load)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def train_oracle(card: str) -> tuple:
    """Phase 9a, in this process: bench.setup(6, model=gpt2-medium) (B 32, T
    1024, flash, fused CE, AdamW, seed 0, bench.batch_tokens) and its 6 steps.
    Returns (losses, step ms by CUDA events, peak GiB); frees the card after."""
    import gc

    from ray_tpu_torch import bench

    gc.collect()
    torch.cuda.empty_cache()  # what phases 1-8 left cached
    run = bench.setup(TRAIN_STEPS, model=TRAIN_MODEL)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for tokens in run.batches:
        loss, t = _timed(lambda: run.step(tokens))
        losses.append(loss.item())
        ms.append(t)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train oracle ({TRAIN_MODEL}, B={bench.BATCH}, T={bench.SEQ}, unsharded, this process): "
          f"losses {', '.join(f'{x:.6f}' for x in losses)}; step ms "
          f"{', '.join(f'{t:.2f}' for t in ms)}, median of steps 1-{TRAIN_STEPS - 1} "
          f"{statistics.median(ms[1:]):.2f}; peak memory {peak:.2f} GiB [{card}]", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"the {TRAIN_MODEL} oracle's losses are not finite: {losses}")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return losses, ms, peak


def medium_train_fn(config: dict) -> None:
    """Phase 9b's train function, run by TorchTrainer in a train worker (on
    the card, in the worker's NCCL process group of one). It builds the
    oracle's model with bench.setup, placed on a mesh of one (build_mesh,
    shard_model with gpt_rules), takes the same steps, reports each step's
    loss and launch counts, writes a checkpoint after TRAIN_CKPT_STEP (the
    model's and AdamW's full state dicts, torch.save into the rank
    directory), and on the first attempt exits after TRAIN_CRASH_STEP. Each
    step's record also goes into the control store KV: the reports of a
    crashed attempt are lost with it. ``config["staging"]``: where the
    checkpoint is written before report() copies it into the run."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        get_model_state_dict,
        get_optimizer_state_dict,
        set_model_state_dict,
        set_optimizer_state_dict,
    )

    import ray_tpu_torch.train as train
    from ray_tpu_torch import bench
    from ray_tpu_torch.collective import process_group
    from ray_tpu_torch.core import worker as worker_mod
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import MeshConfig, build_mesh, shard_model
    from ray_tpu_torch.parallel.sharding import gpt_rules

    ctx = train.get_context()
    control = worker_mod.global_worker().control

    def record(key: str, rec: dict) -> None:
        control.call("kv_put", ns=TRAIN_NS, key=key, value=json.dumps(rec).encode(),
                     retryable=True)

    mesh = build_mesh(MeshConfig(dp=1), device_type="cuda")
    run = bench.setup(TRAIN_STEPS, model=TRAIN_MODEL,
                      place=lambda m: shard_model(m, mesh, gpt_rules()))
    full = StateDictOptions(full_state_dict=True, cpu_offload=True)
    restore = ctx.get_checkpoint()
    attempt, start = (1 if restore is not None else 0), 0
    base = {"attempt": attempt, "pid": os.getpid(), "pg_backend": dist.get_backend(),
            "pg_world": dist.get_world_size(), "pg_init_ms": process_group.last_init_s * 1e3,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
    if restore is not None:
        path = os.path.join(restore.rank_dir(ctx.get_world_rank()), "state.pt")

        def load():
            state = torch.load(path, map_location="cpu", weights_only=True)
            set_model_state_dict(run.model, state["model"], options=full)
            set_optimizer_state_dict(run.model, run.optimizer, state["optimizer"], options=full)
            return state["step"]

        start, base["restore_ms"] = _wall(load)
        base["restored_from"] = os.path.basename(restore.path)
    torch.cuda.reset_peak_memory_stats()
    for step in range(start, TRAIN_STEPS):
        for counts in (fa.launches, fa.launches_f32):
            counts.update(dict.fromkeys(counts, 0))
        loss, ms = _timed(lambda: run.step(run.batches[step]))
        rec = dict(base, step=step, start=start, loss=loss.item(), ms=ms, wall=time.time(),
                   launches=dict(fa.launches), launches_f32=dict(fa.launches_f32),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        if (step == TRAIN_CRASH_STEP and attempt == 0
                and control.call("kv_put", ns=TRAIN_NS, key="crash", value=b"1",
                                 overwrite=False)):
            rec["crash_wall"] = time.time()
            record(f"{attempt}/{step}", rec)
            os._exit(1)
        ckpt = None
        if step == TRAIN_CKPT_STEP:
            staging = tempfile.mkdtemp(dir=config["staging"])
            target = os.path.join(staging, "state.pt")

            def save():
                torch.save({"model": get_model_state_dict(run.model, options=full),
                            "optimizer": get_optimizer_state_dict(run.model, run.optimizer,
                                                                  options=full),
                            "step": step + 1}, target)

            _, rec["ckpt_write_ms"] = _wall(save)
            rec["ckpt_bytes"] = os.path.getsize(target)
            ckpt = train.Checkpoint.from_directory(staging)
        t0 = time.perf_counter()
        train.report({"step": step, "loss": rec["loss"], "launches": rec["launches"],
                      "attempt": attempt}, checkpoint=ckpt)
        rec["report_ms"] = (time.perf_counter() - t0) * 1e3
        if ckpt is not None:
            shutil.rmtree(staging)
        record(f"{attempt}/{step}", rec)


def _read_records(control) -> dict:
    out = {}
    for attempt in (0, 1):
        for step in range(TRAIN_STEPS):
            val = control.call("kv_get", ns=TRAIN_NS, key=f"{attempt}/{step}")
            if val is not None:
                out[attempt, step] = json.loads(val)
    return out


def check_train_records(card: str, recs: dict, oracle: tuple, cfg) -> dict:
    """Phase 9b's checks on the train worker's per-step records: where each
    attempt started and stopped, the losses against the oracle's, the
    launches; prints the times. Returns each kernel's launches a step, the
    median over both attempts' steps."""
    want_losses, want_ms, want_peak = oracle
    first = [s for (a, s) in recs if a == 0]
    second = [s for (a, s) in recs if a == 1]
    if first != list(range(TRAIN_CRASH_STEP + 1)) or "crash_wall" not in recs[0, TRAIN_CRASH_STEP]:
        fail(f"the first attempt ran steps {first}; expected 0-{TRAIN_CRASH_STEP}, then the crash")
    if second != list(range(TRAIN_CKPT_STEP + 1, TRAIN_STEPS)):
        fail(f"the retry ran steps {second}; it should resume at {TRAIN_CKPT_STEP + 1} from the "
             "checkpoint, not at 0")
    resumed = recs[1, TRAIN_CKPT_STEP + 1]
    print(f"train worker: attempt 0 (pid {recs[0, 0]['pid']}) ran steps {first} and exited after "
          f"step {TRAIN_CRASH_STEP}; attempt 1 (pid {resumed['pid']}) restored "
          f"{resumed.get('restored_from')} and ran steps {second}; process group "
          f"{resumed['pg_backend']} of {resumed['pg_world']}, mesh {resumed['mesh']}", flush=True)
    for (a, s), r in sorted(recs.items()):
        if r["pg_backend"] != "nccl" or r["pg_world"] != 1:
            fail(f"attempt {a} ran on a {r['pg_backend']} group of {r['pg_world']}")
    got = [recs[1, s]["loss"] for s in second]
    want = want_losses[second[0]:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    early = [recs[0, s]["loss"] for s in first]
    print(f"train worker losses: attempt 0 steps 0-{TRAIN_CRASH_STEP} "
          f"{', '.join(f'{x:.6f}' for x in early)} (bitwise equal to the oracle's: "
          f"{early == want_losses[:len(early)]}); resumed steps {second[0]}-{second[-1]} "
          f"{', '.join(f'{x:.6f}' for x in got)} vs the oracle's "
          f"{', '.join(f'{x:.6f}' for x in want)}: bitwise equal {got == want}, largest relative "
          f"gap {rel:.3e} (limit {TRAIN_LOSS_RTOL})", flush=True)
    if not rel <= TRAIN_LOSS_RTOL:
        fail(f"the resumed losses {got} disagree with the oracle's {want}")
    design = design_launches(cfg, remat=False)
    bad = {k: (r["launches"], r["launches_f32"]) for k, r in recs.items()
           if r["launches"] != design or any(r["launches_f32"].values())}
    if bad:
        fail(f"train worker launches {bad}; the design says {design} a step, no f32 instance")
    warm = [r["ms"] for (a, s), r in sorted(recs.items())
            if s != (0 if a == 0 else TRAIN_CKPT_STEP + 1)]
    ckpt = recs[0, TRAIN_CKPT_STEP]
    crash_s = resumed["wall"] - recs[0, TRAIN_CRASH_STEP]["crash_wall"]
    peak = max(r["peak_gib"] for r in recs.values())
    print(f"train worker step (CUDA events, the steps after each attempt's first): median "
          f"{statistics.median(warm):.2f} ms ({', '.join(f'{t:.2f}' for t in warm)}); first steps "
          f"{recs[0, 0]['ms']:.2f} and {resumed['ms']:.2f} ms; the oracle's median "
          f"{statistics.median(want_ms[1:]):.2f} ms; process group init "
          f"{recs[0, 0]['pg_init_ms']:.1f} and {resumed['pg_init_ms']:.1f} ms (the whole join: "
          f"the card's selection, rendezvous, init_process_group and the first barrier, which "
          f"builds NCCL's communicator) [{card}]",
          flush=True)
    print(f"checkpoint after step {TRAIN_CKPT_STEP}: {ckpt['ckpt_bytes']} bytes (model and AdamW, "
          f"full state dicts offloaded to the host), written in {ckpt['ckpt_write_ms']:.0f} ms, "
          f"copied into checkpoint_*/rank_0 by report() in {ckpt['report_ms']:.0f} ms; restore "
          f"(torch.load, set_model_state_dict, set_optimizer_state_dict) "
          f"{resumed['restore_ms']:.0f} ms; crash to the end of the first resumed step "
          f"{crash_s:.2f} s; worker peak memory {peak:.2f} GiB (the oracle's {want_peak:.2f} GiB) "
          f"[{card}]", flush=True)
    return {name: statistics.median(r["launches"][name] for r in recs.values()) for name in KERNELS}


def train_library(card: str, oracle: tuple) -> dict:
    """Phase 9b and 9c. ``oracle``: phase 9a's (losses, step ms, peak GiB).
    Returns each kernel's launches a step in the train worker and a
    grad_sync rank."""
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import bench
    from ray_tpu_torch.core import worker as worker_mod
    from ray_tpu_torch.train import FailureConfig, RunConfig, ScalingConfig, TorchTrainer

    cfg = bench.config(TRAIN_MODEL)
    base = tempfile.mkdtemp(prefix="chip_smoke_train_")  # under TMPDIR; removed below
    staging = os.path.join(base, "staging")
    os.makedirs(staging)
    free_gb = shutil.disk_usage(base).free / 1e9
    ray_tpu_torch.init(num_cpus=4, object_store_memory_mb=4096)
    session = worker_mod.global_worker().session_id
    try:
        control = worker_mod.global_worker().control
        trainer = TorchTrainer(
            medium_train_fn,
            train_loop_config={"staging": staging},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="gpt2_medium", storage_path=base,
                                 failure_config=FailureConfig(max_failures=1)),
        )
        t0 = time.perf_counter()
        result = trainer.fit()
        fit_s = time.perf_counter() - t0
        if result.error is not None:
            fail(f"TorchTrainer.fit() returned an error: {result.error}")
        print(f"TorchTrainer ({TRAIN_MODEL}, B={bench.BATCH}, T={bench.SEQ}, ScalingConfig("
              f"num_workers=1, use_gpu=True), FailureConfig(max_failures=1)): fit() {fit_s:.1f} s, "
              f"metrics {result.metrics}; run directory under TMPDIR ({free_gb:.0f} GB free there)",
              flush=True)
        if result.metrics is None or result.metrics.get("step") != TRAIN_STEPS - 1:
            fail(f"the trainer's last metrics are {result.metrics}, expected step {TRAIN_STEPS - 1}")
        per_step = check_train_records(card, _read_records(control), oracle, cfg)
        per_rank = grad_sync_two_ranks(card)
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(base, ignore_errors=True)

    # nothing left behind: the train worker, the controller, the sync ranks
    deadline = time.monotonic() + 30
    while True:
        pids, files = session_leftovers(session)
        if not (pids or files) or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    print(f"after shutdown(): {len(pids)} train worker, controller or actor processes of the "
          f"session alive, {len(files)} of its shm and spill paths left; run directory removed: "
          f"{not os.path.exists(base)}", flush=True)
    if pids or files:
        fail(f"the Train library's session left processes {pids} and files {files}")
    return {name: {"train_worker": per_step[name], "grad_sync_rank": per_rank[name]}
            for name in KERNELS}


class _SyncRank:
    """Phase 9c's actor: one rank of a host-collective group, with its own
    CUDA context on the card. Wrapped by ray_tpu_torch.remote in the phase."""

    def __init__(self, rank: int, world: int, group: str):
        self.rank, self.world, self.group = rank, world, group

    def setup(self) -> bool:
        from ray_tpu_torch import collective

        collective.init_collective_group(self.world, self.rank, backend="cpu",
                                         group_name=self.group)
        return True

    def step(self) -> dict:
        """Forward and backward of phase 3's init on this rank's rows of
        batch 0, then grad_sync(grads).join(): bucketed, on the p2p ring, the
        default buckets, averaged."""
        from ray_tpu_torch import bench, collective
        from ray_tpu_torch.collective import p2p
        from ray_tpu_torch.ops import flash_attention as fa

        run = bench.setup(1, model=SYNC_MODEL)
        rows = run.batches[0].shape[0] // self.world
        tokens = run.batches[0][self.rank * rows:(self.rank + 1) * rows]
        for counts in (fa.launches, fa.launches_f32):
            counts.update(dict.fromkeys(counts, 0))
        loss = run.model.loss(tokens)
        loss.backward()
        torch.cuda.synchronize()
        launches, launches_f32 = dict(fa.launches), dict(fa.launches_f32)
        grads = {n: p.grad for n, p in run.model.named_parameters()}
        collective.barrier(self.group)  # both ranks start the sync together
        before = p2p.snapshot_stats()
        t0 = time.perf_counter()
        handle = collective.grad_sync(grads, group_name=self.group)
        out = handle.join()
        wall_ms = (time.perf_counter() - t0) * 1e3
        after = p2p.snapshot_stats()
        return {"rank": self.rank, "pid": os.getpid(), "rows": rows, "loss": loss.item(),
                "grads": out, "wall_ms": wall_ms, "stats": dict(handle.stats),
                "wire": {k: after[k] - before[k] for k in after},
                "launches": launches, "launches_f32": launches_f32,
                "grad_bytes": sum(g.numel() * g.element_size() for g in grads.values())}


def grad_sync_two_ranks(card: str) -> dict:
    """Phase 9c (inside phase 9's cluster). Returns each kernel's launches
    on a rank, the median over the ranks."""
    import gc

    import ray_tpu_torch
    from ray_tpu_torch import bench

    cfg = bench.config(SYNC_MODEL)
    run = bench.setup(1, model=SYNC_MODEL)  # the full batch (B 32) in this process
    run.model.loss(run.batches[0]).backward()
    ref = {n: p.grad.detach().cpu() for n, p in run.model.named_parameters()}
    del run
    gc.collect()
    torch.cuda.empty_cache()
    Rank = ray_tpu_torch.remote(num_gpus=SYNC_GPUS)(_SyncRank)
    ranks = [Rank.remote(r, SYNC_RANKS, "chip_smoke_sync") for r in range(SYNC_RANKS)]
    try:
        ray_tpu_torch.get([r.setup.remote() for r in ranks], timeout=120)
        outs = ray_tpu_torch.get([r.step.remote() for r in ranks], timeout=600)
    finally:
        for r in ranks:
            ray_tpu_torch.kill(r)
    a, b = outs[0]["grads"], outs[1]["grads"]
    same = a.keys() == b.keys() == ref.keys() and all(np.array_equal(a[n], b[n]) for n in a)
    rel = bench.relnorms({n: torch.tensor(g) for n, g in a.items()}, ref)
    worst = max(rel.items(), key=lambda kv: kv[1])
    print(f"grad_sync ({SYNC_MODEL}, {SYNC_RANKS} actors on this card, {outs[0]['rows']} rows of "
          f"batch 0 each, host collectives: bucketed, p2p ring, default buckets): the ranks' "
          f"reduced leaves bitwise equal {same}; against the full batch's (B {SYNC_RANKS * outs[0]['rows']}) "
          f"gradients over {len(rel)} leaves: max relnorm {worst[1]:.3e} ({worst[0]}), median "
          f"{statistics.median(rel.values()):.3e} (limit {SYNC_GRAD_RELNORM_TOL}); losses "
          f"{outs[0]['loss']:.6f}, {outs[1]['loss']:.6f} [{card}]", flush=True)
    for o in outs:
        print(f"  rank {o['rank']} (pid {o['pid']}): grad_sync of {o['grad_bytes']} bytes of f32 "
              f"gradients: {o['wall_ms']:.1f} ms wall (copy to the host, bucketing, the ring, "
              f"unpacking); {o['stats'].get('buckets')} buckets, {o['wire']['bytes_sent']} bytes "
              f"sent and {o['wire']['bytes_recv']} received on the wire (p2p counters), hidden "
              f"fraction {o['stats'].get('hidden_frac', float('nan')):.3f}; launches "
              f"{o['launches']} [{card}]", flush=True)
    if not same:
        fail("the two ranks' reduced gradients differ")
    bad = [n for n, r in rel.items() if not r <= SYNC_GRAD_RELNORM_TOL]
    if bad:
        fail(f"reduced gradients of {bad} disagree with the full batch's")
    design = design_launches(cfg, remat=False)
    for o in outs:
        if o["launches"] != design or any(o["launches_f32"].values()):
            fail(f"rank {o['rank']} launched {o['launches']} (f32 {o['launches_f32']}); the "
                 f"design says {design}")
    return {name: statistics.median(o["launches"][name] for o in outs) for name in KERNELS}


# ---------------------------------------------------------------------------
# Phase 10: the serve deployment, the OpenAI front door over HTTP
# ---------------------------------------------------------------------------

FRONT_NAME = "openai-llm"  # serve.llm.deploy's default deployment name
FRONT_REPLICAS = 2
N_UNARY = 4  # greedy requests also sent unary, after the SSE burst
N_ONE_BY_ONE = 8  # greedy requests sent one at a time, to each deployment and the handle
N_PINNED = 4  # requests of one OpenAI user, which must land on one replica
FRONT_TIMEOUT_S = 300.0
FRONT_GPUS = 0.5  # each replica's share of the one card (ray_actor_options num_gpus)


def front_text(tokens: list) -> str:
    """A token list as ASCII text, one printable byte per token: the byte
    tokenizer reads it back as one token per byte, and prompts that share
    tokens share text."""
    return "".join(chr(32 + int(t) % 95) for t in tokens)


def front_traffic(vocab: int) -> list:
    """Phase 4's 24 requests as OpenAI completions (a prompt of 64-896 ASCII
    bytes, 8 sharing a 512-byte prefix, 64 tokens each, 4 at temperature
    0.8), in phase 4's order."""
    return [{"prompt": front_text(r["prompt_tokens"]), "max_tokens": r["max_new_tokens"],
             "temperature": r["temperature"]} for r in serving_traffic(vocab)]


def http_json(addr: str, path: str, body=None, timeout: float = FRONT_TIMEOUT_S) -> tuple:
    """(status, JSON body) of a POST (a GET without ``body``)."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://{addr}{path}", data=data,
                                 method="POST" if data else "GET",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def sse_post(addr: str, path: str, body: dict, headers=None,
             timeout: float = FRONT_TIMEOUT_S) -> tuple:
    """POST ``body`` with stream=true -> (status, content type, the events'
    data strings, seconds from the request to the first event)."""
    import http.client

    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=json.dumps({**body, "stream": True}),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        events, first = [], None
        while True:
            line = resp.readline()
            if not line:
                break
            if line.startswith(b"data: "):
                if first is None:
                    first = time.perf_counter() - t0
                events.append(line[len(b"data: "):].rstrip(b"\n").decode())
        return resp.status, resp.getheader("Content-Type"), events, first
    finally:
        conn.close()


def sse_completion(events: list) -> tuple:
    """(text, completion_tokens) of a streamed /v1/completions answer."""
    if not events or events[-1] != "[DONE]":
        fail(f"an SSE stream did not end with [DONE]: {events[-3:]}")
    chunks = [json.loads(e) for e in events[:-1]]
    if "error" in chunks[0]:
        fail(f"an SSE stream carried an error: {chunks[0]['error']}")
    return "".join(c["choices"][0]["text"] for c in chunks), chunks[-1]["usage"]["completion_tokens"]


def proxy_address(timeout_s: float = 60.0) -> str:
    from ray_tpu_torch import serve

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        addrs = serve.proxy_addresses()
        if addrs:
            return addrs[0]
        time.sleep(0.2)
    fail("no HTTP proxy came up")


def _worker_processes() -> dict:
    """{address: pid} of the node's worker processes (the driver's node)."""
    from ray_tpu_torch.core import worker as worker_mod

    st = worker_mod.global_worker().agent.call("get_state", timeout_s=10.0)
    return {w["address"]: w["pid"] for w in st["workers"].values()}


def serve_processes() -> dict:
    """{actor name: pid} of the serve controller, proxies and replicas."""
    from ray_tpu_torch.core import worker as worker_mod

    pids = _worker_processes()
    return {a["name"]: pids[a["worker_address"]]
            for a in worker_mod.global_worker().control.call("list_actors", timeout_s=10.0)
            if a["state"] == "ALIVE" and (a["name"] or "").startswith("SERVE_")
            and a["worker_address"] in pids}


def replica_cards(procs: dict) -> dict:
    """{replica actor name: its CUDA_VISIBLE_DEVICES} for the SERVE_REPLICA
    processes of ``procs`` (serve_processes()), read from the environment
    each was started with (the node agent sets it from the lease)."""
    out = {}
    for name, pid in procs.items():
        if name.startswith("SERVE_REPLICA"):
            env = Path(f"/proc/{pid}/environ").read_bytes().split(b"\0")
            out[name] = next((e.split(b"=", 1)[1].decode() for e in env
                              if e.startswith(b"CUDA_VISIBLE_DEVICES=")), None)
    return out


def torch_loaded(pid: int) -> bool:
    """Whether process ``pid`` has loaded torch: importing it maps libtorch."""
    return "libtorch" in Path(f"/proc/{pid}/maps").read_text()


def top2_gap(model, cfg, prompt: list, gen: list, j: int) -> float:
    """The gap between the two largest logits of GPT2.forward at the
    position that predicts ``gen[j]``, teacher-forced on prompt + gen[:j]."""
    fwd = dataclasses.replace(cfg, remat=False)
    dev = next(model.parameters()).device
    with torch.inference_mode():
        logits = model(torch.tensor([prompt + gen[:j]], device=dev), fwd)[0, -1, :cfg.vocab_size]
    top = logits.float().topk(2).values
    return (top[0] - top[1]).item()


def text_divergence(tok, ref: list, text: str) -> tuple:
    """Where ``text`` leaves the byte decode of ``ref``: (the tokens of the
    first character that differs, as a range of indices into ``ref``), or
    None when the text is the decode. The incremental decoder emits a
    character at the token that completes it, so the first differing token
    lies among those since the last character that still agreed."""
    if text == tok.decode(ref):
        return None
    dec, emitted, since = tok.incremental_decoder(), "", 0
    for j, t in enumerate(ref):
        piece = dec.feed(t)
        if not piece:
            continue
        if not text.startswith(emitted + piece):
            return range(since, j + 1)
        emitted += piece
        since = j + 1
    return range(since, len(ref))


def check_front_texts(what: str, texts: list, refs: list, prompts: list, tok, model,
                      cfg) -> int:
    """Each text equals the byte decode of its reference tokens, or leaves
    it at a near tie: the reference's top-2 logit gap under GREEDY_MARGIN
    at the first differing token. Returns the texts equal."""
    equal = 0
    for text, ref, prompt in zip(texts, refs, prompts):
        where = text_divergence(tok, ref, text)
        if where is None:
            equal += 1
            continue
        gaps = [top2_gap(model, cfg, prompt, ref, j) for j in where if j < len(ref)]
        print(f"  {what}: prompt of {len(prompt)} tokens leaves the reference's text at "
              f"tokens {list(where)}: reference top-2 gaps {[f'{g:.3e}' for g in gaps]} "
              f"(limit {GREEDY_MARGIN})", flush=True)
        if not gaps or min(gaps) > GREEDY_MARGIN:
            fail(f"{what}: a text leaves the in-process engine's at no near tie")
    print(f"{what}: {equal} of {len(texts)} texts equal to the in-process engine's decode",
          flush=True)
    return equal


def _percentile_ms(xs: list, q: float) -> float:
    return float(np.percentile(xs, q)) * 1e3


def front_burst(addr: str, traffic: list) -> tuple:
    """Every request of ``traffic`` at once over SSE -> (texts, client
    TTFTs, output tokens/s); each must answer its max_tokens."""
    def one(r):
        st, ctype, events, ttft = sse_post(addr, "/v1/completions", {"model": SERVE_MODEL, **r})
        if st != 200 or ctype != "text/event-stream":
            fail(f"an SSE completion answered {st} {ctype}")
        text, n = sse_completion(events)
        if n != r["max_tokens"]:
            fail(f"usage.completion_tokens is {n}, asked {r['max_tokens']}")
        return text, ttft, n

    with ThreadPoolExecutor(max_workers=len(traffic)) as pool:
        t0 = time.perf_counter()
        outs = list(pool.map(one, traffic))
        wall = time.perf_counter() - t0
    return [o[0] for o in outs], [o[1] for o in outs], sum(o[2] for o in outs) / wall


def one_by_one(addr: str, reqs: list) -> tuple:
    """``reqs`` over SSE one at a time -> (texts, client TTFTs)."""
    texts, ttfts = [], []
    for r in reqs:
        st, _ctype, events, ttft = sse_post(addr, "/v1/completions", {"model": SERVE_MODEL, **r})
        if st != 200:
            fail(f"an SSE completion answered {st}")
        texts.append(sse_completion(events)[0])
        ttfts.append(ttft)
    return texts, ttfts


def check_engine_metrics(what: str, n_requests: int, n_tokens: int, card: str) -> dict:
    """The engines' series after a deployment's traffic (its replicas
    alive): TTFT counted for every request, the page gauges set, tokens at
    least those returned."""
    from ray_tpu_torch import state

    mx = state.cluster_metrics()
    ttft = sum(s["count"] for s in mx.get("rt_serve_ttft_s", {}).get("series", {}).values())
    itl = sum(s["count"] for s in mx.get("rt_serve_inter_token_s", {}).get("series", {}).values())
    tokens = sum(mx.get("rt_serve_tokens_generated_total", {}).get("series", {}).values())
    pages = {name: mx.get(f"rt_serve_kv_pages_{name}", {}).get("series", {})
             for name in ("total", "occupied", "prefix_resident")}
    print(f"{what} engines' metrics: rt_serve_ttft_s count {ttft} (requests {n_requests}), "
          f"rt_serve_inter_token_s count {itl}, rt_serve_tokens_generated_total {tokens:.0f} "
          f"(tokens returned {n_tokens}), rt_serve_kv_pages_total "
          f"{sorted(pages['total'].values())}, occupied {sorted(pages['occupied'].values())}, "
          f"prefix_resident {sorted(pages['prefix_resident'].values())} [{card}]", flush=True)
    if ttft < n_requests or tokens < n_tokens or not itl or not all(pages.values()):
        fail(f"{what}: the engines' serving metrics are missing or short")
    return mx


def report_state(window_s: float, card: str) -> None:
    """What the state API says of phase 10's session: each deployment's
    request latencies (the spans' summary), the serve control loop's
    status, and the metrics history's TTFT series over the phase's window.
    Fails if the history or the alert engine is off or the series empty."""
    from ray_tpu_torch import state
    from ray_tpu_torch.utils.metrics import hist_quantile

    for dep, rec in state.request_summary()["deployments"].items():
        legs = ", ".join(f"{leg} p50 {v['p50'] * 1e3:.2f} ms p95 {v['p95'] * 1e3:.2f} ms"
                         for leg, v in rec.items() if isinstance(v, dict) and "p50" in v)
        print(f"state.request_summary() {dep}: {legs}", flush=True)
    print(f"state.autoscale_status(): {json.dumps(state.autoscale_status(), default=str)[:1500]}",
          flush=True)
    hist = state.metrics_history("rt_serve_ttft_s", window_s=window_s)
    points = [p for p in hist.get("points", []) if p["count"]]
    alerts = state.alerts()
    if not hist.get("enabled", True) or hist.get("kind") != "histogram" or not points \
            or not alerts["enabled"]:
        fail(f"the metrics history holds no TTFT series for the phase: {hist}, alerts {alerts}")
    total = [0.0] * len(points[0]["buckets"])
    for p in points:
        total = [a + b for a, b in zip(total, p["buckets"])]
    p95 = hist_quantile(hist["boundaries"], total, 0.95)
    firing = [a["name"] for a in alerts["alerts"] if a["state"] == "firing"]
    print(f"state.metrics_history('rt_serve_ttft_s') over the phase's {window_s:.1f} s (step "
          f"{hist['step_s']} s): {len(points)} points with requests, "
          f"{sum(p['count'] for p in points):.0f} requests, mean TTFT per point (ms) "
          f"{[round(p['sum'] / p['count'] * 1e3, 2) for p in points]}, windowed p95 "
          f"{'n/a' if p95 is None else f'{p95 * 1e3:.2f} ms'} (interpolated in its bucket); "
          f"alerts firing {firing} [{card}]", flush=True)


def serve_front_door(card: str, phase4: dict) -> None:
    """Phase 10. ``phase4``: the in-process engine's TTFT p50/p95 (ms) and
    output tokens/s from phase 4."""
    import ray_tpu_torch
    from ray_tpu_torch import serve, state
    from ray_tpu_torch.core import worker as worker_mod
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve import llm
    from ray_tpu_torch.serve.openai.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    cfg = gpt2.CONFIGS[SERVE_MODEL]
    traffic = front_traffic(cfg.vocab_size)
    greedy = [r for r in traffic if r["temperature"] == 0]
    models = {SERVE_MODEL: llm.LLMConfig(model_id=SERVE_MODEL, max_batch_size=SERVE_BATCH)}
    phase_start = time.time()
    ray_tpu_torch.init(num_cpus=4)
    session = worker_mod.global_worker().session_id
    try:
        serve.start(http_port=0)
        # (a) two OpenAI replicas, each with its engine on the card
        t0 = time.perf_counter()
        llm.deploy(models, name=FRONT_NAME, num_replicas=FRONT_REPLICAS,
                   ray_actor_options={"num_gpus": FRONT_GPUS})
        addr = proxy_address()
        st, body = http_json(addr, "/v1/completions", {"model": SERVE_MODEL, "prompt": "hello",
                                                         "max_tokens": 1, "temperature": 0})
        startup_s = time.perf_counter() - t0
        if st != 200:
            fail(f"the first completion answered {st}: {body}")
        print(f"serve.llm.deploy({SERVE_MODEL}, {FRONT_REPLICAS} replicas) to the first answer "
              f"over HTTP: {startup_s:.2f} s [{card}]", flush=True)
        procs = serve_processes()
        plain = {n: pid for n, pid in procs.items() if not n.startswith("SERVE_REPLICA")}
        loaded = {n: torch_loaded(pid) for n, pid in plain.items()}
        placed = replica_cards(procs)
        print(f"serve processes: {sorted(procs)}; torch loaded in the controller and proxies: "
              f"{loaded}; the replicas' CUDA_VISIBLE_DEVICES {placed} ({FRONT_GPUS} of a card "
              "each)", flush=True)
        if len(plain) < 2 or any(loaded.values()):
            fail("the serve controller or a proxy imported torch")
        if len(placed) != FRONT_REPLICAS or len(set(placed.values())) != 1 or "" in placed.values():
            fail(f"{FRONT_REPLICAS} replicas at {FRONT_GPUS} of a card saw {placed}")
        # every replica loads its engine at its first request: warm both
        fingerprints, users = set(), 0
        while len(fingerprints) < FRONT_REPLICAS and users < 64:
            st, body = http_json(addr, "/v1/completions", {
                "model": SERVE_MODEL, "prompt": "warm", "max_tokens": 1, "temperature": 0,
                "user": f"warm-{users}"})
            fingerprints.add(body.get("system_fingerprint"))
            users += 1
        if len(fingerprints) < FRONT_REPLICAS:
            fail(f"{users} sessions reached only {fingerprints}")

        # (b) phase 4's mix at once over SSE, then 4 greedy ones unary
        texts, ttfts, rate = front_burst(addr, traffic)
        mono = {"p50": _percentile_ms(ttfts, 50), "p95": _percentile_ms(ttfts, 95), "tok_s": rate}
        unary_idx = [i for i, r in enumerate(traffic) if r["temperature"] == 0][:N_UNARY]
        unary = []
        for i in unary_idx:
            st, body = http_json(addr, "/v1/completions", {"model": SERVE_MODEL, **traffic[i]})
            if st != 200 or body["usage"]["completion_tokens"] != traffic[i]["max_tokens"]:
                fail(f"a unary completion answered {st}: {body.get('usage')}")
            unary.append(body["choices"][0]["text"])
        pinned = set()
        for _ in range(N_PINNED):
            st, body = http_json(addr, "/v1/completions", {
                "model": SERVE_MODEL, "prompt": "pin me", "max_tokens": 1, "temperature": 0,
                "user": "alice"})
            pinned.add(body["system_fingerprint"])
        print(f"user 'alice' answered by {pinned} ({N_PINNED} requests); the warm-up's sessions "
              f"by {sorted(fingerprints)}", flush=True)
        if len(pinned) != 1:
            fail("one OpenAI user reached more than one replica")
        seq_texts, seq_ttfts = one_by_one(addr, greedy[:N_ONE_BY_ONE])

        # the reference: a fresh in-process engine on the same seeded init
        ref_srv = make_server()
        try:
            model = ref_srv.model
            prompts = [tok.encode(r["prompt"]) for r in greedy]
            with ThreadPoolExecutor(max_workers=len(prompts)) as pool:
                refs = list(pool.map(lambda p: ask(ref_srv, {
                    "prompt_tokens": p, "max_new_tokens": MAX_NEW, "temperature": 0.0}), prompts))
            burst_greedy = [t for t, r in zip(texts, traffic) if r["temperature"] == 0]
            check_front_texts("the SSE burst (greedy) vs the in-process engine", burst_greedy,
                              refs, prompts, tok, model, cfg)
            # a unary text equals its streamed one, or both leave the
            # reference at near ties (the burst's check above)
            same = sum(u == texts[i] for u, i in zip(unary, unary_idx))
            print(f"unary vs streamed: {same} of {len(unary)} texts equal", flush=True)
            check_front_texts("unary vs the in-process engine", unary, refs[:N_UNARY],
                              prompts[:N_UNARY], tok, model, cfg)
            check_front_texts("one at a time (monolithic) vs the in-process engine", seq_texts,
                              refs[:N_ONE_BY_ONE], prompts[:N_ONE_BY_ONE], tok, model, cfg)
            n_mono = users + len(traffic) + N_UNARY + N_PINNED + N_ONE_BY_ONE + 1
            tokens_mono = MAX_NEW * (len(traffic) + N_UNARY + N_ONE_BY_ONE)
            check_engine_metrics("monolithic", n_mono, tokens_mono, card)
            serve.delete(FRONT_NAME)  # its two halves of the card go back

            # token ids through a build_llm_deployment handle
            handle = serve.run(llm.build_llm_deployment(llm.LLMConfig(
                model_id=SERVE_MODEL, max_batch_size=SERVE_BATCH),
                ray_actor_options={"num_gpus": FRONT_GPUS}),
                ready_timeout_s=FRONT_TIMEOUT_S)
            resps = [handle.remote({"prompt_tokens": p, "max_new_tokens": MAX_NEW,
                                    "temperature": 0.0}) for p in prompts[:N_ONE_BY_ONE]]
            got = [r.result(timeout_s=FRONT_TIMEOUT_S)["tokens"] for r in resps]
            compare_streams("handle", got, "in-process", refs[:N_ONE_BY_ONE],
                            [{"prompt_tokens": p, "temperature": 0.0}
                             for p in prompts[:N_ONE_BY_ONE]], model, cfg, near_ties=True)
            serve.delete(f"llm-{SERVE_MODEL}")

            # (c) a prefill tier and one decode replica
            t0 = time.perf_counter()
            llm.deploy(models, name=FRONT_NAME, num_replicas=1, disaggregated=True,
                       prefill_replicas=1, ray_actor_options={"num_gpus": FRONT_GPUS})
            st, body = http_json(addr, "/v1/completions", {
                "model": SERVE_MODEL, "prompt": "hello", "max_tokens": 1, "temperature": 0})
            disagg_startup_s = time.perf_counter() - t0
            if st != 200:
                fail(f"the disaggregated deployment's first completion answered {st}: {body}")
            d_seq_texts, d_seq_ttfts = one_by_one(addr, greedy[:N_ONE_BY_ONE])
            print(f"one at a time, disaggregated vs monolithic: "
                  f"{sum(a == b for a, b in zip(d_seq_texts, seq_texts))} of {N_ONE_BY_ONE} "
                  "texts equal", flush=True)
            check_front_texts("one at a time (disaggregated) vs the in-process engine",
                              d_seq_texts, refs[:N_ONE_BY_ONE], prompts[:N_ONE_BY_ONE], tok,
                              model, cfg)
            d_texts, d_ttfts, d_rate = front_burst(addr, traffic)
            check_front_texts("the SSE burst (disaggregated, greedy) vs the in-process engine",
                              [t for t, r in zip(d_texts, traffic) if r["temperature"] == 0],
                              refs, prompts, tok, model, cfg)
        finally:
            stop_server(ref_srv)
        n_disagg = 1 + N_ONE_BY_ONE + len(traffic)
        check_engine_metrics("disaggregated", n_disagg,
                             MAX_NEW * (N_ONE_BY_ONE + len(traffic)), card)
        disagg = {"p50": _percentile_ms(d_ttfts, 50), "p95": _percentile_ms(d_ttfts, 95),
                  "tok_s": d_rate}

        # the KV shipments: every prefill span's bytes are the rows in the
        # cache's dtype (bf16: 2 bytes an element); the spans as the state
        # API's timeline renders them
        spans = [e for e in state.timeline() if e.get("cat") == "request"]
        pre = [s for s in spans if s["name"].startswith("prefill:")]
        xfer = [s for s in spans if s["name"].startswith("transfer:")]
        itemsize = torch.finfo(cfg.dtype).bits // 8
        per_token = 2 * cfg.n_layer * cfg.n_head * cfg.head_dim * itemsize
        wrong = [(s["args"]["tokens"], s["args"]["kv_bytes"]) for s in pre
                 if s["args"]["kv_bytes"] != per_token * s["args"]["tokens"]]
        print(f"KV shipments: {len(pre)} prefill spans, {len(xfer)} transfer spans; bytes = "
              f"2 x L x n x H x Dh x {itemsize} ({cfg.dtype}) = {per_token} x n in "
              f"{len(pre) - len(wrong)} of {len(pre)}; "
              f"{sum(s['args']['kv_bytes'] for s in pre)} bytes in all", flush=True)
        if len(pre) < n_disagg or len(xfer) < n_disagg or wrong:
            fail(f"the KV shipments are missing or of the wrong size: {wrong[:4]}")
        pre_ms = [s["dur"] / 1e3 for s in pre]
        xfer_ms = [s["dur"] / 1e3 for s in xfer]
        print(f"PREFILL spans: p50 {statistics.median(pre_ms):.2f} ms, max {max(pre_ms):.2f} ms; "
              f"TRANSFER spans: p50 {statistics.median(xfer_ms):.2f} ms, max {max(xfer_ms):.2f} "
              f"ms [{card}]", flush=True)
        added = _percentile_ms(d_seq_ttfts, 50) - _percentile_ms(seq_ttfts, 50)
        print(f"TTFT one request at a time ({N_ONE_BY_ONE} greedy): monolithic p50 "
              f"{_percentile_ms(seq_ttfts, 50):.2f} ms, disaggregated p50 "
              f"{_percentile_ms(d_seq_ttfts, 50):.2f} ms: the KV shipment adds {added:.2f} ms; "
              f"disaggregated deploy to the first answer {disagg_startup_s:.2f} s [{card}]",
              flush=True)
        for what, m in (("in-process engine (phase 4)", phase4),
                        (f"front door, {FRONT_REPLICAS} replicas", mono),
                        ("front door, prefill tier + 1 decode replica", disagg)):
            print(f"{len(traffic)} requests at once, {what}: TTFT p50 {m['p50']:.2f} ms, p95 "
                  f"{m['p95']:.2f} ms, {m['tok_s']:.1f} output tokens/s [{card}]", flush=True)
        report_state(time.time() - phase_start, card)
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()

    deadline = time.monotonic() + 30
    while True:
        pids, files = session_leftovers(session)
        if not (pids or files) or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    print(f"after serve.shutdown() and shutdown(): {len(pids)} replica, controller or proxy "
          f"processes of the session alive, {len(files)} of its shm and spill paths left",
          flush=True)
    if pids or files:
        fail(f"the serve session left processes {pids} and files {files}")


# ---------------------------------------------------------------------------
# Phase 11: GPU-aware placement on the one card
# ---------------------------------------------------------------------------

PLACE_WAIT_S = 5.0  # how long a whole-card request must stay unplaced while the card is held


def placed_probe() -> dict:
    """What a worker process sees: its pid, its CUDA_VISIBLE_DEVICES, the
    cards torch counts, and with a card, card 0's name and UUID and a
    product computed on it."""
    out = {"pid": os.getpid(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "cards": torch.cuda.device_count()}
    if out["cards"]:
        x = torch.ones(64, 64, device="cuda")
        props = torch.cuda.get_device_properties(0)
        out.update(name=props.name, uuid=str(getattr(props, "uuid", "")),
                   product=float((x @ x).sum()))
    return out


class _Placed:
    """Phase 11's actor: a worker that holds its lease's cards for life."""

    def probe(self) -> dict:
        return placed_probe()


def placement(card: str) -> None:
    """Phase 11. The node's card as the GPU resource, with its NVLink
    domain's head; a task of num_gpus=1 in a worker that sees exactly this
    card; two actors of num_gpus=0.5 on the same card in two processes; a
    second whole-card request waiting while they hold it, and a task
    without num_gpus seeing no card; the waiting request placed once they
    are killed; every share back in the node's free set at the end."""
    import ray_tpu_torch
    from ray_tpu_torch.core import worker as worker_mod

    mine = str(getattr(torch.cuda.get_device_properties(0), "uuid", ""))
    ray_tpu_torch.init(num_cpus=2)
    session = worker_mod.global_worker().session_id
    agent = worker_mod.global_worker().agent
    try:
        total = ray_tpu_torch.cluster_resources()
        ids = list(agent.call("get_state")["cards_free"])
        heads = sorted(k for k in total if k.startswith("GPU-") and k.endswith("-head"))
        print(f"placement: the node offers GPU {total.get('GPU')}, card ids {ids}, domain head "
              f"{heads} [{card}]", flush=True)
        if total.get("GPU") != 1.0 or len(ids) != 1 or len(heads) != 1:
            fail(f"one card should be one GPU with one id and one domain head: {total}, {ids}")
        whole = ray_tpu_torch.remote(num_gpus=1)(placed_probe)
        t0 = time.perf_counter()
        a = ray_tpu_torch.get(whole.remote(), timeout=FRONT_TIMEOUT_S)
        first_s = time.perf_counter() - t0
        Half = ray_tpu_torch.remote(num_gpus=0.5)(_Placed)
        halves = [Half.remote(), Half.remote()]
        hs = ray_tpu_torch.get([h.probe.remote() for h in halves], timeout=FRONT_TIMEOUT_S)
        waiting = whole.remote()
        ready, _ = ray_tpu_torch.wait([waiting], timeout=PLACE_WAIT_S)
        cpu = ray_tpu_torch.get(ray_tpu_torch.remote(placed_probe).remote(),
                                timeout=FRONT_TIMEOUT_S)
        held = agent.call("get_state")["cards_free"]
        for h in halves:
            ray_tpu_torch.kill(h)
        b = ray_tpu_torch.get(waiting, timeout=FRONT_TIMEOUT_S)
        deadline = time.monotonic() + 30
        free = agent.call("get_state")["cards_free"]
        while free != dict.fromkeys(ids, 1.0) and time.monotonic() < deadline:
            time.sleep(0.1)
            free = agent.call("get_state")["cards_free"]
    finally:
        ray_tpu_torch.shutdown()
    print(f"placement: num_gpus=1 task (pid {a['pid']}, {first_s:.2f} s to its answer with the "
          f"worker's start): CUDA_VISIBLE_DEVICES {a['visible']}, {a['cards']} card seen, "
          f"{a.get('name')}, UUID {a.get('uuid')} (this process's card {mine}), a 64x64 product's "
          f"sum {a.get('product')}; two num_gpus=0.5 actors (pids {[h['pid'] for h in hs]}): "
          f"{[h['visible'] for h in hs]}, {[h['cards'] for h in hs]} cards seen; a second "
          f"whole-card request placed within {PLACE_WAIT_S} s while they held the card: "
          f"{bool(ready)} (free shares then {held}); a task without num_gpus saw "
          f"CUDA_VISIBLE_DEVICES {cpu['visible']!r}, {cpu['cards']} cards; after the halves "
          f"were killed the request ran in pid {b['pid']} on {b['visible']}; free shares at the "
          f"end {free} [{card}]", flush=True)
    for what, got in (("the num_gpus=1 task", a), ("the waiting request", b)) + tuple(
            (f"a half ({h['pid']})", h) for h in hs):
        if (got["visible"] != ids[0] or got["cards"] != 1 or got.get("uuid") != mine
                or got.get("product") != 64.0 ** 3):
            fail(f"{what} did not see exactly the node's card: {got}")
    if hs[0]["pid"] == hs[1]["pid"]:
        fail("the two halves ran in one process")
    if ready or held != dict.fromkeys(ids, 0.0):
        fail(f"a whole-card request was placed while two halves held the card ({held})")
    if cpu["cards"] != 0 or cpu["visible"] != "":
        fail(f"a task that asked for no card saw {cpu}")
    if free != dict.fromkeys(ids, 1.0):
        fail(f"the card's shares did not come back: {free}")
    deadline = time.monotonic() + 30
    while True:
        pids, files = session_leftovers(session)
        if not (pids or files) or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    if pids or files:
        fail(f"the placement session left processes {pids} and files {files}")


# ---------------------------------------------------------------------------
# Phase 12: device objects (RDT) for CUDA tensors
# ---------------------------------------------------------------------------

RDT_GPUS = 0.5  # the producer and the consumer each ask for half of the card
RDT_HANDOFFS = 5  # per payload; the median is printed
RDT_HOP = (8, 1024, 768)  # phase 8's activation: bf16, 12 MiB
RDT_MODEL = "gpt2-small"  # its bf16 state dict, all its leaves: the weight handoff
RDT_EXPORT_RUNS = 3  # the export's halves: median of 3 after one warm-up
RDT_SEED = 12


def payload_tensors(payload) -> list:
    """[(name, tensor)] of a payload: one tensor, or a state dict."""
    if isinstance(payload, torch.Tensor):
        return [("x", payload)]
    return list(payload.items())


def payload_digest(payload) -> tuple:
    """(sha256 over every tensor's name, dtype, shape and bytes, in order;
    the devices the tensors are on; their bytes)."""
    import hashlib

    h, devices, nbytes = hashlib.sha256(), set(), 0
    for name, x in payload_tensors(payload):
        devices.add(x.device.type)
        nbytes += x.nbytes
        h.update(f"{name}:{x.dtype}:{tuple(x.shape)}".encode())
        h.update(x.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest(), sorted(devices), nbytes


class _RdtProducer:
    """Phase 12's producer, on its half of the card: gpt2-small's bf16
    weights (a trainer's side of a weight handoff) and fresh payloads."""

    def __init__(self, seed: int):
        from ray_tpu_torch.models import gpt2

        self.gen = torch.Generator(device="cuda").manual_seed(seed)
        model = gpt2.init(self.gen, gpt2.CONFIGS[RDT_MODEL], "cuda").to(torch.bfloat16)
        self.weights = model.state_dict()
        self.kept = None
        self.digests = {}

    def payload(self, what: str):
        from collections import OrderedDict

        if what == "hop":
            return torch.randn(RDT_HOP, device="cuda", generator=self.gen).to(torch.bfloat16)
        return OrderedDict((k, v.clone()) for k, v in self.weights.items())

    def make(self, what: str, i: int):
        """A fresh payload, returned beside the time it leaves this task."""
        payload = self.payload(what)
        self.digests[what, i] = payload_digest(payload)
        torch.cuda.synchronize()
        return time.perf_counter(), payload

    def digest(self, what: str, i: int) -> tuple:
        return self.digests.pop((what, i))

    def make_kept(self):
        self.kept = self.payload("hop")
        return self.kept

    def same(self, x) -> bool:
        """The in-process tier: the argument is the stored tensor itself."""
        same = x is self.kept and x.data_ptr() == self.kept.data_ptr()
        self.kept = None
        return same

    def probe(self) -> dict:
        from ray_tpu_torch.core import worker as worker_mod

        # The store's count before the memory: a free that lands between
        # the two reads (the owner's release of a ref reaches this
        # process beside its next probe) then shows in both, never as 0
        # objects beside the memory from before the free.
        stats = worker_mod.global_worker().rpc_device_store_stats(None)
        torch.cuda.synchronize()
        return {**stats, "allocated": torch.cuda.memory_allocated(), "launches": _launch_counts()}

    def export_split(self, what: str) -> dict:
        """The handoff's host halves on a payload, each the median of
        RDT_EXPORT_RUNS after a warm-up. The export: the D2H through the
        pinned ring (every chunk's event waited, nothing written), the
        pwrite of the same bytes from host memory into a fresh shm file,
        and the overlapped export the worker runs (both at once). The
        upload a consumer runs, on a fresh mapping of an exported file:
        device_put, and its halves, the copy out of the mapping into pinned
        memory and the H2D of that."""
        import mmap
        import tempfile

        from ray_tpu_torch.core import device_objects as dev
        from ray_tpu_torch.core.object_store import _pwrite_all
        from ray_tpu_torch.utils.config import config

        arrays = [x for _, x in payload_tensors(self.payload(what))]
        offsets, total = dev.plan_export_layout(arrays)
        chunk = max(64 * 1024, int(config.rdt_d2h_chunk_bytes))
        hosts = [dev._host_bytes(a.cpu()) for a in arrays]
        shm = "/dev/shm" if os.path.isdir("/dev/shm") else None

        def drain(item):
            _off, _view, ready, release = item
            if ready is not None:  # a card's chunk
                ready.synchronize()
                release()

        def into_file(fill):
            fd, path = tempfile.mkstemp(dir=shm)
            try:
                os.ftruncate(fd, total)
                t0 = time.perf_counter()
                fill(fd)
                return (time.perf_counter() - t0) * 1e3
            finally:
                os.close(fd)
                os.unlink(path)

        def d2h():
            t0 = time.perf_counter()
            dev._stage_chunks(arrays, offsets, chunk, drain)
            return (time.perf_counter() - t0) * 1e3

        def write(fd):
            for h, off in zip(hosts, offsets):
                _pwrite_all(fd, h, off)

        meta = [(tuple(a.shape), str(a.dtype).removeprefix("torch."), "cuda") for a in arrays]

        def from_file(read) -> list:
            """[ms] of ``read`` on a fresh mapping of an exported file."""
            fd, path = tempfile.mkstemp(dir=shm)
            try:
                os.ftruncate(fd, total)
                dev.write_arrays_overlapped(fd, arrays, offsets)
                with mmap.mmap(fd, total, prot=mmap.PROT_READ) as mm:
                    view = memoryview(mm)
                    try:
                        return read(view)
                    finally:
                        view.release()
            finally:
                os.close(fd)
                os.unlink(path)

        def put(view) -> list:
            t0 = time.perf_counter()
            dev.device_put(view, offsets, meta)
            torch.cuda.synchronize()
            return [(time.perf_counter() - t0) * 1e3]

        def halves(view) -> list:
            seg = np.frombuffer(view, dtype=np.uint8)
            t0 = time.perf_counter()
            staging = torch.empty(total, dtype=torch.uint8, pin_memory=True)
            staging.numpy()[:] = seg
            t1 = time.perf_counter()
            torch.empty(total, dtype=torch.uint8, device="cuda").copy_(staging, non_blocking=True)
            torch.cuda.synchronize()
            del seg
            return [(t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3]

        runs = {"d2h": d2h, "write": lambda: into_file(write),
                "export": lambda: into_file(lambda fd: dev.write_arrays_overlapped(
                    fd, arrays, offsets)),
                "put": lambda: from_file(put)[0], "from_shm": lambda: from_file(halves)[0],
                "h2d": lambda: from_file(halves)[1]}
        out = {name: statistics.median([fn() for _ in range(RDT_EXPORT_RUNS + 1)][1:])
               for name, fn in runs.items()}
        return dict(out, bytes=total, chunk=chunk)


class _RdtConsumer:
    """Phase 12's consumer, on the other half of the card."""

    def take(self, msg) -> dict:
        torch.cuda.synchronize()  # the uploads were queued on this stream
        arrived = time.perf_counter()
        made, payload = msg
        digest, devices, nbytes = payload_digest(payload)
        return {"ms": (arrived - made) * 1e3, "digest": digest, "devices": devices,
                "bytes": nbytes, "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}

    def launches(self) -> tuple:
        return _launch_counts()


def _wait_freed(producer) -> dict:
    import ray_tpu_torch

    deadline = time.monotonic() + 30
    while True:
        st = ray_tpu_torch.get(producer.probe.remote(), timeout=FRONT_TIMEOUT_S)
        if st["device_objects"] == 0 or time.monotonic() > deadline:
            return st
        time.sleep(0.1)


def device_objects(card: str, hop_ms: float) -> None:
    """Phase 12. ``hop_ms``: phase 8's stage-to-stage hop of the same 12 MiB
    activation (median ms)."""
    import ray_tpu_torch
    from ray_tpu_torch.core import worker as worker_mod
    from ray_tpu_torch.core.device_objects import DeviceValue

    _zero_launches()
    ray_tpu_torch.init(num_cpus=2)
    w = worker_mod.global_worker()
    session = w.session_id
    rows = {}
    try:
        p = ray_tpu_torch.remote(num_gpus=RDT_GPUS)(_RdtProducer).remote(RDT_SEED)
        c = ray_tpu_torch.remote(num_gpus=RDT_GPUS)(_RdtConsumer).remote()
        ray_tpu_torch.get(p.probe.remote(), timeout=FRONT_TIMEOUT_S)
        kept = p.make_kept.options(tensor_transport="device").remote()
        if not ray_tpu_torch.get(p.same.remote(kept), timeout=FRONT_TIMEOUT_S):
            fail("a same-actor round trip of a device object did not return the stored tensor")
        del kept
        _wait_freed(p)
        for what in ("hop", "state_dict"):
            ms = []
            for i in range(RDT_HANDOFFS):
                ref = p.make.options(tensor_transport="device").remote(what, i)
                got = ray_tpu_torch.get(c.take.remote(ref), timeout=FRONT_TIMEOUT_S)
                want = ray_tpu_torch.get(p.digest.remote(what, i), timeout=FRONT_TIMEOUT_S)
                if got["digest"] != want[0] or got["devices"] != ["cuda"]:
                    fail(f"{what} handoff {i}: the consumer's leaves are not the producer's "
                         f"bits on the card ({got['devices']})")
                ms.append(got["ms"])
                if i == 0:
                    if not isinstance(w.memory_store.try_get(ref.id), DeviceValue):
                        fail(f"the owner of the {what} ref holds its payload, not a DeviceValue")
                    t0 = time.perf_counter()
                    _made, mine = ray_tpu_torch.get(ref, timeout=FRONT_TIMEOUT_S)
                    torch.cuda.synchronize()
                    get_ms = (time.perf_counter() - t0) * 1e3
                    if payload_digest(mine)[:2] != (want[0], ["cuda"]):
                        fail(f"the driver's get of the {what} ref is not the producer's bits "
                             "on the card")
                    del mine
                    held = ray_tpu_torch.get(p.probe.remote(), timeout=FRONT_TIMEOUT_S)
                del ref
                freed = _wait_freed(p)
                if freed["device_objects"]:
                    fail(f"{what} handoff {i}: the producer's store still holds "
                         f"{freed['device_objects']} objects after the ref was dropped")
                if i == 0:
                    fell = held["allocated"] - freed["allocated"]
                    if held["device_objects"] != 1 or fell < want[2]:
                        fail(f"the producer's memory fell by {fell} bytes when the {what} ref "
                             f"was dropped, not by the payload's {want[2]}")
                    rows[what] = {"bytes": want[2], "get_ms": get_ms,
                                  "held": held, "freed": freed, "fell": fell,
                                  "visible": got["visible"]}
            rows[what]["ms"] = ms
            rows[what]["export"] = ray_tpu_torch.get(p.export_split.remote(what),
                                                     timeout=FRONT_TIMEOUT_S)
        actor_launches = ray_tpu_torch.get([p.probe.remote(), c.launches.remote()],
                                           timeout=FRONT_TIMEOUT_S)
    finally:
        ray_tpu_torch.shutdown()
    counts, counts_f32 = _launch_counts()
    for what, r in rows.items():
        med = statistics.median(r["ms"])
        e = r["export"]
        rate = f", {r['bytes'] / med / 1e6:.2f} GB/s" if what == "state_dict" else ""
        print(f"device object handoff, {what} ({r['bytes']} bytes, bf16 CUDA leaves), producer "
              f"to consumer at {RDT_GPUS} of the card each (CUDA_VISIBLE_DEVICES "
              f"{r['visible']}), from the producer's return to the consumer's card, median of "
              f"{RDT_HANDOFFS}: {med:.3f} ms{rate} (all: {', '.join(f'{x:.3f}' for x in r['ms'])}); "
              f"the driver's get {r['get_ms']:.3f} ms; the export ({e['chunk']} byte chunks, "
              f"median of {RDT_EXPORT_RUNS}): D2H through pinned buffers {e['d2h']:.3f} ms, "
              f"pwrite into shm {e['write']:.3f} ms, overlapped {e['export']:.3f} ms; the "
              f"upload from a fresh mapping: device_put {e['put']:.3f} ms = the copy out of "
              f"the mapping into pinned memory {e['from_shm']:.3f} ms + H2D {e['h2d']:.3f} ms; the "
              f"producer's memory_allocated {r['held']['allocated']} with the ref, "
              f"{r['freed']['allocated']} after its drop (fell {r['fell']}), store objects "
              f"{r['freed']['device_objects']} [{card}]", flush=True)
    print(f"phase 8's stage-to-stage hop of the same 12 MiB activation (HostTensor over a "
          f"compiled graph's channel): {hop_ms:.3f} ms [{card}]", flush=True)
    launched = {"driver": counts, "driver f32": counts_f32,
                "producer": actor_launches[0]["launches"], "consumer": actor_launches[1]}
    print(f"flash launches in phase 12: {launched}", flush=True)
    if any(n for v in (counts, counts_f32) for n in v.values()) or any(
            n for pair in (actor_launches[0]["launches"], actor_launches[1])
            for v in pair for n in v.values()):
        fail("the device-object phase launched a flash kernel")
    deadline = time.monotonic() + 30
    while True:
        pids, files = session_leftovers(session)
        if not (pids or files) or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    if pids or files:
        fail(f"the device-object session left processes {pids} and files {files}")


# ---------------------------------------------------------------------------
# Phase 13: the PPO learner on the card
# ---------------------------------------------------------------------------

PPO_SEED = 3  # tests/test_rllib.py's
PPO_ITERS = 15
PPO_CHECK_STEPS = 256  # the held minibatch: one minibatch of CartPole steps
PPO_LOSS_RTOL = 1e-5
PPO_UPDATE_RELNORM_TOL = 1e-4  # each parameter's update, card vs CPU, f32
PPO_MOMENT_RELNORM_TOL = 1e-5  # each Adam moment
PPO_SYNC_RUNS = 2  # per variant, in turns


def _relnorm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _ppo_batch(params: dict, steps: int) -> dict:
    """``steps`` of CartPole under ``params`` by an env runner in this
    process, with GAE: a learner's batch."""
    from ray_tpu_torch.rllib import ppo as ppo_mod
    from ray_tpu_torch.utils import serialization

    runner = ppo_mod.EnvRunner.cls("CartPole-v1", PPO_SEED * 1000)
    b = runner.sample(serialization.pack(params), steps)
    adv, targets = ppo_mod._gae(b, 0.99, 0.95)
    return {"obs": b["obs"], "actions": b["actions"].astype(np.int64), "logp": b["logp"],
            "adv": adv, "targets": targets}


def check_learner_update(card: str) -> None:
    """One minibatch update of the learner on the card, held to the same
    update in plain torch on the CPU, from the same params and batch."""
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib import ppo as ppo_mod

    on_card = PPOConfig(num_env_runners=0, seed=PPO_SEED).build()
    on_cpu = PPOConfig(num_env_runners=0, seed=PPO_SEED, device="cpu").build()
    before = {k: torch.from_numpy(v) for k, v in ppo_mod._host_params(on_cpu.policy).items()}
    mb = _ppo_batch({k: v.numpy() for k, v in before.items()}, PPO_CHECK_STEPS)
    loss = {}
    for name, algo in (("card", on_card), ("cpu", on_cpu)):
        loss[name] = float(algo._train_minibatch(
            {k: torch.as_tensor(v, device=algo.device) for k, v in mb.items()}))
    loss_gap = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
    upd, mom = {}, {}
    for k in before:
        pc, pp = on_card.policy[k], on_cpu.policy[k]
        upd[k] = _relnorm(pc.cpu() - before[k], pp - before[k])
        sc, sp = on_card.opt.state[pc], on_cpu.opt.state[pp]
        mom[k] = max(_relnorm(sc["exp_avg"], sp["exp_avg"]),
                     _relnorm(sc["exp_avg_sq"], sp["exp_avg_sq"]))
    print(f"PPO learner, one minibatch update ({PPO_CHECK_STEPS} CartPole steps, f32) on the "
          f"card ({on_card.device}) vs plain torch on the CPU, the same init (seed {PPO_SEED}): "
          f"loss {loss['card']:.7f} vs {loss['cpu']:.7f} (rel {loss_gap:.2e}, limit "
          f"{PPO_LOSS_RTOL:g}); update relnorm max {max(upd.values()):.2e} (limit "
          f"{PPO_UPDATE_RELNORM_TOL:g}); Adam moments relnorm max {max(mom.values()):.2e} "
          f"(limit {PPO_MOMENT_RELNORM_TOL:g}) [{card}]", flush=True)
    if (on_card.device.type != "cuda" or loss_gap > PPO_LOSS_RTOL
            or max(upd.values()) > PPO_UPDATE_RELNORM_TOL
            or max(mom.values()) > PPO_MOMENT_RELNORM_TOL):
        fail(f"the learner's update on the card disagrees with the CPU's: {upd}, {mom}")


def time_loss_syncs(card: str) -> dict:
    """What train()'s float(loss) after every minibatch costs: one
    iteration's updates (6 epochs of 8 minibatches over 2048 steps) with
    a host read of each loss, and the same with the losses read once at
    the end, in turns. Median ms of each."""
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib import ppo as ppo_mod

    algo = PPOConfig(num_env_runners=0, seed=PPO_SEED).build()
    cfg = algo.cfg
    data = _ppo_batch(ppo_mod._host_params(algo.policy), 2 * cfg.rollout_length)
    on_dev = {k: torch.as_tensor(v, device=algo.device) for k, v in data.items()}
    rng = np.random.default_rng(cfg.seed)
    orders = [torch.as_tensor(rng.permutation(len(data["obs"])), device=algo.device)
              for _ in range(cfg.num_epochs)]

    def run(each: bool) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for order in orders:
            for start in range(0, len(order), cfg.minibatch_size):
                idx = order[start:start + cfg.minibatch_size]
                loss = algo._train_minibatch({k: v.index_select(0, idx) for k, v in on_dev.items()})
                losses.append(float(loss) if each else loss)
        if not each:
            torch.stack(losses).cpu()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    run(True)  # warm-up
    times = {True: [], False: []}
    for _ in range(PPO_SYNC_RUNS):
        for each in (True, False, False, True):
            times[each].append(run(each))
    return {"each": statistics.median(times[True]), "once": statistics.median(times[False]),
            "updates": cfg.num_epochs * len(range(0, len(data["obs"]), cfg.minibatch_size))}


def ppo_learner(card: str) -> None:
    """Phase 13: PPOConfig(num_env_runners=2, seed=3), the learner on the
    card and two CPU env runners, 15 iterations under tests/test_rllib.py's
    gates."""
    import ray_tpu_torch
    from ray_tpu_torch.core import worker as worker_mod
    from ray_tpu_torch.rllib import CartPole, PPOConfig

    _zero_launches()
    ray_tpu_torch.init(num_cpus=4)
    session = worker_mod.global_worker().session_id
    try:
        check_learner_update(card)
        algo = PPOConfig(num_env_runners=2, seed=PPO_SEED).build()
        try:
            sgd_ms = []
            update = algo._train_minibatch

            def timed_update(mb):
                # train() reads the loss right after: this sync adds none
                t0 = time.perf_counter()
                loss = update(mb)
                torch.cuda.synchronize()
                sgd_ms.append((time.perf_counter() - t0) * 1e3)
                return loss

            algo._train_minibatch = timed_update
            iters = []
            for _ in range(PPO_ITERS):
                n0 = len(sgd_ms)
                t0 = time.perf_counter()
                result = algo.train()
                wall = time.perf_counter() - t0
                iters.append((wall, sum(sgd_ms[n0:]) / 1e3, result))
            env = CartPole()
            obs, _ = env.reset(seed=42)
            steps, done = 0, False
            while not done and steps < 500:
                obs, _, term, trunc, _ = env.step(algo.compute_action(obs))
                done = term or trunc
                steps += 1
        finally:
            algo.stop()
        syncs = time_loss_syncs(card)
    finally:
        ray_tpu_torch.shutdown()
    counts, counts_f32 = _launch_counts()
    returns = [r["episode_return_mean"] for _, _, r in iters]
    first = next((x for x in returns if x is not None), None)
    best = max((x for x in returns if x is not None), default=0.0)
    walls = [w for w, _, _ in iters]
    sgds = [s for _, s, _ in iters]
    print(f"PPO on CartPole, {PPO_ITERS} iterations (2 CPU env runners x 1024 steps, the "
          f"learner on the card): episode return means "
          f"{[None if x is None else round(x, 1) for x in returns]}; first {first}, best {best} "
          f"(gate: >= max(60, 2 x first)); the greedy policy survived {steps} steps (gate: "
          f">= 100) [{card}]", flush=True)
    print(f"PPO seconds per iteration, median of {PPO_ITERS}: {statistics.median(walls):.3f} s = "
          f"SGD {statistics.median(sgds):.3f} s ({len(sgd_ms) // PPO_ITERS} minibatch updates, "
          f"each read back by float(loss)) + sampling, GAE and the batch's upload "
          f"{statistics.median(w - s for w, s in zip(walls, sgds)):.3f} s; one minibatch update "
          f"median {statistics.median(sgd_ms):.3f} ms (the first iteration's included; first "
          f"update {sgd_ms[0]:.3f} ms) [{card}]", flush=True)
    print(f"train()'s float(loss) after each of {syncs['updates']} updates: "
          f"{syncs['each']:.3f} ms an iteration's SGD, against {syncs['once']:.3f} ms with the "
          f"losses read once at the end ({syncs['each'] - syncs['once']:.3f} ms of host syncs, "
          f"median of {2 * PPO_SYNC_RUNS} each, in turns) [{card}]", flush=True)
    print(f"flash launches in phase 13: {counts}, f32 {counts_f32}", flush=True)
    if first is None or best < max(60.0, 2 * first):
        fail(f"PPO did not learn on the card: first={first}, best={best}")
    if steps < 100:
        fail(f"the greedy policy survived only {steps} steps")
    if any(counts.values()) or any(counts_f32.values()):
        fail("the PPO phase launched a flash kernel")
    deadline = time.monotonic() + 30
    while True:
        pids, files = session_leftovers(session)
        if not (pids or files) or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    if pids or files:
        fail(f"the PPO session left processes {pids} and files {files}")


# ---------------------------------------------------------------------------
# Phase 14: the train step at head dims 128, 32, 96, 48 and 256, and in f32
# ---------------------------------------------------------------------------

# (label, config overrides, batch rows, loss limit, relative?, gradient limit,
# chunks of the gradient check). gpt2-small's widths (d_model 768) as 6
# heads of 128, 24 of 32, 8 of 96 and 16 of 48 (on the 128 and 64 instances,
# padded), 3 of 256, 2 of 384 and 1 of 768 (the column-window kernels),
# bf16, B 32, T 1024: phase 3's init (the weights do not depend on the head
# count), tokens and limits. The Dh 32 and 48 checks
# take their reference pass in two halves of the batch (24 and 16 heads
# double reference attention's score tensors). gpt2-small in f32, B 8, T
# 1024, at 12 heads of 64, 3 of 256 and 2 of 384, held at the JAX package's f32
# limits: the loss within 1e-5 relative, each gradient within 1e-4 in
# relative norm.
HEAD_DIM_RUNS = (
    ("Dh 128 (6 heads)", {"n_head": 6}, 32, LOSS_REF_TOL, False, GRAD_RELNORM_TOL, 1),
    ("Dh 32 (24 heads)", {"n_head": 24}, 32, LOSS_REF_TOL, False, GRAD_RELNORM_TOL, 2),
    ("f32", {"dtype": torch.float32}, 8, 1e-5, True, 1e-4, 1),
    ("Dh 96 (8 heads)", {"n_head": 8}, 32, LOSS_REF_TOL, False, GRAD_RELNORM_TOL, 1),
    ("Dh 48 (16 heads)", {"n_head": 16}, 32, LOSS_REF_TOL, False, GRAD_RELNORM_TOL, 2),
    ("Dh 256 (3 heads)", {"n_head": 3}, 32, LOSS_REF_TOL, False, GRAD_RELNORM_TOL, 1),
    ("f32 Dh 256 (3 heads)", {"n_head": 3, "dtype": torch.float32}, 8, 1e-5, True, 1e-4, 1),
    ("f16", {"dtype": torch.float16}, 32, F16_LOSS_REF_TOL, False, F16_GRAD_RELNORM_TOL, 1),
    ("Dh 384 (2 heads)", {"n_head": 2}, 32, LOSS_REF_TOL, False, GRAD_RELNORM_TOL, 1),
    ("Dh 768 (1 head)", {"n_head": 1}, 32, LOSS_REF_TOL, False, GRAD_RELNORM_TOL, 1),
    ("f32 Dh 384 (2 heads)", {"n_head": 2, "dtype": torch.float32}, 8, 1e-5, True, 1e-4, 1),
)
HEAD_DIM_STEPS = 3  # timed, after one warm-up step
# The f16 run's gradient check under a static loss scale: at B 32, T 1024
# the mean over 32,768 tokens puts most of an f16 backward's activation
# gradients below f16's normal range (6.1e-5), and the two attention paths
# lose them differently (an H100 measured relnorm median 0.155 between them
# unscaled, 1.3e-3 under 2^12). The unscaled gaps are printed beside, not
# held. The train step itself takes no loss scale, as the JAX package's
# does not.
GRAD_LOSS_SCALE = {"f16": 2.0 ** 12}


def head_dim_steps(card: str, phase3_ms: float) -> dict:
    """Phase 14. Each run of HEAD_DIM_RUNS: the gradient check against
    reference attention on batch 0, one warm-up step, HEAD_DIM_STEPS timed
    steps with each kernel's instance launches counted (n_layer calls a
    step of the run's own instance, no other; fa.kernel_passes kernels a
    call). Returns {label: (median ms, launches
    a step by instance)}."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import flash_attention as fa

    table = {}
    for label, overrides, batch, loss_tol, relative, grad_tol, chunks in HEAD_DIM_RUNS:
        run = bench.setup(HEAD_DIM_STEPS + 1, batch=batch, **overrides)
        cfg, T = run.cfg, bench.SEQ
        scale = GRAD_LOSS_SCALE.get(label, 1.0)
        if scale != 1.0:
            check_gradients(run, card, chunks=chunks, gate=False)
        check_gradients(run, card, loss_tol=loss_tol, loss_relative=relative, grad_tol=grad_tol,
                        chunks=chunks, loss_scale=scale)
        loss0 = run.step(run.batches[0]).item()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        times, losses = [], []
        for tokens in run.batches[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = run.step(tokens)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        per_step = {key: n / len(times) for key, n in _instance_counts().items()}
        med = statistics.median(times)
        want = {fa.instance(name, cfg.head_dim, cfg.dtype): cfg.n_layer * fa.kernel_passes(name, cfg.head_dim)
                for name in KERNELS}
        print(f"train {bench.MODEL} {label}: d_model {cfg.d_model}, {cfg.n_head} heads of "
              f"{cfg.head_dim}, {cfg.dtype}, B={batch} T={T}; losses {loss0:.5f} (warm-up), "
              + ", ".join(f"{x:.5f}" for x in losses) + f"; median step {med:.2f} ms "
              f"({', '.join(f'{t:.2f}' for t in times)}), {batch * T / med * 1e3:.1f} tokens/s; "
              f"phase 3 (Dh 64, bf16, B=32): {phase3_ms:.2f} ms; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches a step {per_step} "
              f"[{card}]", flush=True)
        if not all(math.isfinite(x) for x in [loss0, *losses]):
            fail(f"{label}: non-finite loss {[loss0, *losses]}")
        if per_step != want:
            fail(f"{label} launched {per_step} a step; the design says {want}")
        table[label] = (med, per_step)
        del run
        torch.cuda.empty_cache()
    return table


# ---------------------------------------------------------------------------
# Phase 15: Tune, the CLI, job submission, the dashboard, the autoscaler
# ---------------------------------------------------------------------------

TUNE_LRS = (1e-4, 3e-4, 1e-3)  # (a)'s grid: a trial each, all gated by the one card
JOB_TIMEOUT_S = 600.0
# The autoscaler of (d) and of placed_cards.py part 7: a drained domain is
# terminated after AS_IDLE_S idle, and a removed gang's domains must be gone
# within AS_TERMINATE_S (the idle timeout, then polls, the agent's drain
# probe, its exit); a pending gang must be provisioned and reserved within
# AS_RESERVE_S.
AS_IDLE_S, AS_POLL_S, AS_COOLDOWN_S = 4.0, 0.5, 1.0
AS_TERMINATE_S = AS_IDLE_S + 30.0
AS_RESERVE_S = 180.0
# The job's entrypoint: it joins the cluster through RT_ADDRESS, prints what
# it sees, and takes phase 3's first step in a num_gpus=1 task.
JOB_SCRIPT = """import json, os
import ray_tpu_torch

print("entrypoint CUDA_VISIBLE_DEVICES=" + repr(os.environ.get("CUDA_VISIBLE_DEVICES")), flush=True)
ray_tpu_torch.init(address=os.environ["RT_ADDRESS"])


@ray_tpu_torch.remote(num_gpus=1)
def one_step():
    import torch
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import flash_attention as fa

    run = bench.setup(1)
    for counts in (fa.launches, fa.launches_f32):  # set to 0 just before the step
        counts.update(dict.fromkeys(counts, 0))
    loss = run.step(run.batches[0]).item()
    torch.cuda.synchronize()
    return {"loss": loss, "launches": dict(fa.launches),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "cards": torch.cuda.device_count()}


print("JOB_RESULT " + json.dumps(ray_tpu_torch.get(one_step.remote(), timeout=600)), flush=True)
ray_tpu_torch.shutdown()
"""


def counted_step(run, tokens) -> tuple:
    """One train step, the launch counts set to 0 just before it: (loss,
    ms, launches of each kernel in it)."""
    from ray_tpu_torch.ops import flash_attention as fa

    sync = torch.cuda.synchronize if tokens.is_cuda else (lambda: None)
    _zero_launches()
    sync()
    t0 = time.perf_counter()
    loss = run.step(tokens).item()
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    return loss, ms, dict(fa.launches)


def tune_trainable(config: dict) -> None:
    """Phase 15 (a)'s trial, and placed_cards part 6's: gpt2-small from
    phase 3's seeded init and tokens (``bench.setup``: B 32, T 1024, flash,
    fused CE, AdamW; ``config["setup"]`` overrides them, as the CPU
    rehearsal does) at the trial's lr, ``config.get("steps", N_STEPS)``
    steps, a ``tune.report`` after each: its loss, ms and each kernel's
    launches, and what the worker sees (its CUDA_VISIBLE_DEVICES, the cards
    torch counts, card 0's UUID, its pid), the trial's start and the
    report's time on the host clock."""
    from ray_tpu_torch import bench, tune

    start = time.time()
    run = bench.setup(config.get("steps", N_STEPS), **config.get("setup", {}))
    for group in run.optimizer.param_groups:
        group["lr"] = config["lr"]
    seen = {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "pid": os.getpid(),
            "cards": torch.cuda.device_count(), "uuid": ""}
    if seen["cards"]:
        seen["uuid"] = str(getattr(torch.cuda.get_device_properties(0), "uuid", ""))
    for i, tokens in enumerate(run.batches):
        loss, ms, launches = counted_step(run, tokens)
        tune.report(loss=loss, step=i, ms=ms, launches=launches, start=start, t=time.time(),
                    **seen)


def tune_trials(card: str, phase3: tuple) -> list:
    """Phase 15 (a): three trials at {"GPU": 1} on the one card through
    ``tune.Tuner``. Returns each trial's launches a step."""
    import shutil
    import tempfile

    from ray_tpu_torch import bench, tune

    _, losses3, step_ms3 = phase3
    mine = str(getattr(torch.cuda.get_device_properties(0), "uuid", ""))
    design = design_launches(bench.config(), remat=False)
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    t0 = time.time()
    try:
        grid = tune.Tuner(
            tune.with_resources(tune_trainable, {"GPU": 1}),
            param_space={"lr": tune.grid_search(list(TUNE_LRS))},
            tune_config=tune.TuneConfig(metric="loss", mode="min", max_concurrent_trials=3),
            run_dir=run_dir).fit()
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    fit_s = time.time() - t0
    if grid.num_errors or len(grid) != len(TUNE_LRS):
        fail(f"the Tune run: {len(grid)} trials, errors {[r.error for r in grid if r.error]}")
    # (lr, its reports) a trial, in the order the trials started
    recs = sorted(((r.config["lr"], r.all_reports) for r in grid),
                  key=lambda rec: rec[1][0]["start"] if rec[1] else math.inf)
    prev_end = t0
    for lr, reps in recs:
        ms = statistics.median(r["ms"] for r in reps[1:])
        print(f"tune: trial lr {lr:g} (pid {reps[0]['pid']}, CUDA_VISIBLE_DEVICES "
              f"{reps[0]['visible']!r}, {reps[0]['cards']} card seen, UUID {reps[0]['uuid']}): its "
              f"code started {reps[0]['start'] - prev_end:.2f} s after "
              f"{'fit() began' if prev_end == t0 else 'the trial before it ended'}; losses "
              + ", ".join(f"{r['loss']:.5f}" for r in reps)
              + f"; median step {ms:.2f} ms (phase 3: {step_ms3:.2f} ms); wall "
              f"{reps[-1]['t'] - reps[0]['start']:.2f} s; launches a step {reps[-1]['launches']} "
              f"[{card}]", flush=True)
        prev_end = reps[-1]["t"]
    best = grid.get_best_result()
    lowest = min(grid, key=lambda r: r.metrics["loss"])
    print(f"tune: fit() {fit_s:.2f} s for {len(recs)} trials one card at a time; best lr "
          f"{best.config['lr']:g} (final loss {best.metrics['loss']:.5f}) [{card}]", flush=True)
    for (lr, reps), (_, later) in zip(recs, recs[1:]):
        if later[0]["start"] < reps[-1]["t"]:
            fail(f"two trials held the one card at once: lr {lr:g} and the next")
    for lr, reps in recs:
        if len(reps) != N_STEPS or not all(math.isfinite(r["loss"]) for r in reps):
            fail(f"trial lr {lr:g}: {len(reps)} reports, losses {[r['loss'] for r in reps]}")
        if any(r["visible"] in (None, "") or "," in r["visible"] or r["cards"] != 1
               or r["uuid"] != mine for r in reps):
            fail(f"trial lr {lr:g} did not see exactly this card: {reps[0]}")
        if not abs(reps[0]["loss"] - losses3[0]) <= LOSS_REF_TOL:
            fail(f"trial lr {lr:g}: step-0 loss {reps[0]['loss']} vs phase 3's {losses3[0]}")
        if any(r["launches"] != design for r in reps):
            fail(f"trial lr {lr:g} launched {[r['launches'] for r in reps]}; the design says "
                 f"{design} a step")
    if best.trial_id != lowest.trial_id:
        fail(f"get_best_result() is {best.config}, the lowest final loss {lowest.config}")
    return [reps[-1]["launches"] for _, reps in recs]


def cli_status(addr: str, head: str, card: str) -> None:
    """Phase 15 (b): ``python -m ray_tpu_torch --address <addr> status`` in a
    process of its own shows the card as GPU 1 and the domain head."""
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "--address", addr, "status"],
                         capture_output=True, text=True, timeout=120, env=env, cwd=root)
    lines = [ln.strip() for ln in out.stdout.splitlines()]
    shown = [ln for ln in lines if ln.startswith(("GPU:", head + ":"))]
    print(f"cli: python -m ray_tpu_torch status exited {out.returncode}: {shown} [{card}]",
          flush=True)
    if out.returncode != 0:
        fail(f"rt status exited {out.returncode}: {out.stderr[-2000:]}")
    if not any(ln.startswith("GPU:") and ln.endswith("/1 available") for ln in shown) or not any(
            ln.startswith(head + ":") and ln.endswith("/1 available") for ln in shown):
        fail(f"rt status does not show GPU 1 and {head}: {out.stdout}")


def submitted_job(card: str, phase3: tuple) -> dict:
    """Phase 15 (b): an entrypoint submitted through JobSubmissionClient.
    Returns its task's launches in its one step."""
    import shlex
    import tempfile

    from ray_tpu_torch import bench
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

    design = design_launches(bench.config(), remat=False)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_job_") as tmp:
        script = Path(tmp) / "entrypoint.py"
        script.write_text(JOB_SCRIPT)
        client = JobSubmissionClient()
        t0 = time.perf_counter()
        sid = client.submit_job(
            entrypoint=f"{shlex.quote(sys.executable)} {shlex.quote(str(script))}")
        status = client.wait_until_finished(sid, timeout_s=JOB_TIMEOUT_S)
        wall = time.perf_counter() - t0
        logs = client.get_job_logs(sid)
        client.delete_job(sid)
    result = [ln for ln in logs.splitlines() if ln.startswith("JOB_RESULT ")]
    print(f"job: {sid} {status} in {wall:.2f} s; its log: "
          + " | ".join(ln for ln in logs.splitlines()
                       if ln.startswith(("entrypoint", "JOB_RESULT")))
          + f" [{card}]", flush=True)
    if status != JobStatus.SUCCEEDED or not result:
        fail(f"the job ended {status}: {logs[-3000:]}")
    got = json.loads(result[-1].removeprefix("JOB_RESULT "))
    if "entrypoint CUDA_VISIBLE_DEVICES=''" not in logs:
        fail(f"the job's entrypoint saw a card: {logs[-2000:]}")
    if got["cards"] != 1 or got["visible"] in (None, "") or "," in got["visible"]:
        fail(f"the job's num_gpus=1 task did not see one card: {got}")
    if got["launches"] != design or not abs(got["loss"] - phase3[1][0]) <= LOSS_REF_TOL:
        fail(f"the job's step: loss {got['loss']} (phase 3 {phase3[1][0]}), launches "
             f"{got['launches']} (design {design})")
    return got["launches"]


def dashboard_routes(addr: str, head: str, card: str) -> None:
    """Phase 15 (c): the dashboard on a free port answers /api/status,
    /api/nodes and /api/metrics/history with the card and its domain."""
    from ray_tpu_torch.dashboard import Dashboard

    dash = Dashboard(addr, port=0)
    dash.start()
    try:
        got = {path: http_json(dash.address, path, timeout=60) for path in (
            "/api/status", "/api/nodes",
            "/api/metrics/history?name=rt_lease_requests_total&window_s=120")}
    finally:
        dash.stop()
    (s1, status), (s2, nodes), (s3, hist) = got.values()
    total = status.get("resources_total", {}) if s1 == 200 else {}
    print(f"dashboard at {dash.address}: /api/status {s1} (GPU {total.get('GPU')}, {head} "
          f"{total.get(head)}), /api/nodes {s2} ({len(nodes) if s2 == 200 else nodes}), "
          f"/api/metrics/history {s3} (enabled {hist.get('enabled')}, "
          f"{len(hist.get('points') or [])} points) [{card}]", flush=True)
    if s1 != 200 or total.get("GPU") != 1.0 or total.get(head) != 1.0:
        fail(f"/api/status: {s1} {status}")
    if s2 != 200 or not any(n["resources_total"].get("GPU") == 1.0
                            and n["resources_total"].get(head) == 1.0 for n in nodes):
        fail(f"/api/nodes: {s2} {nodes}")
    if s3 != 200 or not hist.get("enabled") or hist.get("name") != "rt_lease_requests_total":
        fail(f"/api/metrics/history: {s3} {hist}")


class DomainWorker:
    """Phase 15 (d)'s worker, pinned to the provisioned domain's bundle: what
    it sees, and one step of phase 3's model."""

    def run(self, setup: dict) -> dict:
        import ray_tpu_torch
        from ray_tpu_torch import bench

        out = placed_probe()
        out["node"] = ray_tpu_torch.get_runtime_context().get_node_id()
        run = bench.setup(1, **setup)
        out["loss"], out["ms"], out["launches"] = counted_step(run, run.batches[0])
        return out


def agent_environ(pid: int) -> dict:
    """The environment process ``pid`` was started with."""
    with open(f"/proc/{pid}/environ", "rb") as f:
        pairs = [kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv]
    return {k.decode(): v.decode() for k, v in pairs}


def autoscaled_domains(domain: str, card_sets, num_slices: int, work) -> dict:
    """A Cluster whose head node's agent sees no card, and an Autoscaler
    over ``GpuDomainProvider(domain=domain, card_sets=card_sets)`` with room
    for ``num_slices`` domains (``card_sets`` None, as on the CPU: each
    domain declares its cards and head). A pending
    ``slice_placement_group(domain, num_slices=num_slices)`` is provisioned
    and reserved, ``work(spg)`` runs while the gang holds its domains, then
    ``remove()`` and the wait for the domains and their agents to go.
    Returns the seconds from the gang's creation to its domains'
    registration and to its reservation, the domains made, their nodes, the
    nodes of the gang's bundles, the CUDA_VISIBLE_DEVICES each agent was
    started with, ``work``'s result, the seconds from ``remove()`` until
    the domains were gone, and the free card sets then. Phase 15 (d) and
    placed_cards.py part 7 make their checks on it."""
    import ray_tpu_torch
    from ray_tpu_torch.accelerators import slice_placement_group
    from ray_tpu_torch.autoscaler import Autoscaler, GpuDomainProvider
    from ray_tpu_torch.core.cluster_utils import Cluster

    c = Cluster()
    scaler = None
    try:
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""  # the head node's agent sees no card
        try:
            c.add_node(num_cpus=2)
        finally:
            if saved is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved
        ray_tpu_torch.init(address=c.address)
        before = ray_tpu_torch.cluster_resources()
        if before.get("GPU", 0) or any(k.endswith("-head") for k in before):
            fail(f"the head node offers cards: {before}")
        provider = GpuDomainProvider(c.address, c.session_id, domain=domain, card_sets=card_sets)
        scaler = Autoscaler(c.address, provider, min_nodes=1, max_nodes=1 + num_slices,
                            idle_timeout_s=AS_IDLE_S, poll_period_s=AS_POLL_S,
                            upscale_cooldown_s=AS_COOLDOWN_S)
        scaler.start()
        t0 = time.perf_counter()
        spg = slice_placement_group(domain, num_slices=num_slices)
        out = {"registered_s": None}
        while out["registered_s"] is None and time.perf_counter() - t0 < AS_RESERVE_S:
            if sum(n.get("alive", True) and n.get("labels", {}).get("gpu-domain-type") == domain
                   for n in ray_tpu_torch.nodes()) >= num_slices:
                out["registered_s"] = time.perf_counter() - t0
            else:
                time.sleep(0.05)
        if (out["registered_s"] is None
                or not spg.wait(max(1.0, AS_RESERVE_S - (time.perf_counter() - t0)))):
            fail(f"{num_slices} domains of {domain} not provisioned and reserved in "
                 f"{AS_RESERVE_S} s ({provider._slices})")
        out["reserved_s"] = time.perf_counter() - t0
        # an agent registers, and the gang may be reserved on it, before its
        # start-up handshake reaches the provider, which books it only then
        while (len(provider.all_slice_members()) < num_slices
               and time.perf_counter() - t0 < AS_RESERVE_S):
            time.sleep(0.05)
        procs = [proc for members in provider._slices.values() for _, proc in members]
        out.update(made=provider._next_slice, nodes=provider.all_slice_members(),
                   locs={node for pg in spg.placement_groups
                         for node in pg.table()["bundle_locations"].values()},
                   agents_visible=sorted(
                       agent_environ(p.pid).get("CUDA_VISIBLE_DEVICES", "<unset>")
                       for p in procs))
        out["result"] = work(spg)
        t1 = time.perf_counter()
        spg.remove()
        while ((provider._slices or any(p.poll() is None for p in procs))
               and time.perf_counter() - t1 < AS_TERMINATE_S):
            time.sleep(0.1)
        out["gone_s"] = time.perf_counter() - t1
        out["free"] = provider.free_card_sets
    finally:
        if scaler is not None:
            scaler.stop()
        ray_tpu_torch.shutdown()
        c.shutdown()
    return out


def autoscaled_domain(card: str, phase3: tuple) -> dict:
    """Phase 15 (d): the autoscaler with the card as its one set makes one
    domain for a pending gang (``autoscaled_domains``), a worker pinned to
    its bundle takes a step on the card, and after remove() the domain
    goes. Returns the worker's launches in its step."""
    import ray_tpu_torch
    from ray_tpu_torch import bench
    from ray_tpu_torch.accelerators.gpu import domain_type

    mine = str(getattr(torch.cuda.get_device_properties(0), "uuid", ""))
    domain = domain_type(torch.cuda.get_device_name(0), 1)
    design = design_launches(bench.config(), remat=False)

    def work(spg) -> dict:
        worker = ray_tpu_torch.remote(num_gpus=1, num_cpus=0)(DomainWorker).options(
            scheduling_strategy=spg.worker_strategy(0, 0)).remote()
        got = ray_tpu_torch.get(worker.run.remote({}), timeout=FRONT_TIMEOUT_S)
        ray_tpu_torch.kill(worker)
        return got

    d = autoscaled_domains(domain, [["0"]], 1, work)
    got = d["result"]
    print(f"autoscaler: domain {domain} on card set ['0']: the pending group's domain registered "
          f"{d['registered_s']:.2f} s and the group reserved {d['reserved_s']:.2f} s after the "
          f"group's creation; {d['made']} domain provisioned, nodes {d['nodes']}, its agent's "
          f"CUDA_VISIBLE_DEVICES "
          f"{d['agents_visible']}, the group on {d['locs']}; the pinned worker (pid {got['pid']}) "
          f"saw CUDA_VISIBLE_DEVICES {got['visible']!r}, {got['cards']} card, UUID "
          f"{got.get('uuid')}; its step: loss {got['loss']:.5f} (phase 3 step 0 "
          f"{phase3[1][0]:.5f}), {got['ms']:.2f} ms, launches {got['launches']}; after remove() "
          f"the domain was terminated in {d['gone_s']:.2f} s (idle timeout {AS_IDLE_S} s, poll "
          f"{AS_POLL_S} s), free sets {d['free']} [{card}]", flush=True)
    if (d["made"] != 1 or len(d["nodes"]) != 1
            or d["locs"] != set(d["nodes"]) or d["agents_visible"] != ["0"]):
        fail(f"the autoscaler did not make exactly one domain on card 0 for the group: {d}")
    if (got["visible"] != "0" or got["cards"] != 1 or got.get("uuid") != mine
            or got["node"] != d["nodes"][0]):
        fail(f"the domain's worker did not see exactly card 0 of its domain: {got}")
    if got["launches"] != design or not abs(got["loss"] - phase3[1][0]) <= LOSS_REF_TOL:
        fail(f"the domain's step: loss {got['loss']}, launches {got['launches']}")
    if d["gone_s"] >= AS_TERMINATE_S or d["free"] != [["0"]]:
        fail(f"the drained domain was not terminated within {AS_TERMINATE_S} s "
             f"({d['gone_s']:.2f} s; free sets {d['free']})")
    return {"launches": got["launches"], "registered_s": d["registered_s"],
            "reserved_s": d["reserved_s"], "terminated_s": d["gone_s"]}


def library_modules(card: str, phase3: tuple) -> dict:
    """Phase 15: (a) Tune, (b) the CLI and job submission, (c) the
    dashboard, on one ray_tpu_torch.init of this card; then (d) the
    autoscaler on a Cluster of its own. Returns the launches a step of
    each kernel in the trials, the job's task and the domain's worker."""
    import ray_tpu_torch
    from ray_tpu_torch.core import worker as worker_mod

    ray_tpu_torch.init(num_cpus=4)
    session = worker_mod.global_worker().session_id
    try:
        addr = worker_mod.global_worker().control_address
        heads = [k for k in ray_tpu_torch.cluster_resources()
                 if k.startswith("GPU-") and k.endswith("-head")]
        if len(heads) != 1:
            fail(f"the card's node should carry one domain head: {heads}")
        head = heads[0]
        trials = tune_trials(card, phase3)
        cli_status(addr, head, card)
        job = submitted_job(card, phase3)
        dashboard_routes(addr, head, card)
    finally:
        ray_tpu_torch.shutdown()
    deadline = time.monotonic() + 30
    while True:
        pids, files = session_leftovers(session)
        if not (pids or files) or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    if pids or files:
        fail(f"the Tune/job session left processes {pids} and files {files}")
    domain = autoscaled_domain(card, phase3)
    return {"trials": trials, "job": job, "domain": domain["launches"]}


def timed_phase(label: str, fn, *args, **kwargs):
    """Run one phase and print its seconds (and the run's so far)."""
    _phase[:] = [label]
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    now = time.perf_counter()
    print(f"phase {label}: {now - t0:.1f} s ({now - RUN_START:.1f} s into the run)", flush=True)
    return out


RUN_START = time.perf_counter()


def main() -> None:
    card = timed_phase("1 (card)", identify)
    sass = timed_phase("1 (build)", build)
    results = timed_phase("2 (bf16 operands)", check_kernels, card)
    f32_operands = timed_phase("2 (f32 operands)", check_f32_operands, card)
    f16_operands = timed_phase("2 (f16 operands)", check_f16_operands, card, results)
    timed_phase("2 (mixed operands)", check_mixed_operands, card)
    mixed_timed = timed_phase("2 (mixed operands, timed)", time_mixed_operands, card)
    wide = timed_phase("2 (head dims above 256)", check_wide_head_dims, card)
    counts, losses, step_ms = timed_phase("3 (train)", train, card)
    remat = timed_phase("3 (remat)", remat_policies, card)
    phase4 = timed_phase("4", serve, card)
    f32 = timed_phase("5", parallel, card)
    timed_phase("6", sharded_step, card, remat["no remat"])
    timed_phase("7", pipeline_train, card, (counts, losses, step_ms))
    pp = {}
    stages = timed_phase("8", pipeline_parallel, card, step_ms, summary=pp)
    trained = timed_phase("9", lambda: train_library(card, train_oracle(card)))
    timed_phase("10", serve_front_door, card, phase4)
    timed_phase("11", placement, card)
    timed_phase("12", device_objects, card, pp["hop_ms"])
    timed_phase("13", ppo_learner, card)
    head_dims = timed_phase("14", head_dim_steps, card, step_ms)
    libs = timed_phase("15", library_modules, card, (counts, losses, step_ms))
    kernels = []
    for name in KERNELS:
        entry = dict(name=name, route="cuda", source=SOURCE, replaces=KERNELS[name],
                     launches=counts[name], **results[name])
        entry["instances"].update(f32_operands[name])
        entry["instances"].update(f16_operands[name])
        entry["instances"].update(mixed_timed[name])
        entry["instances"].update(wide[name])
        entry.update(held_at=sorted(HELD_AT[name], key=lambda h: (int(h.split()[0][1:]), h)),
                     f32_operands_source=F32_SOURCE, f16_operands_source=F16_SOURCE,
                     mixed_operands_source=MIXED_SOURCE, f32=f32[name], sass=sass[name],
                     pipeline_stage_launches_a_step=stages[name],
                     train_library_launches_a_step=trained[name],
                     head_dim_steps_launches_a_step={
                         label: {k: n for k, n in per_step.items() if k.startswith(name + " ")}
                         for label, (_, per_step) in head_dims.items()},
                     f16_train_step_launches_a_step={
                         k: n for k, n in head_dims["f16"][1].items() if k.startswith(name + " ")},
                     tune_trial_launches_a_step=[t[name] for t in libs["trials"]],
                     job_task_launches_a_step=libs["job"][name],
                     autoscaled_domain_launches_a_step=libs["domain"][name])
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

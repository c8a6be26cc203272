"""Config registry: typed flags with env-var overrides.

Equivalent of the reference's RAY_CONFIG system
(src/ray/common/ray_config_def.h — ~230 flags, overridable via RAY_<name>
env vars, head-distributed to all nodes). Here: ``define(name, default)``
registers a flag; ``RT_<NAME>`` env vars override; the head node snapshots
its config and ships it to joining nodes so a cluster shares one view.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Callable, Dict

_ENV_PREFIX = "RT_"


class _Flag:
    __slots__ = ("name", "default", "parser", "value", "overridden",
                 "dynamic")

    def __init__(self, name: str, default: Any, parser: Callable[[str], Any],
                 dynamic: bool = False):
        self.name = name
        self.default = default
        self.parser = parser
        self.overridden = False
        self.dynamic = dynamic
        env = None if dynamic else os.environ.get(
            _ENV_PREFIX + name.upper()
        )
        if env is not None:
            self.value = parser(env)
            self.overridden = True
        else:
            self.value = default

    def read(self) -> Any:
        """Current value.  Static flags resolved env once at define time;
        dynamic flags re-read the environment on every access (per-host /
        per-process values — a worker's XLA rank, a node's chip count —
        that land in os.environ after import, e.g. via runtime-env
        ``apply_env``).  An explicit ``config.set`` still wins."""
        if not self.dynamic or self.overridden:
            return self.value
        env = os.environ.get(_ENV_PREFIX + self.name.upper())
        if env is None or env == "":
            return self.default
        try:
            return self.parser(env)
        except ValueError:
            return self.default


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


class Config:
    """Process-global flag registry."""

    def __init__(self):
        self._flags: Dict[str, _Flag] = {}
        self._lock = threading.Lock()

    def define(self, name: str, default: Any, dynamic: bool = False) -> None:
        if isinstance(default, bool):
            parser: Callable[[str], Any] = _parse_bool
        elif isinstance(default, int):
            parser = int
        elif isinstance(default, float):
            parser = float
        else:
            parser = str
        with self._lock:
            if name not in self._flags:
                self._flags[name] = _Flag(name, default, parser, dynamic)

    def get(self, name: str) -> Any:
        return self._flags[name].read()

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            self._flags[name].value = value
            self._flags[name].overridden = True

    def snapshot(self) -> str:
        """Serialize current values (for head → node distribution).
        Dynamic flags are per-host/per-process and never ship: the
        head's chip count or XLA rank must not overwrite a node's."""
        with self._lock:
            return json.dumps({
                k: f.value for k, f in self._flags.items() if not f.dynamic
            })

    def load_snapshot(self, payload: str) -> None:
        """Apply a head-node snapshot; local env overrides still win."""
        data = json.loads(payload)
        with self._lock:
            for k, v in data.items():
                flag = self._flags.get(k)
                if flag is not None and not flag.overridden \
                        and not flag.dynamic:
                    flag.value = v

    def __getattr__(self, name: str) -> Any:
        try:
            return self._flags[name].read()
        except KeyError:
            raise AttributeError(name) from None


config = Config()

# --- Core flags (subset of the reference's ray_config_def.h surface) ---
config.define("rpc_connect_timeout_s", 10.0)
config.define("rpc_request_timeout_s", 60.0)
config.define("rpc_max_retries", 3)
config.define("rpc_retry_delay_s", 0.1)
# Multi-segment scatter-gather frames for data-bearing RPC messages
# (utils/rpc.py). Off = every frame is legacy single-segment (in-band
# payload pickling): the one-release compat escape hatch for clusters
# mixing pre-multiseg readers with new writers.
config.define("rpc_multiseg", True)
# Fault injection: "Service.Method:p_request:p_response" comma list
# (mirror of RAY_testing_rpc_failure, src/ray/common/ray_config_def.h:862).
config.define("testing_rpc_failure", "")
# Serve proxy → replica hot path: one direct RPC to the hosting worker
# (rpc_actor_direct_call) instead of the actor-task machinery. Off =
# every proxied request takes the ordinary submit/reply path (the
# mixed-version escape hatch, and the A/B lever for bench_core).
config.define("serve_direct_rpc", True)
config.define("health_check_period_s", 1.0)
config.define("health_check_timeout_s", 10.0)
config.define("max_direct_call_object_size", 100 * 1024)
config.define("object_store_memory_mb", 1024)
# Cross-node object transfer chunk size (reference C8 push/pull: 1MB
# chunks, object_manager.proto); larger here since transport is TCP.
config.define("object_transfer_chunk_size", 4 * 1024 * 1024)
# Sliding window of chunk RPCs in flight per pull (reference
# push_manager.h pipelining).
config.define("object_transfer_window", 8)
# Pulls at/above this size stream into a disk-backed mmap instead of a
# heap bytearray (bounding worker RSS for huge objects).
config.define("object_pull_disk_threshold", 256 * 1024 * 1024)
config.define("worker_register_timeout_s", 30.0)
config.define("worker_pool_prestart", 0)
config.define("worker_idle_timeout_s", 600.0)
config.define("scheduler_spread_threshold", 0.5)
config.define("task_max_retries", 3)
config.define("borrow_pin_ttl_s", 600.0)
# Streaming generators: once the done-marker says item i exists, how long
# to wait for its (in-flight) push before declaring the item lost.
config.define("stream_item_grace_s", 30.0)
# After a stream's error marker lands, how long to keep delivering the
# validly-produced prefix (whose pushes ride a different connection and can
# trail the error reply) before raising the error.
config.define("stream_error_grace_s", 2.0)
# Normal-task lease cache (reference normal_task_submitter.h:52-82):
# how long a granted worker lease is kept warm after its queue drains
# before being returned to the node agent, and how many lease requests
# one scheduling key keeps in flight (owner-side rate limiting; reference
# max_pending_lease_requests).
config.define("lease_keepalive_s", 1.0)
config.define("max_lease_requests_per_key", 10)
# Lease pool sizing (Little's law): hold enough workers to drain the
# queue in about this long given the measured per-task service latency.
# Short tasks pipeline onto few warm workers (a worker process per nop
# task is pure context-switch overhead); long tasks scale wide.
config.define("lease_rampup_target_s", 0.1)
# pip runtime envs install OFFLINE from these local wheel directories
# (os.pathsep-separated; this image has no egress to an index)
config.define("pip_find_links",
              os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "wheels"))
# Owner-side lineage entries kept for object reconstruction (reference
# bounds lineage by bytes; we bound by task count).
config.define("lineage_max_entries", 10000)
# Memory monitor (reference C19): kill a worker when host memory usage
# crosses the threshold. testing_memory_usage >= 0 injects a fake reading.
config.define("memory_usage_threshold", 0.95)
config.define("memory_monitor_period_s", 1.0)
config.define("testing_memory_usage", -1.0)
# Control-store metadata persistence (reference C14 Redis FT mode):
# empty = in-memory only; a path enables the HA durable log (snapshot at
# <path>, write-ahead log at <path>.wal) so a restarted head rebuilds an
# identical control plane (core/ha/).
config.define("control_store_persistence_path", "")
# HA durable-log tuning: WAL entries between snapshot compactions, and
# whether each append fsyncs (off by default: flush-to-OS survives a head
# process crash — the failure mode HA targets; power loss needs fsync).
config.define("ha_wal_compact_entries", 1000)
config.define("ha_wal_fsync", False)
# Reconciliation window after a head restart: scheduling stays paused
# this long (or until every restored-alive node re-attaches, whichever
# is sooner) while agents re-assert leases/bundles/workers; nodes that
# never re-attach are then GC'd as dead.
config.define("ha_reconcile_window_s", 8.0)
# Budget for a client (agent/worker/driver) to re-attach to a bounced
# head: retryable control-store calls keep redialing (with backoff,
# consulting ha_head_address_file for a moved head) up to this long.
config.define("ha_reattach_max_s", 60.0)
# Rendezvous file the head publishes its address to (shared storage);
# empty = same-address restarts only.
config.define("ha_head_address_file", "")
config.define("lineage_max_bytes", 256 * 1024 * 1024)
# Host collectives (collective/): peer-to-peer ring transport over the
# worker<->worker multiseg RPC data plane. RT_COLLECTIVE_P2P=0 is the
# kill switch — every collective byte rides the control-store KV again
# (the pre-p2p path, and the A/B lever for bench_core).
config.define("collective_p2p", True)
# Payloads below this ride the KV path even with p2p on: a tiny tensor's
# ring handshake costs more than one head round trip.
config.define("collective_p2p_min_bytes", 32 * 1024)
# Ring pipeline granularity: each ring chunk is split into subchunks of
# about this many bytes so subchunk k+1 is on the wire while k reduces.
config.define("collective_chunk_bytes", 1 * 1024 * 1024)
# Deadline for one collective op (mailbox waits + delivery acks); a dead
# peer surfaces as CollectiveError within this budget, never a hang.
config.define("collective_op_timeout_s", 120.0)
# Quantized allreduce (quant="int8"): elements per blockwise f32 scale.
config.define("collective_quant_block", 2048)
# Overlapped bucketed gradient allreduce (collective/bucketed.py):
# grad_sync packs the gradient pytree into per-dtype byte buckets (in
# reverse leaf order — backward produces output-side grads first) and
# allreduces each bucket on a background comm lane, joining only at
# optimizer apply. RT_COLLECTIVE_BUCKETED=0 is the kill switch: grad_sync
# degrades to the per-leaf blocking allreduce path.
config.define("collective_bucketed", True)
config.define("collective_bucket_bytes", 4 * 1024 * 1024)
# Hierarchical two-level allreduce: when a group spans >1 host (and has
# more ranks than hosts), bucketed allreduce reduces intra-host to a
# leader, runs the ring over leaders only, and broadcasts back — wire
# bytes crossing hosts scale with hosts, not ranks. 0 = always flat ring.
config.define("collective_hierarchical", True)
# Per-process host identity override for the collective topology (used
# by tests/bench to model multi-host placement on one box; empty = the
# worker address host). Dynamic: per-process, never shipped in the head
# config snapshot.
config.define("collective_host_id", "", dynamic=True)
# Compiled pipeline (parallel/pipeline.py CompiledPipeline): force EVERY
# stage-boundary channel onto the cross-host RpcChannel tier even when
# the stages share a node — the test/A-B lever for the worker<->worker
# chan_push path (same-node edges normally ride shm seqlock rings).
config.define("pipeline_force_rpc_channels", False)
# TPU-RDT device-object export: device->host copy of chunk k overlaps
# the shm/socket write of chunk k-1 through a depth-2 staging queue
# (core/device_objects.py write_arrays_overlapped). Chunk size trades
# overlap granularity against per-chunk bookkeeping (clamped to a
# 64 KiB floor); rdt_d2h_overlap off falls back to the serial
# convert-then-write path.
config.define("rdt_d2h_overlap", True)
config.define("rdt_d2h_chunk_bytes", 4 * 1024 * 1024)
# Producer-side eager export: start the (cached, single-flight) segment
# export the moment a device-transport task return is parked, so the
# D2H + shm write overlap the consumer task's submit/schedule latency.
# Off = export lazily on the consumer's first get (the pre-overlap
# behavior; saves the work when consumers are usually in-process).
config.define("rdt_eager_export", True)
config.define("actor_max_restarts", 0)
config.define("log_to_driver", True)
config.define("temp_dir", os.path.join(tempfile.gettempdir(), "ray_tpu_torch"))
# Observability (C18). trace_events gates task lifecycle span stamping
# (RT_TRACE_EVENTS=0 disables); observability_enabled gates the built-in
# core metrics (scheduler/lease/object-store/RPC/serve). Both are read
# once into module-level flags (ray_tpu_torch/observability) so the disabled
# hot path costs a single attribute check, not a registry lookup.
config.define("trace_events", True)
config.define("observability_enabled", True)
# Prefix KV caching (serve/prefix_cache.py): content-hashed prompt
# prefix blocks are kept in a refcounted, LRU-evicted per-engine pool
# and copied into a slot at admission instead of re-running prefill
# over them. RT_SERVE_PREFIX_CACHE=0 is the kill switch (and the A/B
# lever for bench_core's TTFT rows): every admission pays full prefill.
config.define("serve_prefix_cache", True)
# Tokens per prefix block: the unit of hashing, refcounting and reuse.
# Must be uniform across replicas of a deployment (the router's
# prefix-hash hint assumes one block geometry).
config.define("serve_prefix_block_tokens", 64)
# Max resident blocks per engine pool; refcount-0 blocks evict LRU
# beyond this.
config.define("serve_prefix_pool_blocks", 512)
# Paged KV pool (serve/llm.py + prefix_cache.PagedKVPool): the engine's
# generation KV and the prefix cache share ONE block-granular refcounted
# page pool — a prefix hit is a refcount bump (zero block copies),
# eviction is global LRU over pages not pinned by a live request, and
# continuous batching admits by free PAGES instead of free slots.
# RT_SERVE_PAGED_KV=0 is the kill switch: the engine reverts to the
# pre-paged slot cache + copy-based BlockPool (and the A/B lever for
# bench_serve's pagedkv leg). Page size inherits
# serve_prefix_block_tokens so page identity == prefix-block identity.
config.define("serve_paged_kv", True)
# Total pages in the engine pool; 0 = auto-size to MATCHED MEMORY with
# the slot engine (max_batch_size x ceil(n_positions/page_tokens)).
config.define("serve_kv_pool_pages", 0)
# Max concurrent sequences the paged engine decodes per step (the
# static batch width of the jitted decode); 0 = auto
# (4 x max_batch_size, capped by the pool's page count).
config.define("serve_paged_max_seqs", 0)
# Chunked prefill: at most this many prompt tokens are prefilled per
# engine round, so one long prompt is spread across rounds interleaved
# with decode steps (bounding in-flight streams' ITL and per-step
# memory). 0 = unchunked (a prompt prefills in one round).
config.define("serve_prefill_chunk_tokens", 512)
# Async decode pipeline (serve/llm.py): the engine dispatches decode
# chunk N+1 from chunk N's device-resident outputs BEFORE materializing
# chunk N's tokens on the host, so token fan-out, SSE queue puts,
# metrics stamps and the admission scan overlap with device compute
# (one-step lookahead). Page frees are deferred by one step so an
# in-flight chunk never reads freed pages. RT_SERVE_ASYNC_DECODE=0 is
# the kill switch (and the A/B lever for bench_serve's asyncdecode
# leg): the engine harvests every chunk synchronously before the next
# dispatch, exactly the pre-pipeline loop.
config.define("serve_async_decode", True)
# Disaggregated prefill/decode (serve/kv_transfer.py): the ingress
# calls a separate prefill deployment which ships the slot's KV rows
# back over an RpcChannel (zero-copy multiseg frames); the local engine
# imports them and only decodes. RT_SERVE_DISAGG=0 is the kill switch —
# every request prefills in the decode replica even when a prefill
# deployment exists.
config.define("serve_disagg", True)
# Budget for one prefill+transfer leg; a SIGKILLed prefill replica
# surfaces as a request failure within this, never a decode hang.
config.define("serve_disagg_timeout_s", 60.0)
# Server-side slice cap for blocking rpc_* waits on the head (kv_wait,
# wait_actor_alive, wait_placement_group): a handler never holds a
# dispatcher thread longer than this per call — clients re-issue slices
# until their own deadline (tools/rtlint dispatcher-block pass).
config.define("dispatch_wait_slice_s", 2.0)
# Control-plane scale envelope (ISSUE 14). actor_batch_flush_ms: the
# worker-side lifecycle batcher coalesces create/kill submissions for
# this long, then ships ONE register_actors/kill_actors RPC (0 = legacy
# one-RPC-per-actor path, also the bench A/B lever). wal_group_commit_ms:
# the HA WAL buffers appends from concurrent dispatcher threads and
# lands them as one buffered write (+ one fsync when ha_wal_fsync) per
# window; every RPC reply still barriers on durability of its own ops,
# so acked => in-WAL is unchanged (0 = per-op appends).
config.define("actor_batch_flush_ms", 2.0)
config.define("wal_group_commit_ms", 2.0)
# Bounded fan-out for parallel actor teardown (exit/release RPCs to
# workers and node agents during kill-drain).
config.define("actor_kill_fanout", 16)
# Metrics history + alerting plane (ISSUE 15, observability/history.py +
# alerts.py). The head samples state.cluster_metrics()+request_summary()
# every metrics_sample_interval_s into multi-resolution ring buffers
# (0 disables the sampler AND the alert engine; observability_enabled=0
# also disables both). metrics_history_max_series caps distinct
# (metric, tags) series retained — overflow series are dropped and
# counted, bounding head memory.
config.define("metrics_sample_interval_s", 1.0)
config.define("metrics_history_max_series", 2048)
# Alert engine: alerts_enabled gates rule evaluation on the sampler
# tick. The default rule pack reads the knobs below; extra rules ship as
# a JSON list of rule dicts in alerts_rules_extra.
config.define("alerts_enabled", True)
# TTFT SLO burn-rate rule: target latency, allowed bad-event fraction
# (error budget), the two burn windows, and the burn multiple that
# trips the rule on BOTH windows.
config.define("alerts_ttft_target_s", 2.0)
config.define("alerts_ttft_budget", 0.05)
config.define("alerts_burn_short_s", 60.0)
config.define("alerts_burn_long_s", 300.0)
config.define("alerts_burn_factor", 1.0)
# Threshold rules: sustained router/engine queue depth, KV-slot
# occupancy ratio (occupied/total), and the for-duration both must hold
# before firing.
config.define("alerts_queue_depth_max", 64.0)
config.define("alerts_kv_occupancy_frac", 0.95)
config.define("alerts_for_s", 30.0)
config.define("alerts_rules_extra", "")
# Profiler + forensics plane (ISSUE 16, observability/profiler.py +
# forensics.py). profiler_hz > 0 starts a low-rate continuous sampler
# thread in every process (per-subsystem shares feed
# rt_profile_samples_total); 0 = on-demand captures only. Server-side
# rpc_profile durations are clamped to profiler_max_duration_s so a
# caller can never pin a dispatcher thread indefinitely.
config.define("profiler_hz", 0.0)
config.define("profiler_max_duration_s", 60.0)
# Stall watchdog: a worker task running longer than this gets ONE
# {"type":"stall"} event carrying its thread stack stamped into the
# event ring (0 disables the watchdog).
config.define("task_stall_dump_s", 300.0)
# Crash flight recorder: period of the black-box writer thread that
# snapshots last-ring-events/active-tasks/rss to the crash dir (the
# snapshot that survives SIGKILL).
config.define("blackbox_interval_s", 5.0)
# Firing page-severity alerts attach one all-thread stack capture to
# the alert event, at most once per this interval.
config.define("alert_capture_min_interval_s", 60.0)
# Serving control loop (ISSUE 17, serve/autoscale/). The policy engine
# replaces the naive requests-per-replica autoscaler: every
# serve_autoscale_interval_s the controller reads windowed TTFT p95 /
# KV occupancy / queue depth from the head's metrics history (over
# serve_autoscale_window_s) plus the burn-rate alert state, and scales
# with hysteresis — up at the high watermarks (or a firing TTFT burn
# alert), down one replica at a time only after every signal stayed
# below the low watermarks for serve_autoscale_down_cooldown_s.
config.define("serve_autoscale_interval_s", 2.0)
config.define("serve_autoscale_window_s", 30.0)
config.define("serve_autoscale_up_cooldown_s", 2.0)
config.define("serve_autoscale_down_cooldown_s", 15.0)
# TTFT pressure watermark as a fraction of the SLO target
# (alerts_ttft_target_s): p95 above target*high_frac is a scale-up
# hint; below target*low_frac counts toward sustained-ok.
config.define("serve_autoscale_ttft_high_frac", 0.8)
config.define("serve_autoscale_ttft_low_frac", 0.4)
# KV-slot occupancy (occupied/total) watermarks.
config.define("serve_autoscale_kv_high_frac", 0.85)
config.define("serve_autoscale_kv_low_frac", 0.5)
# Session-aware drain: a scale-down victim stops taking new sessions
# (dropped from the routing table, HRW re-pins its sessions) and exits
# when its in-flight streams finish — or at this deadline, force-killed.
config.define("serve_autoscale_drain_deadline_s", 30.0)
# Admission control + load shedding at the proxy: bounded per-deployment
# in-flight work (queued + executing at THIS proxy; 503 + Retry-After
# past the bound — per-deployment override via
# @serve.deployment(max_queued_requests=...)) and an optional per-model
# concurrency cap (429 + Retry-After; 0 = uncapped). Kill switch:
# RT_SERVE_ADMISSION_ENABLED=0 admits everything.
config.define("serve_admission_enabled", True)
config.define("serve_admission_max_inflight", 256)
config.define("serve_admission_model_concurrency", 0)
config.define("serve_admission_retry_after_s", 1.0)
# Shed-rate alert rule: sustained sheds/s (rt_serve_shed_total windowed
# rate) above this trips serve_shed_rate.
config.define("alerts_shed_rate_max", 1.0)

# --- Per-host / per-process flags (dynamic) ----------------------------
# Re-read from the environment on every access and EXCLUDED from
# snapshot()/load_snapshot(): these describe the host or the process
# (chip inventory, XLA rank injected by the train controller via
# runtime-env apply_env), so a head-side value must never ship to nodes.
config.define("address", "", dynamic=True)
config.define("num_cpus", 0.0, dynamic=True)
# TPU inventory overrides (accelerators/tpu.py): "" = autodetect from
# the metadata server / PCI scan.
config.define("num_tpus", "", dynamic=True)
config.define("tpu_pod_type", "", dynamic=True)
config.define("tpu_topology", "", dynamic=True)
config.define("tpu_worker_id", "", dynamic=True)
# SPMD process-group coordinates the train controller injects into each
# TrainWorker's env between boot and run() (train/worker_group.py).
config.define("xla_group", "", dynamic=True)
config.define("xla_rank", "", dynamic=True)
config.define("xla_world", "", dynamic=True)
# Flash-attention block geometry (ops/flash_attention.py); tests tune
# these per-case via monkeypatch.setenv.
config.define("flash_bq", 1024, dynamic=True)
config.define("flash_bk", 1024, dynamic=True)
config.define("usage_stats_enabled", True, dynamic=True)
# Native (C/rust) data-plane toggle (native/__init__.py): RT_NATIVE=0
# forces the pure-python fallbacks.
config.define("native", True, dynamic=True)
# Crash-file directory for THIS process (forensics.py). The node agent
# points spawned workers at the session crash dir via RT_CRASH_DIR;
# empty = <temp_dir>/crash. Per-process by construction, so dynamic.
config.define("crash_dir", "", dynamic=True)

# --- Flags that no module of ray_tpu_torch reads -----------------------
# Their readers are modules not ported yet, named by the ROADMAP.md Queue A
# item that ports them (or, last, modules of neither package). The defines
# above stay as in the JAX package; the flags leave the registry here, so
# that config.set() or a read of one fails instead of doing nothing. An
# RT_<NAME> variable of one is ignored, as any unknown one is.
NOT_PORTED_FLAGS = {
    "item 8 (the state API, the metrics history and the alerts)": (
        "metrics_history_max_series", "alerts_enabled", "alerts_ttft_budget",
        "alerts_burn_short_s", "alerts_burn_long_s", "alerts_burn_factor",
        "alerts_kv_occupancy_frac", "alerts_for_s", "alerts_rules_extra",
        "alerts_shed_rate_max",
    ),
    "item 9 (GPU-aware scheduling; accelerators/ counts cards, not TPU chips)": (
        "num_tpus", "tpu_pod_type", "tpu_topology", "tpu_worker_id",
    ),
    "none: the Pallas kernels' blocks; the CUDA kernels fix their own tiles": (
        "flash_bq", "flash_bk",
    ),
    "none: read by neither package": (
        "worker_register_timeout_s", "worker_idle_timeout_s",
        "scheduler_spread_threshold", "actor_max_restarts", "log_to_driver",
    ),
}
for _names in NOT_PORTED_FLAGS.values():
    for _name in _names:
        del config._flags[_name]

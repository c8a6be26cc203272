"""Disaggregated prefill/decode: the prefill tier and the KV handoff
(counterpart of ``ray_tpu/serve/kv_transfer.py``).

Prefill and decode run as separate deployments. The decode side (the
OpenAI ingress, ``serve/openai/ingress.py``) mints an RPC channel handle
whose reader is its own worker, calls the prefill deployment
(``PrefillServer``) with it, and the prefill replica ships the prompt's
KV back through ``write_value`` (the arrays travel as out-of-band frame
segments, ``core/channels.py``). The trace id rides every leg: the
prefill replica stamps a PREFILL span, the decode side a TRANSFER span,
and ``serve_kv_transfer_bytes`` counts what was shipped.

A ``PrefillEngine`` runs only prefill: it fills one sequence's KV, samples
the first token and returns the shipment a decode engine's ``kv_import``
admission takes, ``{"k", "v", "first_token", "prompt_len",
"cached_tokens"}``. The K/V travel as f32 numpy arrays [L, n, H, Dh]
(numpy has no bf16 without ml_dtypes, and the upcast is exact): twice the
bytes of the JAX package's shipment, whose rows are bf16.

Failure contract: the prefill call carries a deadline
(``serve_disagg_timeout_s``); a SIGKILLed prefill replica surfaces as an
actor death or a timeout on the ack or the channel read, and the request
fails within the budget. Kill switch: ``serve_disagg=False`` (the ingress
prefills locally).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch.models import gpt2
from ray_tpu_torch.models import gpt2_decode as dec
from ray_tpu_torch.observability import core_metrics, tracing
from ray_tpu_torch.serve import prefix_cache
from ray_tpu_torch.serve.llm import (LLMConfig, _bucket, load_model, resolve_engine_device,
                                     sample_one)
from ray_tpu_torch.utils.config import config


def channel_capacity(model_cfg) -> int:
    """Upper bound of one KV shipment: full-length K and V rows in f32, plus
    slack for the frame header."""
    row = model_cfg.n_layer * model_cfg.n_positions * model_cfg.n_head * model_cfg.head_dim * 4
    return 2 * row + (1 << 20)


class PrefillEngine:
    """Prefill-only engine: one working sequence, no decode loop. It takes the
    weights as ``LLMServer`` does (the same seeded init or checkpoint), so at
    temperature 0 its first token and KV are the monolithic engine's.

    With the paged pool on (``serve_paged_kv``, the default) it prefills
    into a ``PagedKVPool`` with the paged functions and ships a gather of
    the sequence's pages; otherwise into a one-row slot cache with a host
    ``BlockPool`` of prefix blocks. Calls are serialised by a lock and run
    on the caller's thread."""

    def __init__(self, cfg: LLMConfig) -> None:
        self.cfg = cfg
        self.device = resolve_engine_device(cfg.device)
        self.model_cfg = gpt2.CONFIGS[cfg.model_id]
        self.model = load_model(cfg, self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(1)
        self._paged = (bool(cfg.paged_kv) if cfg.paged_kv is not None
                       else bool(config.serve_paged_kv))
        if self._paged:
            B = int(config.serve_prefix_block_tokens)
            max_pages = -(-self.model_cfg.n_positions // B)
            # the resident-prefix budget of a BlockPool, plus one full
            # working reservation and the scratch page: alloc can always
            # cover a prompt by evicting residents
            self._pool = prefix_cache.PagedKVPool(
                cfg.model_id, num_pages=int(config.serve_prefix_pool_blocks) + max_pages + 1,
                page_tokens=B)
        else:
            self._pool = prefix_cache.BlockPool(cfg.model_id)
        self._lock = threading.Lock()
        self._cache_k = self._cache_v = None  # built at first use

    def _device_tokens(self, tokens: List[int], width: int) -> torch.Tensor:
        tok = np.zeros((1, width), np.int64)
        tok[0, :len(tokens)] = tokens
        return torch.from_numpy(tok).to(self.device)

    @torch.inference_mode()
    def prefill(self, prompt_tokens: List[int], temperature: float) -> Dict[str, Any]:
        """Prefill the prompt (prefix-cache aware), sample the first token,
        and return the shipment for a decode engine's ``kv_import``."""
        mcfg, model = self.model_cfg, self.model
        T_max = mcfg.n_positions
        prompt = list(prompt_tokens)[-(T_max - 1):] or [0]
        if self._paged:
            return self._prefill_paged(prompt, temperature)

        with self._lock:
            if self._cache_k is None:
                self._cache_k, self._cache_v = dec.init_cache(mcfg, 1, T_max, self.device)
            pool = self._pool if config.serve_prefix_cache else None
            held: List[str] = []
            digests: List[str] = []
            cached = 0
            try:
                if pool is not None:
                    digests = prefix_cache.hash_blocks(prompt, pool.block_tokens)
                    held, ks, vs = pool.match(digests, max_tokens=len(prompt) - 1)
                    cached = len(held) * pool.block_tokens
                if cached:
                    dec.write_prefix(torch.from_numpy(np.concatenate(ks, axis=1)).to(self.device),
                                     torch.from_numpy(np.concatenate(vs, axis=1)).to(self.device),
                                     self._cache_k, self._cache_v, 0)
                    tail = prompt[cached:]
                    tok = self._device_tokens(tail, _bucket(len(tail), T_max - cached))
                    logits = dec.prefill_extend(mcfg, model, tok, cached, len(tail),
                                                self._cache_k, self._cache_v, 0)
                else:
                    tok = self._device_tokens(prompt, _bucket(len(prompt), T_max))
                    logits = dec.prefill(mcfg, model, tok, len(prompt), self._cache_k,
                                         self._cache_v, 0)
                first = sample_one(logits, temperature, self._gen)
                # f32 host copy of the filled row; the shipment and the
                # pool's blocks slice it
                row_k = self._cache_k[:, 0].float().cpu().numpy()
                row_v = self._cache_v[:, 0].float().cpu().numpy()
                if pool is not None and len(digests) > len(held):
                    B = pool.block_tokens
                    for j in range(len(held), len(digests)):
                        pool.insert(digests[j], row_k[:, j * B:(j + 1) * B].copy(),
                                    row_v[:, j * B:(j + 1) * B].copy())
                    held = list(digests)
            except Exception:
                self._cache_k = self._cache_v = None  # rebuilt at the next call
                raise
            finally:
                if pool is not None and held:
                    pool.release(held)
        n = len(prompt)
        return {
            "k": np.ascontiguousarray(row_k[:, :n]),
            "v": np.ascontiguousarray(row_v[:, :n]),
            "first_token": first,
            "prompt_len": n,
            "cached_tokens": cached,
        }

    def _prefill_paged(self, prompt: List[int], temperature: float) -> Dict[str, Any]:
        """Match resident prefix pages (a refcount bump), prefill only the
        tail into fresh pages, seal the new full blocks, and ship a gather
        of the sequence's pages: the same wire format as the slot path."""
        mcfg, model = self.model_cfg, self.model
        pool = self._pool
        B = pool.page_tokens
        max_pages = -(-mcfg.n_positions // B)
        with self._lock:
            if self._cache_k is None:
                self._cache_k, self._cache_v = dec.init_paged_cache(
                    mcfg, pool.num_pages, B, self.device)
                pool.reset()
            digests = (prefix_cache.hash_blocks(prompt, B)
                       if config.serve_prefix_cache else [])
            held_pages: List[int] = []
            new_pages: List[int] = []
            try:
                # keep >= 1 prompt token uncached: its prefill gives the
                # first token's logits
                _, held_pages = pool.match_pages(digests, max_tokens=len(prompt) - 1)
                cached = len(held_pages) * B
                n_pages = -(-len(prompt) // B)
                alloc = pool.alloc(n_pages - len(held_pages))
                if alloc is None:
                    raise RuntimeError(f"prefill page pool exhausted: need "
                                       f"{n_pages - len(held_pages)} pages")
                new_pages = alloc
                pages = held_pages + new_pages
                table = np.zeros((max_pages,), np.int64)
                table[:len(pages)] = pages
                table_dev = torch.from_numpy(table).to(self.device)
                tail = prompt[cached:]
                tok = self._device_tokens(tail, _bucket(len(tail), max_pages * B - cached))
                logits = dec.prefill_paged(mcfg, model, tok, cached, len(tail),
                                           self._cache_k, self._cache_v, table_dev)
                first = sample_one(logits, temperature, self._gen)
                n = len(prompt)
                shape = (mcfg.n_layer, n_pages * B, mcfg.n_head, mcfg.head_dim)
                used = table_dev[:n_pages]
                row_k = self._cache_k[:, used].float().cpu().numpy().reshape(shape)
                row_v = self._cache_v[:, used].float().cpu().numpy().reshape(shape)
                for j in range(len(held_pages), min(n // B, len(digests))):
                    pool.seal(digests[j], int(pages[j]))
            except Exception:
                # rebuilt, with a pool reset, at the next call
                self._cache_k = self._cache_v = None
                raise
            finally:
                pool.release_pages(held_pages + new_pages)
        return {
            "k": np.ascontiguousarray(row_k[:, :n]),
            "v": np.ascontiguousarray(row_v[:, :n]),
            "first_token": first,
            "prompt_len": n,
            "cached_tokens": cached,
        }

    def batch_stats(self, _payload=None) -> Dict[str, Any]:
        return {"prefix": self._pool.stats(), "pid": os.getpid()}

    def unload(self) -> None:
        """The prefix pool dies with the engine."""
        self._pool.close()
        self._cache_k = self._cache_v = None


class PrefillServer:
    """The prefill deployment callable: receives
    ``{model, prompt_tokens, temperature, chan, trace_id}`` payloads
    from decode-side ingress replicas, runs prefill, and ships the KV
    rows back through the caller's channel handle."""

    def __init__(self, models, max_engines_per_replica: int = 2):
        from ray_tpu_torch.serve import multiplex
        from ray_tpu_torch.serve.openai.ingress import _normalize_models

        self._models = _normalize_models(models)
        self._engines = multiplex.make_multiplexer(
            lambda model: self._load_engine(model),
            max_models=max_engines_per_replica,
        )

    def _load_engine(self, model: str) -> PrefillEngine:
        cfg = self._models.get(model)
        if cfg is None:
            raise ValueError(f"model {model!r} does not exist")
        return PrefillEngine(cfg)

    def __call__(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        if payload.get("op") == "info":
            # test/ops hook: which process serves this replica
            return {"pid": os.getpid(),
                    "models": sorted(self._models)}
        model = payload["model"]
        trace_id = payload.get("trace_id")
        t0u = tracing.now_us() if (tracing.ENABLED and trace_id) else 0
        engine = self._engines.get(model)
        shipment = engine.prefill(
            payload["prompt_tokens"], float(payload.get("temperature", 0.0))
        )
        nbytes = shipment["k"].nbytes + shipment["v"].nbytes
        send_kv(payload["chan"], shipment,
                timeout_s=float(payload.get("timeout_s", 30.0)))
        if core_metrics.ENABLED:
            core_metrics.serve_kv_transfer_bytes.inc(
                nbytes, tags={"deployment": model}
            )
        if tracing.ENABLED and trace_id:
            tracing.emit(tracing.request_span(
                trace_id, tracing.PREFILL, model, t0u,
                tracing.now_us() - t0u,
                tokens=shipment["prompt_len"],
                cached=shipment["cached_tokens"] > 0,
                kv_bytes=nbytes,
            ))
        return {
            "ok": True,
            "prompt_len": shipment["prompt_len"],
            "cached_tokens": shipment["cached_tokens"],
            "kv_bytes": nbytes,
        }


def send_kv(handle: Dict[str, Any], shipment: Dict[str, Any],
            timeout_s: float = 30.0) -> None:
    """Writer leg: serialize the shipment scatter-gather (the KV
    ndarrays become out-of-band segments; the ≥32 KiB frame rides the
    multiseg wire format, pinned by tools/check_inband_payloads.py)."""
    from ray_tpu_torch.core import channels

    chan = channels.open_channel(handle, "write")
    try:
        chan.write_value(shipment, timeout_s=timeout_s)
    finally:
        chan.close()


def recv_kv(reader, timeout_s: float = 30.0) -> Dict[str, Any]:
    """Reader leg: one shipment off the channel (zero-copy frame)."""
    return reader.read_value(timeout_s=timeout_s)


def prefill_remote(deployment: str, model: str, eng_req: Dict[str, Any],
                   model_cfg) -> Dict[str, Any]:
    """Decode-side orchestration: run ``eng_req``'s prefill on the
    ``deployment`` prefill tier and return the ``kv_import`` dict for
    the local engine's admission. Raises within the
    RT_SERVE_DISAGG_TIMEOUT_S budget when the prefill tier is dead."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.core import channels
    from ray_tpu_torch.core import worker as worker_mod
    from ray_tpu_torch.utils.config import config

    deadline = time.monotonic() + config.serve_disagg_timeout_s
    w = worker_mod.global_worker()
    handle = channels.rpc_channel_handle(
        w.address, channel_capacity(model_cfg), slots=2
    )
    reader = channels.open_channel(handle, "read")
    trace_id = eng_req.get("trace_id")
    try:
        h = serve.get_deployment_handle(deployment)
        resp = h.remote({
            "model": model,
            "prompt_tokens": eng_req["prompt_tokens"],
            "temperature": eng_req.get("temperature", 0.0),
            "chan": handle,
            "trace_id": trace_id,
            "timeout_s": max(1.0, deadline - time.monotonic()),
        })
        ack = resp.result(
            timeout_s=max(1.0, deadline - time.monotonic())
        )
        if not isinstance(ack, dict) or not ack.get("ok"):
            raise RuntimeError(f"prefill deployment returned {ack!r}")
        t0u = tracing.now_us() if (tracing.ENABLED and trace_id) else 0
        shipment = recv_kv(
            reader, timeout_s=max(1.0, deadline - time.monotonic())
        )
        if tracing.ENABLED and trace_id:
            tracing.emit(tracing.request_span(
                trace_id, tracing.TRANSFER, model, t0u,
                tracing.now_us() - t0u,
                kv_bytes=int(ack.get("kv_bytes", 0)),
            ))
        return {
            "k": shipment["k"],
            "v": shipment["v"],
            "first_token": shipment["first_token"],
            "prompt_len": shipment["prompt_len"],
        }
    finally:
        reader.close()

"""The prefill tier of disaggregated serving (counterpart of
``ray_tpu/serve/kv_transfer.py``'s ``channel_capacity`` and
``PrefillEngine``).

A ``PrefillEngine`` runs only prefill: it fills one sequence's KV, samples
the first token and returns the shipment a decode engine's ``kv_import``
admission takes, ``{"k", "v", "first_token", "prompt_len",
"cached_tokens"}``. The K/V travel as f32 numpy arrays [L, n, H, Dh]: the
card's machine has no bf16 numpy, and the upcast is exact. The RPC legs
(``PrefillServer``, ``send_kv``, ``recv_kv``, ``prefill_remote``) need the
runtime and are not ported (ROADMAP.md, Queue A item 3).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch.models import gpt2
from ray_tpu_torch.models import gpt2_decode as dec
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

"""The serve flags the port's engine reads (counterpart of the serve part of
``ray_tpu/utils/config.py``): the same names, the same defaults and the same
``RT_<NAME>`` environment overrides, read once when the flag is defined.
``config.set`` overrides a flag at run time (the engines read the prefix
and chunking flags at every admission, so tests flip them between
requests).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict

_ENV_PREFIX = "RT_"


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


class Config:
    """Process-global flag registry."""

    def __init__(self):
        self._values: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def define(self, name: str, default: Any) -> None:
        if isinstance(default, bool):
            parser: Callable[[str], Any] = _parse_bool
        elif isinstance(default, int):
            parser = int
        elif isinstance(default, float):
            parser = float
        else:
            parser = str
        env = os.environ.get(_ENV_PREFIX + name.upper())
        with self._lock:
            if name not in self._values:
                self._values[name] = default if env is None else parser(env)

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            if name not in self._values:
                raise KeyError(name)
            self._values[name] = value

    def __getattr__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(name) from None


config = Config()

# Prefix KV caching (serve/prefix_cache.py): full prompt blocks are hashed,
# and a request sharing a resident prefix skips its prefill.
# RT_SERVE_PREFIX_CACHE=0 turns it off (checked at every admission).
config.define("serve_prefix_cache", True)
# Tokens per prefix block, which is also the paged engine's page size.
config.define("serve_prefix_block_tokens", 64)
# Most resident blocks in the slot engine's host pool (and the prefill
# tier's resident-prefix budget); refcount-0 blocks evict LRU beyond it.
config.define("serve_prefix_pool_blocks", 512)
# Paged KV pool (the default engine): generation and prefix KV share one
# refcounted page pool. RT_SERVE_PAGED_KV=0 selects the slot engine.
config.define("serve_paged_kv", True)
# Pages in the engine's pool; 0 = the slot engine's memory
# (max_batch_size x ceil(n_positions / page_tokens)), plus the scratch page.
config.define("serve_kv_pool_pages", 0)
# Decode rows of the paged engine; 0 = 4 x max_batch_size, at most the
# pool's usable pages.
config.define("serve_paged_max_seqs", 0)
# Chunked prefill: at most this many prompt tokens per engine round
# (0 = a prompt prefills in one round).
config.define("serve_prefill_chunk_tokens", 512)
# Async decode: dispatch chunk N+1 before reading chunk N's tokens on the
# host. RT_SERVE_ASYNC_DECODE=0 harvests every chunk before the next.
config.define("serve_async_decode", True)

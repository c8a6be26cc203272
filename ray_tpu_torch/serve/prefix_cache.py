"""Block-granular prefix KV cache for the port's engine (host-only copy of
``ray_tpu/serve/prefix_cache.py``).

Prompts are chopped into fixed-size token blocks, each named by a CHAIN
hash (its own tokens and the parent block's digest, so a digest names a
whole prefix). Two pools:

- ``BlockPool`` (the slot engine): host copies of each full block's K/V,
  refcounted and LRU-evicted; a hit copies the blocks into the slot.
- ``PagedKVPool`` (the paged engine): refcounts over one device-resident
  page pool shared by generation and prefix KV; a hit is a refcount bump,
  no copy.

Lifecycle: ``match``/``insert`` and ``alloc``/``match_pages`` leave the
caller holding one ref per block or page, which it releases when the
request leaves the engine. ``close()`` drops everything regardless of
refcounts. The JAX package's metrics gauges are not ported; the counters
``stats()`` returns are.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch.utils.config import config

# Pools not yet closed in this process, for unload accounting and tests.
_POOLS: Dict[int, Any] = {}
_POOLS_LOCK = threading.Lock()


def hash_blocks(tokens: Sequence[int], block_tokens: int) -> List[str]:
    """Chained content digests of the prompt's FULL blocks:
    digest_i = blake2b(digest_{i-1} || int32 tokens of block i), so two
    prompts share digest_i iff they share their first i+1 blocks. Pure
    content (no pid or seed), so every process agrees, the JAX package's
    included. The trailing partial block is never hashed."""
    n_full = len(tokens) // block_tokens
    if n_full <= 0:
        return []
    arr = np.asarray(tokens[: n_full * block_tokens], dtype=np.int32)
    out: List[str] = []
    parent = b""
    for i in range(n_full):
        h = hashlib.blake2b(digest_size=16)
        h.update(parent)
        h.update(arr[i * block_tokens : (i + 1) * block_tokens].tobytes())
        parent = h.digest()
        out.append(parent.hex())
    return out


class _Block:
    __slots__ = ("digest", "k", "v", "refs", "tick")

    def __init__(self, digest: str, k: np.ndarray, v: np.ndarray):
        self.digest = digest
        self.k = k  # [L, B, H, Dh] host copy (f32)
        self.v = v
        self.refs = 0
        self.tick = 0


class BlockPool:
    """Refcounted, LRU-evicted pool of host prefix KV blocks for one engine."""

    def __init__(self, model_id: str, block_tokens: Optional[int] = None,
                 max_blocks: Optional[int] = None):
        self.model_id = model_id
        self.block_tokens = int(block_tokens or config.serve_prefix_block_tokens)
        self.max_blocks = int(max_blocks or config.serve_prefix_pool_blocks)
        self._lock = threading.Lock()
        self._blocks: Dict[str, _Block] = {}
        self._tick = 0
        self._closed = False
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        with _POOLS_LOCK:
            _POOLS[id(self)] = self

    def match(self, digests: Sequence[str], max_tokens: int
              ) -> Tuple[List[str], List[np.ndarray], List[np.ndarray]]:
        """Longest resident chain prefix of ``digests``, capped so at most
        ``max_tokens`` tokens come from cache (the engine keeps one prompt
        token to prefill: it gives the first token's logits). Increfs every
        matched block; the caller must release()."""
        cap = max(0, int(max_tokens)) // self.block_tokens
        held: List[str] = []
        ks: List[np.ndarray] = []
        vs: List[np.ndarray] = []
        with self._lock:
            if not self._closed:
                for d in digests[:cap]:
                    blk = self._blocks.get(d)
                    if blk is None:
                        break
                    blk.refs += 1
                    self._tick += 1
                    blk.tick = self._tick
                    held.append(d)
                    ks.append(blk.k)
                    vs.append(blk.v)
            self.hits += len(held)
            self.misses += len(digests) - len(held)
        return held, ks, vs

    def insert(self, digest: str, k: np.ndarray, v: np.ndarray) -> None:
        """Park one block's host K/V [L, B, H, Dh]; a block already resident
        is only touched. The caller holds one ref either way until
        release()."""
        with self._lock:
            if self._closed:
                return
            blk = self._blocks.get(digest)
            if blk is None:
                blk = _Block(digest, k, v)
                self._blocks[digest] = blk
            blk.refs += 1
            self._tick += 1
            blk.tick = self._tick
            self._evict_locked()

    def release(self, digests: Sequence[str]) -> None:
        """Drop the caller's refs; refcount-0 blocks stay resident (that
        residency is the cache) and become LRU-evictable."""
        if not digests:
            return
        with self._lock:
            for d in digests:
                blk = self._blocks.get(d)
                if blk is not None and blk.refs > 0:
                    blk.refs -= 1
            self._evict_locked()

    def _evict_locked(self) -> None:
        while len(self._blocks) > self.max_blocks:
            victim = None
            for blk in self._blocks.values():
                if blk.refs == 0 and (victim is None or blk.tick < victim.tick):
                    victim = blk
            if victim is None:
                return  # everything pinned by in-flight requests
            del self._blocks[victim.digest]
            self.evictions += 1

    def resident(self) -> int:
        with self._lock:
            return len(self._blocks)

    def ref_count(self, digest: str) -> int:
        with self._lock:
            blk = self._blocks.get(digest)
            return blk.refs if blk is not None else 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "blocks": len(self._blocks),
                "block_tokens": self.block_tokens,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }

    def close(self) -> None:
        """Drop every block regardless of refs (engine unload): the refs die
        with the engine's slots."""
        with self._lock:
            self._blocks.clear()
            self._closed = True
        with _POOLS_LOCK:
            _POOLS.pop(id(self), None)


class _Page:
    """Metadata of one device-resident KV page (its K/V lives in the engine's
    paged cache, ``gpt2_decode.init_paged_cache`` page ``idx``)."""

    __slots__ = ("idx", "refs", "digest", "tick")

    def __init__(self, idx: int):
        self.idx = idx
        self.refs = 0
        self.digest: Optional[str] = None  # set when sealed as a prefix block
        self.tick = 0


class PagedKVPool:
    """Refcounted allocator over one device-resident page pool shared by
    generation KV and prefix KV. It holds no tensors: a prefix hit is a
    refcount bump on pages already in the device cache.

    Page 0 is scratch and never allocated: inactive decode rows write their
    junk K/V there. ``alloc`` returns pages with one ref each; ``seal``
    registers a written page under its chain digest so ``match_pages`` can
    pin it too; ``release_pages`` drops refs. A ref-0 unsealed page goes
    back to the free list; a ref-0 sealed page stays resident as cache and
    is reclaimed, least recently matched first, only when ``alloc`` runs
    dry."""

    def __init__(self, model_id: str, num_pages: int, page_tokens: Optional[int] = None):
        self.model_id = model_id
        self.page_tokens = int(page_tokens or config.serve_prefix_block_tokens)
        self.num_pages = int(num_pages)
        if self.num_pages < 2:
            raise ValueError("paged pool needs >= 2 pages (page 0 is scratch)")
        self._lock = threading.Lock()
        self._pages: List[_Page] = [_Page(i) for i in range(self.num_pages)]
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))  # page 0 never
        self._sealed: Dict[str, int] = {}  # digest -> page
        self._tick = 0
        self._closed = False
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # block copies made at admission (KV-import page writes, counted by
        # the engine); a prefix hit adds none
        self.copies = 0
        with _POOLS_LOCK:
            _POOLS[id(self)] = self

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages with one ref each, evicting least recently used ref-0
        sealed pages when the free list runs dry. None, taking nothing, when
        even eviction cannot cover the ask."""
        if n <= 0:
            return []
        with self._lock:
            if self._closed:
                return None
            while len(self._free) < n and self._evict_one_locked():
                pass
            if len(self._free) < n:
                return None
            out = [self._free.pop() for _ in range(n)]
            for idx in out:
                pg = self._pages[idx]
                pg.refs = 1
                pg.digest = None
                self._tick += 1
                pg.tick = self._tick
            return out

    def _evict_one_locked(self) -> bool:
        victim: Optional[_Page] = None
        for idx in self._sealed.values():
            pg = self._pages[idx]
            if pg.refs == 0 and (victim is None or pg.tick < victim.tick):
                victim = pg
        if victim is None:
            return False  # every sealed page pinned by a live request
        del self._sealed[victim.digest]
        victim.digest = None
        self._free.append(victim.idx)
        self.evictions += 1
        return True

    def match_pages(self, digests: Sequence[str], max_tokens: int
                    ) -> Tuple[List[str], List[int]]:
        """Longest resident chain prefix of ``digests``, capped at
        ``max_tokens`` tokens. Increfs every matched page; the caller must
        release_pages(). The pages go straight into the page table."""
        cap = max(0, int(max_tokens)) // self.page_tokens
        held: List[str] = []
        pages: List[int] = []
        with self._lock:
            if not self._closed:
                for d in digests[:cap]:
                    idx = self._sealed.get(d)
                    if idx is None:
                        break
                    pg = self._pages[idx]
                    pg.refs += 1
                    self._tick += 1
                    pg.tick = self._tick
                    held.append(d)
                    pages.append(idx)
            self.hits += len(held)
            self.misses += len(digests) - len(held)
        return held, pages

    def seal(self, digest: str, page: int) -> bool:
        """Register a written page as the prefix block ``digest``, with no
        copy. False (the page stays private) when the digest is sealed
        already: racing requests converge on one page."""
        with self._lock:
            if self._closed or digest in self._sealed:
                return False
            pg = self._pages[page]
            pg.digest = digest
            self._sealed[digest] = page
            self._tick += 1
            pg.tick = self._tick
            return True

    def release_pages(self, pages: Sequence[int]) -> None:
        """Drop the caller's pins. Ref-0 unsealed pages return to the free
        list; ref-0 sealed pages stay resident (LRU-evictable)."""
        if not pages:
            return
        with self._lock:
            for idx in pages:
                pg = self._pages[idx]
                if pg.refs > 0:
                    pg.refs -= 1
                if pg.refs == 0 and pg.digest is None and not self._closed:
                    self._free.append(idx)

    def reset(self) -> None:
        """Drop all metadata: the engine rebuilt its device cache after a
        failed round, so no sealed page's content survives."""
        with self._lock:
            if self._closed:
                return
            for pg in self._pages:
                pg.refs = 0
                pg.digest = None
                pg.tick = 0
            self._sealed.clear()
            self._free = list(range(self.num_pages - 1, 0, -1))
            self._tick = 0

    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def resident(self) -> int:
        """Sealed prefix pages resident (BlockPool's name)."""
        with self._lock:
            return len(self._sealed)

    def ref_count(self, digest: str) -> int:
        with self._lock:
            idx = self._sealed.get(digest)
            return self._pages[idx].refs if idx is not None else 0

    def page_refs(self, page: int) -> int:
        with self._lock:
            return self._pages[page].refs

    def stats(self) -> Dict[str, int]:
        with self._lock:
            free = len(self._free)
            return {
                "blocks": len(self._sealed),
                "block_tokens": self.page_tokens,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "copies": self.copies,
                "pages_total": self.num_pages - 1,  # scratch excluded
                "pages_free": free,
                "pages_occupied": self.num_pages - 1 - free,
                "prefix_resident": len(self._sealed),
            }

    def close(self) -> None:
        """Drop everything regardless of refs (engine unload)."""
        with self._lock:
            for pg in self._pages:
                pg.refs = 0
                pg.digest = None
            self._sealed.clear()
            self._free = []
            self._closed = True
        with _POOLS_LOCK:
            _POOLS.pop(id(self), None)


def live_pools() -> List[Any]:
    """Pools not yet close()d in this process (test and debug hook)."""
    with _POOLS_LOCK:
        return list(_POOLS.values())

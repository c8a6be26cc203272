"""The port's copy of the prefix and page pools (ray_tpu_torch/serve/
prefix_cache.py) held to the JAX package's pool contracts
(tests/test_prefix_cache.py and tests/test_paged_kv.py), and its chain
digests to the JAX package's, digest for digest. Host code only."""

import json
import subprocess
import sys

import numpy as np
import pytest

from ray_tpu.serve import prefix_cache as jpc
from ray_tpu_torch.serve import prefix_cache as tpc
from ray_tpu_torch.serve.prefix_cache import BlockPool, PagedKVPool, hash_blocks


# -- chain hashing ----------------------------------------------------------


@pytest.mark.parametrize("n,block", [(0, 4), (3, 4), (10, 4), (8, 4), (200, 64), (1000, 64),
                                     (127, 16)])
def test_hash_blocks_equal_the_jax_packages(n, block):
    tokens = [int(t) for t in np.random.RandomState(n).randint(0, 50257, n)]
    assert hash_blocks(tokens, block) == jpc.hash_blocks(tokens, block)


def test_hash_blocks_only_full_blocks():
    assert hash_blocks([], 4) == []
    assert hash_blocks([1, 2, 3], 4) == []
    assert len(hash_blocks(list(range(10)), 4)) == 2
    assert len(hash_blocks(list(range(8)), 4)) == 2


def test_hash_blocks_chain_prefix_property():
    a = hash_blocks([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12], 4)
    b = hash_blocks([1, 2, 3, 4, 5, 6, 7, 8, 99, 99, 99, 99], 4)
    assert a[:2] == b[:2] and a[2] != b[2]
    c = hash_blocks([9, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12], 4)
    assert all(x != y for x, y in zip(a, c))


def test_hash_blocks_deterministic_across_processes():
    tokens = [int(t) for t in np.random.RandomState(3).randint(0, 256, 200)]
    prog = ("import json, sys; from ray_tpu_torch.serve.prefix_cache import hash_blocks; "
            "print(json.dumps(hash_blocks(json.loads(sys.argv[1]), 64)))")
    out = subprocess.run([sys.executable, "-c", prog, json.dumps(tokens)],
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout) == hash_blocks(tokens, 64)


# -- BlockPool (tests/test_prefix_cache.py:64-130) ---------------------------


def _blk(i):
    k = np.full((2, 4, 2, 2), i, np.float32)
    return k, -k


def test_pool_match_increfs_and_caps():
    pool = BlockPool("m", block_tokens=4, max_blocks=8)
    for d in ("a", "b"):
        pool.insert(d, *_blk(1))
    pool.release(["a", "b"])
    held, ks, vs = pool.match(["a", "b", "x"], max_tokens=100)
    assert held == ["a", "b"] and len(ks) == 2
    assert pool.ref_count("a") == pool.ref_count("b") == 1
    held2, _, _ = pool.match(["a", "x", "b"], max_tokens=100)  # stops at the first miss
    assert held2 == ["a"] and pool.ref_count("a") == 2
    assert pool.match(["a"], max_tokens=3)[0] == []  # cap below one block
    pool.release(["a", "b"])
    pool.release(["a"])
    assert pool.ref_count("a") == 0
    st = pool.stats()
    assert st["hits"] == 3 and st["misses"] == 4
    pool.close()


def test_pool_lru_eviction_prefers_oldest_unreferenced():
    pool = BlockPool("m", block_tokens=4, max_blocks=2)
    for d in ("a", "b"):
        pool.insert(d, *_blk(1))
    pool.release(["a", "b"])
    pool.match(["b"], max_tokens=100)  # touch b: a is now LRU
    pool.release(["b"])
    pool.insert("c", *_blk(2))
    assert pool.resident() == 2
    assert pool.ref_count("a") == 0 and pool.match(["a"], 100)[0] == []
    assert pool.match(["b"], 100)[0] == ["b"]
    assert pool.stats()["evictions"] == 1
    pool.close()


def test_pool_pinned_blocks_survive_overflow():
    pool = BlockPool("m", block_tokens=4, max_blocks=2)
    for d in ("a", "b", "c", "d"):
        pool.insert(d, *_blk(1))
    assert pool.resident() == 4 and pool.stats()["evictions"] == 0
    pool.release(["a", "b", "c", "d"])
    assert pool.resident() == 2  # back to capacity, LRU first
    assert pool.match(["d"], 100)[0] == ["d"]
    pool.close()


def test_pool_close_drops_everything_despite_refs():
    pool = BlockPool("m", block_tokens=4, max_blocks=8)
    pool.insert("a", *_blk(1))
    assert pool in tpc.live_pools()
    pool.close()
    assert pool.resident() == 0 and pool not in tpc.live_pools()
    pool.insert("b", *_blk(2))
    assert pool.resident() == 0 and pool.match(["a"], 100)[0] == []


def test_pools_take_their_defaults_from_the_ports_flags():
    pool = BlockPool("m")
    assert (pool.block_tokens, pool.max_blocks) == (64, 512)
    pool.close()
    pool = PagedKVPool("m", num_pages=3)
    assert pool.page_tokens == 64
    pool.close()


# -- PagedKVPool (tests/test_paged_kv.py:27-98) ------------------------------


def test_pool_scratch_page_never_allocated():
    pool = PagedKVPool("m", num_pages=5, page_tokens=4)
    got = pool.alloc(4)
    assert sorted(got) == [1, 2, 3, 4]
    assert pool.alloc(1) is None
    pool.release_pages(got)
    assert pool.free_pages() == 4
    with pytest.raises(ValueError):
        PagedKVPool("m", num_pages=1, page_tokens=4)
    pool.close()


def test_pool_alloc_is_all_or_nothing():
    pool = PagedKVPool("m", num_pages=4, page_tokens=4)
    held = pool.alloc(2)
    assert pool.alloc(2) is None
    assert pool.free_pages() == 1
    assert pool.alloc(0) == []
    pool.release_pages(held)
    pool.close()


def test_pool_seal_match_is_zero_copy_refcount():
    pool = PagedKVPool("m", num_pages=4, page_tokens=4)
    (pg,) = pool.alloc(1)
    assert pool.seal("d1", pg) is True
    (other,) = pool.alloc(1)
    assert pool.seal("d1", other) is False  # the racing seal loses
    pool.release_pages([other])
    assert pool.free_pages() == 2
    pool.release_pages([pg])
    assert pool.resident() == 1 and pool.free_pages() == 2
    held, pages = pool.match_pages(["d1"], max_tokens=100)
    assert held == ["d1"] and pages == [pg]
    assert pool.ref_count("d1") == 1 and pool.page_refs(pg) == 1
    assert pool.stats()["copies"] == 0
    assert pool.match_pages(["d1"], max_tokens=3) == ([], [])
    pool.release_pages(pages)
    pool.close()


def test_pool_lru_evicts_only_unpinned_sealed():
    pool = PagedKVPool("m", num_pages=3, page_tokens=4)
    a, b = pool.alloc(2)
    pool.seal("a", a)
    pool.seal("b", b)
    pool.release_pages([b])
    (c,) = pool.alloc(1)  # free list dry: evicts b, never the pinned a
    assert c == b and pool.stats()["evictions"] == 1
    assert pool.match_pages(["b"], 100) == ([], [])
    assert pool.ref_count("a") == 1
    assert pool.alloc(1) is None
    pool.release_pages([a, c])
    pool.close()


def test_pool_reset_and_close_drop_everything():
    pool = PagedKVPool("m", num_pages=4, page_tokens=4)
    pgs = pool.alloc(2)
    pool.seal("x", pgs[0])
    pool.reset()
    assert pool.free_pages() == 3 and pool.resident() == 0
    assert pool.match_pages(["x"], 100) == ([], [])
    pgs = pool.alloc(3)
    pool.close()
    assert pool.alloc(1) is None
    pool.release_pages(pgs)  # after close: a no-op
    assert pool.free_pages() == 0


def test_paged_pool_stats_match_the_jax_pools_on_one_script():
    """The same calls on both packages' pools give the same stats at every
    step (the JAX pool's metrics gauges aside)."""
    pools = [jpc.PagedKVPool("m", num_pages=6, page_tokens=4),
             PagedKVPool("m", num_pages=6, page_tokens=4)]
    digests = hash_blocks(list(range(16)), 4)

    def script(pool):
        out = []
        a = pool.alloc(3)
        for d, p in zip(digests, a):
            pool.seal(d, p)
        out.append(pool.stats())
        pool.release_pages(a)
        _, hit = pool.match_pages(digests, max_tokens=11)
        out.append(pool.stats())
        b = pool.alloc(4)  # evicts the one unpinned sealed page
        out.append((pool.stats(), hit, b))
        pool.release_pages(hit + (b or []))
        out.append(pool.stats())
        return out

    assert script(pools[0]) == script(pools[1])
    for pool in pools:
        pool.close()

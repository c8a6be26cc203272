"""The port's LLM engine (ray_tpu_torch/serve/llm.py) and prefill tier
(serve/kv_transfer.py) on the CPU, at gpt2-tiny.

The JAX engine's contracts (tests/test_paged_kv.py:139-300,
tests/test_prefix_cache.py, tests/test_async_decode.py), re-run within the
port at temperature 0: paged vs slot engine, prefix hit vs cold with the
copy counter unchanged, chunked vs unchunked prefill, async vs sync (unary
and streaming), a disaggregated import vs monolithic with copies going up
by 2 and then by 1, pages released exactly once under cancel and unload,
admission deferred under page pressure and oversize requests failed. At
temperature > 0 the sync and async engines draw the same tokens (a step's
draw depends on its step number, not on the draws before it). And one
cross-check: the port's greedy streams equal the JAX ``LLMServer``'s in
f32 on the same numpy checkpoint.
"""

import collections
import dataclasses
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.models import gpt2_decode
from ray_tpu_torch.serve import prefix_cache
from ray_tpu_torch.serve.kv_transfer import PrefillEngine, channel_capacity
from ray_tpu_torch.serve.llm import LLMConfig, LLMServer
from ray_tpu_torch.utils.config import config


def _mk(paged=True, async_on=True, batch=4, **kw):
    return LLMServer(LLMConfig(model_id="gpt2-tiny", max_batch_size=batch, paged_kv=paged,
                               async_decode=async_on, device="cpu", **kw))


def _stop(srv):
    srv.unload()
    srv._thread.join(timeout=30)
    assert not srv._thread.is_alive()


@pytest.fixture(scope="module")
def engines():
    """(paged, async) -> server, all four variants, stopped at teardown."""
    servers = {(p, a): _mk(p, a) for p in (True, False) for a in (True, False)}
    yield servers
    for srv in servers.values():
        _stop(srv)


def _req(prompt, max_new=8, **extra):
    return {"prompt_tokens": prompt, "max_new_tokens": max_new, "temperature": 0.0, **extra}


def _prompt(seed, n):
    return [int(t) for t in np.random.RandomState(seed).randint(0, 256, n)]


# -- engine equivalences -----------------------------------------------------


def test_paged_vs_slot_bitwise(engines):
    for n in (10, 64, 100, 127):
        prompt = _prompt(31 + n, n)
        paged = engines[(True, True)](_req(prompt))["tokens"]
        slot = engines[(False, True)](_req(prompt))["tokens"]
        assert paged == slot, f"paged != slot at prompt len {n}"
        # a prompt filling the window leaves room for T_max - n tokens
        assert len(paged) == min(8, 128 - n) and all(0 <= t < 256 for t in paged)


def test_prefix_hit_is_bitwise_and_copies_nothing(engines):
    srv = engines[(True, True)]
    pool = srv._prefix_pool
    prompt = _prompt(32, 100)
    c0, h0 = pool.stats()["copies"], pool.stats()["hits"]
    cold = srv(_req(prompt))["tokens"]
    hot = srv(_req(prompt))["tokens"]
    st = pool.stats()
    assert hot == cold
    assert st["hits"] > h0 and st["copies"] == c0


@pytest.mark.parametrize("n", [100, 128, 65])
def test_slot_engine_cached_vs_cold_bitwise(engines, n):
    """The slot engine's host block pool: a hit (blocks copied in, the tail
    prefilled) generates the cold tokens, and so does the cache turned off."""
    srv = engines[(False, False)]
    pool = srv._prefix_pool
    prompt = _prompt(11 + n, n)
    h0 = pool.stats()["hits"]
    cold = srv(_req(prompt))["tokens"]
    hot = srv(_req(prompt))["tokens"]
    assert hot == cold and pool.stats()["hits"] > h0
    config.set("serve_prefix_cache", False)
    try:
        assert srv(_req(prompt))["tokens"] == cold
    finally:
        config.set("serve_prefix_cache", True)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_refcounts_drain_under_churn(engines, paged):
    srv = engines[(paged, True)]
    shared = _prompt(12, 64)
    solo = {i: srv(_req(shared + [i, i + 1], max_new=6))["tokens"] for i in range(4)}
    results = [None] * 4

    def call(i):
        results[i] = srv(_req(shared + [i, i + 1], max_new=6))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert [r["tokens"] for r in results] == [solo[i] for i in range(4)]
    pool = srv._prefix_pool
    assert pool.resident() > 0
    with pool._lock:
        refs = ([p.refs for p in pool._pages] if paged
                else [b.refs for b in pool._blocks.values()])
    assert not any(refs), refs


def test_chunked_vs_unchunked_prefill_bitwise(engines):
    srv = engines[(True, True)]
    prompt = _prompt(33, 100)
    config.set("serve_prefix_cache", False)
    try:
        config.set("serve_prefill_chunk_tokens", 16)
        chunked = srv(_req(prompt))["tokens"]
        config.set("serve_prefill_chunk_tokens", 0)
        unchunked = srv(_req(prompt))["tokens"]
    finally:
        config.set("serve_prefill_chunk_tokens", 512)
        config.set("serve_prefix_cache", True)
    assert chunked == unchunked


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_async_vs_sync_unary_bitwise(engines, paged):
    for n in (10, 64, 127):
        prompt = _prompt(41 + n, n)
        a = engines[(paged, True)](_req(prompt, max_new=24))["tokens"]
        s = engines[(paged, False)](_req(prompt, max_new=24))["tokens"]
        assert a == s, f"async != sync (paged={paged}, prompt len {n})"


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_async_vs_sync_stream_bitwise(engines, paged):
    prompt = _prompt(42, 33)

    def collect(srv):
        return [ev["token"] for ev in srv(_req(prompt, max_new=24, stream=True))]

    a = collect(engines[(paged, True)])
    s = collect(engines[(paged, False)])
    u = engines[(paged, True)](_req(prompt, max_new=24))["tokens"]
    assert a == s == u and len(a) == 24


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_async_vs_sync_sampled_streams_equal(paged):
    """Temperature 0.8: fresh sync and async engines given the same requests
    in the same order draw the same tokens, since each step's generator
    comes from its step number."""
    pair = [_mk(paged, a) for a in (True, False)]
    try:
        outs = []
        for srv in pair:
            outs.append([srv({"prompt_tokens": _prompt(50 + i, 20 + 9 * i), "max_new_tokens": 12,
                              "temperature": 0.8})["tokens"] for i in range(3)])
        assert outs[0] == outs[1]
        assert len({tuple(t) for t in outs[0]}) == 3
    finally:
        for srv in pair:
            _stop(srv)


def test_disagg_import_matches_monolithic_and_seals(engines):
    """The paged prefill tier ships the same KV twice; the decode engine
    imports it to the monolithic answer; the second import matches the full
    block the first one sealed and writes only the tail page. The slot
    prefill tier ships the same first token and KV to bf16 rounding."""
    prompt = _prompt(34, 100)
    pre = PrefillEngine(LLMConfig(model_id="gpt2-tiny", paged_kv=True, device="cpu"))
    try:
        ship1 = pre.prefill(prompt, 0.0)
        ship2 = pre.prefill(prompt, 0.0)
        assert ship2["cached_tokens"] == 64 and pre.batch_stats()["prefix"]["hits"] == 1
    finally:
        pre.unload()
    assert ship1["first_token"] == ship2["first_token"]
    assert ship1["k"].dtype == np.float32 and ship1["k"].shape == (2, 100, 4, 16)
    np.testing.assert_array_equal(ship1["k"], ship2["k"])
    np.testing.assert_array_equal(ship1["v"], ship2["v"])

    srv = engines[(True, True)]
    pool = srv._prefix_pool
    c0 = pool.stats()["copies"]
    imp = {k: ship1[k] for k in ("k", "v", "first_token", "prompt_len", "cached_tokens")}
    out1 = srv(_req(prompt, kv_import=dict(imp)))["tokens"]
    c1 = pool.stats()["copies"]
    out2 = srv(_req(prompt, kv_import=dict(imp)))["tokens"]
    c2 = pool.stats()["copies"]
    mono = srv(_req(prompt))["tokens"]
    assert out1 == out2 == mono
    # 100 tokens = one full block and a 36-token tail: the cold import
    # writes both pages, the repeat matches the sealed block and writes
    # only the tail page
    assert (c1 - c0, c2 - c1) == (2, 1)

    slot_pre = PrefillEngine(LLMConfig(model_id="gpt2-tiny", paged_kv=False, device="cpu"))
    try:
        ship_s = slot_pre.prefill(prompt, 0.0)
        again = slot_pre.prefill(prompt, 0.0)  # from the host block pool
    finally:
        slot_pre.unload()
    assert ship_s["first_token"] == ship1["first_token"] == again["first_token"]
    assert again["cached_tokens"] == 64
    # paged (chunk over the virtual row) and slot (prompt only) attention
    # differ in bf16 rounding: within two bf16 ulps of values near 1
    np.testing.assert_allclose(ship_s["k"], ship1["k"], rtol=1.6e-2, atol=8e-3)
    assert engines[(False, True)](_req(prompt, kv_import=dict(ship_s)))["tokens"] == mono


def test_page_admission_defers_under_pressure_and_fails_oversize():
    """Two usable pages: two 2-page requests cannot coexist, so the second
    defers and completes after the first frees its pages; with one usable
    page a 2-page request fails at once instead of waiting forever."""
    config.set("serve_kv_pool_pages", 2)
    try:
        srv = _mk()
    finally:
        config.set("serve_kv_pool_pages", 0)
    try:
        prompts = {"a": _prompt(35, 70), "b": _prompt(36, 70)}
        results = {}

        def call(key):
            results[key] = srv(_req(prompts[key]))["tokens"]

        threads = [threading.Thread(target=call, args=(k,)) for k in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert set(results) == {"a", "b"} and all(len(v) == 8 for v in results.values())
    finally:
        _stop(srv)
    config.set("serve_kv_pool_pages", 1)
    try:
        tiny = _mk()
    finally:
        config.set("serve_kv_pool_pages", 0)
    try:
        assert len(tiny(_req([2] * 40, max_new=8))["tokens"]) == 8
        with pytest.raises(RuntimeError, match="KV pages"):
            tiny(_req([1] * 70))
    finally:
        _stop(tiny)


def test_pages_released_exactly_once_under_cancel_and_unload():
    srv = _mk()
    pool = srv._prefix_pool
    handout, returned = collections.Counter(), collections.Counter()
    orig_alloc, orig_match, orig_release = pool.alloc, pool.match_pages, pool.release_pages

    def spy_alloc(n):
        out = orig_alloc(n)
        if out:
            handout.update(out)
        return out

    def spy_match(digests, max_tokens):
        held, pages = orig_match(digests, max_tokens)
        handout.update(pages)
        return held, pages

    def spy_release(pages):
        returned.update(pages)
        orig_release(pages)

    pool.alloc, pool.match_pages, pool.release_pages = spy_alloc, spy_match, spy_release
    try:
        prompt = _prompt(36, 70)
        gen = srv(_req(prompt, max_new=64, stream=True))
        it = iter(gen)
        next(it)
        next(it)  # the sequence is decoding
        gen.close()  # the client goes away
        assert len(srv(_req(prompt[:10], max_new=4))["tokens"]) == 4
        with pool._lock:
            free = list(pool._free)
            pinned = {p.idx: p.refs for p in pool._pages if p.refs}
        assert len(free) == len(set(free)), free
        assert not pinned, pinned
        st = pool.stats()
        assert st["pages_free"] + st["pages_occupied"] == st["pages_total"]
        assert st["pages_occupied"] == st["prefix_resident"]
        # a request in flight when unload lands fails, and releases nothing twice
        inflight = srv(_req(prompt, max_new=100, stream=True))
        next(iter(inflight))
    finally:
        _stop(srv)
    with pytest.raises(RuntimeError, match="unloaded"):
        list(inflight)
    assert pool not in prefix_cache.live_pools()
    for page, n in returned.items():
        assert n <= handout[page], f"page {page} released {n}x, handed out {handout[page]}x"


def test_mid_lookahead_cancel_returns_pages(engines):
    srv = engines[(True, True)]
    pool = srv._prefix_pool
    idle_occ = pool.stats()["pages_occupied"]
    gen = srv(_req([7] * 40, max_new=100, stream=True))
    assert len([next(gen)["token"] for _ in range(3)]) == 3
    gen.close()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if srv.batch_stats()["occupied"] == 0 and pool.stats()["pages_occupied"] <= idle_occ:
            break
        time.sleep(0.05)
    assert srv.batch_stats()["occupied"] == 0
    assert pool.stats()["pages_occupied"] <= idle_occ, pool.stats()
    assert len(srv(_req([7] * 40, max_new=4))["tokens"]) == 4


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_mid_lookahead_exception_fails_and_recovers(monkeypatch, paged):
    srv = _mk(paged=paged)
    try:
        srv(_req([3] * 20, max_new=4))
        names = (("decode_multi_paged", "decode_paged_and_sample") if paged
                 else ("decode_multi", "decode_and_sample"))
        real = {n: getattr(gpt2_decode, n) for n in names}
        calls = {"n": 0}

        def poison(fn):
            def wrapped(*a, **kw):
                calls["n"] += 1
                if calls["n"] >= 2:  # the first chunk goes out clean
                    raise RuntimeError("injected decode fault")
                return fn(*a, **kw)
            return wrapped

        for n, fn in real.items():
            monkeypatch.setattr(gpt2_decode, n, poison(fn))
        with pytest.raises(RuntimeError, match="injected decode fault"):
            srv(_req([3] * 20, max_new=16))
        for n, fn in real.items():
            monkeypatch.setattr(gpt2_decode, n, fn)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and srv.batch_stats()["occupied"]:
            time.sleep(0.05)
        if paged:
            assert srv._prefix_pool.stats()["pages_occupied"] == 0  # the pool was reset
        assert len(srv(_req([3] * 20, max_new=4))["tokens"]) == 4
    finally:
        _stop(srv)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_idle_arrival_ttft_no_half_second_mode(engines, paged):
    srv = engines[(paged, True)]
    srv(_req([11] * 12, max_new=2))
    lat = []
    for _ in range(6):
        time.sleep(0.12)  # the engine reaches its idle wait
        t0 = time.monotonic()
        srv(_req([11] * 12, max_new=2))
        lat.append(time.monotonic() - t0)
    assert max(lat) < 0.45, sorted(lat)
    ttft = srv.batch_stats()["ttft_s"]
    assert ttft["n"] >= 7 and 0 < ttft["p50"] <= ttft["p95"] < 0.45


def test_concurrent_streams_all_complete(engines):
    srv = engines[(True, True)]
    out = {}

    def run(tag, n, m):
        out[tag] = [ev["token"] for ev in srv(_req([tag] * n, max_new=m, stream=True))]

    ts = [threading.Thread(target=run, args=(17 + j, 10 + 7 * j, 6 + 5 * j)) for j in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert sorted(len(v) for v in out.values()) == [6, 11, 16]


def test_chunked_prefill_keeps_live_stream_producing(monkeypatch):
    """While a 900-token prompt prefills in 64-token chunks, a stream that is
    already decoding keeps producing tokens."""
    monkeypatch.setitem(tg.CONFIGS, "gpt2-tiny-long", dataclasses.replace(
        tg.CONFIGS["gpt2-tiny"], n_positions=1024))
    config.set("serve_prefill_chunk_tokens", 64)
    srv = None
    try:
        srv = LLMServer(LLMConfig(model_id="gpt2-tiny-long", max_batch_size=4, device="cpu"))
        it = iter(srv(_req(_prompt(37, 16), max_new=64, stream=True)))
        next(it)
        done = threading.Event()
        res = {}

        def call_long():
            res["out"] = srv(_req(_prompt(38, 900), max_new=4))
            done.set()

        threading.Thread(target=call_long, daemon=True).start()
        during = 0
        while not done.is_set() and next(it, None) is not None:
            during += 1
        it.close()
        assert done.wait(120) and len(res["out"]["tokens"]) == 4
        assert during >= 3, f"stream produced {during} tokens"
    finally:
        config.set("serve_prefill_chunk_tokens", 512)
        if srv is not None:
            _stop(srv)


# -- the request surface -------------------------------------------------------


def test_request_shapes(engines):
    srv = engines[(True, True)]
    assert srv(_req([1, 2, 3], max_new=0))["tokens"] == []
    assert srv(_req([1, 2, 3], max_new=1))["tokens"] == srv(_req([1, 2, 3], max_new=5))["tokens"][:1]
    assert list(srv(_req([1, 2, 3], max_new=0, stream=True))) == []
    assert len(srv(_req([4], max_new=10_000))["tokens"]) == 127  # T_max - prompt

    class HttpRequest:  # the shape the HTTP proxy hands a deployment
        query = {"stream": "1"}

        def json(self):
            return _req([1, 2, 3], max_new=3)

    assert [ev["index"] for ev in srv(HttpRequest())] == [0, 1, 2]
    st = srv.batch_stats()
    assert st["batches"] > 0 and st["prefix"]["pages_total"] == 4 * 2
    assert channel_capacity(tg.CONFIGS["gpt2-tiny"]) == 2 * 2 * 128 * 64 * 4 + (1 << 20)


def test_recompute_engine_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LLMServer(LLMConfig(engine="recompute", device="cpu"))
    with pytest.raises(ValueError):
        LLMConfig(engine="bogus")


# -- the port's greedy streams against the JAX engine's ----------------------


@pytest.fixture(scope="module")
def f32_pair(tmp_path_factory, cpu_mesh_devices):
    """The JAX and the port's paged engines on one numpy checkpoint of the
    JAX gpt2.init, both with gpt2-tiny switched to f32 while they are
    built (each reads its config once, at construction)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jg
    from ray_tpu.serve.llm import LLMConfig as JaxLLMConfig
    from ray_tpu.serve.llm import LLMServer as JaxLLMServer

    path = tmp_path_factory.mktemp("ckpt") / "gpt2_tiny.pkl"
    params = jax.tree.map(np.asarray, jg.init(jax.random.PRNGKey(0), jg.CONFIGS["gpt2-tiny"]))
    with open(path, "wb") as f:
        pickle.dump(params, f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jg.CONFIGS, "gpt2-tiny",
                   dataclasses.replace(jg.CONFIGS["gpt2-tiny"], dtype=jnp.float32))
        mp.setitem(tg.CONFIGS, "gpt2-tiny",
                   dataclasses.replace(tg.CONFIGS["gpt2-tiny"], dtype=torch.float32))
        jax_srv = JaxLLMServer(JaxLLMConfig(model_id="gpt2-tiny", max_batch_size=4,
                                            checkpoint_path=str(path)))
        port_srv = LLMServer(LLMConfig(model_id="gpt2-tiny", max_batch_size=4,
                                       checkpoint_path=str(path), device="cpu"))
    yield jax_srv, port_srv
    jax_srv._stop.set()
    jax_srv._work.set()
    _stop(port_srv)


@pytest.mark.parametrize("n", [10, 64, 100, 127])
def test_greedy_streams_equal_the_jax_engines_in_f32(f32_pair, n):
    jax_srv, port_srv = f32_pair
    assert port_srv.model.wte.dtype == torch.float32
    assert port_srv.model_cfg.dtype == torch.float32
    prompt = _prompt(60 + n, n)
    want = jax_srv(_req(prompt, max_new=12))["tokens"]
    assert port_srv(_req(prompt, max_new=12))["tokens"] == want


def test_smoke_traffic():
    """chip_smoke.py's serving traffic: 24 requests of 64-896 tokens, 8
    sharing a 512-token prefix, 64 new tokens each, 4 at temperature 0.8 and
    2 streaming, the same at every call."""
    import chip_smoke

    reqs = chip_smoke.serving_traffic(50257)
    assert reqs == chip_smoke.serving_traffic(50257) and len(reqs) == 24
    lens = [len(r["prompt_tokens"]) for r in reqs]
    assert min(lens) >= 64 and max(lens) <= 896
    prefix = [r["prompt_tokens"][:512] for r in reqs]
    assert max(prefix.count(p) for p in prefix) == 8
    assert sorted(r["temperature"] for r in reqs) == [0.0] * 20 + [0.8] * 4
    assert sum(bool(r.get("stream")) for r in reqs) == 2
    assert all(r["max_new_tokens"] == 64 for r in reqs)

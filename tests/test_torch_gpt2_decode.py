"""The port's KV-cached decode functions against the JAX package's, on
gpt2-tiny.

Both sides get the JAX ``gpt2.init`` parameters (the port through numpy and
``from_jax``) and the same tokens from seeded numpy generators, and every
public function of ``ray_tpu/models/gpt2_decode.py`` is held to its twin in
``ray_tpu_torch/models/gpt2_decode.py``: logits, the cache rows written,
greedy tokens and the step-state updates. Each runs in f32 and in bf16
(``dataclasses.replace(cfg, dtype=...)``) with the tolerances below.
The JAX decode path runs no Pallas kernel.

Sampling at temperature > 0 cannot draw JAX's numbers; its own contract
(a step's draw depends on the seed, the step number and the logits only)
is tested here instead.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt2 as jg
from ray_tpu.models import gpt2_decode as jd
from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.models import gpt2_decode as td

# (rtol, atol). f32: the two frameworks sum in other orders; the gaps
# measured are below 2e-7 on logits and caches. bf16: both round at the same
# places, but matmuls, gelu and layernorm round their insides differently;
# measured at most 2.9e-3 on logits (of magnitude up to ~1) and one bf16 ulp
# (1.95e-3) on cache entries.
TOL = {
    "f32": {"logits": (1e-5, 1e-5), "cache": (1e-5, 1e-5)},
    "bf16": {"logits": (2e-2, 1e-2), "cache": (1.6e-2, 4e-3)},
}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
S, T_MAX = 3, 64  # slot cache
N_PAGES, PAGE = 7, 16  # paged cache: max_pages = n_positions / PAGE = 8


@pytest.fixture(scope="module")
def params_np(cpu_mesh_devices):
    params = jg.init(jax.random.PRNGKey(0), jg.CONFIGS["gpt2-tiny"])
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module", params=list(DTYPES))
def pair(request, params_np):
    """(dtype name, JAX cfg, JAX params, port cfg, port model)."""
    jdt, tdt = DTYPES[request.param]
    jcfg = dataclasses.replace(jg.CONFIGS["gpt2-tiny"], dtype=jdt)
    tcfg = dataclasses.replace(tg.CONFIGS["gpt2-tiny"], dtype=tdt)
    params = jax.tree.map(jnp.asarray, params_np)
    return request.param, jcfg, params, tcfg, tg.from_jax(params_np, tcfg, "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dt, kind, what=""):
    rtol, atol = TOL[dt][kind]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol, err_msg=what)


def _t(a):
    """numpy -> a torch tensor (integers as int64, the port's index type)."""
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a.copy())


def _prompt(seed, n, width):
    tok = np.zeros((1, width), np.int32)
    tok[0, :n] = np.random.default_rng(seed).integers(0, 256, n)
    return tok


def _slot_state(pair):
    """Both caches after prefill of a 12-token prompt (width 16) into slot
    1, a copy of its first 16 positions into slot 2 (write_prefix) and a
    5-token tail at position 16 of slot 2 (prefill_extend). Returns the
    logits of each call on both sides and the caches."""
    dt, jcfg, params, tcfg, model = pair
    jk, jv = jd.init_cache(jcfg, S, T_MAX)
    tk, tv = td.init_cache(tcfg, S, T_MAX, "cpu")
    out = {"jcache": None, "tcache": (tk, tv)}
    tok = _prompt(1, 12, 16)
    jl, jk, jv = jd.prefill(jcfg, params, jnp.asarray(tok), jnp.int32(12), jk, jv, jnp.int32(1))
    out["prefill"] = (jl, td.prefill(tcfg, model, _t(tok), 12, tk, tv, 1))
    pk, pv = np.array(jk[:, 1, :16], np.float32), np.array(jv[:, 1, :16], np.float32)
    jk, jv = jd.write_prefix(jnp.asarray(pk), jnp.asarray(pv), jk, jv, jnp.int32(2))
    td.write_prefix(_t(pk), _t(pv), tk, tv, 2)
    out["write_prefix"] = (np.array(jk, np.float32), tk.float().numpy().copy())
    tail = _prompt(2, 5, 16)
    jl, jk, jv = jd.prefill_extend(jcfg, params, jnp.asarray(tail), jnp.int32(16), jnp.int32(5),
                                   jk, jv, jnp.int32(2))
    out["prefill_extend"] = (jl, td.prefill_extend(tcfg, model, _t(tail), 16, 5, tk, tv, 2))
    out["jcache"] = (jk, jv)
    return out


def test_init_caches_match_jax(pair):
    dt, jcfg, _, tcfg, _ = pair
    for (j, _), (t, _) in [(jd.init_cache(jcfg, S, T_MAX), td.init_cache(tcfg, S, T_MAX, "cpu")),
                           (jd.init_paged_cache(jcfg, N_PAGES, PAGE),
                            td.init_paged_cache(tcfg, N_PAGES, PAGE, "cpu"))]:
        assert tuple(t.shape) == j.shape and t.dtype == tcfg.dtype
        assert not t.any()


def test_slot_prefill_write_prefix_extend_match_jax(pair):
    dt = pair[0]
    st = _slot_state(pair)
    _close(st["prefill"][1], st["prefill"][0], dt, "logits", "prefill logits")
    _close(st["write_prefix"][1], st["write_prefix"][0], dt, "cache", "write_prefix rows")
    _close(st["prefill_extend"][1], st["prefill_extend"][0], dt, "logits", "prefill_extend logits")
    for j, t, name in zip(st["jcache"], st["tcache"], "kv"):
        _close(t, j, dt, "cache", f"cache_{name}")
    assert st["prefill"][1].shape == (256,)


def test_decode_step_matches_jax(pair):
    """Three decode steps over slots 1 and 2 (slot 0 idle at length 0), fed
    the JAX argmax tokens on both sides so they stay in step."""
    dt, jcfg, params, tcfg, model = pair
    st = _slot_state(pair)
    jk, jv = st["jcache"]
    tk, tv = st["tcache"]
    last = np.array([0, int(np.argmax(_f32(st["prefill"][0]))),
                     int(np.argmax(_f32(st["prefill_extend"][0])))], np.int32)
    lens = np.array([0, 12, 21], np.int32)
    for step in range(3):
        jl, jk, jv = jd.decode_step(jcfg, params, jnp.asarray(last), jnp.asarray(lens), jk, jv)
        tl = td.decode_step(tcfg, model, _t(last), _t(lens), tk, tv)
        _close(tl, jl, dt, "logits", f"decode_step {step} logits")
        for j, t, name in zip((jk, jv), (tk, tv), "kv"):
            _close(t, j, dt, "cache", f"decode_step {step} cache_{name}")
        last = np.argmax(_f32(jl), -1).astype(np.int32)
        lens = lens + 1


def test_decode_and_sample_and_multi_match_jax(pair):
    """Greedy rows: decode_and_sample's token and the lengths it returns, and
    decode_multi's tokens over 6 steps, equal JAX's; so do the caches. Rows
    0 and 2 are greedy; row 1 samples at temperature 0.7 (its draws differ
    from JAX's by design, so only its token range is checked)."""
    dt, jcfg, params, tcfg, model = pair
    st = _slot_state(pair)
    jk, jv = st["jcache"]
    tk, tv = st["tcache"]
    last = np.array([5, int(np.argmax(_f32(st["prefill"][0]))),
                     int(np.argmax(_f32(st["prefill_extend"][0])))], np.int32)
    lens = np.array([3, 12, 21], np.int32)
    temps = np.array([1e-6, 0.7, 1e-6], np.float32)
    greedy = np.array([True, False, True])
    greedy_rows = [0, 2]
    jn, jlen, jk, jv = jd.decode_and_sample(jcfg, params, jnp.asarray(last), jnp.asarray(lens),
                                            jk, jv, jnp.asarray(temps), jnp.asarray(greedy),
                                            jax.random.PRNGKey(1), jnp.int32(1))
    tn, tlen = td.decode_and_sample(tcfg, model, _t(last), _t(lens), tk, tv, _t(temps),
                                    _t(greedy), 1, 1)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(tn.numpy()[greedy_rows], np.asarray(jn)[greedy_rows])
    assert 0 <= int(tn[1]) < 256
    # the sampled row goes on from JAX's token on both sides
    last = np.asarray(jn, np.int32)
    lens = np.asarray(jlen, np.int32)
    jt, jlast, jlen, jk, jv = jd.decode_multi(jcfg, params, jnp.asarray(last), jnp.asarray(lens),
                                              jk, jv, jnp.asarray(temps), jnp.asarray(greedy),
                                              jax.random.PRNGKey(1), 6, jnp.int32(2))
    tt, tlast, tlen = td.decode_multi(tcfg, model, _t(last), _t(lens), tk, tv, _t(temps),
                                      _t(greedy), 1, 6, 2)
    assert tt.shape == (6, S) and tt.dtype == torch.int64
    np.testing.assert_array_equal(tt.numpy()[:, greedy_rows], np.asarray(jt)[:, greedy_rows])
    np.testing.assert_array_equal(tlast.numpy(), tt.numpy()[-1])
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    # the rows that stayed in step with JAX wrote the same K/V
    for j, t, name in zip((jk, jv), (tk, tv), "kv"):
        _close(t[:, greedy_rows], np.asarray(j)[:, greedy_rows], dt, "cache", f"cache_{name}")


def _paged_tables():
    """Sequence A on pages [3, 1, 4] (non-contiguous), sequence C on [2, 5];
    every other entry is 0, the scratch page."""
    tab_a = np.zeros(8, np.int32)
    tab_a[:3] = [3, 1, 4]
    tab_c = np.zeros(8, np.int32)
    tab_c[:2] = [2, 5]
    return tab_a, tab_c


def _paged_state(pair):
    """Both page pools after a 28-token prompt prefilled into sequence A in
    two chunks (16 tokens, then 12 padded to 16) and an imported 20-token
    prefix written into sequence C's pages (write_pages)."""
    dt, jcfg, params, tcfg, model = pair
    tab_a, tab_c = _paged_tables()
    jk, jv = jd.init_paged_cache(jcfg, N_PAGES, PAGE)
    tk, tv = td.init_paged_cache(tcfg, N_PAGES, PAGE, "cpu")
    prompt = np.random.default_rng(3).integers(0, 256, 28).astype(np.int32)
    logits = []
    for start, n in ((0, 16), (16, 12)):
        tok = np.zeros((1, 16), np.int32)
        tok[0, :n] = prompt[start:start + n]
        jl, jk, jv = jd.prefill_paged(jcfg, params, jnp.asarray(tok), jnp.int32(start),
                                      jnp.int32(n), jk, jv, jnp.asarray(tab_a))
        tl = td.prefill_paged(tcfg, model, _t(tok), start, n, tk, tv, _t(tab_a))
        logits.append((jl, tl))
    rng = np.random.default_rng(4)
    L, H, Dh = jcfg.n_layer, jcfg.n_head, jcfg.head_dim
    kb = rng.standard_normal((L, 2, PAGE, H, Dh)).astype(np.float32)
    vb = rng.standard_normal((L, 2, PAGE, H, Dh)).astype(np.float32)
    jk, jv = jd.write_pages(jnp.asarray(kb), jnp.asarray(vb), jk, jv, jnp.asarray(tab_c[:2]))
    td.write_pages(_t(kb), _t(vb), tk, tv, _t(tab_c[:2]))
    return {"logits": logits, "jcache": (jk, jv), "tcache": (tk, tv),
            "last_a": int(np.argmax(_f32(logits[-1][0])))}


def test_paged_prefill_and_write_pages_match_jax(pair):
    dt = pair[0]
    st = _paged_state(pair)
    for i, (jl, tl) in enumerate(st["logits"]):
        _close(tl, jl, dt, "logits", f"prefill_paged chunk {i} logits")
    for j, t, name in zip(st["jcache"], st["tcache"], "kv"):
        _close(t, j, dt, "cache", f"pages_{name}")


def test_paged_decode_matches_jax(pair):
    """Rows: A at length 28, an inactive row (zero table, length 0: its
    writes land in the scratch page), C at length 20. The logits of each
    step (the private twins both packages keep), decode_paged_and_sample's
    greedy tokens and decode_multi_paged's over 5 steps, and the pools."""
    dt, jcfg, params, tcfg, model = pair
    st = _paged_state(pair)
    jk, jv = st["jcache"]
    tk, tv = st["tcache"]
    tab_a, tab_c = _paged_tables()
    tables = np.stack([tab_a, np.zeros(8, np.int32), tab_c])
    last = np.array([st["last_a"], 0, 7], np.int32)
    lens = np.array([28, 0, 20], np.int32)
    temps = np.full(3, 1e-6, np.float32)
    greedy = np.ones(3, bool)
    jl, _, _ = jd._decode_paged_impl(jcfg, params, jnp.asarray(last), jnp.asarray(lens),
                                     jnp.array(jk), jnp.array(jv), jnp.asarray(tables))
    with torch.inference_mode():
        tl = td._decode_paged_impl(tcfg, model, _t(last), _t(lens), tk.clone(), tv.clone(),
                                   _t(tables))
    _close(tl, jl, dt, "logits", "paged decode logits")
    jn, jlen, jk, jv = jd.decode_paged_and_sample(
        jcfg, params, jnp.asarray(last), jnp.asarray(lens), jk, jv, jnp.asarray(tables),
        jnp.asarray(temps), jnp.asarray(greedy), jax.random.PRNGKey(1), jnp.int32(1))
    tn, tlen = td.decode_paged_and_sample(tcfg, model, _t(last), _t(lens), tk, tv, _t(tables),
                                          _t(temps), _t(greedy), 1, 1)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    jt, _, jlen, jk, jv = jd.decode_multi_paged(
        jcfg, params, jn, jlen, jk, jv, jnp.asarray(tables), jnp.asarray(temps),
        jnp.asarray(greedy), jax.random.PRNGKey(1), 5, jnp.int32(2))
    tt, tlast, tlen = td.decode_multi_paged(tcfg, model, tn, tlen, tk, tv, _t(tables),
                                            _t(temps), _t(greedy), 1, 5, 2)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(tlast.numpy(), tt.numpy()[-1])
    # every page but the scratch page (its junk comes from an idle row)
    for j, t, name in zip((jk, jv), (tk, tv), "kv"):
        _close(t[:, 1:], np.asarray(j)[:, 1:], dt, "cache", f"pages_{name}")


def test_update_rows_match_jax():
    rng = np.random.default_rng(5)
    last = rng.integers(0, 256, 6).astype(np.int32)
    lens = rng.integers(0, 100, 6).astype(np.int32)
    temps = rng.random(6).astype(np.float32)
    greedy = rng.random(6) < 0.5
    tables = rng.integers(0, 9, (6, 4)).astype(np.int32)
    rows = np.array([1, 4], np.int32)
    row_vals = (np.array([7, 9], np.int32), np.array([11, 0], np.int32),
                np.array([0.5, 1e-6], np.float32), np.array([False, True]),
                np.array([[1, 2, 0, 0], [0, 0, 0, 0]], np.int32))
    want = jd.update_rows_paged(*(jnp.asarray(a) for a in (last, lens, temps, greedy, tables,
                                                            rows) + row_vals))
    state = [_t(a) for a in (last, lens, temps, greedy, tables)]
    got = td.update_rows_paged(*state, _t(rows), *(_t(a) for a in row_vals))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the last tokens come back new (the old tensor may be an in-flight
    # chunk's output); the other four are updated in place
    assert got[0] is not state[0]
    np.testing.assert_array_equal(state[0].numpy(), last)
    assert all(g is s for g, s in zip(got[1:], state[1:]))
    want4 = jd.update_rows(*(jnp.asarray(a) for a in (last, lens, temps, greedy, rows)
                             + row_vals[:4]))
    got4 = td.update_rows(*(_t(a) for a in (last, lens, temps, greedy, rows) + row_vals[:4]))
    for g, w in zip(got4, want4):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sample_greedy_rows_are_jax_argmax():
    logits = np.random.default_rng(6).standard_normal((5, 256)).astype(np.float32)
    temps = np.full(5, 1e-6, np.float32)
    greedy = np.ones(5, bool)
    want = jd.sample(jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(greedy),
                     jax.random.PRNGKey(0))
    got = td.sample(_t(logits), _t(temps), _t(greedy), td.step_generator(1, 0, "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_draw_depends_on_seed_and_step_only():
    """fold_in's property: step k's draw is the same whatever was drawn
    before it, and other steps or seeds draw otherwise."""
    logits = torch.zeros(4, 256)
    temps = torch.ones(4)
    greedy = torch.zeros(4, dtype=torch.bool)

    def draw(seed, step):
        return td.sample(logits, temps, greedy, td.step_generator(seed, step, "cpu"))

    first = draw(1, 7)
    for step in range(5):  # draws of other steps in between
        draw(1, step)
    assert torch.equal(draw(1, 7), first)
    assert not torch.equal(draw(1, 8), first) or not torch.equal(draw(2, 7), first)


def test_sample_frequencies_follow_the_softmax():
    """Two live tokens with logits 0 and ln 3 at temperature 1: the second
    is drawn with probability 3/4. 40 rows x 100 steps = 4000 draws; 0.03 is
    about 4.4 standard deviations."""
    logits = torch.full((40, 256), -1e30)
    logits[:, 0] = 0.0
    logits[:, 1] = float(np.log(3.0))
    temps, greedy = torch.ones(40), torch.zeros(40, dtype=torch.bool)
    draws = torch.cat([td.sample(logits, temps, greedy, td.step_generator(1, s, "cpu"))
                       for s in range(100)])
    assert set(draws.tolist()) <= {0, 1}
    assert abs(draws.float().mean().item() - 0.75) < 0.03
    # low temperature sharpens toward the argmax
    cold = td.sample(logits, torch.full((40,), 0.05), greedy, td.step_generator(1, 0, "cpu"))
    assert (cold == 1).all()


# -- the JAX engine tests' decode contracts (tests/test_llm_engine.py:40-113),
# on the port at gpt2-tiny in its default dtype (bf16) --------------------


@pytest.fixture(scope="module")
def tiny(params_np):
    cfg = tg.CONFIGS["gpt2-tiny"]
    return cfg, tg.from_jax(params_np, cfg, "cpu")


def _greedy_reference(cfg, model, prompt, n):
    seq = list(prompt)
    out = []
    with torch.no_grad():
        for _ in range(n):
            logits = model(torch.tensor([seq]), cfg)
            nxt = int(torch.argmax(logits[0, len(seq) - 1, :cfg.vocab_size]))
            out.append(nxt)
            seq.append(nxt)
    return out


def test_kv_decode_matches_full_forward(tiny):
    cfg, model = tiny
    rng = np.random.RandomState(7)
    prompt = list(rng.randint(0, cfg.vocab_size, 12))
    ref = _greedy_reference(cfg, model, prompt, 6)
    ck, cv = td.init_cache(cfg, 4, 64, "cpu")
    tok = np.zeros((1, 16), np.int64)
    tok[0, :len(prompt)] = prompt
    out = [int(torch.argmax(td.prefill(cfg, model, torch.from_numpy(tok), len(prompt), ck, cv,
                                       1)))]
    last = torch.zeros(4, dtype=torch.long)
    lengths = torch.zeros(4, dtype=torch.long)
    last[1] = out[0]
    lengths[1] = len(prompt)
    for _ in range(5):
        nxt = int(torch.argmax(td.decode_step(cfg, model, last, lengths, ck, cv)[1]))
        out.append(nxt)
        last[1] = nxt
        lengths[1] += 1
    assert out == ref


def test_kv_slots_are_isolated(tiny):
    """Two prompts decoding in slots 0 and 2 of one cache each match their
    own single-sequence reference."""
    cfg, model = tiny
    rng = np.random.RandomState(11)
    prompts = [list(rng.randint(0, cfg.vocab_size, 9)), list(rng.randint(0, cfg.vocab_size, 14))]
    refs = [_greedy_reference(cfg, model, p, 4) for p in prompts]
    ck, cv = td.init_cache(cfg, 3, 64, "cpu")
    last = torch.zeros(3, dtype=torch.long)
    lengths = torch.zeros(3, dtype=torch.long)
    outs = {0: [], 2: []}
    for slot, p in zip((0, 2), prompts):
        tok = np.zeros((1, 16), np.int64)
        tok[0, :len(p)] = p
        first = int(torch.argmax(td.prefill(cfg, model, torch.from_numpy(tok), len(p), ck, cv,
                                            slot)))
        outs[slot].append(first)
        last[slot] = first
        lengths[slot] = len(p)
    for _ in range(3):
        logits = td.decode_step(cfg, model, last, lengths, ck, cv)
        for slot in (0, 2):
            nxt = int(torch.argmax(logits[slot]))
            outs[slot].append(nxt)
            last[slot] = nxt
            lengths[slot] += 1
    assert outs[0] == refs[0]
    assert outs[2] == refs[1]

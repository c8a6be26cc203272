"""KV-cached GPT-2 decoding (counterpart of ``ray_tpu/models/gpt2_decode.py``).

The serving engine's device half: prefill writes a prompt's K/V into a
cache, and each decode step runs one token per sequence over the cached
K/V. Two cache layouts, as in the JAX package:

- slots: ``[L, S, T_max, H, Dh]``, one row per sequence;
- pages: ``[L, N_pages, B, H, Dh]`` with a page table per sequence mapping
  virtual position p to (table[p // B], p % B). Page 0 is scratch: inactive
  rows carry all-zero tables and length 0, so their writes land there and
  the step needs no validity branch. Writes through duplicate indices keep
  an arbitrary one, which is harmless only because the pool never hands
  page 0 to a sequence.

Each function takes the port's ``GPT2`` module where the JAX one takes
``params``, and a ``cfg`` that may differ from the model's in its dtype.
Where the JAX function donates the caches, this one updates them in place
and does not return them. Every function runs under
``torch.inference_mode()``.

Numerics follow the JAX functions, not the train path: attention scores
are products of compute-dtype operands rounded to the compute dtype, the
-1e30 mask is applied in that dtype and only the softmax runs in f32;
logits come from compute-dtype operands with an f32 result, sliced to
``vocab_size`` with no pad mask.

Sampling cannot draw JAX's numbers; it keeps ``fold_in``'s property
instead: a step's draw depends only on (seed, step number, logits), never
on how many draws came before (``step_generator``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config, _mm_f32

_NEG_INF = -1e30
Tensor = torch.Tensor


def init_cache(cfg: GPT2Config, slots: int, t_max: int,
               device: DeviceLike = None) -> Tuple[Tensor, Tensor]:
    """(k, v) caches: [n_layer, S, T_max, H, Dh] in the compute dtype."""
    shape = (cfg.n_layer, slots, t_max, cfg.n_head, cfg.head_dim)
    device = resolve_device(device)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


# ---------------------------------------------------------------------------
# The pieces of a layer (the JAX module's _qkv and _proj_mlp, and its inline
# attention and head)
# ---------------------------------------------------------------------------


def _embed(model: GPT2, cfg: GPT2Config, tokens: Tensor, pos: Tensor) -> Tensor:
    """Token plus position embeddings in the compute dtype (gathered, then
    cast: the JAX casts the table first, which gives the same values)."""
    dt = cfg.dtype
    return F.embedding(tokens, model.wte).to(dt) + F.embedding(pos, model.wpe).to(dt)


def _qkv(h: Tensor, blk, cfg: GPT2Config):
    B, T, D = h.shape
    qkv = blk.attn["qkv"](h, cfg.dtype).view(B, T, 3, cfg.n_head, cfg.head_dim)
    return qkv.unbind(2)  # [B, T, H, Dh] each


def _attend(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, cfg: GPT2Config) -> Tensor:
    """q [B, Tq, H, Dh], k/v [B, Tk, H, Dh], mask broadcast to [B, H, Tq, Tk]
    -> [B, Tq, H, Dh], rounded as the JAX decode attention rounds."""
    scale = 1.0 / (cfg.head_dim ** 0.5)
    scores = torch.einsum("bthn,bshn->bhts", q, k) * scale
    scores = scores.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshn->bthn", probs, v)


def _proj_mlp(x: Tensor, att: Tensor, blk, cfg: GPT2Config) -> Tensor:
    B, T, D = x.shape
    dt = cfg.dtype
    x = x + blk.attn["proj"](att.reshape(B, T, D), dt)
    h = F.gelu(blk.mlp["fc_in"](blk.ln2(x), dt), approximate="tanh")
    return x + blk.mlp["fc_out"](h, dt)


def _logits(model: GPT2, cfg: GPT2Config, x: Tensor) -> Tensor:
    """Final hidden states [N, D] -> f32 logits [N, vocab_size] through the
    tied head."""
    wte = model.wte.to(cfg.dtype)
    return _mm_f32(x.to(cfg.dtype), wte.t())[:, : cfg.vocab_size]


def _prompt_logits(model: GPT2, cfg: GPT2Config, x: Tensor, length: int) -> Tensor:
    """Logits [vocab] at the last real position of a [1, P, D] prompt."""
    last = model.ln_f(x)[0, max(int(length) - 1, 0)]
    return _logits(model, cfg, last[None])[0]


# ---------------------------------------------------------------------------
# Slot cache
# ---------------------------------------------------------------------------


@torch.inference_mode()
def prefill(cfg: GPT2Config, model: GPT2, tokens: Tensor, length: int,
            cache_k: Tensor, cache_v: Tensor, slot: int) -> Tensor:
    """Run the prompt ``tokens`` [1, P] (right-padded, ``length`` real)
    through the model, writing each layer's K/V into cache row ``slot``;
    return the last real position's logits [vocab]."""
    P = tokens.shape[1]
    dev = tokens.device
    x = _embed(model, cfg, tokens, torch.arange(P, device=dev)[None])
    causal = torch.ones(P, P, dtype=torch.bool, device=dev).tril()
    for layer, blk in enumerate(model.blocks):
        q, k, v = _qkv(blk.ln1(x), blk, cfg)
        cache_k[layer, slot, :P] = k[0]
        cache_v[layer, slot, :P] = v[0]
        x = _proj_mlp(x, _attend(q, k, v, causal, cfg), blk, cfg)
    return _prompt_logits(model, cfg, x, length)


@torch.inference_mode()
def write_prefix(prefix_k: Tensor, prefix_v: Tensor, cache_k: Tensor, cache_v: Tensor,
                 slot: int) -> None:
    """Copy precomputed prefix K/V [L, C, H, Dh] into cache row ``slot``
    (positions 0..C-1): admission from a prefix-cache hit or a KV import."""
    C = prefix_k.shape[1]
    cache_k[:, slot, :C] = prefix_k.to(cache_k.dtype)
    cache_v[:, slot, :C] = prefix_v.to(cache_v.dtype)


@torch.inference_mode()
def prefill_extend(cfg: GPT2Config, model: GPT2, tokens: Tensor, start: int, length: int,
                   cache_k: Tensor, cache_v: Tensor, slot: int) -> Tensor:
    """Prefill only the uncached tail of a prompt: ``tokens`` [1, P]
    (right-padded, ``length`` real) are positions start..start+P-1, and row
    ``slot`` already holds positions 0..start-1. Writes the tail's K/V at
    ``start``, attends it over the whole row, and returns the last real tail
    position's logits [vocab]. The caller guarantees start + P <= T_max."""
    P = tokens.shape[1]
    T = cache_k.shape[2]
    dev = tokens.device
    pos = start + torch.arange(P, device=dev)
    x = _embed(model, cfg, tokens, pos.clamp(0, T - 1)[None])
    mask = torch.arange(T, device=dev)[None] <= pos[:, None]  # [P, T]
    for layer, blk in enumerate(model.blocks):
        q, k, v = _qkv(blk.ln1(x), blk, cfg)
        cache_k[layer, slot, start:start + P] = k[0]
        cache_v[layer, slot, start:start + P] = v[0]
        att = _attend(q, cache_k[layer, slot][None], cache_v[layer, slot][None], mask, cfg)
        x = _proj_mlp(x, att, blk, cfg)
    return _prompt_logits(model, cfg, x, length)


def _decode_step_impl(cfg: GPT2Config, model: GPT2, last_tokens: Tensor, lengths: Tensor,
                      cache_k: Tensor, cache_v: Tensor) -> Tensor:
    """One token for every slot: [S] last tokens at positions ``lengths``
    write their K/V there and attend over their rows. Returns logits
    [S, vocab]."""
    S = last_tokens.shape[0]
    T = cache_k.shape[2]
    dev = last_tokens.device
    pos = lengths.clamp(0, T - 1)
    x = _embed(model, cfg, last_tokens[:, None], pos[:, None])  # [S, 1, D]
    rows = torch.arange(S, device=dev)
    mask = (torch.arange(T, device=dev)[None] <= pos[:, None])[:, None, None]  # attend 0..pos
    for layer, blk in enumerate(model.blocks):
        q, k, v = _qkv(blk.ln1(x), blk, cfg)  # [S, 1, H, Dh]
        cache_k[layer].index_put_((rows, pos), k[:, 0].to(cache_k.dtype))
        cache_v[layer].index_put_((rows, pos), v[:, 0].to(cache_v.dtype))
        x = _proj_mlp(x, _attend(q, cache_k[layer], cache_v[layer], mask, cfg), blk, cfg)
    return _logits(model, cfg, model.ln_f(x)[:, 0])


decode_step = torch.inference_mode()(_decode_step_impl)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of decode step ``step``: seeded from (seed, step) alone,
    so a step's draw does not depend on the draws before it (the JAX
    engine's ``fold_in(rng_base, step)``)."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + step) % (1 << 63))


@torch.inference_mode()
def sample(logits: Tensor, temps: Tensor, greedy_mask: Tensor,
           generator: torch.Generator) -> Tensor:
    """Per-row temperature or greedy sampling of logits [S, V] -> [S]
    (int64). Greedy rows are the argmax; the others draw by the Gumbel-max
    rule, as ``jax.random.categorical`` does, from ``generator``."""
    greedy = logits.argmax(-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    sampled = (logits / temps.clamp_min(1e-6)[:, None] + gumbel).argmax(-1)
    return torch.where(greedy_mask, greedy, sampled)


@torch.inference_mode()
def update_rows(last_tokens: Tensor, lengths: Tensor, temps: Tensor, greedy_mask: Tensor,
                rows: Tensor, row_last: Tensor, row_len: Tensor, row_temps: Tensor,
                row_greedy: Tensor):
    """Write admission and retirement values into ``rows`` of the
    device-resident step state; returns (last_tokens, lengths, temps,
    greedy_mask). The last tokens come back as a NEW tensor: in the async
    engine the old one is the previous chunk's token output, which the host
    may not have read yet. The other three are updated in place."""
    last_tokens = last_tokens.index_put((rows,), row_last)
    lengths.index_put_((rows,), row_len)
    temps.index_put_((rows,), row_temps)
    greedy_mask.index_put_((rows,), row_greedy)
    return last_tokens, lengths, temps, greedy_mask


@torch.inference_mode()
def decode_and_sample(cfg: GPT2Config, model: GPT2, last_tokens: Tensor, lengths: Tensor,
                      cache_k: Tensor, cache_v: Tensor, temps: Tensor, greedy_mask: Tensor,
                      seed: int, step: int) -> Tuple[Tensor, Tensor]:
    """decode_step + sample + cursor bump: returns (next_tokens [S],
    lengths + 1), both fed straight back in by the engine."""
    logits = _decode_step_impl(cfg, model, last_tokens, lengths, cache_k, cache_v)
    nxt = sample(logits, temps, greedy_mask, step_generator(seed, step, logits.device))
    return nxt, lengths + 1


@torch.inference_mode()
def decode_multi(cfg: GPT2Config, model: GPT2, last_tokens: Tensor, lengths: Tensor,
                 cache_k: Tensor, cache_v: Tensor, temps: Tensor, greedy_mask: Tensor,
                 seed: int, n_steps: int, step0: int) -> Tuple[Tensor, Tensor, Tensor]:
    """``n_steps`` tokens per slot in one call, step i drawing with step
    number step0 + i. Returns (tokens [n_steps, S], last tokens, lengths)."""
    toks = []
    for i in range(n_steps):
        logits = _decode_step_impl(cfg, model, last_tokens, lengths, cache_k, cache_v)
        last_tokens = sample(logits, temps, greedy_mask,
                             step_generator(seed, step0 + i, logits.device))
        lengths = lengths + 1
        toks.append(last_tokens)
    return torch.stack(toks), last_tokens, lengths


# ---------------------------------------------------------------------------
# Paged cache
# ---------------------------------------------------------------------------


def init_paged_cache(cfg: GPT2Config, num_pages: int, page_tokens: int,
                     device: DeviceLike = None) -> Tuple[Tensor, Tensor]:
    """(k, v) page pools: [n_layer, N_pages, B, H, Dh], compute dtype."""
    shape = (cfg.n_layer, num_pages, page_tokens, cfg.n_head, cfg.head_dim)
    device = resolve_device(device)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


@torch.inference_mode()
def write_pages(k_blocks: Tensor, v_blocks: Tensor, cache_k: Tensor, cache_v: Tensor,
                pages: Tensor) -> None:
    """Write ``k_blocks``/``v_blocks`` [L, n, B, H, Dh] into physical pages
    ``pages`` [n] (a disaggregated KV import; prefix hits copy nothing)."""
    cache_k[:, pages] = k_blocks.to(cache_k.dtype)
    cache_v[:, pages] = v_blocks.to(cache_v.dtype)


def _row(cache: Tensor, layer: int, page_table: Tensor, cfg: GPT2Config) -> Tensor:
    """The virtual rows of ``page_table`` [..., MaxPages] gathered from one
    layer's pages -> [..., MaxPages * B, H, Dh]."""
    rows = cache[layer][page_table]  # [..., MaxPages, B, H, Dh]
    return rows.reshape(*page_table.shape[:-1], -1, cfg.n_head, cfg.head_dim)


@torch.inference_mode()
def prefill_paged(cfg: GPT2Config, model: GPT2, tokens: Tensor, start: int, length: int,
                  cache_k: Tensor, cache_v: Tensor, page_table: Tensor) -> Tensor:
    """Prefill one chunk of a prompt into paged KV: ``tokens`` [1, P]
    (right-padded, ``length`` real) are virtual positions start..start+P-1
    of the sequence whose page table is ``page_table`` [MaxPages]; positions
    0..start-1 are already in its pages. Writes the chunk's K/V through the
    table, attends the chunk over the whole gathered row, and returns the
    last real position's logits [vocab]. The caller guarantees start + P <=
    MaxPages * B; padding positions past the sequence's pages hit table
    entries 0, the scratch page."""
    P = tokens.shape[1]
    B = cache_k.shape[2]
    max_pages = page_table.shape[0]
    T = max_pages * B  # virtual row width
    W = model.wpe.shape[0]
    dev = tokens.device
    pos = start + torch.arange(P, device=dev)
    x = _embed(model, cfg, tokens, pos.clamp(0, W - 1)[None])
    mask = torch.arange(T, device=dev)[None] <= pos[:, None]  # [P, T]
    page_of = page_table[(pos // B).clamp(0, max_pages - 1)]  # [P]
    off = pos % B
    for layer, blk in enumerate(model.blocks):
        q, k, v = _qkv(blk.ln1(x), blk, cfg)  # [1, P, H, Dh]
        cache_k[layer].index_put_((page_of, off), k[0].to(cache_k.dtype))
        cache_v[layer].index_put_((page_of, off), v[0].to(cache_v.dtype))
        att = _attend(q, _row(cache_k, layer, page_table, cfg)[None],
                      _row(cache_v, layer, page_table, cfg)[None], mask, cfg)
        x = _proj_mlp(x, att, blk, cfg)
    return _prompt_logits(model, cfg, x, length)


def _decode_paged_impl(cfg: GPT2Config, model: GPT2, last_tokens: Tensor, lengths: Tensor,
                       cache_k: Tensor, cache_v: Tensor, page_tables: Tensor) -> Tensor:
    """One token for every sequence over paged KV: [S] last tokens at
    virtual positions ``lengths`` write their K/V through ``page_tables``
    [S, MaxPages] and attend over their gathered rows. Returns logits
    [S, vocab]."""
    S = last_tokens.shape[0]
    B = cache_k.shape[2]
    T = page_tables.shape[1] * B
    W = model.wpe.shape[0]
    dev = last_tokens.device
    pos = lengths.clamp(0, T - 1)
    x = _embed(model, cfg, last_tokens[:, None], pos.clamp(0, W - 1)[:, None])  # [S, 1, D]
    rows = torch.arange(S, device=dev)
    mask = (torch.arange(T, device=dev)[None] <= pos[:, None])[:, None, None]  # attend 0..pos
    page_of = page_tables[rows, pos // B]  # [S]
    off = pos % B
    for layer, blk in enumerate(model.blocks):
        q, k, v = _qkv(blk.ln1(x), blk, cfg)  # [S, 1, H, Dh]
        # inactive rows have zero tables: their writes land in the scratch page
        cache_k[layer].index_put_((page_of, off), k[:, 0].to(cache_k.dtype))
        cache_v[layer].index_put_((page_of, off), v[:, 0].to(cache_v.dtype))
        att = _attend(q, _row(cache_k, layer, page_tables, cfg),
                      _row(cache_v, layer, page_tables, cfg), mask, cfg)
        x = _proj_mlp(x, att, blk, cfg)
    return _logits(model, cfg, model.ln_f(x)[:, 0])


@torch.inference_mode()
def decode_paged_and_sample(cfg: GPT2Config, model: GPT2, last_tokens: Tensor,
                            lengths: Tensor, cache_k: Tensor, cache_v: Tensor,
                            page_tables: Tensor, temps: Tensor, greedy_mask: Tensor,
                            seed: int, step: int) -> Tuple[Tensor, Tensor]:
    """Paged twin of :func:`decode_and_sample`: (next_tokens, lengths + 1)."""
    logits = _decode_paged_impl(cfg, model, last_tokens, lengths, cache_k, cache_v,
                                page_tables)
    nxt = sample(logits, temps, greedy_mask, step_generator(seed, step, logits.device))
    return nxt, lengths + 1


@torch.inference_mode()
def decode_multi_paged(cfg: GPT2Config, model: GPT2, last_tokens: Tensor, lengths: Tensor,
                       cache_k: Tensor, cache_v: Tensor, page_tables: Tensor,
                       temps: Tensor, greedy_mask: Tensor, seed: int, n_steps: int,
                       step0: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Paged twin of :func:`decode_multi` (the tables stay fixed: admission
    reserved every page up front). Returns (tokens [n_steps, S], last
    tokens, lengths)."""
    toks = []
    for i in range(n_steps):
        logits = _decode_paged_impl(cfg, model, last_tokens, lengths, cache_k, cache_v,
                                    page_tables)
        last_tokens = sample(logits, temps, greedy_mask,
                             step_generator(seed, step0 + i, logits.device))
        lengths = lengths + 1
        toks.append(last_tokens)
    return torch.stack(toks), last_tokens, lengths


@torch.inference_mode()
def update_rows_paged(last_tokens: Tensor, lengths: Tensor, temps: Tensor,
                      greedy_mask: Tensor, page_tables: Tensor, rows: Tensor,
                      row_last: Tensor, row_len: Tensor, row_temps: Tensor,
                      row_greedy: Tensor, row_tables: Tensor):
    """Paged twin of :func:`update_rows`, which also rewrites the changed
    rows' page tables (a retired row's goes all-zero, so its writes land in
    the scratch page). The last tokens come back as a new tensor, for the
    same reason."""
    last_tokens, lengths, temps, greedy_mask = update_rows(
        last_tokens, lengths, temps, greedy_mask, rows, row_last, row_len, row_temps,
        row_greedy)
    page_tables.index_put_((rows,), row_tables)
    return last_tokens, lengths, temps, greedy_mask, page_tables

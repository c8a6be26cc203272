"""Attention implementations (counterpart of ``ray_tpu/ops/attention.py``).

impl="reference": plain PyTorch attention, the numerics oracle.
impl="flash":     the hand-written Hopper kernels (ops/flash_attention.py);
                  the T x T score matrix never reaches device memory.
impl="ring" (context parallelism over a mesh axis) is not ported yet.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
              impl: str = "reference") -> torch.Tensor:
    """q [B, T, H, Dh], k/v [B, S, H, Dh] -> [B, T, H, Dh]."""
    if impl == "reference":
        return _reference_attention(q, k, v, causal)
    if impl == "flash":
        from ray_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal)
    if impl == "ring":
        raise NotImplementedError(
            "ring attention is not ported yet (ROADMAP.md, Queue A: ring attention)"
        )
    raise ValueError(f"unknown attention impl {impl!r}")


def _reference_attention(q, k, v, causal):
    """Scores in f32 from the operands (bf16 products accumulated in f32,
    as the JAX einsum's preferred_element_type does), softmax in f32, the
    probabilities cast to v's dtype before p@v."""
    T, S, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(T, S, dtype=torch.bool, device=q.device).tril(S - T)
        scores = scores.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)

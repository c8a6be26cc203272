"""Attention implementations (counterpart of ``ray_tpu/ops/attention.py``).

impl="reference": plain PyTorch attention, the numerics oracle.
impl="flash":     the hand-written Hopper kernels (ops/flash_attention.py);
                  the T x T score matrix never reaches device memory.
impl="ring":      ring attention over the ranks of ``group``, a
                  ``torch.distributed`` process group (ops/ring_attention.py;
                  ``axis_name`` in JAX): q, k, v are this rank's slice of the
                  sequence. On a mesh, ``ring_attention_sharded`` takes the
                  group from its cp axis. The model does not run the ring:
                  the JAX model does not either (under a cp mesh its jitted
                  loss raises ``NameError: unbound axis name: cp``), so
                  without a group it raises.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
              impl: str = "reference", group=None) -> torch.Tensor:
    """q [B, T, H, Dh], k/v [B, S, H, Dh] -> [B, T, H, Dh]; ``group`` is the
    process group of impl="ring"."""
    if impl == "reference":
        return _reference_attention(q, k, v, causal)
    if impl == "flash":
        from ray_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal)
    if impl == "ring":
        if group is None:
            raise NotImplementedError(
                "ring attention needs a process group (group=...), or a mesh through "
                "ring_attention_sharded; the model does not run the ring"
            )
        from ray_tpu_torch.ops.ring_attention import ring_attention

        return ring_attention(q, k, v, group, causal=causal)
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

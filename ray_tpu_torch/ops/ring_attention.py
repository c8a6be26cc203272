"""Ring attention: context parallelism over a ``torch.distributed`` group.

Counterpart of ``ray_tpu/ops/ring_attention.py``. Each rank of ``group``
holds a T/n slice of Q, K and V ([B, Tl, H, Dh], rank r the rows
[r Tl, (r+1) Tl)); the K/V blocks travel around the ring, rank r sending to
r+1 and receiving from r-1 (``lax.ppermute`` with ``perm = [(i, (i+1) % n)]``
in JAX), while every rank attends its queries to each visiting block and
merges the blocks through their log-sum-exp in f32: exact attention over
the whole sequence. The exchange is ``dist.batch_isend_irecv``: NCCL on the
card, gloo on the CPU. At world 1 nothing is exchanged.

The block math runs in the flash kernels' f32-output instantiations
(``ops/flash_attention.py``, ``out_f32=True``). The ring folds its operands
to the kernels' [B*H, T, Dh] layout once, so the visiting blocks, the
accumulators and the merges stay in that layout; ``flash_fwd_block`` and
``flash_bwd_block`` are the same calls at the model layout.

Visiting blocks under causal masking (global positions; ``_ring_cases``,
ring_attention.py:58):
  src == my  -> the diagonal block: the causal kernel;
  src <  my  -> an earlier block, fully visible: the non-causal kernel;
  src >  my  -> a later block, fully masked: no launch. JAX merges zeros at
                lse -1e30 there, which leaves the running output and lse
                bitwise as they were, so the merge is skipped too.

The backward runs a second ring. delta = rowsum(dO * out) is taken from the
output already cast to q's dtype (ring_attention.py:131-136); dq
accumulates in f32 on its rank, and the dk and dv accumulators travel with
their K/V block, so after n rotations each arrives home carrying every
rank's contribution. In the forward the last rotation of K/V is dead and is
skipped; in the backward the accumulators take all n.

``forward_step`` and ``backward_step`` are one rank's work on one visiting
block, separate from the exchange: the distributed ring (``ring_attention``)
and the ring of n ranks emulated in one process (``ring_attention_emulated``,
for a single card) make the same calls. ``ring_attention_einsum`` is the
einsum oracle (forward only).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.ops import flash_attention as fa

_NEG = -1e30
Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# One rank's work on one visiting block (folded [B*H, T, Dh] layout)
# ---------------------------------------------------------------------------


def _visible(src: int, my: int, causal: bool) -> bool:
    return not causal or src <= my


def forward_init(qf: Tensor) -> Tuple[Tensor, Tensor]:
    """The empty merge state of a rank's q rows: (o 0 [B*H, Tl, Dh] f32,
    lse -1e30 [B*H, Tl] f32)."""
    BH, Tl, D = qf.shape
    return (torch.zeros(BH, Tl, D, dtype=torch.float32, device=qf.device),
            torch.full((BH, Tl), _NEG, dtype=torch.float32, device=qf.device))


def forward_step(qf: Tensor, kf: Tensor, vf: Tensor, src: int, my: int, causal: bool,
                 o: Tensor, lse: Tensor) -> None:
    """Rank ``my`` attends its q rows to the K/V block of rank ``src`` and
    merges the block into (o, lse) in place (ring_attention.py:91-112):
    lse' = logaddexp(lse, lse_b), o' = o exp(lse - lse') + o_b exp(lse_b - lse')."""
    if not _visible(src, my, causal):
        return
    o_b, lse_b = fa.flash_fwd(qf, kf, vf, causal and src == my, out_f32=True)
    new = torch.logaddexp(lse, lse_b)
    o.mul_(torch.exp(lse - new).unsqueeze(-1)).addcmul_(o_b, torch.exp(lse_b - new).unsqueeze(-1))
    lse.copy_(new)


def backward_delta(dof: Tensor, out: Tensor) -> Tensor:
    """delta = rowsum(dO * out) in f32, [B*H, Tl], from the output in q's
    dtype (ring_attention.py:131-136)."""
    return (dof.float() * out.float()).sum(-1)


def backward_step(qf: Tensor, kf: Tensor, vf: Tensor, dof: Tensor, lse: Tensor, delta: Tensor,
                  src: int, my: int, causal: bool, dq: Tensor, dk: Tensor, dv: Tensor) -> None:
    """Rank ``my``'s gradient contributions through the K/V block of rank
    ``src``, against the global lse and delta, added in place to its dq and
    to the block's travelling dk and dv (f32; ring_attention.py:142-160)."""
    if not _visible(src, my, causal):
        return
    diag = causal and src == my
    dq += fa.flash_dq(qf, kf, vf, dof, lse, delta, diag, out_f32=True)
    dk_b, dv_b = fa.flash_dkv(qf, kf, vf, dof, lse, delta, diag, out_f32=True)
    dk += dk_b
    dv += dv_b


# ---------------------------------------------------------------------------
# The exchange
# ---------------------------------------------------------------------------


def _start_rotation(group, tensors: Sequence[Tensor], tag: int) -> Callable[[], List[Tensor]]:
    """Send ``tensors`` to the next rank of ``group`` and receive the
    previous rank's; returns the wait, which gives the received tensors.
    Tags ``tag``, ``tag + 1``, ... keep the messages of one call apart on
    gloo (NCCL matches them in order). World 1: no exchange."""
    n = dist.get_world_size(group)
    if n == 1:
        return lambda: list(tensors)
    my = dist.get_rank(group)
    to, frm = (dist.get_global_rank(group, (my + d) % n) for d in (1, -1))
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, to, group, tag + i) for i, t in enumerate(tensors)]
    ops += [dist.P2POp(dist.irecv, r, frm, group, tag + i) for i, r in enumerate(recv)]
    works = dist.batch_isend_irecv(ops)

    def wait() -> List[Tensor]:
        for w in works:
            w.wait()
        return recv

    return wait


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        B, _, H, _ = q.shape
        n, my = dist.get_world_size(group), dist.get_rank(group)
        qf, kf, vf = fa._fold(q), fa._fold(k), fa._fold(v)
        o, lse = forward_init(qf)
        kk, vv = kf, vf
        for s in range(n):
            # the next block travels while this one is computed; the last
            # rotation would only bring the rank's own block home
            arrived = _start_rotation(group, (kk, vv), 0) if s < n - 1 else None
            forward_step(qf, kk, vv, (my - s) % n, my, causal, o, lse)
            if arrived is not None:
                kk, vv = arrived()
        out = o.to(q.dtype)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.group, ctx.causal, ctx.B, ctx.H = group, causal, B, H
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        return fa._unfold(out, B, H)

    @staticmethod
    def backward(ctx, dout):
        qf, kf, vf, out, lse = ctx.saved_tensors
        group, causal, B, H = ctx.group, ctx.causal, ctx.B, ctx.H
        n, my = dist.get_world_size(group), dist.get_rank(group)
        dof = fa._fold(dout)
        delta = backward_delta(dof, out)
        dq = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
        dk = torch.zeros(kf.shape, dtype=torch.float32, device=kf.device)
        dv = torch.zeros_like(dk)
        kk, vv = kf, vf
        for s in range(n):
            arrived = _start_rotation(group, (kk, vv), 0) if s < n - 1 else None
            backward_step(qf, kk, vv, dof, lse, delta, (my - s) % n, my, causal, dq, dk, dv)
            # the accumulators go on with their block, all n rotations: home at the end
            dk, dv = _start_rotation(group, (dk, dv), 2)()
            if arrived is not None:
                kk, vv = arrived()
        grads = (fa._unfold(g.to(dt), B, H) for g, dt in zip((dq, dk, dv), ctx.dtypes))
        return (*grads, None, None)


def ring_attention(q: Tensor, k: Tensor, v: Tensor, group, causal: bool = True) -> Tensor:
    """Exact attention over the sequence split across ``group``: q, k, v are
    this rank's shard [B, Tl, H, Dh] (rank r holds rows [r Tl, (r+1) Tl));
    returns its rows of the output [B, Tl, H, Dh], differentiable in q, k, v.
    Rank and world come from the group (``axis_index`` and ``psum(1)`` in
    JAX). On CUDA tensors every block goes to the f32 kernels or raises."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected equal [B, Tl, H, Dh] shards, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return _RingAttention.apply(q, k, v, group, causal)


# ---------------------------------------------------------------------------
# n ranks in one process (one card): the same steps, the rotation on lists
# ---------------------------------------------------------------------------


def ring_attention_emulated(q: Sequence[Tensor], k: Sequence[Tensor], v: Sequence[Tensor],
                            do: Optional[Sequence[Tensor]] = None, causal: bool = True):
    """The ring of n = len(q) ranks run in one process, for a single
    device: rank r's shards are q[r], k[r], v[r] ([B, Tl, H, Dh]) and, for
    the backward, its output's cotangent do[r]. Every rank makes the calls
    of ``ring_attention``'s forward and backward, step by step, and a
    rotation moves list entry r to r+1. Returns the per-rank outputs, or
    with ``do`` (out, dq, dk, dv) per rank, each in its input's dtype."""
    n = len(q)
    B, _, H, _ = q[0].shape
    qf, kf, vf = ([fa._fold(x) for x in xs] for xs in (q, k, v))
    state = [forward_init(x) for x in qf]
    kk, vv = list(kf), list(vf)
    for s in range(n):
        for r in range(n):
            forward_step(qf[r], kk[r], vv[r], (r - s) % n, r, causal, *state[r])
        kk, vv = kk[-1:] + kk[:-1], vv[-1:] + vv[:-1]
    out = [o.to(x.dtype) for (o, _), x in zip(state, q)]
    unfold = lambda xs, like: [fa._unfold(x.to(y.dtype), B, H) for x, y in zip(xs, like)]
    if do is None:
        return unfold(out, q)
    dof = [fa._fold(x) for x in do]
    delta = [backward_delta(d, o) for d, o in zip(dof, out)]
    dq = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in qf]
    dk = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in kf]
    dv = [torch.zeros_like(x) for x in dk]
    kk, vv = list(kf), list(vf)
    for s in range(n):
        for r in range(n):
            backward_step(qf[r], kk[r], vv[r], dof[r], state[r][1], delta[r], (r - s) % n, r,
                          causal, dq[r], dk[r], dv[r])
        kk, vv = kk[-1:] + kk[:-1], vv[-1:] + vv[:-1]
        dk, dv = dk[-1:] + dk[:-1], dv[-1:] + dv[:-1]
    return unfold(out, q), unfold(dq, q), unfold(dk, k), unfold(dv, v)


# ---------------------------------------------------------------------------
# einsum block math (the numerics oracle, ring_attention.py:184-244)
# ---------------------------------------------------------------------------


def _block_scores(q: Tensor, kb: Tensor, q_off: int, k_off: int, causal: bool) -> Tensor:
    """Masked scores [B, H, Tq, Tk] f32 of one (q shard, k block) pair at
    global positions."""
    s = torch.einsum("bthd,bshd->bhts", q.float(), kb.float()) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        Tq, Tk = q.shape[1], kb.shape[1]
        row = torch.arange(Tq, device=q.device)[:, None] + q_off
        col = torch.arange(Tk, device=q.device)[None, :] + k_off
        s = s.masked_fill(~(col <= row), _NEG)
    return s


def ring_attention_einsum(q: Tensor, k: Tensor, v: Tensor, group, causal: bool = True) -> Tensor:
    """The einsum ring over ``group``: the same exchange, the block math in
    einsums with a running max and normaliser. Forward only: JAX
    differentiates it through ``ppermute``, which has no autograd here, so
    it refuses inputs that need a gradient."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError("the einsum ring's gradient is not ported; "
                                  "use ring_attention or torch.no_grad()")
    n, my = dist.get_world_size(group), dist.get_rank(group)
    B, Tl, H, D = q.shape
    acc = torch.zeros(B, Tl, H, D, dtype=torch.float32, device=q.device)
    m_run = torch.full((B, H, Tl, 1), _NEG, dtype=torch.float32, device=q.device)
    l_run = torch.zeros(B, H, Tl, 1, dtype=torch.float32, device=q.device)
    kk, vv = k, v
    for s in range(n):
        arrived = _start_rotation(group, (kk, vv), 0) if s < n - 1 else None
        src = (my - s) % n
        scores = _block_scores(q, kk, my * Tl, src * Tl, causal)
        m_b = scores.amax(-1, keepdim=True).clamp_min(_NEG)  # fully masked rows stay finite
        p = torch.exp(scores - m_b)
        if causal:  # exp(-1e30 - -1e30) = 1 on fully masked rows: zero them
            p = p.masked_fill(scores <= _NEG / 2, 0.0)
        l_b = p.sum(-1, keepdim=True)
        o_b = torch.einsum("bhts,bshd->bthd", p.to(vv.dtype), vv)  # in v's dtype, as in JAX
        m_new = torch.maximum(m_run, m_b)
        scale_run, scale_b = torch.exp(m_run - m_new), torch.exp(m_b - m_new)
        acc = acc * scale_run.transpose(1, 2) + o_b.float() * scale_b.transpose(1, 2)
        l_run = l_run * scale_run + l_b * scale_b
        m_run = m_new
        if arrived is not None:
            kk, vv = arrived()
    return (acc / l_run.clamp_min(1e-30).transpose(1, 2)).to(q.dtype)


# ---------------------------------------------------------------------------
# On the mesh (ring_attention.py:247)
# ---------------------------------------------------------------------------


def ring_attention_sharded(q: Tensor, k: Tensor, v: Tensor, mesh, causal: bool = True,
                           cp_axis: str = "cp", batch_axes: Sequence[str] = ("dcn", "dp", "fsdp"),
                           head_axis: Optional[str] = "tp") -> Tensor:
    """Ring attention on a mesh from ``ray_tpu_torch.parallel.build_mesh``,
    local shards in and out: q, k, v are this rank's block of the global
    [B, T, H, Dh] arrays (what ``shard_map``'s body sees in JAX under the
    spec (batch_axes, cp_axis, head_axis, None)), its rows of the batch
    from its data coordinates, its T / cp rows of the sequence from its cp
    coordinate and its heads from its tp coordinate; returns its block of
    the output, differentiable in q, k, v. Batch and heads split nothing
    the attention mixes, so only the cp group exchanges: the ring runs over
    ``mesh[cp_axis]``. The axes named must be the mesh's."""
    names = mesh.mesh_dim_names
    missing = [a for a in (cp_axis, *batch_axes, head_axis) if a is not None and a not in names]
    if missing:
        raise ValueError(f"axes {missing} are not the mesh's {names}")
    return ring_attention(q, k, v, mesh[cp_axis].get_group(), causal=causal)

"""Mixture-of-Experts block: expert parallelism over a ``torch.distributed`` group.

Counterpart of ``ray_tpu/ops/moe.py``: GShard-style top-k routing with a
static capacity per expert (tokens past it are dropped: their combine
weights are zero), experts split over the ranks of ``group``, tokens
exchanged by two all-to-alls. Plain PyTorch, as the JAX module is plain XLA:
einsums, one-hots, a cumulative sum and the exchange. Dispatch and combine
are f32.

Layout on each of the n ranks:
  x        [Bl, D]        this rank's tokens
  wg       [D, E]         the router (the same on every rank)
  w_in     [El, D, F]     this rank's experts (E = n * El; rank r holds
  w_out    [El, F, D]     experts r El .. (r+1) El - 1)
dispatch [Bl, E, C] one-hot -> all-to-all -> experts run on [El, n C, D]
-> the reverse all-to-all -> combine weights back into [Bl, D].

The exchanges are ``dist.all_to_all_single`` on the [n, El, C, D] layout
that ``lax.all_to_all`` (split and concat axis 0, untiled) takes in JAX:
rank r sends block p to rank p and receives, in block p, rank p's tokens
for its own experts. Its gradient is the same exchange of the output's
gradient (``_AllToAll``; ``torch.distributed.nn.functional``'s
differentiable version is deprecated from torch 2.13 on).

Two points where the frameworks differ:
  - ``jax.nn.gelu`` is the tanh approximation by default; the port calls
    ``F.gelu(..., approximate="tanh")``;
  - ``lax.top_k`` puts the lower index first among equal gates, and
    ``torch.topk`` leaves their order unspecified: the router takes the top
    k of a stable descending sort, which keeps the lower index first.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

Tensor = torch.Tensor


def router_dispatch(x: Tensor, wg: Tensor, capacity: int, top_k: int = 2) -> Tuple[Tensor, Tensor]:
    """(dispatch [B, E, C], combine [B, E, C]), both f32, for tokens x [B, D]
    and router wg [D, E] (moe.py:30-67). The top-k gates are renormalised;
    each expert fills its C slots in token order, choice 0 of every token
    before choice 1."""
    E = wg.shape[1]
    gates = torch.softmax(x.float() @ wg.float(), dim=-1)  # [B, E]
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :top_k], topi[:, :top_k]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)

    slots = torch.arange(capacity, device=x.device)
    dispatch = torch.zeros(x.shape[0], E, capacity, dtype=torch.float32, device=x.device)
    combine = torch.zeros_like(dispatch)
    fill = torch.zeros(E, dtype=torch.long, device=x.device)  # slots taken per expert
    for k in range(top_k):
        onehot = F.one_hot(topi[:, k], E)  # [B, E]
        pos = ((torch.cumsum(onehot, 0) - onehot + fill) * onehot).sum(1)  # [B]
        keep = pos < capacity
        pos_oh = (pos[:, None] == slots).float()  # all zero past the capacity
        sel = onehot.float() * keep[:, None]
        dispatch = dispatch + sel[:, :, None] * pos_oh[:, None, :]
        combine = combine + (sel * topv[:, k:k + 1])[:, :, None] * pos_oh[:, None, :]
        fill = fill + (onehot * keep[:, None]).sum(0)
    return dispatch, combine


class _AllToAll(torch.autograd.Function):
    """Block p of x [n, ...] to rank p of ``group``, block p of the result
    from rank p; the gradient goes back by the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllToAll.apply(grad, ctx.group), None


def _experts(tokens: Tensor, w_in: Tensor, w_out: Tensor) -> Tensor:
    """gelu(tokens W_in) W_out per expert: [E, T, D] f32 -> [E, T, D] f32."""
    h = F.gelu(torch.einsum("etd,edf->etf", tokens, w_in.float()), approximate="tanh")
    return torch.einsum("etf,efd->etd", h, w_out.float())


def moe_block_local(x: Tensor, wg: Tensor, w_in: Tensor, w_out: Tensor, capacity: int,
                    top_k: int = 2) -> Tensor:
    """All experts on one device (moe.py:70-76), the numerics oracle:
    x [B, D], w_in [E, D, F], w_out [E, F, D] -> [B, D] in x's dtype."""
    dispatch, combine = router_dispatch(x, wg, capacity, top_k)
    expert_in = torch.einsum("bec,bd->ecd", dispatch, x.float())
    out = _experts(expert_in, w_in, w_out)
    return torch.einsum("bec,ecd->bd", combine, out).to(x.dtype)


def moe_block(x: Tensor, wg: Tensor, w_in: Tensor, w_out: Tensor, capacity: int, group,
              top_k: int = 2) -> Tensor:
    """Expert-parallel MoE over ``group`` (moe.py:79-115): this rank's
    tokens x [Bl, D] and experts w_in [El, D, F], w_out [El, F, D] ->
    [Bl, D] in x's dtype, differentiable in x, wg, w_in and w_out. Routing
    and capacity are per rank, as in JAX."""
    n = dist.get_world_size(group)
    D, El = x.shape[1], w_in.shape[0]
    dispatch, combine = router_dispatch(x, wg, capacity, top_k)  # [Bl, E, C]
    # this rank's tokens for every expert, grouped by the rank that owns it
    expert_in = torch.einsum("bec,bd->ecd", dispatch, x.float())
    recv = _AllToAll.apply(expert_in.reshape(n, El, capacity, D), group)
    tokens = recv.transpose(0, 1).reshape(El, n * capacity, D)  # [El, n C, D]
    out = _experts(tokens, w_in, w_out)
    # the reverse exchange: each rank's tokens' outputs go back to it
    back = _AllToAll.apply(out.reshape(El, n, capacity, D).transpose(0, 1), group)  # [n, El, C, D]
    return torch.einsum("bec,ecd->bd", combine, back.reshape(n * El, capacity, D)).to(x.dtype)


def moe_block_sharded(x: Tensor, wg: Tensor, w_in: Tensor, w_out: Tensor, mesh, capacity: int,
                      ep_axis: str = "ep", top_k: int = 2) -> Tensor:
    """The expert-parallel MoE block on a mesh from
    ``ray_tpu_torch.parallel.build_mesh`` (moe.py:118), local shards in and
    out, as ``shard_map``'s body sees them in JAX: this rank's tokens
    x [B / ep, D] (rows by its ep coordinate), the router wg [D, E] whole,
    its experts w_in [E / ep, D, F] and w_out [E / ep, F, D]; returns its
    tokens' outputs [B / ep, D]. The exchange runs over ``mesh[ep_axis]``."""
    return moe_block(x, wg, w_in, w_out, capacity, mesh[ep_axis].get_group(), top_k)

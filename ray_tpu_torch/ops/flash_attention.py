"""Flash attention: CUDA kernels for Hopper behind a torch.autograd.Function.

Counterpart of ``ray_tpu/ops/flash_attention.py``. The three Pallas TPU
kernels there (``_fwd_kernel``, ``_dq_kernel``, ``_dkv_kernel``) are
CUDA C++ kernels here (``csrc/flash_attention.cu`` with the Hopper helpers
of ``csrc/hopper.cuh``, built by ``_build``):

  - forward: persistent warp-specialised blocks (one per SM), a TMA-fed
    ring of K/V tiles and wgmma, online softmax over 128-key tiles in
    registers for 128 q rows at a time; writes o and the row lse;
  - dq: the forward's structure, 128 q rows at a time, a TMA-fed ring of
    64-key K/V tiles (to the diagonal when causal), wgmma for S, dP and
    dQ = dS K with K read a second time through the transpose bit;
  - dkv: persistent warp-specialised blocks, 128 keys at a time, a TMA-fed
    ring of Q/dO tiles from the diagonal on, wgmma.

Neither backward kernel uses atomics, so the gradients do not depend on
run order. Each kernel has a plain PyTorch version of the same function
in this module (``flash_fwd_reference``, ``flash_bwd_reference``): the CPU
runs it, because the tensors given lie on the CPU, and the card checks
the kernels against it. A CUDA tensor always goes to a kernel or raises.

Layout: the public entry takes and returns [B, T, H, Dh] (the JAX
package's model layout) and folds to [B*H, T, Dh] for the kernels. lse and
delta are [B*H, T] f32; the JAX kernel's [BH, 8, T] sublane layout is a
TPU tiling artefact and is not carried over.

Output type: the kernels write their outputs in the operands' bf16, or in
f32 with ``out_f32=True`` (a second instantiation of each kernel; the
operands stay bf16). Ring attention merges and accumulates its blocks in
f32 (``ops/ring_attention.py``), as the JAX package's block entries
``flash_fwd_block`` and ``flash_bwd_block`` do (flash_attention.py:376-398);
their counterparts here take the model layout and always return f32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ray_tpu_torch.ops import _build

_NEG_INF = -1e30
HEAD_DIMS = (16, 64)  # gpt2-tiny has 16; every GPT-2 size in CONFIGS has 64

# Kernel launches on CUDA tensors, one count per kernel (the plain versions
# are not counted), and of those the launches of the f32-output
# instantiation. chip_smoke.py zeroes these before a path and reads them
# after, to show the path went through the kernels.
launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
launches_f32 = dict.fromkeys(launches, 0)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Plain versions: the JAX kernels' math, on whole [BH, T, Dh] tensors.
# ---------------------------------------------------------------------------


def _scores(q: Tensor, k: Tensor, causal: bool) -> Tensor:
    """S = QK^T / sqrt(Dh) in f32 (scaled after the product), the causal
    mask written as -1e30, as in the JAX kernel (flash_attention.py:58-84)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        Tq, Tk = q.shape[-2], k.shape[-2]
        mask = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    return s


def _out(x: Tensor, like: Tensor, out_f32: bool) -> Tensor:
    return x if out_f32 else x.to(like.dtype)  # x is f32


def flash_fwd_reference(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                        out_f32: bool = False) -> Tuple[Tensor, Tensor]:
    """q [BH, Tq, Dh], k/v [BH, Tk, Dh] -> (o [BH, Tq, Dh] in q's dtype, or
    f32 with ``out_f32``, lse [BH, Tq] f32). p is cast to the input dtype
    before p@v."""
    s = _scores(q, k, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return _out(o, q, out_f32), (m + torch.log(l)).squeeze(-1)


def flash_dq_reference(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor,
                       delta: Tensor, causal: bool, out_f32: bool = False) -> Tensor:
    """dQ = dS K with P = exp(S - lse), dP = dO V^T, dS = P (dP - delta) / sqrt(Dh);
    dS is cast to k's dtype before the product (flash_attention.py:153-160)."""
    _, ds = _p_and_ds(q, k, v, do, lse, delta, causal)
    return _out(torch.matmul(ds.to(k.dtype).float(), k.float()), q, out_f32)


def flash_dkv_reference(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor,
                        delta: Tensor, causal: bool, out_f32: bool = False) -> Tuple[Tensor, Tensor]:
    """dK = dS^T Q and dV = P^T dO, P and dS cast to the input dtype before
    the products (flash_attention.py:187-200)."""
    p, ds = _p_and_ds(q, k, v, do, lse, delta, causal)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    return _out(dk, k, out_f32), _out(dv, v, out_f32)


def flash_bwd_reference(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor,
                        delta: Tensor, causal: bool,
                        out_f32: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv): the plain versions of both backward kernels."""
    dq = flash_dq_reference(q, k, v, do, lse, delta, causal, out_f32)
    return (dq, *flash_dkv_reference(q, k, v, do, lse, delta, causal, out_f32))


def _p_and_ds(q, k, v, do, lse, delta, causal):
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * scale


# ---------------------------------------------------------------------------
# Wrappers: CPU tensors -> plain version; CUDA tensors -> kernel (or raise).
# ---------------------------------------------------------------------------


def _check(q: Tensor, k: Tensor, v: Tensor, causal: bool, *more: Tensor) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("expected folded [B*H, T, Dh] operands")
    BH, Tq, D = q.shape
    if k.shape != v.shape or k.shape[0] != BH or k.shape[2] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if causal and k.shape[1] != Tq:
        raise ValueError("causal flash attention requires Tq == Tk")
    for t in more:  # dO like q; lse and delta [B*H, Tq]
        if t.shape != (q.shape if t.dim() == 3 else (BH, Tq)):
            raise ValueError(f"dO must match q and lse/delta must be [B*H, Tq], got {tuple(t.shape)}")
    devs = {t.device for t in (q, k, v, *more)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    if q.is_cuda:  # the plain versions that serve CPU tensors take any head dim
        if D not in HEAD_DIMS:
            raise ValueError(f"head dim {D} not supported (kernels take {HEAD_DIMS})")
        for t in (q, k, v, *more):
            want = torch.float32 if t.dim() == 2 else torch.bfloat16  # lse/delta vs operands
            if t.dtype != want:
                raise ValueError(f"the CUDA kernels take bf16 operands and f32 lse/delta, got {t.dtype}")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("kernel operands must be contiguous and 16-byte aligned")


def _launch(entry: str, counter: str, out_f32: bool, *args) -> None:
    """Call C entry point ``entry`` of the kernel library on the current
    stream with ``args`` and ``out_f32`` last: tensors go as device
    pointers, floats as float, the rest as int. Counts the launch once the
    entry point has reported no error."""
    lib = _build.load("flash_attention")
    fn = getattr(lib, entry)
    types, vals = [], []
    for a in (*args, out_f32):
        if isinstance(a, torch.Tensor):
            types.append(ctypes.c_void_p)
            vals.append(a.data_ptr())
        elif isinstance(a, float):
            types.append(ctypes.c_float)
            vals.append(a)
        else:
            types.append(ctypes.c_int)
            vals.append(int(a))
    fn.argtypes = types + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(lib, fn(*vals, torch.cuda.current_stream().cuda_stream), entry)
    launches[counter] += 1
    launches_f32[counter] += bool(out_f32)


def _empty_out(like: Tensor, out_f32: bool) -> Tensor:
    dtype = torch.float32 if out_f32 else like.dtype
    return torch.empty(like.shape, dtype=dtype, device=like.device)


@torch.no_grad()
def flash_fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool,
              out_f32: bool = False) -> Tuple[Tensor, Tensor]:
    """Folded forward: q [BH, Tq, Dh], k/v [BH, Tk, Dh] -> (o in q's dtype,
    or f32 with ``out_f32``, lse [BH, Tq] f32)."""
    _check(q, k, v, causal)
    if not q.is_cuda:
        return flash_fwd_reference(q, k, v, causal, out_f32)
    (BH, Tq, D), Tk = q.shape, k.shape[1]
    o = _empty_out(q, out_f32)
    lse = torch.empty(BH, Tq, dtype=torch.float32, device=q.device)
    _launch("rt_flash_fwd", "flash_fwd", out_f32, q, k, v, o, lse, BH, Tq, Tk, D,
            1.0 / math.sqrt(D), causal)
    return o, lse


@torch.no_grad()
def flash_dq(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor, delta: Tensor,
             causal: bool, out_f32: bool = False) -> Tensor:
    """Folded dQ against the row lse and delta = rowsum(dO * O), in q's
    dtype or f32."""
    _check(q, k, v, causal, do, lse, delta)
    if not q.is_cuda:
        return flash_dq_reference(q, k, v, do, lse, delta, causal, out_f32)
    (BH, Tq, D), Tk = q.shape, k.shape[1]
    dq = _empty_out(q, out_f32)
    _launch("rt_flash_dq", "flash_dq", out_f32, q, k, v, do, lse, delta, dq,
            BH, Tq, Tk, D, 1.0 / math.sqrt(D), causal)
    return dq


@torch.no_grad()
def flash_dkv(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor, delta: Tensor,
              causal: bool, out_f32: bool = False) -> Tuple[Tensor, Tensor]:
    """Folded (dK, dV) against the row lse and delta = rowsum(dO * O), in
    k's and v's dtype or f32."""
    _check(q, k, v, causal, do, lse, delta)
    if not q.is_cuda:
        return flash_dkv_reference(q, k, v, do, lse, delta, causal, out_f32)
    (BH, Tq, D), Tk = q.shape, k.shape[1]
    dk, dv = _empty_out(k, out_f32), _empty_out(v, out_f32)
    _launch("rt_flash_dkv", "flash_dkv", out_f32, q, k, v, do, lse, delta, dk, dv,
            BH, Tq, Tk, D, 1.0 / math.sqrt(D), causal)
    return dk, dv


def _fold(x: Tensor) -> Tensor:  # [B, T, H, D] -> [B*H, T, D], contiguous
    B, T, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, T, D).contiguous()


def _unfold(x: Tensor, B: int, H: int) -> Tensor:  # [B*H, T, D] -> [B, T, H, D]
    BH, T, D = x.shape
    return x.view(B, H, T, D).permute(0, 2, 1, 3)


# The forward as one dispatched op: a selective-checkpoint policy
# (models/gpt2.py) sees ops, not the ctypes launch inside, and on the CPU it
# would otherwise see the plain version's products. So the op, kernel or
# plain version alike, is what a remat policy decides on.
@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: Tensor, k: Tensor, v: Tensor, causal: bool) -> Tuple[Tensor, Tensor]:
    return flash_fwd(q, k, v, causal)


@_flash_fwd_op.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q), q.new_empty(q.shape[:2], dtype=torch.float32)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        B, _, H, _ = q.shape
        qf, kf, vf = _fold(q), _fold(k), _fold(v)
        o, lse = _flash_fwd_op(qf, kf, vf, causal)
        ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.causal, ctx.B, ctx.H = causal, B, H
        return _unfold(o, B, H)

    @staticmethod
    def backward(ctx, dout):
        qf, kf, vf, o, lse = ctx.saved_tensors
        B, H = ctx.B, ctx.H
        dof = _fold(dout)
        # delta = rowsum(dO * O) in f32, outside the kernels (flash_attention.py:359)
        delta = (dof.float() * o.float()).sum(-1)
        dq = flash_dq(qf, kf, vf, dof, lse, delta, ctx.causal)
        dk, dv = flash_dkv(qf, kf, vf, dof, lse, delta, ctx.causal)
        return _unfold(dq, B, H), _unfold(dk, B, H), _unfold(dv, B, H), None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = True) -> Tensor:
    """softmax(QK^T / sqrt(Dh)) V for q [B, Tq, H, Dh], k/v [B, Tk, H, Dh]
    (Tq == Tk when causal) -> [B, Tq, H, Dh], differentiable in q, k, v."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected [B, T, H, Dh] operands")
    return _FlashAttention.apply(q, k, v, causal)


# ---------------------------------------------------------------------------
# Block entries for ring attention (flash_attention.py:376-398): one visiting
# K/V block at the model layout, f32 outputs; the ring merges blocks through
# their lse and accumulates their gradients in f32.
# ---------------------------------------------------------------------------


def flash_fwd_block(q: Tensor, k: Tensor, v: Tensor, causal: bool) -> Tuple[Tensor, Tensor]:
    """One (q shard, K/V block) forward: q [B, Tq, H, Dh], k/v [B, Tk, H, Dh]
    (Tk may differ from Tq when not causal) -> (o [B, Tq, H, Dh] f32,
    normalised within the block, lse [B*H, Tq] f32)."""
    B, _, H, _ = q.shape
    o, lse = flash_fwd(_fold(q), _fold(k), _fold(v), causal, out_f32=True)
    return _unfold(o, B, H), lse


def flash_bwd_block(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor, delta: Tensor,
                    causal: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """One block's (dq contribution, dk, dv), f32 [B, T, H, Dh], against the
    GLOBAL lse and delta [B*H, Tq] of the q rows."""
    B, _, H, _ = q.shape
    qf, kf, vf, dof = _fold(q), _fold(k), _fold(v), _fold(do)
    dq = flash_dq(qf, kf, vf, dof, lse, delta, causal, out_f32=True)
    dk, dv = flash_dkv(qf, kf, vf, dof, lse, delta, causal, out_f32=True)
    return _unfold(dq, B, H), _unfold(dk, B, H), _unfold(dv, B, H)

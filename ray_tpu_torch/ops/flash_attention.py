"""Flash attention: CUDA kernels for Hopper behind a torch.autograd.Function.

Counterpart of ``ray_tpu/ops/flash_attention.py``. The three Pallas TPU
kernels there (``_fwd_kernel``, ``_dq_kernel``, ``_dkv_kernel``) are
CUDA C++ kernels here, instantiated for head dims 16, 32, 64, 128 and 256
(``HEAD_DIMS``), and they take every head dim from 1 up: a head dim
between two instances runs on the next one up (``instance_head_dim``), the
tensors at their own width, TMA filling the columns past it with zeros in
shared memory and the outputs written at the true width; a head dim above
256 runs on the column-window kernels (``csrc/flash_wide.cuh``, in every
library), which write their results as windows of at most 256 columns
(128 for dK/dV, ``WIDE_WINDOWS``), each window a grid slice of its own
that recomputes the scores over the whole head dim (``windows``); a head
dim whose rows are not 16-byte strided (not a multiple of 8 in bf16, of 4
in f32) is first copied into zero-padded tensors of the next such width
(``kernel_head_dim``) and its outputs sliced back. The scale is always 1 /
sqrt(the true head dim).
bf16 operands go to ``csrc/flash_attention.cu`` (with the Hopper helpers of
``csrc/hopper.cuh``), f16 operands to the same kernels instantiated for f16
(``csrc/flash_attention_f16.cu``), f32 operands to
``csrc/flash_attention_f32.cu`` (the
same functions at f32 accuracy, as the Pallas kernels compute them on f32
inputs: all three as 3xTF32 products on tf32 wgmma fed by TMA, each operand
split into two tf32 parts in shared memory; the forward, for
``_fwd_kernel``, with 128 q rows a block and an online softmax in
registers, bound by its 4 FLOPs per kept (q, key) pair and head-dim element
at a third of the TF32 rate), and operands of mixed dtypes to those f32
kernels instantiated with rounding (``csrc/flash_attention_mixed.cu``);
``_build`` builds the four libraries. The bf16 (and f16) library's kernels:

  - forward: persistent warp-specialised blocks (one per SM), a TMA-fed
    ring of K/V tiles and wgmma, online softmax over 128-key tiles (64 at
    head dim 256) in registers for 128 q rows at a time; writes o and the
    row lse;
  - dq: the forward's structure, 128 q rows at a time, a TMA-fed ring of
    64-key K/V tiles (to the diagonal when causal), wgmma for S, dP and
    dQ = dS K with K read a second time through the transpose bit;
  - dkv: persistent warp-specialised blocks, 128 keys at a time, a TMA-fed
    ring of Q/dO tiles from the diagonal on, wgmma; at head dim 256 a dV
    pass and a dK pass (one [64 x 256] accumulator each).
The f32 library at head dim 256 keeps a block's own rows raw in shared
memory and splits them into register fragments four k-steps at a time.
Above 256, all three functions in every library: blocks of (head, 64 rows,
a window of output columns), the contraction over the head dim streamed
in 128-byte chunks by cp.async, mma.sync (bf16/f16, or 3xTF32 on f32).

Neither backward kernel uses atomics, so the gradients do not depend on
run order. Each kernel has a plain PyTorch version of the same function
in this module (``flash_fwd_reference``, ``flash_bwd_reference``): the CPU
runs it, because the tensors given lie on the CPU, and the card checks
the kernels against it. A CUDA tensor always goes to a kernel or raises.

Layout: the public entry takes and returns [B, T, H, Dh] (the JAX
package's model layout) and folds to [B*H, T, Dh] for the kernels. lse and
delta are [B*H, T] f32; the JAX kernel's [BH, 8, T] sublane layout is a
TPU tiling artefact and is not carried over.

Types: lse and delta are f32; the operands are bf16, f16 or f32, all of one
dtype or mixed. All bf16 or all f16: the 16-bit kernels of that type, which
round P and dS to it before the products and write their outputs in it, or
in f32 with ``out_f32=True`` (a second instantiation of each kernel). All
f32: the f32 kernels, f32 outputs. Mixed (any q, k, v and dO whose dtypes
are not all one, a bf16/f16 mix included, as ``torch.promote_types`` does):
every operand cast up to f32 (exact), the f32 kernels built with rounding,
which round P and dS where the Pallas kernels cast them -- the forward's P
to v's dtype, dQ's dS to k's, dK/dV's P to dO's and dS to q's
(flash_attention.py:96, :158, :190, :197) -- and each f32 result cast back
to its operand's dtype (o and dq to q's, dk to k's, dv to v's) unless
``out_f32``. The plain versions round at the same places. Any other dtype
(f64, integers) on a CUDA tensor raises. Ring
attention merges and accumulates its blocks in f32
(``ops/ring_attention.py``), as the JAX package's block entries
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
HEAD_DIMS = (16, 32, 64, 128, 256)  # the head dims the kernels are instantiated for
# Above the widest instance, the column-window kernels' output columns a
# window (FWD_WIN, DQ_WIN and DKV_WIN of csrc/flash_wide.cuh).
WIDE_WINDOWS = {"flash_fwd": 256, "flash_dq": 256, "flash_dkv": 128}
# The kernel library of each operand dtype, and of a mix of them.
OPERAND_DTYPES = {torch.bfloat16: "flash_attention", torch.float16: "flash_attention_f16",
                  torch.float32: "flash_attention_f32"}
MIXED_LIBRARY = "flash_attention_mixed"
LIBRARIES = (*OPERAND_DTYPES.values(), MIXED_LIBRARY)
# The rounding types the f32-operand entry points take for P and dS (Round in
# csrc/hopper.cuh): to an operand's dtype before the product.
ROUNDING = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# Kernel launches on CUDA tensors, one count per kernel launched (the plain
# versions are not counted; a dK/dV call at head dim 256 launches its two
# passes, kernel_passes(); a column-window kernel is one launch, all its
# windows in its grid); of those the launches with f32 outputs (out_f32,
# or f32 operands, a mix's among them); and per instance, keyed by the head
# dim asked, the instance that ran and the operands' dtype or "mixed"
# (instance()). chip_smoke.py zeroes these before a path
# and reads them after, to show the path went through the kernels it should.
launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
launches_f32 = dict.fromkeys(launches, 0)
launches_by_instance: dict = {}
DKV_PASSES = {256: 2}  # dK/dV's kernels a call per instance (DKV_PASSES of Tiles<D>, F32Tiles<D>)


def instance_head_dim(head_dim: int) -> int:
    """The head dim of the instance that serves ``head_dim``: the narrowest
    of ``HEAD_DIMS`` that holds it, or ``head_dim`` itself above the widest
    (the column-window kernels take the true width)."""
    if head_dim < 1:
        raise ValueError(f"head dim {head_dim} not supported (the kernels take 1 and up)")
    return next((w for w in HEAD_DIMS if head_dim <= w), head_dim)


def windows(kernel: str, head_dim: int) -> int:
    """The column windows ``kernel`` writes its result in at ``head_dim``:
    one up to the widest instance, else the head dim over the kernel's
    window width (``WIDE_WINDOWS``), rounded up; each a grid slice of the
    one launch."""
    return 1 if instance_head_dim(head_dim) <= HEAD_DIMS[-1] else -(-head_dim // WIDE_WINDOWS[kernel])


def kernel_head_dim(head_dim: int, dtype: torch.dtype) -> int:
    """The width the kernel is given for ``head_dim``: the head dim itself
    when its rows are 16-byte strided (TMA's rule: a multiple of 8 bf16 or 4
    f32), else the next such width, to which the wrapper pads a copy."""
    per_16_bytes = 16 // dtype.itemsize
    return -(-head_dim // per_16_bytes) * per_16_bytes


def kernel_passes(kernel: str, head_dim: int) -> int:
    """The kernels one call of ``kernel`` at ``head_dim`` launches: two for
    dK/dV on the head dim 256 instance (a dV pass, then a dK pass), else
    one (a column-window kernel's windows included)."""
    return DKV_PASSES.get(instance_head_dim(head_dim), 1) if kernel == "flash_dkv" else 1


def instance(kernel: str, head_dim: int, dtype) -> str:
    """The key of ``launches_by_instance`` for ``kernel`` called at
    ``head_dim`` on operands of ``dtype`` (a torch dtype, or "mixed"):
    "flash_fwd d128 bfloat16" at an instance's own width, "flash_fwd d96 on
    d128 bfloat16" for a head dim that runs on a wider instance, "flash_fwd
    d384 on d256x2 bfloat16" above the widest (the column-window kernel,
    two windows of 256 columns), "flash_fwd d64 mixed" for operands of
    several dtypes."""
    width = instance_head_dim(head_dim)
    if width > HEAD_DIMS[-1]:
        on = f" on d{WIDE_WINDOWS[kernel]}x{windows(kernel, head_dim)}"
    else:
        on = "" if width == head_dim else f" on d{width}"
    return f"{kernel} d{head_dim}{on} {str(dtype).removeprefix('torch.')}"

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
    if q.is_cuda:  # the plain versions that serve CPU tensors take any head dim and dtype
        instance_head_dim(D)  # raises below 1
        for t in (q, k, v, *more):
            if t.dim() == 3 and t.dtype not in OPERAND_DTYPES:
                raise ValueError(f"the CUDA kernels take bf16, f16 or f32 operands, got {t.dtype}")
            if t.dim() == 2 and t.dtype != torch.float32:
                raise ValueError(f"the CUDA kernels take f32 lse and delta, got {t.dtype}")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("kernel operands must be contiguous and 16-byte aligned")


def _mixed(*operands: Tensor) -> bool:
    """Whether the operands are of several dtypes (the mixed route)."""
    return len({t.dtype for t in operands}) > 1


def _as_f32(mixed: bool, *operands: Tensor) -> Tuple[Tensor, ...]:
    """The operands as the kernels take them: a mix's cast up to f32 (exact
    for bf16 and f16), else themselves."""
    return tuple(t.float() for t in operands) if mixed else operands


def _back(x: Tensor, like: Tensor, mixed: bool, out_f32: bool) -> Tensor:
    """A mix's f32 result in its operand's dtype (``like``), unless f32
    outputs were asked for; any other result as it is."""
    return x.to(like.dtype) if mixed and not out_f32 else x


def _launch(entry: str, counter: str, head_dim: int, out_f32: bool, *args, rounding=None) -> None:
    """Call C entry point ``entry`` of the kernel library for the operands'
    dtype (``args[0]`` is q), or of a mix when ``rounding`` is given (the
    ROUNDING types of P and of dS, the operands already cast to f32), on the
    current stream with ``args`` and ``out_f32`` last (then the two rounding
    types, for the f32 and mixed libraries): tensors go as device pointers,
    floats as float, the rest as int. Counts the kernels it launched once
    the entry point has reported no error, under the head dim the caller
    asked for (``head_dim``)."""
    q = args[0]
    lib = _build.load(OPERAND_DTYPES[q.dtype] if rounding is None else MIXED_LIBRARY)
    fn = getattr(lib, entry)
    types, vals = [], []
    tail = (out_f32, *(rounding or (0, 0))) if q.dtype == torch.float32 else (out_f32,)
    for a in (*args, *tail):
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
    n = kernel_passes(counter, head_dim)
    launches[counter] += n
    launches_f32[counter] += n if out_f32 or q.dtype == torch.float32 else 0
    key = instance(counter, head_dim, q.dtype if rounding is None else "mixed")
    launches_by_instance[key] = launches_by_instance.get(key, 0) + n


def _empty_out(like: Tensor, out_f32: bool) -> Tensor:
    dtype = torch.float32 if out_f32 else like.dtype
    return torch.empty(like.shape, dtype=dtype, device=like.device)


def _widen(*xs: Tensor) -> Tuple[Tensor, ...]:
    """The [BH, T, Dh] operands as the kernel takes them: themselves, or
    copies zero-padded to ``kernel_head_dim`` (zero columns change no score
    and no real column of a result)."""
    D = xs[0].shape[-1]
    width = kernel_head_dim(D, xs[0].dtype)
    if width == D:
        return xs
    return tuple(torch.nn.functional.pad(x, (0, width - D)) for x in xs)


def _narrow(x: Tensor, D: int) -> Tensor:
    """A kernel's [BH, T, width] output back at head dim D."""
    return x if x.shape[-1] == D else x[..., :D].contiguous()


@torch.no_grad()
def flash_fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool,
              out_f32: bool = False) -> Tuple[Tensor, Tensor]:
    """Folded forward: q [BH, Tq, Dh], k/v [BH, Tk, Dh] (bf16, f16 or f32,
    or a mix) -> (o in q's dtype, or f32 with ``out_f32``, lse [BH, Tq]
    f32)."""
    _check(q, k, v, causal)
    if not q.is_cuda:
        return flash_fwd_reference(q, k, v, causal, out_f32)
    (BH, Tq, D), Tk = q.shape, k.shape[1]
    mixed = _mixed(q, k, v)
    qw, kw, vw = _widen(*_as_f32(mixed, q, k, v))
    o = _empty_out(qw, out_f32)
    lse = torch.empty(BH, Tq, dtype=torch.float32, device=q.device)
    _launch("rt_flash_fwd", "flash_fwd", D, out_f32, qw, kw, vw, o, lse, BH, Tq, Tk, qw.shape[-1],
            1.0 / math.sqrt(D), causal, rounding=(ROUNDING[v.dtype], 0) if mixed else None)
    return _back(_narrow(o, D), q, mixed, out_f32), lse


@torch.no_grad()
def flash_dq(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor, delta: Tensor,
             causal: bool, out_f32: bool = False) -> Tensor:
    """Folded dQ against the row lse and delta = rowsum(dO * O), in q's
    dtype or f32."""
    _check(q, k, v, causal, do, lse, delta)
    if not q.is_cuda:
        return flash_dq_reference(q, k, v, do, lse, delta, causal, out_f32)
    (BH, Tq, D), Tk = q.shape, k.shape[1]
    mixed = _mixed(q, k, v, do)
    qw, kw, vw, dow = _widen(*_as_f32(mixed, q, k, v, do))
    dq = _empty_out(qw, out_f32)
    _launch("rt_flash_dq", "flash_dq", D, out_f32, qw, kw, vw, dow, lse, delta, dq,
            BH, Tq, Tk, qw.shape[-1], 1.0 / math.sqrt(D), causal,
            rounding=(0, ROUNDING[k.dtype]) if mixed else None)
    return _back(_narrow(dq, D), q, mixed, out_f32)


@torch.no_grad()
def flash_dkv(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor, delta: Tensor,
              causal: bool, out_f32: bool = False) -> Tuple[Tensor, Tensor]:
    """Folded (dK, dV) against the row lse and delta = rowsum(dO * O), in
    k's and v's dtype or f32."""
    _check(q, k, v, causal, do, lse, delta)
    if not q.is_cuda:
        return flash_dkv_reference(q, k, v, do, lse, delta, causal, out_f32)
    (BH, Tq, D), Tk = q.shape, k.shape[1]
    mixed = _mixed(q, k, v, do)
    qw, kw, vw, dow = _widen(*_as_f32(mixed, q, k, v, do))
    dk, dv = _empty_out(kw, out_f32), _empty_out(vw, out_f32)
    _launch("rt_flash_dkv", "flash_dkv", D, out_f32, qw, kw, vw, dow, lse, delta, dk, dv,
            BH, Tq, Tk, qw.shape[-1], 1.0 / math.sqrt(D), causal,
            rounding=(ROUNDING[do.dtype], ROUNDING[q.dtype]) if mixed else None)
    return _back(_narrow(dk, D), k, mixed, out_f32), _back(_narrow(dv, D), v, mixed, out_f32)


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

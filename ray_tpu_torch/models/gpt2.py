"""GPT-2 in PyTorch (counterpart of ``ray_tpu/models/gpt2.py``).

Same architecture and numerics as the JAX model: pre-LN blocks, learned
positions, tanh-GELU, a tied LM head over a vocabulary padded to a multiple
of 128, f32 master parameters cast to the compute dtype on every forward,
layernorm and logits in f32. Attention goes through
``ray_tpu_torch.ops.attention`` (``"reference"`` or the hand-written
``"flash"`` kernels).

Remat: ``remat`` recomputes each block in the backward under one of the JAX
model's four policies (``remat_policy``), through ``torch.utils.checkpoint``
with a selective-checkpoint policy that keeps, per layer, what the JAX
model keeps (``REMAT_KEEPS``).

Sharding: ``ray_tpu_torch.parallel.shard_model`` places the model on a
mesh (FSDP2 over the data axes, Megatron-style tensor parallelism over
tp). The blocks, the embedding and the loss then compute on this rank's
shards: its heads, its slice of the MLP hidden width and of the
vocabulary, with the collectives of ``parallel/tensor_parallel.py``; with
no tp group they compute as they do unsharded. ``make_train_step`` runs
unchanged on such a model.

The JAX model stacks its layers on a leading L axis for ``lax.scan``; here
each layer is its own module, iterated by a Python loop. ``from_jax`` and
``to_jax`` convert between the two layouts, so parameters and gradients
compare leaf by leaf with the JAX pytree.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import attention as attention_op
from ray_tpu_torch.parallel.tensor_parallel import all_reduce_, copy_to, reduce_from

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Remat policies (gpt2.py:187-205). What JAX keeps of a layer for its
# backward under each policy, beside the layer's input x (its residuals,
# jax.ad_checkpoint.print_saved_residuals, gpt2-tiny, attn_impl="flash"):
#   full           nothing more: the whole block is recomputed;
#   dots           the qkv, proj and fc_in products (dots with no batch
#                  dimension). fc_out's product is saveable too, but no
#                  backward needs it, so JAX keeps nothing of it;
#   dots_saveable  those and the attention output ("attn_out"); and with
#                  reference attention its batched products (any dot);
#   attn_out       the attention output.
# None keeps the flash kernel's lse, so every policy re-runs the flash
# forward in the backward, in JAX and here.
#
# torch.utils.checkpoint's selective policy decides op by op on what is
# dispatched in the forward. The block's four products are one aten.mm
# each, issued in the order of _PRODUCTS; under a policy that keeps it, the
# attention output is tagged by the op checkpoint_name
# (jax.ad_checkpoint.checkpoint_name's counterpart), a copy that the other
# policies do not pay for;
# the flash forward is one op (ops/flash_attention.py) that no policy keeps.
# ---------------------------------------------------------------------------

REMAT_KEEPS = {
    "full": (),
    "dots": ("qkv", "proj", "fc_in"),
    "dots_saveable": ("qkv", "proj", "fc_in", "attn_out"),
    "attn_out": ("attn_out",),
}
_PRODUCTS = ("qkv", "proj", "fc_in", "fc_out")


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    d_model: int = 768
    n_layer: int = 12
    n_head: int = 12
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32
    # Recompute each block in the backward pass (torch.utils.checkpoint),
    # keeping per layer what remat_policy says (REMAT_KEEPS). scan_unroll,
    # an XLA knob, is not ported: setting it raises.
    remat: bool = True
    remat_policy: str = "full"  # full | dots | dots_saveable | attn_out
    attn_impl: str = "reference"  # reference | flash
    # Cross-entropy in T-chunks of this many tokens, so the [B, T, V] f32
    # logits never exist at once. 0 disables chunking.
    loss_chunk: int = 128
    # "chunked": per-chunk CE under checkpoint (logits recomputed in the
    # backward). "fused": the CE emits bf16 dlogits in the forward; the
    # backward is two matmuls.
    loss_impl: str = "chunked"

    def __post_init__(self):
        if self.loss_impl not in ("chunked", "fused"):
            raise ValueError(f"unknown loss_impl {self.loss_impl!r}")
        if self.remat_policy not in REMAT_KEEPS:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def d_ff(self) -> int:
        return 4 * self.d_model

    def num_params(self) -> int:
        d, l, v = self.d_model, self.n_layer, self.padded_vocab
        per_layer = 4 * d * d + 2 * 4 * d * d + 3 * d + 4 * d + 2 * 2 * d + d
        return v * d + self.n_positions * d + l * per_layer + 2 * d


# The JAX package's configs, same names and sizes.
CONFIGS = {
    "gpt2-small": GPT2Config(),
    "gpt2-medium": GPT2Config(d_model=1024, n_layer=24, n_head=16),
    "gpt2-large": GPT2Config(d_model=1280, n_layer=36, n_head=20),
    "gpt2-xl": GPT2Config(d_model=1600, n_layer=48, n_head=25),
    "gpt2-tiny": GPT2Config(  # tests / dryruns
        vocab_size=256, n_positions=128, d_model=64, n_layer=2, n_head=4,
        remat=False,
    ),
}


# ---------------------------------------------------------------------------
# The remat policies' machinery (see REMAT_KEEPS)
# ---------------------------------------------------------------------------


@torch.library.custom_op("ray_tpu_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` under ``name``, for a remat policy to keep: a contiguous copy
    (a custom op returns a tensor of its own), whose gradient passes
    through."""
    return x.clone(memory_format=torch.contiguous_format)


@checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


checkpoint_name.register_autograd(lambda ctx, grad: (grad, None))


class _KeepPolicy:
    """The selective-checkpoint policy of one block call under
    ``REMAT_KEEPS[name]``: keep those outputs, recompute the rest. It counts
    the block's products to name them, separately in the forward and in the
    recompute (torch versions that ask the policy again there)."""

    def __init__(self, name: str):
        self.keep = REMAT_KEEPS[name]
        self.batched = name == "dots_saveable"
        self.products = {False: 0, True: 0}

    def __call__(self, ctx, op, *args, **kwargs):
        if op is torch.ops.aten.mm.default:
            i = self.products[ctx.is_recompute]
            self.products[ctx.is_recompute] += 1
            keep = i < len(_PRODUCTS) and _PRODUCTS[i] in self.keep
        elif op is torch.ops.aten.bmm.default:
            keep = self.batched
        elif op is torch.ops.ray_tpu_torch.checkpoint_name.default:
            keep = args[1] in self.keep
        else:
            keep = False
        return CheckpointPolicy.MUST_SAVE if keep else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(name: str):
    return create_selective_checkpoint_contexts(_KeepPolicy(name))


# ---------------------------------------------------------------------------
# Modules. Parameter names follow the JAX pytree's keys (ln1.scale,
# attn.qkv.kernel, mlp.fc_out.bias, ...), with the layer index after
# "blocks".
# ---------------------------------------------------------------------------


def _param(shape, cfg: GPT2Config, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))


class _LayerNorm(nn.Module):
    def __init__(self, d: int, cfg: GPT2Config, device):
        super().__init__()
        self.scale = _param((d,), cfg, device)
        self.bias = _param((d,), cfg, device)

    def forward(self, x):
        # f32, population variance, eps 1e-5 (gpt2.py:137-142)
        y = F.layer_norm(x.float(), (x.shape[-1],), self.scale.float(), self.bias.float(), 1e-5)
        return y.to(x.dtype)


class _Dense(nn.Module):
    """A kernel and a bias in the JAX layout; the product flattens them."""

    def __init__(self, kernel_shape, bias_shape, cfg: GPT2Config, device):
        super().__init__()
        self.kernel = _param(kernel_shape, cfg, device)
        self.bias = _param(bias_shape, cfg, device)

    def forward(self, x, dt: torch.dtype, reduce_over=None):
        # x [..., n_in] @ kernel [n_in, n_out] + bias, operands in dt (the
        # JAX einsum and its bias add, both in the compute dtype). A
        # row-parallel product (``reduce_over`` its tp group) is summed
        # over the group before the bias, which is added once.
        y = torch.matmul(x, self.kernel.to(dt).reshape(x.shape[-1], -1))
        return reduce_from(y, reduce_over) + self.bias.to(dt).reshape(-1)


class Block(nn.Module):
    """One pre-LN transformer block (the JAX model's scan body). Under
    tensor parallelism (``tp``, set by ``shard_model``) its parameters are
    this rank's shards: qkv and fc_in column-parallel (its heads, its slice
    of the hidden width), proj and fc_out row-parallel."""

    tp = None

    def __init__(self, cfg: GPT2Config, device):
        super().__init__()
        d, h, hd, f = cfg.d_model, cfg.n_head, cfg.head_dim, cfg.d_ff
        self.ln1 = _LayerNorm(d, cfg, device)
        self.ln2 = _LayerNorm(d, cfg, device)
        self.attn = nn.ModuleDict({
            "qkv": _Dense((d, 3, h, hd), (3, h, hd), cfg, device),
            "proj": _Dense((h, hd, d), (d,), cfg, device),
        })
        self.mlp = nn.ModuleDict({
            "fc_in": _Dense((d, f), (f,), cfg, device),
            "fc_out": _Dense((f, d), (d,), cfg, device),
        })

    def forward(self, x, cfg: GPT2Config):
        if cfg.remat:
            context = (noop_context_fn if cfg.remat_policy == "full"
                       else functools.partial(_remat_context, cfg.remat_policy))
            return checkpoint(self._forward, x, cfg, use_reentrant=False, context_fn=context)
        return self._forward(x, cfg)

    def _forward(self, x, cfg: GPT2Config):
        dt, tp = cfg.dtype, self.tp
        B, T, _ = x.shape
        heads = self.attn["qkv"].kernel.shape[2]  # this rank's: H / tp
        h = copy_to(self.ln1(x), tp)
        qkv = self.attn["qkv"](h, dt).view(B, T, 3, heads, cfg.head_dim)
        q, k, v = qkv.unbind(2)  # [B, T, H, Dh]
        att = attention_op(q, k, v, causal=True, impl=cfg.attn_impl)
        if cfg.remat and "attn_out" in REMAT_KEEPS[cfg.remat_policy]:
            att = checkpoint_name(att, "attn_out")
        x = x + self.attn["proj"](att.reshape(B, T, -1), dt, tp)
        h = copy_to(self.ln2(x), tp)
        h = F.gelu(self.mlp["fc_in"](h, dt), approximate="tanh")
        return x + self.mlp["fc_out"](h, dt, tp)


class GPT2(nn.Module):
    """Parameters are allocated, not initialised: use ``init`` (random, from
    a generator) or ``from_jax`` (the JAX package's parameters). After
    ``shard_model``, ``tp`` is the tp group that splits the vocabulary (and
    the blocks' widths) and ``data`` the group over the data axes that
    splits the batch; both are None on a model that is not sharded."""

    tp = None
    data = None

    def __init__(self, cfg: GPT2Config, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d = cfg.d_model
        self.wte = _param((cfg.padded_vocab, d), cfg, device)
        self.wpe = _param((cfg.n_positions, d), cfg, device)
        self.blocks = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layer))
        self.ln_f = _LayerNorm(d, cfg, device)

    def backbone(self, tokens: torch.Tensor, cfg: Optional[GPT2Config] = None) -> torch.Tensor:
        """tokens [B, T] -> final hidden states [B, T, D] (compute dtype).
        ``cfg`` may differ from the model's in its numerics options
        (attn_impl, loss_impl, remat, ...), never in its widths."""
        cfg = cfg or self.cfg
        T = tokens.shape[1]
        dt = cfg.dtype
        # gather then cast: the same values as casting the table first
        x = self._embed(tokens).to(dt) + self.wpe[:T].to(dt)[None]
        for blk in self.blocks:
            x = blk(x, cfg)
        return self.ln_f(x)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The rows of wte for ``tokens`` (f32). Under tp each rank looks up
        the ids in its slice of the vocabulary, zeros the rest and the rows
        are summed over the group."""
        if self.tp is None:
            return F.embedding(tokens, self.wte)
        rows = self.wte.shape[0]
        local = tokens - self.tp.rank * rows
        own = (local >= 0) & (local < rows)
        found = F.embedding(local.clamp(0, rows - 1), self.wte).masked_fill(~own[..., None], 0.0)
        return reduce_from(found, self.tp)

    def loss(self, tokens: torch.Tensor, cfg: Optional[GPT2Config] = None) -> torch.Tensor:
        """``loss_fn``: a method, so that FSDP2 gathers the root's
        parameters around it as around ``forward``."""
        cfg = cfg or self.cfg
        tokens = tokens.long()
        x = self.backbone(tokens[:, :-1], cfg)
        return head_loss(x, self.wte.to(cfg.dtype), tokens[:, 1:], cfg, self.tp)

    def forward(self, tokens: torch.Tensor, cfg: Optional[GPT2Config] = None) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, padded_vocab] (f32)."""
        cfg = cfg or self.cfg
        if self.tp is not None:
            raise NotImplementedError("GPT2.forward on a tensor-parallel model: its logits are "
                                      "split over the vocabulary (use loss_fn)")
        x = self.backbone(tokens, cfg)
        # tied head: compute-dtype operands, f32 result. Written as an f32
        # product of the upcast operands, which is exact for bf16 inputs and
        # keeps autograd (torch.mm's out_dtype overload has no derivative);
        # off the train step's path, which uses _mm_f32 in the fused loss.
        wte = self.wte.to(cfg.dtype)
        return torch.matmul(x.float(), wte.float().t())


def init(generator: torch.Generator, cfg: GPT2Config, device: DeviceLike = None) -> GPT2:
    """A model with random parameters drawn from ``generator`` (which lives
    on ``device``), at the JAX init's scales (gpt2.py:94-134)."""
    model = GPT2(cfg, device)
    std = 0.02
    proj_std = std / math.sqrt(2 * cfg.n_layer)  # GPT-2 residual-scale init
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in ("wte", "wpe") or name.endswith(("qkv.kernel", "fc_in.kernel")):
                p.normal_(0.0, std, generator=generator)
            elif name.endswith(("proj.kernel", "fc_out.kernel")):
                p.normal_(0.0, proj_std, generator=generator)
            elif leaf == "scale":
                p.fill_(1.0)
            else:
                p.zero_()
    return model


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] with an f32 result from compute-dtype operands,
    as the JAX einsum's preferred_element_type=f32 (f32 accumulation, no
    rounding of the product). On CUDA: torch.mm's out_dtype overload (the
    tensor cores, f32 out). On the CPU, which lacks that overload: the f32
    product of the upcast operands, exact for bf16 inputs."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _vocab_slice(tp, rows: int, device) -> Tuple[int, torch.Tensor]:
    """(first id, the global ids) of this rank's ``rows`` of the vocabulary."""
    lo = 0 if tp is None else tp.rank * rows
    return lo, torch.arange(lo, lo + rows, device=device)


def _local_targets(targets: torch.Tensor, lo: int, rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(targets as indices into this rank's ``rows`` of the vocabulary from
    id ``lo`` on, clamped; whether it owns each)."""
    local = targets - lo
    return local.clamp(0, rows - 1), (local >= 0) & (local < rows)


def _chunk_nll(x_chunk, targets_chunk, wte, cfg: GPT2Config, tp=None) -> torch.Tensor:
    """Cross-entropy over one T-chunk; returns the summed NLL (f32 scalar).
    Under tp, ``wte`` is this rank's slice of the vocabulary and the
    softmax's max, sum and the target's logit are taken over the group."""
    logits = torch.matmul(x_chunk.float(), wte.float().t())  # see GPT2.forward
    lo, ids = _vocab_slice(tp, wte.shape[0], logits.device)
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits.masked_fill(ids >= cfg.vocab_size, _NEG_INF)
    if tp is None:
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, targets_chunk[..., None]).sum()
    # the max only steadies the exponentials: no gradient flows through it
    m = all_reduce_(logits.detach().amax(-1, keepdim=True), tp, dist.ReduceOp.MAX)
    sum_exp = reduce_from(torch.exp(logits - m).sum(-1, keepdim=True), tp)
    local, own = _local_targets(targets_chunk[..., None], lo, wte.shape[0])
    target = reduce_from(logits.gather(-1, local).masked_fill(~own, 0.0), tp)
    return (m + torch.log(sum_exp) - target).sum()


class _FusedCE(torch.autograd.Function):
    """Chunked CE that emits dlogits = softmax - onehot (compute dtype)
    during the forward (gpt2.py:238-300): the [B, T, V] f32 logits never
    exist at once, and the backward is two matmuls, dx = dl @ wte and
    dwte = dl^T @ x, with no recompute. One f32 logits chunk is live at a
    time.

    Under tp (vocabulary-parallel), ``wte`` is this rank's rows: the max,
    the sum of exponentials and the target's logit are all-reduced over the
    group, the padded ids are masked by their global index, dx is a partial
    sum (all-reduced in the backward) and dwte stays local."""

    @staticmethod
    def forward(ctx, x, wte, targets, n_chunks: int, vocab_size: int, tp=None):
        B, T, D = x.shape
        V = wte.shape[0]
        C = T // n_chunks
        dl = torch.empty(B, T, V, dtype=x.dtype, device=x.device)
        nll = torch.zeros((), dtype=torch.float32, device=x.device)
        lo, ids = _vocab_slice(tp, V, x.device)
        pad = ids >= vocab_size
        wte_t = wte.t()
        for c in range(n_chunks):
            sl = slice(c * C, (c + 1) * C)
            tc = targets[:, sl, None]
            if tp is not None:
                tc, own = _local_targets(tc, lo, V)
            logits = _mm_f32(x[:, sl].reshape(B * C, D), wte_t).view(B, C, V)
            if lo + V > vocab_size:
                logits.masked_fill_(pad, _NEG_INF)
            m = logits.amax(-1, keepdim=True)
            if tp is not None:
                all_reduce_(m, tp, dist.ReduceOp.MAX)
            e = torch.exp(logits - m)
            s = e.sum(-1, keepdim=True)
            target = logits.gather(-1, tc)
            if tp is not None:  # one all-reduce for both sums
                both = all_reduce_(torch.cat([s, target.masked_fill(~own, 0.0)], -1), tp)
                s, target = both[..., :1], both[..., 1:]
            lse = m + torch.log(s)
            nll += (lse - target).sum()
            p = e.div_(s)
            minus_one = torch.full_like(tc, -1.0, dtype=p.dtype)
            if tp is not None:
                minus_one = minus_one * own
            p.scatter_add_(-1, tc, minus_one)  # p - onehot
            dl[:, sl] = p
        ctx.save_for_backward(x, wte, dl)
        ctx.tp = tp
        return nll / (B * T)

    @staticmethod
    def backward(ctx, g):
        x, wte, dl = ctx.saved_tensors
        B, T, D = x.shape
        V = wte.shape[0]
        scale = g / (B * T)
        dl2 = dl.view(B * T, V)
        dx = torch.matmul(dl2, wte)  # compute-dtype product; a partial sum under tp
        if ctx.tp is not None:
            all_reduce_(dx, ctx.tp)
        dx = dx.view(B, T, D) * scale.to(x.dtype)
        dwte = _mm_f32(dl2.t(), x.reshape(B * T, D)) * scale
        return dx.to(x.dtype), dwte, None, None, None, None


def loss_fn(model: GPT2, tokens: torch.Tensor, cfg: Optional[GPT2Config] = None) -> torch.Tensor:
    """Next-token cross-entropy over tokens [B, T+1], padded-vocab logits
    masked; the mean over B*T tokens (gpt2.py:303-344)."""
    return model.loss(tokens, cfg)


def head_loss(x: torch.Tensor, wte: torch.Tensor, targets: torch.Tensor,
              cfg: GPT2Config, tp=None) -> torch.Tensor:
    """The tied LM head and its cross-entropy: final hidden states x
    [B, T, D], the embedding in the compute dtype, targets [B, T] (int64)
    -> mean NLL over B*T, by ``cfg.loss_impl``. Under ``tp`` (the group
    that splits the vocabulary), ``wte`` is this rank's rows."""
    B, T, D = x.shape
    if cfg.loss_impl == "fused":
        n_chunks = max(1, T // max(1, cfg.loss_chunk)) if cfg.loss_chunk else 1
        while T % n_chunks:
            n_chunks -= 1
        return _FusedCE.apply(x, wte, targets, n_chunks, cfg.vocab_size, tp)
    x = copy_to(x, tp)  # each rank's logits give a part of x's gradient
    C = cfg.loss_chunk
    if C <= 0 or T <= C:
        return _chunk_nll(x, targets, wte, cfg, tp) / (B * T)
    # full chunks, then one remainder chunk (T is often seq-1, e.g. 1023)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, T, C):
        xc, tc = x[:, c0:c0 + C], targets[:, c0:c0 + C]
        total = total + checkpoint(_chunk_nll, xc, tc, wte, cfg, tp, use_reentrant=False)
    return total / (B * T)


def local_rows(model: GPT2, tokens: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the global batch ``tokens`` on a model placed by
    ``parallel.shard_model``: the split of ``batch_spec``, over dcn x dp x
    fsdp in that order, the same on the ranks of a tp group. All of them on
    a model that is not sharded."""
    data = model.data
    if data is None:
        return tokens
    if tokens.shape[0] % data.size:
        raise ValueError(f"a batch of {tokens.shape[0]} rows does not split over "
                         f"{data.size} data shards")
    return tokens.chunk(data.size)[data.rank]


def data_mean(model: GPT2, value: torch.Tensor) -> torch.Tensor:
    """A per-rank mean (a 0-dim tensor) averaged over the data axes: the
    global batch's. ``value`` itself on a model that is not sharded."""
    if model.data is None:
        return value
    return all_reduce_(value.detach().clone(), model.data) / model.data.size


def make_train_step(model: GPT2, optimizer: torch.optim.Optimizer):
    """Returns train_step(tokens [B, T+1]) -> loss (a 0-dim tensor on the
    model's device): one forward, backward and optimizer step.

    On a model placed by ``parallel.shard_model`` the step means what the
    JAX step means under ``batch_spec``: every rank is given the global
    batch and takes its rows (``local_rows``); the loss is the mean over
    the global batch; FSDP2 averages the gradients over the data axes."""
    device = model.wte.device

    def train_step(tokens) -> torch.Tensor:
        tokens = local_rows(model, torch.as_tensor(tokens, device=device))
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens)
        loss.backward()
        optimizer.step()
        return data_mean(model, loss.detach())

    return train_step


# ---------------------------------------------------------------------------
# Conversion to and from the JAX parameter pytree (nested dicts of numpy
# arrays, layers stacked on a leading L axis under "blocks").
# ---------------------------------------------------------------------------


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def from_jax(params: Dict[str, Any], cfg: GPT2Config, device: DeviceLike = None) -> GPT2:
    """A model holding the JAX ``gpt2.init`` pytree's values: both then
    compute the same function."""
    model = GPT2(cfg, device)
    own = dict(model.named_parameters())
    with torch.no_grad():
        for name, leaf in _flatten(params):
            arr = torch.from_numpy(np.array(leaf, dtype=np.float32))
            if name.startswith("blocks."):
                rest = name[len("blocks."):]
                for i in range(cfg.n_layer):
                    own.pop(f"blocks.{i}.{rest}").copy_(arr[i])
            else:
                own.pop(name).copy_(arr)
    if own:
        raise ValueError(f"JAX pytree lacks {sorted(own)}")
    return model


def to_jax(model: GPT2, grads: bool = False) -> Dict[str, Any]:
    """The model's parameters (or, with ``grads``, their .grad) in the JAX
    pytree layout, as f32 numpy arrays. On a model placed by
    ``shard_model`` the parameters are gathered whole first (collective:
    every rank of its mesh calls it)."""
    if model.data is not None:
        from ray_tpu_torch.parallel.sharding import full_parameters

        named = full_parameters(model, grads).items()
    else:
        named = ((n, p.grad if grads else p) for n, p in model.named_parameters())
    out: Dict[str, Any] = {}
    per_layer: Dict[str, list] = {}
    for name, t in named:
        arr = t.detach().float().cpu().numpy()
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            per_layer.setdefault(rest, []).append(arr)
        else:
            _set(out, name, arr)
    for rest, arrs in per_layer.items():
        _set(out, f"blocks.{rest}", np.stack(arrs))
    return out


def _set(tree: Dict[str, Any], dotted: str, val) -> None:
    *path, leaf = dotted.split(".")
    for key in path:
        tree = tree.setdefault(key, {})
    tree[leaf] = val

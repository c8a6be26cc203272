"""GPT-2 in PyTorch (counterpart of ``ray_tpu/models/gpt2.py``).

Same architecture and numerics as the JAX model: pre-LN blocks, learned
positions, tanh-GELU, a tied LM head over a vocabulary padded to a multiple
of 128, f32 master parameters cast to the compute dtype on every forward,
layernorm and logits in f32. Attention goes through
``ray_tpu_torch.ops.attention`` (``"reference"`` or the hand-written
``"flash"`` kernels).

The JAX model stacks its layers on a leading L axis for ``lax.scan``; here
each layer is its own module, iterated by a Python loop. ``from_jax`` and
``to_jax`` convert between the two layouts, so parameters and gradients
compare leaf by leaf with the JAX pytree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import attention as attention_op

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    d_model: int = 768
    n_layer: int = 12
    n_head: int = 12
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32
    # Recompute each whole block in the backward pass (torch.utils.checkpoint),
    # the JAX model's remat_policy="full". Its selective policies are not
    # ported, nor is scan_unroll (an XLA knob): setting either raises.
    remat: bool = True
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

    def forward(self, x, n_in: int, dt: torch.dtype):
        # x [..., n_in] @ kernel [n_in, n_out] + bias, operands in dt (the
        # JAX einsum and its bias add, both in the compute dtype)
        w = self.kernel.to(dt).reshape(n_in, -1)
        return torch.matmul(x, w) + self.bias.to(dt).reshape(-1)


class Block(nn.Module):
    """One pre-LN transformer block (the JAX model's scan body)."""

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
        dt = cfg.dtype
        B, T, D = x.shape
        h = self.ln1(x)
        qkv = self.attn["qkv"](h, D, dt).view(B, T, 3, cfg.n_head, cfg.head_dim)
        q, k, v = qkv.unbind(2)  # [B, T, H, Dh]
        att = attention_op(q, k, v, causal=True, impl=cfg.attn_impl)
        x = x + self.attn["proj"](att.reshape(B, T, D), D, dt)
        h = self.ln2(x)
        h = F.gelu(self.mlp["fc_in"](h, D, dt), approximate="tanh")
        return x + self.mlp["fc_out"](h, cfg.d_ff, dt)


class GPT2(nn.Module):
    """Parameters are allocated, not initialised: use ``init`` (random, from
    a generator) or ``from_jax`` (the JAX package's parameters)."""

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
        x = F.embedding(tokens, self.wte).to(dt) + self.wpe[:T].to(dt)[None]
        for blk in self.blocks:
            if cfg.remat:
                x = checkpoint(blk, x, cfg, use_reentrant=False)
            else:
                x = blk(x, cfg)
        return self.ln_f(x)

    def forward(self, tokens: torch.Tensor, cfg: Optional[GPT2Config] = None) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, padded_vocab] (f32)."""
        cfg = cfg or self.cfg
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


def _chunk_nll(x_chunk, targets_chunk, wte, cfg: GPT2Config) -> torch.Tensor:
    """Cross-entropy over one T-chunk; returns the summed NLL (f32 scalar)."""
    logits = torch.matmul(x_chunk.float(), wte.float().t())  # see GPT2.forward
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, _NEG_INF)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets_chunk[..., None]).sum()


class _FusedCE(torch.autograd.Function):
    """Chunked CE that emits dlogits = softmax - onehot (compute dtype)
    during the forward (gpt2.py:238-300): the [B, T, V] f32 logits never
    exist at once, and the backward is two matmuls, dx = dl @ wte and
    dwte = dl^T @ x, with no recompute. One f32 logits chunk is live at a
    time."""

    @staticmethod
    def forward(ctx, x, wte, targets, n_chunks: int, vocab_size: int):
        B, T, D = x.shape
        V = wte.shape[0]
        C = T // n_chunks
        dl = torch.empty(B, T, V, dtype=x.dtype, device=x.device)
        nll = torch.zeros((), dtype=torch.float32, device=x.device)
        pad = torch.arange(V, device=x.device) >= vocab_size
        wte_t = wte.t()
        for c in range(n_chunks):
            sl = slice(c * C, (c + 1) * C)
            tc = targets[:, sl, None]
            logits = _mm_f32(x[:, sl].reshape(B * C, D), wte_t).view(B, C, V)
            if vocab_size != V:
                logits.masked_fill_(pad, _NEG_INF)
            m = logits.amax(-1, keepdim=True)
            e = torch.exp(logits - m)
            s = e.sum(-1, keepdim=True)
            lse = m + torch.log(s)
            nll += (lse - logits.gather(-1, tc)).sum()
            p = e.div_(s)
            p.scatter_add_(-1, tc, torch.full_like(tc, -1.0, dtype=p.dtype))  # p - onehot
            dl[:, sl] = p
        ctx.save_for_backward(x, wte, dl)
        return nll / (B * T)

    @staticmethod
    def backward(ctx, g):
        x, wte, dl = ctx.saved_tensors
        B, T, D = x.shape
        V = wte.shape[0]
        scale = g / (B * T)
        dl2 = dl.view(B * T, V)
        dx = torch.matmul(dl2, wte).view(B, T, D) * scale.to(x.dtype)  # compute-dtype product
        dwte = _mm_f32(dl2.t(), x.reshape(B * T, D)) * scale
        return dx.to(x.dtype), dwte, None, None, None


def loss_fn(model: GPT2, tokens: torch.Tensor, cfg: Optional[GPT2Config] = None) -> torch.Tensor:
    """Next-token cross-entropy over tokens [B, T+1], padded-vocab logits
    masked; the mean over B*T tokens (gpt2.py:303-344)."""
    cfg = cfg or model.cfg
    tokens = tokens.long()
    x = model.backbone(tokens[:, :-1], cfg)
    return head_loss(x, model.wte.to(cfg.dtype), tokens[:, 1:], cfg)


def head_loss(x: torch.Tensor, wte: torch.Tensor, targets: torch.Tensor,
              cfg: GPT2Config) -> torch.Tensor:
    """The tied LM head and its cross-entropy: final hidden states x
    [B, T, D], the embedding in the compute dtype, targets [B, T] (int64)
    -> mean NLL over B*T, by ``cfg.loss_impl``."""
    B, T, D = x.shape
    if cfg.loss_impl == "fused":
        n_chunks = max(1, T // max(1, cfg.loss_chunk)) if cfg.loss_chunk else 1
        while T % n_chunks:
            n_chunks -= 1
        return _FusedCE.apply(x, wte, targets, n_chunks, cfg.vocab_size)
    C = cfg.loss_chunk
    if C <= 0 or T <= C:
        return _chunk_nll(x, targets, wte, cfg) / (B * T)
    # full chunks, then one remainder chunk (T is often seq-1, e.g. 1023)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, T, C):
        xc, tc = x[:, c0:c0 + C], targets[:, c0:c0 + C]
        total = total + checkpoint(_chunk_nll, xc, tc, wte, cfg, use_reentrant=False)
    return total / (B * T)


def make_train_step(model: GPT2, optimizer: torch.optim.Optimizer):
    """Returns train_step(tokens [B, T+1]) -> loss (a 0-dim tensor on the
    model's device): one forward, backward and optimizer step."""
    device = model.wte.device

    def train_step(tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=device)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens)
        loss.backward()
        optimizer.step()
        return loss.detach()

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
    pytree layout, as f32 numpy arrays."""
    out: Dict[str, Any] = {}
    per_layer: Dict[str, list] = {}
    for name, p in model.named_parameters():
        t = p.grad if grads else p
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

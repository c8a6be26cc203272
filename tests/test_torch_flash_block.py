"""The port's block entries for ring attention against the JAX package's.

``flash_fwd_block`` and ``flash_bwd_block`` (ray_tpu/ops/flash_attention.py:
376-398 and their counterparts in ray_tpu_torch/ops/flash_attention.py) take
one visiting K/V block at the model layout [B, T, H, Dh] and return f32
outputs. Both run on the CPU: the JAX kernels in Pallas interpret mode, the
port through its plain versions. Inputs come from a seeded numpy generator
and are handed to both (bf16 operands are the same f32 draws rounded to
bf16 on each side); the backward of both takes the same lse and delta,
converted between the port's [B*H, T] and the TPU's [BH, 8, T] layouts.

Tolerances. f32 operands: 1e-5 on the forward (o and lse), 1e-4 on the
gradients, whose sums run in other orders (as tests/test_torch_flash_attention.py).
bf16 operands: both round p to bf16 before p@v, but where JAX runs its
online softmax over several K blocks (Tk = 96) it rounds p against the
running max and the port against the final one, so elements of p may round
to neighbouring bf16 values (2^-8 relative): o within 4e-3 absolute and
relative (measured on these inputs: 9.8e-4), lse within 1e-5. The backward
takes the same lse and delta on both sides, so p and dS round alike: 1e-4,
as in f32 (measured: 2.4e-7).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch.ops import flash_attention as tfa

TOL = {"float32": (1e-5, 1e-4), "bfloat16": (4e-3, 1e-4)}  # (forward, gradients)
LSE_TOL = 1e-5


def _draw(seed, B, Tq, Tk, H, D):
    rng = np.random.default_rng(seed)
    shapes = [(B, Tq, H, D), (B, Tk, H, D), (B, Tk, H, D), (B, Tq, H, D)]
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _sublanes(x):  # [BH, T] -> the TPU's [BH, 8, T]
    return jnp.broadcast_to(jnp.asarray(x)[:, None, :], (x.shape[0], 8, x.shape[1]))


# (B, Tq, Tk, H, D, causal): causal blocks are the ring's diagonal (Tq == Tk);
# non-causal ones its earlier blocks, here also with Tk != Tq (Tk = 96 runs
# JAX's online softmax over three K blocks of 32).
CASES = [(2, 64, 64, 2, 16, True), (1, 64, 64, 2, 64, True),
         (2, 64, 96, 2, 16, False), (1, 32, 96, 2, 64, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}_Tq{}_Tk{}_H{}_D{}_{}".format(
    *c[:5], "causal" if c[5] else "full"))
def test_block_entries_match_jax(cpu_mesh_devices, case, dtype):
    B, Tq, Tk, H, D, causal = case
    q, k, v, do = _draw(7, B, Tq, Tk, H, D)
    jx = [jnp.asarray(x).astype(dtype) for x in (q, k, v, do)]
    tx = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v, do)]
    fwd_tol, grad_tol = TOL[dtype]

    o_j, lse_j = jfa.flash_fwd_block(*jx[:3], causal=causal)
    o_t, lse_t = tfa.flash_fwd_block(*tx[:3], causal=causal)
    assert o_t.dtype == torch.float32 and o_t.shape == (B, Tq, H, D)
    assert lse_t.shape == (B * H, Tq)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=fwd_tol, atol=fwd_tol)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[:, 0, :], rtol=LSE_TOL,
                               atol=LSE_TOL)

    # the global lse and delta of the ring: here this block's own lse, and
    # delta = rowsum(dO * o) from the port's o cast to the operands' dtype
    lse = lse_t
    o_cast = o_t.to(tx[0].dtype)
    delta = (tx[3].float() * o_cast.float()).sum(-1).permute(0, 2, 1).reshape(B * H, Tq)
    grads_j = jfa.flash_bwd_block(*jx, _sublanes(lse.numpy()), _sublanes(delta.numpy()),
                                  causal=causal)
    grads_t = tfa.flash_bwd_block(*tx, lse, delta, causal=causal)
    for name, g_t, g_j in zip(("dq", "dk", "dv"), grads_t, grads_j):
        assert g_t.dtype == torch.float32 and g_t.shape == tuple(g_j.shape), name
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=grad_tol, atol=grad_tol,
                                   err_msg=name)


def test_wrappers_keep_the_operand_dtype_unless_asked(cpu_mesh_devices):
    """The folded wrappers return the operands' dtype by default and f32
    with out_f32; the f32 outputs are the same numbers before the cast."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16).permute(0, 2, 1, 3).reshape(4, 64, 16)
                   for x in _draw(3, 2, 64, 64, 2, 16))
    o, lse = tfa.flash_fwd(q, k, v, True)
    o32, lse32 = tfa.flash_fwd(q, k, v, True, out_f32=True)
    assert o.dtype == torch.bfloat16 and o32.dtype == torch.float32
    assert torch.equal(o32.to(torch.bfloat16), o) and torch.equal(lse, lse32)
    delta = (do.float() * o.float()).sum(-1)
    bf = [tfa.flash_dq(q, k, v, do, lse, delta, True), *tfa.flash_dkv(q, k, v, do, lse, delta, True)]
    f32 = [tfa.flash_dq(q, k, v, do, lse, delta, True, out_f32=True),
           *tfa.flash_dkv(q, k, v, do, lse, delta, True, out_f32=True)]
    for a, b in zip(bf, f32):
        assert a.dtype == torch.bfloat16 and b.dtype == torch.float32
        assert torch.equal(b.to(torch.bfloat16), a)
    assert tfa.launches_f32 == dict.fromkeys(tfa.launches, 0)  # the CPU launches no kernel

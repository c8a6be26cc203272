"""The port's flash attention against the JAX package's Pallas kernel.

Both run on the CPU: the JAX kernel in Pallas interpret mode (as its own
tests run it), the port through its plain PyTorch versions, which the
wrappers take for CPU tensors. Inputs are f32, drawn from a seeded numpy
generator and handed to both. Tolerances mirror the JAX package's own
flash tests (tests/test_ring_attention.py): 1e-5 on the forward (out and
lse), 1e-4 on the gradients, whose sums run in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.ops.attention import attention as t_attention

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _inputs(seed, B, Tq, Tk, H, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, H, D), dtype=np.float32)
    k = rng.standard_normal((B, Tk, H, D), dtype=np.float32)
    v = rng.standard_normal((B, Tk, H, D), dtype=np.float32)
    do = rng.standard_normal((B, Tq, H, D), dtype=np.float32)
    return q, k, v, do


def _jax_fwd(q, k, v, causal):
    """JAX out [B, T, H, D] and lse converted from [BH, 8, T] to [BH, T]."""
    out, res = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    lse = np.asarray(res[-1])
    assert np.array_equal(lse, np.broadcast_to(lse[:, :1], lse.shape))  # 8 equal sublanes
    return np.asarray(out), np.array(lse[:, 0, :])


def _jax_grads(q, k, v, do, causal):
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _torch_grads(q, k, v, do, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, causal)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


def _close(a, b, tol):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


# (B, Tq, Tk, H, D, causal). JAX's default tiles (1024) cover these T in
# one block, so the JAX side runs its one-shot softmax path, except for
# Tk = 96 (tiles of 32: online softmax over three K blocks) and T = 40
# (tiles of 8: the ragged T falls back to the largest divisor). Dh 32 is a
# head dim the CUDA kernels do not take: the plain versions do.
CASES = [
    (2, 64, 64, 2, 16, True),
    (2, 64, 64, 2, 64, True),
    (2, 64, 64, 2, 16, False),
    (1, 64, 64, 2, 64, False),
    (1, 64, 96, 2, 64, False),
    (1, 40, 40, 2, 16, True),
    (1, 64, 64, 2, 32, True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}_Tq{}_Tk{}_H{}_D{}_{}".format(
    *c[:5], "causal" if c[5] else "full"))
def test_forward_matches_jax(cpu_mesh_devices, case):
    B, Tq, Tk, H, D, causal = case
    q, k, v, _ = _inputs(0, B, Tq, Tk, H, D)
    out_j, lse_j = _jax_fwd(q, k, v, causal)
    o, lse = tfa.flash_fwd(*(tfa._fold(torch.from_numpy(x)) for x in (q, k, v)), causal)
    _close(tfa._unfold(o, B, H).numpy(), out_j, FWD_TOL)
    _close(lse.numpy(), lse_j, FWD_TOL)
    out = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal)
    _close(out.numpy(), out_j, FWD_TOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}_Tq{}_Tk{}_H{}_D{}_{}".format(
    *c[:5], "causal" if c[5] else "full"))
def test_gradients_match_jax(cpu_mesh_devices, case):
    B, Tq, Tk, H, D, causal = case
    q, k, v, do = _inputs(1, B, Tq, Tk, H, D)
    grads_j = _jax_grads(q, k, v, do, causal)
    _, grads_t = _torch_grads(q, k, v, do, causal)
    for gj, gt in zip(grads_j, grads_t):
        _close(gt, gj, GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_multiblock_matches_jax(cpu_mesh_devices, causal, monkeypatch):
    """Forced 32x32 JAX tiles on T = 128: the JAX side runs its online
    softmax over 4x4 tiles with causal tile skipping, the path the port's
    kernels mirror."""
    monkeypatch.setenv("RT_FLASH_BQ", "32")
    monkeypatch.setenv("RT_FLASH_BK", "32")
    B, T, H, D = 1, 128, 2, 64
    q, k, v, do = _inputs(2, B, T, T, H, D)
    out_j, lse_j = _jax_fwd(q, k, v, causal)
    o, lse = tfa.flash_fwd(*(tfa._fold(torch.from_numpy(x)) for x in (q, k, v)), causal)
    _close(tfa._unfold(o, B, H).numpy(), out_j, FWD_TOL)
    _close(lse.numpy(), lse_j, FWD_TOL)
    grads_j = _jax_grads(q, k, v, do, causal)
    _, grads_t = _torch_grads(q, k, v, do, causal)
    for gj, gt in zip(grads_j, grads_t):
        _close(gt, gj, GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_kernels_match_jax_blocks(cpu_mesh_devices, causal):
    """The plain versions of the dq and dk/dv kernels against the JAX
    backward kernels, both fed the same lse and delta."""
    B, T, H, D = 1, 64, 2, 16
    q, k, v, do = _inputs(3, B, T, T, H, D)
    fold = jfa._fold
    out_j, lse_j = _jax_fwd(q, k, v, causal)
    delta = np.sum(np.asarray(fold(jnp.asarray(do))) * np.asarray(fold(jnp.asarray(out_j))), -1)
    BH = B * H
    dq_j, dk_j, dv_j = jfa._bwd_kernels(
        fold(jnp.asarray(q)), fold(jnp.asarray(k)), fold(jnp.asarray(v)), fold(jnp.asarray(do)),
        jnp.broadcast_to(jnp.asarray(lse_j)[:, None], (BH, 8, T)),
        jnp.broadcast_to(jnp.asarray(delta)[:, None], (BH, 8, T)),
        causal, jnp.float32, jnp.float32, jnp.float32,
    )
    qf, kf, vf, dof = (tfa._fold(torch.from_numpy(x)) for x in (q, k, v, do))
    lse_t, delta_t = torch.from_numpy(lse_j), torch.from_numpy(delta)
    dq = tfa.flash_dq(qf, kf, vf, dof, lse_t, delta_t, causal)
    dk, dv = tfa.flash_dkv(qf, kf, vf, dof, lse_t, delta_t, causal)
    for got, want in [(dq, dq_j), (dk, dk_j), (dv, dv_j)]:
        _close(got.numpy(), np.asarray(want), GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_reference_attention(causal):
    """Within the port: impl="flash" and impl="reference" agree, forward
    and backward (f32, same tolerances)."""
    q, k, v, do = _inputs(4, 2, 48, 48, 3, 16)
    outs, grads = [], []
    for impl in ("flash", "reference"):
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = t_attention(*ts, causal=causal, impl=impl)
        out.backward(torch.from_numpy(do))
        outs.append(out.detach().numpy())
        grads.append([t.grad.numpy() for t in ts])
    _close(outs[0], outs[1], FWD_TOL)
    for a, b in zip(*grads):
        _close(a, b, GRAD_TOL)


def test_reference_attention_matches_jax(cpu_mesh_devices):
    from ray_tpu.ops.attention import _reference_attention

    q, k, v, _ = _inputs(5, 2, 32, 32, 2, 16)
    want = np.asarray(_reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True))
    got = t_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True, impl="reference")
    _close(got.numpy(), want, FWD_TOL)


def test_cpu_runs_plain_versions_and_counts_no_launch(monkeypatch):
    """CPU tensors never reach the kernel library, and the launch counters
    only count kernel launches."""
    from ray_tpu_torch.ops import _build

    def no_build(name):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    before = dict(tfa.launches)
    q, k, v, do = _inputs(6, 1, 32, 32, 2, 16)
    _torch_grads(q, k, v, do, True)
    assert tfa.launches == before


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that the wrappers' checks take for a CUDA one."""

    is_cuda = True


@pytest.mark.parametrize("bad", ["head_dim", "causal_tq_ne_tk", "rank", "lse_shape"])
def test_wrapper_rejects_what_the_kernels_do_not_take(bad):
    x = torch.zeros(2, 32, 16)
    if bad == "head_dim":
        # the kernels take HEAD_DIMS only; the plain versions that serve CPU
        # tensors take any head dim, as the Pallas kernels do
        y = torch.zeros(2, 32, 32)
        assert tfa.flash_fwd(y, y, y, True)[0].shape == y.shape
        cuda_like = torch.Tensor._make_subclass(_ReportsCuda, y)
        with pytest.raises(ValueError, match="head dim"):
            tfa.flash_fwd(cuda_like, cuda_like, cuda_like, True)
    elif bad == "causal_tq_ne_tk":
        with pytest.raises(ValueError, match="Tq == Tk"):
            tfa.flash_fwd(x, torch.zeros(2, 48, 16), torch.zeros(2, 48, 16), True)
    elif bad == "rank":
        with pytest.raises(ValueError):
            tfa.flash_attention(x, x, x, True)
    else:
        with pytest.raises(ValueError, match="lse/delta"):
            tfa.flash_dq(x, x, x, x, torch.zeros(2, 31), torch.zeros(2, 32), True)

"""The flash kernels' full reach: head dims 32 and 128, and f32 operands.

The CUDA kernels take head dims up to 256 (instances at 16, 32, 64, 128
and 256; tests/test_torch_flash_head_dims.py holds the widths between),
bf16 operands (bf16 or f32 outputs) and f32 operands
(``csrc/flash_attention_f32.cu``), as the Pallas kernels do. On the CPU the wrappers run their plain versions; here
those are held to the JAX package's functions (the Pallas kernels in
interpret mode, one tile per call, as ``tests/test_torch_flash_tiles.py``
runs them) at Dh 32 and 128, in f32 and in bf16, causal and not, with a
ragged T; then GPT-2 at Dh 32 and 128 with flash attention against the JAX
model; then the wrappers' checks and their routing of a CUDA tensor to the
library of its dtype. Inputs come from seeded numpy generators.
"""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt2 as jg
from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch import bench
from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as tfa

# f32: the JAX package's own limits for its f32 kernels
# (tests/test_ring_attention.py:104): 1e-5 on the forward (out and lse),
# 1e-4 on the gradients, whose sums run in another order.
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
# bf16: both sides round P and dS to bf16 at the same places and sum in f32
# in other orders, so every element is held by the kernels' own rule on the
# card (bench.disagreement: 2^-6 relative + 2e-2 of the row's rms, 1e-2
# relnorm); lse (f32 from bf16 products summed in f32) within 1e-4.
LSE_TOL = 1e-4

# (B, Tq, Tk, H, Dh, causal): causal, non-causal with Tk != Tq, ragged T.
CASES = [
    (1, 64, 64, 2, 32, True),
    (1, 64, 64, 2, 128, True),
    (1, 64, 96, 2, 32, False),
    (1, 64, 96, 2, 128, False),
    (1, 40, 40, 2, 32, True),
    (1, 40, 40, 1, 128, True),
]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _id(case):
    B, Tq, Tk, H, D, causal = case
    return f"B{B}_Tq{Tq}_Tk{Tk}_H{H}_D{D}_{'causal' if causal else 'full'}"


def _inputs(seed, B, Tq, Tk, H, D):
    rng = np.random.default_rng(seed)
    make = lambda T: rng.standard_normal((B, T, H, D), dtype=np.float32)  # noqa: E731
    return make(Tq), make(Tk), make(Tk), make(Tq)


@pytest.fixture
def one_jax_tile(monkeypatch):
    """The JAX kernels in one tile per call (a ragged T would otherwise
    fall back to 8-row tiles, many interpret-mode steps)."""
    def set_tiles(Tq, Tk):
        monkeypatch.setenv("RT_FLASH_BQ", str(Tq))
        monkeypatch.setenv("RT_FLASH_BK", str(Tk))
    return set_tiles


def _close(got, want, what):
    gap = bench.disagreement(got, want)
    assert gap["ok"], (what, gap)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_plain_versions_match_jax(cpu_mesh_devices, one_jax_tile, case, dtype):
    """Forward (out, lse) and the gradients of q, k, v through the port's
    autograd Function (its plain versions, on CPU tensors) against the JAX
    package's flash attention and its VJP on the same inputs."""
    B, Tq, Tk, H, D, causal = case
    _, jd, td = DTYPES[dtype]
    q, k, v, do = _inputs(D + Tk, B, Tq, Tk, H, D)
    one_jax_tile(Tq, Tk)
    jq, jk, jv, jdo = (jnp.asarray(x, dtype=jd) for x in (q, k, v, do))
    out_j, res = jfa._flash_fwd(jq, jk, jv, causal)
    lse_j = np.asarray(res[-1])[:, 0, :]
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, causal), jq, jk, jv)
    grads_j = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]

    tq, tk, tv = (torch.from_numpy(x).to(td).requires_grad_() for x in (q, k, v))
    out_t = tfa.flash_attention(tq, tk, tv, causal)
    out_t.backward(torch.from_numpy(do).to(td))
    assert out_t.dtype == td and all(x.grad.dtype == td for x in (tq, tk, tv))
    _, lse_t = tfa.flash_fwd(tfa._fold(tq.detach()), tfa._fold(tk.detach()), tfa._fold(tv.detach()),
                             causal)
    got = [out_t.detach()] + [x.grad for x in (tq, tk, tv)]
    want = [np.asarray(out_j.astype(jnp.float32))] + grads_j
    if dtype == "f32":
        for name, g, w, tol in zip(("o", "dq", "dk", "dv"), got, want,
                                   (FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
            np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol, err_msg=name)
        np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=FWD_TOL, atol=FWD_TOL)
    else:
        for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
            _close(g, torch.from_numpy(w.copy()), name)
        assert np.abs(lse_t.numpy() - lse_j).max() <= LSE_TOL


# GPT-2 at d_model 128 with flash attention: 4 heads of 32 and 1 head of
# 128, 2 layers (gpt2-tiny's other widths), the JAX init carried across by
# from_jax. bf16 limits as tests/test_torch_gpt2.py's bf16 leg (the loss
# within 1e-3, each gradient leaf within 5e-2 of its largest entry); f32:
# the loss within 1e-5 relative, each gradient within 1e-4 in relative norm.
GPT_HEADS = {32: 4, 128: 1}
B, T = 2, 64


def _gpt_cfgs(n_head, dtype):
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(d_model=128, n_layer=2, n_head=n_head, attn_impl="flash")
    return (dataclasses.replace(jg.CONFIGS["gpt2-tiny"], dtype=jd, **kw),
            dataclasses.replace(tg.CONFIGS["gpt2-tiny"], dtype=td, **kw))


@pytest.fixture(scope="module")
def wide_params(cpu_mesh_devices):
    """JAX parameters of the d_model 128 model per head count (the JAX
    model lays its attention weights out by head), and the same as numpy
    arrays."""
    out = {}
    for n_head in GPT_HEADS.values():
        params = jg.init(jax.random.PRNGKey(0), _gpt_cfgs(n_head, "f32")[0])
        out[n_head] = params, jax.tree.map(np.asarray, params)
    return out


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("head_dim", sorted(GPT_HEADS))
def test_gpt2_flash_matches_jax(wide_params, monkeypatch, head_dim, dtype):
    params_j, params_np = wide_params[GPT_HEADS[head_dim]]
    jcfg, tcfg = _gpt_cfgs(GPT_HEADS[head_dim], dtype)
    assert tcfg.head_dim == head_dim
    monkeypatch.setenv("RT_FLASH_BQ", str(T))
    monkeypatch.setenv("RT_FLASH_BK", str(T))
    tok = np.random.default_rng(head_dim).integers(0, 256, (B, T + 1), dtype=np.int32)
    loss_j, grads_j = jax.value_and_grad(jg.loss_fn)(params_j, jnp.asarray(tok), jcfg)
    model = tg.from_jax(params_np, tcfg, "cpu")
    loss_t = tg.loss_fn(model, torch.from_numpy(tok))
    loss_t.backward()
    grads_t = tg.to_jax(model, grads=True)
    loss_j = float(loss_j)
    leaves = list(zip(jax.tree_util.tree_flatten_with_path(grads_j)[0], jax.tree.leaves(grads_t)))
    assert jax.tree.structure(grads_t) == jax.tree.structure(grads_j)
    if dtype == "f32":
        assert abs(loss_t.item() - loss_j) <= 1e-5 * abs(loss_j)
        for (path, want), got in leaves:
            want = np.asarray(want, dtype=np.float64)
            rel = np.linalg.norm(np.asarray(got, dtype=np.float64) - want) / np.linalg.norm(want)
            assert rel <= 1e-4, (jax.tree_util.keystr(path), rel)
    else:
        assert math.isfinite(loss_t.item()) and abs(loss_t.item() - loss_j) <= 1e-3
        for (path, want), got in leaves:
            want = np.asarray(want, dtype=np.float32)
            err = np.abs(got - want).max()
            assert err <= 5e-2 * np.abs(want).max(), (jax.tree_util.keystr(path), err)


# ---------------------------------------------------------------------------
# The wrappers on a tensor that reports CUDA
# ---------------------------------------------------------------------------


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that the wrappers' checks take for a CUDA one."""

    is_cuda = True


def _cuda_like(*shape, dtype):
    return torch.Tensor._make_subclass(_ReportsCuda, torch.zeros(*shape, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
def test_check_takes_every_head_dim_in_bf16_and_f32(head_dim, dtype):
    q = _cuda_like(2, 32, head_dim, dtype=dtype)
    lse = _cuda_like(2, 32, dtype=torch.float32)
    tfa._check(q, q, q, True, q, lse, lse)


def _operands(case):
    """q, k, dO (v is k) and lse/delta for one of the cases below: bf16
    operands and f32 lse, with the case's change."""
    bf, f32 = torch.bfloat16, torch.float32
    q, k, do = (_cuda_like(2, 32, 32, dtype=bf) for _ in range(3))
    lse = _cuda_like(2, 32, dtype=f32)
    if case == "k_f32":
        k = _cuda_like(2, 32, 32, dtype=f32)
    elif case == "do_f32":
        do = _cuda_like(2, 32, 32, dtype=f32)
    elif case == "lse_bf16":
        lse = _cuda_like(2, 32, dtype=bf)
    elif case == "f16_operands":
        q = k = do = _cuda_like(2, 32, 32, dtype=torch.float16)
    elif case == "f64_operands":
        q = k = do = _cuda_like(2, 32, 32, dtype=torch.float64)
    elif case == "int_operands":
        q = k = do = _cuda_like(2, 32, 32, dtype=torch.int32)
    elif case == "head_dim_264":
        q = k = do = _cuda_like(2, 32, 264, dtype=bf)
    elif case == "head_dim_0":
        q = k = do = _cuda_like(2, 32, 0, dtype=bf)
    return q, k, do, lse


@pytest.mark.parametrize("case", ["k_f32", "do_f32", "f16_operands", "head_dim_264"])
def test_check_takes_f16_and_mixed_operands(case):
    """f16 operands, operands of mixed dtypes (an f32 K beside bf16 Q and
    V, an f32 dO) and a head dim above 256 are taken on a CUDA tensor: the
    f16 kernels, the mixed route or the column-window kernels serve them."""
    q, k, do, lse = _operands(case)
    tfa._check(q, k, k, True, do, lse, lse)


@pytest.mark.parametrize("case", ["lse_bf16", "head_dim_0", "f64_operands", "int_operands"])
def test_check_rejects_other_dtypes_and_head_dims(case):
    """lse or delta other than f32, a head dim below 1, and f64 or integer
    operands raise on a CUDA tensor."""
    q, k, do, lse = _operands(case)
    match = {"lse_bf16": "f32 lse", "head_dim_0": "head dim"}.get(case, "bf16, f16 or f32 operands")
    with pytest.raises(ValueError, match=match):
        tfa._check(q, k, k, True, do, lse, lse)


def test_launch_routes_by_operand_dtype_and_counts_instances(monkeypatch):
    """A CUDA tensor goes to the library of its operands' dtype, and each
    launch is counted per kernel, with f32 outputs, and per instance."""
    calls = []

    def load(name):
        def entry(entry_name):
            def fn(*args):
                calls.append((name, entry_name))
                return 0
            return fn
        return types.SimpleNamespace(rt_flash_fwd=entry("rt_flash_fwd"),
                                     rt_flash_dq=entry("rt_flash_dq"),
                                     rt_flash_dkv=entry("rt_flash_dkv"))

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tfa, "launches", dict.fromkeys(tfa.launches, 0))
    monkeypatch.setattr(tfa, "launches_f32", dict.fromkeys(tfa.launches, 0))
    monkeypatch.setattr(tfa, "launches_by_instance", {})
    for d, dtype in ((128, torch.bfloat16), (32, torch.float32)):
        q = _cuda_like(2, 32, d, dtype=dtype)
        lse = _cuda_like(2, 32, dtype=torch.float32)
        tfa.flash_fwd(q, q, q, True)
        tfa.flash_dq(q, q, q, q, lse, lse, True)
        tfa.flash_dkv(q, q, q, q, lse, lse, True)
    assert calls == [(lib, e) for lib in ("flash_attention", "flash_attention_f32")
                     for e in ("rt_flash_fwd", "rt_flash_dq", "rt_flash_dkv")]
    assert tfa.launches == dict.fromkeys(tfa.launches, 2)
    assert tfa.launches_f32 == dict.fromkeys(tfa.launches, 1)  # the f32 operands' outputs
    assert tfa.launches_by_instance == {
        f"{name} d{d} {dt}": 1 for d, dt in ((128, "bfloat16"), (32, "float32"))
        for name in ("flash_fwd", "flash_dq", "flash_dkv")}
    assert tfa.instance("flash_dq", 128, torch.bfloat16) == "flash_dq d128 bfloat16"

"""Head dims above 256: the flash wrappers' column-window route.

The Pallas kernels take any head dim; the port's instanced CUDA kernels
stop at 256, and every head dim above runs on the column-window kernels
(``ray_tpu_torch/ops/csrc/flash_wide.cuh``, built into all four libraries:
bf16, f16, f32 and the mixed dtypes), which write O, dQ, dK and dV as
windows of output columns. On the CPU the wrappers run their plain
versions; here those are held to the JAX package's functions (the Pallas
kernels in interpret mode, one tile per call) at Dh 260, 264, 384 and 512
in bf16, f16, f32 and one mix, causal and non-causal with Tk != Tq: the
autograd Function and the ring's block entries. Then GPT-2 (gpt2-tiny's
vocabulary and depth at d_model 384, one head of 384) against the JAX
model's loss and gradients with flash attention. Then the wrappers'
routing of a CUDA tensor under a stand-in library: the entry point each
dtype reaches, the width and scale it is given, the padding copy at 257
and 260, the windows, one launch a call and the instance keys; the padded
route's arithmetic with the kernel stood in for by its plain version; and
the window widths and shared-memory plans the ``.cuh`` states.
Inputs come from seeded numpy generators.

Tolerances (``tests/test_torch_flash_f16.py``'s rules). An f32 output with
no 16-bit rounding of P or dS on its path: 1e-5 on the forward and 1e-4 on
the gradients, relative and absolute (the JAX package's limits for its
f32 kernels, tests/test_ring_attention.py:104). Any other output (a 16-bit
dtype, or a rounding to one on its path): the kernels' own rule on the
card (bench.disagreement: 2^-6 relative + 2e-2 of the row's rms, 1e-2 in
relative norm), since both sides round at the same places but sum in other
orders, so an element near a rounding boundary may land on the
neighbouring 16-bit value. lse: 1e-4 absolute.
"""

import dataclasses
import math
import re
import types
from pathlib import Path

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

FWD_TOL, GRAD_TOL, LSE_TOL = 1e-5, 1e-4, 1e-4
WIDE_DIMS = (260, 264, 384, 512)

# (q, k, v) dtypes; dO takes q's (the output's).
DTYPE_SETS = {
    "bf16": ("bfloat16",) * 3,
    "f16": ("float16",) * 3,
    "f32": ("float32",) * 3,
    "bf16_f32_bf16": ("bfloat16", "float32", "bfloat16"),
}
# The operand whose dtype P or dS is rounded to on each output's path: o's
# P to v's, dq's dS to k's, dk's dS to q's, dv's P to dO's.
THROUGH = {"o": 2, "dq": 1, "dk": 0, "dv": 3}
# (B, Tq, Tk, H, causal): causal, and non-causal with Tk != Tq.
SHAPES = [(1, 64, 64, 2, True), (1, 40, 72, 2, False)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the products are small and many, and a
    parallel run's other workers want the cores too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(seed, B, Tq, Tk, H, D):
    rng = np.random.default_rng(seed)
    shapes = [(B, Tq, H, D), (B, Tk, H, D), (B, Tk, H, D), (B, Tq, H, D)]
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _held(got: torch.Tensor, want: np.ndarray, tol: float, what, through: str) -> None:
    """An f32 output with no 16-bit rounding on its path (``through``, the
    dtype its P or dS is rounded to) within ``tol``; any other by the
    kernels' rule."""
    if got.dtype == torch.float32 and through == "float32":
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol, atol=tol, err_msg=str(what))
    else:
        gap = bench.disagreement(got, torch.from_numpy(np.array(want)))
        assert gap["ok"], (what, gap)


def _jax_tiles(monkeypatch, Tq, Tk):
    """The JAX kernels in one tile per call."""
    monkeypatch.setenv("RT_FLASH_BQ", str(Tq))
    monkeypatch.setenv("RT_FLASH_BK", str(Tk))


def _shape_id(shape):
    B, Tq, Tk, H, causal = shape
    return f"Tq{Tq}_Tk{Tk}_{'causal' if causal else 'full'}"


@pytest.mark.parametrize("dtypes", list(DTYPE_SETS))
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
@pytest.mark.parametrize("head_dim", WIDE_DIMS)
def test_flash_attention_matches_jax_above_256(cpu_mesh_devices, monkeypatch, head_dim, shape, dtypes):
    """The autograd Function (its plain versions, on CPU tensors) against
    the JAX package's flash attention and its VJP: o, lse and each
    operand's gradient, in JAX's dtypes."""
    B, Tq, Tk, H, causal = shape
    names = DTYPE_SETS[dtypes] + DTYPE_SETS[dtypes][:1]
    draws = _draw(head_dim + Tk, B, Tq, Tk, H, head_dim)
    _jax_tiles(monkeypatch, Tq, Tk)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(n) for x, n in zip(draws, names))
    out_j, res = jfa._flash_fwd(jq, jk, jv, causal)
    lse_j = np.asarray(res[-1])[:, 0, :]
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, causal), jq, jk, jv)
    grads_j = vjp(jdo)

    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, n)).requires_grad_() for x, n in zip(draws[:3], names))
    out_t = tfa.flash_attention(tq, tk, tv, causal)
    out_t.backward(torch.from_numpy(draws[3]).to(getattr(torch, names[3])))
    _, lse_t = tfa.flash_fwd(*(tfa._fold(x.detach()) for x in (tq, tk, tv)), causal)
    for name, g, w, tol in zip(("o", "dq", "dk", "dv"), (out_t, tq.grad, tk.grad, tv.grad), (out_j, *grads_j),
                               (FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), (name, g.dtype, w.dtype)
        assert g.shape[-1] == head_dim, name
        _held(g, np.asarray(w.astype(jnp.float32)), tol, (name, head_dim, dtypes), names[THROUGH[name]])
    assert np.abs(lse_t.numpy() - lse_j).max() <= LSE_TOL


def _sublanes(x):  # [BH, T] -> the TPU's [BH, 8, T]
    return jnp.broadcast_to(jnp.asarray(x)[:, None, :], (x.shape[0], 8, x.shape[1]))


@pytest.mark.parametrize("dtypes", list(DTYPE_SETS))
@pytest.mark.parametrize("head_dim", WIDE_DIMS)
def test_block_entries_match_jax_above_256(cpu_mesh_devices, monkeypatch, head_dim, dtypes):
    """flash_fwd_block and flash_bwd_block (f32 outputs, the ring's)
    against the JAX package's, on the same global lse and delta: a
    diagonal (causal) block at 260 and 384, an earlier (non-causal, Tk !=
    Tq) one at 264 and 512."""
    causal = head_dim in (260, 384)
    B, Tq, Tk, H = (1, 48, 48, 2) if causal else (1, 32, 56, 2)
    names = DTYPE_SETS[dtypes] + DTYPE_SETS[dtypes][:1]
    draws = _draw(3 * head_dim, B, Tq, Tk, H, head_dim)
    _jax_tiles(monkeypatch, Tq, Tk)
    jx = [jnp.asarray(x).astype(n) for x, n in zip(draws, names)]
    tx = [torch.from_numpy(x).to(getattr(torch, n)) for x, n in zip(draws, names)]

    o_j, lse_j = jfa.flash_fwd_block(*jx[:3], causal=causal)
    o_t, lse_t = tfa.flash_fwd_block(*tx[:3], causal=causal)
    assert o_t.dtype == torch.float32 and str(o_j.dtype) == "float32"
    _held(o_t, np.asarray(o_j), FWD_TOL, ("o", head_dim, dtypes), names[THROUGH["o"]])
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[:, 0, :], rtol=FWD_TOL, atol=FWD_TOL)

    o_cast = o_t.to(tx[0].dtype)
    delta = (tx[3].float() * o_cast.float()).sum(-1).permute(0, 2, 1).reshape(B * H, Tq)
    grads_j = jfa.flash_bwd_block(*jx, _sublanes(lse_t.numpy()), _sublanes(delta.numpy()), causal=causal)
    grads_t = tfa.flash_bwd_block(*tx, lse_t, delta, causal=causal)
    for name, g_t, g_j in zip(("dq", "dk", "dv"), grads_t, grads_j):
        assert g_t.dtype == torch.float32 and str(g_j.dtype) == "float32", name
        _held(g_t, np.asarray(g_j), GRAD_TOL, (name, head_dim, dtypes), names[THROUGH[name]])


# GPT-2: gpt2-tiny's vocabulary (256) and depth (2 layers) at d_model 384
# as one head of 384, the JAX init carried across by from_jax. Limits of
# tests/test_torch_flash_head_dims.py's GPT-2 test: f32, the loss within
# 1e-5 relative and each gradient within 1e-4 in relative norm; bf16, the
# loss within 1e-3 and each gradient within 5% of its largest element.
GPT_D, GPT_HEADS, GPT_B, GPT_T = 384, 1, 2, 64


def _gpt_cfgs(dtype):
    jd, td = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}[dtype]
    kw = dict(d_model=GPT_D, n_head=GPT_HEADS, attn_impl="flash")
    return (dataclasses.replace(jg.CONFIGS["gpt2-tiny"], dtype=jd, **kw),
            dataclasses.replace(tg.CONFIGS["gpt2-tiny"], dtype=td, **kw))


@pytest.fixture(scope="module")
def gpt_params(cpu_mesh_devices):
    params = jg.init(jax.random.PRNGKey(0), _gpt_cfgs("f32")[0])
    return params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_gpt2_flash_matches_jax_at_head_dim_384(gpt_params, monkeypatch, dtype):
    params_j, params_np = gpt_params
    jcfg, tcfg = _gpt_cfgs(dtype)
    assert tcfg.head_dim == jcfg.head_dim == 384 and tcfg.n_layer == 2 and tcfg.vocab_size == 256
    monkeypatch.setenv("RT_FLASH_BQ", str(GPT_T))
    monkeypatch.setenv("RT_FLASH_BK", str(GPT_T))
    tok = np.random.default_rng(384).integers(0, 256, (GPT_B, GPT_T + 1), dtype=np.int32)
    loss_j, grads_j = jax.value_and_grad(jg.loss_fn)(params_j, jnp.asarray(tok), jcfg)
    model = tg.from_jax(params_np, tcfg, "cpu")
    loss_t = tg.loss_fn(model, torch.from_numpy(tok))
    loss_t.backward()
    grads_t = tg.to_jax(model, grads=True)
    loss_j = float(loss_j)
    assert jax.tree.structure(grads_t) == jax.tree.structure(grads_j)
    leaves = list(zip(jax.tree_util.tree_flatten_with_path(grads_j)[0], jax.tree.leaves(grads_t)))
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
# Routing of CUDA tensors (CPU tensors that report CUDA; the library loads
# stood in for)
# ---------------------------------------------------------------------------


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that the wrappers' checks take for a CUDA one."""

    is_cuda = True


def _cuda_like(x: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_ReportsCuda, x)


def _recording_loads(monkeypatch):
    """Stand-in libraries that record each call: [(library, entry, args)]."""
    calls = []

    def load(name):
        def entry(entry_name):
            def fn(*args):
                calls.append((name, entry_name, args))
                return 0
            return fn
        return types.SimpleNamespace(**{e: entry(e) for e in ("rt_flash_fwd", "rt_flash_dq", "rt_flash_dkv")})

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tfa, "launches", dict.fromkeys(tfa.launches, 0))
    monkeypatch.setattr(tfa, "launches_f32", dict.fromkeys(tfa.launches, 0))
    monkeypatch.setattr(tfa, "launches_by_instance", {})
    return calls


# head dim -> the width the kernel is given: 16-bit operands, f32 (and a
# mix, cast to f32); its windows of 256 (forward, dQ) and 128 (dK/dV)
# columns; the forward in every library, and the f32 and mixed dQ and dK/dV,
# up to their clusters' limit (fa.CLUSTERS: 1024) instead run on a cluster
# of slices (fa.sliced), above on the windows.
WIDE_ROUTES = {257: (264, 260, 2, 3), 260: (264, 260, 2, 3), 264: (264, 264, 2, 3), 384: (384, 384, 2, 3),
               512: (512, 512, 2, 4), 768: (768, 768, 3, 6), 1024: (1024, 1024, 4, 8), 1280: (1280, 1280, 5, 10)}
ROUTE_DTYPES = {"bf16": (torch.bfloat16,) * 3, "f16": (torch.float16,) * 3, "f32": (torch.float32,) * 3,
                "mixed": (torch.bfloat16, torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("dtypes", list(ROUTE_DTYPES))
@pytest.mark.parametrize("head_dim", sorted(WIDE_ROUTES))
def test_routes_wide_head_dims_to_the_window_kernels(monkeypatch, head_dim, dtypes):
    """Each wrapper hands its library's entry point (the operands', or the
    mixed one's) tensors of the kernel's width (the head dim, or the
    padding copy's at 257, and at 260 in 16 bits), that width as ``d`` and
    1 / sqrt(the true head dim) as the scale, returns outputs of the true
    head dim in their operands' dtypes, and counts one launch a call under
    the window kernel's instance key (the forward in every library, and
    the f32 and mixed dQ and dK/dV, up to their clusters' limit: the
    cluster of slices')."""
    calls = _recording_loads(monkeypatch)
    qd, kd, vd = ROUTE_DTYPES[dtypes]
    mixed = dtypes == "mixed"
    width = WIDE_ROUTES[head_dim][1 if qd == torch.float32 or mixed else 0]
    assert tfa.kernel_head_dim(head_dim, torch.float32 if mixed else qd) == width
    assert tfa.instance_head_dim(head_dim) == head_dim
    bf = torch.bfloat16  # the column windows' counts of dQ and dK/dV (16-bit operands)
    assert (tfa.windows("flash_dq", head_dim, bf),
            tfa.windows("flash_dkv", head_dim, bf)) == (WIDE_ROUTES[head_dim][2], WIDE_ROUTES[head_dim][3])
    f32_kernels = qd == torch.float32 or mixed
    sliced = f32_kernels and head_dim <= 1024
    slices = -(-head_dim // 128)
    fwd_slice, fwd_max = tfa.CLUSTERS[("flash_fwd", 32 if f32_kernels else 16)]
    fwd_sliced = head_dim <= fwd_slice * fwd_max
    BH, T = 2, 24
    q, k, v, do = (_cuda_like(torch.zeros(BH, T, head_dim, dtype=d)) for d in (qd, kd, vd, qd))
    lse = _cuda_like(torch.zeros(BH, T))
    o, _ = tfa.flash_fwd(q, k, v, True)
    dq = tfa.flash_dq(q, k, v, do, lse, lse, True)
    dk, dv = tfa.flash_dkv(q, k, v, do, lse, lse, True)
    assert [x.shape for x in (o, dq, dk, dv)] == [(BH, T, head_dim)] * 4
    assert (o.dtype, dq.dtype, dk.dtype, dv.dtype) == (qd, qd, kd, vd)
    lib = tfa.MIXED_LIBRARY if mixed else tfa.OPERAND_DTYPES[qd]
    assert [(n, e) for n, e, _ in calls] == [(lib, e) for e in ("rt_flash_fwd", "rt_flash_dq", "rt_flash_dkv")]
    for (_, entry, args), n_ptrs in zip(calls, (5, 7, 8)):
        bh, tq, tk, d, scale, causal, out_f32, *_ = args[n_ptrs:]
        assert (bh, tq, tk, d, causal, out_f32) == (BH, T, T, width, 1, 0), entry
        assert scale == pytest.approx(1 / math.sqrt(head_dim), rel=1e-7), entry
        # the caller's own tensors where no copy is made (no padding, no cast)
        assert (args[0] == q.data_ptr()) == (width == head_dim and not mixed), entry
    assert tfa.launches == dict.fromkeys(tfa.launches, 1)
    assert tfa.launches_f32 == dict.fromkeys(tfa.launches, int(qd == torch.float32 or mixed))
    key = "mixed" if mixed else str(qd).removeprefix("torch.")
    fwd_windows = -(-head_dim // fwd_slice) if fwd_sliced else WIDE_ROUTES[head_dim][2]
    on = {"flash_fwd": f"d{fwd_slice}x{fwd_windows} cluster" if fwd_sliced else f"d256x{fwd_windows}",
          "flash_dq": f"d256x{WIDE_ROUTES[head_dim][2]}", "flash_dkv": f"d128x{WIDE_ROUTES[head_dim][3]}"}
    if sliced:
        on.update({name: f"d128x{slices} cluster" for name in ("flash_dq", "flash_dkv")})
    assert tfa.launches_by_instance == {f"{name} d{head_dim} on {on[name]} {key}": 1 for name in tfa.launches}
    dtype = "mixed" if mixed else qd
    assert [tfa.windows(name, head_dim, dtype) for name in tfa.launches] == (
        [fwd_windows, slices, slices] if sliced else
        [fwd_windows, WIDE_ROUTES[head_dim][2], WIDE_ROUTES[head_dim][3]])


def test_instance_keys_above_256():
    """The instance keys phase 14 of chip_smoke.py counts: the head dim
    asked, then the window kernel's window width and count (the forward in
    every library, and the f32 and mixed dQ and dK/dV, up to their
    clusters' limit: the slice width, the cluster's blocks and
    "cluster")."""
    bf = torch.bfloat16
    s16 = tfa.CLUSTERS[("flash_fwd", 16)][0]
    assert tfa.instance("flash_fwd", 384, bf) == f"flash_fwd d384 on d{s16}x{-(-384 // s16)} cluster bfloat16"
    assert tfa.instance("flash_fwd", 768, torch.float16) == f"flash_fwd d768 on d{s16}x{768 // s16} cluster float16"
    assert tfa.instance("flash_fwd", 1032, bf) == "flash_fwd d1032 on d256x5 bfloat16"
    assert tfa.instance("flash_dq", 384, bf) == "flash_dq d384 on d256x2 bfloat16"
    assert tfa.instance("flash_dq", 768, torch.float32) == "flash_dq d768 on d128x6 cluster float32"
    assert tfa.instance("flash_dkv", 384, "mixed") == "flash_dkv d384 on d128x3 cluster mixed"
    assert tfa.instance("flash_fwd", 384, torch.float32) == "flash_fwd d384 on d128x3 cluster float32"
    assert tfa.instance("flash_fwd", 1280, torch.float32) == "flash_fwd d1280 on d256x5 float32"
    assert tfa.instance("flash_dq", 1280, torch.float32) == "flash_dq d1280 on d256x5 float32"
    assert tfa.instance("flash_dkv", 768, bf) == "flash_dkv d768 on d128x6 bfloat16"
    assert tfa.instance("flash_fwd", 256, bf) == "flash_fwd d256 bfloat16"
    assert all(tfa.kernel_passes(name, d) == 1 for name in tfa.launches for d in (257, 384, 768, 4096))


def test_head_dims_below_one_raise_on_the_card():
    """Only a head dim below 1 is refused for its width, before any launch."""
    q = _cuda_like(torch.zeros(2, 16, 0, dtype=torch.bfloat16))
    lse = _cuda_like(torch.zeros(2, 16))
    before = dict(tfa.launches)
    for call in (lambda: tfa.flash_fwd(q, q, q, True), lambda: tfa.flash_dq(q, q, q, q, lse, lse, True),
                 lambda: tfa.flash_dkv(q, q, q, q, lse, lse, True)):
        with pytest.raises(ValueError, match="head dim 0"):
            call()
    assert tfa.launches == before
    with pytest.raises(ValueError, match="head dim"):
        tfa.windows("flash_fwd", 0, torch.bfloat16)


def _emulated_launch(entry, counter, head_dim, out_f32, *args, rounding=None):
    """The kernel stood in for by its plain version at the width and scale
    the entry point is given: writes the outputs in place (operands of one
    dtype)."""
    assert rounding is None
    q, k, v = args[:3]
    scale = next(a for a in args if isinstance(a, float))
    causal = bool(args[-1])
    qs = q.float() * (scale * math.sqrt(q.shape[-1]))  # the plain versions scale by 1 / sqrt(their width)
    if entry == "rt_flash_fwd":
        o, lse = tfa.flash_fwd_reference(qs, k, v, causal, out_f32)
        args[3].copy_(o)
        args[4].copy_(lse)
        return
    do, lse, delta = args[3:6]
    p = torch.exp(tfa._scores(qs, k, causal) - lse[..., None])
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - delta[..., None]) * scale
    if entry == "rt_flash_dq":
        args[6].copy_(torch.matmul(ds.to(k.dtype).float(), k.float()))
    else:
        args[6].copy_(torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float()))
        args[7].copy_(torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("head_dim", [257, 260])
def test_padding_copy_above_256_changes_no_result(monkeypatch, head_dim, dtype):
    """The padded route above 256 (257 in both dtypes, 260 in bf16; 260 is
    f32's own width): the operands copied into zero columns up to the
    kernel's width, the scale of the true head dim, the outputs sliced
    back, equal the plain versions at the true head dim."""
    monkeypatch.setattr(tfa, "_launch", _emulated_launch)
    rng = np.random.default_rng(head_dim)
    BH, Tq = 2, 24
    x = [torch.from_numpy(rng.standard_normal((BH, Tq, head_dim), dtype=np.float32)).to(dtype) for _ in range(4)]
    q, k, v, do = (_cuda_like(t) for t in x)
    o_ref, lse_ref = tfa.flash_fwd_reference(*x[:3], True)
    delta = (x[3].float() * o_ref.float()).sum(-1)
    refs = tfa.flash_bwd_reference(*x, lse_ref, delta, True)
    o, lse = tfa.flash_fwd(q, k, v, True)
    dq = tfa.flash_dq(q, k, v, do, _cuda_like(lse_ref), _cuda_like(delta), True)
    dk, dv = tfa.flash_dkv(q, k, v, do, _cuda_like(lse_ref), _cuda_like(delta), True)
    padded = tfa.kernel_head_dim(head_dim, dtype) > head_dim
    assert padded == (head_dim == 257 or dtype == torch.bfloat16)
    # f32: the JAX package's f32 forward limit, 1e-5 (the padded width's
    # 264- or 260-long sums run in another order); bf16: 1e-2
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for name, got, want in (("o", o, o_ref), ("dq", dq, refs[0]), ("dk", dk, refs[1]), ("dv", dv, refs[2])):
        assert got.shape == want.shape and got.dtype == want.dtype, name
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol, msg=name)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# What the .cuh states
# ---------------------------------------------------------------------------

WIDE_SOURCE = Path(tfa.__file__).resolve().parent / "csrc" / "flash_wide.cuh"


def _constants() -> dict:
    text = WIDE_SOURCE.read_text()
    return {name: int(value) for name, value in re.findall(r"\b([A-Z][A-Z0-9_]*) = (\d+)", text)}


def test_window_widths_are_the_cuh_constants():
    """WIDE_WINDOWS is FWD_WIN, DQ_WIN and DKV_WIN of flash_wide.cuh, and
    both libraries' entry points send every head dim above the widest
    instance there."""
    c = _constants()
    assert tfa.WIDE_WINDOWS == {"flash_fwd": c["FWD_WIN"], "flash_dq": c["DQ_WIN"], "flash_dkv": c["DKV_WIN"]}
    csrc = WIDE_SOURCE.parent
    for name in ("flash_attention.cu", "flash_attention_f32.cu"):
        text = (csrc / name).read_text()
        assert '#include "flash_wide.cuh"' in text, name
        assert "if (d <= 256)" in text and "std::integral_constant<int, WIDE>" in text, name
        assert len(re.findall(r"wide::launch_(?:fwd|dq|dkv)<", text)) == 3, name


@pytest.mark.parametrize("elem", [2, 4], ids=["16-bit", "f32"])
def test_window_kernels_shared_memory_fits(elem):
    """Each window kernel's shared memory (two chunk buffers of every
    operand's rows, then its value tiles; ``chip_smoke.wide_smem_plans``
    from the .cuh's constants) fits an H100 block (232,448 bytes) and
    leaves room for two blocks an SM, and its padded rows are 16-byte
    aligned with a stride of 4 mod 32 banks (conflict-free fragment
    reads)."""
    import chip_smoke

    c = _constants()
    for name, nbytes in chip_smoke.wide_smem_plans(elem).items():
        assert 2 * nbytes <= 232448, (name, nbytes)
    chunk = c["CHUNK_BYTES"] + 16
    for stride in (chunk, *(c[w] * elem + 16 for w in ("FWD_WIN", "DQ_WIN", "DKV_WIN"))):
        assert stride % 16 == 0 and (stride // 4) % 32 == 4, stride

"""Every head dim up to 256: the flash wrappers between and above the instances.

The CUDA kernels are instantiated for head dims 16, 32, 64, 128 and 256; a
head dim between two of them runs on the next one up, the tensors at their
own width and TMA filling the columns past it with zeros in shared memory,
and one whose rows are not 16-byte strided is first copied into
zero-padded tensors (``ray_tpu_torch/ops/flash_attention.py``). On the CPU
the wrappers run their plain versions; here those are held to the JAX
package's functions (the Pallas kernels in interpret mode, one tile per
call, as ``tests/test_torch_flash_reach.py`` runs them) at Dh 8, 20, 40,
48, 80, 96, 160, 192 and 256 in bf16 and f32, causal, non-causal with Tk !=
Tq and ragged; then GPT-2 with flash attention against the JAX model at
head dims 96 and 256; then the wrappers' routing of a CUDA tensor under a
fake library: the instance each head dim runs on, which head dims take the
padding copy, the width and scale the entry point is given, the counters,
and a head dim above 256 sent to the column-window kernels; and the padded
route's arithmetic, the kernel stood in for by its plain version at the
width and scale the entry point is given. Inputs come from seeded numpy
generators.
"""

import dataclasses
import math
import re
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

# tests/test_torch_flash_reach.py's limits. f32: the JAX package's own for
# its f32 kernels (tests/test_ring_attention.py:104), 1e-5 on the forward
# (out and lse) and 1e-4 on the gradients; bf16: every element by the
# kernels' rule on the card (bench.disagreement), lse within 1e-4.
FWD_TOL, GRAD_TOL, LSE_TOL = 1e-5, 1e-4, 1e-4

HEAD_DIMS = (8, 20, 40, 48, 80, 96, 160, 192, 256)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models' products are small and many: one intra-op thread keeps
    them from contending for the cores with the other workers of a
    parallel run (with the default thread count this file took ten times
    its time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (Tq, Tk, causal): causal, non-causal with Tk != Tq, ragged causal.
SHAPES = [(64, 64, True), (64, 96, False), (40, 40, True)]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, Tq, Tk, H, D):
    rng = np.random.default_rng(seed)
    make = lambda T: rng.standard_normal((B, T, H, D), dtype=np.float32)  # noqa: E731
    return make(Tq), make(Tk), make(Tk), make(Tq)


def _shape_id(shape):
    Tq, Tk, causal = shape
    return f"Tq{Tq}_Tk{Tk}_{'causal' if causal else 'full'}"


@pytest.fixture
def one_jax_tile(monkeypatch):
    def set_tiles(Tq, Tk):
        monkeypatch.setenv("RT_FLASH_BQ", str(Tq))
        monkeypatch.setenv("RT_FLASH_BK", str(Tk))
    return set_tiles


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_wrappers_match_jax_at_head_dim(cpu_mesh_devices, one_jax_tile, head_dim, shape, dtype):
    """The forward (out, lse) and dQ and dK/dV wrappers (their plain
    versions, on CPU tensors, folded [B*H, T, Dh]) against the JAX
    package's forward and VJP on the same inputs."""
    (Tq, Tk, causal), (jd, td), H = shape, DTYPES[dtype], 2
    q, k, v, do = _inputs(head_dim + Tk, 1, Tq, Tk, H, head_dim)
    one_jax_tile(Tq, Tk)
    jq, jk, jv, jdo = (jnp.asarray(x, dtype=jd) for x in (q, k, v, do))
    out_j, res = jfa._flash_fwd(jq, jk, jv, causal)
    lse_j = np.asarray(res[-1])[:, 0, :]
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, causal), jq, jk, jv)
    want = [np.asarray(x.astype(jnp.float32)) for x in (out_j, *vjp(jdo))]

    tq, tk, tv, tdo = (tfa._fold(torch.from_numpy(x).to(td)) for x in (q, k, v, do))
    o, lse = tfa.flash_fwd(tq, tk, tv, causal)
    delta = (tdo.float() * o.float()).sum(-1)
    dq = tfa.flash_dq(tq, tk, tv, tdo, lse, delta, causal)
    dk, dv = tfa.flash_dkv(tq, tk, tv, tdo, lse, delta, causal)
    got = [tfa._unfold(x, 1, H).float() for x in (o, dq, dk, dv)]
    assert all(x.dtype == td and x.shape[-1] == head_dim for x in (o, dq, dk, dv))
    for name, g, w, tol in zip(("o", "dq", "dk", "dv"), got, want, (FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        if dtype == "f32":
            np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol, err_msg=name)
        else:
            gap = bench.disagreement(g, torch.from_numpy(w.copy()))
            assert gap["ok"], (name, gap)
    np.testing.assert_allclose(lse.numpy(), lse_j, rtol=0, atol=FWD_TOL if dtype == "f32" else LSE_TOL)


# GPT-2 with flash attention at head dims 96 (d_model 192, 2 heads) and 256
# (d_model 256, 1 head), 2 layers, the JAX init carried across by from_jax;
# the limits of tests/test_torch_flash_reach.py's GPT-2 test.
GPT_WIDTHS = {96: (192, 2), 256: (256, 1)}
B, T = 2, 64


def _gpt_cfgs(head_dim, dtype):
    d_model, n_head = GPT_WIDTHS[head_dim]
    jd, td = DTYPES[dtype]
    kw = dict(d_model=d_model, n_layer=2, n_head=n_head, attn_impl="flash")
    return (dataclasses.replace(jg.CONFIGS["gpt2-tiny"], dtype=jd, **kw),
            dataclasses.replace(tg.CONFIGS["gpt2-tiny"], dtype=td, **kw))


@pytest.fixture(scope="module")
def gpt_params(cpu_mesh_devices):
    out = {}
    for head_dim in GPT_WIDTHS:
        params = jg.init(jax.random.PRNGKey(0), _gpt_cfgs(head_dim, "f32")[0])
        out[head_dim] = params, jax.tree.map(np.asarray, params)
    return out


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("head_dim", sorted(GPT_WIDTHS))
def test_gpt2_flash_matches_jax_at_head_dim(gpt_params, monkeypatch, head_dim, dtype):
    params_j, params_np = gpt_params[head_dim]
    jcfg, tcfg = _gpt_cfgs(head_dim, dtype)
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
# The wrappers on tensors that report CUDA, under a fake library
# ---------------------------------------------------------------------------


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that the wrappers take for a CUDA one."""

    is_cuda = True


def _cuda_like(x):
    return torch.Tensor._make_subclass(_ReportsCuda, x)


# head dim -> (instance, width given to the kernel: bf16, f32)
ROUTES = {1: (16, 8, 4), 6: (16, 8, 8), 8: (16, 8, 8), 20: (32, 24, 20), 40: (64, 40, 40),
          48: (64, 48, 48), 64: (64, 64, 64), 80: (128, 80, 80), 96: (128, 96, 96), 130: (256, 136, 132),
          160: (256, 160, 160), 192: (256, 192, 192), 256: (256, 256, 256)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("head_dim", sorted(ROUTES))
def test_routes_each_head_dim_to_its_instance(monkeypatch, head_dim, dtype):
    """Each wrapper hands the entry point of the operands' library tensors
    of the kernel's width (the head dim, or the padding copy's), that width
    as ``d`` and 1 / sqrt(the true head dim) as the scale, returns outputs
    of the true head dim, and counts the launch under the head dim asked
    and the instance that ran."""
    inst, width = ROUTES[head_dim][0], ROUTES[head_dim][1 if dtype == torch.bfloat16 else 2]
    assert tfa.instance_head_dim(head_dim) == inst and tfa.kernel_head_dim(head_dim, dtype) == width
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
    BH, Tq = 2, 32
    q = _cuda_like(torch.zeros(BH, Tq, head_dim, dtype=dtype))
    lse = _cuda_like(torch.zeros(BH, Tq))
    o, _ = tfa.flash_fwd(q, q, q, True)
    dq = tfa.flash_dq(q, q, q, q, lse, lse, True)
    dk, dv = tfa.flash_dkv(q, q, q, q, lse, lse, True)
    assert all(x.shape == (BH, Tq, head_dim) for x in (o, dq, dk, dv))
    lib = tfa.OPERAND_DTYPES[dtype]
    assert [(n, e) for n, e, _ in calls] == [(lib, e) for e in ("rt_flash_fwd", "rt_flash_dq", "rt_flash_dkv")]
    # the C signatures: (q, k, v, [dO, lse, delta,] outputs..., bh, tq, tk, d, scale, causal, out_f32,
    # [round_p, round_ds: the f32 library's, none for f32 operands,] stream)
    for (_, entry, args), n_ptrs in zip(calls, (5, 7, 8)):
        bh, tq, tk, d, scale, causal, out_f32, *rounding, _ = args[n_ptrs:]
        assert (bh, tq, tk, d, causal, out_f32) == (BH, Tq, Tq, width, 1, 0), entry
        assert rounding == ([0, 0] if dtype == torch.float32 else []), entry
        assert scale == pytest.approx(1 / math.sqrt(head_dim), rel=1e-7), entry
        if width == head_dim:  # the caller's own tensors, no copy
            assert args[0] == q.data_ptr(), entry
        else:
            assert args[0] != q.data_ptr(), entry
    kernels = {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 2 if inst == 256 else 1}  # dK/dV's two passes
    assert tfa.launches == kernels
    assert tfa.launches_f32 == {name: n * (dtype == torch.float32) for name, n in kernels.items()}
    on = "" if inst == head_dim else f" on d{inst}"
    dt = str(dtype).removeprefix("torch.")
    assert tfa.launches_by_instance == {f"{name} d{head_dim}{on} {dt}": n for name, n in kernels.items()}
    assert tfa.instance("flash_fwd", head_dim, dtype) == f"flash_fwd d{head_dim}{on} {dt}"


@pytest.mark.parametrize("head_dim", tfa.HEAD_DIMS)
def test_dkv_passes_are_the_cu_traits(head_dim):
    """The wrapper counts as many dK/dV kernels a call as the instance's
    DKV_PASSES in both libraries' tile blocks (Tiles<D>, F32Tiles<D>)."""
    from pathlib import Path

    csrc = Path(tfa.__file__).resolve().parent / "csrc"
    for name, traits in (("flash_attention.cu", "Tiles"), ("flash_attention_f32.cu", "F32Tiles")):
        blocks = dict(re.findall(rf"^struct {traits}(?:<(\d+)>)? \{{(.*?)^\}};", (csrc / name).read_text(),
                                 re.M | re.S))
        body = blocks.get(str(head_dim), blocks.get(""))
        passes = int(re.search(r"DKV_PASSES = (\d+)", body)[1])
        assert tfa.kernel_passes("flash_dkv", head_dim) == passes, name
    assert tfa.kernel_passes("flash_fwd", head_dim) == tfa.kernel_passes("flash_dq", head_dim) == 1


@pytest.mark.parametrize("head_dim", [257, 264, 512])
def test_head_dims_above_256_raise_and_launch_nothing(monkeypatch, head_dim):
    """A CUDA tensor wider than the widest instance no longer raises: each
    wrapper launches its library's kernel above 256 once (the width it is
    given is the padding copy's at 257), counted under that kernel's
    instance: dQ's and dK/dV's column windows, the forward's cluster of
    256-column slices; on the CPU the plain versions take it."""
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
    x = torch.zeros(2, 16, head_dim, dtype=torch.bfloat16)
    q, lse = _cuda_like(x), _cuda_like(torch.zeros(2, 16))
    outs = [tfa.flash_fwd(q, q, q, True)[0], tfa.flash_dq(q, q, q, q, lse, lse, True),
            *tfa.flash_dkv(q, q, q, q, lse, lse, True)]
    assert all(o.shape == x.shape for o in outs)
    width = -(-head_dim // 8) * 8
    assert [(n, e) for n, e, _ in calls] == [("flash_attention", e) for e in ("rt_flash_fwd", "rt_flash_dq",
                                                                              "rt_flash_dkv")]
    assert all(args[n_ptrs + 3] == width for (_, _, args), n_ptrs in zip(calls, (5, 7, 8)))
    assert tfa.launches == dict.fromkeys(tfa.launches, 1)
    on = {name: f"d{tfa.WIDE_WINDOWS[name]}x{-(-head_dim // tfa.WIDE_WINDOWS[name])}" for name in tfa.launches}
    on["flash_fwd"] = f"d256x{-(-head_dim // 256)} cluster"
    assert tfa.launches_by_instance == {f"{name} d{head_dim} on {on[name]} bfloat16": 1 for name in tfa.launches}
    assert tfa.flash_fwd(x, x, x, True)[0].shape == x.shape


def _emulated_launch(entry, counter, head_dim, out_f32, *args, rounding=None):
    """The kernel stood in for by its plain version at the width and scale
    the entry point is given: writes the outputs in place (operands of one
    dtype: ``rounding`` is None)."""
    assert rounding is None
    q, k, v = args[:3]
    scale = next(a for a in args if isinstance(a, float))
    causal = bool(args[-1])
    plain_scale = 1.0 / math.sqrt(q.shape[-1])
    # the plain versions scale by 1 / sqrt(their width): fold the given scale into q
    qs = q.float() * (scale / plain_scale)
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
@pytest.mark.parametrize("head_dim", [6, 20, 36])
def test_padding_copy_changes_no_result(monkeypatch, head_dim, dtype):
    """The padded route's arithmetic: the operands copied into zero columns
    up to the kernel's width, the entry point given 1 / sqrt(the true head
    dim), the outputs sliced back, equal the plain versions at the true
    head dim (the zero columns change no score and no real column)."""
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
    assert tfa.kernel_head_dim(head_dim, dtype) > head_dim or dtype == torch.float32
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    for name, got, want in (("o", o, o_ref), ("dq", dq, refs[0]), ("dk", dk, refs[1]), ("dv", dv, refs[2])):
        assert got.shape == want.shape and got.dtype == want.dtype, name
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol, msg=name)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("head_dim", (16, 32, 64, 128))
def test_tile_sweep_settings_name_the_cu_macros(head_dim):
    """``python3 -m ray_tpu_torch.sweep_flash_tiles --head-dim D`` takes
    the head dim of every tile set with ring-depth macros (Dh 256's rings
    are fixed at two stages), and each of its builds overrides a ring-depth
    macro the .cu reads for that head dim's tile set (the chosen depth
    among those it tries)."""
    from pathlib import Path

    from ray_tpu_torch import sweep_flash_tiles as sweep

    source = (Path(tfa.__file__).resolve().parent / "csrc" / "flash_attention.cu").read_text()
    assert head_dim in sweep.SWEPT_HEAD_DIMS and 256 not in sweep.SWEPT_HEAD_DIMS
    settings = sweep.settings(head_dim)
    assert settings
    for (define,) in settings:
        macro, value = define.split("=")
        assert f"#ifndef {macro}\n#define {macro} " in source and int(value) >= 2, define
    suffix = "_128" if head_dim == 128 else ""
    for kind in ("FWD", "DKV", "DQ"):
        default = int(re.search(rf"^#define RT_{kind}_STAGES{suffix} (\d+)$", source, re.M)[1])
        assert f"RT_{kind}_STAGES{suffix}={default}" in {d for (d,) in settings}, (kind, head_dim)

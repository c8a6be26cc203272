"""f16 operands and operands of mixed dtypes in the flash kernels.

The CUDA kernels take f16 operands (``csrc/flash_attention_f16.cu``: the
bf16 kernels instantiated for f16) and operands of mixed dtypes (cast up to
f32 and run on the f32 kernels built with rounding,
``csrc/flash_attention_mixed.cu``), as the Pallas kernels do. On the CPU the
wrappers run their plain versions; here those are held to the JAX package's
functions (the Pallas kernels in interpret mode, one tile per call) on
inputs from seeded numpy generators: the autograd Function and the ring's
block entries, in f16 and in four mixes, at head dims 64, 48 and 20, causal
and not. Then the wrappers' routing of a CUDA tensor: f16 to the f16
library, a mix to the mixed library with the rounding types the Pallas
kernels imply, each output in its operand's dtype, every launch counted.

Tolerances. Each output goes through one rounding of P or dS (o: P to
v's dtype; dq: dS to k's; dk: dS to q's; dv: P to dO's). Where that
rounding is to a 16-bit dtype, or the output is in one: both sides round
at the same places but compute the rounded values in other orders, so an
element near a rounding boundary may land on the neighbouring 16-bit value
on each side (measured here: up to 0.75% of an f32 output's elements past
1e-4), and every element is held by the kernels' own rule on the card
(bench.disagreement: 2^-6 relative + 2e-2 of the row's rms, 1e-2 in
relative norm). An f32 output with no 16-bit rounding on its path: 1e-5
on the forward and 1e-4 on the gradients (the JAX package's limits for
its f32 kernels, tests/test_ring_attention.py:104), relative and absolute.
lse (f32 on both sides): 1e-4. Output dtypes equal JAX's.
"""

import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch import bench
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as tfa

FWD_TOL, GRAD_TOL, LSE_TOL = 1e-5, 1e-4, 1e-4

# (q, k, v) dtypes; dO takes q's (the output's). f16 alone, then the four
# mixes the card holds too (chip_smoke.py phase 2).
DTYPE_SETS = {
    "f16": ("float16", "float16", "float16"),
    "bf16_f32_bf16": ("bfloat16", "float32", "bfloat16"),
    "f32_bf16_bf16": ("float32", "bfloat16", "bfloat16"),
    "f16_bf16_f16": ("float16", "bfloat16", "float16"),
    "f16_f16_f32": ("float16", "float16", "float32"),
}
# (B, Tq, Tk, H, Dh, causal): head dims 64, 48 (between instances) and 20
# (the padding copy's), causal and non-causal with Tk != Tq.
CASES = [(1, 256, 256, 2, 64, True), (1, 64, 96, 2, 64, False), (1, 128, 128, 2, 48, True),
         (1, 96, 64, 2, 48, False), (1, 40, 40, 2, 20, True), (1, 64, 96, 2, 20, False)]


def _id(case):
    B, Tq, Tk, H, D, causal = case
    return f"Tq{Tq}_Tk{Tk}_D{D}_{'causal' if causal else 'full'}"


def _draw(seed, B, Tq, Tk, H, D):
    rng = np.random.default_rng(seed)
    shapes = [(B, Tq, H, D), (B, Tk, H, D), (B, Tk, H, D), (B, Tq, H, D)]
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


# The operand whose dtype P or dS is rounded to on each output's path: o's
# P to v's, dq's dS to k's, dk's dS to q's, dv's P to dO's.
THROUGH = {"o": 2, "dq": 1, "dk": 0, "dv": 3}


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
    """The JAX kernels in one tile per call (a ragged T would otherwise fall
    back to 8-row tiles, many interpret-mode steps)."""
    monkeypatch.setenv("RT_FLASH_BQ", str(Tq))
    monkeypatch.setenv("RT_FLASH_BK", str(Tk))


@pytest.mark.parametrize("dtypes", list(DTYPE_SETS))
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_flash_attention_matches_jax(cpu_mesh_devices, monkeypatch, case, dtypes):
    """The port's autograd Function (its plain versions, on CPU tensors)
    against the JAX package's flash attention and its VJP: o, lse, and the
    gradient of each operand, each in JAX's dtype."""
    B, Tq, Tk, H, D, causal = case
    names = DTYPE_SETS[dtypes] + DTYPE_SETS[dtypes][:1]
    draws = _draw(D + Tk, B, Tq, Tk, H, D)
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
    got = [out_t, tq.grad, tk.grad, tv.grad]
    want = [out_j, *grads_j]
    for name, g, w, tol in zip(("o", "dq", "dk", "dv"), got, want, (FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), (name, g.dtype, w.dtype)
        _held(g, np.asarray(w.astype(jnp.float32)), tol, (name, case, dtypes), names[THROUGH[name]])
    assert np.abs(lse_t.numpy() - lse_j).max() <= LSE_TOL


def _sublanes(x):  # [BH, T] -> the TPU's [BH, 8, T]
    return jnp.broadcast_to(jnp.asarray(x)[:, None, :], (x.shape[0], 8, x.shape[1]))


@pytest.mark.parametrize("dtypes", list(DTYPE_SETS))
@pytest.mark.parametrize("case", [(2, 64, 64, 2, 64, True), (1, 32, 96, 2, 48, False)], ids=_id)
def test_block_entries_match_jax(cpu_mesh_devices, monkeypatch, case, dtypes):
    """flash_fwd_block and flash_bwd_block (f32 outputs, the ring's) in f16
    and in the mixes against the JAX package's, on the same lse and delta,
    each output by the rule of its path (above)."""
    B, Tq, Tk, H, D, causal = case
    names = DTYPE_SETS[dtypes] + DTYPE_SETS[dtypes][:1]
    draws = _draw(7, B, Tq, Tk, H, D)
    _jax_tiles(monkeypatch, Tq, Tk)
    jx = [jnp.asarray(x).astype(n) for x, n in zip(draws, names)]
    tx = [torch.from_numpy(x).to(getattr(torch, n)) for x, n in zip(draws, names)]

    o_j, lse_j = jfa.flash_fwd_block(*jx[:3], causal=causal)
    o_t, lse_t = tfa.flash_fwd_block(*tx[:3], causal=causal)
    assert o_t.dtype == torch.float32 and str(o_j.dtype) == "float32"
    _held(o_t, np.asarray(o_j), FWD_TOL, ("o", case, dtypes), names[THROUGH["o"]])
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[:, 0, :], rtol=FWD_TOL, atol=FWD_TOL)

    # the ring's global lse and delta: this block's, delta from o cast to q's dtype
    o_cast = o_t.to(tx[0].dtype)
    delta = (tx[3].float() * o_cast.float()).sum(-1).permute(0, 2, 1).reshape(B * H, Tq)
    grads_j = jfa.flash_bwd_block(*jx, _sublanes(lse_t.numpy()), _sublanes(delta.numpy()), causal=causal)
    grads_t = tfa.flash_bwd_block(*tx, lse_t, delta, causal=causal)
    for name, g_t, g_j in zip(("dq", "dk", "dv"), grads_t, grads_j):
        assert g_t.dtype == torch.float32 and str(g_j.dtype) == "float32", name
        _held(g_t, np.asarray(g_j), GRAD_TOL, (name, case, dtypes), names[THROUGH[name]])


# ---------------------------------------------------------------------------
# Routing of CUDA tensors (CPU tensors that report CUDA; the library loads
# are stood in for).
# ---------------------------------------------------------------------------


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that the wrappers' checks take for a CUDA one."""

    is_cuda = True


def _cuda_like(x: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_ReportsCuda, x)


ROUND = {"float32": 0, "bfloat16": 1, "float16": 2}  # Round in csrc/flash_attention_f32.cu


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


@pytest.mark.parametrize("head_dim", [64, 48])
@pytest.mark.parametrize("dtypes", list(DTYPE_SETS))
def test_launch_routes_f16_and_mixes(monkeypatch, dtypes, head_dim):
    """f16 operands reach the f16 library's entry points with f16 tensors;
    a mix reaches the mixed library with every operand cast to f32 and the
    rounding types of P and dS the Pallas kernels imply (forward: P to v's
    dtype; dQ: dS to k's; dK/dV: P to dO's, dS to q's), after out_f32. The
    outputs come back in their operands' dtypes (o and dq in q's, dk in
    k's, dv in v's); a mix's launches count as f32-operand launches, and
    every launch under its instance ("... mixed" for a mix)."""
    calls = _recording_loads(monkeypatch)
    BH, T = 2, 32
    qd, kd, vd = (getattr(torch, n) for n in DTYPE_SETS[dtypes])
    q, k, v, do = (_cuda_like(torch.zeros(BH, T, head_dim, dtype=d)) for d in (qd, kd, vd, qd))
    lse = _cuda_like(torch.zeros(BH, T))
    o, _ = tfa.flash_fwd(q, k, v, True)
    dq = tfa.flash_dq(q, k, v, do, lse, lse, True)
    dk, dv = tfa.flash_dkv(q, k, v, do, lse, lse, True)
    assert (o.dtype, dq.dtype, dk.dtype, dv.dtype) == (qd, qd, kd, vd)
    assert all(x.shape == (BH, T, head_dim) for x in (o, dq, dk, dv))
    mixed = dtypes != "f16"
    lib = "flash_attention_mixed" if mixed else "flash_attention_f16"
    assert [(n, e) for n, e, _ in calls] == [(lib, e) for e in ("rt_flash_fwd", "rt_flash_dq", "rt_flash_dkv")]
    want_rounding = {"rt_flash_fwd": [ROUND[str(vd)[6:]], 0], "rt_flash_dq": [0, ROUND[str(kd)[6:]]],
                     "rt_flash_dkv": [ROUND[str(qd)[6:]], ROUND[str(qd)[6:]]]}  # dO is q's dtype here
    for (_, entry, args), n_ptrs in zip(calls, (5, 7, 8)):
        bh, tq, tk, d, scale, causal, out_f32, *rounding, _ = args[n_ptrs:]
        assert (bh, tq, tk, d, causal, out_f32) == (BH, T, T, head_dim, 1, 0), entry
        assert scale == pytest.approx(1 / math.sqrt(head_dim), rel=1e-7), entry
        assert rounding == (want_rounding[entry] if mixed else []), entry
        # a mix's 16-bit operands go as f32 copies, an f32 one as it is
        assert (args[0] == q.data_ptr()) == (not mixed or qd == torch.float32), entry
    assert tfa.launches == dict.fromkeys(tfa.launches, 1)
    assert tfa.launches_f32 == dict.fromkeys(tfa.launches, int(mixed))
    key = "mixed" if mixed else "float16"
    on = "" if head_dim == 64 else " on d64"
    assert tfa.launches_by_instance == {f"{n} d{head_dim}{on} {key}": 1 for n in tfa.launches}


def test_mixed_rounding_follows_each_operand(monkeypatch):
    """dK/dV's rounding types follow dO's dtype for P and q's for dS, even
    where the two differ; f32 dO rounds P not at all."""
    calls = _recording_loads(monkeypatch)
    BH, T, D = 2, 16, 32
    q = _cuda_like(torch.zeros(BH, T, D, dtype=torch.float16))
    k = _cuda_like(torch.zeros(BH, T, D, dtype=torch.bfloat16))
    v = _cuda_like(torch.zeros(BH, T, D, dtype=torch.float16))
    do = _cuda_like(torch.zeros(BH, T, D, dtype=torch.float32))
    lse = _cuda_like(torch.zeros(BH, T))
    dk, dv = tfa.flash_dkv(q, k, v, do, lse, lse, True)
    dq = tfa.flash_dq(q, k, v, do, lse, lse, True)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.float16, torch.bfloat16, torch.float16)
    (_, _, dkv_args), (_, _, dq_args) = calls
    assert list(dkv_args[-3:-1]) == [ROUND["float32"], ROUND["float16"]]
    assert list(dq_args[-3:-1]) == [0, ROUND["bfloat16"]]
    o, _ = tfa.flash_fwd(q, k, v, True, out_f32=True)  # f32 outputs asked for: no cast back
    assert o.dtype == torch.float32


def _emulated_mixed_launch(entry, counter, head_dim, out_f32, *args, rounding=None):
    """The mixed kernel stood in for by plain f32 arithmetic on the f32
    operands it is given, rounding P and dS to the dtypes its rounding types
    name: writes the outputs in place."""
    assert rounding is not None and all(a.dtype == torch.float32 for a in args[:3])
    as_dtype = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16}
    rnd = lambda x, r: x.to(as_dtype[r]).float()  # noqa: E731
    q, k, v = args[:3]
    scale = next(a for a in args if isinstance(a, float))
    causal = bool(args[-1])
    # the plain versions scale by 1 / sqrt(their width): fold the given scale into q
    s = tfa._scores(q * (scale * math.sqrt(q.shape[-1])), k, causal)
    if entry == "rt_flash_fwd":
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        args[3].copy_(torch.matmul(rnd(p, rounding[0]), v) / p.sum(-1, keepdim=True))
        args[4].copy_((m + torch.log(p.sum(-1, keepdim=True))).squeeze(-1))
        return
    do, lse, delta = args[3:6]
    p = torch.exp(s - lse[..., None])
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - delta[..., None]) * scale
    if entry == "rt_flash_dq":
        args[6].copy_(torch.matmul(rnd(ds, rounding[1]), k))
    else:
        args[6].copy_(torch.matmul(rnd(ds, rounding[1]).transpose(-1, -2), q))
        args[7].copy_(torch.matmul(rnd(p, rounding[0]).transpose(-1, -2), do))


@pytest.mark.parametrize("head_dim", [64, 6])
@pytest.mark.parametrize("dtypes", [d for d in DTYPE_SETS if d != "f16"])
def test_mixed_route_computes_the_plain_versions(monkeypatch, dtypes, head_dim):
    """The mixed route's arithmetic: the operands cast to f32 (and, at head
    dim 6, padded to f32's 16-byte rows, 8), the kernel rounding P and dS
    by the types the wrapper hands it, the results cast back, equal the
    plain versions on the original operands (which round per operand)."""
    monkeypatch.setattr(tfa, "_launch", _emulated_mixed_launch)
    rng = np.random.default_rng(head_dim)
    BH, T = 2, 24
    qd, kd, vd = (getattr(torch, n) for n in DTYPE_SETS[dtypes])
    x = [torch.from_numpy(rng.standard_normal((BH, T, head_dim), dtype=np.float32)).to(d)
         for d in (qd, kd, vd, qd)]
    q, k, v, do = (_cuda_like(t) for t in x)
    o_ref, lse_ref = tfa.flash_fwd_reference(*x[:3], True)
    delta = (x[3].float() * o_ref.float()).sum(-1)
    refs = tfa.flash_bwd_reference(*x, lse_ref, delta, True)
    o, lse = tfa.flash_fwd(q, k, v, True)
    dq = tfa.flash_dq(q, k, v, do, _cuda_like(lse_ref), _cuda_like(delta), True)
    dk, dv = tfa.flash_dkv(q, k, v, do, _cuda_like(lse_ref), _cuda_like(delta), True)
    for name, got, want in (("o", o, o_ref), ("dq", dq, refs[0]), ("dk", dk, refs[1]), ("dv", dv, refs[2])):
        assert got.shape == want.shape and got.dtype == want.dtype, name
        # f32 sums in other orders (the padded width): 1e-6, or one unit in
        # the last place of a 16-bit result's dtype
        tol = 1e-6 if got.dtype == torch.float32 else torch.finfo(got.dtype).eps
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=1e-6, msg=name)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-6, atol=1e-6)

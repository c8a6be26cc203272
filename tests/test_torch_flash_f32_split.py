"""The f32-operand flash kernels' 3xTF32 arithmetic, modelled in plain PyTorch on the CPU.

``ray_tpu_torch/ops/csrc/flash_attention_f32.cu`` computes the f32 flash
forward and backward on the tensor cores: every f32 operand x is split
into big = tf32(x) (round to nearest, ties away from zero, as
``cvt.rna.tf32.f32`` does) and small = tf32(x - big), and each product is
big.small + small.big + big.big per k-step of 8, in that order, into one
f32 accumulator. This file writes that arithmetic out in PyTorch, tf32
rounding by bit operations, at the tile sizes the ``.cu`` settles on for
each head dim (``F32Tiles<D>``, read from the source), with the kernels'
schedules: a dQ or dK/dV block owns 64 rows, its two consumer warpgroups
take alternate key tiles (dQ) or q tiles (dK/dV) and their partial sums
meet at the end; a forward block owns FWD_ROWS q rows, 64 a warpgroup on
every key tile (or, at 64 rows, alternate tiles whose (m, l, O) merge at
the end), with an online max, sum and rescale in exp2 units. The models
are held to the JAX package's f32 flash forward and backward (the Pallas
kernels in interpret mode, one tile per call, as
``tests/test_torch_flash_reach.py`` runs them) and to the port's plain
versions; the same models with a single TF32 product land far from both,
which is why the split is there. The schedules are held to covering every
kept (q, key) pair once, the transposed tiles' permutation to the
accumulator's register layout, and the split pass's stores to distinct
shared-memory banks. Inputs come from seeded numpy generators at
gpt2-tiny's width (d_model 64; Dh 128 as one head).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch import bench
from ray_tpu_torch.ops import flash_attention as tfa

CU = Path(tfa.__file__).resolve().parent / "csrc" / "flash_attention_f32.cu"
HEAD_DIMS = tuple(tfa.HEAD_DIMS)  # 16, 32, 64, 128, 256
SMEM_LIMIT = 232448  # dynamic shared memory a block may have on an H100
# The JAX package's limit for its f32 kernels' gradients
# (tests/test_ring_attention.py:104), in relative norm.
GRAD_RELNORM = 1e-4
# ... and for its f32 forward: o in relative norm, lse absolute.
FWD_RELNORM, LSE_TOL = 1e-5, 1e-5
LOG2E = 1.4426950408889634
D_MODEL = 64  # gpt2-tiny's width


def cu_f32_tiles(source: str) -> dict:
    """``F32Tiles<D>`` of flash_attention_f32.cu, {D: {NAME: int}}, with
    the global ``ROWS_OWNED`` (rows of a block) beside each."""
    rows = int(re.search(r"^constexpr int ROWS_OWNED = (\d+);", source, re.M)[1])
    out = {}
    for d, body in re.findall(r"^struct F32Tiles<(\d+)> \{(.*?)^\};", source, re.M | re.S):
        out[int(d)] = {name: int(v) for name, v in re.findall(r"(\w+) = (\d+)", body)}
        out[int(d)]["ROWS_OWNED"] = rows
    return out


TILES = cu_f32_tiles(CU.read_text())


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


# ---------------------------------------------------------------------------
# The arithmetic: tf32 rounding, the split, the three products
# ---------------------------------------------------------------------------


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 (10 mantissa bits), to nearest, ties away from
    zero: half a tf32 ulp added to the magnitude, the low 13 bits cleared
    (the sign bit rides along, so the magnitude rounds)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mma3(a: torch.Tensor, b: torch.Tensor, single: bool = False) -> torch.Tensor:
    """a [.., M, K] @ b [.., K, N] as the kernels' tensor cores take it:
    per k-step of 8, big.small, small.big, then big.big into one f32 sum
    (``single``: big.big alone, one TF32 product)."""
    ab, a_s = split(a)
    bb, b_s = split(b)
    out = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for k in range(0, a.shape[-1], 8):
        ks = slice(k, k + 8)
        terms = [(ab, bb)] if single else [(ab, b_s), (a_s, bb), (ab, bb)]
        for x, y in terms:
            out = out + x[..., ks] @ y[..., ks, :]
    return out


def _ceil(a, b):
    return -(-a // b)


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero rows past T, as TMA fills them."""
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[1]))


# ---------------------------------------------------------------------------
# The schedules: which tiles each block's consumer warpgroups take
# ---------------------------------------------------------------------------


def dq_schedule(Tq, Tk, causal, t):
    """Per q block (64 rows from q0): q0 and, per consumer warpgroup c, its
    key tiles (of DQ_BK keys) in order, each with whether it is masked."""
    R, BK = t["ROWS_OWNED"], t["DQ_BK"]
    blocks = []
    for qt in range(_ceil(Tq, R)):
        q0 = qt * R
        n_k = _ceil(min(Tk, q0 + R) if causal else Tk, BK)
        n_plain = min(min(Tk // BK, (q0 + 1) // BK) if causal else Tk // BK, n_k)
        blocks.append((q0, [[(i, i >= n_plain) for i in range(c, n_k, 2)] for c in range(2)]))
    return blocks


def dkv_schedule(Tq, Tk, causal, t):
    """Per key block (64 keys from k0): k0 and, per consumer warpgroup c,
    its q tiles (of DKV_BQ rows) in order, each with whether it is masked."""
    R, BQ = t["ROWS_OWNED"], t["DKV_BQ"]
    n_qs = _ceil(Tq, BQ)
    blocks = []
    for kt in range(_ceil(Tk, R)):
        k0 = kt * R
        i_begin = k0 // BQ if causal else 0
        diag_end = min(n_qs, (k0 + R - 1) // BQ + 1) if causal else i_begin
        plain_end = max(diag_end, Tq // BQ)
        blocks.append((k0, [[(i, i < diag_end or i >= plain_end) for i in range(i_begin + c, n_qs, 2)]
                            for c in range(2)]))
    return blocks


def fwd_schedule(Tq, Tk, causal, t):
    """Per q block (FWD_ROWS rows from q0): q0 and, per consumer warpgroup
    c, (its first row, the key tiles (of FWD_BK keys) it computes in order,
    each with whether it is masked, and the tiles it only waits for and
    releases). FWD_ROWS 128: c owns rows q0 + 64c.., both walk every tile;
    64: both own the 64 rows, c takes tiles c, c + 2, ..."""
    R, ROWS, BK = t["ROWS_OWNED"], t["FWD_ROWS"], t["FWD_BK"]
    shared = ROWS == 2 * R
    blocks = []
    for qt in range(_ceil(Tq, ROWS)):
        q0 = qt * ROWS
        n_k = _ceil(min(Tk, q0 + ROWS) if causal else Tk, BK)
        per_wg = []
        for c in range(2):
            r0 = q0 + R * c if shared else q0
            if not shared:
                n_mine = n_k
            else:
                n_mine = _ceil(min(Tk, r0 + R) if causal else Tk, BK) if r0 < Tq else 0
            n_plain = min(min(Tk // BK, (r0 + 1) // BK) if causal else Tk // BK, n_mine)
            step, first = (1, 0) if shared else (2, c)
            mine = [(i, i >= n_plain) for i in range(first, n_mine, step)]
            after = first + step * len(mine)
            per_wg.append((r0, mine, list(range(after, n_k, step))))
        blocks.append((q0, per_wg))
    return blocks


# ---------------------------------------------------------------------------
# The kernels in that order
# ---------------------------------------------------------------------------


def fwd_model(q, k, v, causal, single=False):
    """(o, lse) by flash_f32_fwd_kernel's schedule and arithmetic: per
    warpgroup and key tile, S = Q K^T in 3xTF32, s = S (scale log2 e) in
    f32, masked to -inf; the running max m (log2 units) and base (0 while
    a row has seen no key); alpha = exp2(m_old - base), P = exp2(s - base);
    each of a row's four threads keeps the sum of its columns (2t, 2t + 1
    of every 8), l = l alpha + that; O = O alpha + P V in 3xTF32 (V^T split
    in shared memory, P split into register fragments). At 64-row blocks
    the two warpgroups' (m, l, O) merge, warpgroup 0's first. Then l over
    the four threads ((l0 + l1) + (l2 + l3)), o = O (1 / l) and lse = (m +
    log2 l) / log2 e."""
    BH, Tq, D = q.shape
    Tk, t = k.shape[1], TILES[D]
    R, ROWS, BK = t["ROWS_OWNED"], t["FWD_ROWS"], t["FWD_BK"]
    scale = 1.0 / math.sqrt(D)
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    qp = _pad_rows(q, _ceil(Tq, ROWS) * ROWS)
    kp, vp = _pad_rows(k, _ceil(Tk, BK) * BK), _pad_rows(v, _ceil(Tk, BK) * BK)
    o, lse = torch.zeros(BH, Tq, D), torch.zeros(BH, Tq)

    def base_of(m):
        return torch.where(m == -math.inf, torch.zeros(()), m)

    for q0, per_wg in fwd_schedule(Tq, Tk, causal, t):
        parts = []
        for r0, tiles, _ in per_wg:
            rows = torch.arange(r0, r0 + R)
            m = torch.full((BH, R), -math.inf)
            l4 = torch.zeros(BH, R, 4)  # per thread t of the row
            acc = torch.zeros(BH, R, D)
            for i, _ in tiles:
                ks = slice(i * BK, (i + 1) * BK)
                s = mma3(qp[:, r0:r0 + R], kp[:, ks].transpose(1, 2), single) * sl2
                cols = torch.arange(i * BK, (i + 1) * BK)
                s = s.masked_fill((cols[None, :] >= Tk) | (causal & (cols[None, :] > rows[:, None])), -math.inf)
                m_new = torch.maximum(m, s.amax(-1))
                base = base_of(m_new)
                alpha = torch.exp2(m - base)
                p = torch.exp2(s - base[..., None])
                l4 = l4 * alpha[..., None] + p.view(BH, R, BK // 8, 4, 2).sum((2, 4))
                acc = acc * alpha[..., None] + mma3(p, vp[:, ks], single)
                m = m_new
            parts.append((r0, m, l4, acc))
        if ROWS == R:  # the two warpgroups' partial results of the same rows
            (r0, m0, l0, a0), (_, m1, l1, a1) = parts
            m = torch.maximum(m0, m1)
            base = base_of(m)
            w0, w1 = torch.exp2(m0 - base), torch.exp2(m1 - base)
            parts = [(r0, m, l0 * w0[..., None] + l1 * w1[..., None], a0 * w0[..., None] + a1 * w1[..., None])]
        for r0, m, l4, acc in parts:
            n = min(R, Tq - r0)
            if n <= 0:
                continue
            l = (l4[..., 0] + l4[..., 1]) + (l4[..., 2] + l4[..., 3])
            o[:, r0:r0 + n] = (acc * (1.0 / l)[..., None])[:, :n]
            lse[:, r0:r0 + n] = ((m + torch.log2(l)) / torch.tensor(LOG2E, dtype=torch.float32))[:, :n]
    return o, lse


def dq_model(q, k, v, do, lse, delta, causal, single=False):
    """dQ by flash_f32_dq_kernel's schedule and arithmetic: S = Q K^T and
    dP = dO V^T in 3xTF32, P = exp2(S scale log2 e - lse log2 e), dS = P
    (dP scale - delta scale), dQ += dS K in 3xTF32 per warpgroup, the two
    partial sums added (warpgroup 0's first)."""
    BH, Tq, D = q.shape
    Tk, t = k.shape[1], TILES[D]
    R, BK = t["ROWS_OWNED"], t["DQ_BK"]
    scale = 1.0 / math.sqrt(D)
    qp, dop = _pad_rows(q, _ceil(Tq, R) * R), _pad_rows(do, _ceil(Tq, R) * R)
    kp, vp = _pad_rows(k, _ceil(Tk, BK) * BK), _pad_rows(v, _ceil(Tk, BK) * BK)
    rows_in = torch.arange(_ceil(Tq, R) * R) < Tq
    l2 = torch.where(rows_in, _pad_rows(lse[..., None], len(rows_in))[..., 0] * LOG2E, 0.0)
    dl = torch.where(rows_in, _pad_rows(delta[..., None], len(rows_in))[..., 0] * scale, 0.0)
    dq = torch.zeros(BH, Tq, D)
    for q0, per_wg in dq_schedule(Tq, Tk, causal, t):
        rows = torch.arange(q0, q0 + R)
        sums = []
        for tiles in per_wg:
            acc = torch.zeros(BH, R, D)
            for i, _ in tiles:
                ks = slice(i * BK, (i + 1) * BK)
                s = mma3(qp[:, q0:q0 + R], kp[:, ks].transpose(1, 2), single)
                p = torch.exp2(s * (scale * LOG2E) - l2[:, q0:q0 + R, None])
                cols = torch.arange(i * BK, (i + 1) * BK)
                p = p.masked_fill((cols[None, :] >= Tk) | (causal & (cols[None, :] > rows[:, None])), 0.0)
                dp = mma3(dop[:, q0:q0 + R], vp[:, ks].transpose(1, 2), single)
                ds = p * (dp * scale - dl[:, q0:q0 + R, None])
                acc = acc + mma3(ds, kp[:, ks], single)
            sums.append(acc)
        n = min(R, Tq - q0)
        dq[:, q0:q0 + n] = (sums[0] + sums[1])[:, :n]
    return dq


def dkv_model(q, k, v, do, lse, delta, causal, single=False):
    """(dK, dV) by flash_f32_dkv_kernel's schedule and arithmetic: S^T = K
    Q^T and dP^T = V dO^T in 3xTF32, P^T and dS^T in f32, dV += P^T dO and
    dK += dS^T Q in 3xTF32 per warpgroup, the partial sums added."""
    BH, Tq, D = q.shape
    Tk, t = k.shape[1], TILES[D]
    R, BQ = t["ROWS_OWNED"], t["DKV_BQ"]
    scale = 1.0 / math.sqrt(D)
    n_rows = _ceil(Tq, BQ) * BQ
    qp, dop = _pad_rows(q, n_rows), _pad_rows(do, n_rows)
    kp, vp = _pad_rows(k, _ceil(Tk, R) * R), _pad_rows(v, _ceil(Tk, R) * R)
    rows_in = torch.arange(n_rows) < Tq
    l2 = torch.where(rows_in, _pad_rows(lse[..., None], n_rows)[..., 0] * LOG2E, 0.0)
    dl = torch.where(rows_in, _pad_rows(delta[..., None], n_rows)[..., 0] * scale, 0.0)
    dk, dv = torch.zeros(BH, Tk, D), torch.zeros(BH, Tk, D)
    for k0, per_wg in dkv_schedule(Tq, Tk, causal, t):
        keys = torch.arange(k0, k0 + R)
        sums_k, sums_v = [], []
        for tiles in per_wg:
            acc_k, acc_v = torch.zeros(BH, R, D), torch.zeros(BH, R, D)
            for i, _ in tiles:
                qs = slice(i * BQ, (i + 1) * BQ)
                st = mma3(kp[:, k0:k0 + R], qp[:, qs].transpose(1, 2), single)
                pt = torch.exp2(st * (scale * LOG2E) - l2[:, None, qs])
                cols = torch.arange(i * BQ, (i + 1) * BQ)
                pt = pt.masked_fill((cols[None, :] >= Tq) | (causal & (keys[:, None] > cols[None, :])), 0.0)
                dpt = mma3(vp[:, k0:k0 + R], dop[:, qs].transpose(1, 2), single)
                dst = pt * (dpt * scale - dl[:, None, qs])
                acc_v = acc_v + mma3(pt, dop[:, qs], single)
                acc_k = acc_k + mma3(dst, qp[:, qs], single)
            sums_k.append(acc_k)
            sums_v.append(acc_v)
        n = min(R, Tk - k0)
        dk[:, k0:k0 + n] = (sums_k[0] + sums_k[1])[:, :n]
        dv[:, k0:k0 + n] = (sums_v[0] + sums_v[1])[:, :n]
    return dk, dv


# ---------------------------------------------------------------------------
# Inputs and references
# ---------------------------------------------------------------------------

# (B, Tq, Tk, causal): causal over several tiles and a ragged end, causal on
# whole tiles, non-causal with Tk != Tq and both ends ragged.
SHAPES = [(2, 130, 130, True), (2, 64, 64, True), (2, 100, 170, False)]
# Head dim 256 (8-row stages: the model's longest loops) at one head and
# shorter sequences: causal over several stages, and non-causal with both
# ends ragged.
SHAPES_256 = [(1, 64, 64, True), (1, 37, 45, False)]
CASES = [(*shape, d) for d in HEAD_DIMS if d != 256 for shape in SHAPES] + [(*shape, 256) for shape in SHAPES_256]


def _id(case):
    B, Tq, Tk, causal, d = case
    return f"B{B}_Tq{Tq}_Tk{Tk}_{'causal' if causal else 'full'}_D{d}"


def _inputs(B, Tq, Tk, D, seed):
    """f32 q, k, v, dO [B*H, T, Dh] at gpt2-tiny's width (H = 64 / Dh, at
    least one head)."""
    rng = np.random.default_rng(seed)
    BH = B * max(1, D_MODEL // D)
    make = lambda T: torch.from_numpy(rng.standard_normal((BH, T, D), dtype=np.float32))  # noqa: E731
    return make(Tq), make(Tk), make(Tk), make(Tq)


def _lse_delta(q, k, v, do, causal):
    """The plain forward's lse and delta = rowsum(dO o)."""
    o, lse = tfa.flash_fwd_reference(q, k, v, causal)
    return lse, (do * o).sum(-1)


@pytest.fixture
def one_jax_tile(monkeypatch):
    """The JAX kernels in one tile per call (a ragged T would otherwise
    fall back to 8-row tiles, many interpret-mode steps)."""
    def set_tiles(Tq, Tk):
        monkeypatch.setenv("RT_FLASH_BQ", str(Tq))
        monkeypatch.setenv("RT_FLASH_BK", str(Tk))
    return set_tiles


def _relnorm(got, want):
    return bench.disagreement(got, torch.from_numpy(np.array(want)))["relnorm"]


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_split_model_matches_jax_and_plain(cpu_mesh_devices, one_jax_tile, case):
    """The 3xTF32 model of both kernels against the JAX package's f32
    flash backward and the port's plain versions, dq, dk and dv within
    1e-4 in relative norm."""
    B, Tq, Tk, causal, D = case
    q, k, v, do = _inputs(B, Tq, Tk, D, seed=D + Tq)
    lse, delta = _lse_delta(q, k, v, do, causal)
    got = (dq_model(q, k, v, do, lse, delta, causal), *dkv_model(q, k, v, do, lse, delta, causal))
    plain = tfa.flash_bwd_reference(q, k, v, do, lse, delta, causal)

    one_jax_tile(Tq, Tk)
    BH = q.shape[0]
    rows = lambda x: jnp.broadcast_to(jnp.asarray(x.numpy())[:, None], (BH, 8, Tq))  # noqa: E731
    jax_grads = jfa._bwd_kernels(*(jnp.asarray(x.numpy()) for x in (q, k, v, do)), rows(lse), rows(delta),
                                 causal, jnp.float32, jnp.float32, jnp.float32)
    for name, g, p, j in zip(("dq", "dk", "dv"), got, plain, jax_grads):
        assert _relnorm(g, p) <= GRAD_RELNORM, (name, "plain", _relnorm(g, p))
        assert _relnorm(g, j) <= GRAD_RELNORM, (name, "jax", _relnorm(g, j))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_forward_model_matches_jax_and_plain(cpu_mesh_devices, one_jax_tile, case):
    """The 3xTF32 model of the forward against the JAX package's f32
    flash forward (the Pallas kernel in interpret mode) and the port's
    plain version: o within 1e-5 in relative norm, lse within 1e-5
    absolute."""
    B, Tq, Tk, causal, D = case
    q, k, v, _ = _inputs(B, Tq, Tk, D, seed=D + Tq + 1)
    o, lse = fwd_model(q, k, v, causal)
    o_plain, lse_plain = tfa.flash_fwd_reference(q, k, v, causal)

    one_jax_tile(Tq, Tk)
    as_jax = lambda x: jnp.asarray(x.numpy())[:, :, None, :]  # noqa: E731  [BH, T, 1, Dh]
    o_jax, res = jfa._flash_fwd(as_jax(q), as_jax(k), as_jax(v), causal)
    o_jax, lse_jax = np.asarray(o_jax)[:, :, 0, :], np.asarray(res[-1])[:, 0, :]
    assert _relnorm(o, o_plain) <= FWD_RELNORM, ("plain", _relnorm(o, o_plain))
    assert _relnorm(o, o_jax) <= FWD_RELNORM, ("jax", _relnorm(o, o_jax))
    assert (lse - lse_plain).abs().max().item() <= LSE_TOL
    assert np.abs(lse.numpy() - lse_jax).max() <= LSE_TOL


# (head dim, kernel): the backward's cases keep their ids ("16" ...).
TF32_CASES = [pytest.param(d, "backward", id=str(d)) for d in HEAD_DIMS] + \
    [pytest.param(d, "forward", id=f"forward-{d}") for d in HEAD_DIMS]


@pytest.mark.parametrize("d, kernel", TF32_CASES)
def test_single_tf32_lands_ten_times_further(d, kernel):
    """The split is what keeps f32 accuracy: the same model with one TF32
    product (big.big) lands at least 10x further from the plain f32
    versions than 3xTF32 does, in dq, dk and dv (missing 1e-4), and in o
    (missing 1e-5)."""
    B, Tq, Tk, causal = SHAPES_256[0] if d == 256 else SHAPES[0]
    q, k, v, do = _inputs(B, Tq, Tk, d, seed=7)
    if kernel == "forward":
        limit, names = FWD_RELNORM, ("o",)
        plain = tfa.flash_fwd_reference(q, k, v, causal)[:1]
        three, one = fwd_model(q, k, v, causal)[:1], fwd_model(q, k, v, causal, single=True)[:1]
    else:
        limit, names = GRAD_RELNORM, ("dq", "dk", "dv")
        lse, delta = _lse_delta(q, k, v, do, causal)
        plain = tfa.flash_bwd_reference(q, k, v, do, lse, delta, causal)
        three = (dq_model(q, k, v, do, lse, delta, causal), *dkv_model(q, k, v, do, lse, delta, causal))
        one = (dq_model(q, k, v, do, lse, delta, causal, single=True),
               *dkv_model(q, k, v, do, lse, delta, causal, single=True))
    for name, p, g3, g1 in zip(names, plain, three, one):
        e3, e1 = _relnorm(g3, p), _relnorm(g1, p)
        assert e1 >= 10 * e3 and e1 > limit, (name, e3, e1)


def test_tf32_rounding_and_split():
    """tf32_rna rounds to 10 mantissa bits, to nearest, ties away from
    zero; big + (x - big) is x exactly, and the small part is at most half
    a tf32 ulp of x."""
    one = torch.tensor(1.0)
    half_ulp = 2.0 ** -11  # a tf32 ulp at 1.0 is 2^-10
    cases = {1 + half_ulp: 1 + 2 * half_ulp, 1 + half_ulp - 2 ** -23: 1.0, -(1 + half_ulp): -(1 + 2 * half_ulp),
             1 + 3 * half_ulp: 1 + 4 * half_ulp, 0.0: 0.0, -2.5: -2.5}
    for x, want in cases.items():
        assert tf32_rna(torch.tensor(x)).item() == want, x
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4096, dtype=np.float32)) * 10.0
    big, small = split(x)
    assert torch.all(big.view(torch.int32) & 0x1FFF == 0) and torch.all(small.view(torch.int32) & 0x1FFF == 0)
    assert torch.equal(big + (x - big), x)
    assert torch.all((x - big).abs() <= x.abs() * half_ulp)
    assert torch.all((big.double() + small.double() - x.double()).abs() <= x.abs().double() * 2.0 ** -21)
    assert tf32_rna(one).item() == 1.0


def _check_fwd_schedule(shape, t):
    """The forward's: every kept (q, key) pair computed exactly once, by the
    warpgroup that owns its row; the masked tiles are those holding a pair
    the mask drops among the warpgroup's rows; every warpgroup waits for and
    releases each tile its block loads that the release count expects of
    it (all of them at 128 rows; its own parity at 64), in order."""
    Tq, Tk, causal = shape
    R, ROWS, BK = t["ROWS_OWNED"], t["FWD_ROWS"], t["FWD_BK"]
    seen = torch.zeros(Tq, Tk, dtype=torch.int32)
    blocks = fwd_schedule(Tq, Tk, causal, t)
    assert len(blocks) == _ceil(Tq, ROWS)
    for q0, per_wg in blocks:
        n_k = _ceil(min(Tk, q0 + ROWS) if causal else Tk, BK)
        for c, (r0, tiles, released) in enumerate(per_wg):
            visited = [i for i, _ in tiles] + released
            assert visited == (list(range(n_k)) if ROWS == 2 * R else list(range(c, n_k, 2))), (q0, c)
            for i, masked in tiles:
                r = torch.arange(r0, r0 + R)[:, None]
                col = torch.arange(i * BK, (i + 1) * BK)[None, :]
                assert masked == bool(((col >= Tk) | (causal & (col > r))).any()), (q0, c, i)
                kept = (r < Tq) & (col < Tk) & ~(causal & (col > r))
                rr, cc = torch.broadcast_tensors(r, col)
                seen.index_put_((rr[kept], cc[kept]), torch.ones(int(kept.sum()), dtype=torch.int32),
                                accumulate=True)
    want = torch.ones(Tq, Tk, dtype=torch.int32)
    assert torch.equal(seen, want.tril() if causal else want)


def _check_schedule(kernel, shape, t):
    """Over all blocks, both warpgroups and their tiles, every (q, key) pair
    the mask keeps is computed exactly once, the masked tiles are the ones
    that hold a pair the mask drops, and the two warpgroups' tile counts of
    a block differ by at most one."""
    if kernel == "fwd":
        return _check_fwd_schedule(shape, t)
    Tq, Tk, causal = shape
    seen = torch.zeros(Tq, Tk, dtype=torch.int32)
    R = t["ROWS_OWNED"]
    blocks = (dq_schedule if kernel == "dq" else dkv_schedule)(Tq, Tk, causal, t)
    assert len(blocks) == _ceil(Tq if kernel == "dq" else Tk, R)
    for first, per_wg in blocks:
        assert len(per_wg) == 2 and abs(len(per_wg[0]) - len(per_wg[1])) <= 1
        for tiles in per_wg:
            for i, masked in tiles:
                if kernel == "dq":
                    rows, cols = torch.arange(first, first + R), torch.arange(i * t["DQ_BK"], (i + 1) * t["DQ_BK"])
                else:
                    rows = torch.arange(i * t["DKV_BQ"], (i + 1) * t["DKV_BQ"])
                    cols = torch.arange(first, first + R)
                r, c = rows[:, None], cols[None, :]
                # masked: keys past Tk (dQ), q rows past Tq (dK/dV), the causal
                # upper triangle; rows or keys past T are computed and never stored
                dropped = ((c >= Tk) if kernel == "dq" else (r >= Tq)) | (causal & (c > r))
                assert masked == bool(dropped.any()), (first, i)
                kept = (r < Tq) & (c < Tk) & ~(causal & (c > r))
                rr, cc = torch.broadcast_tensors(r, c)
                seen.index_put_((rr[kept], cc[kept]), torch.ones(int(kept.sum()), dtype=torch.int32),
                                accumulate=True)
    want = torch.ones(Tq, Tk, dtype=torch.int32)
    assert torch.equal(seen, want.tril() if causal else want)


SCHEDULE_SHAPES = [(1, 1, True), (65, 65, True), (256, 256, True), (1000, 1000, True),
                   (100, 37, False), (300, 1100, False)]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("kernel", ["dq", "dkv", "fwd"])
@pytest.mark.parametrize("shape", SCHEDULE_SHAPES, ids=lambda s: f"Tq{s[0]}_Tk{s[1]}_{'causal' if s[2] else 'full'}")
def test_schedule_covers_each_kept_pair_once(kernel, shape, d):
    _check_schedule(kernel, shape, TILES[d])


@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_fragment_permutation_matches_the_transposed_tile(n):
    """An m64nN accumulator's registers, taken as tf32 A fragments the way
    split_a_frags takes them, times a transposed tile written with the
    split pass's permutation (column 8g + p holds row 8g + 2p, or
    8g + 2(p - 4) + 1 for p >= 4), is the plain product C B."""
    rng = np.random.default_rng(n)
    C = torch.from_numpy(rng.standard_normal((64, n), dtype=np.float32)).double()
    B = torch.from_numpy(rng.standard_normal((n, 24), dtype=np.float32)).double()
    row_of = lambda p: 2 * p if p < 4 else 2 * (p - 4) + 1  # noqa: E731
    bt = torch.zeros(24, n, dtype=torch.float64)  # the transposed tile, [N rows, K positions]
    for g in range(n // 8):
        for p in range(8):
            bt[:, 8 * g + p] = B[8 * g + row_of(p)]
    a = torch.zeros(64, n, dtype=torch.float64)  # the A fragments by (row, k position)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            r = 16 * w + g
            for j in range(n // 8):
                d = {4 * j + 0: C[r, 8 * j + 2 * t], 4 * j + 1: C[r, 8 * j + 2 * t + 1],
                     4 * j + 2: C[r + 8, 8 * j + 2 * t], 4 * j + 3: C[r + 8, 8 * j + 2 * t + 1]}
                # a0..a3 = d[4j], d[4j + 2], d[4j + 1], d[4j + 3] at (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
                a[r, 8 * j + t], a[r + 8, 8 * j + t] = d[4 * j], d[4 * j + 2]
                a[r, 8 * j + t + 4], a[r + 8, 8 * j + t + 4] = d[4 * j + 1], d[4 * j + 3]
    assert torch.allclose(a @ bt.T, C @ B, rtol=0, atol=1e-12)


def tilef_offset(cols: int, rows: int, row: int, col: int) -> int:
    """hopper::TileF<cols, rows>::offset: sub-tiles of min(cols, 32) floats
    a row, swizzled by the row's bytes."""
    w = min(cols, 32)
    row_bytes = w * 4
    off = row * row_bytes + (col % w) * 4
    mask = row_bytes // 16 - 1
    return (col // w) * rows * row_bytes + (off ^ (((off >> 7) & mask) << 4))


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_split_pass_hits_distinct_banks(d):
    """split_tile_t's accesses at every tile the kernels split: a warp's
    32 scalar reads (and natural stores) of one step fall in 32 distinct
    banks, and each 8 lanes' 16-byte stores into the transposed tile fall
    in 8 distinct 16-byte bank groups."""
    t = TILES[d]
    for rows in (t["DQ_BK"], t["DKV_BQ"]):  # dQ's K tiles, dK/dV's Q and dO tiles
        items = rows // 4 * d
        for warp0 in range(0, items, 32):
            lanes = range(warp0, min(warp0 + 32, items))
            for i in range(4):
                banks = set()
                for e in lanes:
                    c, h, g = e % d, (e // d) % 2, e // (2 * d)
                    banks.add(tilef_offset(d, rows, 8 * g + h + 2 * i, c) // 4 % 32)
                assert len(banks) == len(lanes), (d, rows, warp0, i)
            for e0 in range(warp0, min(warp0 + 32, items), 8):
                slots = set()
                for e in range(e0, min(e0 + 8, items)):
                    c, h, g = e % d, (e // d) % 2, e // (2 * d)
                    off = tilef_offset(rows, d, c, 8 * g + 4 * h)
                    assert off % 16 == 0
                    slots.add(off // 16 % 8)
                assert len(slots) == min(8, items - e0), (d, rows, e0)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_forward_split_pass_hits_distinct_banks(d):
    """The forward's transpose-only split of V (split_tile_t without the
    natural copy) at its stage's FWD_BK keys: a warp's 32 scalar reads of
    one step fall in 32 distinct banks, and each 8 lanes' 16-byte stores
    into V^T in 8 distinct 16-byte bank groups."""
    rows = TILES[d]["FWD_BK"]
    items = rows // 4 * d
    for warp0 in range(0, items, 32):
        lanes = range(warp0, min(warp0 + 32, items))
        for i in range(4):
            banks = {tilef_offset(d, rows, 8 * (e // (2 * d)) + (e // d) % 2 + 2 * i, e % d) // 4 % 32
                     for e in lanes}
            assert len(banks) == len(lanes), (d, rows, warp0, i)
        for e0 in range(warp0, min(warp0 + 32, items), 8):
            slots = set()
            for e in range(e0, min(e0 + 8, items)):
                off = tilef_offset(rows, d, e % d, 8 * (e // (2 * d)) + 4 * ((e // d) % 2))
                assert off % 16 == 0
                slots.add(off // 16 % 8)
            assert len(slots) == min(8, items - e0), (d, rows, e0)


def test_tile_block_is_read_from_the_cu():
    """Every head dim has its traits, the forward's among them; each stage
    size is a wgmma N the kernels issue (the score products' N), the rings
    are at least two deep, a 64-row block takes whole 8-row k-steps, and a
    forward block is one or two warpgroups' 64 rows; each plan asserts its
    shared memory."""
    assert set(TILES) == set(HEAD_DIMS)
    source = CU.read_text()
    for d, t in TILES.items():
        assert set(t) == {"DQ_BK", "DQ_STAGES", "DQ_RAW", "DKV_BQ", "DKV_STAGES", "DKV_RAW", "LOADER_WGS",
                          "FWD_ROWS", "FWD_BK", "FWD_STAGES", "FWD_RAW", "FWD_LOADER_WGS", "A_SPLIT", "DKV_PASSES",
                          "ROWS_OWNED"}
        assert t["A_SPLIT"] in (0, 1) and t["DKV_PASSES"] in (1, 2)
        if not t["A_SPLIT"]:  # raw rows, split a sub-tile of k-steps at a time (mma3_raw)
            assert d % 32 == 0
        assert t["DQ_RAW"] in (0, 2, 3, 4) and t["DKV_RAW"] in (0, 2, 3, 4) and t["FWD_RAW"] in (0, 2, 3, 4)
        assert t["LOADER_WGS"] in (1, 2, 3) and t["FWD_LOADER_WGS"] in (1, 2, 3)
        assert t["ROWS_OWNED"] == 64 and t["FWD_ROWS"] in (64, 128)
        assert t["DQ_BK"] in (8, 16, 32, 64) and t["DKV_BQ"] in (8, 16, 32, 64) and t["FWD_BK"] in (8, 16, 32, 64)
        assert min(t["DQ_STAGES"], t["DKV_STAGES"], t["FWD_STAGES"]) >= 2
        for n in (t["DQ_BK"], t["DKV_BQ"], t["FWD_BK"], d):
            assert f"m64n{n}k8.f32.tf32.tf32" in (CU.parent / "hopper.cuh").read_text()
    for kernel in ("dQ's", "dK/dV's", "the forward's"):
        assert f"static_assert(BYTES <= SMEM_LIMIT, \"{kernel} shared memory does not fit\");" in source
    assert "struct FwdPlan {" in source and "F32Tiles<D>::FWD_BK" in source
    assert f"constexpr int SMEM_LIMIT = {SMEM_LIMIT};" in source


def test_sweep_variants_apply_to_the_source():
    """Every variant of ``python3 -m ray_tpu_torch.sweep_flash_f32`` still
    applies to the current sources (an edit that no longer matches would
    be skipped on the card), changes them, and the traits it edits are the
    .cu's."""
    from ray_tpu_torch import sweep_flash_f32 as sweep

    chosen = sweep.sources("chosen")
    for name in sweep.VARIANTS:
        assert (sweep.sources(name) == chosen) == (name == "chosen"), name
    for d, text in sweep.TRAITS.items():
        traits = {name: int(v) for name, v in re.findall(r"(\w+) = (\d+)", text)}
        assert traits == {k: v for k, v in TILES[d].items() if k != "ROWS_OWNED"}, d

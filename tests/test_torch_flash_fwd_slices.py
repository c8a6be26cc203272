"""The forward above head dim 256 on clusters of column slices, modelled in plain PyTorch on the CPU.

Above the widest instance (256), the port's flash forward runs on a
cluster of W = ceil(Dh / SLICE) blocks per (head, q-row block), in every
library: ``flash_fwd_slices_kernel`` (``csrc/flash_attention.cu``, bf16 and
f16 operands) and ``flash_f32_fwd_slices_kernel``
(``csrc/flash_attention_f32.cu``, f32 operands and mixes). Block w owns the
columns [w SLICE, (w + 1) SLICE); per key stage each block contracts its
partial scores over its own slice, the W partials are summed in rank
order (so every block holds bitwise the same S), every block runs the same
online softmax in exp2 units, rounds P to v's dtype and adds P V on its own
slice. This file writes that arithmetic out in PyTorch at the traits the
sources state (``FwdSliceTiles``, read from each ``.cu``): the 16-bit
partials as f32 products of 16-bit values, the f32 ones in 3xTF32 with
SCORE_STEPS k-steps a partial (``tests/test_torch_flash_f32_split.py``'s
model of the tensor cores), the key stages of BK keys, 64 rows a consumer
warpgroup, the 64-row blocks' merge of (m, l, O). The model is held to the
JAX package's forward (the Pallas ``_fwd_kernel`` in interpret mode, one
tile per call) at head dims 264, 320, 384, 520, 768 and 1024, in bf16,
f16, f32 and a mix (bf16 q and v, f32 k), causal, ragged causal and
non-causal with Tk != Tq, and with f32 outputs from 16-bit operands (the
ring's block entry). Then the traits: the shared-memory plans, the
cluster sizes, the wrapper's clusters and the schedules' coverage. Inputs
come from seeded numpy generators.

Tolerances (phase 2 of chip_smoke.py): an f32 output with no 16-bit
rounding of P on its path within 1e-5 in relative norm and lse within
1e-5 absolute (the JAX package's limits for its f32 kernels); any other
output by the kernels' rule on the card (bench.disagreement: both sides
round P to 16 bits, but sum in other orders) and lse within 1e-4.
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
from test_torch_flash_f32_split import cluster_sum, mma3, slice_partial

CSRC = Path(tfa.__file__).resolve().parent / "csrc"
SOURCES = {16: CSRC / "flash_attention.cu", 32: CSRC / "flash_attention_f32.cu"}
SMEM_LIMIT = 232448  # dynamic shared memory a block may have on an H100
PORTABLE_CLUSTER = 8  # blocks a cluster may have without the non-portable opt-in
LOG2E = 1.4426950408889634
FWD_RELNORM, F32_LSE_TOL, LSE_TOL = 1e-5, 1e-5, 1e-4
ROWS_OWNED = 64  # a consumer warpgroup's rows


def cu_fwd_slice_tiles(source: str) -> dict:
    """``FwdSliceTiles`` of a source, {NAME: int}."""
    body = re.search(r"^struct FwdSliceTiles \{(.*?)^\};", source, re.M | re.S)[1]
    return {name: int(v) for name, v in re.findall(r"(\w+) = (\d+)", body)}


TRAITS = {bits: cu_fwd_slice_tiles(path.read_text()) for bits, path in SOURCES.items()}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models' products are small and many: one intra-op thread keeps
    them from contending for the cores with the other workers of a
    parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ceil(a, b):
    return -(-a // b)


def _pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero rows past T and columns past Dh, as TMA fills them."""
    return torch.nn.functional.pad(x, (0, cols - x.shape[-1], 0, rows - x.shape[-2]))


def _bits(dtypes) -> int:
    """The library the operands reach: 16 (all bf16 or all f16) or 32 (f32, or a mix)."""
    return 16 if len(set(dtypes)) == 1 and dtypes[0] in (torch.bfloat16, torch.float16) else 32


# ---------------------------------------------------------------------------
# The schedule and the model
# ---------------------------------------------------------------------------


def fwd_slices_schedule(Tq, Tk, causal, t):
    """Per block of ROWS q rows from q0: per consumer warpgroup c, (its first
    row, the key tiles of BK keys it exchanges and computes in order, each
    with whether it is masked). 16-bit blocks (ROWS q rows): c owns rows
    q0 + 64c and walks every tile to its rows' diagonal (none for rows all
    past Tq); f32 blocks (64 rows): both own the rows, c takes tiles c, c +
    2, ..."""
    ROWS, BK = t.get("ROWS", ROWS_OWNED), t["BK"]
    shared = t["bits"] == 16
    blocks = []
    for qt in range(_ceil(Tq, ROWS)):
        q0 = qt * ROWS
        n_k = _ceil(min(Tk, q0 + ROWS) if causal else Tk, BK)
        per_wg = []
        for c in range(ROWS // ROWS_OWNED if shared else 2):
            r0 = q0 + ROWS_OWNED * c if shared else q0
            if not shared:
                n_mine = n_k
            else:
                n_mine = _ceil(min(Tk, r0 + ROWS_OWNED) if causal else Tk, BK) if r0 < Tq else 0
            n_plain = min(min(Tk // BK, (r0 + 1) // BK) if causal else Tk // BK, n_mine)
            step, first = (1, 0) if shared else (2, c)
            per_wg.append((r0, [(i, i >= n_plain) for i in range(first, n_mine, step)]))
        blocks.append((q0, per_wg))
    return blocks


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """P rounded to v's dtype before P V (f32: unchanged)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def fwd_slices_model(q, k, v, causal, out_f32=False):
    """(o, lse) by the cluster forward: per consumer warpgroup and key tile,
    each block's partial S over its slice (16-bit: f32 products of the
    operands; f32 and mixes: 3xTF32, SCORE_STEPS k-steps a partial), the W
    partials summed in rank order, s = S (scale log2 e) masked to -inf, the
    running max m and base (0 while a row has seen no key), P = exp2(s -
    base) rounded to v's dtype, l = l alpha + rowsum(P), O = O alpha + P V
    (3xTF32 for the f32 kernels); the 64-row f32 blocks' two (m, l, O)
    merged, warpgroup 0's first; o = O / l, in q's dtype unless ``out_f32``
    (the mixed route's f32 result cast back), lse = (m + log2 l) / log2 e.
    Operands [BH, T, Dh], of their own dtypes."""
    dtypes = (q.dtype, k.dtype, v.dtype)
    bits = _bits(dtypes)
    t = dict(TRAITS[bits], bits=bits)
    BH, Tq, D = q.shape
    Tk = k.shape[1]
    S, BK, ROWS = t["SLICE"], t["BK"], t.get("ROWS", ROWS_OWNED)
    W = _ceil(D, S)
    cols = [(w * S, (w + 1) * S) for w in range(W)]
    scale = 1.0 / math.sqrt(D)
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    qp = _pad(q.float(), _ceil(Tq, ROWS) * ROWS, W * S)
    kp, vp = (_pad(x.float(), _ceil(Tk, BK) * BK, W * S) for x in (k, v))
    o, lse = torch.zeros(BH, Tq, D), torch.zeros(BH, Tq)

    def partial(a, b):  # one block's scores over its slice, a [.., R, S] . b [.., BK, S]^T
        return slice_partial(a, b.transpose(1, 2), t) if bits == 32 else a @ b.transpose(1, 2)

    def values(p, vt):
        return mma3(p, vt) if bits == 32 else p @ vt

    def base_of(m):
        return torch.where(m == -math.inf, torch.zeros(()), m)

    for q0, per_wg in fwd_slices_schedule(Tq, Tk, causal, t):
        parts = []
        for r0, tiles in per_wg:
            rows = torch.arange(r0, r0 + ROWS_OWNED)
            m = torch.full((BH, ROWS_OWNED), -math.inf)
            l = torch.zeros(BH, ROWS_OWNED)
            acc = torch.zeros(BH, ROWS_OWNED, W * S)
            for i, _ in tiles:
                ks = slice(i * BK, (i + 1) * BK)
                s = cluster_sum([partial(qp[:, r0:r0 + ROWS_OWNED, a:b], kp[:, ks, a:b]) for a, b in cols]) * sl2
                keys = torch.arange(i * BK, (i + 1) * BK)
                s = s.masked_fill((keys[None, :] >= Tk) | (causal & (keys[None, :] > rows[:, None])), -math.inf)
                m_new = torch.maximum(m, s.amax(-1))
                base = base_of(m_new)
                alpha = torch.exp2(m - base)
                p = torch.exp2(s - base[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + values(_rounded(p, v.dtype), vp[:, ks])
                m = m_new
            parts.append((r0, m, l, acc))
        if len(parts) == 2 and parts[0][0] == parts[1][0]:  # 64-row f32 blocks: the two warpgroups' rows meet
            (r0, m0, l0, a0), (_, m1, l1, a1) = parts
            m = torch.maximum(m0, m1)
            base = base_of(m)
            w0, w1 = torch.exp2(m0 - base), torch.exp2(m1 - base)
            parts = [(r0, m, l0 * w0 + l1 * w1, a0 * w0[..., None] + a1 * w1[..., None])]
        for r0, m, l, acc in parts:
            n = min(ROWS_OWNED, Tq - r0)
            if n <= 0:
                continue
            o[:, r0:r0 + n] = (acc[..., :D] / l[..., None])[:, :n]
            lse[:, r0:r0 + n] = ((m + torch.log2(l)) / torch.tensor(LOG2E, dtype=torch.float32))[:, :n]
    return (o if out_f32 else o.to(q.dtype)), lse


# ---------------------------------------------------------------------------
# The model against the JAX package's forward
# ---------------------------------------------------------------------------

HEAD_DIMS = (264, 320, 384, 520, 768, 1024)
DTYPE_SETS = {"bf16": ("bfloat16",) * 3, "f16": ("float16",) * 3, "f32": ("float32",) * 3,
              "bf16_f32_bf16": ("bfloat16", "float32", "bfloat16")}
# (B, Tq, Tk, H, causal): causal over two 64-row warpgroups and several
# key stages, ragged causal (the last stage and the second warpgroup's
# rows cut short), non-causal with Tk != Tq (both ends ragged).
SHAPES = {"causal": (1, 128, 128, 1, True), "ragged": (1, 100, 100, 1, True), "full": (1, 40, 72, 2, False)}
CASES = [(d, dt, sh) for d in HEAD_DIMS for dt in DTYPE_SETS for sh in SHAPES]
# f32 outputs from 16-bit operands (flash_fwd_block, the ring's entry)
BLOCK_CASES = [(384, "bf16", "full"), (1024, "bf16", "causal"), (520, "f16", "ragged"), (768, "f16", "full")]


def _draw(seed, B, Tq, Tk, H, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in ((B, Tq, H, D), (B, Tk, H, D), (B, Tk, H, D))]


def _held(got: torch.Tensor, want: np.ndarray, through, what) -> None:
    """An f32 output with no 16-bit rounding of P on its path (``through``:
    v's dtype) within FWD_RELNORM in relative norm; any other by the rule."""
    gap = bench.disagreement(got, torch.from_numpy(np.array(want, dtype=np.float32)))
    if got.dtype == torch.float32 and through == torch.float32:
        assert gap["relnorm"] <= FWD_RELNORM, (what, gap)
    else:
        assert gap["ok"], (what, gap)


def _jax_tiles(monkeypatch, Tq, Tk):
    """The JAX kernel in one tile per call."""
    monkeypatch.setenv("RT_FLASH_BQ", str(Tq))
    monkeypatch.setenv("RT_FLASH_BK", str(Tk))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"D{c[0]}_{c[1]}_{c[2]}")
def test_cluster_forward_model_matches_jax(cpu_mesh_devices, monkeypatch, case):
    """The model of the cluster forward against the JAX package's forward
    (the Pallas _fwd_kernel in interpret mode) and the port's plain
    version: o in q's dtype and lse."""
    D, dtypes, shape = case
    B, Tq, Tk, H, causal = SHAPES[shape]
    names = DTYPE_SETS[dtypes]
    draws = _draw(D + Tk + 7 * len(dtypes), B, Tq, Tk, H, D)
    _jax_tiles(monkeypatch, Tq, Tk)
    jx = [jnp.asarray(x).astype(n) for x, n in zip(draws, names)]
    o_j, res = jfa._flash_fwd(*jx, causal)
    lse_j = np.asarray(res[-1])[:, 0, :]
    tx = [tfa._fold(torch.from_numpy(x).to(getattr(torch, n))) for x, n in zip(draws, names)]
    o_m, lse_m = fwd_slices_model(*tx, causal)
    o_p, lse_p = tfa.flash_fwd_reference(*tx, causal)
    assert o_m.dtype == o_p.dtype == getattr(torch, names[0]) and o_m.shape == (B * H, Tq, D)
    through = tx[2].dtype
    o_jf = np.asarray(tfa._fold(torch.from_numpy(np.array(o_j.astype(jnp.float32)))))
    _held(o_m, o_jf, through, ("jax", case))
    _held(o_m, o_p.float().numpy(), through, ("plain", case))
    lse_tol = F32_LSE_TOL if _bits(tuple(x.dtype for x in tx)) == 32 else LSE_TOL
    assert np.abs(lse_m.numpy() - lse_j).max() <= lse_tol, case
    assert (lse_m - lse_p).abs().max().item() <= lse_tol, case


@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: f"D{c[0]}_{c[1]}_{c[2]}")
def test_cluster_forward_f32_outputs_match_jax_block(cpu_mesh_devices, monkeypatch, case):
    """f32 outputs from 16-bit operands (the 16-bit kernel's f32 instance,
    which the ring's flash_fwd_block takes) against the JAX package's
    flash_fwd_block."""
    D, dtypes, shape = case
    B, Tq, Tk, H, causal = SHAPES[shape]
    names = DTYPE_SETS[dtypes]
    draws = _draw(3 * D + Tq, B, Tq, Tk, H, D)
    _jax_tiles(monkeypatch, Tq, Tk)
    o_j, lse_j = jfa.flash_fwd_block(*(jnp.asarray(x).astype(n) for x, n in zip(draws, names)), causal=causal)
    assert str(o_j.dtype) == "float32"
    tx = [tfa._fold(torch.from_numpy(x).to(getattr(torch, n))) for x, n in zip(draws, names)]
    o_m, lse_m = fwd_slices_model(*tx, causal, out_f32=True)
    assert o_m.dtype == torch.float32
    o_jf = np.asarray(tfa._fold(torch.from_numpy(np.array(o_j))))
    _held(o_m, o_jf, tx[2].dtype, case)
    assert np.abs(lse_m.numpy() - np.asarray(lse_j)[:, 0, :]).max() <= LSE_TOL


def test_cluster_sum_is_the_rank_order_chain():
    """The partial scores of a head dim whose last slice is mostly past Dh
    (520: five slices of 128, the last holding 8 columns) add to the whole
    head dim's product within f32 rounding, the last partial over the zero
    columns TMA fills is that of the 8 real ones, and the sum is the chain
    ((p0 + p1) + p2) + ..., the same on every block."""
    rng = np.random.default_rng(520)
    a = torch.from_numpy(rng.standard_normal((2, 64, 520), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 16, 520), dtype=np.float32))
    S = TRAITS[32]["SLICE"]
    ap, bp = _pad(a, 64, 5 * S), _pad(b, 16, 5 * S)
    parts = [slice_partial(ap[..., x:x + S], bp[..., x:x + S].transpose(1, 2), TRAITS[32]) for x in range(0, 5 * S, S)]
    assert torch.equal(parts[-1], slice_partial(_pad(a[..., 512:], 64, S), _pad(b[..., 512:], 16, S).transpose(1, 2),
                                                TRAITS[32]))
    chain = parts[0]
    for p in parts[1:]:
        chain = chain + p
    assert torch.equal(cluster_sum(parts), chain)
    whole = (a.double() @ b.double().transpose(1, 2)).float()
    assert (chain - whole).abs().max().item() <= 1e-4 * whole.abs().max().item()


# ---------------------------------------------------------------------------
# The traits, the plans and the routes
# ---------------------------------------------------------------------------


def test_traits_are_read_from_the_sources():
    """Each source states its FwdSliceTiles: a slice a wgmma N of the value
    product (128, or 256 for 16-bit operands), clusters within the portable
    limit, key stages whose score product is a wgmma N, rings of at least
    two stages, reads of 1-8 blocks at once; 16-bit blocks of 64 or 128 q
    rows (f32 blocks are 64), the f32 partials' k-steps a whole number of
    groups of the slice; the wrapper's clusters are the sources'."""
    hopper = (CSRC / "hopper.cuh").read_text()
    for bits, t in TRAITS.items():
        assert t["SLICE"] in ((128, 256) if bits == 16 else (128,)), bits
        assert 2 <= t["MAX_SLICES"] <= PORTABLE_CLUSTER and t["STAGES"] >= 2
        assert 1 <= t["READ_BLOCKS"] <= PORTABLE_CLUSTER
        assert tfa.CLUSTERS[("flash_fwd", bits)] == (t["SLICE"], t["MAX_SLICES"])
        if bits == 32:
            assert set(t) == {"SLICE", "MAX_SLICES", "BK", "STAGES", "LOADER_WGS", "READ_BLOCKS", "SCORE_STEPS"}
            assert t["BK"] in (8, 16, 32) and f"m64n{t['BK']}k8.f32.tf32.tf32" in hopper
            assert t["SLICE"] % (8 * t["SCORE_STEPS"]) == 0 and t["LOADER_WGS"] in (1, 2, 3)
        else:
            assert set(t) == {"SLICE", "MAX_SLICES", "ROWS", "BK", "STAGES", "READ_BLOCKS"}
            assert t["ROWS"] in (64, 128) and t["BK"] in (32, 64, 128) and f"struct Wgmma<{t['BK']}, E>" in hopper
            assert f"struct Wgmma<{t['SLICE']}, E>" in hopper
        source = SOURCES[bits].read_text()
        assert "static_assert(BYTES <= SMEM_LIMIT, \"the forward's slices' shared memory does not fit\");" in source
        assert "hopper::slice_blocks<FwdSliceTiles>(d)" in source


def test_shared_memory_plans_fit():
    """Each forward cluster's shared-memory plan (SliceFwdSmem of the
    16-bit source, SliceFwdPlan of the f32 one) is held to an H100 block by
    its own source: a static_assert against SMEM_LIMIT, 232,448 bytes in
    each source; the build hands the plan's bytes to phase 1 of
    chip_smoke.py (rt_fwd_slices_smem_bytes). The exchange lives in a tile
    no product reads once the partials are written (the f32 kernel's V as
    loaded, a [64 x BK] partial; the 16-bit kernel's K, a partial per
    consumer warpgroup); the smoke's window case lies just past the 16-bit
    clusters."""
    import chip_smoke

    for bits, plan in ((16, "SliceFwdSmem"), (32, "SliceFwdPlan")):
        source = SOURCES[bits].read_text()
        assert f"constexpr int SMEM_LIMIT = {SMEM_LIMIT};" in source
        body = re.search(rf"^struct {plan} {{(.*?)^}};", source, re.M | re.S)[1]
        assert "static_assert(BYTES <= SMEM_LIMIT," in body, plan
        assert f'extern "C" int rt_fwd_slices_smem_bytes() {{ return {plan}::BYTES; }}' in source
    t32, t16 = TRAITS[32], TRAITS[16]
    assert ROWS_OWNED * t32["BK"] * 4 <= t32["BK"] * t32["SLICE"] * 4
    assert t16["ROWS"] * t16["BK"] * 4 <= t16["BK"] * t16["SLICE"] * 2
    assert chip_smoke.WIDE_FWD16_WINDOW_DIM == t16["SLICE"] * t16["MAX_SLICES"] + 8


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("d", [257, 260, 264, 320, 384, 512, 520, 768, 1020, 1024, 1028, 1032, 1280, 2056])
def test_slices_tile_the_head_dim(bits, d):
    """At every head dim above 256 up to SLICE x MAX_SLICES the forward's
    cluster has ceil(Dh / SLICE) blocks whose slices cover each column once,
    no block wholly past Dh, within the portable limit; the wrapper counts
    that many (fa.windows) and labels them; above, the column windows."""
    t = TRAITS[bits]
    S, M = t["SLICE"], t["MAX_SLICES"]
    dtypes = (torch.bfloat16, torch.float16) if bits == 16 else (torch.float32, "mixed")
    for dtype in dtypes:
        width = d if dtype == "mixed" else tfa.kernel_head_dim(d, dtype)
        sliced = width <= S * M
        assert tfa.sliced("flash_fwd", d, dtype) == sliced, (d, dtype)
        name = str(dtype).removeprefix("torch.")
        if not sliced:
            n = -(-d // tfa.WIDE_WINDOWS["flash_fwd"])
            assert tfa.windows("flash_fwd", d, dtype) == n
            assert tfa.instance("flash_fwd", d, dtype) == f"flash_fwd d{d} on d{tfa.WIDE_WINDOWS['flash_fwd']}x{n} {name}"
            continue
        W = -(-d // S)
        assert tfa.windows("flash_fwd", d, dtype) == W <= PORTABLE_CLUSTER and (W - 1) * S < d
        assert tfa.instance("flash_fwd", d, dtype) == f"flash_fwd d{d} on d{S}x{W} cluster {name}"
        seen = torch.zeros(W * S, dtype=torch.int32)
        for w in range(W):
            seen[w * S:(w + 1) * S] += 1
        assert torch.equal(seen[:d], torch.ones(d, dtype=torch.int32))


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("shape", [(300, 300, True), (128, 128, True), (40, 72, False), (1000, 1000, True),
                                   (130, 1100, False), (300, 1100, False)], ids=str)
def test_schedule_covers_every_kept_pair_once(bits, shape):
    """The cluster forward's schedule (fwd_slices_schedule at the source's
    traits) computes each kept (q, key) pair exactly once for every q row
    before Tq, masks every tile that crosses the diagonal or the ragged
    end, and each warpgroup's exchanged tiles are a prefix of its walk, as
    the slots' round parities need; a 16-bit block's warpgroups meet at a
    named barrier on every tile both compute, the first min(n_own) tiles
    (the kernel's n_both): a warpgroup whose rows all lie past Tq (Tq 300:
    the last block's second) computes none."""
    Tq, Tk, causal = shape
    t = dict(TRAITS[bits], bits=bits)
    BK = t["BK"]
    hits = torch.zeros(Tq, Tk, dtype=torch.int32)
    for q0, per_wg in fwd_slices_schedule(Tq, Tk, causal, t):
        if bits == 16:  # the tiles each warpgroup computes, and those both do
            walks = [{i for i, _ in tiles} for _, tiles in per_wg]
            n_both = min(len(w) for w in walks)
            assert all(set(range(n_both)) <= w for w in walks) and set.intersection(*walks) == set(range(n_both))
        for r0, tiles in per_wg:
            idx = [i for i, _ in tiles]
            if bits == 16:
                assert idx == list(range(len(idx)))
            for i, masked in tiles:
                keys = range(i * BK, min((i + 1) * BK, Tk))
                crosses = (i + 1) * BK > Tk or (causal and (i + 1) * BK - 1 > r0)
                assert masked or not crosses, (r0, i)
                for r in range(r0, min(r0 + ROWS_OWNED, Tq)):
                    for key in keys:
                        if not causal or key <= r:
                            hits[r, key] += 1
    kept = torch.ones(Tq, Tk, dtype=torch.int32)
    if causal:
        kept = kept.tril()
    assert torch.equal(hits, kept)


def test_fwd_sweep_variants_apply_to_the_sources():
    """Every "fwd32" and "fwd16" variant of ``python3 -m
    ray_tpu_torch.sweep_flash_f32`` still applies to the current sources
    (an edit that no longer matches would be refused on the card), and
    changes them: those of FwdSliceTiles exactly the traits they name, in
    their own source; the sweep's FwdSliceTiles texts are the sources';
    each shape it times reaches the clusters it edits, and "off" takes them
    to the column windows."""
    from ray_tpu_torch import sweep_flash_f32 as sweep

    chosen = sweep.sources("chosen")
    for bits, text, source in ((32, sweep.FWD32_TRAITS, sweep.SOURCE), (16, sweep.FWD16_TRAITS, sweep.SOURCE16)):
        assert text in chosen[source] and cu_fwd_slice_tiles(chosen[source]) == TRAITS[bits]
        names = [n for n in sweep.VARIANTS if sweep._family(n) == f"fwd{bits}"]
        assert f"fwd{bits} off" in names and {f"fwd{bits} no wait", f"fwd{bits} no reads"} <= set(sweep.TIMING_ONLY)
        for name in names:
            files = sweep.sources(name)
            assert files != chosen, name
            edits = sweep.VARIANTS[name][1]
            if edits[0][0] == source:
                named = {k: int(v) for k, v in re.findall(r"(\w+) = (\d+)", edits[0][2])}
                assert cu_fwd_slice_tiles(files[source]) == named, name
                assert sum(TRAITS[bits][k] != v for k, v in named.items()) >= 1, name
        shapes = sweep.FWD32_SHAPES if bits == 32 else sweep.FWD16_SHAPES
        for B, T, Tk, H, D, causal, dtypes, out_f32 in shapes + sweep.FWD_CHECKS[bits]:
            assert _bits(dtypes) == bits and tfa.sliced("flash_fwd", D, "mixed" if len(set(dtypes)) > 1 else dtypes[0])

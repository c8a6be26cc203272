"""The tiling of the port's Hopper flash kernels, modelled in plain PyTorch on the CPU.

The forward, dQ and dK/dV kernels of ``ray_tpu_torch/ops/csrc/flash_attention.cu``
run only on the card. This file writes their schedules out in PyTorch at
the tile sizes the ``.cu`` settles on: which work tiles each persistent
block takes and in what order, which (q tile, key tile) pairs each
consumer warpgroup visits, which of those it masks, and the arithmetic in
that order (the forward's exp2 with scale * log2 e folded in and P rounded
to bf16 against the running max; dQ to the diagonal and dK/dV from it on,
P as exp2 with the scale folded in, dS rounded to bf16 before its product
and scaled after it). The model is held by ``bench.disagreement`` to the
port's plain versions and to the JAX package's functions (run as
``tests/test_torch_flash_attention.py`` runs them: Pallas in interpret
mode, one tile per call), and the schedules to covering every pair the mask
keeps exactly once.
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

CU = Path(tfa.__file__).resolve().parent / "csrc" / "flash_attention.cu"


def cu_tiles(source: str) -> dict:
    """The tile block of flash_attention.cu: each ``constexpr int NAME =
    <int or RT_ macro>;``, a macro read from its ``#define`` default."""
    macros = dict(re.findall(r"^#define (RT_\w+) (\d+)$", source, re.M))
    return {name: int(macros.get(value, value)) for name, value in
            re.findall(r"^constexpr int ((?:FWD|DKV|DQ)_(?:WGS|BK|BQ|STAGES)) = (\w+);", source, re.M)}


# The tile sizes the .cu settles on, read from its source, so the model
# follows any change there.
_TILES = cu_tiles(CU.read_text())
FWD_WGS, FWD_BK, FWD_STAGES = _TILES["FWD_WGS"], _TILES["FWD_BK"], _TILES["FWD_STAGES"]
DKV_BK, DKV_BQ, DKV_STAGES = _TILES["DKV_BK"], _TILES["DKV_BQ"], _TILES["DKV_STAGES"]
DQ_WGS, DQ_BK, DQ_STAGES = _TILES["DQ_WGS"], _TILES["DQ_BK"], _TILES["DQ_STAGES"]
WG_ROWS = 64  # q rows (forward, dQ) or keys (dK/dV) of one consumer warpgroup
FWD_BQ = WG_ROWS * FWD_WGS
DQ_BQ = WG_ROWS * DQ_WGS
GRID = 132    # one persistent block per SM of an H100 SXM

LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
LSE_TOL = 1e-4  # f32 in both, summed in other orders (as on the card)

# (Tq, Tk, causal)
SHAPES = [(1, 1, True), (65, 65, True), (256, 256, True), (1000, 1000, True),
          (100, 37, False), (300, 1100, False)]
CASES = [(*shape, d) for shape in SHAPES for d in (16, 64)]
BH = 2  # B 1, H 2


def _ceil(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# Schedules (WorkList, the per-warpgroup tile loops)
# ---------------------------------------------------------------------------


def work_list(n_tiles, bh, causal, longest_high, grid=GRID):
    """Per persistent block, its (bh, tile) works in order, as WorkList
    hands them out: units u = b, b + grid, ...; a causal unit pairs tiles
    p and n - 1 - p, the longer one first."""
    per_head = _ceil(n_tiles, 2) if causal else n_tiles
    blocks = []
    for b in range(min(grid, per_head * bh)):
        works = []
        for u in range(b, per_head * bh, grid):
            h, p = divmod(u, per_head)
            if not causal:
                works.append((h, p))
                continue
            hi = n_tiles - 1 - p
            longer, shorter = (hi, p) if longest_high else (p, hi)
            works.append((h, longer))
            if hi != p:
                works.append((h, shorter))
        blocks.append(works)
    return blocks


def _q_tile_visits(qt, Tq, Tk, causal, bq, bk):
    """For q work tile qt of bq rows: per consumer warpgroup, its first row
    and the key tiles (of bk keys) it multiplies, in order, each with
    whether it is masked (to the diagonal when causal)."""
    q0 = qt * bq
    out = []
    for c in range(bq // WG_ROWS):
        wq0 = q0 + WG_ROWS * c
        # no tiles for a warpgroup whose rows all lie past Tq
        n_own = _ceil(min(Tk, wq0 + WG_ROWS) if causal else Tk, bk) if wq0 < Tq else 0
        tiles = [(i, i * bk + bk > Tk or (causal and i * bk + bk - 1 > wq0)) for i in range(n_own)]
        out.append((wq0, tiles))
    return out


def fwd_visits(qt, Tq, Tk, causal):
    return _q_tile_visits(qt, Tq, Tk, causal, FWD_BQ, FWD_BK)


def dq_visits(qt, Tq, Tk, causal):
    return _q_tile_visits(qt, Tq, Tk, causal, DQ_BQ, DQ_BK)


def dkv_visits(kt, Tq, Tk, causal):
    """For work tile kt: per consumer warpgroup, its first key and the q
    tiles (of DKV_BQ rows) it multiplies, in order, each with whether it is
    masked (from the diagonal on when causal)."""
    k0 = kt * DKV_BK
    out = []
    for c in range(DKV_BK // WG_ROWS):
        wk0 = k0 + WG_ROWS * c
        first = wk0 // DKV_BQ if causal else 0
        tiles = [(i, i * DKV_BQ + DKV_BQ > Tq or (causal and wk0 + WG_ROWS - 1 > i * DKV_BQ))
                 for i in range(first, _ceil(Tq, DKV_BQ))]
        out.append((wk0, tiles))
    return out


# ---------------------------------------------------------------------------
# The kernels' arithmetic in their order
# ---------------------------------------------------------------------------


def fwd_model(q, k, v, causal):
    """o, lse by the forward kernel's schedule: bf16 inputs, f32 scores,
    m and l in log2 units, P rounded to bf16 against the running max."""
    BHn, Tq, D = q.shape
    Tk = k.shape[1]
    sl2 = LOG2E / math.sqrt(D)
    qf, kf, vf = q.float(), k.float(), v.float()
    o = torch.zeros(BHn, Tq, D)
    lse = torch.zeros(BHn, Tq)
    for works in work_list(_ceil(Tq, FWD_BQ), BHn, causal, longest_high=True):
        for bh, qt in works:
            for wq0, tiles in fwd_visits(qt, Tq, Tk, causal):
                rows = torch.arange(wq0, wq0 + WG_ROWS)
                live = rows < Tq
                qr = torch.zeros(WG_ROWS, D)
                qr[live] = qf[bh, rows[live]]
                m = torch.full((WG_ROWS, 1), -math.inf)
                l = torch.zeros(WG_ROWS, 1)
                acc = torch.zeros(WG_ROWS, D)
                for i, masked in tiles:
                    cols = torch.arange(i * FWD_BK, (i + 1) * FWD_BK)
                    kt, vt = torch.zeros(FWD_BK, D), torch.zeros(FWD_BK, D)
                    kt[cols < Tk], vt[cols < Tk] = kf[bh, cols[cols < Tk]], vf[bh, cols[cols < Tk]]
                    s = qr @ kt.T
                    if masked:
                        off = (cols[None] >= Tk) | (causal & (cols[None] > rows[:, None]))
                        s = s.masked_fill(off, -math.inf)
                    m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
                    alpha, p = torch.exp2(m - m_new), torch.exp2(s * sl2 - m_new)
                    l = l * alpha + p.sum(-1, keepdim=True)
                    acc = acc * alpha + p.bfloat16().float() @ vt
                    m = m_new
                o[bh, rows[live]] = (acc / l)[live]
                lse[bh, rows[live]] = ((m + torch.log2(l)) * LN2).squeeze(-1)[live]
    return o.bfloat16(), lse


def dq_model(q, k, v, do, lse, delta, causal):
    """dq by the dQ kernel's schedule: P = 2^(S sl2 - lse log2 e), dS = P (dP -
    delta) rounded to bf16 before its product, scaled after it."""
    BHn, Tq, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    sl2 = scale * LOG2E
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dq = torch.zeros(BHn, Tq, D)
    for works in work_list(_ceil(Tq, DQ_BQ), BHn, causal, longest_high=True):
        for bh, qt in works:
            for wq0, tiles in dq_visits(qt, Tq, Tk, causal):
                rows = torch.arange(wq0, wq0 + WG_ROWS)
                live = rows < Tq
                qr, dor = torch.zeros(WG_ROWS, D), torch.zeros(WG_ROWS, D)
                qr[live], dor[live] = qf[bh, rows[live]], dof[bh, rows[live]]
                l2, dl = torch.zeros(WG_ROWS, 1), torch.zeros(WG_ROWS, 1)
                l2[live, 0], dl[live, 0] = lse[bh, rows[live]] * LOG2E, delta[bh, rows[live]]
                acc = torch.zeros(WG_ROWS, D)
                for i, masked in tiles:
                    cols = torch.arange(i * DQ_BK, (i + 1) * DQ_BK)
                    inc = cols < Tk
                    kt, vt = torch.zeros(DQ_BK, D), torch.zeros(DQ_BK, D)
                    kt[inc], vt[inc] = kf[bh, cols[inc]], vf[bh, cols[inc]]
                    p = torch.exp2(qr @ kt.T * sl2 - l2)
                    if masked:
                        off = (cols[None] >= Tk) | (causal & (cols[None] > rows[:, None]))
                        p = p.masked_fill(off, 0.0)
                    ds = p * (dor @ vt.T - dl)
                    acc += ds.bfloat16().float() @ kt
                dq[bh, rows[live]] = (acc * scale)[live]
    return dq.bfloat16()


def dkv_model(q, k, v, do, lse, delta, causal):
    """dk, dv by the dK/dV kernel's schedule: P^T = 2^(S^T sl2 - lse log2 e),
    dS^T = P^T (dP^T - delta) rounded to bf16 before its product, scaled
    after it."""
    BHn, Tq, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    sl2 = scale * LOG2E
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dk, dv = torch.zeros(BHn, Tk, D), torch.zeros(BHn, Tk, D)
    for works in work_list(_ceil(Tk, DKV_BK), BHn, causal, longest_high=False):
        for bh, kt in works:
            for wk0, tiles in dkv_visits(kt, Tq, Tk, causal):
                keys = torch.arange(wk0, wk0 + WG_ROWS)
                live = keys < Tk
                kr, vr = torch.zeros(WG_ROWS, D), torch.zeros(WG_ROWS, D)
                kr[live], vr[live] = kf[bh, keys[live]], vf[bh, keys[live]]
                dk_acc, dv_acc = torch.zeros(WG_ROWS, D), torch.zeros(WG_ROWS, D)
                for i, masked in tiles:
                    rows = torch.arange(i * DKV_BQ, (i + 1) * DKV_BQ)
                    inq = rows < Tq
                    qt, dot = torch.zeros(DKV_BQ, D), torch.zeros(DKV_BQ, D)
                    qt[inq], dot[inq] = qf[bh, rows[inq]], dof[bh, rows[inq]]
                    ls, ds = torch.zeros(DKV_BQ), torch.zeros(DKV_BQ)
                    ls[inq], ds[inq] = lse[bh, rows[inq]], delta[bh, rows[inq]]
                    p = torch.exp2(kr @ qt.T * sl2 - ls[None] * LOG2E)
                    if masked:
                        off = (rows[None] >= Tq) | (causal & (keys[:, None] > rows[None]))
                        p = p.masked_fill(off, 0.0)
                    dst = p * (vr @ dot.T - ds[None])
                    dv_acc += p.bfloat16().float() @ dot
                    dk_acc += dst.bfloat16().float() @ qt
                dk[bh, keys[live]] = (dk_acc * scale)[live]
                dv[bh, keys[live]] = dv_acc[live]
    return dk.bfloat16(), dv.bfloat16()


# ---------------------------------------------------------------------------
# Inputs and the JAX functions (B 1, H 2: folded BH 2)
# ---------------------------------------------------------------------------


def _inputs(Tq, Tk, D, seed=0):
    """bf16 q, k, v, dO [BH, T, D] from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    make = lambda T: torch.from_numpy(rng.standard_normal((BH, T, D), dtype=np.float32)).bfloat16()
    return make(Tq), make(Tk), make(Tk), make(Tq)


def _to_model_layout(x):  # [BH, T, D] bf16 -> [1, T, BH, D] f32 numpy, as the JAX functions take
    return np.asarray(tfa._unfold(x.float(), 1, BH).contiguous().numpy())


@pytest.fixture
def one_jax_tile(monkeypatch):
    """The JAX kernels in one tile per call (their ragged T would otherwise
    fall back to 8-row tiles, thousands of interpret-mode steps)."""
    def set_tiles(Tq, Tk):
        monkeypatch.setenv("RT_FLASH_BQ", str(Tq))
        monkeypatch.setenv("RT_FLASH_BK", str(Tk))
    return set_tiles


def _close(got, want):
    gap = bench.disagreement(got, want)
    assert gap["ok"], gap


def _id(case):
    Tq, Tk, causal, d = case
    return f"Tq{Tq}_Tk{Tk}_{'causal' if causal else 'full'}_D{d}"


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_forward_tiles_match_plain_and_jax(cpu_mesh_devices, one_jax_tile, case):
    Tq, Tk, causal, D = case
    q, k, v, _ = _inputs(Tq, Tk, D)
    o, lse = fwd_model(q, k, v, causal)
    o_ref, lse_ref = tfa.flash_fwd_reference(q, k, v, causal)
    _close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL

    one_jax_tile(Tq, Tk)
    out_j, res = jfa._flash_fwd(*(jnp.asarray(_to_model_layout(x)) for x in (q, k, v)), causal)
    _close(o, tfa._fold(torch.from_numpy(np.array(out_j))))
    assert np.abs(lse.numpy() - np.asarray(res[-1])[:, 0, :]).max() <= LSE_TOL


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_dkv_tiles_match_plain_and_jax(cpu_mesh_devices, one_jax_tile, case):
    Tq, Tk, causal, D = case
    q, k, v, do = _inputs(Tq, Tk, D, seed=1)
    o_ref, lse = tfa.flash_fwd_reference(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1)
    dk, dv = dkv_model(q, k, v, do, lse, delta, causal)
    dk_ref, dv_ref = tfa.flash_dkv_reference(q, k, v, do, lse, delta, causal)
    _close(dk, dk_ref)
    _close(dv, dv_ref)

    one_jax_tile(Tq, Tk)
    fold = jfa._fold
    _, dk_j, dv_j = jfa._bwd_kernels(
        *(fold(jnp.asarray(_to_model_layout(x))) for x in (q, k, v, do)),
        jnp.broadcast_to(jnp.asarray(lse.numpy())[:, None], (BH, 8, Tq)),
        jnp.broadcast_to(jnp.asarray(delta.numpy())[:, None], (BH, 8, Tq)),
        causal, jnp.float32, jnp.float32, jnp.float32,
    )
    _close(dk, torch.from_numpy(np.array(dk_j)))
    _close(dv, torch.from_numpy(np.array(dv_j)))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_dq_tiles_match_plain_and_jax(cpu_mesh_devices, one_jax_tile, case):
    Tq, Tk, causal, D = case
    q, k, v, do = _inputs(Tq, Tk, D, seed=2)
    o_ref, lse = tfa.flash_fwd_reference(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1)
    dq = dq_model(q, k, v, do, lse, delta, causal)
    _close(dq, tfa.flash_dq_reference(q, k, v, do, lse, delta, causal))

    one_jax_tile(Tq, Tk)
    fold = jfa._fold
    dq_j, _, _ = jfa._bwd_kernels(
        *(fold(jnp.asarray(_to_model_layout(x))) for x in (q, k, v, do)),
        jnp.broadcast_to(jnp.asarray(lse.numpy())[:, None], (BH, 8, Tq)),
        jnp.broadcast_to(jnp.asarray(delta.numpy())[:, None], (BH, 8, Tq)),
        causal, jnp.float32, jnp.float32, jnp.float32,
    )
    _close(dq, torch.from_numpy(np.array(dq_j)))


@pytest.mark.parametrize("kernel", ["forward", "dq", "dkv"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: _id((*s, 0))[:-3])
def test_schedule_covers_each_kept_pair_once(kernel, shape):
    """Over all blocks, warpgroups and visited tiles, every (q, key) pair
    the mask keeps is computed exactly once, every work tile is taken by
    exactly one block, and the masked tiles are the ones that hold a pair
    the mask drops. Causal units cost the same, longest tile first."""
    Tq, Tk, causal = shape
    seen = torch.zeros(Tq, Tk, dtype=torch.int32)
    if kernel == "forward":
        n, tile_rows, longest_high, visits = _ceil(Tq, FWD_BQ), FWD_BQ, True, fwd_visits
    elif kernel == "dq":
        n, tile_rows, longest_high, visits = _ceil(Tq, DQ_BQ), DQ_BQ, True, dq_visits
    else:
        n, tile_rows, longest_high, visits = _ceil(Tk, DKV_BK), DKV_BK, False, dkv_visits
    blocks = work_list(n, 1, causal, longest_high)
    works = [w for b in blocks for w in b]
    assert sorted(works) == [(0, t) for t in range(n)]
    for tile in range(n):
        for first, tiles in visits(tile, Tq, Tk, causal):
            for i, masked in tiles:
                if kernel != "dkv":
                    bk = FWD_BK if kernel == "forward" else DQ_BK
                    rows, cols = range(first, first + WG_ROWS), range(i * bk, (i + 1) * bk)
                else:
                    rows, cols = range(i * DKV_BQ, (i + 1) * DKV_BQ), range(first, first + WG_ROWS)
                block = [(r, c) for r in rows for c in cols]
                # The kernels mask what would change a kept result: keys past
                # Tk in the forward and dQ, q rows past Tq in dK/dV, and the
                # causal upper triangle; rows (forward, dQ) or keys (dK/dV)
                # past T are computed and never stored.
                dropped = [(c >= Tk if kernel != "dkv" else r >= Tq) or (causal and c > r)
                           for r, c in block]
                assert masked == any(dropped)
                kept = [(r, c) for r, c in block if r < Tq and c < Tk and not (causal and c > r)]
                for r, c in kept:
                    seen[r, c] += 1
    want = torch.ones(Tq, Tk, dtype=torch.int32)
    if causal:
        want = want.tril()
    assert torch.equal(seen, want)
    if causal:  # a unit's two tiles add up to the same work as any other unit's
        # the tiles visited by the warpgroup that sees the most of them
        cost = lambda t: max(len(tiles) for _, tiles in visits(t, Tq, Tk, causal))
        unit_cost = set()
        for b in blocks:
            j = 0
            while j < len(b):
                h, t = b[j]
                if j + 1 < len(b) and b[j + 1] == (h, n - 1 - t) and n - 1 - t != t:
                    assert cost(t) >= cost(n - 1 - t)  # the longer tile first
                    unit_cost.add(cost(t) + cost(n - 1 - t))
                    j += 2
                else:
                    assert n - 1 - t == t  # only the middle tile of an odd count is alone
                    j += 1
        assert len(unit_cost) <= 1, unit_cost


def test_tile_block_is_read_from_the_cu():
    """The model's tile sizes come from the .cu's block, a macro's default
    included; the non-causal Tq 300, Tk 1100 case spans more key tiles than
    the forward's and dQ's rings have stages and more q tiles than dK/dV's,
    so all three rings wrap."""
    source = CU.read_text()
    assert set(_TILES) == {"FWD_WGS", "FWD_BK", "FWD_STAGES", "DKV_BK", "DKV_BQ", "DKV_STAGES",
                           "DQ_WGS", "DQ_BK", "DQ_STAGES"}
    assert f"constexpr int FWD_BQ = {WG_ROWS} * FWD_WGS;" in source
    assert f"constexpr int DQ_BQ = {WG_ROWS} * DQ_WGS;" in source
    for macro, name in (("RT_FWD_STAGES", "FWD_STAGES"), ("RT_DQ_STAGES", "DQ_STAGES")):
        deeper = re.sub(rf"^#define {macro} \d+$", f"#define {macro} 7", source, flags=re.M)
        assert cu_tiles(deeper)[name] == 7
    assert FWD_BK in (64, 128) and DQ_BK in (64, 128)
    assert min(FWD_STAGES, DKV_STAGES, DQ_STAGES) >= 2
    assert _ceil(1100, FWD_BK) > FWD_STAGES and _ceil(300, DKV_BQ) > DKV_STAGES
    assert _ceil(1100, DQ_BK) > DQ_STAGES

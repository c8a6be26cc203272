"""The tiling of the port's Hopper flash kernels, modelled in plain PyTorch on the CPU.

The forward, dQ and dK/dV kernels of ``ray_tpu_torch/ops/csrc/flash_attention.cu``
run only on the card. This file writes their schedules out in PyTorch at
the tile sizes the ``.cu`` settles on for each head dim (``Tiles<D>``: 16,
32 and 64 share one set, 128 and 256 have their own; at 256 dK/dV runs as
a dV pass and a dK pass): which work tiles each persistent
block takes and in what order, which (q tile, key tile) pairs each
consumer warpgroup visits, which of those it masks, and the arithmetic in
that order (the forward's exp2 with scale * log2 e folded in and P rounded
to bf16 against the running max; dQ to the diagonal and dK/dV from it on,
P as exp2 with the scale folded in, dS scaled and then rounded to bf16
before its product). The model is held by ``bench.disagreement`` to the
port's plain versions and to the JAX package's functions (run as
``tests/test_torch_flash_attention.py`` runs them: Pallas in interpret
mode, one tile per call), and the schedules to covering every pair the mask
keeps exactly once. Each instance's shared-memory plan, worked out from the
``.cu``'s constants, is held to the 232,448 bytes a block may have.
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


HEAD_DIMS = tuple(tfa.HEAD_DIMS)  # 16, 32, 64, 128, 256


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


SMEM_LIMIT = 232448  # dynamic shared memory a block may have on an H100


def cu_tiles(source: str) -> dict:
    """The tile block of flash_attention.cu per head dim, {D: {NAME: int}}:
    each global ``constexpr int NAME = <int>;`` (FWD_WGS, DKV_BK, DQ_WGS)
    and each member of the ``Tiles`` traits (``NAME = <int or RT_ macro>``;
    the primary template for the head dims without a specialisation), a
    macro read from its ``#define`` default."""
    macros = dict(re.findall(r"^#define (RT_\w+) (\d+)$", source, re.M))
    value = lambda v: int(macros.get(v, v))
    common = {name: value(v) for name, v in
              re.findall(r"^constexpr int ((?:FWD|DKV|DQ)_(?:WGS|BK|BQ|STAGES)) = (\w+);", source, re.M)}
    traits = {int(d) if d else None: {name: value(v) for name, v in re.findall(r"(\w+) = (\w+)", body)}
              for d, body in re.findall(r"^struct Tiles(?:<(\d+)>)? \{(.*?)^\};", source, re.M | re.S)}
    return {d: {**common, **traits.get(d, traits[None])} for d in HEAD_DIMS}


# The tile sizes the .cu settles on, read from its source, so the model
# follows any change there.
_TILES = cu_tiles(CU.read_text())
WG_ROWS = 64  # q rows (forward, dQ) or keys (dK/dV) of one consumer warpgroup
GRID = 132    # one persistent block per SM of an H100 SXM


class Tiles:
    """One head dim's tile sizes and ring depths (``Tiles<D>`` in the .cu)."""

    def __init__(self, d: int):
        t = _TILES[d]
        self.d = d
        self.FWD_WGS, self.FWD_BK, self.FWD_STAGES = t["FWD_WGS"], t["FWD_BK"], t["FWD_STAGES"]
        self.DKV_BK, self.DKV_BQ, self.DKV_STAGES = t["DKV_BK"], t["DKV_BQ"], t["DKV_STAGES"]
        self.DKV_KV_IN_REGS, self.DKV_PASSES = t["DKV_KV_IN_REGS"], t["DKV_PASSES"]
        self.DQ_WGS, self.DQ_BK, self.DQ_STAGES = t["DQ_WGS"], t["DQ_BK"], t["DQ_STAGES"]
        self.FWD_Q_BUFS, self.DQ_QDO_IN_REGS = t["FWD_Q_BUFS"], t["DQ_QDO_IN_REGS"]
        self.FWD_BQ = WG_ROWS * self.FWD_WGS
        self.DQ_BQ = WG_ROWS * self.DQ_WGS


TILES = {d: Tiles(d) for d in HEAD_DIMS}

LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
LSE_TOL = 1e-4  # f32 in both, summed in other orders (as on the card)

# (Tq, Tk, causal)
SHAPES = [(1, 1, True), (65, 65, True), (256, 256, True), (1000, 1000, True),
          (100, 37, False), (300, 1100, False)]
# Head dim 256's models at the shapes under 1,000 rows (its tiles are the
# smallest, so the longer shapes cost the most; its schedules are checked at
# every shape below).
CASES = ([(*shape, d) for shape in SHAPES for d in (16, 64)]
         + [(*shape, d) for shape in SHAPES for d in (32, 128)]
         + [(*shape, 256) for shape in SHAPES if max(shape[:2]) < 1000])
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


def fwd_visits(qt, Tq, Tk, causal, t):
    return _q_tile_visits(qt, Tq, Tk, causal, t.FWD_BQ, t.FWD_BK)


def dq_visits(qt, Tq, Tk, causal, t):
    return _q_tile_visits(qt, Tq, Tk, causal, t.DQ_BQ, t.DQ_BK)


def dkv_visits(kt, Tq, Tk, causal, t):
    """For work tile kt: per consumer warpgroup, its first key and the q
    tiles (of DKV_BQ rows) it multiplies, in order, each with whether it is
    masked (from the diagonal on when causal)."""
    k0, bq = kt * t.DKV_BK, t.DKV_BQ
    out = []
    for c in range(t.DKV_BK // WG_ROWS):
        wk0 = k0 + WG_ROWS * c
        first = wk0 // bq if causal else 0
        tiles = [(i, i * bq + bq > Tq or (causal and wk0 + WG_ROWS - 1 > i * bq))
                 for i in range(first, _ceil(Tq, bq))]
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
    t = TILES[D]
    FWD_BK = t.FWD_BK
    sl2 = LOG2E / math.sqrt(D)
    qf, kf, vf = q.float(), k.float(), v.float()
    o = torch.zeros(BHn, Tq, D)
    lse = torch.zeros(BHn, Tq)
    for works in work_list(_ceil(Tq, t.FWD_BQ), BHn, causal, longest_high=True):
        for bh, qt in works:
            for wq0, tiles in fwd_visits(qt, Tq, Tk, causal, t):
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
    delta) scale rounded to bf16 before its product."""
    BHn, Tq, D = q.shape
    Tk = k.shape[1]
    t = TILES[D]
    DQ_BK = t.DQ_BK
    scale = 1.0 / math.sqrt(D)
    sl2 = scale * LOG2E
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dq = torch.zeros(BHn, Tq, D)
    for works in work_list(_ceil(Tq, t.DQ_BQ), BHn, causal, longest_high=True):
        for bh, qt in works:
            for wq0, tiles in dq_visits(qt, Tq, Tk, causal, t):
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
                    ds = p * (dor @ vt.T - dl) * scale
                    acc += ds.bfloat16().float() @ kt
                dq[bh, rows[live]] = acc[live]
    return dq.bfloat16()


def dkv_model(q, k, v, do, lse, delta, causal):
    """dk, dv by the dK/dV kernel's schedule: P^T = 2^(S^T sl2 - lse log2 e),
    dS^T = P^T (dP^T - delta) scale rounded to bf16 before its product. With
    DKV_PASSES 2 the schedule runs twice, dV in the first pass and dK in the
    second, each recomputing S^T and P^T."""
    BHn, Tq, D = q.shape
    Tk = k.shape[1]
    t = TILES[D]
    DKV_BQ = t.DKV_BQ
    scale = 1.0 / math.sqrt(D)
    sl2 = scale * LOG2E
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dk, dv = torch.zeros(BHn, Tk, D), torch.zeros(BHn, Tk, D)
    passes = [("dk", "dv")] if t.DKV_PASSES == 1 else [("dv",), ("dk",)]
    for outs, works in ((o, w) for o in passes
                        for w in work_list(_ceil(Tk, t.DKV_BK), BHn, causal, longest_high=False)):
        for bh, kt in works:
            for wk0, tiles in dkv_visits(kt, Tq, Tk, causal, t):
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
                    if "dv" in outs:
                        dv_acc += p.bfloat16().float() @ dot
                    if "dk" in outs:
                        dst = p * (vr @ dot.T - ds[None]) * scale
                        dk_acc += dst.bfloat16().float() @ qt
                if "dk" in outs:
                    dk[bh, keys[live]] = dk_acc[live]
                if "dv" in outs:
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


def _check_schedule(kernel, shape, t):
    """Over all blocks, warpgroups and visited tiles, every (q, key) pair
    the mask keeps is computed exactly once, every work tile is taken by
    exactly one block, and the masked tiles are the ones that hold a pair
    the mask drops. Causal units cost the same, longest tile first."""
    Tq, Tk, causal = shape
    seen = torch.zeros(Tq, Tk, dtype=torch.int32)
    if kernel == "forward":
        n, longest_high, visits = _ceil(Tq, t.FWD_BQ), True, fwd_visits
    elif kernel == "dq":
        n, longest_high, visits = _ceil(Tq, t.DQ_BQ), True, dq_visits
    else:
        n, longest_high, visits = _ceil(Tk, t.DKV_BK), False, dkv_visits
    blocks = work_list(n, 1, causal, longest_high)
    works = [w for b in blocks for w in b]
    assert sorted(works) == [(0, tile) for tile in range(n)]
    for tile in range(n):
        for first, tiles in visits(tile, Tq, Tk, causal, t):
            for i, masked in tiles:
                if kernel != "dkv":
                    bk = t.FWD_BK if kernel == "forward" else t.DQ_BK
                    rows, cols = torch.arange(first, first + WG_ROWS), torch.arange(i * bk, (i + 1) * bk)
                else:
                    rows = torch.arange(i * t.DKV_BQ, (i + 1) * t.DKV_BQ)
                    cols = torch.arange(first, first + WG_ROWS)
                r, c = rows[:, None], cols[None, :]
                # The kernels mask what would change a kept result: keys past
                # Tk in the forward and dQ, q rows past Tq in dK/dV, and the
                # causal upper triangle; rows (forward, dQ) or keys (dK/dV)
                # past T are computed and never stored.
                dropped = ((c >= Tk) if kernel != "dkv" else (r >= Tq)) | (causal & (c > r))
                assert masked == bool(dropped.any())
                kept = (r < Tq) & (c < Tk) & ~(causal & (c > r))
                rr, cc = torch.broadcast_tensors(r, c)
                seen.index_put_((rr[kept], cc[kept]), torch.ones(int(kept.sum()), dtype=torch.int32),
                                accumulate=True)
    want = torch.ones(Tq, Tk, dtype=torch.int32)
    if causal:
        want = want.tril()
    assert torch.equal(seen, want)
    if causal:  # a unit's two tiles add up to the same work as any other unit's
        # the tiles visited by the warpgroup that sees the most of them
        cost = lambda tile: max(len(tiles) for _, tiles in visits(tile, Tq, Tk, causal, t))
        unit_cost = set()
        for b in blocks:
            j = 0
            while j < len(b):
                h, tile = b[j]
                if j + 1 < len(b) and b[j + 1] == (h, n - 1 - tile) and n - 1 - tile != tile:
                    assert cost(tile) >= cost(n - 1 - tile)  # the longer tile first
                    unit_cost.add(cost(tile) + cost(n - 1 - tile))
                    j += 2
                else:
                    assert n - 1 - tile == tile  # only the middle tile of an odd count is alone
                    j += 1
        assert len(unit_cost) <= 1, unit_cost


@pytest.mark.parametrize("kernel", ["forward", "dq", "dkv"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: _id((*s, 0))[:-3])
def test_schedule_covers_each_kept_pair_once(kernel, shape):
    """The schedules of head dims 16, 32 and 64 (one set of tiles)."""
    assert len({(t.FWD_BK, t.DKV_BQ, t.DQ_BK) for d, t in TILES.items() if d < 128}) == 1
    _check_schedule(kernel, shape, TILES[64])


@pytest.mark.parametrize("kernel", ["forward", "dq", "dkv"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: _id((*s, 0))[:-3])
def test_schedule_covers_each_kept_pair_once_at_head_dim_128(kernel, shape):
    """Head dim 128's schedules: 32 keys a dQ stage, 32 q rows a dK/dV stage."""
    _check_schedule(kernel, shape, TILES[128])


@pytest.mark.parametrize("kernel", ["forward", "dq", "dkv"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: _id((*s, 0))[:-3])
def test_schedule_covers_each_kept_pair_once_at_head_dim_256(kernel, shape):
    """Head dim 256's schedules: 64 keys a forward stage, 32 keys a dQ
    stage, 32 q rows a dK/dV stage; dK/dV's two passes (dV, then dK) each
    walk the whole schedule, so each covers every kept pair once."""
    t = TILES[256]
    assert (t.FWD_Q_BUFS, t.DKV_PASSES, t.DQ_QDO_IN_REGS, t.DKV_KV_IN_REGS) == (1, 2, 0, 0)
    for _ in range(t.DKV_PASSES if kernel == "dkv" else 1):
        _check_schedule(kernel, shape, t)


def smem_plan(t: Tiles) -> dict:
    """Each kernel's dynamic shared memory at head dim t.d, by the layout of
    FwdSmem, DkvSmem and DqSmem in the .cu (1,024 bytes of alignment slack,
    the tiles, the mbarriers): FWD_Q_BUFS Q tiles; a warpgroup's output
    staging tile of 64 rows and at most 128 columns (StageTile); dK/dV's two
    sets of staging tiles, or one a pass with DKV_PASSES 2."""
    d, row = t.d, 2 * t.d  # bytes of a bf16 row
    stage_row = 2 * min(d, 128)
    outs = 2 if t.DKV_PASSES == 1 else 1
    fwd = (t.FWD_Q_BUFS * t.FWD_BQ * row + 2 * t.FWD_STAGES * t.FWD_BK * row
           + t.FWD_WGS * WG_ROWS * stage_row + 8 * (2 * t.FWD_Q_BUFS + 3 * t.FWD_STAGES))
    ring = 2 * t.DKV_BK * row + 2 * t.DKV_STAGES * t.DKV_BQ * row + 2 * t.DKV_STAGES * t.DKV_BQ * 4
    dkv = _ceil(ring, 1024) * 1024 + outs * 2 * WG_ROWS * stage_row + 8 * (2 + 2 * t.DKV_STAGES)
    dq = (2 * t.DQ_BQ * row + 2 * t.DQ_STAGES * t.DQ_BK * row + t.DQ_WGS * WG_ROWS * stage_row
          + 8 * (2 + 2 * t.DQ_STAGES))
    assert d in HEAD_DIMS
    return {"flash_fwd": 1024 + fwd, "flash_dkv": 1024 + dkv, "flash_dq": 1024 + dq}


def f32_smem_plan(d: int) -> dict:
    """The f32 library's dynamic shared memory at head dim d, by FwdPlan,
    DqPlan and DkvPlan, from F32Tiles<d>: 1,024 bytes of alignment slack;
    the block's rows of its split operands, big and small (the forward:
    FWD_ROWS rows of Q; dQ and dK/dV: ROWS_OWNED rows of two operands, Q and
    dO, or K and V); STAGES stages of split tiles (the forward: K big and
    small and V^T big and small, FWD_BK keys, and V as loaded without raw
    slots; dQ: K and V big and small and K^T big and small, DQ_BK keys;
    dK/dV: Q and dO big and small, natural and transposed, DKV_BQ rows, and
    the rows' lse and delta; a pass of two: the six tiles its products
    read); RAW raw slots (the two operands as loaded); two mbarriers, two a
    load slot (a raw slot, or a stage without them) and two a stage (Feed).
    With A_SPLIT 0 the block's own rows are kept raw, not split."""
    source = (CU.parent / "flash_attention_f32.cu").read_text()
    rows = int(re.search(r"^constexpr int ROWS_OWNED = (\d+);", source, re.M)[1])
    body = re.search(rf"^struct F32Tiles<{d}> \{{(.*?)^\}};", source, re.M | re.S)[1]
    t = {name: int(v) for name, v in re.findall(r"(\w+) = (\d+)", body)}
    parts = 2 if t["A_SPLIT"] else 1  # big and small, or raw
    owned = 2 * parts * rows * d * 4
    bars = lambda stages, raw: 8 * (2 + 2 * (raw or stages) + 2 * stages)  # noqa: E731
    fwd_tile = t["FWD_BK"] * d * 4
    fwd_stage = 4 * fwd_tile + (fwd_tile if t["FWD_RAW"] == 0 else 0)
    dq_stage, dq_raw = 6 * t["DQ_BK"] * d * 4, 2 * t["DQ_BK"] * d * 4
    dkv_tiles = 8 if t["DKV_PASSES"] == 1 else 6
    dkv_stage, dkv_raw = dkv_tiles * t["DKV_BQ"] * d * 4 + 2 * t["DKV_BQ"] * 4, 2 * t["DKV_BQ"] * d * 4
    return {"flash_fwd": 1024 + parts * t["FWD_ROWS"] * d * 4 + t["FWD_STAGES"] * fwd_stage
            + t["FWD_RAW"] * 2 * fwd_tile + bars(t["FWD_STAGES"], t["FWD_RAW"]),
            "flash_dq": 1024 + owned + t["DQ_STAGES"] * dq_stage + t["DQ_RAW"] * dq_raw
            + bars(t["DQ_STAGES"], t["DQ_RAW"]),
            "flash_dkv": 1024 + owned + t["DKV_STAGES"] * dkv_stage + t["DKV_RAW"] * dkv_raw
            + bars(t["DKV_STAGES"], t["DKV_RAW"])}


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_shared_memory_plan_fits(d):
    """Every instance's shared memory, worked out from the .cu's constants,
    fits in what a block may have; the .cu asserts the same at build time."""
    plans = {"bf16": smem_plan(TILES[d]), "f32": f32_smem_plan(d)}
    for lib, plan in plans.items():
        for name, nbytes in plan.items():
            assert nbytes <= SMEM_LIMIT, (lib, name, d, nbytes)
    source = CU.read_text()
    for name in ("forward", "dK/dV", "dQ"):
        assert f"LAUNCH <= SMEM_LIMIT, \"{'the forward' if name == 'forward' else name}" in source
    assert f"constexpr int SMEM_LIMIT = {SMEM_LIMIT};" in source


def test_tile_block_is_read_from_the_cu():
    """The model's tile sizes come from the .cu's block, a macro's default
    included; the non-causal Tq 300, Tk 1100 case spans more key tiles than
    the forward's and dQ's rings have stages and more q tiles than dK/dV's,
    so all three rings wrap."""
    source = CU.read_text()
    for d in HEAD_DIMS:
        assert set(_TILES[d]) == {"FWD_WGS", "FWD_BK", "FWD_STAGES", "FWD_Q_BUFS", "DKV_BK", "DKV_BQ",
                                  "DKV_STAGES", "DKV_KV_IN_REGS", "DKV_PASSES", "DQ_WGS", "DQ_BK", "DQ_STAGES",
                                  "DQ_QDO_IN_REGS"}
    assert f"constexpr int FWD_BQ = {WG_ROWS} * FWD_WGS;" in source
    assert f"constexpr int DQ_BQ = {WG_ROWS} * DQ_WGS;" in source
    for macro, name, d in (("RT_FWD_STAGES", "FWD_STAGES", 64), ("RT_DQ_STAGES", "DQ_STAGES", 16),
                           ("RT_DKV_STAGES_128", "DKV_STAGES", 128)):
        deeper = re.sub(rf"^#define {macro} \d+$", f"#define {macro} 7", source, flags=re.M)
        assert cu_tiles(deeper)[d][name] == 7
    for t in TILES.values():
        assert t.FWD_BK in (64, 128) and t.DQ_BK in (32, 64, 128) and t.DKV_BQ in (32, 64)
        assert min(t.FWD_STAGES, t.DKV_STAGES, t.DQ_STAGES) >= 2
        assert _ceil(1100, t.FWD_BK) > t.FWD_STAGES and _ceil(300, t.DKV_BQ) > t.DKV_STAGES
        assert _ceil(1100, t.DQ_BK) > t.DQ_STAGES

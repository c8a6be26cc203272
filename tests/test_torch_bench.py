"""ray_tpu_torch.bench on the CPU: the shared train-step setup, and the
agreement rule that chip_smoke.py and the CUDA tests hold each kernel to.

The rule must pass what the kernels' other summation order produces (here
a tiled online softmax written out in PyTorch, rounding p to bf16 against
the running max as the forward kernel does) and fail a kernel that is
wrong on a fraction of the rows, the failure the rule is there to catch.
"""

import math

import numpy as np
import pytest
import torch

from ray_tpu_torch import bench
from ray_tpu_torch.ops import flash_attention as fa

BH, T, D, TILE = 4, 256, 64, 64


def _inputs():
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.standard_normal((BH, T, D), dtype=np.float32)).bfloat16()
            for _ in range(3)]


def _tiled_forward(q, k, v):
    """o by online softmax over 64-key tiles, causal, p rounded to bf16
    against the running max before p@v (the forward kernel's order)."""
    scale = 1.0 / math.sqrt(D)
    o = torch.empty(BH, T, D)
    for i0 in range(0, T, TILE):
        qi = q[:, i0:i0 + TILE].float()
        m = torch.full((BH, TILE, 1), -1e30)
        l = torch.zeros(BH, TILE, 1)
        acc = torch.zeros(BH, TILE, D)
        for j0 in range(0, i0 + TILE, TILE):
            s = qi @ k[:, j0:j0 + TILE].float().transpose(1, 2) * scale
            above = torch.arange(j0, j0 + TILE)[None] > torch.arange(i0, i0 + TILE)[:, None]
            s = s.masked_fill(above, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.bfloat16().float() @ v[:, j0:j0 + TILE].float()
            m = m_new
        o[:, i0:i0 + TILE] = acc / l
    return o.bfloat16()


def _late_rows_off(o, factor):
    o = o.clone()
    o[:, T // 2:] *= factor
    return o


def _tile_dropped(o):
    o = o.clone()
    o[:, T - TILE:] = 0
    return o


def _nan(o):
    o = o.clone()
    o[1, 7, 3] = float("nan")
    return o


@pytest.mark.parametrize("variant, ok", [
    (lambda o, tiled: tiled, True),
    (lambda o, tiled: o, True),
    (lambda o, tiled: _late_rows_off(o, 0.8), False),
    (lambda o, tiled: _late_rows_off(o, 1.05), False),
    (lambda o, tiled: _tile_dropped(o), False),
    (lambda o, tiled: _nan(o), False),
], ids=["tiled-order", "itself", "late-rows-20pct-off", "late-rows-5pct-off",
        "last-tile-dropped", "nan"])
def test_rule_passes_rounding_and_fails_wrong_rows(variant, ok):
    q, k, v = _inputs()
    o, _ = fa.flash_fwd_reference(q, k, v, True)
    gap = bench.disagreement(variant(o, _tiled_forward(q, k, v)), o)
    assert gap["ok"] is ok, gap


def test_rule_takes_outputs_that_are_zero_in_exact_arithmetic():
    """dS at T = 1 is zero up to f32 rounding: the floor accepts it."""
    want = torch.full((2, 1, D), 3e-8)
    assert bench.disagreement(torch.full((2, 1, D), -2e-7), want)["ok"]
    assert not bench.disagreement(torch.full((2, 1, D), 1e-3), want)["ok"]


def test_setup_trains_on_the_cpu():
    run = bench.setup(2, model="gpt2-tiny", batch=2, seq=16, device="cpu")
    assert (run.cfg.attn_impl, run.cfg.loss_impl, run.cfg.remat) == ("flash", "fused", False)
    for i, tokens in enumerate(run.batches):
        assert tokens.shape == (2, 17) and tokens.device.type == "cpu"
        np.testing.assert_array_equal(
            tokens.numpy(),
            np.random.default_rng(i * 2 + 1).integers(0, run.cfg.vocab_size, (2, 17)))
    losses = [run.step(t).item() for t in run.batches]
    assert all(math.isfinite(x) for x in losses)
    assert abs(losses[0] - math.log(run.cfg.vocab_size)) < 0.5


def test_setup_is_seeded():
    a = bench.setup(1, model="gpt2-tiny", batch=2, seq=16, device="cpu")
    b = bench.setup(1, model="gpt2-tiny", batch=2, seq=16, device="cpu")
    for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), name


def test_timed_steps_counts_from_zero_on_the_cpu():
    """Warm-up steps, then the timed ones: a time for each, the launch
    counts set to 0 first (the plain versions launch nothing), and the
    card's peak memory and busy time nan on the CPU."""
    from ray_tpu_torch.ops import flash_attention as fa

    run = bench.setup(4, model="gpt2-tiny", batch=2, seq=16, device="cpu")
    fa.launches["flash_fwd"] += 5
    before = [p.detach().clone() for p in run.model.parameters()]
    times, per_step, peak, busy = bench.timed_steps(run, run.batches, warmup=1)
    assert len(times) == 3 and all(t > 0 for t in times)
    assert per_step == dict.fromkeys(fa.launches, 0.0)
    assert math.isnan(peak) and math.isnan(busy)
    assert not any(torch.equal(a, p) for a, p in zip(before, run.model.parameters()))

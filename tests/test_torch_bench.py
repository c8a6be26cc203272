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


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


class _Event:
    def __init__(self, name, device_type, start=0, end=0):
        self.name, self.device_type, self.time_range = name, device_type, _Range(start, end)


def _pads(kernels_kept: int) -> list:
    """A card_trace window's pad launches on the host, then ``kernels_kept``
    of their kernels on the card (the first ones lost)."""
    from torch.autograd import DeviceType

    return ([_Event("cudaLaunchKernel", DeviceType.CPU, -100 + i, -99 + i) for i in range(bench.PAD_KERNELS)]
            + [_Event("void at::cuda::spin_kernel(long)", DeviceType.CUDA, -50 + i, -49 + i)
               for i in range(bench.PAD_KERNELS - kernels_kept, bench.PAD_KERNELS)])


def _fake_profiler(monkeypatch, events):
    """torch.profiler.profile replaced by a window whose trace holds
    ``events``, and the card's synchronize and the pads' kernel by nothing;
    returns the list that counts the windows opened."""
    opened = []

    class Window:
        def __init__(self, *args, **kwargs):
            opened.append(1)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return events

    monkeypatch.setattr(torch.profiler, "profile", Window)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    return opened


@pytest.mark.parametrize("pads_kept,device_events,why", [
    pytest.param(0, [], "no device time", id="no_device_time"),
    pytest.param(0, [("flash_dq_kernel<float>", 10, 30), ("elementwise", 30, 40)], "no pad kernel",
                 id="no_pad_kernel"),
    pytest.param(8, [("flash_dq_kernel<float>", 10, 30)],
                 "1 kernels for 2 launches (the first kernel starts 0.009 ms after the first launch)",
                 id="a_kernel_lost")])
def test_a_trace_that_does_not_measure_the_card_is_not_measured(monkeypatch, pads_kept, device_events, why):
    """A trace without device events, without a pad kernel, or with fewer
    kernels than the host launched in it besides the pads, gives nan device
    times, no split, and no window in profiler_ready."""
    from torch.autograd import DeviceType

    events = [*_pads(pads_kept), _Event("aten::mul_", DeviceType.CPU, 0, 5),
              _Event("cudaLaunchKernel", DeviceType.CPU, 1, 2), _Event("cudaLaunchKernelExC", DeviceType.CPU, 3, 4),
              *(_Event(name, DeviceType.CUDA, a, b) for name, a, b in device_events)]
    opened = _fake_profiler(monkeypatch, events)
    assert bench.measured_kernels(torch.profiler.profile()) == ([], why)
    assert bench.device_trace(lambda: None) == []
    assert math.isnan(bench.busy_ms(lambda: None))
    flash, rest, top = bench.device_split(lambda: None)
    assert math.isnan(flash) and math.isnan(rest) and top == []
    opened.clear()
    assert bench.profiler_ready(3, device="cpu") == 0 and len(opened) == 3


def test_a_trace_with_device_time_is_split_and_unioned(monkeypatch):
    """A kernel for every launch but the pads (some of whose kernels were
    lost) gives the union of the device intervals, the split between the
    flash kernels and the rest, and the first window in profiler_ready; the
    pads and a host range mirrored on the device are left out."""
    from torch.autograd import DeviceType

    events = [*_pads(9), _Event("step", DeviceType.CPU, 0, 100),
              _Event("cudaLaunchKernel", DeviceType.CPU, 1, 2),
              _Event("cuLaunchKernelEx", DeviceType.CPU, 3, 4),
              _Event("cudaMemcpyAsync", DeviceType.CPU, 5, 6),
              _Event("step", DeviceType.CUDA, 0, 100),
              _Event("flash_dq_kernel<float>", DeviceType.CUDA, 10, 30),
              _Event("elementwise", DeviceType.CUDA, 20, 50),
              _Event("Memcpy DtoD (Device -> Device)", DeviceType.CUDA, 60, 70)]
    opened = _fake_profiler(monkeypatch, events)
    assert [ev.name for ev in bench.device_trace(lambda: None)] == [
        "flash_dq_kernel<float>", "elementwise", "Memcpy DtoD (Device -> Device)"]
    assert bench.busy_ms(lambda: None) == pytest.approx(0.05)
    flash, rest, top = bench.device_split(lambda: None)
    assert flash == pytest.approx(0.02) and rest == pytest.approx(0.04)
    assert top == [("elementwise", pytest.approx(0.03)),
                   ("Memcpy DtoD (Device -> Device)", pytest.approx(0.01))]
    opened.clear()
    assert bench.profiler_ready(3, device="cpu") == 1 and len(opened) == 1


def test_smoke_device_times_are_not_measured_without_device_time(monkeypatch, capsys):
    """chip_smoke.py's profiled f32 kernel times read nan, printed as "not
    measured", where the trace does not measure the card; the run goes on."""
    import chip_smoke

    _fake_profiler(monkeypatch, [])
    calls = {name: (lambda: None) for name in ("flash_fwd", "flash_dq", "flash_dkv")}
    got = chip_smoke._device_ms(calls, 384, rounds=2)
    assert list(got) == list(calls) and all(math.isnan(ms) for ms in got.values())
    assert ("trace of the f32 kernels holds no device time: its device time is not measured"
            in capsys.readouterr().out)
    assert chip_smoke._ms_text(float("nan")) == "not measured"
    assert chip_smoke._ms_text(1.23456) == "1.2346 ms"

"""The port's CUDA kernels on the card (marker ``cuda``: they skip without
one; the CPU tests cover the plain versions). Run on a machine with an
NVIDIA Hopper card:

    python -m pytest tests/test_torch_cuda.py -m cuda

Small shapes. Each kernel is held against its plain version on the same
bf16 inputs by chip_smoke.py's rule, ``ray_tpu_torch.bench.disagreement``:
every element within 2^-6 of its value plus 2e-2 of its row's rms, and
the whole within 1e-2 in relative norm (the two round to bf16 at the same
places and sum in other orders); outputs that are zero in exact arithmetic
(at T = 1, dS = P (dP - delta) = 0 up to f32 rounding) within 1e-5. lse,
f32 in both, within 1e-4.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from ray_tpu_torch import bench
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

LSE_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


def _bf16(seed, *shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)


def _close(got, want):
    gap = bench.disagreement(got, want)
    assert gap["ok"], gap


# (BH, Tq, Tk, D, causal): tile-aligned, ragged, a single row, Tk != Tq,
# Tk over more key tiles than the forward's and dQ's rings have stages (they
# wrap), and more causal work units (70 heads x 2) than an H100 has SMs, so
# some persistent blocks take several.
CASES = [(3, 128, 128, 64, True), (2, 65, 65, 16, True), (2, 1, 1, 64, True),
         (3, 100, 37, 64, False), (1, 64, 200, 16, False), (2, 257, 257, 64, False),
         (2, 300, 1100, 64, False), (70, 512, 512, 64, True)]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_kernels_match_plain_versions(cuda, case):
    BH, Tq, Tk, D, causal = case
    q, do = _bf16(0, BH, Tq, D).to(cuda), _bf16(1, BH, Tq, D).to(cuda)
    k, v = _bf16(2, BH, Tk, D).to(cuda), _bf16(3, BH, Tk, D).to(cuda)
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1)
    dq = fa.flash_dq(q, k, v, do, lse_ref, delta, causal)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, causal)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    _close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    dq_ref, dk_ref, dv_ref = fa.flash_bwd_reference(q, k, v, do, lse_ref, delta, causal)
    for got, want in [(dq, dq_ref), (dk, dk_ref), (dv, dv_ref)]:
        _close(got, want)


def test_kernels_are_deterministic(cuda):
    """No atomics: two runs give the same bits."""
    q, k, v, do = (_bf16(i, 4, 192, 64).to(cuda) for i in range(4))
    runs = []
    for _ in range(2):
        o, lse = fa.flash_fwd(q, k, v, True)
        delta = (do.float() * o.float()).sum(-1)
        runs.append([o, lse, fa.flash_dq(q, k, v, do, lse, delta, True),
                     *fa.flash_dkv(q, k, v, do, lse, delta, True)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_attention_autograd_on_card(cuda):
    """[B, T, H, Dh] through the autograd Function on the card against the
    same function on the CPU (plain versions, same bf16 inputs)."""
    B, T, H, D = 2, 96, 3, 64
    xs = [_bf16(10 + i, B, T, H, D) for i in range(4)]
    outs = {}
    for dev in ("cpu", cuda):
        q, k, v = (x.detach().to(dev).requires_grad_() for x in xs[:3])
        out = fa.flash_attention(q, k, v, True)
        out.backward(xs[3].to(dev))
        outs[str(dev)] = [t.detach().cpu() for t in (out, q.grad, k.grad, v.grad)]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        _close(got, want)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = _bf16(0, 2, 64, 64).to(cuda)
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_fwd(x.float(), x.float(), x.float(), True)
    with pytest.raises(ValueError, match="contiguous"):
        y = _bf16(1, 2, 64, 128).to(cuda)[..., :64]
        fa.flash_fwd(y, x, x, True)
    with pytest.raises(ValueError, match="head dim"):
        z = _bf16(2, 2, 64, 32).to(cuda)
        fa.flash_fwd(z, z, z, True)
    with pytest.raises(ValueError, match="several devices"):
        fa.flash_fwd(x, x.cpu(), x, True)


def test_build_is_cached_by_content(cuda):
    lib = _build.load("flash_attention")
    path = _build.library_path("flash_attention")
    assert path.exists() and path.with_name(path.name + ".log").exists()
    assert _build.build("flash_attention") == path
    assert _build.load("flash_attention") is lib


def test_tiny_train_step_on_card(cuda):
    """gpt2-tiny through the kernels on the card: the loss matches the same
    model on the CPU (plain versions) within bf16 rounding, and each kernel
    runs once per layer per step."""
    from ray_tpu_torch.models import gpt2

    cfg = dataclasses.replace(gpt2.CONFIGS["gpt2-tiny"], attn_impl="flash", loss_impl="fused")
    cpu_model = gpt2.init(torch.Generator().manual_seed(0), cfg, "cpu")
    model = gpt2.GPT2(cfg, cuda)
    model.load_state_dict(cpu_model.state_dict())
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 65), dtype=np.int32)
    with torch.no_grad():
        want = gpt2.loss_fn(cpu_model, torch.from_numpy(tokens)).item()
    step = gpt2.make_train_step(model, torch.optim.AdamW(model.parameters(), lr=3e-4,
                                                         weight_decay=0.01))
    before = dict(fa.launches)
    losses = [step(tokens).item() for _ in range(2)]
    assert all(np.isfinite(losses))
    assert abs(losses[0] - want) <= 1e-2
    assert {n: fa.launches[n] - before[n] for n in before} == {
        n: 2 * cfg.n_layer for n in before}


def test_serving_engine_on_card(cuda, monkeypatch, tmp_path):
    """A few requests through the paged engine on the card (gpt2-tiny in
    f32, four at once, one streaming): each answer equals the same engine's
    on the CPU with the same weights (a checkpoint both load; the CPU and
    CUDA generators draw different inits), the pool drains to its sealed
    prefix pages, and serving launches none of the flash kernels."""
    import pickle

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve.llm import LLMConfig, LLMServer

    monkeypatch.setitem(gpt2.CONFIGS, "gpt2-tiny", dataclasses.replace(
        gpt2.CONFIGS["gpt2-tiny"], dtype=torch.float32))
    ckpt = tmp_path / "gpt2_tiny.pkl"
    weights = gpt2.init(torch.Generator().manual_seed(0), gpt2.CONFIGS["gpt2-tiny"], "cpu")
    ckpt.write_bytes(pickle.dumps(gpt2.to_jax(weights)))
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, 256, n)] for n in (10, 64, 100, 70)]
    answers = {}
    before = dict(fa.launches)
    for dev in ("cpu", "cuda"):
        srv = LLMServer(LLMConfig(model_id="gpt2-tiny", max_batch_size=4, device=dev,
                                  checkpoint_path=str(ckpt)))
        try:
            assert srv.model.wte.device.type == dev
            out = [None] * len(prompts)

            def call(i):
                req = {"prompt_tokens": prompts[i], "max_new_tokens": 12, "stream": i == 3}
                res = srv(req)
                out[i] = [ev["token"] for ev in res] if i == 3 else res["tokens"]

            threads = [threading.Thread(target=call, args=(i,)) for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
            answers[dev] = out
            st = srv.batch_stats()["prefix"]
            assert st["pages_occupied"] == st["prefix_resident"]
        finally:
            srv.unload()
            srv._thread.join(timeout=30)
    assert answers["cuda"] == answers["cpu"]
    assert all(len(a) == 12 for a in answers["cuda"])
    assert dict(fa.launches) == before


# Ring attention's f32 block entries, the emulated and the distributed ring,
# and the MoE block (ops/flash_attention.py, ops/ring_attention.py,
# ops/moe.py).


@pytest.mark.parametrize("case", [(2, 256, 256, 3, 64, True), (2, 200, 333, 2, 16, False)], ids=str)
def test_f32_block_entries_match_plain_versions(cuda, case):
    """flash_fwd_block / flash_bwd_block (the f32 instantiations) against the
    plain versions' f32 outputs; one f32 launch of each kernel."""
    B, Tq, Tk, H, D, causal = case
    q, do = _bf16(20, B, Tq, H, D).to(cuda), _bf16(21, B, Tq, H, D).to(cuda)
    k, v = _bf16(22, B, Tk, H, D).to(cuda), _bf16(23, B, Tk, H, D).to(cuda)
    before = dict(fa.launches_f32)
    o, lse = fa.flash_fwd_block(q, k, v, causal)
    qf, kf, vf, dof = (fa._fold(x) for x in (q, k, v, do))
    o_ref, lse_ref = fa.flash_fwd_reference(qf, kf, vf, causal, out_f32=True)
    delta = (dof.float() * o_ref.to(torch.bfloat16).float()).sum(-1)
    grads = fa.flash_bwd_block(q, k, v, do, lse_ref, delta, causal)
    refs = fa.flash_bwd_reference(qf, kf, vf, dof, lse_ref, delta, causal, out_f32=True)
    torch.cuda.synchronize()
    assert {n: fa.launches_f32[n] - before[n] for n in before} == dict.fromkeys(before, 1)
    assert o.dtype == torch.float32
    _close(fa._fold(o), o_ref)
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    for got, want in zip(grads, refs):
        assert got.dtype == torch.float32
        _close(fa._fold(got), want)


def test_emulated_ring_on_card(cuda):
    """4 ranks emulated on the card against the monolithic flash attention;
    every visible block (4 diagonal + 6 earlier) through the f32 kernels."""
    from ray_tpu_torch.ops.ring_attention import ring_attention_emulated

    x = {n: _bf16(30 + i, 2, 512, 3, 64).to(cuda) for i, n in enumerate(("q", "k", "v", "do"))}
    before = dict(fa.launches_f32)
    res = ring_attention_emulated(*(list(x[n].chunk(4, dim=1)) for n in ("q", "k", "v", "do")))
    torch.cuda.synchronize()
    assert {n: fa.launches_f32[n] - before[n] for n in before} == dict.fromkeys(before, 10)
    q, k, v = (x[n].clone().requires_grad_() for n in ("q", "k", "v"))
    out = fa.flash_attention(q, k, v, True)
    out.backward(x["do"])
    for parts, want in zip(res, (out, q.grad, k.grad, v.grad)):
        _close(torch.cat(parts, dim=1), want)


def test_ring_and_moe_on_a_group_of_one(cuda, tmp_path):
    """attention(impl="ring") and moe_block on an NCCL group of this card
    alone: the ring is one causal f32 block (the flash kernels' answer), the
    MoE exchanges are copies (moe_block_local's answer)."""
    import torch.distributed as dist

    from ray_tpu_torch.ops.attention import attention
    from ray_tpu_torch.ops.moe import moe_block, moe_block_local

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        xs = [_bf16(40 + i, 2, 256, 3, 64).to(cuda) for i in range(4)]
        outs = {}
        for impl, kw in (("ring", {"group": group}), ("flash", {})):
            q, k, v = (x.clone().requires_grad_() for x in xs[:3])
            out = attention(q, k, v, causal=True, impl=impl, **kw)
            out.backward(xs[3])
            outs[impl] = (out, q.grad, k.grad, v.grad)
        for got, want in zip(outs["ring"], outs["flash"]):
            _close(got, want)

        rng = np.random.default_rng(5)
        args = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * sc).to(cuda)
                for s, sc in (((64, 32), 1.0), ((32, 8), 0.1), ((8, 32, 64), 0.1), ((8, 64, 32), 0.1))]
        res = {}
        for name, fn in (("ep", lambda *a: moe_block(*a, 20, group)),
                         ("local", lambda *a: moe_block_local(*a, 20))):
            leaves = [a.clone().requires_grad_() for a in args]
            out = fn(*leaves)
            (out ** 2).sum().backward()
            res[name] = [out] + [t.grad for t in leaves]
        for got, want in zip(res["ep"], res["local"]):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    finally:
        dist.destroy_process_group()

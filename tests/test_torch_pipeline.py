"""The port's pipeline parallelism (``ray_tpu_torch.parallel.pipeline``)
against the JAX package's, on one module-scoped port cluster on the CPU.

The contracts of ``tests/test_pipeline.py``, re-run on the port: the
schedules (compared with the JAX package's own functions), the two-stage
MLP of that file held to its JAX ``_reference_step`` under the RPC tier and
the compiled tier (shm and RPC channels), GPipe and 1F1B, 1F1B bitwise equal
to GPipe; AdamW from a torch optimizer factory against ``optax.adamw``; the
chaos test; the RPC mailbox. Then gpt2-tiny in two stages (the split
``chip_smoke.py`` phase 8 runs at gpt2-small) against
``ray_tpu.models.gpt2.loss_fn`` under ``jax.value_and_grad``. Both sides
run in f32 on the same numpy inputs.

The wall-clock ratio of ``test_dag.py::test_compiled_path_beats_rpc_path``
is not asserted here: ``chip_smoke.py`` prints it on the card.

The JAX package's modules are imported inside the functions that use
them, never as globals of this module: the port's ``dumps_function``
registers a stage function's module, and the modules its globals name,
for pickling by value (every package but its own counts as user code), and
the JAX runtime in the same process would inherit that registration.
``test_the_jax_package_is_not_registered_by_value`` holds that.
"""

import dataclasses
import functools
import os
import pickle
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import cloudpickle
import jax
import jax.numpy as jnp
import optax

import ray_tpu_torch
from ray_tpu_torch.core import cluster_utils
from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.parallel import pipeline as pp
from ray_tpu_torch.parallel.pipeline import HostTensor, Pipeline
from ray_tpu_torch.utils import serialization
from ray_tpu_torch.utils.config import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_MB, LR = 4, 0.1
# f32 on both sides; the frameworks sum in other orders (gaps ~1e-7)
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
GPT_RELNORM = 1e-4


@pytest.fixture(scope="module")
def rt():
    cluster_utils.sweep_stale_runtime()
    # the stage processes inherit it: their torch on one intra-op thread
    # each, as several run at once beside the other test files
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ray_tpu_torch.init(num_cpus=4)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


# -- the schedules and the wire format: no cluster ---------------------------


def test_schedules_match_the_jax_package():
    from ray_tpu.parallel import pipeline as jax_pipeline

    assert pp.SCHEDULES == jax_pipeline.SCHEDULES
    for schedule in pp.SCHEDULES:
        for n_stages in (1, 2, 3, 4):
            for n_mb in (1, 2, 3, 8):
                for stage in range(n_stages):
                    args = (schedule, n_stages, stage, n_mb)
                    assert pp._schedule_ops(*args) == jax_pipeline._schedule_ops(*args), args
                    assert (pp._max_live_activations(*args)
                            == jax_pipeline._max_live_activations(*args)), args
    assert pp._max_live_activations("1f1b", 4, 0, 8) == 4
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        pp._schedule_ops("pipedream", 2, 0, 4)


def test_the_parallel_package_does_not_import_the_pipeline():
    """As in the JAX package, a user imports the pipeline module by name."""
    code = ("import sys, ray_tpu_torch.parallel; "
            "assert 'ray_tpu_torch.parallel.pipeline' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64])
def test_host_tensor_round_trip_out_of_band(dtype):
    """A tensor crosses as a host array (bf16 as its uint16 bits) whose
    buffer pickle-5 carries out of band: the in-band part is a small header,
    and the values come back bit for bit."""
    t = (torch.randn(4, 33, 16) * 100).to(dtype)
    bits = (lambda x: x.view(torch.int16)) if dtype == torch.bfloat16 else (lambda x: x)
    h = HostTensor.of(t)
    assert h.dtype == str(dtype).removeprefix("torch.")
    if dtype == torch.bfloat16:
        assert h.array.dtype == np.uint16
    meta, views = serialization.serialize(h)
    assert [v.nbytes for v in views] == [t.numel() * t.element_size()]
    assert len(meta) < 512
    back = serialization.unpack(serialization.pack(h))
    got = back.to("cpu")
    assert got.dtype == dtype and torch.equal(bits(got), bits(t))
    np.testing.assert_array_equal(np.asarray(back), t.float().numpy() if dtype ==
                                  torch.bfloat16 else t.numpy())
    assert torch.equal(bits(pickle.loads(pickle.dumps(h)).to("cpu")), bits(t))


def test_host_tensor_from_an_unaligned_read_only_buffer():
    """What a channel slot gives back: a read-only buffer at an odd offset."""
    t = torch.randn(3, 5).to(torch.bfloat16)
    raw = bytes(1) + t.view(torch.int16).numpy().tobytes()
    arr = np.frombuffer(raw, dtype=np.uint16, offset=1).reshape(3, 5)
    assert not arr.flags.writeable
    got = HostTensor(arr, "bfloat16").to("cpu")
    assert torch.equal(got.view(torch.int16), t.view(torch.int16))
    got += 1  # a copy: the received buffer is untouched
    assert np.frombuffer(raw, dtype=np.uint16, offset=1).reshape(3, 5).tobytes() == arr.tobytes()


def test_rpc_mailbox_semantics():
    """RpcChannel receiver mailbox: bounded, idempotent per seq, and closed
    stays closed."""
    from ray_tpu_torch.core import channels as channels_mod
    from ray_tpu_torch.core.channels import close_rpc_mailbox, rpc_channel_deliver

    cid = "rttchan_test_mailbox"
    assert rpc_channel_deliver(cid, 1, b"a", 2)["status"] == "ok"
    assert rpc_channel_deliver(cid, 1, b"a", 2)["status"] == "ok"  # dup
    assert rpc_channel_deliver(cid, 2, b"b", 2)["status"] == "ok"
    assert rpc_channel_deliver(cid, 3, b"c", 2)["status"] == "full"
    mb = channels_mod._mailbox(cid, 2)
    with mb.cv:
        mb.q.popleft()
        mb.consumed += 1
    assert rpc_channel_deliver(cid, 3, b"c", 2)["status"] == "ok"
    close_rpc_mailbox(cid)
    assert rpc_channel_deliver(cid, 4, b"d", 2)["status"] == "closed"
    close_rpc_mailbox(cid)  # idempotent


# -- the two-stage MLP of tests/test_pipeline.py ---------------------------


def _mlp_stage1(params, x):
    return torch.tanh(x @ params["w"])


def _mlp_stage2(params, h):
    return h @ params["w"]


def _mse(pred, target):
    return torch.mean((pred - target) ** 2)


# (tier, schedule); "compiled-rpc" forces every edge onto the RpcChannel tier
MLP_RUNS = [("rpc", "gpipe"), ("compiled", "gpipe"), ("compiled", "1f1b"),
            ("compiled-rpc", "1f1b")]


def _train(pipe, tier, schedule, batches, lr, steps):
    """``steps`` steps on ``batches`` (microbatches, targets); returns the
    losses and every stage's parameters after each step."""
    losses, params = [], []
    if tier == "rpc":
        for _ in range(steps):
            losses.append(pipe.train_step(*batches, lr=lr))
            params.append(pipe.get_params())
        return losses, params
    config.set("pipeline_force_rpc_channels", tier == "compiled-rpc")
    try:
        cp = pipe.compile(schedule=schedule, step_timeout_s=60.0)
    finally:
        config.set("pipeline_force_rpc_channels", False)
    try:
        assert bool(cp._shm_channels) == (tier == "compiled")
        for _ in range(steps):
            losses.append(cp.train_step(*batches, lr=lr))
            params.append(cp.get_params())
    finally:
        cp.teardown(timeout_s=30.0)
    return losses, params


@pytest.fixture(scope="module")
def mlp_runs(rt):
    """Two SGD steps of each (tier, schedule) from the same init."""
    from test_pipeline import _two_stage_problem

    W1, W2, X, Y, *_ = _two_stage_problem()
    batches = (list(np.split(X, N_MB)), list(np.split(Y, N_MB)))
    runs = {}
    for tier, schedule in MLP_RUNS:
        pipe = Pipeline([_mlp_stage1, _mlp_stage2], [{"w": W1}, {"w": W2}], _mse,
                        device="cpu")
        try:
            runs[tier, schedule] = _train(pipe, tier, schedule, batches, LR, 2)
        finally:
            pipe.shutdown()
    return runs


@pytest.mark.parametrize("tier,schedule", MLP_RUNS, ids=lambda v: v)
def test_mlp_matches_the_jax_reference_step(mlp_runs, tier, schedule):
    from test_pipeline import _reference_step, _two_stage_problem

    W1, W2, X, Y, *_ = _two_stage_problem()
    losses, params = mlp_runs[tier, schedule]
    want = {"w1": W1, "w2": W2}
    for step in range(2):
        ref_params, ref_loss = _reference_step(want["w1"], want["w2"], X, Y, LR, N_MB)
        want = {k: np.asarray(v) for k, v in ref_params.items()}
        assert abs(losses[step] - ref_loss) <= LOSS_RTOL * abs(ref_loss), (step, losses)
        for got, name in zip(params[step], ("w1", "w2")):
            np.testing.assert_allclose(got["w"], want[name], rtol=PARAM_RTOL, atol=PARAM_ATOL)
    assert losses[1] < losses[0]


def test_mlp_1f1b_and_every_tier_bitwise_equal_gpipe(mlp_runs):
    """The same microbatches in the same backward order: every tier and
    schedule gives GPipe's losses and parameters bit for bit."""
    g_losses, g_params = mlp_runs["compiled", "gpipe"]
    for key, (losses, params) in mlp_runs.items():
        assert losses == g_losses, key
        for step_g, step in zip(g_params, params):
            for a, b in zip(step_g, step):
                np.testing.assert_array_equal(a["w"], b["w"], err_msg=str(key))


def test_mlp_adamw_factory_matches_optax(rt):
    """A torch optimizer built once in each stage from a factory, against
    optax.adamw at the same hyperparameters on the same mean gradients."""
    from test_pipeline import _two_stage_problem

    W1, W2, X, Y, *_ = _two_stage_problem()
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
    factory = functools.partial(torch.optim.AdamW, lr=0.01, betas=(hyper["b1"], hyper["b2"]),
                                eps=hyper["eps"], weight_decay=hyper["weight_decay"])
    pipe = Pipeline([_mlp_stage1, _mlp_stage2], [{"w": W1}, {"w": W2}], _mse,
                    optimizer=factory, device="cpu")
    try:  # an lr the optimizer must ignore, as optax's update does
        losses, params = _train(pipe, "compiled", "1f1b",
                                (list(np.split(X, N_MB)), list(np.split(Y, N_MB))), 123.0, 2)
    finally:
        pipe.shutdown()

    def full_loss(p, x, y):
        return jnp.mean((jnp.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2)

    opt = optax.adamw(0.01, **hyper)
    p = {"w1": jnp.asarray(W1), "w2": jnp.asarray(W2)}
    state = opt.init(p)
    for step in range(2):
        outs = [jax.value_and_grad(full_loss)(p, x, y)
                for x, y in zip(np.split(X, N_MB), np.split(Y, N_MB))]
        ref_loss = sum(float(loss) for loss, _ in outs) / N_MB
        grads = jax.tree.map(lambda *g: sum(g[1:], g[0]) / N_MB, *[g for _, g in outs])
        updates, state = opt.update(grads, state, p)
        p = optax.apply_updates(p, updates)
        assert abs(losses[step] - ref_loss) <= LOSS_RTOL * abs(ref_loss)
        for got, name in zip(params[step], ("w1", "w2")):
            np.testing.assert_allclose(got["w"], np.asarray(p[name]), rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=f"step {step} {name}")


def test_compiled_pipeline_chaos_sigkill_mid_step(rt):
    """SIGKILL a mid-pipeline stage during a 1F1B step: the driver raises
    within the step deadline, the pipeline refuses further steps, and
    teardown still reclaims every channel."""
    rng = np.random.default_rng(1)
    Ws = [rng.normal(size=(8, 8)).astype(np.float32) * 0.3 for _ in range(3)]
    X = rng.normal(size=(32, 8)).astype(np.float32)
    Y = rng.normal(size=(32, 8)).astype(np.float32)

    def slow_stage(params, x):
        time.sleep(0.05)  # stretch the step so the kill lands mid-step
        return torch.tanh(x @ params["w"])

    pipe = Pipeline([slow_stage] * 3, [{"w": w} for w in Ws], _mse, device="cpu")
    victim_pid = rt.get(pipe.stages[1].pid.remote(), timeout=60)
    cp = pipe.compile(schedule="1f1b", step_timeout_s=8.0)
    shm_paths = [ch.path for ch in cp._shm_channels]
    assert shm_paths and all(os.path.basename(p).startswith("rttchan_") for p in shm_paths)
    killer = threading.Timer(0.3, lambda: os.kill(victim_pid, signal.SIGKILL))
    killer.start()
    t0 = time.monotonic()
    try:
        with pytest.raises(Exception):
            cp.train_step(list(np.split(X, 8)), list(np.split(Y, 8)), lr=0.1)
        assert time.monotonic() - t0 < 20.0
        with pytest.raises(RuntimeError, match="broken"):
            cp.train_step(list(np.split(X, 8)), list(np.split(Y, 8)))
    finally:
        killer.cancel()
        cp.teardown(timeout_s=15.0)
        pipe.shutdown()
    for p in shm_paths:
        assert not os.path.exists(p), f"teardown leaked {p}"
        assert not os.path.exists(p + ".d")


# -- gpt2-tiny in two stages: chip_smoke.py phase 8's stage functions ---------

B, T, N_LAYER, SPLIT = 8, 32, 4, 2
GPT_LR = 1.0  # (p - p') / lr recovers the tied gradient well above wte's f32 rounding


def _flat_port_names(params_np, n_layer):
    out = {}
    for name, arr in tg._flatten(params_np):
        if name.startswith("blocks."):
            for i in range(n_layer):
                out[f"blocks.{i}.{name[len('blocks.'):]}"] = np.asarray(arr[i])
        else:
            out[name] = np.asarray(arr)
    return out


@pytest.fixture(scope="module")
def gpt2_case(cpu_mesh_devices):
    from ray_tpu.models import gpt2 as jg

    jcfg = dataclasses.replace(jg.CONFIGS["gpt2-tiny"], n_layer=N_LAYER, dtype=jnp.float32,
                               attn_impl="reference")
    params = jax.tree.map(np.asarray, jg.init(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, T + 1), dtype=np.int32)
    mbs = np.split(tokens, N_MB)
    loss_and_grad = jax.jit(jax.value_and_grad(jg.loss_fn), static_argnums=2)
    outs = [loss_and_grad(params, mb, jcfg) for mb in mbs]
    loss = sum(float(v) for v, _ in outs) / N_MB
    grads = jax.tree.map(lambda *g: sum(g[1:], g[0]) / N_MB, *[g for _, g in outs])
    return (_flat_port_names(params, N_LAYER), mbs, loss,
            _flat_port_names(jax.tree.map(np.asarray, grads), N_LAYER))


@pytest.fixture(scope="module")
def gpt2_runs(rt, gpt2_case):
    """One SGD step of gpt2-tiny in chip_smoke.py phase 8's two stages (its
    stage functions: flash attention and the fused CE, their plain versions
    here) under compiled GPipe and 1F1B."""
    import chip_smoke

    flat, mbs, _, _ = gpt2_case
    tcfg = dataclasses.replace(tg.CONFIGS["gpt2-tiny"], n_layer=N_LAYER, dtype=torch.float32,
                               attn_impl="flash", loss_impl="fused")
    stage0, stage1, loss = chip_smoke.pipeline_stage_fns(tcfg, SPLIT)
    runs, out = {}, None
    for schedule in ("gpipe", "1f1b"):
        pipe = Pipeline([stage0, stage1], chip_smoke.split_stage_params(flat, SPLIT), loss,
                        device="cpu")
        try:
            runs[schedule] = _train(pipe, "compiled", schedule,
                                    (mbs, [mb[:, 1:] for mb in mbs]), GPT_LR, 1)
            if out is None:
                out = pipe.forward(mbs[0])  # the parameters after the step
        finally:
            pipe.shutdown()
    return runs, out


def _relnorm(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_gpt2_two_stages_match_jax(gpt2_case, gpt2_runs):
    """The mean loss over the microbatches, every untied parameter after the
    SGD step, and the two wte copies' steps summed into the tied gradient,
    against JAX on the same microbatches."""
    flat, _, ref_loss, ref_grads = gpt2_case
    losses, params = gpt2_runs[0]["gpipe"]
    assert abs(losses[0] - ref_loss) <= LOSS_RTOL * abs(ref_loss)
    got = {**params[0][0], **params[0][1]}
    step = {n: (flat[n if n != "head" else "wte"] - p) / GPT_LR for n, p in got.items()}
    for name, p in got.items():
        if name in ("wte", "head"):
            continue
        want_p = flat[name] - GPT_LR * ref_grads[name]
        assert _relnorm(p, want_p) <= GPT_RELNORM, name
        # the step alone, so a small gradient on a large parameter (a
        # LayerNorm scale near 1) is held too: to GPT_RELNORM, above the f32
        # rounding of p - lr * g, half an ulp of p' an element
        rounding = np.linalg.norm(np.spacing(p)) / 2 / GPT_LR
        gap = np.linalg.norm(step[name] - ref_grads[name])
        assert gap <= GPT_RELNORM * np.linalg.norm(ref_grads[name]) + rounding, name
    tied = step["wte"] + step["head"]
    assert _relnorm(tied, ref_grads["wte"]) <= GPT_RELNORM
    # each copy alone is not the tied gradient: the sum is what matches
    assert _relnorm(step["head"], ref_grads["wte"]) > 10 * GPT_RELNORM


def test_gpt2_1f1b_bitwise_equals_gpipe(gpt2_runs):
    runs, _ = gpt2_runs
    assert runs["1f1b"][0] == runs["gpipe"][0]
    for a, b in zip(runs["gpipe"][1][0], runs["1f1b"][1][0]):
        assert a.keys() == b.keys()
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_gpt2_pipeline_forward_is_the_backbone(gpt2_case, gpt2_runs):
    """Inference through both stages (predict, no graph kept) equals the
    unsharded JAX backbone on the stages' parameters after the step."""
    from ray_tpu.models import gpt2 as jg

    _, params = gpt2_runs[0]["gpipe"]
    _, mbs, _, _ = gpt2_case
    got = {**params[0][0], **params[0][1]}
    jcfg = dataclasses.replace(jg.CONFIGS["gpt2-tiny"], n_layer=N_LAYER, dtype=jnp.float32,
                               attn_impl="reference")
    jp = {"wte": got["wte"], "wpe": got["wpe"],
          "ln_f": {"scale": got["ln_f.scale"], "bias": got["ln_f.bias"]}, "blocks": {}}
    for name in {k.split(".", 2)[2] for k in got if k.startswith("blocks.")}:
        tg._set(jp["blocks"], name, np.stack([got[f"blocks.{i}.{name}"]
                                              for i in range(N_LAYER)]))
    want = np.asarray(jg.backbone(jp, mbs[0][:, :-1], jcfg))
    out = np.asarray(gpt2_runs[1])
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)


def test_the_jax_package_is_not_registered_by_value(mlp_runs, gpt2_runs):
    """After the port pickled this module's stage functions (and the
    smoke's), cloudpickle still pickles the JAX package by reference, as the
    JAX runtime's tests in this process need."""
    assert not [m for m in cloudpickle.list_registry_pickle_by_value()
                if m == "ray_tpu" or m.startswith("ray_tpu.") or m == "test_pipeline"]

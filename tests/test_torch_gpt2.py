"""The port's GPT-2 against the JAX package's, on gpt2-tiny.

The JAX parameters (``gpt2.init``) are carried into the port by
``from_jax`` through numpy; tokens come from a seeded numpy generator. The
f32 legs (``dtype=float32`` on both sides) hold the port to the JAX model
to float rounding; the JAX flash kernel runs in Pallas interpret mode, the
port's through its plain versions (CPU tensors). The bf16 and f16 legs have
looser tolerances, stated where they are used.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.models import gpt2 as jg
from ray_tpu_torch.models import gpt2 as tg

B, T = 2, 64
LOSS_CHUNK = 24  # chunked: 24 + 24 + a remainder of 16; fused: 2 chunks of 32

# f32: the two frameworks sum in other orders; the measured gaps are ~1e-7.
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _cfgs(dtype="f32", **kw):
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
              "f16": (jnp.float16, torch.float16)}[dtype]
    kw.setdefault("loss_chunk", LOSS_CHUNK)
    return (dataclasses.replace(jg.CONFIGS["gpt2-tiny"], dtype=jd, **kw),
            dataclasses.replace(tg.CONFIGS["gpt2-tiny"], dtype=td, **kw))


@pytest.fixture(scope="module")
def jax_params(cpu_mesh_devices):
    jcfg, _ = _cfgs()
    return jg.init(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def params_np(jax_params):
    return jax.tree.map(np.asarray, jax_params)


def _tokens(seed, n=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (B, T + 1), dtype=np.int32) for _ in range(n)]


def _leaves_close(got, want, rtol, atol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0], jax.tree.leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_configs_match_jax():
    for name, jcfg in jg.CONFIGS.items():
        tcfg = tg.CONFIGS[name]
        for field in ("vocab_size", "n_positions", "d_model", "n_layer", "n_head", "remat",
                      "remat_policy", "loss_chunk", "loss_impl", "attn_impl", "head_dim",
                      "padded_vocab", "d_ff"):
            assert getattr(tcfg, field) == getattr(jcfg, field), (name, field)
        assert tcfg.num_params() == jcfg.num_params()
        assert tcfg.dtype == torch.bfloat16 and tcfg.param_dtype == torch.float32


def test_config_rejects_what_is_not_ported():
    cfg = tg.CONFIGS["gpt2-tiny"]
    for knob in ("loss_impl", "remat_policy"):
        with pytest.raises(ValueError):
            dataclasses.replace(cfg, **{knob: "bogus"})
    for knob in ("scan_unroll", "cp_axis"):  # not ported
        with pytest.raises(TypeError):
            dataclasses.replace(cfg, **{knob: 2})
    model = tg.GPT2(dataclasses.replace(cfg, attn_impl="ring"), "cpu")
    with pytest.raises(NotImplementedError, match="ring"):
        model(torch.zeros(1, 8, dtype=torch.long))


def test_from_jax_round_trip(params_np):
    _, tcfg = _cfgs()
    back = tg.to_jax(tg.from_jax(params_np, tcfg, "cpu"))
    _leaves_close(back, params_np, 0, 0)


def test_init_matches_jax_scales(jax_params):
    """Same leaves, shapes and scales as the JAX init (random draws differ:
    the generators do); the same seed gives the same model."""
    cfg = tg.CONFIGS["gpt2-tiny"]
    a = tg.to_jax(tg.init(torch.Generator().manual_seed(0), cfg, "cpu"))
    b = tg.to_jax(tg.init(torch.Generator().manual_seed(0), cfg, "cpu"))
    _leaves_close(a, b, 0, 0)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jax_params)[0],
                                 jax.tree.leaves(a)):
        want = np.asarray(want)
        assert got.shape == want.shape, jax.tree_util.keystr(path)
        assert abs(got.mean() - want.mean()) < 2e-3, jax.tree_util.keystr(path)
        # ~8k+ draws per random leaf: the std estimate is within ~1.5%
        np.testing.assert_allclose(got.std(), want.std(), rtol=0.05, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_logits_match_jax(jax_params, params_np, attn_impl):
    jcfg, tcfg = _cfgs(attn_impl=attn_impl)
    (tok,) = _tokens(0)
    want = np.asarray(jg.forward(jax_params, jnp.asarray(tok[:, :-1]), jcfg))
    model = tg.from_jax(params_np, tcfg, "cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(tok[:, :-1]).long()).numpy()
    assert got.shape == (B, T, tcfg.padded_vocab) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _loss_and_grads(jax_params, params_np, tok, jcfg, tcfg):
    loss_j, grads_j = jax.value_and_grad(jg.loss_fn)(jax_params, jnp.asarray(tok), jcfg)
    model = tg.from_jax(params_np, tcfg, "cpu")
    loss_t = tg.loss_fn(model, torch.from_numpy(tok))
    loss_t.backward()
    return float(loss_j), grads_j, loss_t.item(), tg.to_jax(model, grads=True)


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
@pytest.mark.parametrize("loss_impl", ["chunked", "fused"])
def test_loss_and_grads_match_jax(jax_params, params_np, loss_impl, attn_impl):
    jcfg, tcfg = _cfgs(loss_impl=loss_impl, attn_impl=attn_impl)
    (tok,) = _tokens(1)
    loss_j, grads_j, loss_t, grads_t = _loss_and_grads(jax_params, params_np, tok, jcfg, tcfg)
    assert abs(loss_t - loss_j) <= LOSS_TOL * abs(loss_j)
    _leaves_close(grads_t, grads_j, GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("loss_chunk", [0, 200])
def test_unchunked_loss_matches_jax(jax_params, params_np, loss_chunk):
    """loss_chunk 0 (chunking off) and a chunk longer than T: one chunk."""
    jcfg, tcfg = _cfgs(loss_chunk=loss_chunk)
    (tok,) = _tokens(2)
    loss_j, grads_j, loss_t, grads_t = _loss_and_grads(jax_params, params_np, tok, jcfg, tcfg)
    assert abs(loss_t - loss_j) <= LOSS_TOL * abs(loss_j)
    _leaves_close(grads_t, grads_j, GRAD_RTOL, GRAD_ATOL)


def test_remat_matches_jax(jax_params, params_np):
    """remat=True (each block recomputed in the backward) changes nothing."""
    jcfg, tcfg = _cfgs(remat=True, loss_impl="fused", attn_impl="flash")
    (tok,) = _tokens(3)
    loss_j, grads_j, loss_t, grads_t = _loss_and_grads(jax_params, params_np, tok, jcfg, tcfg)
    assert abs(loss_t - loss_j) <= LOSS_TOL * abs(loss_j)
    _leaves_close(grads_t, grads_j, GRAD_RTOL, GRAD_ATOL)


POLICIES = ["full", "dots", "dots_saveable", "attn_out"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_matches_jax(jax_params, params_np, policy, dtype):
    """Each remat policy on both sides (flash attention, fused CE): the
    loss and every gradient of the JAX model under the same policy, at the
    tolerances of test_loss_and_grads_match_jax (f32) and
    test_bf16_matches_jax (bf16)."""
    jcfg, tcfg = _cfgs(dtype, remat=True, remat_policy=policy, loss_impl="fused",
                       attn_impl="flash")
    (tok,) = _tokens(6)
    loss_j, grads_j, loss_t, grads_t = _loss_and_grads(jax_params, params_np, tok, jcfg, tcfg)
    if dtype == "f32":
        assert abs(loss_t - loss_j) <= LOSS_TOL * abs(loss_j)
        _leaves_close(grads_t, grads_j, GRAD_RTOL, GRAD_ATOL)
        return
    assert math.isfinite(loss_t) and abs(loss_t - loss_j) <= 1e-3
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(grads_j)[0],
                                 jax.tree.leaves(grads_t)):
        want = np.asarray(want, dtype=np.float32)
        err = np.abs(got - want).max()
        assert err <= 5e-2 * np.abs(want).max(), (jax.tree_util.keystr(path), err)


def _jax_kept_per_layer(jax_params, tok, jcfg):
    """(dtype, size) of each activation JAX keeps per layer for the
    backward: the residuals the layer scan stacks (print_saved_residuals),
    less their layer axis."""
    import contextlib
    import io
    import re

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax.ad_checkpoint.print_saved_residuals(
            lambda p: jg.loss_fn(p, jnp.asarray(tok), jcfg), jax_params)
    kept = []
    for line in out.getvalue().splitlines():
        found = re.match(r"(\w+)\[([\d,]*)\] output of scan .*\(backbone\)", line)
        if found:
            shape = [int(n) for n in found[2].split(",")]
            assert shape[0] == jcfg.n_layer, line
            kept.append((found[1], math.prod(shape[1:])))
    return sorted(kept)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_keeps_what_jax_keeps(jax_params, params_np, monkeypatch, policy):
    """What each layer keeps for the backward under each policy (bf16,
    flash attention): the layer input x, which checkpoint holds, and the
    outputs the selective policy keeps in the forward. Held to the JAX
    model's residuals under the same policy, by dtype and size (the port's
    products are [B*T, N] matrices where JAX's are [B, T, ...]): x alone
    under "full"; x and the qkv, proj and fc_in products under "dots";
    those and the attention output under "dots_saveable"; x and the
    attention output under "attn_out"."""
    from torch.utils.checkpoint import CheckpointPolicy

    jcfg, tcfg = _cfgs("bf16", remat=True, remat_policy=policy, loss_impl="fused",
                       attn_impl="flash")
    (tok,) = _tokens(7)
    names = {torch.bfloat16: "bf16", torch.float32: "f32"}
    regions = []

    class Recording(tg._KeepPolicy):
        def __init__(self, name):
            super().__init__(name)
            self.kept = []
            regions.append(self.kept)

        def __call__(self, ctx, op, *args, **kwargs):
            decision = super().__call__(ctx, op, *args, **kwargs)
            if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                a = args[0]
                size = a.shape[0] * args[1].shape[1] if op is torch.ops.aten.mm.default else a.numel()
                self.kept.append((names[a.dtype], size))
            return decision

    monkeypatch.setattr(tg, "_KeepPolicy", Recording)
    model = tg.from_jax(params_np, tcfg, "cpu")
    tg.loss_fn(model, torch.from_numpy(tok)).backward()
    assert len(regions) == (0 if policy == "full" else tcfg.n_layer)
    x = (names[tcfg.dtype], B * T * tcfg.d_model)  # the layer input
    want = _jax_kept_per_layer(jax_params, tok, jcfg)
    for kept in regions or [[]] * tcfg.n_layer:
        assert sorted([x] + kept) == want, (policy, kept, want)


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_train_steps_match_optax(jax_params, params_np, attn_impl):
    """3 steps of torch.optim.AdamW against 3 jitted optax adamw steps
    (lr 3e-4, weight decay 0.01: bench.py's optimizer).

    Parameter tolerance: Adam divides by sqrt(v) + 1e-8, so an element whose
    gradient is near zero turns a 1e-7 gap in the gradient into a gap of up
    to a whole step (lr = 3e-4) in the update. Measured gaps are ~4e-6
    after 3 steps; atol 3e-5 is a tenth of one step's lr."""
    jcfg, tcfg = _cfgs(loss_impl="fused", attn_impl=attn_impl)
    opt = optax.adamw(3e-4, weight_decay=0.01)
    state = opt.init(jax_params)
    step_j = jax.jit(jg.make_train_step(jcfg, opt))
    model = tg.from_jax(params_np, tcfg, "cpu")
    step_t = tg.make_train_step(
        model, torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                                 betas=(0.9, 0.999), eps=1e-8))
    params = jax_params
    for tok in _tokens(4, n=3):
        params, state, loss_j = step_j(params, state, jnp.asarray(tok))
        loss_t = step_t(tok)  # numpy tokens are taken as they are
        assert abs(loss_t.item() - float(loss_j)) <= LOSS_TOL * abs(float(loss_j))
    _leaves_close(tg.to_jax(model), params, 1e-5, 3e-5)


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
@pytest.mark.parametrize("loss_impl", ["chunked", "fused"])
def test_bf16_matches_jax(jax_params, params_np, loss_impl, attn_impl):
    """bf16 compute on both sides (f32 master parameters). bf16 keeps ~3
    significant digits and the frameworks round at other places (bias adds,
    GELU, the head), so: the loss within 1e-3 (measured ~1e-4), and each
    gradient leaf within 5e-2 of its largest entry (measured <= 1.8e-2)."""
    jcfg, tcfg = _cfgs("bf16", loss_impl=loss_impl, attn_impl=attn_impl)
    (tok,) = _tokens(5)
    loss_j, grads_j, loss_t, grads_t = _loss_and_grads(jax_params, params_np, tok, jcfg, tcfg)
    assert math.isfinite(loss_t) and abs(loss_t - loss_j) <= 1e-3
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(grads_j)[0],
                                 jax.tree.leaves(grads_t)):
        want = np.asarray(want, dtype=np.float32)
        err = np.abs(got - want).max()
        assert err <= 5e-2 * np.abs(want).max(), (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
@pytest.mark.parametrize("loss_impl", ["chunked", "fused"])
def test_f16_matches_jax(jax_params, params_np, loss_impl, attn_impl):
    """f16 compute on both sides (f32 master parameters), beside the bf16
    leg. f16 keeps three more mantissa bits than bf16; the frameworks still
    round at other places: the loss within 1e-4 (measured 5.7e-6), each
    gradient leaf within 1e-2 of its largest entry (measured <= 2.9e-3)."""
    jcfg, tcfg = _cfgs("f16", loss_impl=loss_impl, attn_impl=attn_impl)
    (tok,) = _tokens(5)
    loss_j, grads_j, loss_t, grads_t = _loss_and_grads(jax_params, params_np, tok, jcfg, tcfg)
    assert math.isfinite(loss_t) and abs(loss_t - loss_j) <= 1e-4
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(grads_j)[0],
                                 jax.tree.leaves(grads_t)):
        want = np.asarray(want, dtype=np.float32)
        err = np.abs(got - want).max()
        assert err <= 1e-2 * np.abs(want).max(), (jax.tree_util.keystr(path), err)


def test_f16_train_step_matches_optax(jax_params, params_np):
    """One torch.optim.AdamW step in f16 compute (flash attention, fused CE)
    against one jitted optax adamw step (lr 3e-4, weight decay 0.01). The
    step's loss within 1e-4 relative (measured 8.6e-8). Adam's first step
    moves each parameter by lr * g / (|g| + 1e-8) (plus the decay): where
    |g| is at least 1e-2 of its leaf's largest entry (the two frameworks'
    f16 gradients agree to 2.9e-3 of it, test above) both move the element
    alike, within 1e-6; elsewhere the direction rests on f16 rounding (the
    key bias's gradient is zero in exact arithmetic) and each may step
    either way: within two steps, 2 lr."""
    lr = 3e-4
    jcfg, tcfg = _cfgs("f16", loss_impl="fused", attn_impl="flash")
    opt = optax.adamw(lr, weight_decay=0.01)
    (tok,) = _tokens(4)
    grads_j = jax.grad(jg.loss_fn)(jax_params, jnp.asarray(tok), jcfg)
    params_j, _, loss_j = jax.jit(jg.make_train_step(jcfg, opt))(jax_params, opt.init(jax_params),
                                                                  jnp.asarray(tok))
    model = tg.from_jax(params_np, tcfg, "cpu")
    step_t = tg.make_train_step(model, torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=0.01,
                                                         betas=(0.9, 0.999), eps=1e-8))
    loss_t = step_t(tok)
    assert abs(loss_t.item() - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    leaves = zip(jax.tree_util.tree_flatten_with_path(params_j)[0], jax.tree.leaves(tg.to_jax(model)),
                 jax.tree.leaves(grads_j))
    for (path, want), got, g in leaves:
        want, g = np.asarray(want), np.abs(np.asarray(g, dtype=np.float32))
        gap = np.abs(got - want)
        settled = g >= 1e-2 * g.max()
        assert gap[settled].max(initial=0.0) <= 1e-6, (jax.tree_util.keystr(path), gap[settled].max())
        assert gap.max() <= 2 * lr, (jax.tree_util.keystr(path), gap.max())

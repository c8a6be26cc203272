"""The port's MLP against the JAX package's (BASELINE config 1).

The JAX parameters (``mlp.init``) are carried into the port by
``from_jax`` through numpy; inputs and labels come from a seeded numpy
generator. Both sides compute in f32 and sum in other orders: forward,
loss, accuracy and every gradient within 1e-6 relative (a small absolute
floor for values that are zero or near it, stated below). The port's own
init is held to the JAX init's scale and zero biases.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import mlp as jm
from ray_tpu_torch.models import mlp as tm

RTOL = 1e-6
# Gradients and logits that sum to ~0 (a dead ReLU unit's column, a bias
# whose contributions cancel) have no relative scale: below 1e-6 of the
# leaf's largest entry, entries are held absolutely.
ATOL_FRAC = 1e-6
N = 64

CONFIGS = {
    "default": dict(),                                      # (784, 128, 128, 10)
    "test": dict(in_dim=8, hidden=(16,), num_classes=3),    # tests/test_train.py's
}


def _pair(name):
    kw = CONFIGS[name]
    return jm.MLPConfig(**kw), tm.MLPConfig(**kw)


def _batch(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, jcfg.in_dim)).astype(np.float32)
    y = rng.integers(0, jcfg.num_classes, N).astype(np.int32)
    return x, y


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_FRAC * scale)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request, cpu_mesh_devices):
    jcfg, tcfg = _pair(request.param)
    params = jm.init(jax.random.PRNGKey(0), jcfg)
    params_np = jax.tree.map(np.asarray, params)
    model = tm.from_jax(params_np, tcfg, device="cpu")
    return jcfg, tcfg, params, model


def test_forward_matches_jax(case):
    jcfg, _, params, model = case
    x, _ = _batch(jcfg)
    want = jm.forward(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_loss_and_gradients_match_jax(case):
    jcfg, _, params, model = case
    x, y = _batch(jcfg, seed=1)
    loss_j, grads_j = jax.value_and_grad(jm.loss_fn)(params, (jnp.asarray(x), jnp.asarray(y)))
    model.zero_grad(set_to_none=True)
    loss_t = tm.loss_fn(model, (torch.from_numpy(x), torch.from_numpy(y)))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=RTOL)
    grads_t = tm.to_jax(model, grads=True)
    assert jax.tree.structure(grads_t) == jax.tree.structure(grads_j)
    for g, w in zip(jax.tree.leaves(grads_t), jax.tree.leaves(grads_j)):
        assert g.shape == w.shape
        _close(g, w)
    model.zero_grad(set_to_none=True)


def test_accuracy_matches_jax(case):
    jcfg, _, params, model = case
    x, y = _batch(jcfg, seed=2)
    want = float(jm.accuracy(params, (jnp.asarray(x), jnp.asarray(y))))
    with torch.no_grad():
        got = tm.accuracy(model, (torch.from_numpy(x), torch.from_numpy(y))).item()
    assert got == want


def test_to_jax_round_trip(case):
    _, tcfg, params, model = case
    back = tm.to_jax(model)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(g, np.asarray(w))
    again = tm.from_jax(back, tcfg, device="cpu")
    for (n, p), (m, q) in zip(model.named_parameters(), again.named_parameters()):
        assert n == m and torch.equal(p, q)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_scale_and_zero_biases(name):
    """The port's init draws from its own generator (not JAX's), so it is
    held to the JAX init's law: He-normal kernels, std sqrt(2 / fan_in)
    within sampling error, zero biases, the same shapes and names."""
    jcfg, tcfg = _pair(name)
    model = tm.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    want = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jcfg))
    got = tm.to_jax(model)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for layer, leaves in got.items():
        k = leaves["kernel"]
        assert k.shape == want[layer]["kernel"].shape
        assert not leaves["bias"].any()
        std = (2.0 / k.shape[0]) ** 0.5
        # the sample std of n normals is within 6 / sqrt(2n) of sigma, relative
        assert abs(k.std() / std - 1) < 6 / np.sqrt(2 * k.size), (layer, k.std(), std)
        assert abs(k.mean()) < 6 * std / np.sqrt(k.size)
    again = tm.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), again.parameters()))


def test_entry_points_default_to_cuda():
    """Without device="cpu" the model is made on cuda, and raises where
    there is no card."""
    if torch.cuda.is_available():
        assert tm.MLP(tm.MLPConfig()).layer0.kernel.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA device"):
        tm.MLP(tm.MLPConfig())

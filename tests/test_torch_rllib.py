"""The port's RLlib-lite (``ray_tpu_torch/rllib``: a copy of the JAX
package's env and ``__init__``, and ``ppo.py`` with a torch learner) on
the CPU: the contracts of ``tests/test_rllib.py``, re-run on the port's
cluster, plus the learner held to the JAX package's.

- the env contract;
- one minibatch update from the JAX package's init (PRNGKey(3), carried
  across by ``params_from_jax``) on a real minibatch, held to the JAX
  learner's at f32: the loss within 1e-5 relative, each parameter's update
  within 1e-4 relnorm and each Adam moment within 1e-5 (measured on the
  CPU: 1e-5 and 6e-7 at most; the update is the difference of two
  rounded f32 parameters, and the two frameworks sum in other orders);
- iteration 1's rollouts of the port's runners, bitwise the JAX runners';
- PPO learning CartPole at seed 3 under the JAX file's thresholds, from
  the JAX init and from the port's own.

The JAX package is imported inside the functions that use it.
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.core import cluster_utils
from ray_tpu_torch.rllib import ppo as port_ppo
from ray_tpu_torch.utils import serialization

SEED = 3
LOSS_RTOL = 1e-5
UPDATE_RELNORM_TOL = 1e-4
MOMENT_RELNORM_TOL = 1e-5


@pytest.fixture(scope="module")
def rt():
    cluster_utils.sweep_stale_runtime()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the learner is small; other files run beside this one
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    torch.set_num_threads(threads)


def _jax_init(seed: int = SEED) -> dict:
    """The JAX package's policy at ``seed``, as numpy arrays."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from ray_tpu.rllib import ppo as jax_ppo
    from ray_tpu.rllib.env import CartPole

    env = CartPole()
    params = jax_ppo.init_policy(jax.random.PRNGKey(seed), env.observation_size,
                                 env.num_actions, 64)
    return {k: np.asarray(v) for k, v in params.items()}


def _relnorm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_cartpole_env_contract():
    from ray_tpu_torch.rllib import CartPole

    env = CartPole()
    obs, info = env.reset(seed=0)
    assert obs.shape == (4,)
    total = 0.0
    done = False
    steps = 0
    while not done and steps < 600:
        obs, r, term, trunc, _ = env.step(steps % 2)
        total += r
        done = term or trunc
        steps += 1
    assert 1 <= steps <= 500
    # alternating actions balance poorly: episode ends early
    assert steps < 500


def test_init_policy_has_the_jax_parameters():
    """The same six parameters, shapes and scales; params_from_jax carries
    the JAX policy across bit for bit."""
    jax_params = _jax_init()
    policy = port_ppo.init_policy(torch.Generator().manual_seed(SEED), 4, 2, 64)
    assert isinstance(policy, torch.nn.Module)
    assert {k: tuple(p.shape) for k, p in policy.items()} == \
        {k: v.shape for k, v in jax_params.items()}
    for k in ("b1", "b2"):
        assert not policy[k].any()
    for k in ("w1", "w2", "pi", "v"):  # each draw's scale, as the JAX init's
        assert abs(policy[k].std().item() / jax_params[k].std() - 1) < 0.35, k
    carried = port_ppo.params_from_jax(jax_params)
    for k, v in jax_params.items():
        assert carried[k].dtype == torch.float32
        assert np.array_equal(carried[k].detach().numpy(), v)


def _jax_learner(seed: int):
    """The JAX package's PPO learner (no env runners: no cluster)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from ray_tpu.rllib import ppo as jax_ppo

    return jax_ppo.PPOConfig(num_env_runners=0, seed=seed).build()


def _minibatch(params: dict, n: int = 256) -> dict:
    """A real minibatch: n steps of CartPole under ``params`` (the JAX
    package's runner class, in this process), with GAE."""
    from ray_tpu.rllib import ppo as jax_ppo

    runner = jax_ppo.EnvRunner.cls("CartPole-v1", SEED * 1000)
    b = runner.sample(serialization.pack(params), n)
    adv, targets = jax_ppo._gae(b, 0.99, 0.95)
    return {"obs": b["obs"], "actions": b["actions"], "logp": b["logp"], "adv": adv,
            "targets": targets}


def _adam_moments(opt_state) -> tuple:
    import jax

    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu") and hasattr(x, "nu")):
        if hasattr(node, "mu"):
            return node.mu, node.nu
    raise AssertionError("no Adam state in the optax chain")


def test_train_minibatch_matches_jax():
    import jax.numpy as jnp

    jax_algo = _jax_learner(SEED)
    before = {k: np.asarray(v) for k, v in jax_algo.params.items()}
    mb = _minibatch(before)
    params, opt_state, loss = jax_algo._train_minibatch(
        jax_algo.params, jax_algo.opt_state, {k: jnp.asarray(v) for k, v in mb.items()})
    mu, nu = _adam_moments(opt_state)

    algo = port_ppo.PPOConfig(num_env_runners=0, seed=SEED, device="cpu").build()
    algo.policy.load_state_dict(port_ppo.params_from_jax(before).state_dict())
    tmb = {k: torch.as_tensor(v) for k, v in mb.items()}
    tmb["actions"] = tmb["actions"].long()
    got_loss = algo._train_minibatch(tmb)

    assert abs(float(got_loss) - float(loss)) <= LOSS_RTOL * abs(float(loss))
    for k, p in algo.policy.items():
        got_update = p.detach().numpy() - before[k]
        want_update = np.asarray(params[k]) - before[k]
        assert _relnorm(got_update, want_update) < UPDATE_RELNORM_TOL, k
        state = algo.opt.state[p]
        assert int(state["step"]) == 1
        assert _relnorm(state["exp_avg"].numpy(), mu[k]) < MOMENT_RELNORM_TOL, k
        assert _relnorm(state["exp_avg_sq"].numpy(), nu[k]) < MOMENT_RELNORM_TOL, k


def test_clip_by_global_norm_is_optax_rule():
    """Scaled by max_norm / norm only when the norm reaches max_norm."""
    import optax

    gen = np.random.default_rng(0)
    for scale in (0.01, 1.0):
        grads = {k: gen.standard_normal(s).astype(np.float32) * scale
                 for k, s in (("a", (4, 8)), ("b", (8,)))}
        want, _ = optax.clip_by_global_norm(0.5).update(grads, optax.EmptyState())
        got = [torch.tensor(grads[k]) for k in ("a", "b")]
        port_ppo.clip_by_global_norm_(got, 0.5)
        for k, g in zip(("a", "b"), got):
            np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)
            if scale == 0.01:
                assert np.array_equal(g.numpy(), grads[k])  # under the limit: untouched


def test_first_rollouts_are_the_jax_runners(rt):
    """Iteration 1's rollouts: the port's runner actors on the JAX init,
    bitwise the JAX package's runner class on the same params."""
    from ray_tpu.rllib import ppo as jax_ppo

    jax_params = _jax_init()
    algo = port_ppo.PPOConfig(num_env_runners=2, seed=SEED, device="cpu").build()
    try:
        algo.policy.load_state_dict(port_ppo.params_from_jax(jax_params).state_dict())
        blob = serialization.pack(port_ppo._host_params(algo.policy))
        got = rt.get([r.sample.remote(blob, 1024) for r in algo.runners], timeout=120)
        for i, batch in enumerate(got):
            want = jax_ppo.EnvRunner.cls("CartPole-v1", SEED * 1000 + i).sample(
                serialization.pack(jax_params), 1024)
            assert batch.keys() == want.keys()
            for k, v in want.items():
                if isinstance(v, np.ndarray):
                    assert v.dtype == batch[k].dtype and np.array_equal(v, batch[k]), k
                else:
                    assert v == batch[k], k
    finally:
        algo.stop()


@pytest.mark.parametrize("init", ["jax", "port"])
def test_ppo_learns_cartpole(rt, init):
    """PPO on CartPole: mean episode return must improve substantially
    over a handful of iterations (random policy ~= 20)."""
    from ray_tpu_torch.rllib import PPOConfig

    algo = PPOConfig(num_env_runners=2, seed=SEED, device="cpu").build()
    try:
        if init == "jax":
            algo.policy.load_state_dict(port_ppo.params_from_jax(_jax_init()).state_dict())
        first = None
        best = 0.0
        for _ in range(15):
            result = algo.train()
            ret = result["episode_return_mean"]
            if ret is not None:
                if first is None:
                    first = ret
                best = max(best, ret)
        assert first is not None
        assert best >= max(60.0, 2 * first), (
            f"PPO did not learn: first={first}, best={best}"
        )
        # the learned greedy policy balances much longer than random
        from ray_tpu_torch.rllib import CartPole

        env = CartPole()
        obs, _ = env.reset(seed=42)
        steps = 0
        done = False
        while not done and steps < 500:
            obs, _, term, trunc, _ = env.step(algo.compute_action(obs))
            done = term or trunc
            steps += 1
        assert steps >= 100, f"greedy policy survived only {steps} steps"
    finally:
        algo.stop()


def test_learner_raises_without_cuda(monkeypatch):
    """PPOConfig(device=None) puts the learner on cuda: with no card it
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_ppo.PPOConfig(num_env_runners=0).build()

"""PPO — the RLlib-lite flagship algorithm, with a torch learner.

Ported from the JAX package's ``rllib/ppo.py``. Parity: the reference
Algorithm/EnvRunnerGroup/LearnerGroup split
(rllib/algorithms/algorithm.py:212, env_runner_group.py:70,
learner_group.py:100) at BASELINE config #4's shape: CPU env-runner
ACTORS sample rollouts with a numpy copy of the policy, the LEARNER runs
the PPO update (clipped surrogate + value loss + entropy bonus over GAE
advantages, global-norm clip 0.5, Adam) on the driver's card — cards
never wait on environment stepping, hosts never run SGD.

The runners stay numpy and import no torch: the module imports it in
the functions that use it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.utils import serialization

PARAM_NAMES = ("w1", "b1", "w2", "b2", "pi", "v")
GRAD_CLIP = 0.5  # optax.clip_by_global_norm(0.5) in the JAX learner


# ---------------------------------------------------------------------------
# policy: 2-layer MLP -> (logits, value)
# ---------------------------------------------------------------------------


def init_policy(generator, obs_size: int, num_actions: int, hidden: int = 64):
    """The policy's six parameters (the JAX package's init_policy, drawn
    from ``generator``, a CPU ``torch.Generator``) as an
    ``nn.ParameterDict`` on the CPU."""
    import torch

    def norm(shape, scale):
        return torch.randn(shape, generator=generator, dtype=torch.float32) * scale

    return torch.nn.ParameterDict({
        "w1": norm((obs_size, hidden), 0.5 / obs_size**0.5),
        "b1": torch.zeros(hidden),
        "w2": norm((hidden, hidden), 1.0 / hidden**0.5),
        "b2": torch.zeros(hidden),
        "pi": norm((hidden, num_actions), 0.01),
        "v": norm((hidden, 1), 1.0 / hidden**0.5),
    })


def params_from_jax(params: Dict[str, np.ndarray]):
    """The JAX package's policy (its params as numpy arrays) as this
    module's ``nn.ParameterDict``, f32, on the CPU."""
    import torch

    return torch.nn.ParameterDict({
        k: torch.tensor(np.asarray(params[k], dtype=np.float32)) for k in PARAM_NAMES
    })


def _forward_np(params: Dict[str, np.ndarray], obs: np.ndarray):
    """Numpy policy forward for the CPU rollout path (no torch import in
    the hot sampling loop)."""
    h = np.tanh(obs @ params["w1"] + params["b1"])
    h = np.tanh(h @ params["w2"] + params["b2"])
    logits = h @ params["pi"]
    value = (h @ params["v"])[..., 0]
    return logits, value


def _forward_torch(params, obs):
    import torch

    h = torch.tanh(obs @ params["w1"] + params["b1"])
    h = torch.tanh(h @ params["w2"] + params["b2"])
    return h @ params["pi"], (h @ params["v"])[..., 0]


def _host_params(policy) -> Dict[str, np.ndarray]:
    """A numpy snapshot of the policy: a copy, also on the CPU (where
    ``.numpy()`` would alias the parameters the optimizer updates)."""
    return {k: p.detach().to("cpu", copy=True).numpy() for k, p in policy.items()}


# ---------------------------------------------------------------------------
# env runner actor (CPU sampling)
# ---------------------------------------------------------------------------


@ray_tpu_torch.remote
class EnvRunner:
    """Samples rollouts with a numpy snapshot of the policy (parity:
    SingleAgentEnvRunner)."""

    def __init__(self, env_spec, seed: int):
        self.env = make_env(env_spec)
        self.rng = np.random.default_rng(seed)
        self.obs, _ = self.env.reset(seed=seed)
        self.episode_return = 0.0
        self.completed_returns: List[float] = []

    def sample(self, params_blob: bytes, num_steps: int) -> Dict[str, Any]:
        params = {
            k: np.asarray(v)
            for k, v in serialization.unpack(params_blob).items()
        }
        obs_buf = np.empty((num_steps, self.env.observation_size), np.float32)
        act_buf = np.empty((num_steps,), np.int32)
        logp_buf = np.empty((num_steps,), np.float32)
        val_buf = np.empty((num_steps,), np.float32)
        rew_buf = np.empty((num_steps,), np.float32)
        done_buf = np.empty((num_steps,), np.float32)
        self.completed_returns = []
        for t in range(num_steps):
            logits, value = _forward_np(params, self.obs)
            z = logits - logits.max()
            p = np.exp(z)
            p /= p.sum()
            action = int(self.rng.choice(len(p), p=p))
            obs_buf[t] = self.obs
            act_buf[t] = action
            logp_buf[t] = float(np.log(p[action] + 1e-12))
            val_buf[t] = float(value)
            nxt, reward, terminated, truncated, _ = self.env.step(action)
            rew_buf[t] = reward
            done = terminated or truncated
            done_buf[t] = float(done)
            self.episode_return += reward
            if done:
                self.completed_returns.append(self.episode_return)
                self.episode_return = 0.0
                nxt, _ = self.env.reset()
            self.obs = nxt
        _, last_val = _forward_np(params, self.obs)
        return {
            "obs": obs_buf, "actions": act_buf, "logp": logp_buf,
            "values": val_buf, "rewards": rew_buf, "dones": done_buf,
            "last_value": float(last_val),
            "episode_returns": self.completed_returns,
        }


def _gae(batch: Dict[str, np.ndarray], gamma: float, lam: float):
    """Generalized advantage estimation over one runner's rollout."""
    rewards, values, dones = batch["rewards"], batch["values"], batch["dones"]
    T = len(rewards)
    adv = np.zeros(T, np.float32)
    last = 0.0
    next_value = batch["last_value"]
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last = delta + gamma * lam * nonterminal * last
        adv[t] = last
        next_value = values[t]
    return adv, adv + values


# ---------------------------------------------------------------------------
# PPO algorithm
# ---------------------------------------------------------------------------


class PPOConfig:
    def __init__(
        self,
        env: Any = "CartPole-v1",
        num_env_runners: int = 2,
        rollout_length: int = 1024,
        gamma: float = 0.99,
        gae_lambda: float = 0.95,
        clip: float = 0.2,
        lr: float = 1e-3,
        entropy_coeff: float = 0.01,
        vf_coeff: float = 0.5,
        num_epochs: int = 6,
        minibatch_size: int = 256,
        hidden: int = 64,
        seed: int = 0,
        device: Optional[str] = None,
    ):
        self.env = env
        self.num_env_runners = num_env_runners
        self.rollout_length = rollout_length
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self.clip = clip
        self.lr = lr
        self.entropy_coeff = entropy_coeff
        self.vf_coeff = vf_coeff
        self.num_epochs = num_epochs
        self.minibatch_size = minibatch_size
        self.hidden = hidden
        self.seed = seed
        # the learner's device: None is cuda (raises without it); the CPU
        # tests pass "cpu"
        self.device = device

    def build(self) -> "PPO":
        return PPO(self)


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax.clip_by_global_norm, in place: every gradient times
    ``max_norm / norm`` when the global norm reaches ``max_norm``, else
    untouched (torch's clip_grad_norm_ divides by norm + 1e-6 instead).
    No host sync."""
    import torch

    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


class PPO:
    def __init__(self, cfg: PPOConfig):
        import torch

        from ray_tpu_torch.device import resolve_device

        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        probe = make_env(cfg.env)
        self.policy = init_policy(
            torch.Generator().manual_seed(cfg.seed), probe.observation_size,
            probe.num_actions, cfg.hidden,
        ).to(self.device)
        # global-norm gradient clipping ahead of adam: the stock PPO
        # stabilizer against late-training policy collapse (reference
        # rllib default grad_clip on the same loss family)
        self.opt = torch.optim.Adam(self.policy.parameters(), lr=cfg.lr)
        # best-iterate checkpoint (by rollout return): greedy evaluation
        # serves the best policy seen, not whatever the last SGD epoch
        # left behind — the in-memory analogue of keep-best checkpointing
        self.best_params = None
        self.best_return = -float("inf")
        self.runners = [
            EnvRunner.remote(cfg.env, cfg.seed * 1000 + i)
            for i in range(cfg.num_env_runners)
        ]
        self._train_minibatch = self._make_train_minibatch()
        self.iteration = 0

    def _make_train_minibatch(self):
        import torch

        cfg = self.cfg
        params = list(self.policy.values())

        def loss_fn(mb):
            logits, values = _forward_torch(self.policy, mb["obs"])
            logp_all = torch.log_softmax(logits, dim=-1)
            logp = torch.gather(logp_all, 1, mb["actions"][:, None])[:, 0]
            ratio = torch.exp(logp - mb["logp"])
            adv = mb["adv"]
            # the population std, as jnp.std
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
            surr = torch.minimum(
                ratio * adv,
                torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv,
            )
            entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=1)
            vf_loss = torch.mean((values - mb["targets"]) ** 2)
            return (
                -torch.mean(surr)
                + cfg.vf_coeff * vf_loss
                - cfg.entropy_coeff * torch.mean(entropy)
            )

        def train_minibatch(mb):
            """One clipped, Adam-stepped update; returns the loss (on the
            learner's device: reading it is the caller's host sync)."""
            self.opt.zero_grad(set_to_none=True)
            loss = loss_fn(mb)
            loss.backward()
            with torch.no_grad():
                clip_by_global_norm_([p.grad for p in params], GRAD_CLIP)
            self.opt.step()
            return loss.detach()

        return train_minibatch

    def train(self) -> Dict[str, Any]:
        """One iteration: parallel rollouts -> GAE -> minibatch SGD."""
        import torch

        cfg = self.cfg
        params_np = _host_params(self.policy)
        blob = serialization.pack(params_np)
        batches = ray_tpu_torch.get(
            [
                r.sample.remote(blob, cfg.rollout_length)
                for r in self.runners
            ],
            timeout=600,
        )
        advs, targets = [], []
        for b in batches:
            a, t = _gae(b, cfg.gamma, cfg.gae_lambda)
            advs.append(a)
            targets.append(t)
        data = {
            "obs": np.concatenate([b["obs"] for b in batches]),
            "actions": np.concatenate([b["actions"] for b in batches]).astype(np.int64),
            "logp": np.concatenate([b["logp"] for b in batches]),
            "adv": np.concatenate(advs),
            "targets": np.concatenate(targets),
        }
        n = len(data["obs"])
        # the iteration's batch goes to the learner's device once; each
        # minibatch is gathered there
        on_dev = {k: torch.as_tensor(v, device=self.device) for k, v in data.items()}
        rng = np.random.default_rng(cfg.seed + self.iteration)
        losses = []
        for _ in range(cfg.num_epochs):
            order = rng.permutation(n)
            for start in range(0, n, cfg.minibatch_size):
                idx = torch.as_tensor(order[start:start + cfg.minibatch_size],
                                      device=self.device)
                mb = {k: v.index_select(0, idx) for k, v in on_dev.items()}
                loss = self._train_minibatch(mb)
                losses.append(float(loss))
        self.iteration += 1
        episode_returns = [
            r for b in batches for r in b["episode_returns"]
        ]
        return_mean = (
            float(np.mean(episode_returns)) if episode_returns else None
        )
        if return_mean is not None and return_mean > self.best_return:
            # snapshot the params that PRODUCED these rollouts (pre-update
            # for this iteration's SGD — the policy the returns measure)
            self.best_return = return_mean
            self.best_params = params_np
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": return_mean,
            "best_return": (
                self.best_return if self.best_params is not None else None
            ),
            "num_episodes": len(episode_returns),
            "loss": float(np.mean(losses)),
            "num_env_steps": n,
        }

    def get_policy_params(self):
        return self.policy

    def compute_action(self, obs: np.ndarray, use_best: bool = True) -> int:
        """Greedy action. With use_best (default) the best-return iterate
        serves the action — deploy-the-best-checkpoint semantics;
        use_best=False evaluates the live (latest) params."""
        if use_best and self.best_params is not None:
            params_np = self.best_params
        else:
            params_np = _host_params(self.policy)
        logits, _ = _forward_np(params_np, np.asarray(obs, np.float32))
        return int(np.argmax(logits))

    def stop(self) -> None:
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001
                pass

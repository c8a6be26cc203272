"""ray_tpu_torch.rllib — reinforcement learning (RLlib-lite).

Parity target: the reference RLlib's PPO path at BASELINE config #4's
shape (CPU env-runner actors + accelerator learner); algorithms beyond
PPO follow the same EnvRunner/Learner split.
"""

from ray_tpu_torch.rllib.env import ENV_REGISTRY, CartPole, Env, make_env
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig

__all__ = [
    "CartPole",
    "ENV_REGISTRY",
    "Env",
    "PPO",
    "PPOConfig",
    "make_env",
]

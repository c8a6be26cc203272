"""Environment interface + built-in CartPole.

Parity: the reference RLlib's env layer (rllib/env/) is gymnasium-based;
this image has no gymnasium, so the interface is the same shape
(reset() -> (obs, info), step(a) -> (obs, reward, terminated, truncated,
info)) with a self-contained CartPole-v1 implementation (standard
Barto-Sutton-Anderson dynamics) as the canonical test env.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


class Env:
    observation_size: int
    num_actions: int

    def reset(self, seed: Optional[int] = None) -> Tuple[np.ndarray, Dict]:
        raise NotImplementedError

    def step(self, action: int) -> Tuple[np.ndarray, float, bool, bool, Dict]:
        raise NotImplementedError


class CartPole(Env):
    """CartPole-v1 dynamics (gymnasium-compatible semantics: reward 1 per
    step, terminated on |x|>2.4 or |theta|>12deg, truncated at 500)."""

    observation_size = 4
    num_actions = 2

    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    LENGTH = 0.5
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * math.pi / 360
    X_LIMIT = 2.4
    MAX_STEPS = 500

    def __init__(self):
        self._rng = np.random.default_rng(0)
        self._state = np.zeros(4, np.float64)
        self._steps = 0

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._steps = 0
        return self._state.astype(np.float32).copy(), {}

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE_MAG if action == 1 else -self.FORCE_MAG
        costheta, sintheta = math.cos(theta), math.sin(theta)
        total_mass = self.MASSCART + self.MASSPOLE
        polemass_length = self.MASSPOLE * self.LENGTH
        temp = (
            force + polemass_length * theta_dot**2 * sintheta
        ) / total_mass
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASSPOLE * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x += self.TAU * x_dot
        x_dot += self.TAU * xacc
        theta += self.TAU * theta_dot
        theta_dot += self.TAU * thetaacc
        self._state = np.asarray([x, x_dot, theta, theta_dot])
        self._steps += 1
        terminated = bool(
            abs(x) > self.X_LIMIT or abs(theta) > self.THETA_LIMIT
        )
        truncated = self._steps >= self.MAX_STEPS
        return (
            self._state.astype(np.float32).copy(), 1.0, terminated,
            truncated, {},
        )


ENV_REGISTRY: Dict[str, Callable[[], Env]] = {"CartPole-v1": CartPole}


def make_env(name_or_factory: Any) -> Env:
    if callable(name_or_factory):
        return name_or_factory()
    return ENV_REGISTRY[name_or_factory]()

"""CartPole-v1, natively vectorized (classic-control dynamics).

Matches the standard CartPole-v1 contract the reference's BASELINE config
targets (`rllib/tuned_examples/ppo/cartpole-ppo.yaml`): 4-dim observation,
2 actions, reward 1 per step, termination at |x|>2.4 or |theta|>12°,
truncation at 500 steps. Dynamics are Euler-integrated batched numpy.

The step math lives in module-level functions parameterized by the array
namespace (`xp` = numpy here, jax.numpy in `podracer.jax_env.JaxCartPole`)
so the numpy sampling plane and the jitted Anakin plane share ONE source of
dynamics — parity between them holds by construction, and the parity test
(`tests/test_podracer_env_parity.py`) guards the wrapper semantics (reset
distributions, auto-reset, step counting) rather than transcribed physics.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .spaces import Box, Discrete
from .vector import VectorEnv

GRAVITY = 9.8
MASSCART = 1.0
MASSPOLE = 0.1
TOTAL_MASS = MASSCART + MASSPOLE
LENGTH = 0.5  # half pole length
POLEMASS_LENGTH = MASSPOLE * LENGTH
FORCE_MAG = 10.0
TAU = 0.02
THETA_THRESHOLD = 12 * 2 * math.pi / 360
X_THRESHOLD = 2.4
RESET_BOUND = 0.05


def cartpole_step(xp, state, actions):
    """One Euler step of the batched cart-pole dynamics.

    `state` is [N, 4] (x, x_dot, theta, theta_dot), `actions` is [N] in
    {0, 1}; returns the new [N, 4] state. Pure in `xp` (numpy or jax.numpy).
    """
    x, x_dot, theta, theta_dot = state[:, 0], state[:, 1], state[:, 2], state[:, 3]
    force = xp.where(actions == 1, FORCE_MAG, -FORCE_MAG)
    costheta = xp.cos(theta)
    sintheta = xp.sin(theta)
    temp = (force + POLEMASS_LENGTH * theta_dot**2 * sintheta) / TOTAL_MASS
    thetaacc = (GRAVITY * sintheta - costheta * temp) / (
        LENGTH * (4.0 / 3.0 - MASSPOLE * costheta**2 / TOTAL_MASS)
    )
    xacc = temp - POLEMASS_LENGTH * thetaacc * costheta / TOTAL_MASS

    x = x + TAU * x_dot
    x_dot = x_dot + TAU * xacc
    theta = theta + TAU * theta_dot
    theta_dot = theta_dot + TAU * thetaacc
    return xp.stack([x, x_dot, theta, theta_dot], axis=1)


def cartpole_terminated(xp, state):
    """[N, 4] state -> [N] bool termination mask (pole fell / cart left)."""
    return (xp.abs(state[:, 0]) > X_THRESHOLD) | (
        xp.abs(state[:, 2]) > THETA_THRESHOLD
    )


class VectorCartPole(VectorEnv):
    GRAVITY = GRAVITY
    MASSCART = MASSCART
    MASSPOLE = MASSPOLE
    TOTAL_MASS = TOTAL_MASS
    LENGTH = LENGTH
    POLEMASS_LENGTH = POLEMASS_LENGTH
    FORCE_MAG = FORCE_MAG
    TAU = TAU
    THETA_THRESHOLD = THETA_THRESHOLD
    X_THRESHOLD = X_THRESHOLD

    max_episode_steps = 500

    def __init__(self, num_envs: int = 1, max_episode_steps: int = 500):
        self.num_envs = num_envs
        self.max_episode_steps = max_episode_steps
        self.observation_space = Box(-np.inf, np.inf, (4,))
        self.action_space = Discrete(2)
        self._rng = np.random.default_rng()
        self._state = np.zeros((num_envs, 4), np.float64)
        self._steps = np.zeros(num_envs, np.int64)

    def _sample_state(self, n: int) -> np.ndarray:
        return self._rng.uniform(-RESET_BOUND, RESET_BOUND, size=(n, 4))

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._sample_state(self.num_envs)
        self._steps[:] = 0
        return self._state.astype(np.float32), {}

    def step(self, actions: np.ndarray):
        self._state = cartpole_step(np, self._state, actions)
        self._steps += 1

        terminated = cartpole_terminated(np, self._state)
        truncated = (~terminated) & (self._steps >= self.max_episode_steps)
        reward = np.ones(self.num_envs, np.float32)

        done = terminated | truncated
        info = {
            "episode_returns": [],
            "episode_lengths": [],
        }
        if done.any():
            idx = np.nonzero(done)[0]
            # reward-per-step=1 → episode return == episode length
            info["episode_returns"] = [float(self._steps[i]) for i in idx]
            info["episode_lengths"] = [int(self._steps[i]) for i in idx]
            self._state[idx] = self._sample_state(len(idx))
            self._steps[idx] = 0
        return (
            self._state.astype(np.float32),
            reward,
            terminated,
            truncated,
            info,
        )

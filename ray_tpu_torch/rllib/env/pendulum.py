"""Pendulum-v1, natively vectorized — continuous-action counterpart for
testing Gaussian policies (classic-control dynamics).

Like `cartpole.py`, the step math is a module-level function parameterized
by the array namespace (`xp`) so the numpy sampling plane and the jitted
Anakin plane (`podracer.jax_env.JaxPendulum`) share one dynamics source.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .spaces import Box
from .vector import VectorEnv

MAX_SPEED = 8.0
MAX_TORQUE = 2.0
DT = 0.05
G = 10.0
M = 1.0
L = 1.0
RESET_THETA_BOUND = np.pi
RESET_THETADOT_BOUND = 1.0


def pendulum_step(xp, theta, theta_dot, u):
    """One step of the batched pendulum dynamics.

    `theta`/`theta_dot`/`u` are [N]; torque is clipped here. Returns
    (new_theta, new_theta_dot, cost) where `cost` (>= 0) is computed from
    the PRE-step state, exactly the classic-control reward convention.
    Pure in `xp` (numpy or jax.numpy).
    """
    u = xp.clip(u, -MAX_TORQUE, MAX_TORQUE)
    norm_th = ((theta + xp.pi) % (2 * xp.pi)) - xp.pi
    cost = norm_th**2 + 0.1 * theta_dot**2 + 0.001 * u**2

    new_theta_dot = theta_dot + (
        3 * G / (2 * L) * xp.sin(theta) + 3.0 / (M * L**2) * u
    ) * DT
    new_theta_dot = xp.clip(new_theta_dot, -MAX_SPEED, MAX_SPEED)
    new_theta = theta + new_theta_dot * DT
    return new_theta, new_theta_dot, cost


def pendulum_obs(xp, theta, theta_dot):
    """[N] angle/velocity -> [N, 3] (cos, sin, theta_dot) observation."""
    return xp.stack([xp.cos(theta), xp.sin(theta), theta_dot], axis=1)


class VectorPendulum(VectorEnv):
    MAX_SPEED = MAX_SPEED
    MAX_TORQUE = MAX_TORQUE
    DT = DT
    G = G
    M = M
    L = L

    max_episode_steps = 200

    def __init__(self, num_envs: int = 1, max_episode_steps: int = 200):
        self.num_envs = num_envs
        self.max_episode_steps = max_episode_steps
        self.observation_space = Box(-np.inf, np.inf, (3,))
        self.action_space = Box(-self.MAX_TORQUE, self.MAX_TORQUE, (1,))
        self._rng = np.random.default_rng()
        self._theta = np.zeros(num_envs)
        self._theta_dot = np.zeros(num_envs)
        self._steps = np.zeros(num_envs, np.int64)
        self._ep_ret = np.zeros(num_envs, np.float64)

    def _obs(self) -> np.ndarray:
        return pendulum_obs(np, self._theta, self._theta_dot).astype(np.float32)

    def _sample(self, n):
        theta = self._rng.uniform(-RESET_THETA_BOUND, RESET_THETA_BOUND, n)
        theta_dot = self._rng.uniform(-RESET_THETADOT_BOUND, RESET_THETADOT_BOUND, n)
        return theta, theta_dot

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._theta, self._theta_dot = self._sample(self.num_envs)
        self._steps[:] = 0
        self._ep_ret[:] = 0.0
        return self._obs(), {}

    def step(self, actions: np.ndarray):
        u = np.asarray(actions, np.float64).reshape(self.num_envs)
        self._theta, self._theta_dot, cost = pendulum_step(
            np, self._theta, self._theta_dot, u
        )
        self._steps += 1
        self._ep_ret += -cost

        truncated = self._steps >= self.max_episode_steps
        terminated = np.zeros(self.num_envs, bool)
        info = {"episode_returns": [], "episode_lengths": []}
        if truncated.any():
            idx = np.nonzero(truncated)[0]
            info["episode_returns"] = [float(self._ep_ret[i]) for i in idx]
            info["episode_lengths"] = [int(self._steps[i]) for i in idx]
            th_new, thdot_new = self._sample(len(idx))
            self._theta[idx] = th_new
            self._theta_dot[idx] = thdot_new
            self._steps[idx] = 0
            self._ep_ret[idx] = 0.0
        return self._obs(), (-cost).astype(np.float32), terminated, truncated, info

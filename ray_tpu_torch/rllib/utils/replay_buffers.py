"""Replay buffer framework (reference: `rllib/utils/replay_buffers/` —
`ReplayBuffer`, `PrioritizedReplayBuffer`, `MultiAgentReplayBuffer`).

TPU-first shape: buffers live host-side in flat numpy rings and SAMPLE in
stacked [k, mb, ...] layouts so the learner consumes k minibatches in one
jit-compiled `lax.scan` — one device transfer per training iteration, not
per gradient step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class ReplayBuffer:
    """Uniform circular transition buffer for off-policy algorithms.

    Actions may be discrete (scalar int) or continuous ([act_dim] float).
    `add_fragment` flattens the EnvRunner's time-major [T, B] rollout
    fragments into transitions (computing next_obs from the fragment).
    """

    def __init__(self, capacity: int, obs_dim: int, act_shape: Tuple[int, ...] = (),
                 act_dtype=np.int32):
        self.capacity = capacity
        self.obs = np.empty((capacity, obs_dim), np.float32)
        self.next_obs = np.empty((capacity, obs_dim), np.float32)
        self.actions = np.empty((capacity, *act_shape), act_dtype)
        self.rewards = np.empty(capacity, np.float32)
        self.dones = np.empty(capacity, np.float32)
        self.size = 0
        self.pos = 0

    def __len__(self) -> int:
        return self.size

    def add_fragment(self, batch: Dict[str, np.ndarray]):
        obs, dones = batch["obs"], batch["dones"]
        T, B = dones.shape
        next_obs = np.concatenate([obs[1:], batch["last_obs"][None]], axis=0)
        n = T * B
        self._put(
            idx=(self.pos + np.arange(n)) % self.capacity,
            obs=obs.reshape(n, -1),
            next_obs=next_obs.reshape(n, -1),
            actions=batch["actions"].reshape((n, *self.actions.shape[1:])),
            rewards=batch["rewards"].reshape(n),
            dones=dones.reshape(n),
        )
        self.pos = (self.pos + n) % self.capacity
        self.size = min(self.size + n, self.capacity)

    def _put(self, idx, obs, next_obs, actions, rewards, dones):
        self.obs[idx] = obs
        self.next_obs[idx] = next_obs
        self.actions[idx] = actions
        self.rewards[idx] = rewards
        self.dones[idx] = dones

    def _gather(self, idx) -> Dict[str, np.ndarray]:
        return {
            "obs": self.obs[idx],
            "next_obs": self.next_obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "dones": self.dones[idx],
        }

    def sample(self, rng: np.random.Generator, k: int, mb: int) -> Dict[str, np.ndarray]:
        """k uniform minibatches of size mb, stacked [k, mb, ...]."""
        return self._gather(rng.integers(0, self.size, size=(k, mb)))


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (reference:
    `rllib/utils/replay_buffers/prioritized_replay_buffer.py`; Schaul et al.).

    Keeps per-transition priorities p_i; samples ∝ p_i^alpha with
    importance-sampling weights (β-annealed by the caller). Priorities for
    sampled transitions are updated from TD errors via `update_priorities`.
    """

    def __init__(self, capacity: int, obs_dim: int, act_shape: Tuple[int, ...] = (),
                 act_dtype=np.int32, alpha: float = 0.6):
        super().__init__(capacity, obs_dim, act_shape, act_dtype)
        self.alpha = alpha
        self.priorities = np.zeros(capacity, np.float64)
        self._max_prio = 1.0

    def add_fragment(self, batch: Dict[str, np.ndarray]):
        T, B = batch["dones"].shape
        n = T * B
        idx = (self.pos + np.arange(n)) % self.capacity
        super().add_fragment(batch)
        self.priorities[idx] = self._max_prio  # new data gets max priority

    def sample(
        self, rng: np.random.Generator, k: int, mb: int, beta: float = 0.4
    ) -> Dict[str, np.ndarray]:
        p = self.priorities[: self.size] ** self.alpha
        probs = p / p.sum()
        idx = rng.choice(self.size, size=(k, mb), p=probs)
        out = self._gather(idx)
        weights = (self.size * probs[idx]) ** (-beta)
        out["weights"] = (weights / weights.max()).astype(np.float32)
        out["indices"] = idx.astype(np.int64)
        return out

    def update_priorities(self, indices: np.ndarray, td_errors: np.ndarray):
        prios = np.abs(np.asarray(td_errors, np.float64)).reshape(-1) + 1e-6
        self.priorities[np.asarray(indices).reshape(-1)] = prios
        self._max_prio = max(self._max_prio, float(prios.max()))

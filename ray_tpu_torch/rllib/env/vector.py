"""Vector environment base class.

All built-in envs implement batched numpy dynamics directly (no per-env
Python objects). Auto-reset: a sub-env that terminates/truncates at step t
returns its reset observation at t+1; the completed episode's return and
length are appended to the lists in `info["episode_returns"|"episode_lengths"]`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .spaces import Space


class VectorEnv:
    num_envs: int
    observation_space: Space
    action_space: Space
    max_episode_steps: Optional[int] = None

    def reset(self, seed: Optional[int] = None) -> Tuple[np.ndarray, dict]:
        raise NotImplementedError

    def step(self, actions: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, dict]:
        """Returns (obs [N,...], reward [N], terminated [N], truncated [N], info)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class SyncVectorEnv(VectorEnv):
    """Wraps N independent single-env objects (for user-registered envs that
    aren't natively vectorized). Single envs follow the gymnasium API."""

    def __init__(self, env_fns):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        e0 = self.envs[0]
        self.observation_space = e0.observation_space
        self.action_space = e0.action_space
        self.max_episode_steps = getattr(e0, "max_episode_steps", None)
        self._ep_ret = np.zeros(self.num_envs, np.float64)
        self._ep_len = np.zeros(self.num_envs, np.int64)

    def reset(self, seed: Optional[int] = None):
        obs = []
        for i, e in enumerate(self.envs):
            o, _ = e.reset(seed=None if seed is None else seed + i)
            obs.append(o)
        self._ep_ret[:] = 0.0
        self._ep_len[:] = 0
        return np.stack(obs), {}

    def step(self, actions):
        obs, rews, terms, truncs = [], [], [], []
        ep_returns, ep_lengths = [], []
        for i, e in enumerate(self.envs):
            o, r, term, trunc, _ = e.step(actions[i])
            self._ep_ret[i] += r
            self._ep_len[i] += 1
            if term or trunc:
                ep_returns.append(self._ep_ret[i])
                ep_lengths.append(int(self._ep_len[i]))
                self._ep_ret[i] = 0.0
                self._ep_len[i] = 0
                o, _ = e.reset()
            obs.append(o)
            rews.append(r)
            terms.append(term)
            truncs.append(trunc)
        info = {"episode_returns": ep_returns, "episode_lengths": ep_lengths}
        return (
            np.stack(obs),
            np.asarray(rews, np.float32),
            np.asarray(terms, bool),
            np.asarray(truncs, bool),
            info,
        )

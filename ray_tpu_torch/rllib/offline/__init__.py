"""Offline RL data plane.

Reference analog: `python/ray/rllib/offline/` (JsonReader/JsonWriter sample
batches for BC/CQL/MARWIL). Here an offline dataset is a dict of numpy
arrays ({"obs": [N, obs_dim], "actions": [N]/[N, act_dim]}) with JSONL
persistence, plus a collector that rolls a policy (scripted or learned) in a
native vector env.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from ..env import make_env


class OfflineDataset:
    def __init__(
        self,
        obs: np.ndarray,
        actions: np.ndarray,
        returns: Optional[np.ndarray] = None,
        # reference: (obs, actions, returns) only (`ray_tpu/rllib/offline/__init__.py:22-27`);
        # CQL reads the transition fields (`cql.py:52`), so the port carries them.
        rewards: Optional[np.ndarray] = None,
        next_obs: Optional[np.ndarray] = None,
        dones: Optional[np.ndarray] = None,
    ):
        if len(obs) != len(actions):
            raise ValueError("obs and actions must align")
        self.obs = np.asarray(obs, np.float32)
        self.actions = np.asarray(actions)
        # Monte-Carlo returns per transition — required by advantage-weighted
        # methods (MARWIL); BC ignores them.
        self.returns = None if returns is None else np.asarray(returns, np.float32)
        if self.returns is not None and len(self.returns) != len(self.obs):
            raise ValueError(
                f"returns ({len(self.returns)}) must align with obs ({len(self.obs)})"
            )
        # reference: no transition fields (`offline/__init__.py:38`). Per
        # transition: its reward, the observation after it (the reset one
        # where it ended an episode) and whether it did; in memory only
        # (write_json/read_json keep obs, action and return).
        self.rewards = None if rewards is None else np.asarray(rewards, np.float32)
        self.next_obs = None if next_obs is None else np.asarray(next_obs, np.float32)
        self.dones = None if dones is None else np.asarray(dones, np.float32)
        for name in ("rewards", "next_obs", "dones"):
            arr = getattr(self, name)
            if arr is not None and len(arr) != len(self.obs):
                raise ValueError(f"{name} ({len(arr)}) must align with obs ({len(self.obs)})")

    def __len__(self) -> int:
        return len(self.obs)

    def sample(self, rng: np.random.Generator, n: int) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, len(self.obs), size=n)
        out = {"obs": self.obs[idx], "actions": self.actions[idx]}
        if self.returns is not None:
            out["returns"] = self.returns[idx]
        return out

    # ------------------------------------------------------------- storage
    def write_json(self, path: str):
        """JSONL, one transition per line (reference: `offline/json_writer.py`)."""
        with open(path, "w") as f:
            for i in range(len(self.obs)):
                row = {
                    "obs": self.obs[i].tolist(),
                    "action": (
                        self.actions[i].tolist()
                        if hasattr(self.actions[i], "tolist")
                        else self.actions[i]
                    ),
                }
                if self.returns is not None:
                    row["return"] = float(self.returns[i])
                f.write(json.dumps(row) + "\n")

    @classmethod
    def read_json(cls, path: str) -> "OfflineDataset":
        obs, actions, returns = [], [], []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                row = json.loads(line)
                obs.append(row["obs"])
                actions.append(row["action"])
                if "return" in row:
                    returns.append(row["return"])
        if returns and len(returns) != len(obs):
            raise ValueError(
                f"{path}: {len(returns)} of {len(obs)} rows carry 'return' — "
                "mixed files would silently mis-pair returns with obs; "
                "regenerate the data with uniform fields"
            )
        return cls(
            np.asarray(obs, np.float32),
            np.asarray(actions),
            np.asarray(returns, np.float32) if returns else None,
        )


def collect_dataset(
    env_name: str,
    policy_fn: Callable[[np.ndarray], np.ndarray],
    n_steps: int,
    *,
    num_envs: int = 8,
    seed: int = 0,
    gamma: float = 0.99,
    env_kwargs: Optional[dict] = None,
    transitions: bool = False,
) -> OfflineDataset:
    """Roll `policy_fn(obs_batch) -> action_batch` in the native vector env
    and record transitions (expert-demonstration collection for BC).
    `transitions=True` also records each step's reward, next observation
    and done (the TD learners' data: CQL)."""
    # reference: no transitions= (`ray_tpu/rllib/offline/__init__.py:92-100`).
    env = make_env(env_name, num_envs, **(env_kwargs or {}))
    obs, _ = env.reset(seed=seed)
    all_obs, all_act, all_rew, all_done = [], [], [], []
    all_next = []  # reference: no next observations (`offline/__init__.py:106`)
    steps = 0
    while steps < n_steps:
        actions = np.asarray(policy_fn(obs))
        all_obs.append(obs.copy())
        all_act.append(actions.copy())
        obs, rew, term, trunc, _ = env.step(actions)
        all_next.append(np.asarray(obs, np.float32).copy())  # reference: not recorded
        all_rew.append(np.asarray(rew, np.float32))
        all_done.append((term | trunc).astype(np.float32))
        steps += len(actions)
    env.close()
    # Monte-Carlo returns down each env's transition stream (match `gamma`
    # to the consuming algorithm's discount; truncated tails bootstrap to 0).
    rew = np.stack(all_rew)        # [T, N]
    done = np.stack(all_done)
    ret = np.zeros_like(rew)
    acc = np.zeros(rew.shape[1], np.float32)
    for t in range(len(rew) - 1, -1, -1):
        acc = rew[t] + gamma * acc * (1.0 - done[t])
        ret[t] = acc
    def flat(xs):
        return np.concatenate(list(xs), axis=0)[:n_steps]

    if not transitions:
        return OfflineDataset(flat(all_obs), flat(all_act), flat(ret))
    # reference: (obs, actions, returns) only (`offline/__init__.py:129`).
    return OfflineDataset(flat(all_obs), flat(all_act), flat(ret),
                          rewards=flat(rew), next_obs=flat(all_next), dones=flat(done))


class EpisodeDataset:
    """Episodic offline data for trajectory methods (Decision Transformer).

    Reference analog: `rllib/algorithms/dt/` consumes SampleBatches grouped
    by episode; here episodes are explicit: each is
    {"obs": [T, D], "actions": [T], "rewards": [T]}.
    """

    def __init__(self, episodes: List[Dict[str, np.ndarray]]):
        if not episodes:
            raise ValueError("EpisodeDataset needs at least one episode")
        self.episodes = [
            {
                "obs": np.asarray(e["obs"], np.float32),
                "actions": np.asarray(e["actions"]),
                "rewards": np.asarray(e["rewards"], np.float32),
            }
            for e in episodes
        ]
        # Undiscounted returns-to-go per step (the DT conditioning signal).
        self._rtg = [
            np.cumsum(e["rewards"][::-1])[::-1].astype(np.float32)
            for e in self.episodes
        ]
        self.returns = np.array([r[0] for r in self._rtg], np.float32)

    def __len__(self) -> int:
        return len(self.episodes)

    def sample_subsequences(
        self, rng: np.random.Generator, batch_size: int, K: int
    ) -> Dict[str, np.ndarray]:
        """[B, K] windows ending at random timesteps, front-padded (mask=0
        on pad): obs, actions, rtg, timesteps, mask."""
        obs_dim = self.episodes[0]["obs"].shape[1]
        act_dtype = self.episodes[0]["actions"].dtype
        out = {
            "obs": np.zeros((batch_size, K, obs_dim), np.float32),
            "actions": np.zeros((batch_size, K), act_dtype),
            "rtg": np.zeros((batch_size, K), np.float32),
            "timesteps": np.zeros((batch_size, K), np.int32),
            "mask": np.zeros((batch_size, K), np.float32),
        }
        # Sample episodes weighted by length (uniform over TIMESTEPS).
        lengths = np.array([len(e["actions"]) for e in self.episodes])
        probs = lengths / lengths.sum()
        eps = rng.choice(len(self.episodes), size=batch_size, p=probs)
        for b, ei in enumerate(eps):
            ep, rtg = self.episodes[ei], self._rtg[ei]
            T = len(ep["actions"])
            end = int(rng.integers(1, T + 1))
            start = max(0, end - K)
            n = end - start
            out["obs"][b, K - n:] = ep["obs"][start:end]
            out["actions"][b, K - n:] = ep["actions"][start:end]
            out["rtg"][b, K - n:] = rtg[start:end]
            out["timesteps"][b, K - n:] = np.arange(start, end)
            out["mask"][b, K - n:] = 1.0
        return out


def collect_episodes(
    env_name: str,
    policy_fn: Callable[[np.ndarray], np.ndarray],
    n_episodes: int,
    *,
    seed: int = 0,
    max_steps: int = 500,
    env_kwargs: Optional[dict] = None,
) -> EpisodeDataset:
    """Roll `policy_fn` one env at a time and keep whole episodes (the
    trajectory-structured sibling of `collect_dataset`)."""
    env = make_env(env_name, 1, **(env_kwargs or {}))
    episodes = []
    for i in range(n_episodes):
        obs, _ = env.reset(seed=seed + i)
        rows = {"obs": [], "actions": [], "rewards": []}
        for _ in range(max_steps):
            a = np.asarray(policy_fn(obs))
            rows["obs"].append(obs[0].copy())
            rows["actions"].append(a[0])
            obs, rew, term, trunc, _ = env.step(a)
            rows["rewards"].append(float(rew[0]))
            if bool(term[0] or trunc[0]):
                break
        episodes.append({k: np.asarray(v) for k, v in rows.items()})
    env.close()
    return EpisodeDataset(episodes)

"""EnvRunner — vectorized sampling actor (reference: `rllib/env/env_runner.py:15`,
`SingleAgentEnvRunner`; old stack `rllib/evaluation/rollout_worker.py:159`).

One EnvRunner steps an [N]-env numpy batch; the policy forward + action
sample is one torch call per step on the runner's `device` (None: the card;
a remote runner is a CPU actor and passes "cpu", the reference's "CPU
backend on rollout hosts"). Actions are drawn from softmax(logits) with the
runner's `torch.Generator`. Weights arrive as an argument to `sample()` —
the driver broadcasts them through the object store exactly like the
reference's `sync weights back to rollout workers` step (SURVEY.md §3.5).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...device import resolve_device
from ..utils.tree import to_device, tree_map
from . import make_env
from .spaces import Discrete


class EnvRunner:
    def __init__(
        self,
        *,
        env_name: str,
        num_envs: int = 8,
        module: Any,
        rollout_len: int = 128,
        seed: Optional[int] = None,
        env_kwargs: Optional[dict] = None,
        env_to_module=None,
        module_to_env=None,
        device=None,
    ):
        self._env_name = env_name
        self._env_kwargs = dict(env_kwargs or {})
        # Connector pipelines (reference: `rllib/connectors/`): observation
        # transforms before the policy forward, action transforms before
        # env.step. The LEARNER sees connector-transformed obs — policy and
        # training views must match.
        self._env_to_module = env_to_module
        self._module_to_env = module_to_env
        self.env = make_env(env_name, num_envs, **self._env_kwargs)
        # The env may round the slot count (e.g. multi-agent instances ×
        # agents) — its own num_envs is authoritative for buffer shapes.
        self.num_envs = self.env.num_envs
        self.rollout_len = rollout_len
        self.module = module
        self.device = resolve_device(device)
        self._discrete = isinstance(self.env.action_space, Discrete)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed if seed is not None else np.random.randint(2**31))
        self._obs, _ = self.env.reset(seed=seed)
        # Invariant: self._mobs is the policy-view (connector-transformed)
        # of self._obs, computed EXACTLY ONCE per raw observation — stateful
        # connectors (running normalization) must not double-count batches,
        # and the GAE bootstrap view must equal the next fragment's obs[0].
        self._mobs = (
            self._obs if self._env_to_module is None
            else np.asarray(self._env_to_module(self._obs))
        )
        self._mobs_shape = tuple(np.asarray(self._mobs).shape[1:])

        mod = self.module

        # Stateful-module protocol (recurrent policies — DreamerV3's RSSM;
        # reference analog: RLlib's RNN policy state in `Policy.compute_
        # actions` state_batches): a module exposing `act`/`initial_state`
        # owns its whole action computation and threads a per-env state
        # tree through the rollout; state rows reset where an episode
        # ended.
        self._stateful = hasattr(mod, "act") and hasattr(mod, "initial_state")
        if self._stateful:
            # Cached: rebuilt-per-reset zero trees would re-transfer to
            # the device on nearly every step in short-episode envs.
            self._init_state = to_device(mod.initial_state(self.num_envs), self.device)
            self._state = self._init_state
            self._act_st = torch.no_grad()(functools.partial(mod.act, greedy=False))
            self._act_st_greedy = torch.no_grad()(functools.partial(mod.act, greedy=True))

            def _reset_rows(state, done, init):
                def blend(s, s0):
                    mask = done.reshape(done.shape + (1,) * (s.ndim - 1))
                    return torch.where(mask > 0, s0, s)

                return tree_map(blend, state, init)

            self._reset_rows = _reset_rows
        else:
            @torch.no_grad()
            def _act(params, obs, gen):
                dist, value = mod.forward(params, obs)
                action = mod.sample(gen, dist)
                logp = mod.log_prob(dist, action)
                return action, logp, value

            @torch.no_grad()
            def _act_greedy(params, obs):
                dist, value = mod.forward(params, obs)
                return mod.greedy(dist), value

            self._act = _act
            self._act_greedy = _act_greedy

    def get_spaces(self):
        return self.env.observation_space, self.env.action_space

    def ping(self) -> str:
        return "ok"

    def _obs_tensor(self, obs) -> torch.Tensor:
        return torch.as_tensor(np.asarray(obs, np.float32), device=self.device)

    def sample(self, params) -> Dict[str, np.ndarray]:
        """Collect `rollout_len` vectorized steps. Returns time-major arrays
        [T, N, ...] plus the bootstrap observation and episode stats."""
        # Weights to the device ONCE per fragment (numpy from the store, or
        # tensors already there: no copy).
        params = to_device(params, self.device)
        T, N = self.rollout_len, self.num_envs
        obs_buf = np.empty((T, N) + self._mobs_shape, np.float32)
        act_dtype = np.int32 if self._discrete else np.float32
        act_shape = (T, N) if self._discrete else (T, N) + tuple(self.env.action_space.shape)
        act_buf = np.empty(act_shape, act_dtype)
        logp_buf = np.empty((T, N), np.float32)
        val_buf = np.empty((T, N), np.float32)
        rew_buf = np.empty((T, N), np.float32)
        done_buf = np.empty((T, N), np.float32)

        ep_returns, ep_lengths = [], []
        obs, mobs = self._obs, self._mobs
        state = self._state if self._stateful else None
        for t in range(T):
            if self._stateful:
                action, logp, value, state = self._act_st(params, self._obs_tensor(mobs), state, self._gen)
            else:
                action, logp, value = self._act(params, self._obs_tensor(mobs), self._gen)
            action_np = action.cpu().numpy()
            obs_buf[t] = mobs
            act_buf[t] = action_np
            logp_buf[t] = logp.cpu().numpy()
            val_buf[t] = value.cpu().numpy()
            env_action = (
                action_np if self._module_to_env is None
                else self._module_to_env(action_np)
            )
            obs, rew, term, trunc, info = self.env.step(env_action)
            mobs = (
                obs if self._env_to_module is None
                else np.asarray(self._env_to_module(obs))
            )
            rew_buf[t] = rew
            done_buf[t] = (term | trunc).astype(np.float32)
            if self._stateful and done_buf[t].any():
                state = self._reset_rows(
                    state, torch.as_tensor(done_buf[t], device=self.device), self._init_state
                )
            ep_returns.extend(info.get("episode_returns", []))
            ep_lengths.extend(info.get("episode_lengths", []))
        self._obs, self._mobs = obs, mobs
        if self._stateful:
            self._state = state

        return {
            "obs": obs_buf,
            "actions": act_buf,
            "logp": logp_buf,
            "values": val_buf,
            "rewards": rew_buf,
            "dones": done_buf,
            "last_obs": np.asarray(mobs).copy(),
            "episode_returns": np.asarray(ep_returns, np.float64),
            "episode_lengths": np.asarray(ep_lengths, np.int64),
        }

    def evaluate(self, params, num_episodes: int = 10) -> Dict[str, float]:
        """Greedy rollouts to episode completion (fresh env instance so the
        training stream's auto-reset state is untouched)."""
        env = make_env(self._env_name, self.num_envs, **self._env_kwargs)
        params = to_device(params, self.device)
        obs, _ = env.reset()
        init_state = (
            to_device(self.module.initial_state(env.num_envs), self.device)
            if self._stateful else None
        )
        state = init_state
        eval_gen = torch.Generator(device=self.device)
        eval_gen.manual_seed(0)
        returns: list = []
        guard = 0
        while len(returns) < num_episodes and guard < 100_000:
            guard += 1
            mobs = obs if self._env_to_module is None else self._env_to_module(obs)
            if self._stateful:
                action, _, _, state = self._act_st_greedy(params, self._obs_tensor(mobs), state, eval_gen)
            else:
                action, _ = self._act_greedy(params, self._obs_tensor(mobs))
            action_np = action.cpu().numpy()
            if self._module_to_env is not None:
                action_np = self._module_to_env(action_np)
            obs, rew, term, trunc, info = env.step(action_np)
            done = (term | trunc).astype(np.float32)
            if self._stateful and done.any():
                state = self._reset_rows(state, torch.as_tensor(done, device=self.device), init_state)
            returns.extend(info.get("episode_returns", []))
        return {
            "episode_reward_mean": float(np.mean(returns[:num_episodes])) if returns else float("nan"),
            "episodes": len(returns[:num_episodes]),
        }

"""Multi-agent environment API (reference: `rllib/env/multi_agent_env.py`).

`MultiAgentEnv` follows the reference's dict-keyed contract: reset/step
exchange per-agent dicts, `terminateds["__all__"]` ends the episode.

TPU-first training shape: shared-policy multi-agent is a *vectorization*
problem — `SharedPolicyVectorEnv` flattens M env instances × A agents into
M·A policy slots so the stock EnvRunner/PPO/IMPALA machinery trains the
shared policy with zero special-casing (the reference reaches the same
shape via policy_mapping_fn to a single policy). Per-agent distinct
policies remain future work.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .vector import VectorEnv


class MultiAgentEnv:
    """Gymnasium-flavored multi-agent episode.

    reset(seed) -> ({agent: obs}, info)
    step({agent: action}) -> (obs_d, rew_d, terminated_d, truncated_d, info)
    where terminated_d/truncated_d carry a "__all__" key.
    """

    agents: List[str]
    observation_space = None  # per-agent (homogeneous) spaces
    action_space = None

    def reset(self, seed: Optional[int] = None) -> Tuple[Dict, dict]:
        raise NotImplementedError

    def step(self, action_dict: Dict) -> Tuple[Dict, Dict, Dict, Dict, dict]:
        raise NotImplementedError


def make_multi_agent(env_ctor: Callable, num_agents: int = 2):
    """Lift a single-agent vector env into an independent-agents
    MultiAgentEnv (reference analog: `rllib/env/multi_agent_env.py
    make_multi_agent`) — each agent steps its own copy of the env."""

    class _IndependentMA(MultiAgentEnv):
        def __init__(self, **kwargs):
            self._env = env_ctor(num_agents, **kwargs)  # one slot per agent
            self.agents = [f"agent_{i}" for i in range(num_agents)]
            self.observation_space = self._env.observation_space
            self.action_space = self._env.action_space
            self._live = np.ones(num_agents, bool)

        def reset(self, seed: Optional[int] = None):
            obs, info = self._env.reset(seed=seed)
            self._live[:] = True
            return {a: obs[i] for i, a in enumerate(self.agents)}, info

        def step(self, action_dict):
            acts = np.stack([action_dict[a] for a in self.agents])
            live_before = self._live.copy()
            obs, rew, term, trunc, info = self._env.step(acts)
            done = term | trunc
            self._live &= ~done
            obs_d = {a: obs[i] for i, a in enumerate(self.agents)}
            # A finished agent's slot auto-resets underneath (vector-env
            # contract); mask its post-done rewards/flags so the episode's
            # team return counts each agent's FIRST episode only.
            rew_d = {
                a: float(rew[i]) if live_before[i] else 0.0
                for i, a in enumerate(self.agents)
            }
            term_d = {
                a: bool(term[i]) and bool(live_before[i])
                for i, a in enumerate(self.agents)
            }
            trunc_d = {
                a: bool(trunc[i]) and bool(live_before[i])
                for i, a in enumerate(self.agents)
            }
            term_d["__all__"] = bool((~self._live).all())
            trunc_d["__all__"] = False
            return obs_d, rew_d, term_d, trunc_d, info

    return _IndependentMA


class SharedPolicyVectorEnv(VectorEnv):
    """Adapts M MultiAgentEnv instances to the VectorEnv contract with one
    slot per (instance, agent) pair — a shared policy acts for every agent.

    Episode stats report the TEAM return (sum over agents) once per episode.
    Agents that are done inside a live episode keep receiving their last
    observation and zero reward until "__all__" (standard padding)."""

    def __init__(self, make_ma_env: Callable[[], MultiAgentEnv], num_instances: int):
        self.instances = [make_ma_env() for _ in range(num_instances)]
        probe = self.instances[0]
        self.agents = list(probe.agents)
        self.num_envs = num_instances * len(self.agents)
        self.observation_space = probe.observation_space
        self.action_space = probe.action_space
        self._team_ret = np.zeros(num_instances, np.float64)
        self._ep_len = np.zeros(num_instances, np.int64)
        self._last_obs: List[Dict] = [{} for _ in range(num_instances)]

    def _flatten(self, per_instance_obs: List[Dict]) -> np.ndarray:
        rows = []
        for obs_d in per_instance_obs:
            rows.extend(obs_d[a] for a in self.agents)
        return np.stack(rows).astype(np.float32)

    def reset(self, seed: Optional[int] = None):
        all_obs = []
        for i, inst in enumerate(self.instances):
            obs_d, _ = inst.reset(seed=None if seed is None else seed + i)
            self._last_obs[i] = dict(obs_d)
            all_obs.append(obs_d)
        self._team_ret[:] = 0.0
        self._ep_len[:] = 0
        return self._flatten(all_obs), {}

    def step(self, actions: np.ndarray):
        A = len(self.agents)
        obs_rows, rew_rows, term_rows, trunc_rows = [], [], [], []
        ep_returns, ep_lengths = [], []
        for i, inst in enumerate(self.instances):
            act_d = {a: actions[i * A + k] for k, a in enumerate(self.agents)}
            obs_d, rew_d, term_d, trunc_d, _ = inst.step(act_d)
            self._last_obs[i].update(obs_d)
            self._team_ret[i] += sum(rew_d.values())
            self._ep_len[i] += 1
            done_all = term_d.get("__all__", False) or trunc_d.get("__all__", False)
            if done_all:
                ep_returns.append(self._team_ret[i])
                ep_lengths.append(int(self._ep_len[i]))
                self._team_ret[i] = 0.0
                self._ep_len[i] = 0
                obs_d, _ = inst.reset()
                self._last_obs[i] = dict(obs_d)
            for a in self.agents:
                obs_rows.append(self._last_obs[i][a])
                rew_rows.append(rew_d.get(a, 0.0))
                term_rows.append(done_all or term_d.get(a, False))
                trunc_rows.append(trunc_d.get(a, False))
        info = {"episode_returns": ep_returns, "episode_lengths": ep_lengths}
        return (
            np.stack(obs_rows).astype(np.float32),
            np.asarray(rew_rows, np.float32),
            np.asarray(term_rows, bool),
            np.asarray(trunc_rows, bool),
            info,
        )

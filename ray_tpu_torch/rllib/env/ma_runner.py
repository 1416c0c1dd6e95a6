"""Multi-policy rollout collection over MultiAgentEnv instances.

Reference analog: `rllib/env/multi_agent_env_runner.py` +
`rllib/policy/policy_map.py` — a policy-mapping fn routes each agent to a
policy; sampling yields ONE batch PER POLICY. TPU-native shape discipline:
each policy's batch is a dense time-major [T, n_slots] block (slot =
(env instance, agent) pair mapped to that policy), so the per-policy learner
update keeps fixed shapes; agents sitting out a step (done inside a live
episode) are padded with last-obs/zero-reward exactly like
SharedPolicyVectorEnv pads. The port (of `ray_tpu/rllib/env/ma_runner.py`)
runs each policy's forward in torch on the runner's `device` (None: the
card), drawing actions with the runner's `torch.Generator`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ...device import resolve_device
from ..utils.tree import to_device
from .multi_agent import MultiAgentEnv


class MultiAgentEnvRunner:
    """Steps M MultiAgentEnv instances; emits {policy_id: time-major batch}.

    `modules` maps policy_id -> RLModule; `policy_mapping_fn(agent_id)`
    routes agents. Weight SHARING (self-play) is expressed by mapping many
    agents to one policy_id."""

    def __init__(
        self,
        *,
        make_env: Callable[[], MultiAgentEnv],
        modules: Dict[str, Any],
        policy_mapping_fn: Callable[[str], str],
        num_instances: int = 4,
        rollout_len: int = 64,
        seed: Optional[int] = None,
        device=None,
    ):
        self.instances = [make_env() for _ in range(num_instances)]
        probe = self.instances[0]
        self.agents: List[str] = list(probe.agents)
        self.mapping = {a: policy_mapping_fn(a) for a in self.agents}
        unknown = set(self.mapping.values()) - set(modules)
        if unknown:
            raise ValueError(f"policy_mapping_fn routed to unknown {unknown}")
        self.modules = modules
        self.rollout_len = rollout_len
        self.num_instances = num_instances
        # Per-policy slot layout: slots are (instance, agent) pairs, agent
        # order fixed — batch column j of policy p is always the same pair.
        self.slots: Dict[str, List[str]] = {}
        for a in self.agents:
            self.slots.setdefault(self.mapping[a], []).append(a)
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed if seed is not None else np.random.randint(2**31))
        self._act = {
            pid: torch.no_grad()(self._make_act(mod)) for pid, mod in modules.items()
        }
        self._greedy = {
            pid: torch.no_grad()(self._make_greedy(mod)) for pid, mod in modules.items()
        }
        self._obs: List[Dict] = []
        self._team_ret = np.zeros(num_instances)
        self._agent_ret = [
            {a: 0.0 for a in self.agents} for _ in range(num_instances)
        ]
        self._ep_len = np.zeros(num_instances, np.int64)
        self._reset_all(seed)

    @staticmethod
    def _make_act(mod):
        def _act(params, obs, gen):
            dist, value = mod.forward(params, obs)
            action = mod.sample(gen, dist)
            return action, mod.log_prob(dist, action), value
        return _act

    @staticmethod
    def _make_greedy(mod):
        def _greedy(params, obs):
            dist, _ = mod.forward(params, obs)
            return mod.greedy(dist)
        return _greedy

    def _reset_all(self, seed=None):
        self._obs = []
        for i, inst in enumerate(self.instances):
            obs_d, _ = inst.reset(seed=None if seed is None else seed + i)
            self._obs.append(dict(obs_d))
        self._team_ret[:] = 0.0
        self._ep_len[:] = 0

    def _policy_obs(self, pid: str) -> np.ndarray:
        rows = [
            self._obs[i][a]
            for i in range(self.num_instances)
            for a in self.slots[pid]
        ]
        return np.stack(rows).astype(np.float32)

    def ping(self) -> str:
        return "ok"

    # ------------------------------------------------------------- sampling
    def sample(self, params_by_policy: Dict[str, Any]) -> Dict[str, Dict]:
        """Collect `rollout_len` steps; returns per-policy time-major
        batches (obs/actions/logp/values/rewards/dones/last_obs) plus
        '__stats__' with team episode returns."""
        params_dev = {
            pid: to_device(p, self.device) for pid, p in params_by_policy.items()
        }
        T = self.rollout_len
        bufs = {
            pid: {
                "obs": [], "actions": [], "logp": [], "values": [],
                "rewards": [], "dones": [],
            }
            for pid in self.slots
        }
        ep_returns: List[float] = []
        ep_lengths: List[int] = []
        policy_returns: Dict[str, List[float]] = {}
        for _ in range(T):
            step_actions: Dict[str, Dict[str, np.ndarray]] = {}
            for pid, agents in self.slots.items():
                obs = self._policy_obs(pid)
                action, logp, value = self._act[pid](
                    params_dev[pid], torch.as_tensor(obs, device=self.device), self._gen)
                action = action.cpu().numpy()
                bufs[pid]["obs"].append(obs)
                bufs[pid]["actions"].append(action)
                bufs[pid]["logp"].append(logp.cpu().numpy())
                bufs[pid]["values"].append(value.cpu().numpy())
                k = 0
                for i in range(self.num_instances):
                    for a in agents:
                        step_actions.setdefault(i, {})[a] = action[k]
                        k += 1
            rew_rows = {pid: [] for pid in self.slots}
            done_rows = {pid: [] for pid in self.slots}
            for i, inst in enumerate(self.instances):
                obs_d, rew_d, term_d, trunc_d, _ = inst.step(step_actions[i])
                all_done = term_d.get("__all__", False) or trunc_d.get(
                    "__all__", False
                )
                self._team_ret[i] += sum(
                    rew_d.get(a, 0.0) for a in self.agents
                )
                for a in self.agents:
                    self._agent_ret[i][a] += rew_d.get(a, 0.0)
                self._ep_len[i] += 1
                for a in self.agents:
                    # Done-inside-live-episode padding: keep last obs.
                    if a in obs_d:
                        self._obs[i][a] = obs_d[a]
                for pid, agents in self.slots.items():
                    for a in agents:
                        rew_rows[pid].append(rew_d.get(a, 0.0))
                        done_rows[pid].append(
                            float(
                                all_done
                                or term_d.get(a, False)
                                or trunc_d.get(a, False)
                            )
                        )
                if all_done:
                    ep_returns.append(float(self._team_ret[i]))
                    ep_lengths.append(int(self._ep_len[i]))
                    for pid, agents in self.slots.items():
                        policy_returns.setdefault(pid, []).append(
                            float(sum(self._agent_ret[i][a] for a in agents))
                        )
                    obs_d, _ = inst.reset()
                    self._obs[i] = dict(obs_d)
                    self._team_ret[i] = 0.0
                    self._agent_ret[i] = {a: 0.0 for a in self.agents}
                    self._ep_len[i] = 0
            for pid in self.slots:
                bufs[pid]["rewards"].append(
                    np.asarray(rew_rows[pid], np.float32)
                )
                bufs[pid]["dones"].append(np.asarray(done_rows[pid], np.float32))
        out: Dict[str, Dict] = {}
        for pid, b in bufs.items():
            out[pid] = {k: np.stack(v) for k, v in b.items()}
            out[pid]["last_obs"] = self._policy_obs(pid)
        out["__stats__"] = {
            "episode_returns": np.asarray(ep_returns),
            "episode_lengths": np.asarray(ep_lengths, np.int64),
            "policy_episode_returns": {
                pid: np.asarray(v) for pid, v in policy_returns.items()
            },
        }
        return out

    # ------------------------------------------------------------ evaluate
    def evaluate(self, params_by_policy: Dict[str, Any], episodes: int) -> Dict:
        params_dev = {
            pid: to_device(p, self.device) for pid, p in params_by_policy.items()
        }
        rets: List[float] = []
        inst = self.instances[0]
        for _ in range(episodes):
            obs_d, _ = inst.reset()
            self._obs[0] = dict(obs_d)
            total, steps = 0.0, 0
            while steps < 2000:
                act_d = {}
                for pid, agents in self.slots.items():
                    rows = np.stack(
                        [self._obs[0][a] for a in agents]
                    ).astype(np.float32)
                    acts = self._greedy[pid](
                        params_dev[pid], torch.as_tensor(rows, device=self.device)).cpu().numpy()
                    for k, a in enumerate(agents):
                        act_d[a] = acts[k]
                obs_d, rew_d, term_d, trunc_d, _ = inst.step(act_d)
                total += sum(rew_d.get(a, 0.0) for a in self.agents)
                for a in self.agents:
                    if a in obs_d:
                        self._obs[0][a] = obs_d[a]
                steps += 1
                if term_d.get("__all__") or trunc_d.get("__all__"):
                    break
            rets.append(total)
        return {
            "episode_reward_mean": float(np.mean(rets)) if rets else float("nan"),
            "episodes": len(rets),
        }

"""Multi-agent PPO: N policies trained from one multi-agent rollout stream.

Reference analog: the multi-agent training stack —
`rllib/policy/policy_map.py:1` (policy registry + mapping) +
`rllib/env/multi_agent_env.py:1` (env contract) + the per-policy batch
split in `MultiAgentBatch`. Each policy keeps its OWN fixed-shape PPO
update (GAE + epochs + minibatching + optimizer — see
`ppo.make_ppo_update`) on its own learner on `config.device` (None: the
card; the reference, `ray_tpu/rllib/algorithms/multi_agent_ppo.py:7-10`,
jits each into one XLA program); the mapping fn fixes slot layouts at
setup so batch shapes never change across iterations.

Self-play weight sharing: map several agents to one policy id — they share
one module, one learner, one parameter set (the `shared_policy=True`
convenience maps ALL agents to "shared").
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, List, Optional

from ..core.learner import Learner
from ..env.ma_runner import MultiAgentEnvRunner
from .algorithm import Algorithm
from .ppo import PPOConfig, make_ppo_update


class MultiAgentPPOConfig(PPOConfig):
    def __init__(self):
        super().__init__()
        self.policies: List[str] = []
        self.policy_mapping_fn: Optional[Callable[[str], str]] = None
        self.shared_policy: bool = False
        self.ma_env_maker: Optional[Callable] = None
        self.num_instances: int = 8

    def multi_agent(self, *, policies: Optional[List[str]] = None,
                    policy_mapping_fn: Optional[Callable] = None,
                    shared_policy: bool = False):
        """Reference analog: `AlgorithmConfig.multi_agent(policies=...,
        policy_mapping_fn=...)`."""
        if policies is not None:
            self.policies = list(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        self.shared_policy = shared_policy
        return self

    def environment(self, env=None, *, env_config=None, ma_env_maker=None):
        if ma_env_maker is not None:
            self.ma_env_maker = ma_env_maker
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = env_config
        return self

    def validate(self):
        if self.ma_env_maker is None:
            raise ValueError(
                "environment(ma_env_maker=<MultiAgentEnv factory>) is required"
            )
        # PPO's divisibility check, minus the base env-NAME requirement
        # (multi-agent envs come from the factory, not the registry).
        if self.train_batch_size % self.minibatch_size != 0:
            raise ValueError(
                f"train_batch_size {self.train_batch_size} must be divisible "
                f"by minibatch_size {self.minibatch_size}"
            )
        if self.shared_policy:
            return
        if not self.policies:
            raise ValueError("multi_agent(policies=[...]) is required")
        if self.policy_mapping_fn is None:
            raise ValueError("multi_agent(policy_mapping_fn=...) is required")


class MultiAgentPPO(Algorithm):
    config_class = MultiAgentPPOConfig

    # ---------------------------------------------------------------- setup
    def setup(self):
        cfg = self.config
        make_ma = cfg.ma_env_maker
        if make_ma is None:
            raise ValueError(
                "MultiAgentPPO needs environment(ma_env_maker=<MultiAgentEnv "
                "factory>)"
            )
        probe = make_ma()
        self.agents = list(probe.agents)
        self.observation_space = probe.observation_space
        self.action_space = probe.action_space
        if cfg.shared_policy:
            cfg.policies = ["shared"]
            cfg.policy_mapping_fn = lambda a: "shared"
        self.mapping = {a: cfg.policy_mapping_fn(a) for a in self.agents}

        self.modules: Dict[str, object] = {
            pid: self._make_module() for pid in cfg.policies
        }
        from ..utils.optim import make_optimizer

        self.learners: Dict[str, Learner] = {}
        for pid, mod in self.modules.items():
            opt = make_optimizer(cfg)
            # reference: Learner(mod, make_ppo_update(mod, opt, cfg), seed=cfg.seed)
            # (`multi_agent_ppo.py:108-110`): the learners on the config's device.
            learner = Learner(
                mod, make_ppo_update(mod, opt, cfg), seed=cfg.seed, device=cfg.device
            )
            learner.opt_state = opt.init(learner.params)
            self.learners[pid] = learner
        self._weights = {
            pid: l.params for pid, l in self.learners.items()
        }
        self._runner = MultiAgentEnvRunner(
            make_env=make_ma,
            modules=self.modules,
            policy_mapping_fn=cfg.policy_mapping_fn,
            num_instances=cfg.num_instances,
            rollout_len=cfg.derived_rollout_len(),
            seed=cfg.seed,
            device=cfg.device,  # reference: no device (`multi_agent_ppo.py:116-123`)
        )
        self._eval_runner: Optional[MultiAgentEnvRunner] = None
        self._policy_returns: Dict[str, List[float]] = {}

    # Single-policy plumbing the base class expects but MA replaces:
    @property
    def learner_group(self):  # save/stop compatibility shim
        class _Shim:
            def __init__(shim):
                pass

            def save_state(shim):
                return {
                    pid: {"params": l.params, "opt_state": l.opt_state}
                    for pid, l in self.learners.items()
                }

            def load_state(shim, state):
                for pid, s in state.items():
                    self.learners[pid].params = s["params"]
                    self.learners[pid].opt_state = s["opt_state"]
                self._weights = {
                    pid: l.params for pid, l in self.learners.items()
                }

            def get_weights(shim):
                return {pid: l.params for pid, l in self.learners.items()}

            def shutdown(shim):
                pass

        return _Shim()

    # ---------------------------------------------------------------- train
    def training_step(self) -> Dict:
        batches = self._runner.sample(self._weights)
        stats = batches.pop("__stats__")
        self._episodes_this_iter += len(stats["episode_returns"])
        self._episode_returns.extend(stats["episode_returns"].tolist())
        self._episode_lengths.extend(stats["episode_lengths"].tolist())
        for pid, rets in stats["policy_episode_returns"].items():
            self._policy_returns.setdefault(pid, []).extend(rets.tolist())
            del self._policy_returns[pid][:-100]
        metrics: Dict[str, Dict] = {}
        steps = 0
        for pid, batch in batches.items():
            learner = self.learners[pid]
            m = learner.update(batch)
            metrics[pid] = {k: float(v) for k, v in m.items()}
            T, B = batch["rewards"].shape
            steps += T * B
        self._weights = {pid: l.params for pid, l in self.learners.items()}
        return {
            "_env_steps_this_iter": steps,
            "info": {"learner": metrics},
            "policy_reward_mean": {
                pid: (float(sum(v) / len(v)) if v else float("nan"))
                for pid, v in self._policy_returns.items()
            },
        }

    # ------------------------------------------------------------ evaluate
    def evaluate(self) -> Dict:
        if self._eval_runner is None:
            self._eval_runner = MultiAgentEnvRunner(
                make_env=self.config.ma_env_maker,
                modules=self.modules,
                policy_mapping_fn=self.config.policy_mapping_fn,
                num_instances=1,
                rollout_len=self.config.derived_rollout_len(),
                seed=(self.config.seed or 0) + 10_000,
                device=self.config.device,  # reference: no device (`multi_agent_ppo.py:187-194`)
            )
        out = self._eval_runner.evaluate(
            self._weights, self.config.evaluation_num_episodes
        )
        return {**out, "num_eval_runners": 1}

    def stop(self):
        pass

    # --------------------------------------------------------- checkpoints
    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "wb") as f:
            pickle.dump(
                {
                    "learner": self.learner_group.save_state(),
                    "iteration": self.iteration,
                    "timesteps_total": self._timesteps_total,
                },
                f,
            )
        return checkpoint_dir

    def restore(self, checkpoint_dir: str):
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self.learner_group.load_state(state["learner"])
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]


MultiAgentPPOConfig.algo_class = MultiAgentPPO

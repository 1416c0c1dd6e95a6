"""Algorithm — the trainable RL driver (reference: `rllib/algorithms/algorithm.py:796`
`step`, `:1575 training_step`).

`train()` runs one iteration: sample from EnvRunners (driver-local or
ray_tpu_torch actors), update the Learner, and sync weights back through
the object store — the reference's PPO shape (SURVEY.md §3.5) minus torch
DDP. The learner and the local runner run on `config.device` (None: the
card); remote runners are CPU actors and run their forward on the CPU (the
reference, `ray_tpu/rllib/algorithms/algorithm.py:4-6`, jits one program
per learner update and runs every runner on JAX's backend).  `Algorithm` duck-types the Tune `Trainable` contract
(`train/save/restore/stop`) so `ray_tpu_torch.tune.Tuner` can drive it.
"""

from __future__ import annotations

import collections
import os
import pickle
import time
from typing import Dict, List, Optional

import numpy as np

from ..core.learner import Learner, LearnerGroup
from ..env import make_env
from ..env.env_runner import EnvRunner
from ..env.spaces import Box, Discrete
from .algorithm_config import AlgorithmConfig


class Algorithm:
    config_class = AlgorithmConfig

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        self.iteration = 0
        self._timesteps_total = 0
        self._episode_returns = collections.deque(maxlen=100)
        self._episode_lengths = collections.deque(maxlen=100)
        self._episodes_this_iter = 0
        self._remote_runners: List = []
        self._local_runner: Optional[EnvRunner] = None
        self._ray = None
        self._podracer = None  # Anakin/Sebulba plane when configured
        self.setup()

    # ---------------------------------------------------------------- setup
    def setup(self):
        cfg = self.config
        probe = make_env(cfg.env, 1, **cfg.env_config)
        self.observation_space = probe.observation_space
        self.action_space = probe.action_space
        probe.close()

        self.module = self._make_module()

        rollout_len = cfg.derived_rollout_len()
        runner_kwargs = dict(
            env_name=cfg.env,
            num_envs=cfg.num_envs_per_env_runner,
            module=self.module,
            rollout_len=rollout_len,
            env_kwargs=cfg.env_config,
            env_to_module=(
                cfg.env_to_module_connector()
                if cfg.env_to_module_connector is not None else None
            ),
            module_to_env=(
                cfg.module_to_env_connector()
                if cfg.module_to_env_connector is not None else None
            ),
        )
        self._runner_kwargs = runner_kwargs  # eval runners reuse the recipe

        if cfg.podracer_plane is not None:
            # Podracer planes replace BOTH the LearnerGroup and the sampling
            # runners — the plane owns the full sample->update loop. Eval
            # still rides the classic EnvRunner recipe above (same module,
            # weights pulled from the plane).
            self.learner_group = None
            self._podracer = self._build_podracer_plane()
            self._weights = self._podracer.get_weights()
            return

        # reference: LearnerGroup(self._make_learner, remote=cfg.remote_learner)
        # (`ray_tpu/rllib/algorithms/algorithm.py:82-84`); a remote learner on
        # the card needs a GPU worker.
        self.learner_group = LearnerGroup(
            self._make_learner, remote=cfg.remote_learner, device=cfg.device
        )
        self._weights = self.learner_group.get_weights()
        if cfg.num_env_runners > 0:
            import ray_tpu_torch

            self._ray = ray_tpu_torch
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init(ignore_reinit_error=True)
            # reference: ray_tpu.remote(EnvRunner) on JAX's default backend
            # (`ray_tpu/rllib/algorithms/algorithm.py:92-96`). A remote runner
            # is a CPU actor (no card) and runs its forward on the CPU.
            RemoteRunner = ray_tpu_torch.remote(num_cpus=1)(EnvRunner)
            self._remote_runners = [
                RemoteRunner.remote(seed=cfg.seed + i, device="cpu", **runner_kwargs)
                for i in range(cfg.num_env_runners)
            ]
            ray_tpu_torch.get([r.ping.remote() for r in self._remote_runners])
        else:
            # reference: EnvRunner(seed=cfg.seed, **runner_kwargs) (`algorithm.py:99`)
            self._local_runner = EnvRunner(seed=cfg.seed, device=cfg.device, **runner_kwargs)

    def _make_module(self):
        from ..core.rl_module import DiscretePolicyModule, GaussianPolicyModule

        hidden = tuple(self.config.model.get("hidden", (64, 64)))
        obs_dim = int(np.prod(self.observation_space.shape))
        if self.config.env_to_module_connector is not None:
            # The module sees CONNECTOR-transformed observations — size its
            # input from a transformed probe batch, not the raw space.
            probe_env = make_env(self.config.env, 1, **self.config.env_config)
            probe_obs, _ = probe_env.reset(seed=0)
            probe_env.close()
            out = self.config.env_to_module_connector()(probe_obs)
            obs_dim = int(np.prod(np.asarray(out).shape[1:]))
        model = dict(self.config.model)
        if isinstance(self.action_space, Discrete):
            return DiscretePolicyModule(
                obs_dim, self.action_space.n, hidden, model=model
            )
        if isinstance(self.action_space, Box):
            return GaussianPolicyModule(
                obs_dim, int(np.prod(self.action_space.shape)), hidden,
                model=model,
            )
        raise TypeError(f"Unsupported action space {self.action_space}")

    def _make_learner(self) -> Learner:
        raise NotImplementedError

    # ------------------------------------------------------------ podracer
    def _build_podracer_plane(self):
        plane = self.config.podracer_plane
        if plane == "anakin":
            from ..podracer.anakin import AnakinDriver

            return AnakinDriver(self)
        if plane == "sebulba":
            from ..podracer.sebulba import SebulbaDriver

            return SebulbaDriver(self)
        raise ValueError(f"Unknown podracer plane {plane!r}")

    def _podracer_update_factory(self, axis_name=None):
        """(opt, update_fn) for the podracer planes — algorithm-specific.

        `update_fn(state, batch, rng) -> (state, metrics)` over the
        time-major batch dict; `axis_name` names the pmap axis when the
        plane shards over devices (gradients must pmean across it).
        """
        raise NotImplementedError(
            f"{type(self).__name__} has no podracer update factory "
            "(PPO is the first podracer-capable algorithm)"
        )

    # ---------------------------------------------------------------- train
    def train(self) -> Dict:
        t0 = time.perf_counter()
        self.iteration += 1
        self._episodes_this_iter = 0
        if self._podracer is not None:
            result = self._podracer.training_step()
            self._weights = self._podracer.get_weights()
        else:
            result = self.training_step()
        dt = time.perf_counter() - t0
        steps_this_iter = result.pop("_env_steps_this_iter", 0)
        self._timesteps_total += steps_this_iter
        result.update(
            training_iteration=self.iteration,
            timesteps_total=self._timesteps_total,
            num_env_steps_sampled_this_iter=steps_this_iter,
            episode_reward_mean=(
                float(np.mean(self._episode_returns)) if self._episode_returns else float("nan")
            ),
            episode_len_mean=(
                float(np.mean(self._episode_lengths)) if self._episode_lengths else float("nan")
            ),
            episodes_this_iter=self._episodes_this_iter,
            time_this_iter_s=dt,
            env_steps_per_sec=steps_this_iter / dt if dt > 0 else 0.0,
        )
        # Periodic evaluation on DEDICATED runners (reference:
        # evaluation_interval + evaluation workers).
        interval = self.config.evaluation_interval
        if interval and self.iteration % interval == 0:
            result["evaluation"] = self.evaluate()
        return result

    def training_step(self) -> Dict:
        raise NotImplementedError

    # ------------------------------------------------------------- sampling
    def _sample_batches(self) -> List[Dict[str, np.ndarray]]:
        """One rollout fragment from every runner (parallel when remote)."""
        if self._remote_runners:
            w_ref = self._ray.put(self._weights)
            batches = self._ray.get([r.sample.remote(w_ref) for r in self._remote_runners])
        else:
            batches = [self._local_runner.sample(self._weights)]
        for b in batches:
            returns = b.pop("episode_returns").tolist()
            self._episodes_this_iter += len(returns)
            self._episode_returns.extend(returns)
            self._episode_lengths.extend(b.pop("episode_lengths").tolist())
        return batches

    @staticmethod
    def _concat_batches(batches: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        """Concatenate runner fragments along the env axis (axis=1; time-major)."""
        if len(batches) == 1:
            return batches[0]
        out = {}
        for k in batches[0]:
            axis = 0 if k == "last_obs" else 1
            out[k] = np.concatenate([b[k] for b in batches], axis=axis)
        return out

    # ---------------------------------------------------------- evaluation
    # Reference analog: the evaluation-WORKER plane — greedy rollouts on
    # runners SEPARATE from the training stream (training envs keep their
    # auto-reset state; eval never perturbs the sampling distribution).
    def _ensure_eval_runners(self):
        if getattr(self, "_eval_runners", None) is not None:
            return
        cfg = self.config
        kwargs = dict(self._runner_kwargs)
        if cfg.evaluation_num_env_runners > 0:
            import ray_tpu_torch

            from ..env.env_runner import EnvRunner

            RemoteRunner = ray_tpu_torch.remote(num_cpus=1)(EnvRunner)
            # reference: no device= (`algorithm.py:232-235`); a CPU actor has no card.
            self._eval_runners = [
                RemoteRunner.remote(seed=cfg.seed + 10_000 + i, device="cpu", **kwargs)
                for i in range(cfg.evaluation_num_env_runners)
            ]
            ray_tpu_torch.get([r.ping.remote() for r in self._eval_runners])
        else:
            from ..env.env_runner import EnvRunner

            # reference: EnvRunner(seed=cfg.seed + 10_000, **kwargs) (`algorithm.py:240-242`)
            self._eval_runners = [
                EnvRunner(seed=cfg.seed + 10_000, device=cfg.device, **kwargs)
            ]

    def evaluate(self) -> Dict:
        self._ensure_eval_runners()
        n = self.config.evaluation_num_episodes
        runners = self._eval_runners
        if self.config.evaluation_num_env_runners > 0:
            import ray_tpu_torch

            # Exact split: base episodes everywhere + the remainder spread
            # over the first runners (a flat max(1, n//k) under- or
            # over-shoots the configured duration).
            base, rem = divmod(n, len(runners))
            shares = [
                base + (1 if i < rem else 0) for i in range(len(runners))
            ]
            outs = ray_tpu_torch.get(
                [
                    r.evaluate.remote(self._weights, share)
                    for r, share in zip(runners, shares) if share > 0
                ]
            )
        else:
            outs = [runners[0].evaluate(self._weights, n)]
        total = sum(o.get("episodes", 0) for o in outs)
        means = [
            o["episode_reward_mean"] * o.get("episodes", 0)
            for o in outs if o.get("episodes", 0)
        ]
        return {
            "episode_reward_mean": (sum(means) / total) if total else float("nan"),
            "episodes": total,
            "num_eval_runners": len(runners),
        }

    # --------------------------------------------------------- checkpoints
    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        learner_state = (
            self._podracer.save_state()
            if self._podracer is not None
            else self.learner_group.save_state()
        )
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "learner": learner_state,
                    "iteration": self.iteration,
                    "timesteps_total": self._timesteps_total,
                    "config": self.config.to_dict(),
                },
                f,
            )
        return checkpoint_dir

    def restore(self, checkpoint_dir: str):
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "rb") as f:
            state = pickle.load(f)
        if self._podracer is not None:
            self._podracer.load_state(state["learner"])
            self._weights = self._podracer.get_weights()
        else:
            self.learner_group.load_state(state["learner"])
            self._weights = self.learner_group.get_weights()
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, config: AlgorithmConfig):
        algo = cls(config)
        algo.restore(checkpoint_dir)
        return algo

    def stop(self):
        if self._remote_runners:
            for r in self._remote_runners:
                try:
                    self._ray.kill(r)
                except Exception:  # noqa: BLE001
                    pass
            self._remote_runners = []
        # Dedicated eval runners die with the algorithm too (leaking one
        # pair per Tune trial would eat the cluster's CPUs).
        if self.config.evaluation_num_env_runners > 0:
            import ray_tpu_torch

            for r in getattr(self, "_eval_runners", None) or []:
                try:
                    ray_tpu_torch.kill(r)
                except Exception:  # noqa: BLE001
                    pass
        self._eval_runners = None
        if self._podracer is not None:
            self._podracer.stop()
            self._podracer = None
        if self.learner_group is not None:
            self.learner_group.shutdown()

    # Tune function-trainable adapter
    def __call__(self, _config: Optional[dict] = None):
        return self.train()

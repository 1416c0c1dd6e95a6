"""AlgorithmConfig — fluent builder (reference: `rllib/algorithms/algorithm_config.py`).

Same chaining surface as the reference (`.environment().env_runners()
.training().build()`); only TPU-relevant knobs are kept. Each algorithm
subclasses with its own training() keys.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Type


class AlgorithmConfig:
    algo_class: Optional[Type] = None

    def __init__(self):
        # environment
        self.env: Optional[str] = None
        self.env_config: Dict[str, Any] = {}
        # env runners
        self.num_env_runners: int = 0  # 0 => sample in the driver process
        self.num_envs_per_env_runner: int = 8
        self.rollout_fragment_length: Optional[int] = None  # derived if None
        # Connector factories (reference: `rllib/connectors/`): zero-arg
        # callables returning a Connector/ConnectorPipeline; factories (not
        # instances) because every runner actor needs its own state.
        self.env_to_module_connector = None
        self.module_to_env_connector = None
        # training (common)
        self.gamma: float = 0.99
        self.lr: float = 3e-4
        self.train_batch_size: int = 2048
        self.model: Dict[str, Any] = {"hidden": (64, 64)}
        self.grad_clip: Optional[float] = 0.5
        # resources
        self.num_learners: int = 0
        self.use_mesh: bool = False
        self.remote_learner: bool = False
        # The learner's and the local runner's device (None: the card), as
        # the port's other entry points take device= (reference: JAX's
        # default backend, `ray_tpu/rllib/algorithms/algorithm_config.py:36-39`).
        self.device: Optional[str] = None
        # podracer planes (arxiv 2104.06272): None keeps the classic
        # EnvRunner/LearnerGroup path; "anakin" fuses env+learner into one
        # jit; "sebulba" splits an actor gang from a learner over the block
        # transport.
        self.podracer_plane: Optional[str] = None
        self.podracer_num_envs: int = 64        # total batched envs (anakin)
        self.podracer_rollout_len: Optional[int] = None  # derived if None
        self.podracer_num_devices: int = 1      # anakin: pmap width
        self.podracer_num_actors: int = 2       # sebulba: actor-gang size
        self.podracer_envs_per_actor: int = 8   # sebulba: VectorEnv width
        self.podracer_broadcast_interval: int = 1  # sebulba: param sync cadence
        self.podracer_min_actors: int = 1       # sebulba: elastic floor
        self.podracer_max_restarts: int = 3     # sebulba: reshape budget
        # debugging
        self.seed: int = 0
        # evaluation (reference: the evaluation-worker config in
        # `algorithm_config.py` — evaluation_interval /
        # evaluation_num_env_runners / evaluation_duration)
        self.evaluation_num_episodes: int = 10
        self.evaluation_interval: Optional[int] = None  # iterations; None=off
        self.evaluation_num_env_runners: int = 0  # 0 = dedicated local runner

    # ------------------------------------------------------- builder API
    def environment(self, env: Optional[str] = None, *, env_config: Optional[dict] = None) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def env_runners(
        self,
        *,
        num_env_runners: Optional[int] = None,
        num_envs_per_env_runner: Optional[int] = None,
        rollout_fragment_length: Optional[int] = None,
        **_compat,
    ) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if "env_to_module_connector" in _compat:
            self.env_to_module_connector = _compat.pop("env_to_module_connector")
        if "module_to_env_connector" in _compat:
            self.module_to_env_connector = _compat.pop("module_to_env_connector")
        return self

    # reference old-stack alias
    rollouts = env_runners

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise AttributeError(f"Unknown training key {k!r} for {type(self).__name__}")
            setattr(self, k, v)
        return self

    # reference: no device= (`ray_tpu/rllib/algorithms/algorithm_config.py:100`)
    def resources(self, *, num_learners: Optional[int] = None, remote_learner: Optional[bool] = None,
                  device: Optional[str] = None, **_c) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        if remote_learner is not None:
            self.remote_learner = remote_learner
        if device is not None:
            self.device = device
        return self

    def framework(self, *_a, **_k) -> "AlgorithmConfig":
        return self  # always torch here (the reference: always JAX)

    def podracer(
        self,
        plane: Optional[str] = None,
        *,
        num_envs: Optional[int] = None,
        rollout_len: Optional[int] = None,
        num_devices: Optional[int] = None,
        num_actors: Optional[int] = None,
        envs_per_actor: Optional[int] = None,
        broadcast_interval: Optional[int] = None,
        min_actors: Optional[int] = None,
        max_restarts: Optional[int] = None,
    ) -> "AlgorithmConfig":
        """Select a Podracer execution plane (one config surface, two planes).

        `plane="anakin"` needs a functional JaxEnv form of `env` (env.step
        fused into the learner's jit); `plane="sebulba"` runs the numpy
        VectorEnvs on an actor gang shipping trajectories to a learner over
        the block transport. `plane=None` (default) keeps the classic path.
        """
        if plane is not None:
            self.podracer_plane = plane
        if num_envs is not None:
            self.podracer_num_envs = num_envs
        if rollout_len is not None:
            self.podracer_rollout_len = rollout_len
        if num_devices is not None:
            self.podracer_num_devices = num_devices
        if num_actors is not None:
            self.podracer_num_actors = num_actors
        if envs_per_actor is not None:
            self.podracer_envs_per_actor = envs_per_actor
        if broadcast_interval is not None:
            self.podracer_broadcast_interval = broadcast_interval
        if min_actors is not None:
            self.podracer_min_actors = min_actors
        if max_restarts is not None:
            self.podracer_max_restarts = max_restarts
        return self

    def debugging(self, *, seed: Optional[int] = None, **_c) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def evaluation(
        self,
        *,
        evaluation_num_episodes: Optional[int] = None,
        evaluation_duration: Optional[int] = None,  # reference alias
        evaluation_interval: Optional[int] = None,
        evaluation_num_env_runners: Optional[int] = None,
        **_c,
    ) -> "AlgorithmConfig":
        if evaluation_duration is not None:
            self.evaluation_num_episodes = evaluation_duration
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_num_env_runners is not None:
            self.evaluation_num_env_runners = evaluation_num_env_runners
        if evaluation_num_episodes is not None:
            self.evaluation_num_episodes = evaluation_num_episodes
        return self

    # ------------------------------------------------------------ build
    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in vars(self).items() if not k.startswith("_")}

    def validate(self) -> None:
        if self.env is None:
            raise ValueError("config.environment(env=...) is required")
        if self.podracer_plane not in (None, "anakin", "sebulba"):
            raise ValueError(
                f"podracer plane must be 'anakin' or 'sebulba', got "
                f"{self.podracer_plane!r}"
            )
        if self.podracer_plane == "anakin":
            # reference: podracer.jax_env.jax_env_registered and its JaxEnv
            # wording (`ray_tpu/rllib/algorithms/algorithm_config.py:190-197`).
            from ..podracer.torch_env import torch_env_registered

            if not torch_env_registered(self.env):
                raise ValueError(
                    f"Anakin needs a functional TorchEnv form of {self.env!r} "
                    "(register one via podracer.torch_env.register_torch_env, or "
                    "use the Sebulba plane for Python-loop envs)."
                )
        if self.podracer_plane == "sebulba":
            if self.podracer_num_actors < 1:
                raise ValueError("sebulba needs podracer_num_actors >= 1")
            if self.podracer_min_actors > self.podracer_num_actors:
                raise ValueError(
                    "podracer_min_actors must be <= podracer_num_actors"
                )

    def build(self) -> "Algorithm":  # noqa: F821
        if self.algo_class is None:
            raise ValueError(f"{type(self).__name__} has no algo_class")
        self.validate()
        return self.algo_class(self.copy())

    @property
    def num_samplers(self) -> int:
        return max(self.num_env_runners, 1)

    def derived_rollout_len(self) -> int:
        if self.rollout_fragment_length is not None:
            return self.rollout_fragment_length
        total_envs = self.num_samplers * self.num_envs_per_env_runner
        return max(self.train_batch_size // total_envs, 1)

    def derived_podracer_rollout_len(self) -> int:
        if self.podracer_rollout_len is not None:
            return self.podracer_rollout_len
        if self.podracer_plane == "sebulba":
            total = self.podracer_num_actors * self.podracer_envs_per_actor
        else:
            total = self.podracer_num_envs
        return max(self.train_batch_size // max(total, 1), 1)

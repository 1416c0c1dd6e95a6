"""TD3 — Twin Delayed Deep Deterministic Policy Gradient.

Reference analog: `rllib/algorithms/td3/td3.py` (DDPG + the three TD3
tricks): twin critics with the min-target, target-policy smoothing (clipped
Gaussian noise on the target action), and delayed policy/target updates.
The JAX reference (`ray_tpu/rllib/algorithms/td3.py`) runs all
`num_grad_steps` minibatch updates inside one jitted `lax.scan` per
iteration; the port runs the same steps in order on the learner's device,
each step one CUDA graph on the card (`optim.step_program`). The
target-policy noise is drawn apart from the update, from the learner's
generator (`update.with_draws` takes it); exploration noise is injected by
the EnvRunner-side `sample`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.learner import Learner
from ..core.rl_module import RLModule, _mlp_apply, _mlp_init
from ..env.spaces import Box
from ..utils import optim
from ..utils.replay_buffers import ReplayBuffer
from ..utils.tree import tree_map
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig
from .dqn import polyak


class TD3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.train_batch_size = 400        # env steps sampled per iteration
        self.replay_buffer_capacity: int = 100_000
        self.learning_starts: int = 1_000
        self.minibatch_size: int = 256
        self.num_grad_steps: int = 32      # grad steps per iteration
        self.tau: float = 0.005            # Polyak for targets
        self.exploration_noise: float = 0.1   # behavior-policy sigma
        self.target_noise: float = 0.2        # smoothing sigma
        self.noise_clip: float = 0.5
        self.policy_delay: int = 2            # actor updates every N critic steps
        self.use_twin_q: bool = True          # False → plain DDPG critic
        self.grad_clip = None


class TD3Module(RLModule):
    """Deterministic actor + twin critics; params = {actor, actor_t, q1, q2,
    q1_t, q2_t}. The EnvRunner 'dist' is the (unscaled) tanh action mean;
    `sample` adds exploration noise, `greedy` is the mean."""

    def __init__(self, obs_dim: int, act_dim: int, action_scale: float,
                 hidden=(256, 256), exploration_noise: float = 0.1):
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.action_scale = float(action_scale)
        self.hidden = tuple(hidden)
        self.exploration_noise = float(exploration_noise)

    def init(self, gen):
        # reference: three keys split from one (`td3.py:61`); the port draws
        # the actor, then each critic, from one generator.
        actor = _mlp_init(gen, (self.obs_dim, *self.hidden, self.act_dim), scale_last=0.01)
        q_sizes = (self.obs_dim + self.act_dim, *self.hidden, 1)
        q1 = _mlp_init(gen, q_sizes, scale_last=1.0)
        q2 = _mlp_init(gen, q_sizes, scale_last=1.0)
        return {
            "actor": actor,
            "actor_t": tree_map(torch.clone, actor),
            "q1": q1,
            "q2": q2,
            "q1_t": tree_map(torch.clone, q1),
            "q2_t": tree_map(torch.clone, q2),
        }

    # ---- heads ----
    def act(self, actor_params, obs):
        """Deterministic tanh action in [-1, 1] (unscaled)."""
        return torch.tanh(_mlp_apply(actor_params, obs, activation=torch.relu))

    def q_value(self, q_params, obs, actions_unit):
        x = torch.cat([obs, actions_unit], dim=-1)
        return _mlp_apply(q_params, x, activation=torch.relu)[..., 0]

    # ---- EnvRunner interface ----
    def forward(self, params, obs):
        return self.act(params["actor"], obs), torch.zeros(obs.shape[:-1], dtype=torch.float32, device=obs.device)

    def sample(self, gen, dist):
        noise = self.exploration_noise * torch.randn(dist.shape, generator=gen, dtype=dist.dtype,
                                                     device=dist.device)
        return torch.clamp(dist + noise, -1.0, 1.0) * self.action_scale

    def greedy(self, dist):
        return dist * self.action_scale

    def log_prob(self, dist, actions):
        # Deterministic policy: logp is meaningless; the runner records it
        # but TD3 never consumes it.
        return torch.zeros(dist.shape[:-1], dtype=torch.float32, device=dist.device)

    def entropy(self, dist):
        return torch.zeros(dist.shape[:-1], dtype=torch.float32, device=dist.device)


def make_td3_update(module: TD3Module, actor_opt, critic_opt, cfg: TD3Config):
    """update(state, batches, gen) -> (state, metrics) over [k, mb] stacked
    minibatches: the target-policy noise drawn from `gen` ([k, mb, act_dim]
    standard normals), then `update.with_draws(state, batches, draws)`, the
    update given them (the reference's `normal(key_i, actions.shape)` for
    `keys = split(rng, k)`, `td3.py:110-112,185`). `update.step` is one
    gradient step, `update.program` its `optim.step_program` and
    `update.scan_inputs(batches, draws)` their (inputs, variants)."""
    gamma, tau = cfg.gamma, cfg.tau

    def critic_loss(qs, params, mb, normal):
        # Target-policy smoothing: clipped noise on the target action.
        noise = torch.clamp(cfg.target_noise * normal, -cfg.noise_clip, cfg.noise_clip)
        next_a = torch.clamp(module.act(params["actor_t"], mb["next_obs"]) + noise, -1.0, 1.0)
        if cfg.use_twin_q:
            target_q = torch.minimum(
                module.q_value(params["q1_t"], mb["next_obs"], next_a),
                module.q_value(params["q2_t"], mb["next_obs"], next_a),
            )
        else:  # plain DDPG: single critic, no clipped-double trick
            target_q = module.q_value(params["q1_t"], mb["next_obs"], next_a)
        y = (mb["rewards"] + gamma * (1.0 - mb["dones"]) * target_q).detach()
        unit_a = mb["actions"] / module.action_scale
        q1 = module.q_value(qs["q1"], mb["obs"], unit_a)
        if cfg.use_twin_q:
            q2 = module.q_value(qs["q2"], mb["obs"], unit_a)
            loss = ((q1 - y) ** 2 + (q2 - y) ** 2).mean()
        else:
            loss = ((q1 - y) ** 2).mean()
        return loss, {"critic_loss": loss, "q_mean": q1.mean()}

    critic_keys = ("q1", "q2") if cfg.use_twin_q else ("q1",)

    def actor_loss(actor, params, mb):
        a = module.act(actor, mb["obs"])
        loss = -module.q_value(params["q1"], mb["obs"], a).mean()
        return loss, {"actor_loss": loss}

    critic_vg, actor_vg = optim.value_and_grad(critic_loss), optim.value_and_grad(actor_loss)

    def grad_step(state, inp, with_actor: bool):
        """One step of the reference's scan (`td3.py:146-183`); `with_actor`
        is its `lax.cond` on `step % policy_delay == 0`, a host branch on
        the step's index (each branch its own graph on the card)."""
        params, (a_opt, c_opt) = state
        mb = inp["mb"]
        qs_in = {k: params[k] for k in critic_keys}
        (qs, c_opt), c_aux = optim.gradient_step(critic_opt, critic_vg, (qs_in, c_opt), params, mb,
                                                 inp["noise"])
        params = {**params, **qs}
        if with_actor:
            (actor, a_opt), a_aux = optim.gradient_step(actor_opt, actor_vg, (params["actor"], a_opt), params, mb)
            params = {**params, "actor": actor}
            # Delayed Polyak of actor AND critic targets (TD3 couples
            # target updates to the policy cadence).
            with torch.no_grad():
                params = {**params, **{f"{k}_t": polyak(params[f"{k}_t"], params[k], tau)
                                       for k in ("actor", *critic_keys)}}
            a_loss = a_aux["actor_loss"]
        else:
            a_loss = torch.zeros((), dtype=torch.float32, device=c_aux["critic_loss"].device)
        aux = {"critic_loss": c_aux["critic_loss"], "actor_loss": a_loss, "q_mean": c_aux["q_mean"]}
        return (params, (a_opt, c_opt)), aux

    program = optim.step_program(grad_step)

    def scan_inputs(batches, draws):
        # The scan's step counter starts at 0 each update (`td3.py:186`).
        k = batches["obs"].shape[0]
        return {"mb": batches, "noise": draws}, [i % cfg.policy_delay == 0 for i in range(k)]

    def with_draws(state, batches, draws):
        return program(state, *scan_inputs(batches, draws))

    def update(state, batches, gen):
        draws = torch.randn(batches["actions"].shape, generator=gen, dtype=torch.float32, device=gen.device)
        return with_draws(state, batches, draws)

    update.with_draws = with_draws
    update.step = grad_step
    update.program = program
    update.scan_inputs = scan_inputs
    return update


class TD3(Algorithm):
    config_class = TD3Config

    def setup(self):
        super().setup()
        cfg = self.config
        obs_dim = int(np.prod(self.observation_space.shape))
        act_dim = int(np.prod(self.action_space.shape))
        self._buffer = ReplayBuffer(
            cfg.replay_buffer_capacity, obs_dim,
            act_shape=(act_dim,), act_dtype=np.float32,
        )
        self._np_rng = np.random.default_rng(cfg.seed)

    def _make_module(self):
        if not isinstance(self.action_space, Box):
            raise TypeError("TD3 requires a continuous (Box) action space")
        hidden = tuple(self.config.model.get("hidden", (256, 256)))
        obs_dim = int(np.prod(self.observation_space.shape))
        act_dim = int(np.prod(self.action_space.shape))
        scale = float(np.max(np.abs(self.action_space.high)))
        return TD3Module(
            obs_dim, act_dim, scale, hidden,
            exploration_noise=self.config.exploration_noise,
        )

    def _make_learner(self) -> Learner:
        from ..utils.optim import make_optimizer

        cfg = self.config
        actor_opt = make_optimizer(cfg)
        critic_opt = make_optimizer(cfg)
        learner = Learner(
            self.module,
            make_td3_update(self.module, actor_opt, critic_opt, cfg),
            seed=cfg.seed, device=cfg.device,
        )
        critic_keys = ("q1", "q2") if cfg.use_twin_q else ("q1",)
        learner.opt_state = (
            actor_opt.init(learner.params["actor"]),
            critic_opt.init({k: learner.params[k] for k in critic_keys}),
        )
        return learner

    def training_step(self) -> Dict:
        cfg = self.config
        batches = self._sample_batches()
        env_steps = 0
        for b in batches:
            T, B = b["rewards"].shape
            env_steps += T * B
            self._buffer.add_fragment(b)

        metrics: Dict = {}
        if len(self._buffer) >= cfg.learning_starts:
            mbs = self._buffer.sample(
                self._np_rng, cfg.num_grad_steps, cfg.minibatch_size
            )
            metrics = self.learner_group.update(mbs)
            self._weights = self.learner_group.get_weights()
        return {"_env_steps_this_iter": env_steps, "info": {"learner": metrics}}


TD3Config.algo_class = TD3

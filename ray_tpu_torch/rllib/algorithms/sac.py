"""SAC — Soft Actor-Critic (reference: `rllib/algorithms/sac/`).

Squashed-Gaussian actor, twin Q critics with Polyak targets, and learned
entropy temperature alpha (target entropy = -act_dim). The JAX reference
(`ray_tpu/rllib/algorithms/sac.py`) runs the k gradient steps of one
iteration as a single jit-compiled `lax.scan`; the port runs the same
steps in order on the learner's device, each step (critics, actor, alpha
and the Polyak update) one CUDA graph on the card (`optim.step_program`).
The two normal draws of each step are taken apart from the update, from
the learner's generator (`update.with_draws` takes them).
"""

from __future__ import annotations

import math
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

_LOG_STD_MIN, _LOG_STD_MAX = -5.0, 2.0


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.train_batch_size = 400        # env steps sampled per iteration
        self.replay_buffer_capacity: int = 100_000
        self.learning_starts: int = 1_000
        self.minibatch_size: int = 256
        self.num_grad_steps: int = 32      # grad steps per iteration
        self.tau: float = 0.005            # Polyak for target critics
        self.initial_alpha: float = 0.2
        self.target_entropy: str | float = "auto"  # -act_dim when auto
        self.grad_clip = None


class SACModule(RLModule):
    """Actor head outputs (mean, log_std); actions are tanh-squashed and
    scaled to the env bound. Critics live alongside in the same tree:
    params = {actor, q1, q2, q1_t, q2_t, log_alpha}."""

    def __init__(self, obs_dim: int, act_dim: int, action_scale: float,
                 hidden=(256, 256), initial_alpha: float = 0.2):
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.action_scale = float(action_scale)
        self.hidden = tuple(hidden)
        self.initial_alpha = float(initial_alpha)

    def init(self, gen):
        # reference: three keys split from one (`sac.py:58`); the port draws
        # the actor, then each critic, from one generator.
        actor = _mlp_init(gen, (self.obs_dim, *self.hidden, 2 * self.act_dim), scale_last=0.01)
        q_sizes = (self.obs_dim + self.act_dim, *self.hidden, 1)
        q1 = _mlp_init(gen, q_sizes, scale_last=1.0)
        q2 = _mlp_init(gen, q_sizes, scale_last=1.0)
        return {
            "actor": actor,
            "q1": q1,
            "q2": q2,
            "q1_t": tree_map(torch.clone, q1),
            "q2_t": tree_map(torch.clone, q2),
            "log_alpha": torch.tensor(np.log(self.initial_alpha), dtype=torch.float32, device=gen.device),
        }

    # ---- actor ----
    def actor_dist(self, actor_params, obs):
        out = _mlp_apply(actor_params, obs, activation=torch.relu)
        mean, log_std = torch.chunk(out, 2, dim=-1)
        return mean, torch.clamp(log_std, _LOG_STD_MIN, _LOG_STD_MAX)

    def sample_action(self, eps, actor_params, obs):
        """Reparameterized squashed sample → (action, log_prob), given the
        standard-normal draw `eps` (reference: `sample_action(rng, ...)`
        draws it inside, `sac.py:79-84`)."""
        mean, log_std = self.actor_dist(actor_params, obs)
        std = torch.exp(log_std)
        pre = mean + std * eps
        a = torch.tanh(pre)
        # Change-of-variables: tanh Jacobian AND the ×scale Jacobian
        # (-log scale per dim; without it the entropy equilibrium is biased).
        logp = torch.sum(
            -0.5 * (eps ** 2 + 2 * log_std + math.log(2 * math.pi))
            - torch.log(1.0 - a ** 2 + 1e-6)
            - math.log(self.action_scale),
            dim=-1,
        )
        return a * self.action_scale, logp

    def q_value(self, q_params, obs, actions):
        x = torch.cat([obs, actions / self.action_scale], dim=-1)
        return _mlp_apply(q_params, x, activation=torch.relu)[..., 0]

    # ---- EnvRunner interface (dist = (mean, log_std)) ----
    def forward(self, params, obs):
        dist = self.actor_dist(params["actor"], obs)
        return dist, torch.zeros(obs.shape[:-1], dtype=torch.float32, device=obs.device)

    def sample(self, gen, dist):
        mean, log_std = dist
        noise = torch.randn(mean.shape, generator=gen, dtype=mean.dtype, device=mean.device)
        return torch.tanh(mean + torch.exp(log_std) * noise) * self.action_scale

    def greedy(self, dist):
        return torch.tanh(dist[0]) * self.action_scale

    def log_prob(self, dist, actions):
        mean, log_std = dist
        a = torch.clamp(actions / self.action_scale, -1 + 1e-6, 1 - 1e-6)
        pre = torch.atanh(a)
        var = torch.exp(2 * log_std)
        base = torch.sum(
            -0.5 * ((pre - mean) ** 2 / var + 2 * log_std + math.log(2 * math.pi)), dim=-1
        )
        return base - torch.sum(
            torch.log(1.0 - a ** 2 + 1e-6) + math.log(self.action_scale), dim=-1
        )

    def entropy(self, dist):
        _, log_std = dist
        return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1)


def make_sac_update(module: SACModule, actor_opt, critic_opt, alpha_opt, cfg: SACConfig,
                    target_entropy: float):
    """update(state, batches, gen) -> (state, metrics) over [k, mb] stacked
    minibatches: each step's two standard-normal draws ([k, mb, act_dim]
    each: "next" for the next action, "actor" for the actor's
    reparameterised action) taken from `gen`, then
    `update.with_draws(state, batches, draws)`, the update given them (the
    reference's `k_next, k_actor = split(key_i)`, `sac.py:161`).
    `update.step` is one gradient step, `update.program` its
    `optim.step_program` and `update.scan_inputs(batches, draws)` their
    (inputs, variants)."""
    gamma, tau = cfg.gamma, cfg.tau

    def critic_loss(qs, params, mb, next_a, next_logp, alpha):
        y = mb["rewards"] + gamma * (1.0 - mb["dones"]) * (
            torch.minimum(
                module.q_value(params["q1_t"], mb["next_obs"], next_a),
                module.q_value(params["q2_t"], mb["next_obs"], next_a),
            )
            - alpha * next_logp
        )
        y = y.detach()
        q1 = module.q_value(qs["q1"], mb["obs"], mb["actions"])
        q2 = module.q_value(qs["q2"], mb["obs"], mb["actions"])
        loss = ((q1 - y) ** 2 + (q2 - y) ** 2).mean()
        return loss, {"critic_loss": loss, "q_mean": q1.mean()}

    def actor_loss(actor, params, mb, eps, alpha):
        a, logp = module.sample_action(eps, actor, mb["obs"])
        q = torch.minimum(
            module.q_value(params["q1"], mb["obs"], a),
            module.q_value(params["q2"], mb["obs"], a),
        )
        loss = (alpha * logp - q).mean()
        return loss, {"actor_loss": loss, "logp": logp}

    def alpha_loss(log_alpha, logp):
        loss = (-torch.exp(log_alpha) * (logp + target_entropy).detach()).mean()
        return loss, {}

    critic_vg = optim.value_and_grad(critic_loss)
    actor_vg = optim.value_and_grad(actor_loss)
    alpha_vg = optim.value_and_grad(alpha_loss)

    def grad_step(state, inp, variant=None):
        """One step of the reference's scan (`sac.py:156-204`): the critics,
        then the actor on the new critics, then alpha on the actor's logp,
        then the Polyak update."""
        params, (a_opt, c_opt, al_opt) = state
        mb = inp["mb"]
        alpha = torch.exp(params["log_alpha"])

        with torch.no_grad():
            next_a, next_logp = module.sample_action(inp["eps_next"], params["actor"], mb["next_obs"])
        qs_in = {"q1": params["q1"], "q2": params["q2"]}
        (new_qs, c_opt), c_aux = optim.gradient_step(critic_opt, critic_vg, (qs_in, c_opt), params, mb, next_a,
                                                     next_logp, alpha)
        params = {**params, **new_qs}

        (actor, a_opt), a_aux = optim.gradient_step(actor_opt, actor_vg, (params["actor"], a_opt), params, mb,
                                                    inp["eps_actor"], alpha)
        params = {**params, "actor": actor}
        logp = a_aux["logp"]

        (log_alpha, al_opt), _ = optim.gradient_step(alpha_opt, alpha_vg, (params["log_alpha"], al_opt), logp)
        params = {**params, "log_alpha": log_alpha}

        with torch.no_grad():
            params = {**params, "q1_t": polyak(params["q1_t"], params["q1"], tau),
                      "q2_t": polyak(params["q2_t"], params["q2"], tau)}
            aux = {
                "critic_loss": c_aux["critic_loss"],
                "actor_loss": a_aux["actor_loss"],
                "alpha": torch.exp(params["log_alpha"]),
                "q_mean": c_aux["q_mean"],
                "entropy": -logp.mean(),
            }
        return (params, (a_opt, c_opt, al_opt)), aux

    program = optim.step_program(grad_step)

    def scan_inputs(batches, draws):
        inputs = {"mb": batches, "eps_next": draws["next"], "eps_actor": draws["actor"]}
        return inputs, [None] * batches["obs"].shape[0]

    def with_draws(state, batches, draws):
        return program(state, *scan_inputs(batches, draws))

    def update(state, batches, gen):
        shape = batches["actions"].shape
        draws = {name: torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
                 for name in ("next", "actor")}
        return with_draws(state, batches, draws)

    update.with_draws = with_draws
    update.step = grad_step
    update.program = program
    update.scan_inputs = scan_inputs
    return update


class SAC(Algorithm):
    config_class = SACConfig

    def setup(self):
        super().setup()
        cfg = self.config
        obs_dim = int(np.prod(self.observation_space.shape))
        act_dim = int(np.prod(self.action_space.shape))
        self._buffer = ReplayBuffer(
            cfg.replay_buffer_capacity, obs_dim, act_shape=(act_dim,), act_dtype=np.float32
        )
        self._np_rng = np.random.default_rng(cfg.seed)

    def _make_module(self):
        if not isinstance(self.action_space, Box):
            raise TypeError("SAC requires a continuous (Box) action space")
        hidden = tuple(self.config.model.get("hidden", (256, 256)))
        obs_dim = int(np.prod(self.observation_space.shape))
        act_dim = int(np.prod(self.action_space.shape))
        scale = float(np.max(np.abs(self.action_space.high)))
        return SACModule(obs_dim, act_dim, scale, hidden,
                         initial_alpha=self.config.initial_alpha)

    def _make_learner(self) -> Learner:
        cfg = self.config
        act_dim = self.module.act_dim
        target_entropy = (
            -float(act_dim) if cfg.target_entropy == "auto" else float(cfg.target_entropy)
        )
        from ..utils.optim import make_optimizer

        actor_opt = make_optimizer(cfg)
        critic_opt = make_optimizer(cfg)
        alpha_opt = make_optimizer(cfg)
        learner = Learner(
            self.module,
            make_sac_update(self.module, actor_opt, critic_opt, alpha_opt, cfg, target_entropy),
            seed=cfg.seed, device=cfg.device,
        )
        learner.opt_state = (
            actor_opt.init(learner.params["actor"]),
            critic_opt.init({"q1": learner.params["q1"], "q2": learner.params["q2"]}),
            alpha_opt.init(learner.params["log_alpha"]),
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
            mbs = self._buffer.sample(self._np_rng, cfg.num_grad_steps, cfg.minibatch_size)
            metrics = self.learner_group.update(mbs)
            self._weights = self.learner_group.get_weights()
        return {"_env_steps_this_iter": env_steps, "info": {"learner": metrics}}


SACConfig.algo_class = SAC

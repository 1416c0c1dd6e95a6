"""DQN (reference: `rllib/algorithms/dqn`).

Host-side numpy replay buffer feeding a double-Q update with Polyak target
sync on the learner's device (the JAX reference,
`ray_tpu/rllib/algorithms/dqn.py`, scans the minibatches in one XLA
program; the port loops over them in order, each minibatch step one CUDA
graph on the card: `optim.step_program`). Epsilon-greedy exploration
rides the params tree (`eps` leaf, a 0-d tensor) so the stock EnvRunner
sampling step needs no special case.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.learner import Learner
from ..core.rl_module import QModule, RLModule
from ..env.spaces import Discrete
from ..utils import optim
from ..utils.tree import tree_leaves, tree_map, tree_unflatten_like
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.train_batch_size = 512       # env steps sampled per iteration
        self.replay_buffer_capacity: int = 50_000
        self.learning_starts: int = 1_000
        self.minibatch_size: int = 64
        self.num_grad_steps: int = 32     # grad steps per iteration
        self.target_network_update_tau: float = 0.01
        self.epsilon_initial: float = 1.0
        self.epsilon_final: float = 0.05
        self.epsilon_decay_steps: int = 10_000
        self.double_q: bool = True


class QPolicyModule(RLModule):
    """Adapts QModule to the EnvRunner interface: params carry
    {online, target, eps}; `sample` is epsilon-greedy over online Q."""

    def __init__(self, obs_dim: int, n_actions: int, hidden=(64, 64), model=None):
        self.q = QModule(obs_dim, n_actions, hidden, model=model)
        self.n_actions = n_actions

    def init(self, gen):
        online = self.q.init(gen)
        return {
            "online": online,
            "target": tree_map(torch.clone, online),
            "eps": torch.tensor(1.0, dtype=torch.float32),
        }

    def forward(self, params, obs):
        qvals = self.q.forward(params["online"], obs)
        # (dist, value) interface: dist = (q, eps); value = greedy Q
        return (qvals, params["eps"]), qvals.max(dim=-1).values

    @staticmethod
    def sample(gen, dist):
        """Per row: a uniform random action with probability eps, else the
        greedy one; both draws from `gen` (on the q-values' device)."""
        qvals, eps = dist
        greedy = qvals.argmax(dim=-1)
        explore = torch.rand(greedy.shape, generator=gen, device=qvals.device) < eps
        random = torch.randint(0, qvals.shape[-1], greedy.shape, generator=gen, device=qvals.device)
        return torch.where(explore, random, greedy).to(torch.int32)

    @staticmethod
    def greedy(dist):
        qvals, _ = dist
        return qvals.argmax(dim=-1)

    @staticmethod
    def log_prob(dist, actions):
        qvals, _ = dist
        return torch.zeros(qvals.shape[:-1], dtype=torch.float32, device=qvals.device)  # unused by DQN

    @staticmethod
    def entropy(dist):
        qvals, _ = dist
        return torch.zeros(qvals.shape[:-1], dtype=torch.float32, device=qvals.device)


from ..utils.replay_buffers import ReplayBuffer  # noqa: E402 — shared framework


def huber_loss(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """optax.huber_loss: 0.5·min(|x|, δ)² + δ·(|x| − min(|x|, δ))."""
    abs_x = torch.abs(x)
    quadratic = torch.clamp(abs_x, max=delta)
    return 0.5 * quadratic ** 2 + delta * (abs_x - quadratic)


def taken(q: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """q[..., a] per row (the reference's take_along_axis)."""
    return torch.gather(q, -1, actions.long()[..., None])[..., 0]


def polyak(target, online, tau: float):
    """(1 - τ)·target + τ·online, each op over every leaf at once
    (`torch._foreach_*`, the same arithmetic as leaf by leaf)."""
    t, o = tree_leaves(target), tree_leaves(online)
    return tree_unflatten_like(target, torch._foreach_add(torch._foreach_mul(t, 1 - tau), torch._foreach_mul(o, tau)))


def target_net_step(opt, value_and_grad, tau: float):
    """`step(state, mb) -> (state, aux)` over {online, target, eps} params:
    a gradient step on the online net (`value_and_grad(online, target,
    mb)`), then Polyak toward its NEW params (DQN's and CQL's minibatch
    step)."""
    def step(state, mb):
        params, opt_state = state
        (online, opt_state), aux = optim.gradient_step(opt, value_and_grad, (params["online"], opt_state),
                                                       params["target"], mb)
        target = polyak(params["target"], online, tau)
        return ({"online": online, "target": target, "eps": params["eps"]}, opt_state), aux

    return step


def make_dqn_update(module: QPolicyModule, opt, cfg: DQNConfig):
    gamma, tau, double_q = cfg.gamma, cfg.target_network_update_tau, cfg.double_q
    qnet = module.q

    def loss_fn(online, target, mb):
        q = qnet.forward(online, mb["obs"])
        q_taken = taken(q, mb["actions"])
        with torch.no_grad():
            q_next_target = qnet.forward(target, mb["next_obs"])
            if double_q:
                # argmax: the first index on ties, as jnp's.
                next_a = qnet.forward(online, mb["next_obs"]).argmax(dim=-1)
                q_next = taken(q_next_target, next_a)
            else:
                q_next = q_next_target.max(dim=-1).values
            td_target = mb["rewards"] + gamma * (1.0 - mb["dones"]) * q_next
        td = q_taken - td_target
        loss = huber_loss(td).mean()
        return loss, {"td_loss": loss, "q_mean": q_taken.mean()}

    step = target_net_step(opt, optim.value_and_grad(loss_fn), tau)
    # The reference's lax.scan over the [k, mb] stacked minibatches, in
    # order; on the card each minibatch step one CUDA graph.
    program = optim.step_program(lambda st, mb, _: step(st, mb))

    def update(state, batches, gen):
        del gen
        return program(state, batches, [None] * batches["obs"].shape[0])

    return update


class DQN(Algorithm):
    config_class = DQNConfig

    def setup(self):
        super().setup()
        obs_dim = int(np.prod(self.observation_space.shape))
        self._buffer = ReplayBuffer(self.config.replay_buffer_capacity, obs_dim)
        self._np_rng = np.random.default_rng(self.config.seed)

    def _make_module(self):
        if not isinstance(self.action_space, Discrete):
            raise TypeError("DQN requires a discrete action space")
        hidden = tuple(self.config.model.get("hidden", (64, 64)))
        obs_dim = int(np.prod(self.observation_space.shape))
        return QPolicyModule(
            obs_dim, self.action_space.n, hidden, model=dict(self.config.model)
        )

    def _make_learner(self) -> Learner:
        from ..utils.optim import make_optimizer

        cfg = self.config
        opt = make_optimizer(cfg)
        learner = Learner(
            self.module, make_dqn_update(self.module, opt, cfg), seed=cfg.seed,
            device=cfg.device,
        )
        learner.opt_state = opt.init(learner.params["online"])
        return learner

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(self._timesteps_total / max(cfg.epsilon_decay_steps, 1), 1.0)
        return cfg.epsilon_initial + frac * (cfg.epsilon_final - cfg.epsilon_initial)

    def training_step(self) -> Dict:
        cfg = self.config
        self._weights = dict(self._weights)
        self._weights["eps"] = np.asarray(self._epsilon(), np.float32)
        batches = self._sample_batches()
        env_steps = 0
        for b in batches:
            T, B = b["rewards"].shape
            env_steps += T * B
            self._buffer.add_fragment(b)

        metrics: Dict = {"td_loss": float("nan"), "q_mean": float("nan")}
        if self._buffer.size >= cfg.learning_starts:
            mbs = self._buffer.sample(self._np_rng, cfg.num_grad_steps, cfg.minibatch_size)
            metrics = self.learner_group.update(mbs)
            self._weights = self.learner_group.get_weights()
            self._weights = dict(self._weights)
            self._weights["eps"] = np.asarray(self._epsilon(), np.float32)
        return {"_env_steps_this_iter": env_steps, "info": {"learner": metrics}}


DQNConfig.algo_class = DQN

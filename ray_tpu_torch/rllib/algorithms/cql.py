"""CQL — Conservative Q-Learning for offline RL (discrete-action form).

Reference analog: `rllib/algorithms/cql/cql.py:1` (continuous SAC-based);
here the discrete variant (Kumar et al. 2020, Eq. 4): double-Q TD learning
on the LOGGED transitions plus the conservative regularizer
    alpha * E_s[ logsumexp_a Q(s,a) − Q(s, a_data) ],
which pushes down out-of-distribution action values — the property that
separates CQL from naive offline DQN (which inflates unseen actions) and
lets it IMPROVE on the behavior policy where BC can only imitate it.

The JAX reference (`ray_tpu/rllib/algorithms/cql.py`) jits the epoch loop,
minibatching and optimizer into one program per iteration; the port runs
them on the learner's device (each minibatch step one CUDA graph on the
card), split as BC's: permutations from the
learner's generator, and the update given them (`update.with_perms`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.learner import Learner
from ..env.spaces import Discrete
from ..offline import OfflineDataset
from ..utils import optim
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig
from .dqn import QPolicyModule, huber_loss, taken, target_net_step


class CQLConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.train_batch_size = 2048      # transitions per iteration
        self.minibatch_size: int = 256
        self.num_epochs: int = 4
        self.cql_alpha: float = 1.0       # conservative penalty weight
        self.target_network_update_tau: float = 0.005
        self.dataset: Optional[OfflineDataset] = None
        self.evaluation_interval = 1
        self.evaluation_num_episodes = 10

    def offline_data(self, dataset: Optional[OfflineDataset] = None):
        self.dataset = dataset
        return self

    def validate(self):
        super().validate()
        if self.dataset is None:
            raise ValueError("CQL requires offline_data(dataset=...)")
        if self.dataset.rewards is None or self.dataset.next_obs is None:
            raise ValueError(
                "CQL needs TRANSITION-level data (rewards/next_obs/dones) — "
                "collect with collect_dataset(..., transitions=True)"
            )


def make_cql_update(module: QPolicyModule, opt, cfg: CQLConfig):
    gamma, tau, alpha = cfg.gamma, cfg.target_network_update_tau, cfg.cql_alpha
    qnet = module.q

    def loss_fn(online, target, mb):
        q = qnet.forward(online, mb["obs"])                     # [B, A]
        q_data = taken(q, mb["actions"])
        # Double-Q TD target on logged transitions.
        with torch.no_grad():
            next_q_online = qnet.forward(online, mb["next_obs"])
            next_q_target = qnet.forward(target, mb["next_obs"])
            next_a = next_q_online.argmax(dim=-1)
            q_next = taken(next_q_target, next_a)
            td_target = mb["rewards"] + gamma * (1.0 - mb["dones"]) * q_next
        td_loss = huber_loss(q_data - td_target).mean()
        # Conservative term: push down the soft-max over ALL actions, push
        # up the logged action (Kumar et al. Eq. 4, discrete form).
        conservative = (torch.logsumexp(q, dim=-1) - q_data).mean()
        loss = td_loss + alpha * conservative
        return loss, {
            "td_loss": td_loss,
            "cql_penalty": conservative,
            "q_data_mean": q_data.mean(),
        }

    step = target_net_step(opt, optim.value_and_grad(loss_fn), tau)
    return optim.make_minibatch_update(step, cfg.num_epochs, cfg.minibatch_size)


class CQL(Algorithm):
    config_class = CQLConfig

    def setup(self):
        super().setup()
        self._np_rng = np.random.default_rng(self.config.seed)

    def _make_module(self):
        if not isinstance(self.action_space, Discrete):
            raise TypeError("discrete CQL requires a discrete action space")
        hidden = tuple(self.config.model.get("hidden", (64, 64)))
        obs_dim = int(np.prod(self.observation_space.shape))
        return QPolicyModule(
            obs_dim, self.action_space.n, hidden,
            model=dict(self.config.model),
        )

    def _make_learner(self) -> Learner:
        from ..utils.optim import make_optimizer

        cfg = self.config
        opt = make_optimizer(cfg)
        learner = Learner(
            self.module, make_cql_update(self.module, opt, cfg), seed=cfg.seed,
            device=cfg.device,
        )
        learner.opt_state = opt.init(learner.params["online"])
        return learner

    def training_step(self) -> Dict:
        cfg = self.config
        ds = cfg.dataset
        idx = self._np_rng.integers(0, len(ds), size=cfg.train_batch_size)
        batch = {
            "obs": ds.obs[idx],
            "actions": np.asarray(ds.actions[idx], np.int32),
            "rewards": ds.rewards[idx],
            "next_obs": ds.next_obs[idx],
            "dones": ds.dones[idx],
        }
        metrics = self.learner_group.update(batch)
        self._weights = self.learner_group.get_weights()
        # Offline: no env steps sampled; greedy rollouts only via evaluate().
        return {"_env_steps_this_iter": 0, "info": {"learner": metrics}}


CQLConfig.algo_class = CQL

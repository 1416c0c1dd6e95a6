"""Behavior Cloning — offline RL (reference: `rllib/algorithms/bc/bc.py`).

Supervised policy learning from demonstrations: maximize log π(a|s) over an
`OfflineDataset`. No environment interaction during training; the env is
only used for evaluation. The JAX reference (`ray_tpu/rllib/algorithms/bc.py`)
runs the minibatch-epoch loop as one jitted XLA program per iteration; the
port runs it on the learner's device (each minibatch step one CUDA graph
on the card), split as PPO's is: the
permutations drawn from the learner's generator, one per epoch, and the
update given them (`update.with_perms`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.learner import Learner
from ..offline import OfflineDataset
from ..utils import optim
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.train_batch_size = 2048      # transitions sampled per iteration
        self.minibatch_size = 256
        self.num_epochs = 4
        self.dataset: Optional[OfflineDataset] = None
        self.input_path: Optional[str] = None  # JSONL alternative
        # BC never samples the env for training.
        self.num_env_runners = 0

    def offline_data(self, dataset: Optional[OfflineDataset] = None,
                     input_path: Optional[str] = None) -> "BCConfig":
        self.dataset = dataset
        self.input_path = input_path
        return self

    def validate(self):
        super().validate()
        if self.dataset is None and self.input_path is None:
            raise ValueError("BC needs offline_data(dataset=...) or input_path")
        if self.train_batch_size % self.minibatch_size != 0:
            raise ValueError("train_batch_size must divide into minibatches")


def make_supervised_update(opt, cfg, loss_fn):
    """Shared offline SGD update (BC/MARWIL): epochs of permuted minibatch
    steps per iteration. `loss_fn(params, mb) -> (loss, metrics_dict)`.
    Returns update(state, batch, gen) -> (state, metrics), and
    `update.with_perms(state, batch, perms)`, the same update given the
    permutations ([num_epochs, num_minibatches, mb_size])."""
    value_and_grad = optim.value_and_grad(loss_fn)

    def step(state, mb):
        return optim.gradient_step(opt, value_and_grad, state, mb)

    return optim.make_minibatch_update(step, cfg.num_epochs, cfg.minibatch_size)


def make_bc_update(module, opt, cfg: BCConfig):
    def loss_fn(params, mb):
        dist, _ = module.forward(params, mb["obs"])
        logp = module.log_prob(dist, mb["actions"])
        loss = -torch.mean(logp)
        return loss, {"bc_loss": loss}

    return make_supervised_update(opt, cfg, loss_fn)


class BC(Algorithm):
    config_class = BCConfig

    def setup(self):
        cfg = self.config
        if cfg.dataset is None:
            cfg.dataset = OfflineDataset.read_json(cfg.input_path)
        self._np_rng = np.random.default_rng(cfg.seed)
        super().setup()

    def _make_learner(self) -> Learner:
        from ..utils.optim import make_optimizer

        cfg = self.config
        opt = make_optimizer(cfg)
        learner = Learner(
            self.module, make_bc_update(self.module, opt, cfg), seed=cfg.seed,
            device=cfg.device,
        )
        learner.opt_state = opt.init(learner.params)
        return learner

    def training_step(self) -> Dict:
        cfg = self.config
        batch = cfg.dataset.sample(self._np_rng, cfg.train_batch_size)
        metrics = self.learner_group.update(batch)
        self._weights = self.learner_group.get_weights()
        # Offline: "reward" comes from evaluation rollouts, not sampling.
        ev = self.evaluate()
        self._episode_returns.extend(
            [ev["episode_reward_mean"]] if "episode_reward_mean" in ev else []
        )
        return {
            "_env_steps_this_iter": 0,
            "num_offline_transitions_this_iter": cfg.train_batch_size,
            "info": {"learner": metrics},
            "evaluation": ev,
        }


BCConfig.algo_class = BC

"""A2C — synchronous advantage actor-critic.

Reference analog: `rllib/algorithms/a2c/a2c.py` (A3C's synchronous variant:
on-policy rollouts, GAE advantages, a SINGLE full-batch gradient step per
iteration — no ratio clipping, no minibatch epochs). Shares PPO's runner
and GAE machinery; the JAX reference (`ray_tpu/rllib/algorithms/a2c.py`)
jits the update into one XLA program, the port runs it on the learner's
device, op for op, GAE and the step one CUDA graph on the card
(`optim.step_program`).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.learner import Learner
from ..utils import optim
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig


class A2CConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lambda_: float = 1.0          # reference default: plain returns
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01
        self.lr = 7e-4
        self.train_batch_size = 512


# The batch fields GAE and the loss read (`optim.single_step_update`).
_GAE_KEYS = ("obs", "actions", "logp", "values", "rewards", "dones", "last_obs")


def make_a2c_update(module, opt, cfg: A2CConfig):
    gamma, lam = cfg.gamma, cfg.lambda_
    vf_coeff, ent_coeff = cfg.vf_loss_coeff, cfg.entropy_coeff

    def loss_fn(params, mb):
        dist, value = module.forward(params, mb["obs"])
        logp = module.log_prob(dist, mb["actions"])
        adv = mb["adv"]
        # Population std (the reference's jnp.std; torch's default is unbiased).
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg_loss = -(adv * logp).mean()
        vf_loss = 0.5 * ((value - mb["returns"]) ** 2).mean()
        entropy = module.entropy(dist).mean()
        total = pg_loss + vf_coeff * vf_loss - ent_coeff * entropy
        return total, {
            "total_loss": total,
            "policy_loss": pg_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
        }

    value_and_grad = optim.value_and_grad(loss_fn)

    def step(state, batch):
        from ..utils.gae import compute_gae, flatten_time_major

        params, opt_state = state
        with torch.no_grad():
            advs, returns = compute_gae(module, params, batch, gamma, lam)
            flat = flatten_time_major(batch, advs, returns)
        return optim.gradient_step(opt, value_and_grad, (params, opt_state), flat)

    return optim.single_step_update(step, _GAE_KEYS)


class A2C(Algorithm):
    config_class = A2CConfig

    def _make_learner(self) -> Learner:
        from ..utils.optim import make_optimizer

        cfg = self.config
        opt = make_optimizer(cfg)
        learner = Learner(
            self.module, make_a2c_update(self.module, opt, cfg), seed=cfg.seed,
            device=cfg.device,
        )
        learner.opt_state = opt.init(learner.params)
        return learner

    def training_step(self) -> Dict:
        batches = self._sample_batches()
        batch = self._concat_batches(batches)
        T, B = batch["rewards"].shape
        metrics = self.learner_group.update(batch)
        self._weights = self.learner_group.get_weights()
        return {
            "_env_steps_this_iter": T * B,
            "info": {"learner": metrics},
        }


A2CConfig.algo_class = A2C

"""PPO (reference: `rllib/algorithms/ppo/ppo.py:61,353`).

BASELINE config #1 is PPO CartPole-v1 → reward 150 within 100k env steps
(`rllib/tuned_examples/ppo/cartpole-ppo.yaml:4-6`).

The learner runs the JAX reference's update (`ray_tpu/rllib/algorithms/ppo.py`,
one XLA program there) on the learner's device: GAE, the SGD-epoch loop
over minibatch permutations (each minibatch step one CUDA graph on the
card), the clipped-surrogate loss and the optimizer, op for op. The permutations are drawn apart from the update
(`optim.make_minibatch_update`), so the update given them (`update.with_perms`) can be held
to the reference's with the permutations JAX drew.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.learner import Learner
from ..utils import optim
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lambda_: float = 0.95
        self.clip_param: float = 0.2
        self.vf_clip_param: float = 10.0
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.0
        self.num_epochs: int = 8         # reference: num_sgd_iter
        self.minibatch_size: int = 256   # reference: sgd_minibatch_size
        self.lr = 3e-4
        self.train_batch_size = 2048

    def validate(self):
        super().validate()
        if self.train_batch_size % self.minibatch_size != 0:
            raise ValueError(
                f"train_batch_size {self.train_batch_size} must be divisible by "
                f"minibatch_size {self.minibatch_size}"
            )


def make_ppo_update(module, opt, cfg: PPOConfig, axis_name: Optional[str] = None):
    """Builds update(state, batch, gen) -> (state, metrics), and
    `update.with_perms(state, batch, perms)`, the same update given the
    minibatch permutations ([num_epochs, num_minibatches, mb_size]).

    The reference's `axis_name` pmaps the update for the Anakin podracer
    plane over devices (gradients pmean'd across them); the port's Anakin
    runs on one device, and a pmean across cards is not ported.
    """
    if axis_name is not None:
        raise NotImplementedError(
            "make_ppo_update(axis_name=): the update across several cards (a "
            "pmean of the gradients) is not ported (ROADMAP queue 1 item 6); "
            "the podracer planes run the update on one device"
        )
    gamma, lam = cfg.gamma, cfg.lambda_
    clip, vf_clip = cfg.clip_param, cfg.vf_clip_param
    vf_coeff, ent_coeff = cfg.vf_loss_coeff, cfg.entropy_coeff

    def loss_fn(params, mb):
        dist, value = module.forward(params, mb["obs"])
        logp = module.log_prob(dist, mb["actions"])
        ratio = torch.exp(logp - mb["logp"])
        adv = mb["adv"]
        # Population std (the reference's jnp.std; torch's default is unbiased).
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)

        pg_loss = torch.maximum(-adv * ratio, -adv * torch.clamp(ratio, 1 - clip, 1 + clip)).mean()

        v_clipped = mb["values"] + torch.clamp(value - mb["values"], -vf_clip, vf_clip)
        vf_loss = 0.5 * torch.maximum(
            (value - mb["returns"]) ** 2, (v_clipped - mb["returns"]) ** 2
        ).mean()

        entropy = module.entropy(dist).mean()
        total = pg_loss + vf_coeff * vf_loss - ent_coeff * entropy
        # Schulman's low-variance KL estimator: E[(r-1) - log r]
        approx_kl = ((ratio - 1.0) - torch.log(ratio)).mean()
        clip_frac = (torch.abs(ratio - 1.0) > clip).to(torch.float32).mean()
        aux = {
            "total_loss": total,
            "policy_loss": pg_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "approx_kl": approx_kl,
            "clip_frac": clip_frac,
        }
        return total, aux

    value_and_grad = optim.value_and_grad(loss_fn)

    def step(state, mb):
        return optim.gradient_step(opt, value_and_grad, state, mb)

    def gae(state, batch):
        from ..utils.gae import compute_gae, flatten_time_major

        advs, returns = compute_gae(module, state[0], batch, gamma, lam)
        return flatten_time_major(batch, advs, returns)

    return optim.make_minibatch_update(step, cfg.num_epochs, cfg.minibatch_size, prepare=gae)


class PPO(Algorithm):
    config_class = PPOConfig

    def _make_learner(self) -> Learner:
        from ..utils.optim import make_optimizer

        cfg = self.config
        opt = make_optimizer(cfg)
        learner = Learner(
            self.module, make_ppo_update(self.module, opt, cfg), seed=cfg.seed,
            device=cfg.device,
        )
        learner.opt_state = opt.init(learner.params)
        return learner

    def _podracer_update_factory(self, axis_name: Optional[str] = None):
        """PPO's update program for the podracer planes — the SAME
        `make_ppo_update` the LearnerGroup path runs, handed to Anakin's
        fused step on one device or to the Sebulba learner gang."""
        from ..utils.optim import make_optimizer

        cfg = self.config
        opt = make_optimizer(cfg)
        return opt, make_ppo_update(self.module, opt, cfg, axis_name=axis_name)

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


PPOConfig.algo_class = PPO

"""MARWIL — Monotonic Advantage Re-Weighted Imitation Learning (offline).

Reference analog: `rllib/algorithms/marwil/marwil.py`. Supervised policy
learning weighted by exponentiated advantages: the value head regresses
Monte-Carlo returns; the policy maximizes `exp(beta * A) * log pi(a|s)` with
A = R - V(s). `beta = 0` degenerates to BC. Same minibatch-epoch learner
as BC/PPO (the JAX reference, `ray_tpu/rllib/algorithms/marwil.py`,
jits it).
"""

from __future__ import annotations

import torch

from ..core.learner import Learner
from .bc import BC, BCConfig, make_supervised_update


class MARWILConfig(BCConfig):
    def __init__(self):
        super().__init__()
        self.beta: float = 1.0
        self.vf_coeff: float = 1.0
        self.advantage_clip: float = 10.0  # cap exp-weights (wild advantages)

    def validate(self):
        super().validate()
        if self.dataset is not None and self.dataset.returns is None:
            raise ValueError(
                "MARWIL needs Monte-Carlo returns in the offline dataset "
                "(collect with rllib.offline.collect_dataset or provide "
                "OfflineDataset(..., returns=...))"
            )


def make_marwil_update(module, opt, cfg: MARWILConfig):
    def loss_fn(params, mb):
        dist, value = module.forward(params, mb["obs"])
        logp = module.log_prob(dist, mb["actions"])
        adv = mb["returns"] - value
        # Policy gradient must not flow into the value baseline.
        w = torch.exp(
            torch.clamp(cfg.beta * adv.detach(), -cfg.advantage_clip, cfg.advantage_clip)
        )
        policy_loss = -torch.mean(w * logp)
        vf_loss = torch.mean(adv**2)
        loss = policy_loss + cfg.vf_coeff * vf_loss
        return loss, {
            "marwil_loss": loss,
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
        }

    return make_supervised_update(opt, cfg, loss_fn)


class MARWIL(BC):
    config_class = MARWILConfig

    def setup(self):
        super().setup()  # may load the dataset from input_path
        if self.config.dataset.returns is None:
            raise ValueError(
                "MARWIL needs Monte-Carlo returns; this dataset (loaded from "
                f"{self.config.input_path!r}) has none — regenerate with "
                "collect_dataset (records returns) or add a 'return' field"
            )

    def _make_learner(self) -> Learner:
        from ..utils.optim import make_optimizer

        cfg = self.config
        opt = make_optimizer(cfg)
        learner = Learner(
            self.module, make_marwil_update(self.module, opt, cfg), seed=cfg.seed,
            device=cfg.device,
        )
        learner.opt_state = opt.init(learner.params)
        return learner


MARWILConfig.algo_class = MARWIL

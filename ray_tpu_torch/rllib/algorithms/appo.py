"""APPO — Asynchronous PPO (reference: `rllib/algorithms/appo/`).

IMPALA's decoupled actor-learner architecture (stale-weight async rollouts,
consume-as-they-arrive) with PPO's clipped-surrogate objective computed on
V-trace-corrected advantages — the reference's exact hybrid. Reuses the
IMPALA training loop and its V-trace; only the update differs (on the
learner's device, one CUDA graph on the card, where the JAX reference,
`ray_tpu/rllib/algorithms/appo.py`, jits one XLA program).
"""

from __future__ import annotations

import torch

from ..core.learner import Learner
from ..utils import optim
from .impala import VTRACE_KEYS, IMPALA, IMPALAConfig, time_major_forward, vtrace


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.clip_param: float = 0.2
        self.lr = 3e-4
        self.entropy_coeff = 0.01


def make_appo_update(module, opt, cfg: APPOConfig):
    gamma = cfg.gamma
    rho_bar = cfg.vtrace_clip_rho_threshold
    c_bar = cfg.vtrace_clip_c_threshold
    clip = cfg.clip_param
    vf_coeff, ent_coeff = cfg.vf_loss_coeff, cfg.entropy_coeff

    def loss_fn(params, batch):
        dist, values, logp, last_val = time_major_forward(module, params, batch)

        ratio = torch.exp(logp - batch["logp"])
        # The ratio is detached only inside the rho/c clips (`appo.py:50-51`).
        clipped_rhos = torch.clamp(ratio.detach(), max=rho_bar)
        cs = torch.clamp(ratio.detach(), max=c_bar)
        vs, adv = vtrace(batch, values.detach(), last_val.detach(), clipped_rhos, cs, gamma)
        # Population std (the reference's jnp.std; torch's default is unbiased).
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)

        # PPO clipped surrogate on the v-trace advantages — APPO's objective.
        pg_loss = torch.maximum(
            -adv * ratio, -adv * torch.clamp(ratio, 1 - clip, 1 + clip)
        ).mean()
        vf_loss = 0.5 * ((values - vs) ** 2).mean()
        entropy = module.entropy(dist).mean()
        total = pg_loss + vf_coeff * vf_loss - ent_coeff * entropy
        return total, {
            "total_loss": total,
            "policy_loss": pg_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "clip_frac": (torch.abs(ratio - 1.0) > clip).to(torch.float32).mean(),
        }

    value_and_grad = optim.value_and_grad(loss_fn)
    return optim.single_step_update(lambda state, batch: optim.gradient_step(opt, value_and_grad, state, batch),
                                    VTRACE_KEYS)


class APPO(IMPALA):
    config_class = APPOConfig

    def _make_learner(self) -> Learner:
        from ..utils.optim import make_optimizer

        cfg = self.config
        opt = make_optimizer(cfg, cfg.opt)
        learner = Learner(
            self.module, make_appo_update(self.module, opt, cfg), seed=cfg.seed,
            device=cfg.device,
        )
        learner.opt_state = opt.init(learner.params)
        return learner


APPOConfig.algo_class = APPO

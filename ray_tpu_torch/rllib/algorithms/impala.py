"""IMPALA (reference: `rllib/algorithms/impala/impala.py:65,126`).

Decoupled actor-learner architecture: EnvRunner actors sample continuously
with (slightly) stale weights; the driver consumes batches as they arrive
(`ray_tpu_torch.wait`), corrects off-policyness with **V-trace**, and
re-arms each runner with fresh weights. The JAX reference
(`ray_tpu/rllib/algorithms/impala.py`) jits the V-trace update into one XLA
program per arriving batch; the port runs it on the learner's device, its
reverse `lax.scan` a loop over T from the end, the update one CUDA graph on
the card (`optim.step_program`).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.learner import Learner
from ..utils import optim
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.vtrace_clip_rho_threshold: float = 1.0
        self.vtrace_clip_c_threshold: float = 1.0
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01
        self.lr = 5e-4
        self.train_batch_size = 512
        self.num_env_runners = 2
        self.broadcast_interval: int = 1  # updates between weight refreshes
        # "adam" | "rmsprop". The reference defaults to rmsprop(eps=0.1),
        # tuned for Atari-scale gradients — that eps flattens the small
        # gradients of classic-control tasks to a standstill; adam default.
        self.opt: str = "adam"

    def validate(self):
        super().validate()
        if self.opt not in ("adam", "rmsprop"):
            raise ValueError(f"opt must be adam|rmsprop, got {self.opt!r}")


def time_major_forward(module, params, batch):
    """(dist, values [T, B], logp [T, B], last_val [B]) of the module on a
    time-major batch: the forward over the T·B flattened observations, its
    outputs reshaped back — a Gaussian `(mean, log_std)` keeps its
    unbatched `log_std`."""
    T, B = batch["rewards"].shape
    obs_flat = batch["obs"].reshape(T * B, -1)
    dist, values = module.forward(params, obs_flat)
    values = values.reshape(T, B)
    if isinstance(dist, tuple):  # gaussian (mean, log_std)
        dist = tuple(
            d.reshape((T, B) + tuple(d.shape[1:])) if d.ndim > 1 else d for d in dist
        )
    else:
        dist = dist.reshape((T, B) + tuple(dist.shape[1:]))
    logp = module.log_prob(dist, batch["actions"])
    _, last_val = module.forward(params, batch["last_obs"])
    return dist, values, logp, last_val


def vtrace(batch, values, last_val, clipped_rhos, cs, gamma: float):
    """(vs, pg_adv) [T, B]: the V-trace targets and the policy-gradient
    advantages, from detached inputs (the reference stop_gradients both
    outputs, `impala.py:89,91-93`, `appo.py:65-69`, so no gradient flows
    through them). The reverse scan runs as a loop over T from the end,
    from zeros_like(last_val)."""
    not_done = 1.0 - batch["dones"]
    rewards = batch["rewards"]
    v_next = torch.cat([values[1:], last_val[None]], dim=0)
    deltas = clipped_rhos * (rewards + gamma * not_done * v_next - values)

    vs_minus_v = torch.empty_like(deltas)
    acc = torch.zeros_like(last_val)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + gamma * not_done[t] * cs[t] * acc
        vs_minus_v[t] = acc
    vs = vs_minus_v + values
    vs_next = torch.cat([vs[1:], last_val[None]], dim=0)
    pg_adv = clipped_rhos * (rewards + gamma * not_done * vs_next - values)
    return vs, pg_adv


# The batch fields the V-trace losses read (`optim.single_step_update`).
VTRACE_KEYS = ("obs", "actions", "logp", "rewards", "dones", "last_obs")


def make_vtrace_update(module, opt, cfg: IMPALAConfig):
    gamma = cfg.gamma
    rho_bar = cfg.vtrace_clip_rho_threshold
    c_bar = cfg.vtrace_clip_c_threshold
    vf_coeff, ent_coeff = cfg.vf_loss_coeff, cfg.entropy_coeff

    def loss_fn(params, batch):
        dist, values, logp, last_val = time_major_forward(module, params, batch)

        rhos = torch.exp(logp - batch["logp"])
        clipped_rhos = torch.clamp(rhos, max=rho_bar)
        cs = torch.clamp(rhos, max=c_bar)
        vs, pg_adv = vtrace(batch, values.detach(), last_val.detach(), clipped_rhos.detach(),
                            cs.detach(), gamma)

        pg_loss = -(logp * pg_adv).mean()
        vf_loss = 0.5 * ((values - vs) ** 2).mean()
        entropy = module.entropy(dist).mean()
        total = pg_loss + vf_coeff * vf_loss - ent_coeff * entropy
        aux = {
            "total_loss": total,
            "policy_loss": pg_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "mean_rho": rhos.mean(),
        }
        return total, aux

    value_and_grad = optim.value_and_grad(loss_fn)
    return optim.single_step_update(lambda state, batch: optim.gradient_step(opt, value_and_grad, state, batch),
                                    VTRACE_KEYS)


class IMPALA(Algorithm):
    config_class = IMPALAConfig

    def setup(self):
        super().setup()
        self._inflight: dict = {}  # future -> runner
        self._updates_since_broadcast = 0

    def _make_learner(self) -> Learner:
        from ..utils.optim import make_optimizer

        cfg = self.config
        opt = make_optimizer(cfg, cfg.opt)
        learner = Learner(
            self.module, make_vtrace_update(self.module, opt, cfg), seed=cfg.seed,
            device=cfg.device,
        )
        learner.opt_state = opt.init(learner.params)
        return learner

    def training_step(self) -> Dict:
        if not self._remote_runners:
            # Degenerate sync path (local runner): sample → vtrace update.
            batches = self._sample_batches()
            batch = self._concat_batches(batches)
            T, B = batch["rewards"].shape
            metrics = self.learner_group.update(batch)
            self._weights = self.learner_group.get_weights()
            return {"_env_steps_this_iter": T * B, "info": {"learner": metrics}}

        ray = self._ray
        # Arm every idle runner with the current weights.
        w_ref = ray.put(self._weights)
        for r in self._remote_runners:
            if r not in self._inflight.values():
                fut = r.sample.remote(w_ref)
                self._inflight[fut] = r

        ready, _ = ray.wait(list(self._inflight), num_returns=1, timeout=60.0)
        env_steps = 0
        metrics: Dict = {}
        for fut in ready:
            runner = self._inflight.pop(fut)
            batch = ray.get(fut)
            returns = batch.pop("episode_returns").tolist()
            self._episodes_this_iter += len(returns)
            self._episode_returns.extend(returns)
            self._episode_lengths.extend(batch.pop("episode_lengths").tolist())
            T, B = batch["rewards"].shape
            env_steps += T * B
            metrics = self.learner_group.update(batch)
            self._updates_since_broadcast += 1
            if self._updates_since_broadcast >= self.config.broadcast_interval:
                self._weights = self.learner_group.get_weights()
                w_ref = ray.put(self._weights)
                self._updates_since_broadcast = 0
            # Re-arm immediately (decoupled sampling).
            new_fut = runner.sample.remote(w_ref)
            self._inflight[new_fut] = runner
        return {"_env_steps_this_iter": env_steps, "info": {"learner": metrics}}

    def stop(self):
        self._inflight.clear()
        super().stop()


IMPALAConfig.algo_class = IMPALA

"""Generalized advantage estimation — shared by the on-policy learners
(PPO, A2C; reference analog: `rllib/evaluation/postprocessing.py`
compute_gae_for_sample_batch). The JAX reference (`ray_tpu/rllib/utils/gae.py`)
runs it as a reverse `lax.scan`; the port loops over T in reverse with the
same ops in the same order, on the batch's device."""

from __future__ import annotations

import torch


def compute_gae(module, params, batch, gamma: float, lam: float):
    """Time-major batch → (advantages, returns), both [T, B]."""
    rewards, dones, values = batch["rewards"], batch["dones"], batch["values"]
    _, last_val = module.forward(params, batch["last_obs"])

    T, B = rewards.shape
    advs = torch.empty_like(values)
    adv_next, v_next = torch.zeros(B, dtype=values.dtype, device=values.device), last_val
    for t in range(T - 1, -1, -1):
        r, d, v = rewards[t], dones[t], values[t]
        delta = r + gamma * v_next * (1.0 - d) - v
        adv_next = delta + gamma * lam * (1.0 - d) * adv_next
        advs[t] = adv_next
        v_next = v
    return advs, advs + values


def flatten_time_major(batch, advs, returns):
    """[T, B, ...] rollouts → flat per-sample dict for minibatching."""
    T, B = batch["rewards"].shape
    N = T * B
    return {
        "obs": batch["obs"].reshape(N, -1),
        "actions": batch["actions"].reshape((N,) + tuple(batch["actions"].shape[2:])),
        "logp": batch["logp"].reshape(N),
        "values": batch["values"].reshape(N),
        "adv": advs.reshape(N),
        "returns": returns.reshape(N),
    }

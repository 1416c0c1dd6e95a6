"""RLModule — the model abstraction (reference: `rllib/core/rl_module/rl_module.py:228`).

The reference's RLModule is a torch/tf nn.Module with forward_exploration /
forward_inference / forward_train methods. The port keeps the JAX
reference's shape (`ray_tpu/rllib/core/rl_module.py`): an RLModule is a
*pure-function pair* `(init, forward)` over a params tree of torch tensors
(`{"pi": [{"w", "b"}, ...], "v": ..., "log_std", "enc"}`, the reference's
pytree), used identically by the EnvRunner's sampling step and the
Learner's update. `init` and `sample` take a `torch.Generator` where the
reference takes a PRNG key; `params_from_numpy` carries the reference's
params (`jax.device_get`) across.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ..utils.tree import to_device
from .catalog import orthogonal


def _mlp_init(gen, sizes: Sequence[int], scale_last: float = 0.01):
    """Orthogonal-init MLP params: list of (W, b), drawn from `gen`."""
    params = []
    for i, (d_in, d_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = orthogonal(gen, (d_in, d_out), scale_last if i == len(sizes) - 2 else float(np.sqrt(2)))
        params.append({"w": w, "b": torch.zeros((d_out,), dtype=torch.float32, device=w.device)})
    return params


def _mlp_apply(params, x, activation=torch.tanh):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = activation(x)
    return x


def params_from_numpy(tree, device=None):
    """The reference's params (numpy leaves, as `jax.device_get` returns
    them) as the port's: the same tree of f32 tensors on `device` (None:
    the card)."""
    return to_device(tree, resolve_device(device))


class RLModule:
    """Base: subclasses define `init(gen) -> params` and
    `forward(params, obs) -> outputs` as pure functions, plus static
    distribution helpers `sample/log_prob/entropy/greedy` over the forward
    output's dist component."""

    def init(self, gen):
        raise NotImplementedError

    def forward(self, params, obs):
        raise NotImplementedError


def _build_encoder(model: dict, obs_dim: int):
    """Catalog hookup for the feedforward modules: None/mlp keeps the
    classic separate-tower layout; other encoders (cnn / custom-registered)
    feed shared features into linear heads. Recurrent encoders need
    sequence plumbing the feedforward runner doesn't provide."""
    from .catalog import build_encoder

    name = (model or {}).get("encoder", "mlp")
    if name == "mlp":
        return None  # classic towers
    if name == "lstm":
        raise ValueError(
            "the lstm encoder needs recurrent rollout plumbing; use it via "
            "the catalog's step/apply API, not the feedforward modules"
        )
    return build_encoder(model, obs_dim)


class DiscretePolicyModule(RLModule):
    """Separate policy/value MLP towers (default), or a catalog encoder
    (e.g. cnn) with linear pi/v heads; categorical action distribution.

    forward -> (logits [B, n_actions], value [B]).
    """

    def __init__(self, obs_dim: int, n_actions: int, hidden: Sequence[int] = (64, 64),
                 model: dict = None):
        self.obs_dim = obs_dim
        self.n_actions = n_actions
        self.hidden = tuple(hidden)
        self.encoder = _build_encoder(model, obs_dim)

    def init(self, gen):
        if self.encoder is not None:
            d = self.encoder.out_dim
            return {
                "enc": self.encoder.init(gen),
                "pi": _mlp_init(gen, (d, self.n_actions), scale_last=0.01),
                "v": _mlp_init(gen, (d, 1), scale_last=1.0),
            }
        return {
            "pi": _mlp_init(gen, (self.obs_dim, *self.hidden, self.n_actions), scale_last=0.01),
            "v": _mlp_init(gen, (self.obs_dim, *self.hidden, 1), scale_last=1.0),
        }

    def forward(self, params, obs) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.encoder is not None:
            feat = self.encoder.apply(params["enc"], obs)
            return (
                _mlp_apply(params["pi"], feat),
                _mlp_apply(params["v"], feat)[..., 0],
            )
        logits = _mlp_apply(params["pi"], obs)
        value = _mlp_apply(params["v"], obs)[..., 0]
        return logits, value

    # --- categorical distribution helpers (used by PPO/IMPALA losses) ---
    @staticmethod
    def log_prob(logits, actions):
        logp = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp, -1, actions.long()[..., None])[..., 0]

    @staticmethod
    def entropy(logits):
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)

    @staticmethod
    def sample(gen, logits):
        """An action per row drawn from softmax(logits) with `gen` (on the
        logits' device)."""
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=gen).reshape(probs.shape[:-1])

    @staticmethod
    def greedy(logits):
        return logits.argmax(dim=-1)


class GaussianPolicyModule(RLModule):
    """Diagonal-Gaussian policy for continuous actions (tanh-free, clipped by
    the env). forward -> ((mean [B, act_dim], log_std [act_dim]), value [B])."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: Sequence[int] = (64, 64),
                 model: dict = None):
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.hidden = tuple(hidden)
        self.encoder = _build_encoder(model, obs_dim)

    def init(self, gen):
        if self.encoder is not None:
            d = self.encoder.out_dim
            return {
                "enc": self.encoder.init(gen),
                "pi": _mlp_init(gen, (d, self.act_dim), scale_last=0.01),
                "v": _mlp_init(gen, (d, 1), scale_last=1.0),
                "log_std": torch.zeros((self.act_dim,), dtype=torch.float32, device=gen.device),
            }
        return {
            "pi": _mlp_init(gen, (self.obs_dim, *self.hidden, self.act_dim), scale_last=0.01),
            "v": _mlp_init(gen, (self.obs_dim, *self.hidden, 1), scale_last=1.0),
            "log_std": torch.zeros((self.act_dim,), dtype=torch.float32, device=gen.device),
        }

    def forward(self, params, obs):
        if self.encoder is not None:
            feat = self.encoder.apply(params["enc"], obs)
            mean = _mlp_apply(params["pi"], feat)
            value = _mlp_apply(params["v"], feat)[..., 0]
            return (mean, params["log_std"]), value
        mean = _mlp_apply(params["pi"], obs)
        value = _mlp_apply(params["v"], obs)[..., 0]
        return (mean, params["log_std"]), value

    @staticmethod
    def log_prob(dist, actions):
        mean, log_std = dist
        var = torch.exp(2 * log_std)
        return torch.sum(
            -0.5 * ((actions - mean) ** 2 / var + 2 * log_std + math.log(2 * math.pi)),
            dim=-1,
        )

    @staticmethod
    def entropy(dist):
        _, log_std = dist
        return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))

    @staticmethod
    def sample(gen, dist):
        mean, log_std = dist
        noise = torch.randn(mean.shape, generator=gen, dtype=mean.dtype, device=mean.device)
        return mean + torch.exp(log_std) * noise

    @staticmethod
    def greedy(dist):
        return dist[0]  # the mean


class QModule(RLModule):
    """Q-network for DQN: forward -> q_values [B, n_actions]."""

    def __init__(self, obs_dim: int, n_actions: int, hidden: Sequence[int] = (64, 64),
                 model: dict = None):
        self.obs_dim = obs_dim
        self.n_actions = n_actions
        self.hidden = tuple(hidden)
        self.encoder = _build_encoder(model, obs_dim)

    def init(self, gen):
        if self.encoder is not None:
            return {
                "enc": self.encoder.init(gen),
                "q": _mlp_init(gen, (self.encoder.out_dim, self.n_actions), scale_last=1.0),
            }
        return {"q": _mlp_init(gen, (self.obs_dim, *self.hidden, self.n_actions), scale_last=1.0)}

    def forward(self, params, obs):
        if self.encoder is not None:
            feat = self.encoder.apply(params["enc"], obs)
            return _mlp_apply(params["q"], feat)
        return _mlp_apply(params["q"], obs, activation=torch.relu)

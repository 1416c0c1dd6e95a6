"""Model catalog — pluggable encoder factories consumed by every policy
module (reference analog: `rllib/models/catalog.py` — `ModelCatalog`
mapping model-config dicts to network classes, with `register_custom_model`).

The port keeps the reference's shape (`ray_tpu/rllib/core/catalog.py`): an
encoder is a pure-function pair `(init, apply)` over a params tree of torch
tensors plus its output width. Selection rides the algorithm's `model`
config:

    config.training(model={"encoder": "cnn", "obs_shape": (84, 84, 4),
                           "conv_filters": [(16, 4, 2), (32, 4, 2)]})

Built-ins: "mlp" (default), "cnn" (a conv stack over flattened NHWC image
observations; the reference's HWIO kernels, run by `F.conv2d` on NCHW),
"lstm" (a recurrent encoder: `apply` loops over time where the reference
scans; stepwise `step` for carried-state inference). Custom encoders
register via `register_encoder(name, factory)`. `init` takes a
`torch.Generator` where the reference takes a PRNG key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "silu": F.silu,
}


@dataclasses.dataclass
class Encoder:
    init: Callable  # generator -> params
    apply: Callable  # (params, obs[B, D]) -> features [B, out_dim]
    out_dim: int
    # Recurrent encoders also provide stepwise application + initial state.
    initial_state: Optional[Callable] = None  # batch -> state pytree
    step: Optional[Callable] = None  # (params, obs[B,D], state) -> (feat, state)


_REGISTRY: Dict[str, Callable[[Dict[str, Any], int], Encoder]] = {}


def register_encoder(name: str, factory: Callable[[Dict[str, Any], int], Encoder]):
    """Reference analog: `ModelCatalog.register_custom_model`."""
    _REGISTRY[name] = factory


def build_encoder(model_config: Dict[str, Any], obs_dim: int) -> Encoder:
    name = model_config.get("encoder", "mlp")
    factory = _REGISTRY.get(name)
    if factory is None:
        raise KeyError(
            f"unknown encoder {name!r}; registered: {sorted(_REGISTRY)}"
        )
    return factory(model_config, obs_dim)


def orthogonal(gen: torch.Generator, shape: Tuple[int, ...], scale: float) -> torch.Tensor:
    """An f32 orthogonal matrix of `shape` (the last axis is the output, the
    rest flattened: `jax.nn.initializers.orthogonal`'s layout), drawn from
    `gen` on the generator's device."""
    w = torch.empty((int(np.prod(shape[:-1])), shape[-1]), dtype=torch.float32, device=gen.device)
    torch.nn.init.orthogonal_(w, gain=scale, generator=gen)
    return w.reshape(shape)


# --------------------------------------------------------------------- MLP
def _dense_init(gen, d_in, d_out, scale=np.sqrt(2)):
    w = orthogonal(gen, (d_in, d_out), float(scale))
    return {"w": w, "b": torch.zeros((d_out,), dtype=torch.float32, device=w.device)}


def _mlp_encoder(model_config: Dict[str, Any], obs_dim: int) -> Encoder:
    hidden = tuple(model_config.get("hidden", (64, 64)))
    act = _ACTIVATIONS[model_config.get("activation", "tanh")]
    sizes = (obs_dim, *hidden)

    def init(gen):
        return [_dense_init(gen, a, b) for a, b in zip(sizes[:-1], sizes[1:])]

    def apply(params, x):
        for layer in params:
            x = act(x @ layer["w"] + layer["b"])
        return x

    return Encoder(init=init, apply=apply, out_dim=hidden[-1] if hidden else obs_dim)


# --------------------------------------------------------------------- CNN
def _cnn_encoder(model_config: Dict[str, Any], obs_dim: int) -> Encoder:
    """Conv stack over image observations. Observations arrive FLATTENED
    [B, H*W*C] in NHWC order (the runner flattens all obs); the encoder
    reshapes from `obs_shape`. Kernels are HWIO, as the reference's; the
    convolution runs on NCHW (`VALID`: no padding) and the features are
    flattened back in NHWC order, so the head's weights mean the same."""
    obs_shape = tuple(model_config["obs_shape"])  # (H, W, C)
    if int(np.prod(obs_shape)) != obs_dim:
        raise ValueError(
            f"model.obs_shape {obs_shape} does not match obs_dim {obs_dim}"
        )
    filters: Sequence[Tuple[int, int, int]] = model_config.get(
        "conv_filters", [(16, 4, 2), (32, 4, 2)]
    )  # (out_channels, kernel, stride)
    out_dim = int(model_config.get("encoder_out", 256))
    act = _ACTIVATIONS[model_config.get("activation", "relu")]

    def conv_shapes():
        h, w, c = obs_shape
        specs = []
        for oc, k, s in filters:
            specs.append((c, oc, k, s))
            h = (h - k) // s + 1
            w = (w - k) // s + 1
            c = oc
        return specs, h * w * c

    specs, flat_dim = conv_shapes()

    def init(gen):
        params = {"conv": []}
        for ic, oc, k, _s in specs:
            w = orthogonal(gen, (k, k, ic, oc), float(np.sqrt(2)))
            params["conv"].append(
                {"w": w, "b": torch.zeros((oc,), dtype=torch.float32, device=w.device)}
            )
        params["head"] = _dense_init(gen, flat_dim, out_dim)
        return params

    def apply(params, x):
        b = x.shape[0]
        x = x.reshape((b, *obs_shape)).permute(0, 3, 1, 2)  # NHWC -> NCHW
        for layer, (_ic, _oc, _k, s) in zip(params["conv"], specs):
            # HWIO -> OIHW
            x = act(F.conv2d(x, layer["w"].permute(3, 2, 0, 1), layer["b"], stride=s))
        x = x.permute(0, 2, 3, 1).reshape((b, -1))  # NHWC order, as the reference flattens
        return act(x @ params["head"]["w"] + params["head"]["b"])

    return Encoder(init=init, apply=apply, out_dim=out_dim)


# -------------------------------------------------------------------- LSTM
def _lstm_encoder(model_config: Dict[str, Any], obs_dim: int) -> Encoder:
    """Single-layer LSTM (reference analog: `use_lstm` wrappers in
    `models/catalog.py`). `apply` consumes [B, T, D] sequences, one cell
    step per time step (the reference's `lax.scan`; training/BPTT); `step`
    carries (h, c) for per-step inference and equals one of those steps."""
    units = int(model_config.get("lstm_cell_size", 64))

    def init(gen):
        scale = 1.0 / np.sqrt(units)

        def uniform(shape):
            u = torch.rand(shape, generator=gen, dtype=torch.float32, device=gen.device)
            return u * (2 * scale) - scale

        return {
            "wx": uniform((obs_dim, 4 * units)),
            "wh": uniform((units, 4 * units)),
            "b": torch.zeros((4 * units,), dtype=torch.float32, device=gen.device),
        }

    def cell(params, x_t, state):
        h, c = state
        z = x_t @ params["wx"] + h @ params["wh"] + params["b"]
        i, f, g, o = torch.split(z, units, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)

    def initial_state(batch: int, device=None):
        return (
            torch.zeros((batch, units), dtype=torch.float32, device=device),
            torch.zeros((batch, units), dtype=torch.float32, device=device),
        )

    def apply(params, x):
        # [B, T, D] -> final hidden state [B, units].
        state = initial_state(x.shape[0], x.device)
        for t in range(x.shape[1]):
            _, state = cell(params, x[:, t], state)
        return state[0]

    def step(params, x_t, state):
        return cell(params, x_t, state)

    return Encoder(
        init=init, apply=apply, out_dim=units,
        initial_state=initial_state, step=step,
    )


register_encoder("mlp", _mlp_encoder)
register_encoder("cnn", _cnn_encoder)
register_encoder("lstm", _lstm_encoder)

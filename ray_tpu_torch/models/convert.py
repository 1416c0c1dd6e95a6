"""Params from the JAX reference's pytree.

`ray_tpu/models/gpt.py` keeps params as a dict of stacked `[L, ...]` arrays
(keys and layouts at its `init_params`); the port keeps the same keys and
layouts as torch tensors (a MoE config's `moe_*` experts included), so
conversion is a per-array copy onto the device. This is how tests and `chip_smoke.py` give both packages the same
weights.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device, resolve_dtype
from .gpt import GPTConfig, param_logical_dims


def params_from_jax(np_params: Dict[str, np.ndarray], cfg: GPTConfig, device=None,
                    dtype: Optional[Any] = None) -> Dict[str, torch.Tensor]:
    """numpy arrays (e.g. `{k: np.asarray(v) for k, v in jax_params.items()}`)
    -> torch tensors on `device`, cast to `dtype` (default: kept as stored,
    with bfloat16 arrays widened exactly to float32)."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype) if dtype is not None else None
    missing = set(param_logical_dims(cfg)) - set(np_params)
    if missing:
        raise KeyError(f"params lack {sorted(missing)}")
    L = cfg.n_layers
    out = {}
    for name, arr in np_params.items():
        a = np.asarray(arr)
        if a.dtype.name == "bfloat16":  # ml_dtypes; torch.from_numpy cannot take it
            a = a.astype(np.float32)
        t = torch.tensor(a)  # a copy: arrays from JAX are read-only
        if name not in ("tok_embed", "ln_f_w", "ln_f_b", "pos_embed", "lm_head") and t.shape[0] != L:
            raise ValueError(f"{name}: leading dim {t.shape[0]} != n_layers {L}")
        out[name] = t.to(device=dev, dtype=dt if dt is not None else t.dtype)
    return out

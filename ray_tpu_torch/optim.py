"""AdamW with the arithmetic of `optax.adamw`, the reference's optimizer.

`bench.py` trains with `optax.adamw(3e-4, weight_decay=0.1,
mu_dtype=bf16)`: the first moment is STORED in bf16 and the second in the
params' dtype (f32 master weights). `torch.optim.AdamW` keeps both moments
in the parameter dtype, so the port has its own: per parameter, with
t = the step count,

    mu  = (1 - b1) * g + b1 * mu            (f32; b1 * mu in the stored dtype)
    nu  = (1 - b2) * g**2 + b2 * nu
    u   = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps) + wd * p
    p  -= lr * u
    mu  = mu rounded to mu_dtype            (after the update is formed)

which is `scale_by_adam` (the update uses the f32 first moment; the stored
one is cast afterwards), `add_decayed_weights` on every parameter, and
`scale_by_learning_rate`. A parameter without a gradient steps with a zero
gradient, as optax sees a zero cotangent for a leaf the loss does not use.
Params are updated in place.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .device import resolve_dtype


class AdamW(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-4, mu_dtype: Optional[Any] = None):
        if lr < 0 or eps < 0 or weight_decay < 0 or not all(0.0 <= b < 1.0 for b in betas):
            raise ValueError(f"bad AdamW hyperparameters lr={lr} betas={betas} eps={eps} "
                             f"weight_decay={weight_decay}")
        mu_dtype = None if mu_dtype is None else resolve_dtype(mu_dtype)
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, mu_dtype=mu_dtype))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p, dtype=group["mu_dtype"] or p.dtype)
                    state["nu"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                mu, nu = state["mu"], state["nu"]
                # Bias corrections in f32, as optax computes 1 - decay**count.
                bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32).pow(t).item()
                bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32).pow(t).item()
                # b1 * mu is taken in mu's dtype, b1 rounded to it too (bf16:
                # 0.8984375), as optax's weakly typed product does; then
                # added in f32.
                m = g * (1.0 - b1)
                m.add_(mu * torch.tensor(b1, dtype=mu.dtype).item())
                nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                u = (m / bc1).div_((nu / bc2).sqrt_().add_(eps))
                u.add_(p, alpha=wd)
                p.add_(u, alpha=-lr)
                mu.copy_(m)
        return loss

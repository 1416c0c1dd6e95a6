"""Normalization ops. `rmsnorm` runs the hand-written CUDA kernel
(`kernels/csrc/rmsnorm.cu`) on a CUDA tensor and its plain PyTorch version
on a CPU tensor; `layernorm` is plain torch on both.

When a gradient is wanted `rmsnorm` runs as the custom op
`ray_tpu_torch::rmsnorm`: the forward is the kernel (plain on the CPU) and
the backward is the VJP of `rmsnorm_plain` by torch autograd, as the
reference's custom VJP `_rmsnorm` takes the VJP of `_rmsnorm_ref` (RMSNorm's
backward has no Pallas kernel)."""

from __future__ import annotations

from typing import Optional

import torch


def rmsnorm_plain(x, weight, eps: float = 1e-6):
    """f32 `x * rsqrt(mean(x^2) + eps) * w`, cast back to x's dtype — the
    arithmetic of the CUDA kernel and of the reference's `_rmsnorm_ref`."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def _rmsnorm_fwd(x, weight, eps: float):
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps)
    from ..kernels.rmsnorm import rmsnorm_fwd

    return rmsnorm_fwd(x, weight, eps)


@torch.library.custom_op("ray_tpu_torch::rmsnorm", mutates_args=())
def rmsnorm_op(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """The differentiable RMSNorm forward."""
    return _rmsnorm_fwd(x, weight, eps)


def _rmsnorm_setup_context(ctx, inputs, output):
    x, weight, eps = inputs
    ctx.save_for_backward(x, weight)
    ctx.eps = eps


def _rmsnorm_backward(ctx, g):
    x, weight = ctx.saved_tensors
    with torch.enable_grad():
        x_, w_ = x.detach().requires_grad_(), weight.detach().requires_grad_()
        dx, dw = torch.autograd.grad(rmsnorm_plain(x_, w_, ctx.eps), (x_, w_), g)
    return dx, dw, None


rmsnorm_op.register_autograd(_rmsnorm_backward, setup_context=_rmsnorm_setup_context)


def rmsnorm(x, weight, eps: float = 1e-6):
    """RMSNorm over the last dim, any width (the reference's `D % 128` gate
    was a TPU tiling limit). Norm biases are ignored by the callers, as in
    the reference."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return rmsnorm_op(x, weight, eps)
    return _rmsnorm_fwd(x, weight, eps)


def layernorm(x, weight, bias: Optional[torch.Tensor] = None, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)  # population variance
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)

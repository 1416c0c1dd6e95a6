"""Attention: the plain reference, the flash-attention wrappers and their
gradient.

`flash_attention` runs the hand-written CUDA kernels on CUDA tensors
(`kernels/csrc/flash_fwd.cu` forward, `kernels/csrc/flash_bwd.cu` dQ and
dK/dV backward) and the plain versions on CPU tensors
(`flash_attention_plain`, `flash_attention_bwd_plain`). Ring and Ulysses
context parallelism are not ported yet (see ROADMAP.md).

When a gradient is wanted the forward runs as one custom op,
`ray_tpu_torch::flash_attention`, whose outputs are (o, lse) and whose
backward is the flash backward against the saved (q, k, v, o, lse) — the
reference's custom VJPs `_flash` and `_flash_stats`. Being one op, its
outputs can be saved by a selective-checkpoint policy (`remat_policy=
"attn"` in `models/gpt.py`), so the forward runs once per step. lse is
non-differentiable on every device, as the reference stop-gradients it.

On CUDA a head dim the kernels are not compiled for is zero-padded up to
the next one (`kernels.flash_fwd.HEAD_DIMS`) and the outputs sliced back:
zero columns change neither QKᵀ nor the first D columns of P·V, and the
scale is fixed from the true D before the pad. Beyond the widest compiled
head dim the op raises; it never falls back to the plain version.

Shapes follow [batch, heads, seq, head_dim] throughout. Causal rows are
END-aligned with the keys: query i sits at position i + (Skv - S), which
covers decode over a cached prefix and chunked prefill.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_NEG_INF = -1e30


def _visible(S: int, Skv: int, device):
    """[S, Skv] bool: key j is visible to query i (end-aligned causal)."""
    qpos = torch.arange(S, device=device)[:, None] + (Skv - S)
    return qpos >= torch.arange(Skv, device=device)[None, :]


def _causal_logits(q, k, causal: bool, scale: float):
    """f32 logits [B, H, S, Skv] with the end-aligned causal mask."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        logits = logits.masked_fill(~_visible(q.shape[-2], k.shape[-2], q.device), _NEG_INF)
    return logits


def flash_attention_plain(q, k, v, causal: bool = True, sm_scale: Optional[float] = None,
                          return_lse: bool = False):
    """The flash kernel's function in plain torch (materialized f32 logits,
    probs cast to v's dtype before P·V): output, and with `return_lse` the
    f32 per-row logsumexp as (B*H, 1, S)."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = _causal_logits(q, k, causal, scale)
    out = torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)
    if not return_lse:
        return out
    B, H, S = q.shape[0], q.shape[1], q.shape[2]
    return out, torch.logsumexp(logits, dim=-1).reshape(B * H, 1, S)


# The reference's name for the ground truth the kernel is held to.
attention_reference = flash_attention_plain


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool, scale: float):
    """(dq, dk, dv) of o = flash(q, k, v) for the output cotangent `do`, in
    plain torch with the backward kernels' arithmetic step by step
    (`_flash_bwd_pallas`): Δ = rowsum(dO∘O) in f32; P = exp(S·scale − lse),
    masked to 0; dS = P∘(dP − Δ) cast to the input dtype; P cast to dO's
    dtype for dV; the scale applied last. lse is the forward's, B*H*S f32
    values (unpadded)."""
    B, H, S, _ = q.shape
    f = torch.float32
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse.reshape(B, H, S, 1))
    if causal:
        p = torch.where(_visible(S, k.shape[-2], q.device), p, 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta)).to(q.dtype)
    dq = (torch.matmul(ds.to(f), k.float()) * scale).to(q.dtype)
    dk = (torch.matmul(ds.to(f).transpose(-1, -2), q.float()) * scale).to(k.dtype)
    dv = torch.matmul(p.to(do.dtype).to(f).transpose(-1, -2), do.float()).to(v.dtype)
    return dq, dk, dv


def padded_head_dim(D: int) -> int:
    """The narrowest head dim the flash kernels are compiled for that holds D."""
    from ..kernels.flash_fwd import HEAD_DIMS

    for d in HEAD_DIMS:
        if d >= D:
            return d
    raise ValueError(f"head_dim {D} is wider than {HEAD_DIMS[-1]}, the widest head dim the "
                     "flash kernels are compiled for")


def _pad_d(x, Dp: int):
    """x zero-padded along its last dim to Dp columns."""
    return x if x.shape[-1] == Dp else torch.nn.functional.pad(x, (0, Dp - x.shape[-1]))


def _unpad_d(x, D: int):
    """The first D columns of x (x itself when it has D)."""
    return x if x.shape[-1] == D else x[..., :D]


def _flash_fwd(q, k, v, causal: bool, scale: float, return_lse: bool):
    """Forward with (B*H, 1, S) lse or None: kernel on CUDA, plain on CPU."""
    if q.device.type == "cpu":
        res = flash_attention_plain(q, k, v, causal, scale, return_lse)
        return res if return_lse else (res, None)
    from ..kernels.flash_fwd import flash_fwd

    D, Dp = q.shape[-1], padded_head_dim(q.shape[-1])
    out, lse = flash_fwd(_pad_d(q, Dp), _pad_d(k, Dp), _pad_d(v, Dp), causal, scale, return_lse)
    return _unpad_d(out, D), (lse.view(q.shape[0] * q.shape[1], 1, q.shape[2]) if return_lse else None)


@torch.library.custom_op("ray_tpu_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                       scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The differentiable flash forward: (o, lse)."""
    return _flash_fwd(q, k, v, causal, scale, True)


def _flash_setup_context(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.scale = causal, scale
    ctx.mark_non_differentiable(lse)


def _flash_backward(ctx, g_o, _g_lse):
    """The flash backward: the dQ and dK/dV kernels on CUDA tensors, the
    plain version on CPU tensors."""
    q, k, v, o, lse = ctx.saved_tensors
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, g_o, ctx.causal, ctx.scale)
    else:
        from ..kernels.flash_bwd import flash_bwd

        D, Dp = q.shape[-1], padded_head_dim(q.shape[-1])
        dq, dk, dv = (_unpad_d(g, D) for g in flash_bwd(*(_pad_d(t, Dp) for t in (q, k, v, o)), lse,
                                                        _pad_d(g_o, Dp), ctx.causal, ctx.scale))
    return dq, dk, dv, None, None


flash_attention_op.register_autograd(_flash_backward, setup_context=_flash_setup_context)


def _flash(q, k, v, causal, sm_scale, return_lse):
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out, lse = flash_attention_op(q, k, v, causal, scale)
    else:  # serving: no residuals to keep, and lse only when asked for
        out, lse = _flash_fwd(q, k, v, causal, scale, return_lse)
    return (out, lse) if return_lse else out


def flash_attention(q, k, v, causal: bool = True, sm_scale: Optional[float] = None):
    """Blockwise online-softmax attention, differentiable."""
    return _flash(q, k, v, causal, sm_scale, False)


def flash_attention_with_stats(q, k, v, causal: bool = True, sm_scale: Optional[float] = None):
    """`flash_attention` that also returns the f32 per-row logsumexp,
    UNPADDED as (B*H, 1, S) — the reference's off-TPU shape. lse is not
    differentiable: use it for logging, not as a loss term."""
    return _flash(q, k, v, causal, sm_scale, True)

"""Attention: the plain reference, the flash-attention wrappers and their
gradient.

`flash_attention` runs the hand-written CUDA kernels on CUDA tensors
(`kernels/csrc/flash_fwd.cu` forward, `kernels/csrc/flash_bwd.cu` dQ and
dK/dV backward) and the plain versions on CPU tensors
(`flash_attention_plain`, `flash_attention_bwd_plain`).

Context parallelism, per rank under `parallel.spmd.shard_fn`:
`ring_attention` rotates K/V blocks around the sequence axis with
`collective.ops.ppermute` (f32 softmax statistics, causal masking on
global positions); `ulysses_attention` swaps the split from sequence to
heads with `all_to_all` and runs `flash_attention` on full sequences.

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
scale is fixed from the true D before the pad. Above the widest compiled
head dim (256), D is padded to a multiple of 64 and the wrappers take the
wide-head route (`kernels/csrc/flash_wide.cu`), so every D runs on the
card; the op never falls back to the plain version.

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
    """The narrowest head dim the flash kernels are compiled for that holds
    D; above the widest, D rounded up to the wide route's multiple of 64."""
    from ..kernels import flash_wide
    from ..kernels.flash_fwd import HEAD_DIMS

    for d in HEAD_DIMS:
        if d >= D:
            return d
    return flash_wide.padded_head_dim(D)


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


# ------------------------------------------------------------ ring attention
def _chunk_attn(q, k, v, mask, scale):
    """One K/V chunk's contribution with softmax stats (all f32)."""
    s = torch.matmul(q, k.float().transpose(-1, -2)) * scale
    s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)  # [B, H, S, 1]
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.float())
    return o, m, l


def ring_attention(q, k, v, axis: str = "sp", causal: bool = True, sm_scale: Optional[float] = None):
    """Blockwise ring attention over sequence shards (call under shard_fn).

    Per rank: q, k, v are the LOCAL sequence shard [B, H, S_local, D]. Each
    of the `axis_size` steps attends q against the K/V block currently
    held, then passes K/V one hop around the ring (`ppermute`). Causal
    masking uses global positions, so fully-masked steps contribute
    nothing."""
    from ..collective.ops import axis_index, axis_size, ppermute

    n = axis_size(axis)
    my = axis_index(axis)
    B, H, S_local, D = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qf = q.float()
    rows = my * S_local + torch.arange(S_local, device=q.device)[:, None]  # global q positions
    acc = torch.zeros((B, H, S_local, D), dtype=torch.float32, device=q.device)
    m_prev = torch.full((B, H, S_local, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l_prev = torch.zeros((B, H, S_local, 1), dtype=torch.float32, device=q.device)
    perm = [(d, (d + 1) % n) for d in range(n)]
    for i in range(n):
        src = (my - i) % n  # whose K/V block this rank holds at step i
        cols = src * S_local + torch.arange(S_local, device=q.device)[None, :]
        mask = (rows >= cols) if causal else torch.ones((S_local, S_local), dtype=torch.bool, device=q.device)
        o_c, m_c, l_c = _chunk_attn(qf, k, v, mask, scale)
        m_new = torch.maximum(m_prev, m_c)
        alpha = torch.exp(m_prev - m_new)
        beta = torch.exp(m_c - m_new)
        acc = acc * alpha + o_c * beta
        l_prev = l_prev * alpha + l_c * beta
        m_prev = m_new
        if i + 1 < n:
            k, v = ppermute(k, axis, perm), ppermute(v, axis, perm)
    return (acc / l_prev.clamp_min(1e-30)).to(q.dtype)


def ulysses_attention(q, k, v, axis: str = "sp", causal: bool = True, sm_scale: Optional[float] = None):
    """DeepSpeed-Ulysses context parallelism (call under shard_fn).

    Inputs are sequence-sharded [B, H, S_local, D]; `all_to_all` swaps the
    split from sequence to heads, each rank runs full-sequence flash
    attention (the kernel on the card) over H/n heads, then swaps back.
    Requires H % axis_size == 0."""
    from ..collective.ops import all_to_all

    # [B, H, S/n, D] -> [B, H/n, S, D]
    q2, k2, v2 = (all_to_all(t, axis, split_axis=1, concat_axis=2) for t in (q, k, v))
    o2 = flash_attention(q2, k2, v2, causal=causal, sm_scale=sm_scale)
    # [B, H/n, S, D] -> [B, H, S/n, D]
    return all_to_all(o2, axis, split_axis=2, concat_axis=1)

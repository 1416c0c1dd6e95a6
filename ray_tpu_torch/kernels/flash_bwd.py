"""Launch wrappers of the flash-attention backward kernels
(`csrc/flash_bwd.cu`): dQ and dK/dV.

Replace `ray_tpu/ops/attention.py` `_flash_bwd_pallas`, whose two
pallas_calls run `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`. At the
training shape (S = 1024, D = 64, bf16, causal) both kernels are bound by
tensor-core operations (6·D and 8·D FLOPs per unmasked pair), just above
their bytes. They keep the reference's two-pass split, so dQ needs no
atomics and is deterministic. See the source for the design.

Delta = rowsum(dO∘O) stays a plain torch reduction, as the reference leaves
it to XLA outside Pallas. `flash_bwd_dq.launches` and
`flash_bwd_dkv.launches` count launches of each kernel, and only those.
"""

from __future__ import annotations

import torch

from . import build
from .flash_fwd import HEAD_DIMS, _kernel_view


def _checked(q, k, v, do, lse, delta, causal: bool):
    """Validate the inputs and return them as the kernels read them, with
    lse and Delta as contiguous [B*H, S] f32."""
    tensors = (q, k, v, do, lse, delta)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("flash backward takes CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype == do.dtype):
        raise TypeError(f"q/k/v/dO dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}, {do.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or do.shape != q.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"dO{tuple(do.shape)}")
    B, H, S, D = q.shape
    Skv = k.shape[2]
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D:
        raise ValueError(f"k{tuple(k.shape)} does not match q{tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if S < 1 or Skv < 1 or B * H > 65535:
        raise ValueError(f"unsupported sizes B*H={B * H}, S={S}, Skv={Skv}")
    if causal and Skv < S:
        raise ValueError("causal attention needs Skv >= S (queries are end-aligned)")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.numel() != B * H * S:
            raise ValueError(f"{name} must be f32 with B*H*S = {B * H * S} elements, got "
                             f"{t.dtype} {tuple(t.shape)}")
    rows = (lse.reshape(B * H, S).contiguous(), delta.reshape(B * H, S).contiguous())
    return (*(_kernel_view(t) for t in (q, k, v, do)), *rows)


def _launch(fn, q, k, v, do, lse, delta, outs, causal: bool, scale: float):
    B, H, S, D = q.shape
    lib = build.library()
    err = getattr(lib, fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *(o.data_ptr() for o in outs),
        B, H, S, k.shape[2], D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        do.stride(0), do.stride(1), do.stride(2),
        int(causal), float(scale), build.dtype_code(q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, fn)


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dQ [B,H,S,D] in q's dtype from q, dO [B,H,S,D], k, v [B,H,Skv,D]
    (CUDA, one dtype: bf16 or f32), the forward's lse and Delta (f32,
    B*H*S elements each)."""
    q, k, v, do, lse, delta = _checked(q, k, v, do, lse, delta, causal)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("rt_flash_bwd_dq", q, k, v, do, lse, delta, (dq,), causal, scale)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """(dK, dV) [B,H,Skv,D] in k's dtype; inputs as `flash_bwd_dq`."""
    q, k, v, do, lse, delta = _checked(q, k, v, do, lse, delta, causal)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    _launch("rt_flash_bwd_dkv", q, k, v, do, lse, delta, (dk, dv), causal, scale)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def flash_bwd(q, k, v, o, lse, do, causal: bool, scale: float):
    """(dQ, dK, dV) of attention output o = flash(q, k, v) for the output
    cotangent dO: Delta = rowsum(dO∘O) in f32, then the two kernels."""
    delta = (do.float() * o.float()).sum(-1)
    return (flash_bwd_dq(q, k, v, do, lse, delta, causal, scale),
            *flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale))

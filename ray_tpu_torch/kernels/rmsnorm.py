"""Launch wrapper of the RMSNorm kernel (`csrc/rmsnorm.cu`), and its launch
plan.

Replaces `ray_tpu/ops/norms.py` `_rmsnorm_pallas` (kernel body
`_rmsnorm_kernel`). RMSNorm does ~4 operations per element, far below the
H100's break-even intensity, so it is bound by the bytes it moves: read x
once, write y once, read the weight once. One call is one launch: the
weight is read in its own dtype (f32 or bf16) and upcast in the kernel.

`plan` owns every launch decision: the path, the threads per row, the rows a
CTA normalises at once, the 16-byte vectors each thread holds, the shared
memory and the grid. The kernel uses these values as given (`LaunchPlan` is
the C side's `RmsLaunch`, field for field) and refuses a plan it was not
compiled for. Paths:

- ``regs`` (the main path): a 16-byte-aligned row is held in registers from
  the sum of squares to the scaled write, in persistent CTAs that read the
  weight once; each thread starts the 16-byte loads of its next rows before
  the current rows' reduction.
- ``vector``: aligned rows too wide for registers, two passes over the row
  with 16-byte loads.
- ``scalar``: a base or row stride that is not 16-byte aligned, or D not a
  multiple of the vector width: two passes, element loads.

`rmsnorm_fwd.launches` counts launches of the kernel, and only those.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import torch

from . import build

PATHS = ("regs", "vector", "scalar")
NVS = (1, 2)                    # 16-byte vectors of a row per thread (compiled instantiations; 4 spills)
MAX_CONSUMERS = 512             # row threads of a regs CTA (kMaxConsumers)
VEC = 16                        # bytes of a vector load and its alignment
RESIDENT = 2                    # regs CTAs per SM (the kernel's __launch_bounds__)
ROWS_THREADS = 256              # threads of a vector / scalar CTA
ROWS_RESIDENT = 4               # vector / scalar CTAs per SM (their __launch_bounds__)
PARTIAL_BYTES = 2 * (MAX_CONSUMERS // 32) * 4   # double-buffered per-warp partial sums: every path's shared memory


@dataclass(frozen=True)
class RmsPlan:
    path: str
    threads_per_row: int    # T: threads that reduce one row together
    rows_per_cta: int       # R: rows a CTA normalises at once
    nv: int                 # 16-byte vectors of the row each thread holds (regs)
    smem_bytes: int
    grid: int               # persistent CTAs: CTA c takes row groups c, c + grid, ...
    block_threads: int      # R * T (regs); 256 (vector / scalar)
    w_vec: bool             # weight read with 16-byte loads (regs)
    row_bytes: int          # D * x's element size
    groups: int             # row groups of R rows: ceil(N / R)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _resident_choice(N: int, D: int, xb: int, sms: int):
    """(T, R, nv) for a register-resident row, or None where the row
    is too wide. Rows of T threads, R = MAX_CONSUMERS // T of them per CTA;
    the narrowest T whose row groups give every SM a CTA, else the widest
    (N small: spread each row over more threads and SMs). Narrow rows go
    faster where they fill the card: a CTA then reduces R rows at once."""
    VR = D * xb // VEC
    cands = {}
    for nv in NVS:
        T = 32 * _ceil(_ceil(VR, nv), 32)
        if T > MAX_CONSUMERS or T in cands:
            continue
        cands[T] = (T, MAX_CONSUMERS // T, nv)
    if not cands:
        return None
    ordered = [cands[T] for T in sorted(cands)]
    for c in ordered:
        if _ceil(N, c[1]) >= sms:
            return c
    return ordered[-1]


@lru_cache(maxsize=1024)
def _plan(N: int, D: int, xb: int, rows16: bool, w16: bool, sms: int) -> RmsPlan:
    row_bytes = D * xb
    choice = _resident_choice(N, D, xb, sms) if rows16 else None
    if choice is not None:
        T, R, nv = choice
        groups = _ceil(N, R)
        return RmsPlan(path="regs", threads_per_row=T, rows_per_cta=R, nv=nv, smem_bytes=PARTIAL_BYTES,
                       grid=min(groups, sms * RESIDENT), block_threads=R * T, w_vec=w16, row_bytes=row_bytes,
                       groups=groups)
    path = "vector" if rows16 else "scalar"
    return RmsPlan(path=path, threads_per_row=ROWS_THREADS, rows_per_cta=1, nv=0, smem_bytes=PARTIAL_BYTES,
                   grid=min(N, sms * ROWS_RESIDENT), block_threads=ROWS_THREADS, w_vec=False,
                   row_bytes=row_bytes, groups=N)


def plan(N: int, D: int, x_dtype, row_stride: int, x_ptr: int, y_ptr: int, sms: int, w_ptr: int = 0) -> RmsPlan:
    """The launch plan for x [N, D] (unit stride along D, `row_stride`
    elements between rows) at address x_ptr, y [N, D] contiguous at y_ptr
    and the weight at w_ptr, on a card with `sms` SMs. Every pair of x and w
    dtypes is compiled with the same shapes, so the weight's dtype leaves the
    plan as it is; its address decides its loads."""
    if N < 1 or D < 1:
        raise ValueError(f"N={N}, D={D}: nothing to normalise")
    xb = x_dtype.itemsize
    rows16 = x_ptr % VEC == 0 and (row_stride * xb) % VEC == 0 and (D * xb) % VEC == 0 and y_ptr % VEC == 0
    return _plan(N, D, xb, rows16, w_ptr % VEC == 0, sms)


class LaunchPlan(ctypes.Structure):
    """What `rt_rmsnorm` is handed: `RmsLaunch` in the source, field for field."""

    _fields_ = [(name, ctypes.c_int32) for name in (
        "path", "threads_per_row", "rows_per_cta", "nv", "smem_bytes", "grid", "block_threads", "w_vec")]


@lru_cache(maxsize=1024)
def launch_plan(p: RmsPlan) -> LaunchPlan:
    return LaunchPlan(path=PATHS.index(p.path), threads_per_row=p.threads_per_row, rows_per_cta=p.rows_per_cta,
                      nv=p.nv, smem_bytes=p.smem_bytes, grid=p.grid,
                      block_threads=p.block_threads, w_vec=int(p.w_vec))


@lru_cache(maxsize=None)
def _check_plan_layout(lib) -> None:
    if lib.rt_rmsnorm_plan_bytes() != ctypes.sizeof(LaunchPlan):
        raise RuntimeError("LaunchPlan does not match the kernel library's RmsLaunch")


@lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def rmsnorm_fwd(x, weight, eps: float = 1e-6):
    """RMSNorm of a CUDA tensor over its last dim; output in x's dtype. x
    and the weight are each f32 or bf16; the weight is read in its own
    dtype."""
    if not (x.is_cuda and weight.is_cuda):
        raise ValueError("rmsnorm_fwd takes CUDA tensors")
    xcode, wcode = build.dtype_code(x.dtype), build.dtype_code(weight.dtype)
    D = x.shape[-1]
    if weight.shape != (D,):
        raise ValueError(f"weight shape {tuple(weight.shape)} != ({D},)")
    x2 = x.reshape(-1, D)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    if weight.stride(0) != 1:
        weight = weight.contiguous()
    N = x2.shape[0]
    y = torch.empty((N, D), dtype=x.dtype, device=x.device)
    if N == 0:
        return y.reshape(x.shape)
    row_stride = x2.stride(0) if N > 1 else D  # one row: its stride is never used
    p = plan(N, D, x.dtype, row_stride, x2.data_ptr(), y.data_ptr(), _sm_count(x.device), weight.data_ptr())
    lib = build.library()
    _check_plan_layout(lib)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.rt_rmsnorm(x2.data_ptr(), weight.data_ptr(), y.data_ptr(), N, D, row_stride, float(eps),
                         xcode, wcode, ctypes.byref(launch_plan(p)), stream)
    build.check(lib, err, "rmsnorm")
    rmsnorm_fwd.launches += 1
    return y.reshape(x.shape)


rmsnorm_fwd.launches = 0

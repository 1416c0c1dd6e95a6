"""Launch wrapper of the flash-attention forward kernel
(`csrc/flash_fwd.cu`), and its launch plan.

Replaces `ray_tpu/ops/attention.py` `_flash_fwd_pallas` (kernel body
`_flash_fwd_kernel`). On the H100 the causal forward does (S+1)/4 FLOPs
per byte it must move (bf16): bound by bytes below S ~ 1200 and by
tensor-core operations above. The bf16 kernel is warp-specialised: one
producer warp streams Q, K and V tiles in with TMA through a ring of
shared-memory stages; two or three consumer warpgroups compute S = Q·Kᵀ
and O += P·V with `wgmma` (P from registers), taking turns at the tensor
cores; persistent CTAs walk the work items heaviest-first. See the source
for the design. The f32 path (parity runs) is a plain-FMA kernel.

`launches` owns every launch decision of the bf16 kernel that follows from
the shapes; each launch's plan holds its stages, shared memory, grid, the q
tiles in launch order with the key tiles each consumer warpgroup reads, and
the TMA tensor maps (dims, byte strides, boxes). The kernel uses these values as given (`LaunchPlan`
is the C side's `FwdLaunch`, byte for byte); it only refuses a plan whose
tile shape is not the one it was compiled for (the wgmma shapes are
compile-time), so the CPU tests reach every value the kernel runs with.

`launches` splits one call into kernel launches where a plan's table or the
grid would overflow: q tiles in groups of at most MAX_Q_TILES per launch
(each launch writes the rows and lse of its own tiles), and heads in ranges
of at most MAX_BH (the f32 kernel's grid is (q tiles, B*H)). At the main
path's shapes a call is one launch.

`flash_fwd.launches` counts launches of the kernel, and only those.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import torch

from . import build

HEAD_DIMS = (32, 64, 128, 256)
MAX_STAGES = 4
MAX_Q_TILES = 256           # q tiles per head a plan may list (kMaxQTiles in the source)
MAX_BH = 65535              # heads (B*H) one launch may take: the f32 kernel's grid.y
SMEM_LIMIT = 232_448        # dynamic shared memory one block may use on the H100
SMEM_ALIGN_SLACK = 1024     # the kernel aligns its tiles to 1024 bytes (the swizzle atom)
ELEM = 2                    # bytes of a bf16 element
WG_ROWS = 64                # q rows of one consumer warpgroup


@dataclass(frozen=True)
class TmaMap:
    """A rank-4 TMA tensor map over [B, H, L, D]: dims innermost first
    (D, L, H, B), byte strides of L, H and B, and the box one copy lands
    (columns, rows)."""

    dims: tuple
    strides: tuple
    box: tuple


@dataclass(frozen=True)
class QTile:
    """One q tile of a head: its first row (negative for a ragged first
    tile), the key tiles the producer streams for it, and the key tiles
    each consumer warpgroup reads (0 for a warpgroup with no real row)."""

    q0: int
    n_kv: int
    n_kv_wg: tuple


@dataclass(frozen=True)
class FwdPlan:
    block_q: int
    block_k: int            # keys per tile
    stages: int             # K/V ring depth
    swizzle: int            # bytes of one shared-memory row of a box (128, or 64 at D = 32)
    box_cols: int           # bf16 columns of one TMA box: swizzle / 2
    smem_bytes: int
    BH: int
    n_items: int            # (q tile, b*h) work items: item i is tile i // BH of head i % BH
    grid: int               # persistent CTAs: CTA c takes items c, c + grid, ...
    tiles: tuple            # QTile per q tile, in launch order (heaviest first)


def consumer_warpgroups(D: int) -> int:
    """Consumer warpgroups of 64 q rows: three at D <= 64 (one warpgroup's
    softmax takes as long as two warpgroups' products there), two above."""
    return 3 if D <= 64 else 2


def block_q(D: int) -> int:
    """q rows per work item."""
    return WG_ROWS * consumer_warpgroups(D)


def block_k(D: int) -> int:
    """Keys per tile: 128, or 64 at D = 256 so that Q and two stages fit."""
    return 64 if D == 256 else 128


def swizzle_bytes(D: int) -> int:
    """128-byte swizzle, 64-byte where a row is only 64 bytes (D = 32)."""
    return 64 if D == 32 else 128


def stages_o(D: int) -> bool:
    """O goes out through shared memory and a TMA store where it fits (D <=
    128); at D = 256 the threads store it directly."""
    return D <= 128


def smem_bytes(D: int, stages: int) -> int:
    """Q, the O staging tile, `stages` K and V tiles, 3 mbarriers per stage
    and 2 for Q, and the alignment slack: the kernel's shared-memory layout."""
    q = block_q(D) * D * ELEM
    o = q if stages_o(D) else 0
    kv = block_k(D) * D * ELEM
    return SMEM_ALIGN_SLACK + q + o + 2 * stages * kv + 8 * (3 * stages + 2)


def stages_for(D: int) -> int:
    """The deepest ring (at most MAX_STAGES) that fits in shared memory."""
    fits = [s for s in range(2, MAX_STAGES + 1) if smem_bytes(D, s) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"no ring of >= 2 stages fits at D={D}")
    return max(fits)


def kv_tiles_for_rows(r0: int, r1: int, S: int, Skv: int, causal: bool, bk: int) -> int:
    """Key tiles that q rows [r0, r1) read, rows outside [0, S) left out:
    up to the last key the last real row sees (end-aligned causal: row i
    sees keys <= i + Skv - S), or all; 0 without a real row."""
    lo, hi = max(r0, 0), min(r1, S)
    if lo >= hi:
        return 0
    kv_end = min(Skv, Skv - S + hi) if causal else Skv
    return -(-kv_end // bk)


def q_tiles(S: int, Skv: int, causal: bool, D: int) -> tuple:
    """The q tiles of one head in launch order. The tiles are aligned to the
    END of the sequence, so a ragged tile is the first (its rows before 0
    are padding: TMA zero-fills them and they are never stored), the
    lightest under the causal mask; the order is longest first (LPT)."""
    bq, bk, n = block_q(D), block_k(D), -(-S // block_q(D))
    tiles = []
    for qt in range(n):
        q0 = S - (n - qt) * bq
        wg = tuple(kv_tiles_for_rows(q0 + WG_ROWS * c, q0 + WG_ROWS * (c + 1), S, Skv, causal, bk)
                   for c in range(consumer_warpgroups(D)))
        tiles.append(QTile(q0=q0, n_kv=max(wg), n_kv_wg=wg))
    return tuple(sorted(tiles, key=lambda t: -t.n_kv))


def _plan(BH: int, D: int, tiles: tuple, sm_count: int) -> FwdPlan:
    bq, bk, stages, sw = block_q(D), block_k(D), stages_for(D), swizzle_bytes(D)
    n_items = len(tiles) * BH
    return FwdPlan(block_q=bq, block_k=bk, stages=stages, swizzle=sw, box_cols=sw // ELEM,
                   smem_bytes=smem_bytes(D, stages), BH=BH, n_items=n_items,
                   grid=min(n_items, sm_count), tiles=tiles)


def _tiles(S: int, Skv: int, D: int, causal: bool) -> tuple:
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    tiles = q_tiles(S, Skv, causal, D)
    if tiles[0].n_kv > 0xFFFF:
        raise ValueError(f"S={S}, Skv={Skv} at D={D}: more key tiles than 65535")
    return tiles


@dataclass(frozen=True)
class Launch:
    """One launch of a call over [B, H, L, D]: the heads [b0:b1, h0:h1]
    (a contiguous range of b*H + h), and for bf16 the plan of the tiles it
    covers (a FwdPlan, or a flash_bwd.KernelPlan; None for f32, whose
    kernels tile themselves)."""

    b0: int
    b1: int
    h0: int
    h1: int
    plan: Optional[object]

    def heads(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, ...] at this launch's heads (x itself when they are all)."""
        if (self.b0, self.h0, self.b1, self.h1) == (0, 0, *x.shape[:2]):
            return x
        return x[self.b0:self.b1, self.h0:self.h1]

    def rows(self, x: torch.Tensor, H: int) -> torch.Tensor:
        """x [B*H, ...] at this launch's heads (a contiguous range; x itself
        when they are all)."""
        lo, hi = self.b0 * H + self.h0, (self.b1 - 1) * H + self.h1
        return x if (lo, hi) == (0, x.shape[0]) else x[lo:hi]


def bh_chunks(B: int, H: int, cap: int = MAX_BH) -> tuple:
    """(b0, b1, h0, h1) ranges of at most `cap` heads each that cover the B*H
    heads once, in order. Each is whole batches (every head of b0..b1-1) or
    a head range of one batch, so each is a contiguous range of b*H + h: a
    contiguous output or lse viewed at its first head."""
    if B * H <= cap:
        return ((0, B, 0, H),)
    if H <= cap:
        nb = cap // H
        return tuple((b, min(b + nb, B), 0, H) for b in range(0, B, nb))
    return tuple((b, b + 1, h, min(h + cap, H)) for b in range(B) for h in range(0, H, cap))


def split(tiles: tuple, cap: int) -> tuple:
    """The tiles in launch order, in groups of at most `cap`."""
    return tuple(tiles[i:i + cap] for i in range(0, len(tiles), cap))


@lru_cache(maxsize=256)
def launches(B: int, H: int, S: int, Skv: int, D: int, causal: bool, sm_count: int,
             bf16: bool = True) -> tuple:
    """The launches of one forward call: every (head range, group of at
    most MAX_Q_TILES q tiles) for bf16, every head range for f32."""
    chunks = bh_chunks(B, H)
    if not bf16:
        return tuple(Launch(*c, None) for c in chunks)
    groups = split(_tiles(S, Skv, D, causal), MAX_Q_TILES)
    return tuple(Launch(b0, b1, h0, h1, _plan((b1 - b0) * (h1 - h0), D, g, sm_count))
                 for b0, b1, h0, h1 in chunks for g in groups)


def byte_strides(x: torch.Tensor) -> tuple:
    """(batch, head, seq) strides of x [B, H, L, D] in bytes."""
    return tuple(s * x.element_size() for s in x.stride()[:3])


def tma_maps(p: FwdPlan, q, k, v, o) -> tuple:
    """The four tensor maps the bf16 kernel copies through: over [B, H, L,
    D] with the tensors' own byte strides, a box of box_cols columns by
    block_q (q), block_k (k, v) or 64 (o: one consumer warpgroup's rows)
    rows."""
    def one(x, rows):
        B, H, L, D = x.shape
        sb, sh, sl = byte_strides(x)
        return TmaMap(dims=(D, L, H, B), strides=(sl, sh, sb), box=(p.box_cols, rows))
    return one(q, p.block_q), one(k, p.block_k), one(v, p.block_k), one(o, WG_ROWS)


class _TmaSpec(ctypes.Structure):
    _fields_ = [("dims", ctypes.c_uint64 * 4), ("strides", ctypes.c_uint64 * 3),
                ("box", ctypes.c_uint32 * 2)]


class _QTile(ctypes.Structure):
    _fields_ = [("q0", ctypes.c_int32), ("n_kv", ctypes.c_uint16), ("n_kv_wg", ctypes.c_uint16 * 3)]


class LaunchPlan(ctypes.Structure):
    """What `rt_flash_fwd` is handed for a bf16 launch: `FwdLaunch` in the
    source, field for field."""

    _fields_ = [("block_q", ctypes.c_int32), ("block_k", ctypes.c_int32), ("swizzle", ctypes.c_int32),
                ("stages", ctypes.c_int32), ("smem_bytes", ctypes.c_int32), ("grid", ctypes.c_int32),
                ("n_items", ctypes.c_int32), ("BH", ctypes.c_int32), ("maps", _TmaSpec * 4),
                ("tiles", _QTile * MAX_Q_TILES)]


@lru_cache(maxsize=256)
def _packed(p: FwdPlan) -> LaunchPlan:
    lp = LaunchPlan(block_q=p.block_q, block_k=p.block_k, swizzle=p.swizzle, stages=p.stages,
                    smem_bytes=p.smem_bytes, grid=p.grid, n_items=p.n_items, BH=p.BH)
    for slot, t in zip(lp.tiles, p.tiles):
        slot.q0, slot.n_kv = t.q0, t.n_kv
        slot.n_kv_wg[:len(t.n_kv_wg)] = t.n_kv_wg
    return lp


def launch_plan(p: FwdPlan, q, k, v, o) -> LaunchPlan:
    """p and the tensors' tensor maps packed as the kernel's launch takes them."""
    lp = LaunchPlan.from_buffer_copy(_packed(p))
    for spec, m in zip(lp.maps, tma_maps(p, q, k, v, o)):
        spec.dims[:], spec.strides[:], spec.box[:] = m.dims, m.strides, m.box
    return lp


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """x itself when the kernels can read it through its strides, else a
    contiguous copy in a fresh (aligned) allocation. Read in place means:
    unit last stride, base and every other stride 16-byte aligned — what TMA
    requires of a tensor map's base and strides (the backward kernels'
    16-byte loads need the same). A contiguous tensor at a misaligned offset
    is copied too (`.contiguous()` would return it as it is)."""
    return x if _readable_in_place(x) else x.clone(memory_format=torch.contiguous_format)


def _readable_in_place(x: torch.Tensor) -> bool:
    size = x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all((s * size) % 16 == 0 for s in x.stride()[:-1]))


@lru_cache(maxsize=None)
def _check_plan_layout(lib) -> None:
    if lib.rt_flash_fwd_plan_bytes() != ctypes.sizeof(LaunchPlan):
        raise RuntimeError("LaunchPlan does not match the kernel library's FwdLaunch")


@lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_fwd(q, k, v, causal: bool, scale: float, return_lse: bool = False):
    """q [B,H,S,D], k/v [B,H,Skv,D] CUDA tensors of one dtype (bf16 or f32)
    -> (o [B,H,S,D] in that dtype, lse [B*H, S] f32 or None)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_fwd takes CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    code = build.dtype_code(q.dtype)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    B, H, S, D = q.shape
    Skv = k.shape[2]
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D:
        raise ValueError(f"k{tuple(k.shape)} does not match q{tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if S < 1 or Skv < 1:
        raise ValueError(f"unsupported sizes S={S}, Skv={Skv}")
    if causal and Skv < S:
        raise ValueError("causal attention needs Skv >= S (queries are end-aligned)")
    if not scale > 0:
        raise ValueError(f"scale must be positive, got {scale}")  # the kernels take maxima of raw scores
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    o = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device) if return_lse else None
    lib = build.library()
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_plan_layout(lib)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    for ln in launches(B, H, S, Skv, D, bool(causal), _sm_count(q.device), bf16):
        qc, kc, vc, oc = (ln.heads(x) for x in (q, k, v, o))
        lp = launch_plan(ln.plan, qc, kc, vc, oc) if bf16 else None  # the f32 kernel tiles itself
        err = lib.rt_flash_fwd(
            qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), oc.data_ptr(),
            ln.rows(lse, H).data_ptr() if lse is not None else None,
            ln.b1 - ln.b0, ln.h1 - ln.h0, S, Skv, D,
            *byte_strides(qc), *byte_strides(kc), *byte_strides(vc),
            int(causal), float(scale), code, ctypes.byref(lp) if lp is not None else None, stream,
        )
        build.check(lib, err, "flash_fwd")
        flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0

"""Launch wrappers of the flash-attention backward kernels
(`csrc/flash_bwd.cu`): dQ (with Δ) and dK/dV, and their launch plan.

Replace `ray_tpu/ops/attention.py` `_flash_bwd_pallas`, whose two
pallas_calls run `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`. At the
training shape (S = 1024, D = 64, bf16, causal) both kernels are bound by
tensor-core operations (6·D and 8·D FLOPs per unmasked pair), just above
their bytes. They keep the reference's two-pass split, so no gradient needs
atomics and every one is deterministic. The bf16 kernels are
warp-specialised like the forward: one producer warp streams tiles in with
TMA through a ring of shared-memory stages, two consumer warpgroups take
turns at the tensor cores (`wgmma`), persistent CTAs walk the work items
heaviest first. See the source for the design. The f32 kernels (parity
runs) use plain FMA.

Δ = rowsum(dO∘O) is computed by the dQ kernel, from the O and dO tiles it
holds in shared memory, and written as f32 [B*H, S] for the dK/dV kernel:
`flash_bwd` launches dQ first and dK/dV after it on the same stream.

`launches` owns every launch decision of the bf16 kernels that follows from
the shapes; each launch's plan holds the kernel's stages, shared memory,
grid, the work items in launch order with the stream tiles each consumer
warpgroup reads, and the TMA tensor maps (dims, byte strides, boxes). The kernels use these values as
given (`LaunchPlan` is the C side's `BwdLaunch`, byte for byte) and refuse
only a tile shape they were not compiled for.

`launches` splits one call of a kernel into launches as the forward does
(`flash_fwd.launches`): outer tiles in groups of at most MAX_TILES (dQ
works per q tile, dK/dV per key tile, so the launches' outputs do not
overlap), heads in ranges of at most MAX_BH. Every dQ launch runs before
the first dK/dV launch, which reads Δ of every q row.

`flash_bwd_dq.launches` and `flash_bwd_dkv.launches` count launches of each
kernel, and only those.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import torch

from . import build
from .flash_fwd import (
    ELEM,
    HEAD_DIMS,
    MAX_BH,
    SMEM_ALIGN_SLACK,
    SMEM_LIMIT,
    WG_ROWS,
    Launch,
    TmaMap,
    _kernel_view,
    _sm_count,
    _TmaSpec,
    bh_chunks,
    byte_strides,
    kv_tiles_for_rows,
    split,
    swizzle_bytes,
)

MAX_STAGES = 4
MAX_TILES = 128             # outer tiles per head a plan may list (kMaxTiles in the source)
STATS_BYTES = 8             # lse and Δ (f32) of one q row in a dK/dV stage
BARRIER = 8                 # bytes of one mbarrier


@dataclass(frozen=True)
class Tile:
    """One outer tile of a head: its first row `r0` (q rows for dQ, negative
    for a ragged first tile; keys for dK/dV), the stream tiles [lo, hi) the
    producer loads for it (key tiles for dQ, q tiles for dK/dV), and the
    range [wg_lo[c], wg_hi[c]) that consumer warpgroup c reads, (0, 0) for a
    warpgroup without a real row."""

    r0: int
    lo: int
    hi: int
    wg_lo: tuple
    wg_hi: tuple


@dataclass(frozen=True)
class KernelPlan:
    kind: str               # "dq" or "dkv"
    warpgroups: int         # consumer warpgroups, 64 outer rows each
    block_rows: int         # outer rows per work item: q rows (dQ) or keys (dK/dV)
    block_stream: int       # rows per streamed tile: keys (dQ) or q rows (dK/dV)
    splits: int             # column splits of the gradients (dK/dV at D = 256: 2)
    stages: int             # ring depth
    swizzle: int
    box_cols: int
    smem_bytes: int
    BH: int
    n_items: int            # item i: tile i // (BH * splits), head (i % (BH * splits)) // splits
    grid: int               # persistent CTAs: CTA c takes items c, c + grid, ...
    tiles: tuple            # Tile per outer tile, in launch order (heaviest first)


def dq_warpgroups(D: int) -> int:
    """Two consumer warpgroups; one at D = 256, where Q, dO and O of 128
    rows would not fit in shared memory beside a ring."""
    return 1 if D == 256 else 2


def dq_block_k(D: int) -> int:
    """Keys per tile of the dQ kernel: 64, 32 at D = 256 (registers)."""
    return 32 if D == 256 else 64


def dkv_block_q(D: int) -> int:
    """q rows per tile of the dK/dV kernel: 64, 32 at D >= 128, where the
    dK and dV accumulators take most of the registers."""
    return 64 if D <= 64 else 32


def dkv_splits(D: int) -> int:
    """dK and dV of 64 x D f32 each do not fit a thread's registers at
    D = 256: each item computes one half of the columns (and recomputes
    S^T and dP^T)."""
    return 2 if D == 256 else 1


def staged_out(D: int) -> bool:
    """The gradients go out through shared memory and TMA stores where it
    fits (D <= 128); at D = 256 the threads store them directly."""
    return D <= 128


def smem_bytes(kind: str, D: int, stages: int) -> int:
    """The kernel's shared-memory layout: alignment slack, the item's tiles
    (dQ: Q, dO, O; dK/dV: K, V), the output staging tiles, `stages` stream
    stages (dQ: K and V; dK/dV: Q, dO, and lse and Δ of their rows), and the
    mbarriers (full and empty per stage, two for the item's tiles)."""
    bars = BARRIER * (2 * stages + 2)
    if kind == "dq":
        bq = WG_ROWS * dq_warpgroups(D)
        item = 3 * bq * D * ELEM
        out = bq * D * ELEM if staged_out(D) else 0
        stage = 2 * dq_block_k(D) * D * ELEM
    else:
        bkv, bq = 2 * WG_ROWS, dkv_block_q(D)
        item = 2 * bkv * D * ELEM
        out = 2 * bkv * D * ELEM if staged_out(D) else 0
        stage = 2 * bq * D * ELEM + bq * STATS_BYTES
    return SMEM_ALIGN_SLACK + item + out + stages * stage + bars


def stages_for(kind: str, D: int) -> int:
    """The deepest ring (at most MAX_STAGES) that fits in shared memory."""
    fits = [s for s in range(2, MAX_STAGES + 1) if smem_bytes(kind, D, s) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"no ring of >= 2 stages fits the {kind} kernel at D={D}")
    return max(fits)


def dq_tiles(S: int, Skv: int, causal: bool, D: int) -> tuple:
    """The q tiles of one head for the dQ kernel, in launch order. As in the
    forward, the tiles end at the sequence's end, so a ragged tile is the
    first (rows before 0 are zero-filled and never stored) and the lightest;
    each warpgroup reads the key tiles up to the last key its real rows see."""
    nwg, bk = dq_warpgroups(D), dq_block_k(D)
    bq = WG_ROWS * nwg
    n = -(-S // bq)
    tiles = []
    for qt in range(n):
        q0 = S - (n - qt) * bq
        hi = tuple(kv_tiles_for_rows(q0 + WG_ROWS * c, q0 + WG_ROWS * (c + 1), S, Skv, causal, bk)
                   for c in range(nwg))
        tiles.append(Tile(r0=q0, lo=0, hi=max(hi), wg_lo=(0,) * nwg, wg_hi=hi))
    return tuple(sorted(tiles, key=lambda t: -(t.hi - t.lo)))


def first_q_tile(k0: int, k1: int, S: int, Skv: int, causal: bool, bq: int):
    """The first q tile (of bq rows, from row 0) with a row that sees one of
    the keys [k0, k1), keys at or past Skv left out; None without a real
    key. End-aligned causal: row i sees keys <= i + Skv - S."""
    k1 = min(k1, Skv)
    if k0 >= k1:
        return None
    return max(0, k0 - (Skv - S)) // bq if causal else 0


def dkv_tiles(S: int, Skv: int, causal: bool, D: int) -> tuple:
    """The key tiles of one head for the dK/dV kernel, in launch order. Key
    tiles start at 0 (a ragged last tile is zero-filled past Skv and not
    stored); each warpgroup reads the q tiles from the first one that
    reaches its keys to the end. Heaviest (earliest) tiles first."""
    bkv, bq = 2 * WG_ROWS, dkv_block_q(D)
    nq = -(-S // bq)
    tiles = []
    for kt in range(-(-Skv // bkv)):
        k0 = kt * bkv
        firsts = [first_q_tile(k0 + WG_ROWS * c, k0 + WG_ROWS * (c + 1), S, Skv, causal, bq)
                  for c in range(2)]
        lo = tuple(0 if f is None else f for f in firsts)
        hi = tuple(0 if f is None else nq for f in firsts)
        active = [f for f in firsts if f is not None]
        tiles.append(Tile(r0=k0, lo=min(active), hi=nq, wg_lo=lo, wg_hi=hi))
    return tuple(sorted(tiles, key=lambda t: -(t.hi - t.lo)))


def _tiles(kind: str, S: int, Skv: int, D: int, causal: bool) -> tuple:
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    tiles = dq_tiles(S, Skv, causal, D) if kind == "dq" else dkv_tiles(S, Skv, causal, D)
    if max(t.hi for t in tiles) > 0xFFFF:
        raise ValueError(f"S={S}, Skv={Skv} at D={D}: the {kind} kernel takes at most 65535 "
                         "stream tiles")
    return tiles


def _kernel_plan(kind: str, BH: int, D: int, tiles: tuple, sm_count: int) -> KernelPlan:
    if kind == "dq":
        nwg, rows, stream, splits = dq_warpgroups(D), WG_ROWS * dq_warpgroups(D), dq_block_k(D), 1
    else:
        nwg, rows, stream, splits = 2, 2 * WG_ROWS, dkv_block_q(D), dkv_splits(D)
    stages, sw = stages_for(kind, D), swizzle_bytes(D)
    n_items = len(tiles) * BH * splits
    return KernelPlan(kind=kind, warpgroups=nwg, block_rows=rows, block_stream=stream, splits=splits,
                      stages=stages, swizzle=sw, box_cols=sw // ELEM, smem_bytes=smem_bytes(kind, D, stages),
                      BH=BH, n_items=n_items, grid=min(n_items, sm_count), tiles=tiles)


@lru_cache(maxsize=512)
def launches(kind: str, B: int, H: int, S: int, Skv: int, D: int, causal: bool, sm_count: int,
             bf16: bool = True) -> tuple:
    """The launches of one call of the `kind` kernel ("dq" or "dkv"): every
    (head range, group of at most MAX_TILES outer tiles) for bf16, every
    head range for f32."""
    chunks = bh_chunks(B, H)
    if not bf16:
        return tuple(Launch(*c, None) for c in chunks)
    groups = split(_tiles(kind, S, Skv, D, causal), MAX_TILES)
    return tuple(Launch(b0, b1, h0, h1, _kernel_plan(kind, (b1 - b0) * (h1 - h0), D, g, sm_count))
                 for b0, b1, h0, h1 in chunks for g in groups)


def tma_maps(p: KernelPlan, *tensors) -> tuple:
    """The six tensor maps a kernel copies through, over [B, H, L, D] with
    the tensors' own byte strides. dQ: q, dO, O (boxes of block_rows rows),
    k, v (block_stream rows), dq (64 rows: one warpgroup's). dK/dV: q, dO
    (block_stream rows), k, v (block_rows rows), dk, dv (64 rows)."""
    if p.kind == "dq":
        rows = (p.block_rows,) * 3 + (p.block_stream,) * 2 + (WG_ROWS,)
    else:
        rows = (p.block_stream,) * 2 + (p.block_rows,) * 2 + (WG_ROWS,) * 2

    def one(x, r):
        B, H, L, D = x.shape
        sb, sh, sl = byte_strides(x)
        return TmaMap(dims=(D, L, H, B), strides=(sl, sh, sb), box=(p.box_cols, r))
    return tuple(one(x, r) for x, r in zip(tensors, rows, strict=True))


class _Tile(ctypes.Structure):
    _fields_ = [("r0", ctypes.c_int32), ("lo", ctypes.c_uint16), ("hi", ctypes.c_uint16),
                ("wg_lo", ctypes.c_uint16 * 2), ("wg_hi", ctypes.c_uint16 * 2)]


class LaunchPlan(ctypes.Structure):
    """What `rt_flash_bwd_dq` and `rt_flash_bwd_dkv` are handed for a bf16
    launch: `BwdLaunch` in the source, field for field."""

    _fields_ = [("block_rows", ctypes.c_int32), ("block_stream", ctypes.c_int32),
                ("swizzle", ctypes.c_int32), ("stages", ctypes.c_int32),
                ("smem_bytes", ctypes.c_int32), ("grid", ctypes.c_int32),
                ("n_items", ctypes.c_int32), ("BH", ctypes.c_int32),
                ("splits", ctypes.c_int32), ("warpgroups", ctypes.c_int32),
                ("maps", _TmaSpec * 6), ("tiles", _Tile * MAX_TILES)]


@lru_cache(maxsize=512)
def _packed(p: KernelPlan) -> LaunchPlan:
    lp = LaunchPlan(block_rows=p.block_rows, block_stream=p.block_stream, swizzle=p.swizzle,
                    stages=p.stages, smem_bytes=p.smem_bytes, grid=p.grid, n_items=p.n_items,
                    BH=p.BH, splits=p.splits, warpgroups=p.warpgroups)
    for slot, t in zip(lp.tiles, p.tiles):
        slot.r0, slot.lo, slot.hi = t.r0, t.lo, t.hi
        slot.wg_lo[:len(t.wg_lo)] = t.wg_lo
        slot.wg_hi[:len(t.wg_hi)] = t.wg_hi
    return lp


def launch_plan(p: KernelPlan, *tensors) -> LaunchPlan:
    """p and the tensors' tensor maps (in `tma_maps`' order) packed as the
    kernel's launch takes them."""
    lp = LaunchPlan.from_buffer_copy(_packed(p))
    for spec, m in zip(lp.maps, tma_maps(p, *tensors)):
        spec.dims[:], spec.strides[:], spec.box[:] = m.dims, m.strides, m.box
    return lp


@lru_cache(maxsize=None)
def _check_plan_layout(lib) -> None:
    if lib.rt_flash_bwd_plan_bytes() != ctypes.sizeof(LaunchPlan):
        raise RuntimeError("LaunchPlan does not match the kernel library's BwdLaunch")


def _checked(q, k, v, do, causal: bool, rows: dict):
    """Validate the inputs; return q, k, v, dO as the kernels read them and
    the f32 row vectors in `rows` (name -> tensor) as contiguous [B*H, S]."""
    if not all(t.is_cuda for t in (q, k, v, do, *rows.values())):
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
    if S < 1 or Skv < 1:
        raise ValueError(f"unsupported sizes S={S}, Skv={Skv}")
    if causal and Skv < S:
        raise ValueError("causal attention needs Skv >= S (queries are end-aligned)")
    for name, t in rows.items():
        if t.dtype != torch.float32 or t.numel() != B * H * S:
            raise ValueError(f"{name} must be f32 with B*H*S = {B * H * S} elements, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return (*(_kernel_view(t) for t in (q, k, v, do)),
            *(t.reshape(B * H, S).contiguous() for t in rows.values()))


def _launch(fn: str, kind: str, inputs: tuple, rows: tuple, outs: tuple, map_order: tuple,
            causal: bool, scale: float) -> int:
    """Call `fn` on the kernel library once per launch of `kind`: the
    `inputs` (q, k, v, ... [B, H, L, D] in bf16 or f32; their strides are
    passed in bytes), the `rows` (lse, Δ: [B*H, S] f32), the `outs` ([B, H,
    L, D]), each at the launch's heads, then the sizes, the strides, and for
    bf16 the launch's plan with tensor maps over (inputs + outs)[i] for i in
    `map_order`. Returns the number of launches."""
    q, k = inputs[:2]
    B, H, S, D = q.shape
    lib = build.library()
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_plan_layout(lib)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lns = launches(kind, B, H, S, k.shape[2], D, bool(causal), _sm_count(q.device), bf16)
    for ln in lns:
        ins, os_ = tuple(ln.heads(t) for t in inputs), tuple(ln.heads(t) for t in outs)
        views = ins + os_
        lp = launch_plan(ln.plan, *(views[i] for i in map_order)) if bf16 else None  # f32 tiles itself
        err = getattr(lib, fn)(
            *(t.data_ptr() for t in ins + tuple(ln.rows(r, H) for r in rows) + os_),
            ln.b1 - ln.b0, ln.h1 - ln.h0, S, k.shape[2], D, *(s for t in ins for s in byte_strides(t)),
            int(causal), float(scale), build.dtype_code(q.dtype),
            ctypes.byref(lp) if lp is not None else None, stream,
        )
        build.check(lib, err, fn)
    return len(lns)


def flash_bwd_dq(q, k, v, o, do, lse, causal: bool, scale: float):
    """(dQ [B,H,S,D] in q's dtype, Δ = rowsum(dO∘O) [B*H, S] f32) from q, O,
    dO [B,H,S,D], k, v [B,H,Skv,D] (CUDA, one dtype: bf16 or f32) and the
    forward's lse (f32, B*H*S elements)."""
    if o.shape != q.shape or o.dtype != q.dtype or not o.is_cuda:
        raise ValueError(f"o must be a CUDA tensor like q{tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(o.shape)} {o.dtype} on {o.device}")
    q, k, v, do, lse = _checked(q, k, v, do, causal, {"lse": lse})
    o = _kernel_view(o)
    B, H, S, _ = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    # tensor maps over q, dO, O, k, v, dq
    flash_bwd_dq.launches += _launch("rt_flash_bwd_dq", "dq", (q, k, v, o, do), (lse, delta), (dq,),
                                     (0, 4, 3, 1, 2, 5), causal, scale)
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """(dK, dV) [B,H,Skv,D] in k's dtype; q, k, v, dO and lse as
    `flash_bwd_dq`, Δ as it returns it (f32, B*H*S elements)."""
    q, k, v, do, lse, delta = _checked(q, k, v, do, causal, {"lse": lse, "delta": delta})
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    # tensor maps over q, dO, k, v, dk, dv
    flash_bwd_dkv.launches += _launch("rt_flash_bwd_dkv", "dkv", (q, k, v, do), (lse, delta), (dk, dv),
                                      (0, 3, 1, 2, 4, 5), causal, scale)
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def flash_bwd(q, k, v, o, lse, do, causal: bool, scale: float):
    """(dQ, dK, dV) of attention output o = flash(q, k, v) for the output
    cotangent dO. The order carries a dependency: the dQ kernel computes Δ =
    rowsum(dO∘O) and writes it, and the dK/dV kernel, launched after it on
    the same stream, reads it."""
    dq, delta = flash_bwd_dq(q, k, v, o, do, lse, causal, scale)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale))

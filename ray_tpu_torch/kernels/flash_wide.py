"""Launch plan of the wide-head flash kernels (`csrc/flash_wide.cu`): the
route of the flash forward (with lse), dQ (with Δ) and dK/dV for head dims
above 256, the widest the tiled kernels (`flash_fwd.cu`, `flash_bwd.cu`)
are compiled for.

They replace, for 256 < D, `ray_tpu/ops/attention.py` `_flash_fwd_pallas`
and `_flash_bwd_pallas`, which take any head dim. The kernels are plain
FMA with f32 accumulation for both dtypes: correct for any D, not fast.
A block takes BLOCK_ROWS rows (q rows; keys for dK/dV), streams the head
dim through shared memory STREAM_COLS columns at a time for the logits, and
writes at most COL_CHUNK output columns: grid z is the column chunk, and
every chunk recomputes the logits and P for its columns.

The wrappers (`flash_fwd.flash_fwd`, `flash_bwd.flash_bwd_dq`,
`flash_bwd.flash_bwd_dkv`) take this route for D > 256 (the op pads D to a
multiple of STREAM_COLS) and count its launches as their own;
`flash_fwd.launches` and `flash_bwd.launches` hold a `WidePlan` per launch.
A call splits over heads as the tiled kernels' does (`flash_fwd.bh_chunks`:
grid y is the head, at most 65535 per launch). Its sequence needs no split:
grid x, the row tiles, takes 2^31 - 1, and no plan holds a tile table.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

BLOCK_ROWS = 32     # rows of one block (kRows in the source)
STREAM_COLS = 64    # head-dim columns per reduction chunk (kSC)
COL_CHUNK = 128     # output columns of one block, at most (kCC)
MIN_D = 257         # the narrowest head dim this route takes
KINDS = ("fwd", "dq", "dkv")


def takes(D: int) -> bool:
    """Whether the wide route takes head dim D (above 256, padded)."""
    return D >= MIN_D and D % STREAM_COLS == 0


def padded_head_dim(D: int) -> int:
    """D rounded up to whole stream chunks."""
    return -(-D // STREAM_COLS) * STREAM_COLS


def col_chunks(D: int) -> tuple:
    """[c0, c1) output column ranges, one per grid z, that cover D once."""
    return tuple((c, min(c + COL_CHUNK, D)) for c in range(0, D, COL_CHUNK))


@dataclass(frozen=True)
class WidePlan:
    kind: str           # "fwd", "dq" or "dkv"
    block_rows: int
    stream_cols: int
    col_chunk: int      # grid z = c covers output columns col_chunks(D)[c]
    grid: tuple         # (row tiles, B*H, column chunks)


@lru_cache(maxsize=256)
def plan(kind: str, BH: int, S: int, Skv: int, D: int) -> WidePlan:
    """One launch of the `kind` kernel over BH heads: forward and dQ tile the
    S q rows, dK/dV the Skv keys."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if not takes(D):
        raise ValueError(f"head_dim {D}: the wide route takes multiples of {STREAM_COLS} from {MIN_D}")
    rows = Skv if kind == "dkv" else S
    return WidePlan(kind=kind, block_rows=BLOCK_ROWS, stream_cols=STREAM_COLS, col_chunk=COL_CHUNK,
                    grid=(-(-rows // BLOCK_ROWS), BH, len(col_chunks(D))))


class LaunchPlan(ctypes.Structure):
    """What `rt_flash_wide_*` are handed: `WideLaunch` in the source, field
    for field."""

    _fields_ = [("block_rows", ctypes.c_int32), ("stream_cols", ctypes.c_int32),
                ("col_chunk", ctypes.c_int32), ("grid_x", ctypes.c_int32), ("grid_y", ctypes.c_int32),
                ("grid_z", ctypes.c_int32)]


def launch_plan(p: WidePlan) -> LaunchPlan:
    return LaunchPlan(p.block_rows, p.stream_cols, p.col_chunk, *p.grid)


@lru_cache(maxsize=None)
def check_plan_layout(lib) -> None:
    if lib.rt_flash_wide_plan_bytes() != ctypes.sizeof(LaunchPlan):
        raise RuntimeError("LaunchPlan does not match the kernel library's WideLaunch")

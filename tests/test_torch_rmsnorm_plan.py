"""The RMSNorm kernel's launch plan (`ray_tpu_torch/kernels/rmsnorm.py`
`plan`, `launch_plan`), checked on the CPU: the path each row layout takes,
shared memory, the persistent grid and the rows each CTA takes, the 16-byte
loads' alignment, and the packed struct the kernel is handed. `schedule`
and `vector_loads` below walk the rows and loads in the order
`csrc/rmsnorm.cu` takes them."""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from ray_tpu_torch.kernels import rmsnorm as rk

H100_SMS = 132
DEFAULT_SMEM = 48 * 1024  # dynamic shared memory a block gets without raising its limit
NAMED_BARRIERS = 15       # barrier ids 1..15: one for each row of a CTA that needs one
SRC = Path(rk.__file__).resolve().parent / "csrc" / "rmsnorm.cu"
BASE = 0x7F00_0000_0000  # a 16-byte (indeed 256-byte) aligned address, as an allocation gives
BF16, F32 = torch.bfloat16, torch.float32
MAIN_N = (1, 4, 8, 64, 256, 512, 2048, 16384)


def schedule(p, N: int):
    """(cta, row, slot) of every row: CTA c takes groups c, c + grid, ...;
    group g holds rows g*R .. g*R + R - 1 (those below N)."""
    R = p.rows_per_cta
    for c in range(p.grid):
        for grp in range(c, p.groups, p.grid):
            for slot in range(R):
                row = grp * R + slot
                if row < N:
                    yield c, row, slot


def vector_loads(p, N: int, x_ptr: int, row_stride_bytes: int):
    """(row, global address) of every 16-byte load of x on the regs path:
    thread t of a row's slot loads the row's vectors t + i*T, i < nv."""
    VR = p.row_bytes // rk.VEC
    for _, row, _ in schedule(p, N):
        for t in range(p.threads_per_row):
            for i in range(p.nv):
                if t + i * p.threads_per_row < VR:
                    yield row, x_ptr + row * row_stride_bytes + (t + i * p.threads_per_row) * rk.VEC


def _plan(N=512, D=4096, x=BF16, row_stride=None, x_off=0, w_off=0, sms=H100_SMS):
    """The plan for x [N, D] at BASE + x_off elements with `row_stride`
    elements between rows (D by default), y at BASE, the weight at BASE +
    w_off bf16 elements."""
    stride = D if row_stride is None else row_stride
    return rk.plan(N, D, x, stride, BASE + x_off * x.itemsize, BASE, sms, BASE + 2 * w_off)


@pytest.mark.parametrize("case,kw,path", [
    ("aligned bf16 rows", {}, "regs"),
    ("aligned f32 rows", dict(x=F32), "regs"),
    ("x offset by one element", dict(x_off=1), "scalar"),
    ("f32 x offset by one element", dict(x=F32, x_off=1), "scalar"),
    ("row stride not a multiple of 8", dict(row_stride=4100), "scalar"),
    ("row stride a multiple of 8", dict(row_stride=4104), "regs"),
    ("D not a multiple of the vector", dict(D=4097), "scalar"),
    ("D=100 bf16 (200-byte rows)", dict(D=100), "scalar"),
    ("D=100 f32 (400-byte rows)", dict(D=100, x=F32), "regs"),
    ("f32 row too wide for registers", dict(D=8192, x=F32), "vector"),
    ("bf16 row too wide for registers", dict(D=40000), "vector"),
])
def test_path_choice(case, kw, path):
    assert _plan(**kw).path == path, case


def test_misaligned_weight_is_read_by_elements():
    assert _plan().w_vec and not _plan(w_off=1).w_vec
    assert _plan(w_off=1).path == "regs"  # the row is still held in registers


def _shapes():
    return ([(N, 4096, x) for N in MAIN_N for x in (BF16, F32)]
            + [(N, D, BF16) for N in (3, 300, 5000) for D in (64, 768, 2048, 8192)]
            + [(7, 100, F32), (300, 4096 + 8, BF16)])


@pytest.mark.parametrize("N,D,x", _shapes())
def test_grid_covers_every_row_once(N, D, x):
    p = _plan(N, D, x)
    resident = rk.RESIDENT if p.path == "regs" else rk.ROWS_RESIDENT
    assert 1 <= p.grid <= H100_SMS * resident and p.grid <= p.groups == -(-N // p.rows_per_cta)
    rows = sorted(row for _, row, _ in schedule(p, N))
    assert rows == list(range(N))
    # each CTA's rows come in groups of R consecutive rows, one slot each
    for c, row, slot in schedule(p, N):
        assert (row // p.rows_per_cta) % p.grid == c and row % p.rows_per_cta == slot


@pytest.mark.parametrize("N,D,x", _shapes())
def test_shared_memory_fits(N, D, x):
    """Every path lays out only the double-buffered partial sums, within
    what a block gets without raising its limit (the launch does not)."""
    p = _plan(N, D, x)
    assert p.smem_bytes == rk.PARTIAL_BYTES <= DEFAULT_SMEM


@pytest.mark.parametrize("N,D,x", _shapes())
def test_threads_hold_the_whole_row(N, D, x):
    """A register-resident row: T threads (warps) x NV 16-byte vectors cover
    it, R rows of T threads fill at most MAX_CONSUMERS, and a row needing a
    barrier has a named barrier of its own."""
    p = _plan(N, D, x)
    if p.path != "regs":
        assert (p.threads_per_row, p.rows_per_cta, p.block_threads) == (rk.ROWS_THREADS, 1, rk.ROWS_THREADS)
        return
    T, R = p.threads_per_row, p.rows_per_cta
    assert T % 32 == 0 and p.nv in rk.NVS and T * p.nv >= D * x.itemsize // 16
    assert T * (p.nv - 1) < D * x.itemsize // 16 or p.nv == 1  # no narrower NV would do with this T
    assert R * T <= rk.MAX_CONSUMERS and (T == 32 or R <= NAMED_BARRIERS)
    assert p.block_threads == R * T


@pytest.mark.parametrize("N,D,x,row_stride", [
    (16384, 4096, BF16, 4096), (512, 4096, F32, 4096), (300, 768, BF16, 768),
    (7, 100, F32, 100), (64, 4096, BF16, 3 * 4096 + 8), (5000, 2048, F32, 2048)])
def test_vector_loads_are_16_byte_aligned(N, D, x, row_stride):
    """Every 16-byte load of the regs path starts on a 16-byte boundary, and
    a row's loads cover its bytes exactly once."""
    p = _plan(N, D, x, row_stride=row_stride)
    assert p.path == "regs"
    stride_bytes = row_stride * x.itemsize
    by_row = {}
    for row, addr in vector_loads(p, N, BASE, stride_bytes):
        assert addr % rk.VEC == 0
        by_row.setdefault(row, []).append(addr - BASE - row * stride_bytes)
    assert sorted(by_row) == list(range(N))
    for offsets in by_row.values():
        assert sorted(offsets) == list(range(0, D * x.itemsize, rk.VEC))


@pytest.mark.parametrize("N", [1, 4, 8])
def test_decode_rows_spread_over_ctas(N):
    """At decode (N <= 8) every row gets a CTA of its own, its 4096 bf16
    columns one 16-byte vector per thread: one DRAM round trip per row."""
    p = _plan(N)
    assert (p.grid, p.rows_per_cta, p.threads_per_row, p.nv) == (N, 1, 512, 1)


@pytest.mark.parametrize("N,T,R", [(2048, 256, 2), (16384, 256, 2), (512, 256, 2), (263, 256, 2), (262, 512, 1),
                                   (64, 512, 1)])
def test_rows_narrow_once_they_fill_the_card(N, T, R):
    """Once the row groups give every SM a CTA, rows take fewer threads (two
    vectors each) and a CTA reduces two of them at once."""
    p = _plan(N)
    assert (p.threads_per_row, p.rows_per_cta, p.grid) == (T, R, min(-(-N // R), H100_SMS * rk.RESIDENT))


def test_plan_refuses():
    with pytest.raises(ValueError, match="nothing"):
        _plan(N=0)


def _c_struct_fields(text: str, name: str) -> list:
    body = re.search(r"struct %s \{([^{}]*)\};" % name, text).group(1)
    decl = re.sub(r"//[^\n]*", "", body).strip().rstrip(";")
    typ, names = re.match(r"(int)\s+(.*)", decl, re.S).groups()
    return [n.strip() for n in names.split(",")]


def test_launch_plan_matches_the_c_struct():
    """LaunchPlan against RmsLaunch as `rmsnorm.cu` declares it, and the
    constants and launch bounds the kernels are compiled with."""
    text = SRC.read_text()
    fields = _c_struct_fields(text, "RmsLaunch")
    assert fields == [f for f, _ in rk.LaunchPlan._fields_]
    assert ctypes.sizeof(rk.LaunchPlan) == 4 * len(fields)
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    assert consts["kMaxConsumers"] == rk.MAX_CONSUMERS and consts["kRowsThreads"] == rk.ROWS_THREADS
    assert re.search(r"kPartialBytes = 2 \* kMaxWarps \* 4", text) and rk.PARTIAL_BYTES == 2 * 16 * 4
    assert "R > %d" % NAMED_BARRIERS in text  # the C side refuses a plan with too few named barriers
    enum = re.search(r"enum Path \{([^}]*)\}", text).group(1)
    assert [int(v) for v in re.findall(r"= (\d+)", enum)] == list(range(len(rk.PATHS)))
    assert re.findall(r"k(\w+) =", enum) == [p.capitalize() for p in rk.PATHS]
    bounds = re.findall(r"__launch_bounds__\((\w+), (\d+)\)", text)
    assert bounds == [("kMaxConsumers", str(rk.RESIDENT)), ("kRowsThreads", str(rk.ROWS_RESIDENT))]


@pytest.mark.parametrize("kw", [{}, dict(N=4), dict(x_off=1), dict(D=40000)])
def test_launch_plan_packs_what_the_kernel_runs_with(kw):
    p = _plan(**kw)
    lp = rk.launch_plan(p)
    assert rk.PATHS[lp.path] == p.path
    assert (lp.threads_per_row, lp.rows_per_cta, lp.nv, lp.smem_bytes, lp.grid, lp.block_threads, lp.w_vec) == (
        p.threads_per_row, p.rows_per_cta, p.nv, p.smem_bytes, p.grid, p.block_threads, int(p.w_vec))

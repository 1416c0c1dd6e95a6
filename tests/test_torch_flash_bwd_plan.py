"""The bf16 flash backward's launch plan (`ray_tpu_torch/kernels/flash_bwd.py`
`launches`, `tma_maps`, `launch_plan`), checked on the CPU: for the dQ kernel
and the dK/dV kernel, the stream tiles each work item and each consumer
warpgroup reads, the work items in launch order, shared memory, the TMA
maps, and the packed struct the kernels are handed."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_tpu_torch.kernels import flash_bwd as fb
from ray_tpu_torch.kernels import flash_fwd as ff

H100_SMS = 132


def _plan(kind, B, H, S, Skv, D, causal, sms):
    """The `kind` kernel's plan for a call that is one launch of it."""
    lns = fb.launches(kind, B, H, S, Skv, D, causal, sms)
    assert len(lns) == 1 and (lns[0].b0, lns[0].b1, lns[0].h0, lns[0].h1) == (0, B, 0, H)
    return lns[0].plan
SRC = Path(fb.__file__).resolve().parent / "csrc"
SHAPES = [(1, 1), (1, 300), (127, 128), (129, 129), (200, 1000), (300, 1000), (257, 300), (64, 192),
          (1024, 1024)]


def _visible(S, Skv, causal):
    """[S, Skv] bool: query i sees key j (end-aligned causal)."""
    if not causal:
        return np.ones((S, Skv), bool)
    return np.arange(S)[:, None] + (Skv - S) >= np.arange(Skv)[None, :]


def _tiles_with_pairs(vis, rows, keys, axis_len, block, by_rows):
    """Sorted indices of the stream tiles (blocks of `block` along the keys
    when by_rows, else along the q rows, from 0) that hold a visible pair
    of a real row in `rows` and a real key in `keys`."""
    S, Skv = vis.shape
    r = [i for i in rows if 0 <= i < S]
    k = [j for j in keys if 0 <= j < Skv]
    if not r or not k:
        return []
    sub = vis[np.ix_(r, k)]
    idx = np.array(k)[sub.any(axis=0)] if by_rows else np.array(r)[sub.any(axis=1)]
    return sorted({int(i) // block for i in idx})


@pytest.mark.parametrize("D", ff.HEAD_DIMS)
@pytest.mark.parametrize("S,Skv", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_dq_key_tiles_match_brute_force(D, S, Skv, causal):
    """Each q tile streams the key tiles up to the last one its real rows
    see, and each warpgroup reads the prefix of them its own rows see."""
    p = _plan("dq", 1, 2, S, Skv, D, causal, H100_SMS)
    vis = _visible(S, Skv, causal)
    bq, bk = p.block_rows, p.block_stream
    assert bq == ff.WG_ROWS * p.warpgroups and len(p.tiles) == -(-S // bq)
    assert sorted(t.r0 for t in p.tiles) == [S - (j + 1) * bq for j in reversed(range(len(p.tiles)))]
    for t in p.tiles:
        seen = _tiles_with_pairs(vis, range(t.r0, t.r0 + bq), range(Skv), Skv, bk, True)
        assert (t.lo, t.hi) == (0, seen[-1] + 1)  # every real row sees key 0: a prefix
        assert len(t.wg_lo) == len(t.wg_hi) == p.warpgroups
        for c in range(p.warpgroups):
            r0 = t.r0 + ff.WG_ROWS * c
            mine = _tiles_with_pairs(vis, range(r0, r0 + ff.WG_ROWS), range(Skv), Skv, bk, True)
            assert (t.wg_lo[c], t.wg_hi[c]) == ((0, mine[-1] + 1) if mine else (0, 0))


@pytest.mark.parametrize("D", ff.HEAD_DIMS)
@pytest.mark.parametrize("S,Skv", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_dkv_q_tiles_match_brute_force(D, S, Skv, causal):
    """Each key tile streams the q tiles from the first with a row that sees
    one of its keys to the end, and each warpgroup reads those from the
    first that reaches its own keys (ragged tiles and Skv > S included)."""
    p = _plan("dkv", 1, 2, S, Skv, D, causal, H100_SMS)
    vis = _visible(S, Skv, causal)
    bkv, bq, nq = p.block_rows, p.block_stream, -(-S // p.block_stream)
    assert bkv == 2 * ff.WG_ROWS and sorted(t.r0 for t in p.tiles) == list(range(0, Skv, bkv))
    for t in p.tiles:
        seen = _tiles_with_pairs(vis, range(S), range(t.r0, t.r0 + bkv), S, bq, False)
        assert seen == list(range(seen[0], nq))  # a suffix: later rows see more keys
        assert (t.lo, t.hi) == (seen[0], nq)
        for c in range(2):
            k0 = t.r0 + ff.WG_ROWS * c
            mine = _tiles_with_pairs(vis, range(S), range(k0, k0 + ff.WG_ROWS), S, bq, False)
            assert (t.wg_lo[c], t.wg_hi[c]) == ((mine[0], nq) if mine else (0, 0))
            assert not mine or t.lo <= t.wg_lo[c]


@pytest.mark.parametrize("kind", ["dq", "dkv"])
@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("S,Skv,causal", [(1024, 1024, True), (300, 1000, True), (257, 257, False)])
def test_items_heaviest_first_and_each_once(kind, D, S, Skv, causal):
    """Work items in launch order: every (tile, head, column split) once,
    the tiles with the most stream tiles first (late q tiles for dQ, early
    key tiles for dK/dV), so the last wave is not one heavy item."""
    B, H = 3, 5
    p = _plan(kind, B, H, S, Skv, D, causal, H100_SMS)
    units = p.BH * p.splits
    assert p.BH == B * H and p.n_items == len(p.tiles) * units
    assert p.splits == (2 if kind == "dkv" and D == 256 else 1)
    order = [(p.tiles[i // units].r0, (i % units) // p.splits, i % p.splits) for i in range(p.n_items)]
    assert len(set(order)) == p.n_items
    work = [p.tiles[i // units].hi - p.tiles[i // units].lo for i in range(p.n_items)]
    assert work == sorted(work, reverse=True)
    if causal and S == Skv == 1024:
        r0s = [t.r0 for t in p.tiles]
        assert r0s == (sorted(r0s, reverse=True) if kind == "dq" else sorted(r0s))


@pytest.mark.parametrize("B,H,S,grid", [(13, 20, 1024, 132), (1, 1, 100, 1), (1, 2, 300, 6)])
def test_persistent_grid(B, H, S, grid):
    dq, dkv = (_plan(kind, B, H, S, S, 64, True, H100_SMS) for kind in ("dq", "dkv"))
    assert dq.grid == min(dq.n_items, H100_SMS) == grid
    assert dkv.grid == min(dkv.n_items, H100_SMS)


@pytest.mark.parametrize("kind", ["dq", "dkv"])
@pytest.mark.parametrize("D", ff.HEAD_DIMS)
def test_shared_memory_fits(kind, D):
    p = _plan(kind, 2, 4, 512, 512, D, True, H100_SMS)
    assert p.smem_bytes == fb.smem_bytes(kind, D, p.stages) <= ff.SMEM_LIMIT == 232_448
    assert 2 <= p.stages <= fb.MAX_STAGES
    assert p.stages == fb.MAX_STAGES or fb.smem_bytes(kind, D, p.stages + 1) > ff.SMEM_LIMIT
    # every tile a 1024-byte multiple, so that each lands on the swizzle atom
    rows = (p.block_rows, p.block_stream, ff.WG_ROWS)
    assert all((r * D * 2) % 1024 == 0 for r in rows)
    # the item's tiles, two stages and (D <= 128) the staged gradients at least
    item = (3 if kind == "dq" else 2) * p.block_rows * D * 2
    staged = (1 if kind == "dq" else 2) * p.block_rows * D * 2 if fb.staged_out(D) else 0
    assert p.smem_bytes >= item + staged + 2 * 2 * p.block_stream * D * 2
    assert fb.staged_out(D) == (D <= 128)


def test_head_dim_shapes():
    """The tile shapes the kernels are compiled for (DqCfg, DkvCfg)."""
    shapes = {D: (fb.dq_warpgroups(D), fb.dq_block_k(D), fb.dkv_block_q(D), fb.dkv_splits(D))
              for D in ff.HEAD_DIMS}
    assert shapes == {32: (2, 64, 64, 1), 64: (2, 64, 64, 1), 128: (2, 64, 32, 1), 256: (1, 32, 32, 2)}


@pytest.mark.parametrize("D", ff.HEAD_DIMS)
def test_tma_maps_read_strided_do_in_place(D):
    """dO as autograd hands it over ([B, S, H, D] seen as [B, H, S, D]) is
    read through its own strides; every box fits its swizzle."""
    B, H, S, Skv = 2, 4, 96, 160
    do = torch.zeros(B, S, H, D, dtype=torch.bfloat16).transpose(1, 2)
    assert not do.is_contiguous() and ff._kernel_view(do) is do
    q, o = torch.zeros(B, H, S, D, dtype=torch.bfloat16), torch.zeros(B, H, S, D, dtype=torch.bfloat16)
    k = v = torch.zeros(B, H, Skv, D, dtype=torch.bfloat16)
    dq, dkv = (_plan(kind, B, H, S, Skv, D, True, H100_SMS) for kind in ("dq", "dkv"))
    dq_maps = fb.tma_maps(dq, q, do, o, k, v, q)
    dkv_maps = fb.tma_maps(dkv, q, do, k, v, k, v)
    seq_major = (H * D * 2, D * 2, S * H * D * 2)
    assert dq_maps[1].strides == dkv_maps[1].strides == seq_major
    assert dq_maps[0].strides == (D * 2, S * D * 2, H * S * D * 2)
    assert [m.box[1] for m in dq_maps] == [dq.block_rows] * 3 + [dq.block_stream] * 2 + [64]
    assert [m.box[1] for m in dkv_maps] == [dkv.block_stream] * 2 + [dkv.block_rows] * 2 + [64] * 2
    assert [m.dims[1] for m in dq_maps] == [S, S, S, Skv, Skv, S]
    assert [m.dims[1] for m in dkv_maps] == [S, S, Skv, Skv, Skv, Skv]
    for m in dq_maps + dkv_maps:
        assert m.box[0] * 2 == dq.swizzle == dkv.swizzle == ff.swizzle_bytes(D) and D % m.box[0] == 0
        assert m.dims[0] == D and m.dims[2:] == (H, B) and all(s % 16 == 0 for s in m.strides)


def _c_structs(text: str) -> dict:
    """name -> list of (type, name, count) of the plain structs in a C++ source."""
    out = {}
    for name, body in re.findall(r"struct (\w+) \{([^{}]*)\};", text):
        fields = []
        for decl in re.sub(r"//[^\n]*", "", body).split(";"):
            decl = decl.strip()
            if not decl or "(" in decl or "*" in decl or "static" in decl:
                continue
            typ, rest = re.match(r"((?:unsigned )?(?:long long|short|int|\w+))\s+(.*)", decl).groups()
            for d in rest.split(","):
                m = re.match(r"\s*(\w+)(?:\[(\w+)\])?", d)
                fields.append((typ, m.group(1), m.group(2)))
        out[name] = fields
    return out


def _c_sizeof(structs: dict, consts: dict, name: str) -> tuple:
    """(size, alignment) of struct `name` under the x86-64 / CUDA rules."""
    prim = {"int": 4, "unsigned int": 4, "unsigned short": 2, "unsigned long long": 8}
    off, align = 0, 1
    for typ, _, count in structs[name]:
        size, a = (prim[typ], prim[typ]) if typ in prim else _c_sizeof(structs, consts, typ)
        n = 1 if count is None else int(consts.get(count, count))
        off = -(-off // a) * a + size * n
        align = max(align, a)
    return -(-off // align) * align, align


def test_launch_plan_matches_the_c_struct():
    """LaunchPlan against BwdLaunch as `flash_bwd.cu` declares it (with
    TmaSpec from `hopper_common.cuh`): the same size, and the table and
    ring bounds the kernels are compiled with."""
    text = (SRC / "hopper_common.cuh").read_text() + (SRC / "flash_bwd.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert int(consts["kMaxTiles"]) == fb.MAX_TILES and int(consts["kMaxStages"]) == fb.MAX_STAGES
    size, _ = _c_sizeof(_c_structs(text), consts, "BwdLaunch")
    assert size == ctypes.sizeof(fb.LaunchPlan) == 10 * 4 + 6 * 64 + fb.MAX_TILES * 16
    assert fb.LaunchPlan.maps.offset == 40 and fb.LaunchPlan.tiles.offset == 40 + 6 * 64


@pytest.mark.parametrize("kind", ["dq", "dkv"])
@pytest.mark.parametrize("D", ff.HEAD_DIMS)
def test_launch_plan_packs_what_the_kernel_runs_with(kind, D):
    B, H, S, Skv = 2, 3, 300, 700
    q = torch.zeros(B, H, S, D, dtype=torch.bfloat16)
    do = torch.zeros(B, S, H, D, dtype=torch.bfloat16).transpose(1, 2)
    k = v = torch.zeros(B, H, Skv, D, dtype=torch.bfloat16)
    p = _plan(kind, B, H, S, Skv, D, True, H100_SMS)
    tensors = (q, do, q, k, v, q) if kind == "dq" else (q, do, k, v, k, v)
    lp = fb.launch_plan(p, *tensors)
    assert (lp.block_rows, lp.block_stream, lp.swizzle, lp.stages, lp.smem_bytes, lp.grid, lp.n_items, lp.BH,
            lp.splits, lp.warpgroups) == (p.block_rows, p.block_stream, p.swizzle, p.stages, p.smem_bytes,
                                          p.grid, p.n_items, B * H, p.splits, p.warpgroups)
    for spec, m in zip(lp.maps, fb.tma_maps(p, *tensors)):
        assert (tuple(spec.dims), tuple(spec.strides), tuple(spec.box)) == (m.dims, m.strides, m.box)
    for slot, t in zip(lp.tiles, p.tiles):
        assert (slot.r0, slot.lo, slot.hi) == (t.r0, t.lo, t.hi)
        assert tuple(slot.wg_lo)[:len(t.wg_lo)] == t.wg_lo and tuple(slot.wg_hi)[:len(t.wg_hi)] == t.wg_hi
    assert all(slot.hi == 0 for slot in lp.tiles[len(p.tiles):])


@pytest.mark.parametrize("kind", ["dq", "dkv"])
def test_plan_refuses_unknown_head_dim(kind):
    with pytest.raises(ValueError, match="head_dim"):
        fb.launches(kind, 1, 1, 8, 8, 96, True, H100_SMS)


def test_plan_refuses_more_tiles_than_the_kernel_table():
    """One launch holds at most the kernel's table of outer tiles; a call
    past it is split into launches that each stay within it."""
    S = 2 * ff.WG_ROWS * fb.MAX_TILES  # 128 q tiles (dQ) and 128 key tiles (dK/dV) per head
    for kind in ("dq", "dkv"):
        assert len(_plan(kind, 1, 1, S, S, 64, True, H100_SMS).tiles) == fb.MAX_TILES
        lns = fb.launches(kind, 1, 1, S + 1, S + 1, 64, True, H100_SMS)
        assert [len(ln.plan.tiles) for ln in lns] == [fb.MAX_TILES, 1]

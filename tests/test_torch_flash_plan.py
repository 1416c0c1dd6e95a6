"""The bf16 flash forward's launch plan (`ray_tpu_torch/kernels/flash_fwd.py`
`launches`, `tma_maps`, `launch_plan`, `_kernel_view`), checked on the CPU: the
stages, shared memory, grid, q tiles in launch order with their key-tile
counts, and TMA maps that the kernel is handed and runs with as given."""

import ctypes

import pytest
import torch

from ray_tpu_torch.kernels import build
from ray_tpu_torch.kernels import flash_fwd as ff

H100_SMS = 132


def _plan(B, H, S, Skv, D, causal, sms):
    """The plan of a call that is one launch."""
    lns = ff.launches(B, H, S, Skv, D, causal, sms)
    assert len(lns) == 1 and (lns[0].b0, lns[0].b1, lns[0].h0, lns[0].h1) == (0, B, 0, H)
    return lns[0].plan


@pytest.mark.parametrize("D", ff.HEAD_DIMS)
def test_shared_memory_fits(D):
    p = _plan(4, 32, 512, 512, D, True, H100_SMS)
    assert p.smem_bytes <= ff.SMEM_LIMIT == 232_448
    assert 2 <= p.stages <= ff.MAX_STAGES
    assert p.smem_bytes == ff.smem_bytes(D, p.stages)
    # the deepest ring that fits: one more stage would not
    assert p.stages == ff.MAX_STAGES or ff.smem_bytes(D, p.stages + 1) > ff.SMEM_LIMIT
    # Q (and O where it is staged) plus two stages of K and V at least, and
    # the tiles are 1024-byte multiples
    staged = p.block_q * D * 2 if ff.stages_o(D) else 0
    assert p.smem_bytes >= (p.block_q + 4 * p.block_k) * D * 2 + staged
    assert p.block_q == ff.block_q(D) and p.block_q % 64 == 0
    assert ff.stages_o(D) == (D <= 128)
    assert (p.block_q * D * 2) % 1024 == 0 and (p.block_k * D * 2) % 1024 == 0


@pytest.mark.parametrize("D", ff.HEAD_DIMS)
def test_tma_box_within_the_swizzle(D):
    p = _plan(2, 4, 300, 300, D, False, H100_SMS)
    x = torch.zeros(2, 4, 300, D, dtype=torch.bfloat16)
    maps = ff.tma_maps(p, x, x, x, x)
    for m, rows in zip(maps, (p.block_q, p.block_k, p.block_k, 64)):
        inner_bytes = m.box[0] * 2
        assert inner_bytes <= p.swizzle and inner_bytes % 16 == 0
        assert D % m.box[0] == 0                    # whole boxes across the head dim
        assert m.box == (p.box_cols, rows) and all(b <= 256 for b in m.box)
        assert m.dims == (D, 300, 4, 2)
    assert p.swizzle == (64 if D == 32 else 128)


def _layouts(D):
    B, H, S = 2, 4, 96
    qkv = torch.zeros(B, S, 3, H, D, dtype=torch.bfloat16)
    return {
        "contiguous": torch.zeros(B, H, S, D, dtype=torch.bfloat16),
        "qkv view": qkv[:, :, 2].transpose(1, 2),
        "seq-major": torch.zeros(B, S, H, D, dtype=torch.bfloat16).transpose(1, 2),
    }


@pytest.mark.parametrize("D", ff.HEAD_DIMS)
@pytest.mark.parametrize("layout", ["contiguous", "qkv view", "seq-major"])
def test_strides_and_bases_16_byte_aligned(D, layout):
    x = ff._kernel_view(_layouts(D)[layout])
    assert x.data_ptr() % 16 == 0
    assert all(s % 16 == 0 for s in ff.byte_strides(x))
    p = _plan(2, 4, 96, 96, D, True, H100_SMS)
    o = torch.empty(2, 4, 96, D, dtype=torch.bfloat16)
    assert all(s % 16 == 0 for m in ff.tma_maps(p, x, x, x, o) for s in m.strides)


def test_generate_layout_read_in_place():
    """v as the generate path hands it over: a strided view of the qkv
    projection [B, S, 3, H, D]; TMA reads it through its strides."""
    B, S, H, D = 4, 128, 32, 128
    qkv = torch.zeros(B, S, 3, H, D, dtype=torch.bfloat16)
    v = qkv[:, :, 2].transpose(1, 2)
    assert not v.is_contiguous()
    assert ff._kernel_view(v) is v
    p = _plan(B, H, S, S, D, True, H100_SMS)
    mv = ff.tma_maps(p, v, v, v, v)[2]
    # (seq, head, batch) byte strides: a row of the projection, one head, one batch
    assert mv.strides == (3 * H * D * 2, D * 2, S * 3 * H * D * 2)
    assert mv.box == (64, p.block_k)


@pytest.mark.parametrize("case", ["offset base", "odd row stride"])
def test_misaligned_view_is_copied(case):
    D = 64
    if case == "offset base":  # 2 bytes past an aligned allocation
        x = torch.zeros(1 + 2 * 4 * 10 * D, dtype=torch.bfloat16)[1:].view(2, 4, 10, D)
    else:                      # rows of D + 1 elements: the seq stride is 130 bytes
        x = torch.zeros(2, 4, 10, D + 1, dtype=torch.bfloat16)[..., :D]
    assert not ff._readable_in_place(x)
    y = ff._kernel_view(x)
    assert y is not x and y.is_contiguous() and torch.equal(y, x)
    assert y.data_ptr() % 16 == 0 and all(s % 16 == 0 for s in ff.byte_strides(y))


def _brute_force_kv_tiles(r0, r1, S, Skv, causal, bk):
    """Key tiles holding at least one (query, key) pair that a real query
    row in [r0, r1) sees (end-aligned causal); 0 without a real row."""
    seen = [j for j in range(Skv)
            if any(not causal or j <= i + Skv - S for i in range(max(r0, 0), min(r1, S)))]
    return max(seen) // bk + 1 if seen else 0


@pytest.mark.parametrize("S,bq", [(1, 128), (128, 128), (129, 128), (1024, 192), (1000, 192)])
def test_q_tiles_end_at_the_sequence_end(S, bq):
    D = 128 if bq == 128 else 64  # the head dims with block_q = bq
    assert ff.block_q(D) == bq
    starts = sorted(t.q0 for t in ff.q_tiles(S, S, True, D))
    assert starts[-1] + bq == S and all(b - a == bq for a, b in zip(starts, starts[1:]))
    assert -bq < starts[0] <= 0  # only the first tile is ragged: rows before 0 are padding


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,Skv", [(1, 1), (1, 300), (127, 128), (129, 129), (200, 1000),
                                   (300, 1000), (257, 300), (64, 192), (1024, 1024)])
@pytest.mark.parametrize("causal", [True, False])
def test_kv_tile_counts_match_brute_force(D, S, Skv, causal):
    """The key tiles the producer streams for each q tile and each consumer
    warpgroup reads, against a brute-force count of the pairs they see."""
    p = _plan(1, 2, S, Skv, D, causal, H100_SMS)
    assert len(p.tiles) == -(-S // p.block_q) and p.n_items == 2 * len(p.tiles)
    for t in p.tiles:
        assert t.n_kv == _brute_force_kv_tiles(t.q0, t.q0 + p.block_q, S, Skv, causal, p.block_k)
        assert len(t.n_kv_wg) == ff.consumer_warpgroups(D)
        for c, n in enumerate(t.n_kv_wg):
            r0 = t.q0 + ff.WG_ROWS * c
            assert n == _brute_force_kv_tiles(r0, r0 + ff.WG_ROWS, S, Skv, causal, p.block_k)


@pytest.mark.parametrize("S,Skv,causal", [(512, 512, True), (300, 1000, True), (257, 257, False)])
def test_items_heaviest_first_and_each_once(S, Skv, causal):
    B, H = 3, 5
    p = _plan(B, H, S, Skv, 128, causal, H100_SMS)
    # item i is q tile i // BH of head i % BH
    order = [(p.tiles[i // p.BH].q0, i % p.BH) for i in range(p.n_items)]
    assert p.BH == B * H and len(order) == p.n_items == len(p.tiles) * B * H
    starts = {S - (j + 1) * p.block_q for j in range(len(p.tiles))}
    assert sorted(order) == sorted((q0, bh) for q0 in starts for bh in range(B * H))
    work = [p.tiles[i // p.BH].n_kv for i in range(p.n_items)]
    assert work == sorted(work, reverse=True)  # longest processing time first


@pytest.mark.parametrize("B,H,S,sms,grid", [(4, 32, 512, 132, 132), (1, 1, 100, 132, 1),
                                            (1, 2, 300, 132, 6), (13, 20, 1024, 132, 132)])
def test_persistent_grid(B, H, S, sms, grid):
    p = _plan(B, H, S, S, 128, True, sms)
    assert p.grid == grid == min(p.n_items, sms)


def test_plan_refuses_unknown_head_dim():
    with pytest.raises(ValueError, match="head_dim"):
        ff.launches(1, 1, 8, 8, 96, True, H100_SMS)


def test_plan_refuses_more_q_tiles_than_the_kernel_table():
    """One launch holds at most the kernel's table of q tiles; a call past
    it is split into launches that each stay within it."""
    S = ff.block_q(128) * ff.MAX_Q_TILES
    assert len(_plan(1, 1, S, S, 128, True, H100_SMS).tiles) == ff.MAX_Q_TILES
    lns = ff.launches(1, 1, S + 1, S + 1, 128, True, H100_SMS)
    assert [len(ln.plan.tiles) for ln in lns] == [ff.MAX_Q_TILES, 1]


@pytest.mark.parametrize("D", ff.HEAD_DIMS)
def test_launch_plan_packs_what_the_kernel_runs_with(D):
    """The bytes `rt_flash_fwd` reads (FwdLaunch) hold the plan and the tensor
    maps field for field, with the layout of the C struct."""
    B, H, S, Skv = 2, 3, 300, 700
    q = torch.zeros(B, H, S, D, dtype=torch.bfloat16)
    kv = torch.zeros(B, Skv, 2, H, D, dtype=torch.bfloat16)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    p = _plan(B, H, S, Skv, D, True, H100_SMS)
    lp = ff.launch_plan(p, q, k, v, q)
    # 8 ints, 4 x (4 + 3 u64 + 2 u32), MAX_Q_TILES x (i32 + 4 u16), no padding
    assert ctypes.sizeof(lp) == 8 * 4 + 4 * 64 + ff.MAX_Q_TILES * 12
    assert ff.LaunchPlan.maps.offset == 32 and ff.LaunchPlan.tiles.offset == 32 + 4 * 64
    assert (lp.block_q, lp.block_k, lp.swizzle, lp.stages, lp.smem_bytes, lp.grid, lp.n_items, lp.BH) == (
        p.block_q, p.block_k, p.swizzle, p.stages, p.smem_bytes, p.grid, p.n_items, B * H)
    for spec, m in zip(lp.maps, ff.tma_maps(p, q, k, v, q)):
        assert (tuple(spec.dims), tuple(spec.strides), tuple(spec.box)) == (m.dims, m.strides, m.box)
    assert tuple(lp.maps[1].strides) == (2 * H * D * 2, D * 2, Skv * 2 * H * D * 2)
    for slot, t in zip(lp.tiles, p.tiles):
        assert (slot.q0, slot.n_kv) == (t.q0, t.n_kv)
        assert tuple(slot.n_kv_wg)[:len(t.n_kv_wg)] == t.n_kv_wg
    assert all(slot.n_kv == 0 for slot in lp.tiles[len(p.tiles):])


def test_build_digest_covers_every_source_and_header(tmp_path, monkeypatch):
    """Editing a header (not only a .cu) must trigger a rebuild."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build._digest()
    assert {"hopper_common.cuh", "flash_common.cuh"} <= {f.name for f in csrc.iterdir()}
    header = csrc / "hopper_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build._digest() != before

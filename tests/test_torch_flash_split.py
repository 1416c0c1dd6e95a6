"""How one flash call splits into kernel launches (`flash_fwd.launches`,
`flash_bwd.launches`), checked on the CPU: at sequences just below, at and
past each tile table and at B*H past the grid limit, the launches cover
every (head, outer tile) exactly once, each within the kernel's limits;
and the zero-padding of head dims the kernels are not compiled for is
exact (checked on the plain versions)."""

import math

import pytest
import torch

from ray_tpu_torch.kernels import flash_bwd as fb
from ray_tpu_torch.kernels import flash_fwd as ff
from ray_tpu_torch.ops import flash_attention_bwd_plain, flash_attention_plain

H100_SMS = 132


def _covered(lns, B, H, first_row):
    """(b*H + h, first row of the tile) for every item of every launch,
    checking each launch against what its kernel accepts."""
    seen = []
    for ln in lns:
        assert 0 <= ln.b0 < ln.b1 <= B and 0 <= ln.h0 < ln.h1 <= H
        assert ln.b1 - ln.b0 == 1 or (ln.h0, ln.h1) == (0, H), "heads must be a contiguous range"
        BH = (ln.b1 - ln.b0) * (ln.h1 - ln.h0)
        assert BH <= ff.MAX_BH
        if ln.plan is None:
            seen += [(b * H + h, None) for b in range(ln.b0, ln.b1) for h in range(ln.h0, ln.h1)]
            continue
        p = ln.plan
        splits = getattr(p, "splits", 1)
        assert p.BH == BH and p.n_items == len(p.tiles) * BH * splits
        assert 1 <= p.grid <= min(p.n_items, H100_SMS)
        seen += [(b * H + h, first_row(t)) for b in range(ln.b0, ln.b1) for h in range(ln.h0, ln.h1)
                 for t in p.tiles]
    return seen


def _assert_once(seen, want):
    assert len(seen) == len(set(seen)), "an item is covered twice"
    assert set(seen) == want


FWD_CAPS = [(D, ff.block_q(D) * ff.MAX_Q_TILES) for D in (64, 128)]


@pytest.mark.parametrize("D,cap_rows", FWD_CAPS)
@pytest.mark.parametrize("tiles", [-1, 0, 1])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_launches_cover_every_q_tile_once(D, cap_rows, tiles, causal):
    S = cap_rows + tiles * ff.block_q(D)
    B, H = 2, 3
    lns = ff.launches(B, H, S, S, D, causal, H100_SMS)
    assert len(lns) == (2 if tiles > 0 else 1)
    assert all(len(ln.plan.tiles) <= ff.MAX_Q_TILES for ln in lns)
    all_tiles = ff.q_tiles(S, S, causal, D)
    _assert_once(_covered(lns, B, H, lambda t: t.q0), {(bh, t.q0) for bh in range(B * H) for t in all_tiles})
    # The heaviest tiles go first, across launches as within one.
    order = [t.n_kv for ln in lns for t in ln.plan.tiles]
    assert order == sorted(order, reverse=True)
    if tiles <= 0:  # within the table: the one launch is the whole plan
        assert len(lns[0].plan.tiles) == len(all_tiles) and lns[0].plan.BH == B * H


def test_forward_launch_just_past_the_cap_takes_the_ragged_tile():
    S = ff.block_q(128) * ff.MAX_Q_TILES + 1
    lns = ff.launches(1, 1, S, S, 128, True, H100_SMS)
    assert [len(ln.plan.tiles) for ln in lns] == [ff.MAX_Q_TILES, 1]
    assert lns[1].plan.tiles[0].q0 == 1 - ff.block_q(128)  # the first, lightest, ragged tile


BWD_CAPS = [(D, kind) for D in (64, 128, 256) for kind in ("dq", "dkv")]


def _bwd_rows(kind, D):
    return ff.WG_ROWS * fb.dq_warpgroups(D) if kind == "dq" else 2 * ff.WG_ROWS


@pytest.mark.parametrize("D,kind", BWD_CAPS)
@pytest.mark.parametrize("tiles", [-1, 0, 1])
def test_backward_launches_cover_every_outer_tile_once(D, kind, tiles):
    S = _bwd_rows(kind, D) * (fb.MAX_TILES + tiles)
    B, H = 1, 2
    lns = fb.launches(kind, B, H, S, S, D, True, H100_SMS)
    assert len(lns) == (2 if tiles > 0 else 1)
    assert all(len(ln.plan.tiles) <= fb.MAX_TILES and ln.plan.kind == kind for ln in lns)
    all_tiles = fb.dq_tiles(S, S, True, D) if kind == "dq" else fb.dkv_tiles(S, S, True, D)
    _assert_once(_covered(lns, B, H, lambda t: t.r0), {(bh, t.r0) for bh in range(B * H) for t in all_tiles})
    if tiles <= 0:  # within the table: the one launch is the whole plan
        assert len(lns[0].plan.tiles) == len(all_tiles) and lns[0].plan.BH == B * H


@pytest.mark.parametrize("B,H", [(1, 65536), (2, 32768), (65536, 1), (4, 16384), (3, 30000),
                                 (1, 65535), (1, 131071)])
@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("bf16", [True, False])
def test_launches_cover_every_head_once_past_the_grid_limit(B, H, kind, bf16):
    S, D = 200, 64
    if kind == "fwd":
        lns = ff.launches(B, H, S, S, D, True, H100_SMS, bf16)
        tiles, first = ff.q_tiles(S, S, True, D), (lambda t: t.q0)
    else:
        lns = fb.launches(kind, B, H, S, S, D, True, H100_SMS, bf16)
        tiles = fb.dq_tiles(S, S, True, D) if kind == "dq" else fb.dkv_tiles(S, S, True, D)
        first = lambda t: t.r0  # noqa: E731
    assert len(lns) == math.ceil(B * H / ff.MAX_BH)
    want = {(bh, first(t) if bf16 else None) for bh in range(B * H) for t in (tiles if bf16 else [None])}
    _assert_once(_covered(lns, B, H, first), want)


@pytest.mark.parametrize("B,H", [(1, 65536), (2, 32768), (65536, 1), (3, 30000)])
def test_launch_views_are_its_heads(B, H):
    """`heads` of [B, H, ...] and `rows` of [B*H, ...] name the same heads,
    and the rows are one contiguous block (the kernels take lse, Δ and the
    outputs as contiguous from the view's first head)."""
    x = torch.arange(B * H).reshape(B, H)
    for ln in ff.launches(B, H, 8, 8, 32, True, H100_SMS):
        heads = ln.heads(x)
        assert heads.flatten().tolist() == ln.rows(x.reshape(B * H), H).tolist()
        assert heads.is_contiguous()


@pytest.mark.parametrize("D,Dp", [(16, 32), (80, 128), (96, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_zero_padding_the_head_dim_is_exact(D, Dp, causal):
    """What the op relies on to run a head dim the kernels lack: with the
    scale fixed from the true D, zero columns change neither the output's
    first D columns, nor lse, nor the first D columns of dq, dk and dv; the
    padded columns of the output and the gradients are zero."""
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(2, 3, 33, D, generator=g) for _ in range(4))
    pad = lambda x: torch.nn.functional.pad(x, (0, Dp - D))  # noqa: E731
    scale = D ** -0.5
    o, lse = flash_attention_plain(q, k, v, causal, scale, return_lse=True)
    op, lsep = flash_attention_plain(pad(q), pad(k), pad(v), causal, scale, return_lse=True)
    torch.testing.assert_close(op[..., :D], o, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lsep, lse, atol=1e-6, rtol=1e-6)
    assert not op[..., D:].any()
    grads = flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    gradsp = flash_attention_bwd_plain(pad(q), pad(k), pad(v), op, lsep, pad(do), causal, scale)
    for a, b in zip(gradsp, grads):
        torch.testing.assert_close(a[..., :D], b, atol=1e-5, rtol=1e-5)
        assert not a[..., D:].any()

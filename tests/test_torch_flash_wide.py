"""The wide-head route of the flash kernels (head dims above 256), checked on
the CPU: its launch plan (`kernels.flash_wide`, the plan `flash_fwd.launches`
and `flash_bwd.launches` hold above D = 256) covers every output column and
every (head, row tile) once, is chosen only above 256, and composes with the
head split of the tiled kernels; the plan's C struct and tile constants
agree with `csrc/flash_wide.cu`; and the attention op at D = 320 (which on
the card pads to a wide head) matches the JAX reference's `flash_attention`
and its Pallas kernels in interpret mode, forward and gradient.

The kernels themselves run only on a card: `tests/test_torch_kernels.py`
`test_flash_wide_route_matches_plain` (`cuda`)."""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as j_flash_attention
from ray_tpu.ops.attention import _flash_bwd_pallas, _flash_fwd_pallas
from ray_tpu_torch.kernels import flash_bwd as fb
from ray_tpu_torch.kernels import flash_fwd as ff
from ray_tpu_torch.kernels import flash_wide as fw
from ray_tpu_torch.ops import flash_attention, flash_attention_with_stats
from ray_tpu_torch.ops.attention import padded_head_dim

H100_SMS = 132
SOURCE = Path(fw.__file__).resolve().parent / "csrc" / "flash_wide.cu"
WIDE = (320, 384, 512, 1024, 1088)


def _launches(kind, B, H, S, Skv, D, bf16=True):
    if kind == "fwd":
        return ff.launches(B, H, S, Skv, D, True, H100_SMS, bf16)
    return fb.launches(kind, B, H, S, Skv, D, True, H100_SMS, bf16)


@pytest.mark.parametrize("D", WIDE)
def test_column_chunks_cover_each_output_column_once(D):
    cols = [c for c0, c1 in fw.col_chunks(D) for c in range(c0, c1)]
    assert cols == list(range(D))
    widths = [c1 - c0 for c0, c1 in fw.col_chunks(D)]
    assert all(0 < w <= fw.COL_CHUNK and w % fw.STREAM_COLS == 0 for w in widths)


@pytest.mark.parametrize("kind", fw.KINDS)
@pytest.mark.parametrize("bf16", [True, False])
def test_route_is_chosen_only_above_256(kind, bf16):
    for D in ff.HEAD_DIMS:
        assert not any(isinstance(ln.plan, fw.WidePlan) for ln in _launches(kind, 1, 2, 64, 64, D, bf16))
    for D in WIDE:
        lns = _launches(kind, 1, 2, 64, 64, D, bf16)
        assert len(lns) == 1 and isinstance(lns[0].plan, fw.WidePlan) and lns[0].plan.kind == kind
    for D in (300, 257):  # not a multiple of 64 above 256: the op pads them
        with pytest.raises(ValueError, match="head_dim"):
            _launches(kind, 1, 2, 64, 64, D, bf16)
    assert [fw.takes(d) for d in (256, 257, 300, 320, 1024)] == [False, False, False, True, True]


@pytest.mark.parametrize("D", [1, 200, 256, 257, 288, 300, 320, 511, 1000, 4097])
def test_op_pads_to_a_head_dim_a_kernel_takes(D):
    Dp = padded_head_dim(D)
    assert Dp >= D and (Dp in ff.HEAD_DIMS or fw.takes(Dp))
    assert (Dp in ff.HEAD_DIMS) == (D <= 256)
    assert Dp - D < (64 if D > 256 else Dp)


@pytest.mark.parametrize("kind", fw.KINDS)
@pytest.mark.parametrize("B,H,S,Skv", [(2, 3, 100, 100), (1, 65536, 40, 40), (3, 30000, 7, 70),
                                       (1, 1, 32769, 32769)])
def test_launches_cover_every_head_and_row_tile_once(kind, B, H, S, Skv):
    """The head split of the tiled kernels (at most 65535 heads per launch,
    each a contiguous range of b*H + h) carries over; within a launch the
    grid covers every row tile (q rows, or keys for dK/dV) and column chunk
    once. A sequence past the tiled kernels' tables is one launch per head
    range: grid x has no table."""
    D = 320
    rows = Skv if kind == "dkv" else S
    lns = _launches(kind, B, H, S, Skv, D)
    assert len(lns) == len(ff.bh_chunks(B, H))
    seen = []
    for ln in lns:
        p = ln.plan
        BH = (ln.b1 - ln.b0) * (ln.h1 - ln.h0)
        assert ln.b1 - ln.b0 == 1 or (ln.h0, ln.h1) == (0, H)
        assert p.grid == (-(-rows // fw.BLOCK_ROWS), BH, len(fw.col_chunks(D))) and p.grid[1] <= ff.MAX_BH
        # grid z = c starts at column c * col_chunk, as the kernel computes it
        assert [c * p.col_chunk for c in range(p.grid[2])] == [c0 for c0, _ in fw.col_chunks(D)]
        seen += [(b * H + h) for b in range(ln.b0, ln.b1) for h in range(ln.h0, ln.h1)]
    assert seen == list(range(B * H))
    first_rows = [x * fw.BLOCK_ROWS for x in range(lns[0].plan.grid[0])]
    assert first_rows[-1] < rows <= first_rows[-1] + fw.BLOCK_ROWS


def _source_constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, name
    return int(m.group(1))


def test_plan_matches_the_kernel_source():
    """The plan's tile constants are the kernels' compile-time ones, and
    `LaunchPlan` is `WideLaunch` field for field (six 32-bit ints)."""
    assert (_source_constant("kRows"), _source_constant("kSC"), _source_constant("kCC")) == \
        (fw.BLOCK_ROWS, fw.STREAM_COLS, fw.COL_CHUNK)
    struct = re.search(r"struct WideLaunch \{(.*?)\};", SOURCE.read_text(), re.S).group(1)
    fields = [f.strip() for f in re.sub(r"\bint\b", "", struct).replace("\n", " ").split(",")]
    fields = [f.strip(" ;") for f in fields]
    assert fields == [n for n, _ in fw.LaunchPlan._fields_]
    assert ctypes.sizeof(fw.LaunchPlan) == 4 * len(fields)
    lp = fw.launch_plan(fw.plan("dq", 6, 100, 100, 512))
    assert (lp.block_rows, lp.stream_cols, lp.col_chunk, lp.grid_x, lp.grid_y, lp.grid_z) == (32, 64, 128, 4, 6, 4)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("S,Skv,causal", [(64, 64, True), (40, 96, True), (48, 48, False)])
def test_op_at_a_wide_head_matches_jax(S, Skv, causal):
    """The op at D = 320 on the CPU (its plain version: the card pads D = 320
    to no wider head, the wide route's own) against the JAX package's
    `flash_attention` (off the TPU, its reference path) and its Pallas
    forward and backward in interpret mode: output, lse and the gradients."""
    D, tol = 320, 2e-3
    q, k, v = _rand(1, 2, S, D, seed=60), _rand(1, 2, Skv, D, seed=61), _rand(1, 2, Skv, D, seed=62)
    g = _rand(1, 2, S, D, seed=63)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    want, vjp = jax.vjp(lambda a, b, c: j_flash_attention(a, b, c, causal), jq, jk, jv)
    want_grads = vjp(jg)
    scale = D ** -0.5
    p_o, p_lse = _flash_fwd_pallas(jq, jk, jv, causal, scale, 128, 128, interpret=True, return_lse=True)
    pallas_grads = _flash_bwd_pallas(jq, jk, jv, p_o, p_lse, jg, causal, scale, 128, 128, interpret=True)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out, lse = flash_attention_with_stats(tq, tk, tv, causal)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(p_o)[:, :, :S], atol=tol, rtol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(p_lse)[:, :, :S], atol=tol, rtol=tol)
    for t, w, p in zip((tq, tk, tv), want_grads, pallas_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=tol, rtol=tol)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(p), atol=tol, rtol=tol)
    with torch.no_grad():
        np.testing.assert_array_equal(flash_attention(tq, tk, tv, causal).numpy(), out.detach().numpy())

"""The port's CUDA kernels against their plain PyTorch versions.

Tests marked `cuda` need a CUDA card (and `nvcc` to build the kernels);
without one they skip. On the H100, run them with:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

(`--noconftest`: `tests/conftest.py` imports JAX, which this file does not
need and a CUDA machine may not have.)

The unmarked tests check the wrappers' refusals, which need no card.
"""

import pytest
import torch

from ray_tpu_torch.kernels import build
from ray_tpu_torch.kernels.flash_bwd import flash_bwd, flash_bwd_dkv, flash_bwd_dq
from ray_tpu_torch.kernels import flash_bwd as fb
from ray_tpu_torch.kernels import flash_fwd as ff
from ray_tpu_torch.kernels.flash_fwd import flash_fwd
from ray_tpu_torch.kernels.rmsnorm import rmsnorm_fwd
from ray_tpu_torch.models import gpt as tg
from ray_tpu_torch.ops import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_attention_with_stats,
    rmsnorm,
    rmsnorm_plain,
)
from ray_tpu_torch.optim import AdamW

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    """Decided here, not at import time: the suite runs under xdist, and
    every worker must collect the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: pytest -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dtype)


# The bf16 forward works in 128-row q tiles and 128-key tiles (64 at
# D = 256): sizes on both sides of each tile boundary, several q tiles
# against a longer cache (Skv > S), and the smallest problem.
_TILE_EDGES = [(S, S, causal) for S in (127, 128, 129, 255, 257, 1000) for causal in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("S,Skv,causal", [(256, 256, True), (256, 256, False), (200, 200, True),
                                          (200, 200, False), (1, 128, True), (64, 192, True),
                                          *_TILE_EDGES, (300, 1000, True), (300, 1000, False),
                                          (1, 1, True)])
def test_flash_kernel_matches_plain(cuda, dtype, D, S, Skv, causal):
    q = _randn((2, 3, S, D), dtype, cuda, 0)
    k = _randn((2, 3, Skv, D), dtype, cuda, 1)
    v = _randn((2, 3, Skv, D), dtype, cuda, 2)
    out, lse = flash_fwd(q, k, v, causal, D ** -0.5, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_plain(q, k, v, causal, return_lse=True)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse.reshape(ref_lse.shape), ref_lse, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_inputs(cuda):
    """q/k/v as the model produces them: views of one [B, S, 3, H, D]
    projection, not contiguous per head."""
    qkv = _randn((2, 100, 3, 4, 64), torch.bfloat16, cuda, 3)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    before = flash_fwd.launches
    out = flash_attention(q, k, v, causal=True)
    assert flash_fwd.launches == before + 1
    ref = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), True)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernel_more_items_than_two_waves(cuda, D):
    """B*H = 288 > 2 * 132 (q tiles) work items: every persistent CTA walks
    several items, heaviest first."""
    q, k, v = (_randn((9, 32, 200, D), torch.bfloat16, cuda, 20 + i) for i in range(3))
    out, lse = flash_fwd(q, k, v, True, D ** -0.5, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_plain(q, k, v, True, return_lse=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse.reshape(ref_lse.shape), ref_lse, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_flash_kernel_replays_in_a_cuda_graph(cuda):
    """The launch (tensor maps as kernel parameters, shared-memory limit
    raised beforehand) is captured once and replayed on new inputs."""
    B, H, S, D = 2, 4, 300, 128
    q, k, v = (_randn((B, H, S, D), torch.bfloat16, cuda, 30 + i) for i in range(3))
    flash_fwd(q, k, v, True, D ** -0.5)  # first call outside the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_fwd(q, k, v, True, D ** -0.5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, lse = flash_fwd(q, k, v, True, D ** -0.5, return_lse=True)
    for seed in (40, 50):
        for i, t in enumerate((q, k, v)):
            t.copy_(_randn((B, H, S, D), torch.bfloat16, cuda, seed + i))
        graph.replay()
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_plain(q, k, v, True, return_lse=True)
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(lse.reshape(ref_lse.shape), ref_lse, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_flash_kernel_generate_layout(cuda):
    """The generate path's prefill: q and k contiguous after RoPE, v a
    strided view of the [B, S, 3, H, D] projection, read in place."""
    qkv = _randn((4, 128, 3, 32, 128), torch.bfloat16, cuda, 60)
    q, k = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(2))
    v = qkv[:, :, 2].transpose(1, 2)
    assert not v.is_contiguous()
    out = flash_fwd(q, k, v, True, 128 ** -0.5)[0]
    torch.cuda.synchronize()
    ref = flash_attention_plain(q, k, v.contiguous(), True)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_flash_kernel_refuses_nonpositive_scale(cuda):
    x = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="scale"):
        flash_fwd(x, x, x, True, 0.0)


# The main path's rows (D=4096: decode 1-8, an engine chunk 64, generate's
# prefill 512, a shape beyond L2 16384), ragged rows, narrow and wide D
# (4097 and 100 bf16 take the scalar path; 8192 f32 and 40000 are too wide
# for registers and take the vector path).
_RMS_CASES = ([(N, 4096) for N in (1, 4, 7, 8, 64, 512, 16384)] + [(4096, 768), (5, 100), (3, 4097)]
              + [(N, D) for D in (64, 100, 768, 4097, 8192) for N in (3, 300)] + [(2, 40000)])
_DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("w_dtype", _DTYPES)
@pytest.mark.parametrize("N,D", _RMS_CASES)
def test_rmsnorm_kernel_matches_plain(cuda, dtype, w_dtype, N, D):
    """x and the weight each in f32 or bf16; the weight is read in its own
    dtype (no cast before the kernel)."""
    x = _randn((N, D), dtype, cuda, 4) * 3
    w = (1 + 0.1 * _randn((D,), torch.float32, cuda, 5)).to(w_dtype)
    before = rmsnorm_fwd.launches
    y = rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rmsnorm_fwd.launches == before + 1 and y.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), rmsnorm_plain(x, w).float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_rmsnorm_kernel_reads_row_strided_input(cuda):
    x = _randn((6, 2 * 512), torch.bfloat16, cuda, 6)[:, :512]
    w = _randn((512,), torch.float32, cuda, 7)
    torch.testing.assert_close(rmsnorm_fwd(x, w).float(), rmsnorm_plain(x, w).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _DTYPES)
def test_rmsnorm_kernel_reads_a_misaligned_base(cuda, dtype):
    """x[:, 1:] of a wider tensor: every row starts one element past a
    16-byte boundary, so no 16-byte load may touch it (scalar path); a
    weight one element past a boundary is read by elements."""
    x = (_randn((64, 4097), dtype, cuda, 10) * 3)[:, 1:]
    w = (1 + 0.1 * _randn((4097,), torch.float32, cuda, 11)).to(dtype)[1:]
    assert x.data_ptr() % 16 != 0 and w.data_ptr() % 16 != 0
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    aligned_x = x.contiguous()
    for xx in (x, aligned_x):  # scalar path; then the register path with element weight loads
        torch.testing.assert_close(rmsnorm_fwd(xx, w).float(), rmsnorm_plain(xx, w).float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("N,D", [(4, 4096), (2048, 4096), (16384, 4096), (300, 4097)])
def test_rmsnorm_kernel_is_deterministic(cuda, dtype, N, D):
    """Bitwise-equal results over repeated calls (at N=16384 each CTA takes
    many row groups, alternating its two register buffers)."""
    x = _randn((N, D), dtype, cuda, 12) * 3
    w = (1 + 0.1 * _randn((D,), torch.float32, cuda, 13)).to(dtype)
    first = rmsnorm_fwd(x, w)
    for _ in range(5):
        assert torch.equal(rmsnorm_fwd(x, w), first)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4, 512])
def test_rmsnorm_call_is_one_device_kernel(cuda, N):
    """With a bf16 weight (the serving path's), a call is one launch: no cast
    kernel before the norm, counted on the device by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    x = _randn((N, 4096), torch.bfloat16, cuda, 14)
    w = (1 + 0.1 * _randn((4096,), torch.float32, cuda, 15)).to(torch.bfloat16)
    rmsnorm(x, w)  # build and warm up outside the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rmsnorm(x, w)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "rmsnorm" in kernels[0], kernels


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _DTYPES)
def test_rmsnorm_op_gradient_on_the_card_matches_the_cpu(cuda, dtype):
    """The custom op ray_tpu_torch::rmsnorm: kernel forward, plain VJP."""
    cpu = torch.device("cpu")
    x0 = _randn((64, 4096), torch.float32, cpu, 16) * 3
    w0 = 1 + 0.1 * _randn((4096,), torch.float32, cpu, 17)
    g0 = _randn((64, 4096), torch.float32, cpu, 18)
    grads = {}
    for dev in (cpu, cuda):
        x = x0.to(dev, dtype, copy=True).requires_grad_()
        w = w0.to(dev, dtype, copy=True).requires_grad_()
        y = rmsnorm(x, w)
        assert y.grad_fn is not None
        y.backward(g0.to(dev, dtype))
        grads[dev.type] = (y.detach().cpu().float(), x.grad.cpu().float(), w.grad.cpu().float())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for name, got, want in zip(("y", "dx", "dw"), grads["cuda"], grads["cpu"]):
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= tol * max(scale, 1.0), name


def _bwd_pair(q, k, v, o, lse, do, causal, scale):
    """dQ, Δ, dK, dV from the two kernels, launched as `flash_bwd` launches
    them (dQ writes Δ, dK/dV reads it)."""
    dq, delta = flash_bwd_dq(q, k, v, o, do, lse, causal, scale)
    return (dq, delta, *flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale))


def _assert_bwd_matches_plain(got, q, k, v, o, lse, do, causal, scale, tol):
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    want_delta = (do.float() * o.float()).sum(-1).reshape(got[1].shape)
    for name, a, w in zip(("dq", "delta", "dk", "dv"), got, (want[0], want_delta, *want[1:])):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        torch.testing.assert_close(a.float(), w.float(), atol=tol, rtol=tol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("S,Skv,causal", [(256, 256, True), (256, 256, False), (200, 200, True),
                                          (1, 128, True), (64, 192, True)])
def test_flash_bwd_kernels_match_plain(cuda, dtype, D, S, Skv, causal):
    """dQ, dK, dV and the dQ kernel's Δ against the plain backward and
    rowsum(dO∘O); `flash_bwd` launches each kernel once."""
    q = _randn((2, 3, S, D), dtype, cuda, 10)
    k = _randn((2, 3, Skv, D), dtype, cuda, 11)
    v = _randn((2, 3, Skv, D), dtype, cuda, 12)
    do = _randn((2, 3, S, D), dtype, cuda, 13)
    o, lse = flash_fwd(q, k, v, causal, D ** -0.5, return_lse=True)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    dq, dk, dv = flash_bwd(q, k, v, o, lse, do, causal, D ** -0.5)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    got = _bwd_pair(q, k, v, o, lse, do, causal, D ** -0.5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), (got[0], *got[2:])))
    _assert_bwd_matches_plain(got, q, k, v, o, lse, do, causal, D ** -0.5, TOL[dtype])


@pytest.mark.cuda
def test_flash_bwd_kernels_read_strided_inputs(cuda):
    """dO as autograd may hand it in (a transposed view), q/k/v as views of
    one projection."""
    qkv = _randn((2, 100, 3, 4, 64), torch.bfloat16, cuda, 14)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = _randn((2, 100, 4, 64), torch.bfloat16, cuda, 15).transpose(1, 2)
    assert not do.is_contiguous()
    o, lse = flash_fwd(q, k, v, True, 0.125, return_lse=True)
    got = _bwd_pair(q, k, v, o, lse, do, True, 0.125)
    torch.cuda.synchronize()
    _assert_bwd_matches_plain(got, *(t.contiguous() for t in (q, k, v, o)), lse, do.contiguous(), True, 0.125,
                              2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_kernels_are_deterministic(cuda, dtype):
    """Two runs give bitwise-equal dQ, Δ, dK and dV: no atomics, a fixed
    order of every sum (B*H = 288 heads: persistent CTAs walk several items)."""
    q, k, v, do = (_randn((9, 32, 300, 64), dtype, cuda, 70 + i) for i in range(4))
    o, lse = flash_fwd(q, k, v, True, 0.125, return_lse=True)
    first = _bwd_pair(q, k, v, o, lse, do, True, 0.125)
    second = _bwd_pair(q, k, v, o, lse, do, True, 0.125)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "delta", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_flash_bwd_pair_replays_in_a_cuda_graph(cuda):
    """The pair (tensor maps as kernel parameters, Δ handed from one kernel
    to the next on the stream) is captured once and replayed on new inputs."""
    B, H, S, D = 2, 4, 300, 64
    q, k, v, do = (_randn((B, H, S, D), torch.bfloat16, cuda, 80 + i) for i in range(4))
    o, lse = flash_fwd(q, k, v, True, D ** -0.5, return_lse=True)
    flash_bwd(q, k, v, o, lse, do, True, D ** -0.5)  # first call outside the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_bwd(q, k, v, o, lse, do, True, D ** -0.5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = _bwd_pair(q, k, v, o, lse, do, True, D ** -0.5)
    for seed in (90, 100):
        for i, t in enumerate((q, k, v, do)):
            t.copy_(_randn((B, H, S, D), torch.bfloat16, cuda, seed + i))
        o2, lse2 = flash_fwd(q, k, v, True, D ** -0.5, return_lse=True)
        o.copy_(o2)
        lse.copy_(lse2)
        graph.replay()
        torch.cuda.synchronize()
        _assert_bwd_matches_plain(got, q, k, v, o, lse, do, True, D ** -0.5, 2e-2)


def _tiny_llama(**kw):
    # d_head 16, as the CPU parity configs: the op pads it to the kernels' 32.
    return tg.GPTConfig(vocab_size=64, n_layers=2, d_model=64, n_heads=4, d_head=16, d_mlp=128,
                        max_seq=64, norm="rmsnorm", activation="swiglu", pos="rotary", rotary_dim=16,
                        tie_embeddings=False, dtype=torch.float32, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("remat_policy", [None, "attn"])
def test_model_grads_on_the_card_match_the_cpu(cuda, remat_policy):
    """Every gradient of the model through the kernels (flash forward and
    backward, RMSNorm) against the same model on the CPU (plain ops)."""
    cfg = _tiny_llama(remat=True, remat_policy=remat_policy)
    cpu = tg.init_params(cfg, seed=0, device="cpu")
    gpu = {k: v.to(cuda) for k, v in cpu.items()}
    tokens = torch.randint(0, cfg.vocab_size, (2, 49), generator=torch.Generator().manual_seed(1))
    counts = (flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches, rmsnorm_fwd.launches)
    losses = {}
    for name, params in (("cpu", cpu), ("gpu", gpu)):
        for p in params.values():
            p.requires_grad_(True)
        losses[name] = tg.loss_fn(params, {"tokens": tokens.to(params["w_qkv"].device)}, cfg)
        losses[name].backward()
    torch.cuda.synchronize()
    after = (flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches, rmsnorm_fwd.launches)
    assert all(b > a for a, b in zip(counts, after)), (counts, after)
    torch.testing.assert_close(losses["gpu"].cpu(), losses["cpu"], atol=1e-5, rtol=1e-5)
    for k, p in cpu.items():
        if k.endswith("_b") and k.startswith("ln"):
            continue  # RMSNorm ignores its biases: no gradient on either side
        want, got = p.grad, gpu[k].grad.cpu()
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-4 * scale, k


@pytest.mark.cuda
def test_attn_remat_runs_flash_forward_once_per_layer(cuda):
    cfg = _tiny_llama(remat=True, remat_policy="attn")
    params = tg.init_params(cfg, seed=0, device=cuda)
    step = tg.make_train_step(cfg, AdamW(params.values(), lr=1e-3, mu_dtype=torch.bfloat16))
    tokens = torch.randint(0, cfg.vocab_size, (2, 65), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(2))
    flash_fwd.launches = flash_bwd_dq.launches = flash_bwd_dkv.launches = 0
    _, metrics = step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert (flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches) == (L, L, L)
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])


def _op_matches_plain(q, k, v, causal, tol):
    """The attention op and its gradient (the custom op, so the kernels)
    against the plain versions: the forward (o, lse) against the plain
    forward, the gradient against the plain backward of that same forward
    (the kernels' o and lse, as `_assert_bwd_matches_plain` holds them)."""
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    scale = q.shape[-1] ** -0.5
    out, lse = flash_attention_with_stats(q, k, v, causal)
    do = _randn(out.shape, out.dtype, out.device, 77)
    out.backward(do)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_plain(q.detach(), k.detach(), v.detach(), causal, return_lse=True)
    torch.testing.assert_close(out.detach().float(), ref.float(), atol=tol, rtol=tol, msg="o")
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol, msg="lse")
    want = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), out.detach(), lse, do, causal, scale)
    for name, t, w in zip(("dq", "dk", "dv"), (q, k, v), want):
        assert t.grad.shape == w.shape and t.grad.dtype == w.dtype, name
        torch.testing.assert_close(t.grad.float(), w.float(), atol=tol, rtol=tol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [16, 80, 96])
@pytest.mark.parametrize("S,Skv,causal", [(200, 200, True), (129, 129, False), (64, 192, True)])
def test_flash_op_pads_head_dims(cuda, dtype, D, S, Skv, causal):
    """Head dims the kernels are not compiled for go through the kernels,
    zero-padded to the next compiled one (16 -> 32, 80 and 96 -> 128)."""
    before = (flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches)
    _op_matches_plain(_randn((2, 3, S, D), dtype, cuda, 20), _randn((2, 3, Skv, D), dtype, cuda, 21),
                      _randn((2, 3, Skv, D), dtype, cuda, 22), causal, TOL[dtype])
    after = (flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches)
    assert all(b == a + 1 for a, b in zip(before, after)), (before, after)


def test_flash_op_refuses_head_dims_past_the_widest():
    from ray_tpu_torch.ops.attention import padded_head_dim

    assert [padded_head_dim(d) for d in (1, 16, 32, 33, 80, 96, 128, 200, 256)] == \
        [32, 32, 32, 64, 128, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="257 is wider than 256"):
        padded_head_dim(257)


@pytest.mark.cuda
@pytest.mark.parametrize("D,S,fwd_launches,bwd_launches", [
    (128, ff.block_q(128) * ff.MAX_Q_TILES + 1, 2, None),    # forward: just past its q-tile table
    (64, 2 * ff.WG_ROWS * fb.MAX_TILES + 1, 1, 2),           # backward: past dQ's and dK/dV's tables
])
def test_flash_splits_sequences_past_the_tile_tables(cuda, D, S, fwd_launches, bwd_launches):
    """A bf16 sequence longer than one launch's tile table runs as several
    launches of the same kernel, each over its own tiles."""
    q, k, v = (_randn((1, 1, S, D), torch.bfloat16, cuda, 30 + i) for i in range(3))
    before = (flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches)
    if bwd_launches is None:
        with torch.no_grad():
            out = flash_attention(q, k, v, True)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), flash_attention_plain(q, k, v, True).float(),
                                   atol=2e-2, rtol=2e-2)
        assert flash_fwd.launches - before[0] == fwd_launches
        return
    _op_matches_plain(q, k, v, True, 2e-2)
    after = (flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches)
    assert tuple(b - a for a, b in zip(before, after)) == (fwd_launches, bwd_launches, bwd_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,n", [(65535, 1), (65536, 2)])
def test_flash_splits_heads_past_the_grid_limit(cuda, dtype, H, n):
    """B*H = 65536 heads: two launches of each kernel, over heads [0, 65535)
    and [65535, 65536); at 65535, the most one launch takes, one."""
    B, S, D = 1, 40, 32
    before = (flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches)
    _op_matches_plain(*(_randn((B, H, S, D), dtype, cuda, 40 + i) for i in range(3)), True, TOL[dtype])
    after = (flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches)
    assert tuple(b - a for a, b in zip(before, after)) == (n, n, n)


def test_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd(x, x, x, True, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_fwd(torch.zeros(2, 8), torch.ones(8))


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()


def test_bwd_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 2, 8, 64)
    stats = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dq(x, x, x, x, x, stats, True, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dkv(x, x, x, x, stats, stats, True, 0.125)

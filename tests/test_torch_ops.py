"""The port's ops (`ray_tpu_torch.ops`) against the JAX reference
(`ray_tpu.ops`), on the CPU: the plain flash-attention version against
`attention_reference` and the Pallas kernel in interpret mode, lse against
the reference's off-TPU `flash_attention_with_stats`, the plain flash
backward against the Pallas backward in interpret mode and against the VJP
of `attention_reference`, the gradients of the differentiable ops, RMSNorm,
RoPE and LayerNorm. Inputs are made with numpy and handed to both
packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import apply_rope as j_apply_rope
from ray_tpu.ops import attention_reference as j_attention_reference
from ray_tpu.ops import layernorm as j_layernorm
from ray_tpu.ops import rmsnorm as j_rmsnorm
from ray_tpu.ops import rope_frequencies as j_rope_frequencies
from ray_tpu.ops.attention import _flash_bwd_pallas, _flash_fwd_pallas
from ray_tpu.ops.attention import flash_attention_with_stats as j_flash_with_stats
from ray_tpu_torch.ops import (
    attention_reference,
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_attention_with_stats,
    layernorm,
    rmsnorm,
    rmsnorm_plain,
    rope_frequencies,
    rope_rotate,
)

TOL = 2e-3  # f32, as tests/test_ops.py holds the Pallas kernel


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# The grid of tests/test_ops.py:31-55 (S=256 causal and not, ragged 200,
# decode 1x128, chunked 64x192).
GRID = [
    (256, 256, True, 64),
    (256, 256, False, 64),
    (200, 200, False, 32),
    (200, 200, True, 32),
    (1, 128, True, 32),
    (64, 192, True, 32),
]


@pytest.mark.parametrize("S,Skv,causal,D", GRID)
def test_flash_plain_matches_reference_and_pallas(S, Skv, causal, D):
    q, k, v = _rand(1, 2, S, D, seed=0), _rand(1, 2, Skv, D, seed=1), _rand(1, 2, Skv, D, seed=2)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = flash_attention_plain(tq, tk, tv, causal).numpy()
    want = np.asarray(j_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal))
    pallas = np.asarray(_flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                          D ** -0.5, 128, 128, interpret=True))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, pallas, atol=TOL, rtol=TOL)
    # The CPU dispatch of the wrapper is the plain version, bit for bit.
    np.testing.assert_array_equal(flash_attention(tq, tk, tv, causal).numpy(), got)
    np.testing.assert_allclose(attention_reference(tq, tk, tv, causal).numpy(), want,
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("S,Skv,causal", [(200, 200, True), (64, 192, True), (128, 128, False)])
def test_flash_lse_matches_reference_stats(S, Skv, causal):
    q, k, v = _rand(2, 3, S, 32, seed=3), _rand(2, 3, Skv, 32, seed=4), _rand(2, 3, Skv, 32, seed=5)
    out, lse = flash_attention_with_stats(*map(torch.from_numpy, (q, k, v)), causal=causal)
    j_out, j_lse = j_flash_with_stats(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    assert tuple(lse.shape) == (6, 1, S) == tuple(j_lse.shape)  # unpadded, as off the TPU
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=TOL, rtol=TOL)


def test_flash_plain_bf16_rounds_probs_like_reference():
    q, k, v = _rand(1, 2, 64, 32, seed=6), _rand(1, 2, 64, 32, seed=7), _rand(1, 2, 64, 32, seed=8)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention_plain(tq, tk, tv, True)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(j_attention_reference(jq, jk, jv, True).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("shape", [(4, 128), (2, 3, 96), (5, 100)])
def test_rmsnorm_plain_matches_reference(shape):
    x = _rand(*shape, seed=9) * 3
    w = 1 + 0.1 * _rand(shape[-1], seed=10)
    got = rmsnorm_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(j_rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(), got)


def test_rmsnorm_bf16_input_f32_weight_keeps_input_dtype():
    x = _rand(3, 64, seed=11)
    w = 1 + 0.1 * _rand(64, seed=12)
    got = rmsnorm_plain(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    want = np.asarray(j_rmsnorm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w)).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("with_bias", [True, False])
def test_layernorm_matches_reference(with_bias):
    x = _rand(4, 48, seed=13) * 2 + 1
    w = 1 + 0.1 * _rand(48, seed=14)
    b = 0.1 * _rand(48, seed=15) if with_bias else None
    got = layernorm(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b) if with_bias else None).numpy()
    want = np.asarray(j_layernorm(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b) if with_bias else None))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("positions", [None, [3, 0, 7, 7, 1]])
def test_rope_matches_reference(positions):
    head_dim, max_seq = 16, 32
    cos, sin = rope_frequencies(head_dim, max_seq)
    j_cos, j_sin = j_rope_frequencies(head_dim, max_seq)
    np.testing.assert_allclose(cos.numpy(), np.asarray(j_cos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(j_sin), atol=1e-6)
    assert tuple(cos.shape) == (max_seq, head_dim // 2) and cos.dtype == torch.float32
    x = _rand(2, 3, 5, head_dim, seed=16)
    tpos = torch.arange(5) if positions is None else torch.tensor(positions)
    jpos = None if positions is None else jnp.asarray(positions)
    got = rope_rotate(torch.from_numpy(x), cos[tpos], sin[tpos]).numpy()
    want = np.asarray(j_apply_rope(jnp.asarray(x), j_cos, j_sin, jpos))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# The cases of tests/test_ops.py::test_flash_bwd_kernel_matches_reference.
BWD_CASES = [
    (True, 256, 256, 64),
    (False, 256, 256, 64),
    (True, 200, 200, 32),   # ragged against 128-row blocks: the Pallas lse is padded
    (True, 64, 192, 32),    # chunked prefill (end-aligned rows)
]


@pytest.mark.parametrize("causal,S,Skv,D", BWD_CASES)
def test_flash_bwd_plain_matches_pallas_and_reference_vjp(causal, S, Skv, D):
    scale = D ** -0.5
    q, k, v = _rand(1, 2, S, D, seed=20), _rand(1, 2, Skv, D, seed=21), _rand(1, 2, Skv, D, seed=22)
    g = _rand(1, 2, S, D, seed=23)
    jq, jk, jv, jgo = map(jnp.asarray, (q, k, v, g))
    # The reference's two views of the same gradient, as tests/test_ops.py runs them.
    ref = jax.vjp(lambda a, b, c: j_attention_reference(a, b, c, causal, scale), jq, jk, jv)[1](jgo)
    o, lse = _flash_fwd_pallas(jq, jk, jv, causal, scale, 128, 128, interpret=True, return_lse=True)
    pallas = _flash_bwd_pallas(jq, jk, jv, o, lse, jgo, causal, scale, 128, 128, interpret=True)

    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    t_o, t_lse = flash_attention_plain(tq, tk, tv, causal, scale, return_lse=True)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(lse)[:, :, :S], atol=TOL, rtol=TOL)
    got = flash_attention_bwd_plain(tq, tk, tv, t_o, t_lse, tg, causal, scale)
    for name, a, want_pallas, want_ref in zip("qkv", got, pallas, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(want_pallas), atol=TOL, rtol=TOL, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(want_ref), atol=TOL, rtol=TOL, err_msg=name)


def test_flash_bwd_plain_bf16_rounds_like_pallas():
    """bf16 inputs: dS and P rounded to bf16 before their products, as the
    Pallas backward rounds them (2e-2, the bf16 bar of tests/test_ops.py)."""
    S, D, scale = 128, 32, 32 ** -0.5
    arrays = [_rand(1, 2, S, D, seed=s) for s in (24, 25, 26, 27)]
    jq, jk, jv, jgo = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    o, lse = _flash_fwd_pallas(jq, jk, jv, True, scale, 128, 128, interpret=True, return_lse=True)
    want = _flash_bwd_pallas(jq, jk, jv, o, lse, jgo, True, scale, 128, 128, interpret=True)
    tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    t_o, t_lse = flash_attention_plain(tq, tk, tv, True, scale, return_lse=True)
    got = flash_attention_bwd_plain(tq, tk, tv, t_o, t_lse, tg, True, scale)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("with_stats", [False, True])
def test_flash_autograd_matches_reference_vjp_and_lse_has_no_grad(with_stats):
    q, k, v = _rand(2, 3, 40, 32, seed=28), _rand(2, 3, 56, 32, seed=29), _rand(2, 3, 56, 32, seed=30)
    g = _rand(2, 3, 40, 32, seed=31)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    if with_stats:
        out, lse = flash_attention_with_stats(tq, tk, tv, causal=True)
        assert not lse.requires_grad and lse.grad_fn is None
    else:
        out = flash_attention(tq, tk, tv, causal=True)
    assert out.requires_grad
    out.backward(torch.from_numpy(g))
    ref = jax.vjp(lambda a, b, c: j_attention_reference(a, b, c, True), *map(jnp.asarray, (q, k, v)))[1](
        jnp.asarray(g))
    for t, want in zip((tq, tk, tv), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", [(4, 128), (2, 3, 96)])
def test_rmsnorm_grad_matches_jax_vjp(shape):
    x = _rand(*shape, seed=32) * 3
    w = 1 + 0.1 * _rand(shape[-1], seed=33)
    g = _rand(*shape, seed=34)
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y = rmsnorm(tx, tw)
    y.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(j_rmsnorm, jnp.asarray(x), jnp.asarray(w))
    want_x, want_w = vjp(jnp.asarray(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(j_rmsnorm(jnp.asarray(x), jnp.asarray(w))),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_w), atol=1e-4, rtol=1e-5)

"""The port's model (`ray_tpu_torch.models.gpt`) against the JAX reference
(`ray_tpu.models.gpt`) in f32 on the CPU, on tiny gpt2-style, gptj-style
(parallel block, untied, partial rotary) and llama-style configs with the
same converted weights: forward logits, dense prefill/decode logits and
greedy tokens, and the paged prefill/decode/verify logits and KV pools."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jg
from ray_tpu_torch.models import gpt as tg
from ray_tpu_torch.models.convert import params_from_jax

TOL = 2e-4  # f32 logits, as tests/test_generate.py holds the JAX decode path

BASE = dict(vocab_size=64, n_layers=2, d_model=48, n_heads=3, d_head=16, d_mlp=96,
            max_seq=64, remat=False)
STYLES = {
    "gpt2": dict(),
    "gptj": dict(pos="rotary", rotary_dim=8, parallel_block=True, tie_embeddings=False),
    "llama": dict(pos="rotary", rotary_dim=16, norm="rmsnorm", activation="swiglu",
                  tie_embeddings=False),
}


def _configs(style, attn_impl="flash"):
    kw = {**BASE, **STYLES[style], "attn_impl": attn_impl}
    return jg.GPTConfig(**kw, dtype=jnp.float32), tg.GPTConfig(**kw, dtype=torch.float32)


def _params(jcfg, seed=0):
    """numpy params with the reference's keys and shapes: matrices at std 0.3
    (the reference's 0.02 init makes a tiny model's greedy decode repeat one
    token, and parity would prove nothing), random biases and norm weights
    so that their layouts are exercised too."""
    shapes = jax.eval_shape(lambda: jg.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in shapes.items():
        if name.startswith("b_") or name.endswith("_b"):
            a = 0.1 * rng.standard_normal(s.shape)
        elif name.endswith("_w"):
            a = 1 + 0.1 * rng.standard_normal(s.shape)
        else:
            a = 0.3 * rng.standard_normal(s.shape)
        out[name] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module", params=list(STYLES))
def model(request):
    jcfg, tcfg = _configs(request.param)
    np_params = _params(jcfg)
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    tp = params_from_jax(np_params, tcfg, device="cpu")
    return request.param, jcfg, tcfg, jp, tp


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, BASE["vocab_size"], shape)


def test_forward_logits(model):
    _, jcfg, tcfg, jp, tp = model
    toks = _tokens((2, 11))
    want = np.asarray(jg.forward(jp, jnp.asarray(toks), jcfg))
    got = tg.forward(tp, torch.as_tensor(toks), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 11, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_forward_ref_attention_matches_flash(model):
    style, _, tcfg, _, tp = model
    _, ref_cfg = _configs(style, attn_impl="ref")
    toks = torch.as_tensor(_tokens((1, 9)))
    np.testing.assert_allclose(tg.forward(tp, toks, ref_cfg).numpy(),
                               tg.forward(tp, toks, tcfg).numpy(), atol=1e-6)


def test_prefill_and_decode_logits(model):
    _, jcfg, tcfg, jp, tp = model
    toks = _tokens((2, 7))
    M = 12
    j_logits, j_cache = jg.prefill(jp, jnp.asarray(toks, jnp.int32), jcfg, jg.init_cache(jcfg, 2, M))
    t_cache = tg.init_cache(tcfg, 2, M, device="cpu")
    t_logits, t_cache = tg.prefill(tp, torch.as_tensor(toks), tcfg, t_cache)
    assert t_logits.dtype == torch.float32
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(t_cache["k"].numpy(), np.asarray(j_cache["k"]), atol=TOL, rtol=TOL)
    nxt = _tokens((3, 2), seed=2)
    for step in range(3):
        j_logits, j_cache = jg.decode_step(jp, jnp.asarray(nxt[step], jnp.int32), j_cache, jcfg)
        t_logits, t_cache = tg.decode_step(tp, torch.as_tensor(nxt[step]), t_cache, tcfg)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=TOL, rtol=TOL)
    assert t_cache["len"] == int(j_cache["len"]) == 10
    np.testing.assert_allclose(t_cache["v"].numpy(), np.asarray(j_cache["v"]), atol=TOL, rtol=TOL)


def test_make_generate_greedy_tokens(model):
    style, jcfg, tcfg, jp, tp = model
    toks = _tokens((2, 6), seed=3)
    N = 10
    want = np.asarray(jax.jit(jg.make_generate(jcfg, N))(
        jp, jnp.asarray(toks, jnp.int32), jax.random.PRNGKey(0)))
    got = tg.make_generate(tcfg, N)(tp, torch.as_tensor(toks)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(want.ravel().tolist())) > 3, f"{style}: degenerate decode, parity proves nothing"


def _paged_pools(jcfg, tcfg, num_blocks=16, block_size=4):
    return (jg.init_paged_cache(jcfg, num_blocks, block_size),
            tg.init_paged_cache(tcfg, num_blocks, block_size, device="cpu"))


def _check_pools(t_kv, j_kv):
    # Block 0 is the null block: padding writes land there in an order
    # neither package defines.
    for name in ("k", "v"):
        np.testing.assert_allclose(t_kv[name][:, 1:].numpy(), np.asarray(j_kv[name])[:, 1:],
                                   atol=TOL, rtol=TOL)


def test_paged_prefill_decode_verify(model):
    _, jcfg, tcfg, jp, tp = model
    j_kv, t_kv = _paged_pools(jcfg, tcfg)
    prompt = _tokens((10,), seed=4)
    table = np.array([3, 5, 7, 0])  # 3 blocks of 4 + padding to the width bucket
    # Two chunks: prompt[0:6] padded to 8, then prompt[6:10] (4).
    for start, n, Sp in ((0, 6, 8), (6, 4, 4)):
        chunk = np.zeros((1, Sp), np.int64)
        chunk[0, :n] = prompt[start:start + n]
        j_logits, j_kv = jg.prefill_paged(jp, jnp.asarray(chunk, jnp.int32), jnp.int32(n),
                                          jnp.int32(start), jnp.asarray(table, jnp.int32), j_kv, jcfg)
        t_logits, t_kv = tg.prefill_paged(tp, torch.as_tensor(chunk), n, start,
                                          torch.as_tensor(table), t_kv, tcfg)
        assert tuple(t_logits.shape) == (64,)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=TOL, rtol=TOL)
        _check_pools(t_kv, j_kv)

    # Decode: lane 0 is the sequence at position 10, lane 1 a padding lane.
    tok = np.array([int(prompt[-1]), 0])
    pos = np.array([10, 0])
    tables = np.stack([table, np.zeros(4, np.int64)])
    j_logits, j_kv = jg.decode_step_paged(jp, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32),
                                          jnp.asarray(tables, jnp.int32), j_kv, jcfg)
    t_logits, t_kv = tg.decode_step_paged(tp, torch.as_tensor(tok), torch.as_tensor(pos),
                                          torch.as_tensor(tables), t_kv, tcfg)
    np.testing.assert_allclose(t_logits[0].numpy(), np.asarray(j_logits)[0], atol=TOL, rtol=TOL)
    _check_pools(t_kv, j_kv)

    # Verify: lane 0 scores its token plus a 2-token draft at 11..13.
    vt = np.array([[5, 9, 2], [0, 0, 0]])
    vpos = np.array([11, 0])
    vlen = np.array([3, 0])
    j_logits, j_kv = jg.verify_step_paged(jp, jnp.asarray(vt, jnp.int32), jnp.asarray(vpos, jnp.int32),
                                          jnp.asarray(vlen, jnp.int32), jnp.asarray(tables, jnp.int32),
                                          j_kv, jcfg)
    t_logits, t_kv = tg.verify_step_paged(tp, torch.as_tensor(vt), torch.as_tensor(vpos),
                                          torch.as_tensor(vlen), torch.as_tensor(tables), t_kv, tcfg)
    assert tuple(t_logits.shape) == (2, 3, 64)
    np.testing.assert_allclose(t_logits[0].numpy(), np.asarray(j_logits)[0], atol=TOL, rtol=TOL)
    _check_pools(t_kv, j_kv)


def test_paged_padded_slots_past_max_seq(model):
    """Padded slots may sit past max_seq (a chunk bucket after a prefix hit,
    a verify lane at the limit); JAX clamps their table gathers, and so must
    the port, on every position kind (learned and rotary)."""
    _, jcfg, tcfg, jp, tp = model
    j_kv, t_kv = _paged_pools(jcfg, tcfg, num_blocks=20)
    prompt = _tokens((62,), seed=5)
    table = np.arange(1, 17)  # 16 blocks of 4 = max_seq 64
    # prompt[52:62] is padded to 16: its bucket covers positions 52..67.
    for start, n, Sp in ((0, 52, 64), (52, 10, 16)):
        chunk = np.zeros((1, Sp), np.int64)
        chunk[0, :n] = prompt[start:start + n]
        j_logits, j_kv = jg.prefill_paged(jp, jnp.asarray(chunk, jnp.int32), jnp.int32(n),
                                          jnp.int32(start), jnp.asarray(table, jnp.int32), j_kv, jcfg)
        t_logits, t_kv = tg.prefill_paged(tp, torch.as_tensor(chunk), n, start,
                                          torch.as_tensor(table), t_kv, tcfg)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=TOL, rtol=TOL)
        _check_pools(t_kv, j_kv)
    # Verify at position 62 with a 1-token draft: the third slot is at 64.
    vt, vpos, vlen = np.array([[5, 9, 2]]), np.array([62]), np.array([2])
    j_logits, j_kv = jg.verify_step_paged(jp, jnp.asarray(vt, jnp.int32), jnp.asarray(vpos, jnp.int32),
                                          jnp.asarray(vlen, jnp.int32), jnp.asarray(table[None], jnp.int32),
                                          j_kv, jcfg)
    t_logits, t_kv = tg.verify_step_paged(tp, torch.as_tensor(vt), torch.as_tensor(vpos),
                                          torch.as_tensor(vlen), torch.as_tensor(table[None]), t_kv, tcfg)
    np.testing.assert_allclose(t_logits[0, :2].numpy(), np.asarray(j_logits)[0, :2], atol=TOL, rtol=TOL)
    _check_pools(t_kv, j_kv)


def test_paged_scatter_splits_advanced_indices():
    """kk[phys, :, off] with index tensors split by a slice puts the indexed
    dim first (numpy's rule): [n, H, Dh]."""
    pool = torch.zeros(4, 3, 2, 5)
    phys, off = torch.tensor([1, 2]), torch.tensor([0, 1])
    assert tuple(pool[phys, :, off].shape) == (2, 3, 5)
    pool[phys, :, off] = torch.ones(2, 3, 5)
    assert pool[1, :, 0].eq(1).all() and pool[2, :, 1].eq(1).all() and pool.sum() == 30


def test_ring_and_ulysses_raise():
    """Outside shard_fn no mesh axis is bound: the port raises, as the
    reference does outside shard_map (the sharded paths:
    tests/test_torch_sharded.py)."""
    for impl in ("ring", "ulysses"):
        jcfg, tcfg = _configs("llama", attn_impl=impl)
        q = torch.zeros(1, 3, 4, 16)
        with pytest.raises(RuntimeError, match="no mesh is bound"):
            tg._attention(tcfg, q, q, q)
        jq = jnp.zeros((1, 3, 4, 16))
        with pytest.raises(NameError):
            jg._attention(jcfg, jq, jq, jq)

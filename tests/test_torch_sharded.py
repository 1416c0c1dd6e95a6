"""The port's sharded model (`ray_tpu_torch.models.gpt` with `mesh=`, and
under a whole-model `shard_fn`) against the reference on its 8-device fake
CPU mesh, f32, the same numpy weights and tokens, 8 gloo ranks (one world
for the module):

* the dp=2 × fsdp=2 × tp=2 train step (`tests/test_models.py:80`): params
  placed by `param_shardings`, two AdamW steps against the reference's
  jitted step with `optax.adamw` on the same mesh, in gpt2, gptj and llama
  styles (llama with remat "attn", so the saved flash op runs under
  DTensor);
* `global_positions` under sp (`tests/test_models.py:106`);
* ring attention at sp=8 and Ulysses at sp=2 in the model forward, under a
  whole-model shard_fn (`tests/test_models.py:125`): logits and the
  gradients of sum(logits · w) against the reference's own shard_map run;
* ring and Ulysses in automatic mode (`loss_fn(mesh=)`, sp=2 × dp=2 × tp=2):
  loss and gradients against the reference's pjit run;
* that automatic mode partitions the work: the shapes each rank computes
  on, and the local shape of each gradient.

Tolerances, those of `tests/test_torch_train.py`: loss, grad_norm 1e-4
relative; gradients 1e-4 of each tensor's largest entry; params after the
steps within 3·lr·2⁻⁸ (AdamW's bf16 first moment may round the other way
per step; eps 1e-3, see that file); logits 2e-4 (`tests/test_torch_gpt.py`).

This module's top level imports no JAX: the gloo ranks import it."""

import types

import numpy as np
import pytest
import torch

from torch_gloo import rank_results, run_world
from ray_tpu_torch.models import gpt as tg
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.parallel import P, make_mesh, place, shard_fn

WORLD = 8
GRAD_TOL = 1e-4
LOGIT_TOL = 2e-4
LR = 1e-2
HYPER = dict(weight_decay=0.1, eps=1e-3)

TINY = dict(vocab_size=256, n_layers=2, d_model=64, n_heads=4, d_head=16, d_mlp=128, max_seq=64,
            attn_impl="flash", remat=False)
STYLES = {
    "gpt2": dict(),
    "gptj": dict(pos="rotary", rotary_dim=8, parallel_block=True, tie_embeddings=False),
    "llama": dict(pos="rotary", rotary_dim=16, norm="rmsnorm", activation="swiglu", tie_embeddings=False,
                  remat=True, remat_policy="attn"),
}
# Context parallelism: (style, attn_impl, mesh sizes of the whole-model run)
CP = {
    "ring_sp8": ("gpt2", "ring", dict(sp=8)),
    "ring_sp8_llama": ("llama", "ring", dict(sp=8)),
    "ulysses_sp2": ("gptj", "ulysses", dict(sp=2, dp=4)),
}
AUTO_CP = {"ring": "gpt2", "ulysses": "llama"}
AUTO_CP_MESH = dict(sp=2, dp=2, tp=2)


def _kw(style, **over):
    kw = {**TINY, **STYLES[style], **over}
    if kw.get("attn_impl") != "flash":
        kw.update(remat=False, remat_policy=None)
    return kw


def _np_params(style, seed=0):
    shapes = {k: tuple(v.shape) for k, v in tg.init_params(
        tg.GPTConfig(**_kw(style), dtype=torch.float32), device="cpu").items()}
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in shapes.items():
        if name.startswith("b_") or name.endswith("_b"):
            a = 0.1 * rng.standard_normal(s)
        elif name.endswith("_w"):
            a = 1 + 0.1 * rng.standard_normal(s)
        else:
            a = 0.3 * rng.standard_normal(s)
        out[name] = a.astype(np.float32)
    return out


def _tokens(shape=(8, 17), seed=1):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], shape)


def _cotangent(shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _grads_np(params):
    return {k: (p.grad.full_tensor() if hasattr(p.grad, "full_tensor") else p.grad).numpy()
            if p.grad is not None else np.zeros(tuple(p.shape), np.float32) for k, p in params.items()}


# ------------------------------------------------------------ rank cases
def rank_train_step():
    from ray_tpu_torch.optim import AdamW

    mesh = make_mesh("cpu", dp=2, fsdp=2, tp=2)
    out = {}
    for style in STYLES:
        cfg = tg.GPTConfig(**_kw(style), dtype=torch.float32)
        shardings = tg.param_shardings(cfg, mesh)
        params = {k: place(v, mesh, shardings[k]).detach()
                  for k, v in params_from_jax(_np_params(style), cfg, device="cpu").items()}
        step = tg.make_train_step(cfg, AdamW(params.values(), lr=LR, mu_dtype=torch.bfloat16, **HYPER),
                                  mesh=mesh)
        metrics = []
        for _ in range(2):
            params, m = step(params, {"tokens": torch.as_tensor(_tokens())})
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        out[style] = {"metrics": metrics,
                      "params": {k: p.detach().full_tensor().numpy() for k, p in params.items()},
                      "w_qkv": [str(pl) for pl in params["w_qkv"].placements],
                      "tok_embed": [str(pl) for pl in params["tok_embed"].placements]}
    return out


def rank_global_positions():
    mesh = make_mesh("cpu", sp=8)
    cfg = tg.GPTConfig(**_kw("gpt2", attn_impl="ring"), dtype=torch.float32)
    fn = shard_fn(lambda _: tg.global_positions(cfg, 4)[None, :], mesh, P("sp"), P("sp"))
    return fn(torch.zeros(8)).full_tensor().numpy()


def rank_context_parallel():
    """Whole-model shard_fn: tokens split over sp, params replicated."""
    out = {}
    for name, (style, impl, sizes) in CP.items():
        mesh = make_mesh("cpu", **sizes)
        cfg = tg.GPTConfig(**_kw(style, attn_impl=impl), dtype=torch.float32)
        params = params_from_jax(_np_params(style), cfg, device="cpu")
        for p in params.values():
            p.requires_grad_(True)
        tokens = torch.as_tensor(_tokens((2, 64)))
        fn = shard_fn(lambda p, t: tg.forward(p, t, cfg), mesh, (P(), P(None, "sp")), P(None, "sp", None))
        logits = fn(params, tokens).full_tensor()
        (logits * torch.as_tensor(_cotangent(tuple(logits.shape)))).sum().backward()
        out[name] = {"logits": logits.detach().numpy(), "grads": _grads_np(params)}
    return out


def rank_context_parallel_auto():
    """loss_fn(mesh=): the attention core under shard_fn over sp."""
    mesh = make_mesh("cpu", **AUTO_CP_MESH)
    out = {}
    for impl, style in AUTO_CP.items():
        cfg = tg.GPTConfig(**_kw(style, attn_impl=impl), dtype=torch.float32)
        shardings = tg.param_shardings(cfg, mesh)
        params = {k: place(v, mesh, shardings[k]).detach().requires_grad_(True)
                  for k, v in params_from_jax(_np_params(style), cfg, device="cpu").items()}
        loss = tg.loss_fn(params, {"tokens": torch.as_tensor(_tokens((4, 33)))}, cfg, mesh=mesh)
        loss.backward()
        out[impl] = {"loss": loss.full_tensor().item(), "grads": _grads_np(params)}
    return out


def rank_partitioned_compute():
    """loss_fn(mesh=) on dp=2 × fsdp=2 × tp=2: the shapes the per-rank
    program computes on, and the local shape of each gradient."""
    mesh = make_mesh("cpu", dp=2, fsdp=2, tp=2)
    cfg = tg.GPTConfig(**_kw("llama"), dtype=torch.float32)
    shardings = tg.param_shardings(cfg, mesh)
    params = {k: place(v, mesh, shardings[k]).detach().requires_grad_(True)
              for k, v in params_from_jax(_np_params("llama"), cfg, device="cpu").items()}
    seen = {}
    attention, logits, block = tg._attention, tg._logits, tg._block

    def spy_attention(cfg, q, k, v):
        seen["q"] = tuple(q.shape)
        return attention(cfg, q, k, v)

    def spy_logits(params, x, cfg):
        out = logits(params, x, cfg)
        seen["logits"], seen["lm_head"] = tuple(out.shape), tuple(params["lm_head"].shape)
        return out

    def spy_block(cfg, rope_tables, x, p, positions, auto=False):
        seen["layer"] = {k: tuple(w.shape) for k, w in p.items()}
        return block(cfg, rope_tables, x, p, positions, auto)

    tg._attention, tg._logits, tg._block = spy_attention, spy_logits, spy_block
    try:
        tg.loss_fn(params, {"tokens": torch.as_tensor(_tokens())}, cfg, mesh=mesh).backward()
    finally:
        tg._attention, tg._logits, tg._block = attention, logits, block
    used = [k for k, p in params.items() if p.grad is not None]  # RMSNorm has no bias
    seen["grads"] = {k: tuple(params[k].grad.to_local().shape) for k in used}
    seen["params"] = {k: tuple(params[k].to_local().shape) for k in used}
    return seen


RANK_CASES = ["rank_train_step", "rank_global_positions", "rank_context_parallel", "rank_context_parallel_auto",
              "rank_partitioned_compute"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(__file__, RANK_CASES, WORLD, tmp_path_factory.mktemp("gloo"))


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from ray_tpu.models import gpt as jg
    from ray_tpu.parallel import make_mesh as jmake_mesh, shard_fn as jshard_fn

    return types.SimpleNamespace(jax=jax, jnp=jnp, optax=optax, P=JP, NamedSharding=NamedSharding, gpt=jg,
                                 make_mesh=jmake_mesh, shard_fn=jshard_fn)


def _jcfg(ref, style, **over):
    return ref.gpt.GPTConfig(**_kw(style, **over), dtype=ref.jnp.float32)


def _close_by_max(got, want, tol, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, f"{what}: max |d| {err:.3e} > {tol} x {scale:.3e}"


# ------------------------------------------------------------ tests
@pytest.mark.parametrize("style", list(STYLES))
def test_sharded_train_step_dp_fsdp_tp(style, world, ref):
    jax, jnp = ref.jax, ref.jnp
    mesh = ref.make_mesh(dp=2, fsdp=2, tp=2)
    cfg = _jcfg(ref, style)
    shardings = ref.gpt.param_shardings(cfg, mesh)
    params = {k: jax.device_put(jnp.asarray(v), shardings[k]) for k, v in _np_params(style).items()}
    opt = ref.optax.adamw(LR, mu_dtype=jnp.bfloat16, **HYPER)
    step = jax.jit(ref.gpt.make_train_step(cfg, opt))
    state = (params, opt.init(params))
    tokens = jax.device_put(jnp.asarray(_tokens(), jnp.int32), ref.NamedSharding(mesh, ref.P(("dp", "fsdp"), None)))
    want = []
    for _ in range(2):
        state, m = step(state, {"tokens": tokens})
        want.append((float(m["loss"]), float(m["grad_norm"])))
    for rank, got in enumerate(rank_results(world, "rank_train_step")):
        got = got[style]
        for (loss, gnorm), (j_loss, j_gnorm) in zip(got["metrics"], want):
            assert loss == pytest.approx(j_loss, rel=1e-4), f"rank {rank}"
            assert gnorm == pytest.approx(j_gnorm, rel=1e-4), f"rank {rank}"
        for k, v in state[0].items():
            np.testing.assert_allclose(got["params"][k], np.asarray(v), atol=3 * LR * 2**-8,
                                       err_msg=f"rank {rank} {k}")
        # Params keep their placements through the step: heads over tp, the
        # vocab over tp and embed over fsdp (the mesh: dp, fsdp, tp).
        assert got["w_qkv"] == ["R", "S(1)", "S(3)"]
        assert got["tok_embed"] == ["R", "S(1)", "S(0)"]


def test_global_positions_under_sp(world):
    for got in rank_results(world, "rank_global_positions"):
        np.testing.assert_array_equal(got.ravel(), np.arange(32))


@pytest.mark.parametrize("name", list(CP))
def test_context_parallel_model_matches_reference(name, world, ref):
    style, impl, sizes = CP[name]
    jax, jnp = ref.jax, ref.jnp
    mesh = ref.make_mesh(**sizes)
    cfg = _jcfg(ref, style, attn_impl=impl)
    params = {k: jnp.asarray(v) for k, v in _np_params(style).items()}
    tokens = jnp.asarray(_tokens((2, 64)), jnp.int32)
    fn = jax.jit(ref.shard_fn(lambda p, t: ref.gpt.forward(p, t, cfg), mesh,
                              in_specs=(ref.P(), ref.P(None, "sp")), out_specs=ref.P(None, "sp", None)))
    want = np.asarray(fn(params, tokens))
    plain = np.asarray(ref.gpt.forward(params, tokens, _jcfg(ref, style, attn_impl="ref")))
    np.testing.assert_allclose(want, plain, atol=LOGIT_TOL, rtol=LOGIT_TOL)  # the reference's own check
    w = _cotangent(want.shape)
    want_grads = jax.grad(lambda p: (fn(p, tokens) * w).sum())(params)
    for rank, got in enumerate(rank_results(world, "rank_context_parallel")):
        got = got[name]
        np.testing.assert_allclose(got["logits"], want, atol=LOGIT_TOL, rtol=LOGIT_TOL, err_msg=f"rank {rank}")
        for k, v in want_grads.items():
            _close_by_max(got["grads"][k], np.asarray(v), GRAD_TOL, f"rank {rank} d{k}")


@pytest.mark.parametrize("impl", list(AUTO_CP))
def test_context_parallel_on_the_mesh_matches_reference(impl, world, ref):
    jax, jnp = ref.jax, ref.jnp
    style = AUTO_CP[impl]
    mesh = ref.make_mesh(**AUTO_CP_MESH)
    cfg = _jcfg(ref, style, attn_impl=impl)
    shardings = ref.gpt.param_shardings(cfg, mesh)
    params = {k: jax.device_put(jnp.asarray(v), shardings[k]) for k, v in _np_params(style).items()}
    batch = {"tokens": jnp.asarray(_tokens((4, 33)), jnp.int32)}
    j_loss, j_grads = jax.jit(jax.value_and_grad(lambda p, b: ref.gpt.loss_fn(p, b, cfg, mesh)))(params, batch)
    for rank, got in enumerate(rank_results(world, "rank_context_parallel_auto")):
        got = got[impl]
        assert got["loss"] == pytest.approx(float(j_loss), rel=1e-4), f"rank {rank}"
        for k, v in j_grads.items():
            _close_by_max(got["grads"][k], np.asarray(v), GRAD_TOL, f"rank {rank} d{k}")


def test_automatic_mode_partitions_the_compute(world):
    """dp=2 × fsdp=2 × tp=2: each rank runs 2 of the 8 sequences, 2 of the 4
    heads and 128 of the 256 vocab entries; a block sees its weights whole
    over fsdp and split over tp; every gradient comes back as the local
    shard of its param."""
    E, H, Dh, F_, V = TINY["d_model"], TINY["n_heads"], TINY["d_head"], TINY["d_mlp"], TINY["vocab_size"]
    for rank, got in enumerate(rank_results(world, "rank_partitioned_compute")):
        assert got["q"] == (2, H // 2, 16, Dh), rank
        assert got["logits"] == (2, 16, V // 2) and got["lm_head"] == (E, V // 2), rank
        assert got["layer"]["w_qkv"] == (E, 3, H // 2, Dh) and got["layer"]["w_o"] == (H // 2, Dh, E)
        assert got["layer"]["w_in"] == (E, F_ // 2) and got["layer"]["w_out"] == (F_ // 2, E)
        assert got["grads"] == got["params"] and len(got["grads"]) >= 10, rank
        assert got["params"]["w_qkv"] == (2, E // 2, 3, H // 2, Dh)
        assert got["params"]["tok_embed"] == (V // 2, E // 2)

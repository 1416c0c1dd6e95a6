"""The port's Mixture-of-Experts (`ray_tpu_torch.ops.moe`, the MoE branch of
`ray_tpu_torch.models.gpt`) against the reference (`ray_tpu.ops.moe`,
`ray_tpu.models.gpt`) in f32 on the CPU, on the same numpy inputs: routing
(dispatch, combine, aux, capacity drops) for top-1 and top-2, the layer's
output and gradients in gelu and swiglu, expert parallelism (ep=4 × dp=2,
8 gloo ranks) against the unsharded reference at a capacity that drops
tokens, and a MoE GPT converted by `params_from_jax`.

Tolerances: routing decisions (which token, expert and slot) exactly; f32
values 1e-5 relative to each tensor's largest entry (sums in another
order); gradients 1e-4 of each tensor's largest entry, the bar of
`tests/test_torch_train.py`.

This module's top level imports no JAX: the gloo ranks import it."""

import types

import numpy as np
import pytest
import torch

from torch_gloo import rank_results, run_world
from ray_tpu_torch.models import gpt as tg
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.ops import moe as tmoe
from ray_tpu_torch.parallel import P, make_mesh, place

VAL_TOL = 1e-5
GRAD_TOL = 1e-4
WORLD = 8

# name -> MoEConfig fields (d_model 16, d_ff 32, f32), tokens [B, S, D]
LAYERS = {
    "top2_gelu": dict(num_experts=4, top_k=2, capacity_factor=1.25),
    "top1_gelu": dict(num_experts=4, top_k=1, capacity_factor=1.25),
    "top2_swiglu": dict(num_experts=4, top_k=2, capacity_factor=1.0, activation="swiglu"),
    "top2_drops": dict(num_experts=4, top_k=2, capacity_factor=0.5),
    "top1_drops": dict(num_experts=8, top_k=1, capacity_factor=0.5, activation="swiglu"),
}
# Expert parallel: ep=4 x dp=2, tokens [8, 16, 16] split over dp, 8 experts
# split over ep, capacity factors that drop tokens.
EP_LAYERS = {
    "ep_top2_drops": dict(num_experts=8, top_k=2, capacity_factor=0.5),
    "ep_top1_swiglu_drops": dict(num_experts=8, top_k=1, capacity_factor=0.75, activation="swiglu"),
}
EP_TOKENS = (8, 16, 16)


def _cfg(moe, fields, dtype):
    return moe.MoEConfig(d_model=16, d_ff=32, dtype=dtype, **fields)


def _layer_inputs(fields, shape=(2, 8, 16), seed=0):
    """numpy params (std 0.3: routing far from ties), tokens and the
    output cotangent."""
    rng = np.random.default_rng(seed)
    E, D, F_ = fields["num_experts"], 16, 32
    p = {"w_router": rng.standard_normal((D, E)), "w_in": rng.standard_normal((E, D, F_)),
         "w_out": rng.standard_normal((E, F_, D))}
    if fields.get("activation") == "swiglu":
        p["w_gate"] = rng.standard_normal((E, D, F_))
    p = {k: (0.3 * v).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    return p, x, w


def _torch_layer(fields, p, x, w):
    cfg = _cfg(tmoe, fields, torch.float32)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = tmoe.moe_forward(tp, tx, cfg)
    ((y * torch.tensor(w)).sum() + aux).backward()
    return y.detach().numpy(), aux.item(), {**{k: t.grad.numpy() for k, t in tp.items()}, "x": tx.grad.numpy()}


def _assert_close_by_max(got, want, tol, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, f"{what}: max |d| {err:.3e} > {tol} x {scale:.3e}"


# ------------------------------------------------------------ rank cases
def rank_expert_parallel():
    """Each EP layer on ep=4 x dp=2 from DTensors: output, aux and the
    gradients of sum(y * w) + aux."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_mesh("cpu", ep=4, dp=2)
    names = list(mesh.mesh_dim_names)
    out = {}
    for name, fields in EP_LAYERS.items():
        p, x, w = _layer_inputs(fields, EP_TOKENS, seed=7)
        cfg = _cfg(tmoe, fields, torch.float32)
        tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
        tx = torch.tensor(x, requires_grad=True)
        by_ep = [Shard(0) if a == "ep" else Replicate() for a in names]
        dp = {k: place(t, mesh, [Replicate()] * mesh.ndim if k == "w_router" else by_ep) for k, t in tp.items()}
        xd = place(tx, mesh, [Shard(0) if a == "dp" else Replicate() for a in names])
        y, aux = tmoe.moe_forward(dp, xd, cfg)
        yf = y.full_tensor()
        ((yf * torch.tensor(w)).sum() + aux.full_tensor()).backward()
        out[name] = {"y": yf.detach().numpy(), "aux": aux.full_tensor().item(),
                     "y_placements": [str(pl) for pl in y.placements],
                     "grads": {**{k: t.grad.numpy() for k, t in tp.items()}, "x": tx.grad.numpy()}}
    return out


GPT_STYLES = {
    "gpt2_moe": dict(mlp_type="moe", moe_experts=4, moe_top_k=2),
    "llama_moe_top1": dict(mlp_type="moe", moe_experts=4, moe_top_k=1, norm="rmsnorm", activation="swiglu",
                           pos="rotary", rotary_dim=16, tie_embeddings=False),
}
GPT_BASE = dict(vocab_size=64, n_layers=2, d_model=32, n_heads=2, d_head=16, d_mlp=64, max_seq=64,
                remat=False, moe_capacity_factor=0.75)


def _gpt_params(gpt, cfg, seed=0):
    """numpy params with the port's keys and shapes (the reference's), std
    0.3 matrices, random biases and norm weights."""
    shapes = {k: tuple(v.shape) for k, v in tg.init_params(
        tg.GPTConfig(**{**GPT_BASE, **cfg}, dtype=torch.float32), device="cpu").items()}
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


def _gpt_batch(seed=1, shape=(8, 17)):
    return np.random.default_rng(seed).integers(0, GPT_BASE["vocab_size"], shape)


GPT_MESHES = {"ep4_dp2": dict(ep=4, dp=2), "fsdp2_ep2_tp2": dict(fsdp=2, ep=2, tp=2)}


def rank_moe_gpt_sharded():
    """The MoE GPT's loss and gradients through `loss_fn(..., mesh=)` on
    each of `GPT_MESHES`, params placed by `param_shardings`."""
    return {mesh_name: _moe_gpt_sharded(make_mesh("cpu", **sizes)) for mesh_name, sizes in GPT_MESHES.items()}


def _moe_gpt_sharded(mesh):
    out = {}
    for style, kw in GPT_STYLES.items():
        cfg = tg.GPTConfig(**{**GPT_BASE, **kw}, dtype=torch.float32)
        np_params = _gpt_params(tg, kw)
        shardings = tg.param_shardings(cfg, mesh)
        params = {k: place(v, mesh, shardings[k]).detach().requires_grad_(True)
                  for k, v in params_from_jax(np_params, cfg, device="cpu").items()}
        loss = tg.loss_fn(params, {"tokens": torch.as_tensor(_gpt_batch())}, cfg, mesh=mesh)
        loss.backward()
        out[style] = {"loss": loss.full_tensor().item(),
                      "grads": {k: (p.grad.full_tensor().numpy() if p.grad is not None
                                    else np.zeros(p.shape, np.float32)) for k, p in params.items()},
                      "moe_w_in": [str(pl) for pl in shardings["moe_w_in"]]}
    return out


RANK_CASES = ["rank_expert_parallel", "rank_moe_gpt_sharded"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(__file__, RANK_CASES, WORLD, tmp_path_factory.mktemp("gloo"))


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jg
    from ray_tpu.ops import moe as jmoe

    return types.SimpleNamespace(jax=jax, jnp=jnp, moe=jmoe, gpt=jg)


def _jax_layer(ref, fields, p, x, w):
    cfg = _cfg(ref.moe, fields, ref.jnp.float32)

    def loss(params, x):
        y, aux = ref.moe.moe_forward(params, x, cfg)
        return (y * w).sum() + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = ref.jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        {k: ref.jnp.asarray(v) for k, v in p.items()}, ref.jnp.asarray(x))
    return np.asarray(y), float(aux), {**{k: np.asarray(v) for k, v in gp.items()}, "x": np.asarray(gx)}


# ------------------------------------------------------------ tests
@pytest.mark.parametrize("name", list(LAYERS))
def test_router_matches_reference(name, ref):
    """The same tokens, experts and slots, the same gate weights and aux;
    the drop cases really drop."""
    fields = LAYERS[name]
    p, x, _ = _layer_inputs(fields, (32, 16))
    jcfg, tcfg = _cfg(ref.moe, fields, ref.jnp.float32), _cfg(tmoe, fields, torch.float32)
    want, want_aux = ref.moe.moe_router(ref.jnp.asarray(x), ref.jnp.asarray(p["w_router"]), jcfg)
    got, got_aux = tmoe.moe_router(torch.tensor(x), torch.tensor(p["w_router"]), tcfg)
    want = np.asarray(want)
    assert got.shape == want.shape == (32, fields["num_experts"], tcfg.capacity(32))
    np.testing.assert_array_equal(got.numpy() > 0, want > 0)
    _assert_close_by_max(got.numpy(), want, VAL_TOL, "combine")
    assert got_aux.item() == pytest.approx(float(want_aux), rel=VAL_TOL)
    routed = (want > 0).sum(axis=(1, 2))
    choices = fields["top_k"] * 32
    if "drops" in name:
        assert routed.sum() < choices, "the capacity drops no token: the case proves nothing"
    else:
        assert 0 < routed.sum() <= choices


def test_router_drop_case_of_the_reference():
    """tests/test_moe.py::test_capacity_drops_tokens: identical tokens overflow."""
    cfg = tmoe.MoEConfig(num_experts=2, top_k=1, d_model=8, d_ff=16, capacity_factor=0.25)
    combine, _ = tmoe.moe_router(torch.ones(64, 8), tmoe.moe_init(cfg, seed=4, device="cpu")["w_router"], cfg)
    assert float((combine.sum(dim=(1, 2)) > 0).sum()) <= cfg.capacity(64)


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_output_and_grads_match_reference(name, ref):
    fields = LAYERS[name]
    p, x, w = _layer_inputs(fields)
    y, aux, grads = _torch_layer(fields, p, x, w)
    jy, jaux, jgrads = _jax_layer(ref, fields, p, x, w)
    _assert_close_by_max(y, jy, VAL_TOL, "y")
    assert aux == pytest.approx(jaux, rel=VAL_TOL)
    assert set(grads) == set(jgrads)
    for k in jgrads:
        _assert_close_by_max(grads[k], jgrads[k], GRAD_TOL, k)
    assert np.abs(grads["w_router"]).sum() > 0  # routing is learned


def test_moe_init_shapes_and_bf16_layer():
    cfg = tmoe.MoEConfig(num_experts=4, top_k=2, d_model=16, d_ff=32, activation="swiglu")
    params = tmoe.moe_init(cfg, seed=5, device="cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        "w_router": (16, 4), "w_in": (4, 16, 32), "w_out": (4, 32, 16), "w_gate": (4, 16, 32)}
    assert all(v.dtype == torch.float32 for v in params.values())
    y, aux = tmoe.moe_forward(params, torch.randn(2, 8, 16), cfg)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 8, 16) and torch.isfinite(aux)
    assert tmoe.MOE_LOGICAL_DIMS == {"w_router": ("embed", "experts"), "w_in": ("experts", "embed", "mlp"),
                                     "w_out": ("experts", "mlp", "embed"), "w_gate": ("experts", "embed", "mlp")}


@pytest.mark.parametrize("name", list(EP_LAYERS))
def test_expert_parallel_equals_the_unsharded_reference(name, world, ref):
    fields = EP_LAYERS[name]
    p, x, w = _layer_inputs(fields, EP_TOKENS, seed=7)
    jy, jaux, jgrads = _jax_layer(ref, fields, p, x, w)
    cfg = _cfg(ref.moe, fields, ref.jnp.float32)
    kept = np.asarray(ref.moe.moe_router(ref.jnp.asarray(x.reshape(-1, 16)), ref.jnp.asarray(p["w_router"]),
                                         cfg)[0]) > 0
    assert kept.sum() < fields["top_k"] * x.shape[0] * x.shape[1], "no token dropped: the case proves nothing"
    for rank, got in enumerate(rank_results(world, "rank_expert_parallel")):
        got = got[name]
        _assert_close_by_max(got["y"], jy, VAL_TOL, f"rank {rank} y")
        assert got["aux"] == pytest.approx(jaux, rel=VAL_TOL)
        assert got["y_placements"] == ["S(0)", "R"]  # tokens stay split over dp (the mesh: dp, ep)
        for k in jgrads:
            _assert_close_by_max(got["grads"][k], jgrads[k], GRAD_TOL, f"rank {rank} d{k}")


def _jax_gpt(ref, kw):
    jcfg = ref.gpt.GPTConfig(**{**GPT_BASE, **kw}, dtype=ref.jnp.float32)
    return jcfg, {k: ref.jnp.asarray(v) for k, v in _gpt_params(tg, kw).items()}


@pytest.mark.parametrize("style", list(GPT_STYLES))
def test_moe_gpt_forward_loss_and_grads_match_reference(style, ref):
    kw = GPT_STYLES[style]
    jcfg, jp = _jax_gpt(ref, kw)
    tcfg = tg.GPTConfig(**{**GPT_BASE, **kw}, dtype=torch.float32)
    tokens = _gpt_batch()
    j_logits, j_aux = ref.gpt.forward(jp, ref.jnp.asarray(tokens), jcfg, return_aux=True)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tcfg, device="cpu")
    assert "moe_w_in" in tp and "w_in" not in tp
    t_logits, t_aux = tg.forward(tp, torch.as_tensor(tokens), tcfg, return_aux=True)
    _assert_close_by_max(t_logits.detach().numpy(), np.asarray(j_logits), VAL_TOL, "logits")
    assert t_aux.item() == pytest.approx(float(j_aux), rel=VAL_TOL) and float(j_aux) > 0
    batch = {"tokens": tokens}
    j_loss, j_grads = ref.jax.value_and_grad(ref.gpt.loss_fn)(jp, {"tokens": ref.jnp.asarray(tokens)}, jcfg)
    for p in tp.values():
        p.requires_grad_(True)
    t_loss = tg.loss_fn(tp, {"tokens": torch.as_tensor(batch["tokens"])}, tcfg)
    t_loss.backward()
    assert t_loss.item() == pytest.approx(float(j_loss), rel=VAL_TOL)
    for k in j_grads:
        got = tp[k].grad.numpy() if tp[k].grad is not None else np.zeros(tp[k].shape, np.float32)
        _assert_close_by_max(got, np.asarray(j_grads[k]), GRAD_TOL, k)


@pytest.mark.parametrize("style", list(GPT_STYLES))
def test_moe_gpt_on_the_mesh_equals_the_unsharded_reference(style, world, ref):
    """loss_fn(mesh=) on ep=4 x dp=2: the experts split over ep, the batch
    over dp; loss and every gradient as the reference's unsharded step."""
    kw = GPT_STYLES[style]
    jcfg, jp = _jax_gpt(ref, kw)
    j_loss, j_grads = ref.jax.value_and_grad(ref.gpt.loss_fn)(jp, {"tokens": ref.jnp.asarray(_gpt_batch())},
                                                                jcfg)
    for rank, got in enumerate(rank_results(world, "rank_moe_gpt_sharded")):
        got = got["ep4_dp2"][style]
        assert got["moe_w_in"] == ["R", "S(1)"]  # the mesh (dp, ep): experts dim on ep
        assert got["loss"] == pytest.approx(float(j_loss), rel=VAL_TOL)
        for k in j_grads:
            _assert_close_by_max(got["grads"][k], np.asarray(j_grads[k]), GRAD_TOL, f"rank {rank} d{k}")


@pytest.mark.parametrize("style", list(GPT_STYLES))
def test_moe_gpt_on_an_fsdp_ep_tp_mesh_equals_the_unsharded_reference(style, world, ref):
    """loss_fn(mesh=) on fsdp=2 x ep=2 x tp=2: the batch and the embed dim
    over fsdp, the experts over ep, each expert's hidden units, the heads
    and the vocab over tp; loss and every gradient as the reference's
    unsharded step."""
    kw = GPT_STYLES[style]
    jcfg, jp = _jax_gpt(ref, kw)
    j_loss, j_grads = ref.jax.value_and_grad(ref.gpt.loss_fn)(jp, {"tokens": ref.jnp.asarray(_gpt_batch())},
                                                                jcfg)
    for rank, got in enumerate(rank_results(world, "rank_moe_gpt_sharded")):
        got = got["fsdp2_ep2_tp2"][style]
        assert got["moe_w_in"] == ["S(2)", "S(1)", "S(3)"]  # embed on fsdp, experts on ep, mlp on tp
        assert got["loss"] == pytest.approx(float(j_loss), rel=VAL_TOL)
        for k in j_grads:
            _assert_close_by_max(got["grads"][k], np.asarray(j_grads[k]), GRAD_TOL, f"rank {rank} d{k}")


@pytest.mark.parametrize("style", list(GPT_STYLES))
def test_moe_prefill_matches_reference(style, ref):
    kw = GPT_STYLES[style]
    jcfg, jp = _jax_gpt(ref, kw)
    tcfg = tg.GPTConfig(**{**GPT_BASE, **kw}, dtype=torch.float32)
    tokens = _gpt_batch(shape=(2, 9))
    want, _ = ref.gpt.prefill(jp, ref.jnp.asarray(tokens), jcfg, ref.gpt.init_cache(jcfg, 2, 16))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tcfg, device="cpu")
    got, _ = tg.prefill(tp, torch.as_tensor(tokens), tcfg, tg.init_cache(tcfg, 2, 16, device="cpu"))
    _assert_close_by_max(got.numpy(), np.asarray(want), VAL_TOL, "prefill logits")


def test_moe_gpt_trains():
    """tests/test_moe.py::test_moe_gpt_trains: 5 Adam steps on one batch of a
    MoE GPT with the port's own init memorize it."""
    from ray_tpu_torch.optim import AdamW

    cfg = tg.GPTConfig(vocab_size=128, n_layers=2, d_model=32, n_heads=2, d_head=16, d_mlp=64, max_seq=32,
                       attn_impl="ref", remat=False, mlp_type="moe", moe_experts=4, moe_top_k=2,
                       dtype=torch.float32)
    params = tg.init_params(cfg, seed=0, device="cpu")
    assert "moe_w_in" in params and "w_in" not in params
    step = tg.make_train_step(cfg, AdamW(params.values(), lr=1e-3, weight_decay=0.0))
    tokens = torch.randint(0, 128, (2, 33), generator=torch.Generator().manual_seed(1))
    losses = [step(params, {"tokens": tokens})[1]["loss"].item() for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_decode_and_paged_paths_refuse_moe_as_the_reference(ref):
    kw = GPT_STYLES["gpt2_moe"]
    jcfg, jp = _jax_gpt(ref, kw)
    tcfg = tg.GPTConfig(**{**GPT_BASE, **kw}, dtype=torch.float32)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tcfg, device="cpu")
    jnp = ref.jnp
    kv_j = {"k": jnp.zeros((2, 4, 2, 4, 16)), "v": jnp.zeros((2, 4, 2, 4, 16))}
    kv_t = tg.init_paged_cache(tcfg, 4, 4, device="cpu")
    one = torch.zeros(1, dtype=torch.long)
    cases = [
        (lambda: ref.gpt.decode_step(jp, jnp.zeros(1, jnp.int32), ref.gpt.init_cache(jcfg, 1, 8), jcfg),
         lambda: tg.decode_step(tp, one, tg.init_cache(tcfg, 1, 8, device="cpu"), tcfg)),
        (lambda: ref.gpt.prefill_paged(jp, jnp.zeros((1, 4), jnp.int32), 4, 0, jnp.zeros(2, jnp.int32), kv_j, jcfg),
         lambda: tg.prefill_paged(tp, torch.zeros(1, 4, dtype=torch.long), 4, 0, torch.zeros(2, dtype=torch.long),
                                  kv_t, tcfg)),
        (lambda: ref.gpt.decode_step_paged(jp, jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32),
                                           jnp.zeros((1, 2), jnp.int32), kv_j, jcfg),
         lambda: tg.decode_step_paged(tp, one, one, torch.zeros(1, 2, dtype=torch.long), kv_t, tcfg)),
        (lambda: ref.gpt.verify_step_paged(jp, jnp.zeros((1, 2), jnp.int32), jnp.zeros(1, jnp.int32),
                                           jnp.ones(1, jnp.int32), jnp.zeros((1, 2), jnp.int32), kv_j, jcfg),
         lambda: tg.verify_step_paged(tp, torch.zeros(1, 2, dtype=torch.long), one, torch.ones(1, dtype=torch.long),
                                      torch.zeros(1, 2, dtype=torch.long), kv_t, tcfg)),
    ]
    for j_call, t_call in cases:
        with pytest.raises(NotImplementedError) as j_err:
            j_call()
        with pytest.raises(NotImplementedError) as t_err:
            t_call()
        assert str(t_err.value) == str(j_err.value)

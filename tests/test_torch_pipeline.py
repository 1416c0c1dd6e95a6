"""The port's in-program GPipe pipeline (`ray_tpu_torch.parallel.pipeline`
and `models.gpt`'s pipeline half) against the reference on its 8-device
fake CPU mesh, f32, the same numpy weights and tokens, 8 gloo ranks (one
world for the module). The reference side runs as `tests/test_pipeline.py`
runs it.

* the tanh GPipe at pp=4 against the serial forward and its gradients
  (`tests/test_pipeline.py:57-97`), and split/merge with its error;
* gpt2- and llama-style `pipeline_loss_fn` at pp=4 and pp=2 against the
  reference's `pipeline_loss_fn` (loss 1e-5 relative, every gradient 1e-4
  of its largest entry) and its serial `loss_fn` (loss 2e-3 relative, the
  reference's own pipeline-vs-serial bar, `tests/test_pipeline.py:139`);
* pp=2 x fsdp=2 x tp=2 against the reference's serial `loss_fn` and
  `jax.grad` (the reference cannot run its own fsdp/tp-composed pipeline
  on the CPU, `tests/test_pipeline.py:23-28`);
* the MoE aux loss and the router's gradient (`:178`);
* the ring rejection (`:200`);
* two `make_pipeline_train_step` steps: params within 3·lr·2⁻⁸ of the
  reference's (AdamW's bf16 first moment may round the other way).

The world has 8 ranks, so a port mesh smaller than 8 along pp fills the
rest with dp (the batch split; a replica of the pipeline per dp rank),
where the reference builds its pp mesh on the first devices only.

This module's top level imports no JAX: the gloo ranks import it."""

import types

import numpy as np
import pytest
import torch

from torch_gloo import rank_results, run_world
from ray_tpu_torch.models import gpt as tg
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.parallel import (
    make_gpipe_fn,
    make_mesh,
    make_pipelined_loss_fn,
    merge_microbatches,
    place,
    split_microbatches,
    stack_stage_params,
)

WORLD = 8
GRAD_TOL = 1e-4
LR = 1e-2
HYPER = dict(weight_decay=0.1, eps=1e-3)
M = 2  # microbatches of the GPT cases

TINY = dict(vocab_size=128, n_layers=4, d_model=32, n_heads=2, d_head=16, d_mlp=64, max_seq=16,
            attn_impl="flash", remat=False)
STYLES = {
    "gpt2": dict(),
    "llama": dict(pos="rotary", rotary_dim=16, norm="rmsnorm", activation="swiglu", tie_embeddings=False,
                  remat=True, remat_policy="attn"),
    "moe": dict(n_layers=2, vocab_size=64, mlp_type="moe", moe_experts=2, moe_top_k=1),
}
# name -> (style, the port's mesh, the reference's mesh or None for serial only)
CASES = {
    "gpt2_pp4": ("gpt2", dict(pp=4, dp=2), dict(pp=4)),
    "gpt2_pp2": ("gpt2", dict(pp=2, dp=4), dict(pp=2)),
    "llama_pp4": ("llama", dict(pp=4, dp=2), dict(pp=4)),
    "llama_pp2": ("llama", dict(pp=2, dp=4), dict(pp=2)),
    "llama_pp2_fsdp2_tp2": ("llama", dict(pp=2, fsdp=2, tp=2), None),
    "moe_pp2": ("moe", dict(pp=2, dp=4), dict(pp=2)),
}
TRAIN = ("gpt2", dict(pp=2, dp=4), dict(pp=2))


def _kw(style):
    return {**TINY, **STYLES[style]}


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


def _tokens(style, shape=(8, 17), seed=1):
    return np.random.default_rng(seed).integers(0, _kw(style)["vocab_size"], shape)


def _tanh_stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _tanh_params(d, n_stages, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32),
             "b": (0.1 * rng.standard_normal(d)).astype(np.float32)} for _ in range(n_stages)]


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _staged(style, mesh, pp):
    cfg = tg.GPTConfig(**_kw(style), dtype=torch.float32)
    params = params_from_jax(_np_params(style), cfg, device="cpu")
    staged = tg.split_stage_params(params, cfg, pp)
    shardings = tg.pipeline_stage_shardings(cfg, mesh)
    return cfg, {k: place(v, mesh, shardings[k]).detach().requires_grad_(True) for k, v in staged.items()}


def _full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy()


def stack_np(per_stage):
    """stack_stage_params on torch tensors, back to numpy."""
    stacked = stack_stage_params([{k: torch.as_tensor(v) for k, v in p.items()} for p in per_stage])
    return {k: v.numpy() for k, v in stacked.items()}


# ------------------------------------------------------------ rank cases
def rank_gpipe_tanh():
    """The tanh stack at pp=4 (x dp=2): forward at d=8, B=16, M=4, and the
    gradients of the pipelined MSE at d=4, B=8, M=4."""
    mesh = make_mesh("cpu", pp=4, dp=2)
    stacked = {k: torch.as_tensor(v) for k, v in stack_np(_tanh_params(8, 4, 0)).items()}
    x = torch.as_tensor(_normal((16, 8), 1))
    y = make_gpipe_fn(_tanh_stage, mesh, num_microbatches=4)(stacked, split_microbatches(x, 4))
    out = {"y": merge_microbatches(torch.as_tensor(_full(y)))}
    stacked = {k: torch.as_tensor(v).requires_grad_(True) for k, v in stack_np(_tanh_params(4, 4, 2)).items()}
    loss_fn = make_pipelined_loss_fn(_tanh_stage, lambda y, t: ((y - t) ** 2).mean(), mesh, num_microbatches=4)
    loss = loss_fn(stacked, torch.as_tensor(_normal((8, 4), 3)), torch.as_tensor(_normal((8, 4), 4)))
    loss.backward()
    out["loss"] = loss.item()
    out["grads"] = {k: v.grad.numpy() for k, v in stacked.items()}
    return out


def rank_gpt_pipeline():
    out = {}
    for name, (style, sizes, _) in CASES.items():
        mesh = make_mesh("cpu", **sizes)
        cfg, params = _staged(style, mesh, sizes["pp"])
        loss = tg.pipeline_loss_fn(params, {"tokens": torch.as_tensor(_tokens(style))}, cfg, mesh, M)
        loss.backward()
        out[name] = {"loss": loss.full_tensor().item(),
                     "grads": tg.merge_stage_params({k: torch.as_tensor(_full(p.grad)) for k, p in params.items()
                                                     if p.grad is not None}, cfg)}
        out[name]["grads"] = {k: v.numpy() for k, v in out[name]["grads"].items()}
    return out


def rank_pipeline_train_step():
    from ray_tpu_torch.optim import AdamW

    style, sizes, _ = TRAIN
    mesh = make_mesh("cpu", **sizes)
    cfg, params = _staged(style, mesh, sizes["pp"])
    params = {k: v.detach() for k, v in params.items()}
    step = tg.make_pipeline_train_step(
        cfg, AdamW(params.values(), lr=LR, mu_dtype=torch.bfloat16, **HYPER), mesh, M)
    metrics = []
    for _ in range(2):
        params, m = step(params, {"tokens": torch.as_tensor(_tokens(style))})
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return {"metrics": metrics, "params": {k: _full(p) for k, p in params.items()},
            "w_qkv": [str(pl) for pl in params["w_qkv"].placements]}


RANK_CASES = ["rank_gpipe_tanh", "rank_gpt_pipeline", "rank_pipeline_train_step"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(__file__, RANK_CASES, WORLD, tmp_path_factory.mktemp("gloo"))


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import gpt as jg
    from ray_tpu.parallel import MeshSpec

    return types.SimpleNamespace(jax=jax, jnp=jnp, optax=optax, gpt=jg,
                                 mesh=lambda **sizes: MeshSpec(**sizes).build(
                                     jax.devices()[:int(np.prod(list(sizes.values())))]))


def _jcfg(ref, style):
    return ref.gpt.GPTConfig(**_kw(style), dtype=ref.jnp.float32)


def _close_by_max(got, want, tol, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, f"{what}: max |d| {err:.3e} > {tol} x {scale:.3e}"


# ------------------------------------------------------------ tests
def test_gpipe_matches_serial_forward_and_gradients(world, ref):
    jax, jnp = ref.jax, ref.jnp

    def stage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    expect = jnp.asarray(_normal((16, 8), 1))
    for p in _tanh_params(8, 4, 0):
        expect = stage(p, expect)
    per_stage = _tanh_params(4, 4, 2)
    stacked = {k: jnp.stack([jnp.asarray(p[k]) for p in per_stage]) for k in ("w", "b")}
    x, t = jnp.asarray(_normal((8, 4), 3)), jnp.asarray(_normal((8, 4), 4))

    def loss_serial(sp):
        y = x
        for i in range(4):
            y = stage({k: v[i] for k, v in sp.items()}, y)
        return jnp.mean((y - t) ** 2)

    want_loss, want_grads = jax.value_and_grad(loss_serial)(stacked)
    for rank, got in enumerate(rank_results(world, "rank_gpipe_tanh")):
        np.testing.assert_allclose(got["y"], np.asarray(expect), rtol=1e-5, atol=1e-5, err_msg=f"rank {rank}")
        assert got["loss"] == pytest.approx(float(want_loss), rel=1e-5)
        for k, v in want_grads.items():
            np.testing.assert_allclose(got["grads"][k], np.asarray(v), rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {rank} d{k}")


def test_microbatch_split_merge():
    x = torch.arange(24).reshape(12, 2)
    mb = split_microbatches(x, 3)
    assert mb.shape == (3, 4, 2)
    assert torch.equal(merge_microbatches(mb), x)
    with pytest.raises(ValueError, match="not divisible"):
        split_microbatches(x, 5)


def test_stage_params_split_merge_round_trip_as_leaves():
    cfg = tg.GPTConfig(**_kw("llama"), dtype=torch.float32)
    params = tg.init_params(cfg, device="cpu")
    staged = tg.split_stage_params(params, cfg, 2)
    assert staged["w_qkv"].shape == (2, 2, *params["w_qkv"].shape[1:])
    assert staged["tok_embed"].shape == params["tok_embed"].shape
    assert all(v.is_leaf for v in staged.values())
    merged = tg.merge_stage_params(staged, cfg)
    assert all(torch.equal(merged[k], params[k]) for k in params)
    with pytest.raises(ValueError, match="not divisible"):
        tg.split_stage_params(params, cfg, 3)


@pytest.mark.parametrize("name", list(CASES))
def test_gpt_pipeline_matches_reference(name, world, ref):
    style, _, ref_mesh = CASES[name]
    jax, jnp = ref.jax, ref.jnp
    cfg = _jcfg(ref, style)
    params = {k: jnp.asarray(v) for k, v in _np_params(style).items()}
    batch = {"tokens": jnp.asarray(_tokens(style), jnp.int32)}
    serial, serial_grads = jax.value_and_grad(lambda p: ref.gpt.loss_fn(p, batch, cfg))(params)
    want = want_grads = None
    if ref_mesh is not None:
        mesh = ref.mesh(**ref_mesh)
        staged = ref.gpt.split_stage_params(params, cfg, ref_mesh["pp"])
        want, want_grads = jax.jit(jax.value_and_grad(
            lambda p: ref.gpt.pipeline_loss_fn(p, batch, cfg, mesh, num_microbatches=M)))(staged)
        want_grads = ref.gpt.merge_stage_params(want_grads, cfg)
    # The reference's own pipeline-vs-serial bar; not for MoE, which routes
    # each microbatch alone (capacity and aux per microbatch).
    dense = style != "moe"
    if dense and want is not None:
        assert float(want) == pytest.approx(float(serial), rel=2e-3)
    for rank, got in enumerate(rank_results(world, "rank_gpt_pipeline")):
        got = got[name]
        if dense:
            assert got["loss"] == pytest.approx(float(serial), rel=2e-3), f"rank {rank}"
        if want is not None:
            assert got["loss"] == pytest.approx(float(want), rel=1e-5), f"rank {rank}"
        grads = want_grads if want_grads is not None else serial_grads
        for k, v in grads.items():
            if float(np.abs(np.asarray(v)).max()) == 0.0:  # a param the loss does not use
                assert k not in got["grads"] or not np.abs(got["grads"][k]).max(), k
                continue
            _close_by_max(got["grads"][k], np.asarray(v), GRAD_TOL, f"rank {rank} d{k}")
        if style == "moe":
            assert np.abs(got["grads"]["moe_router"]).sum() > 0, "router got no gradient"


def test_gpt_pipeline_rejects_ring_attention():
    cfg = tg.GPTConfig(**{**_kw("gpt2"), "attn_impl": "ring"}, dtype=torch.float32)
    params = tg.split_stage_params(tg.init_params(cfg, device="cpu"), cfg, 2)
    with pytest.raises(NotImplementedError, match="pp-manual"):
        tg.pipeline_loss_fn(params, {"tokens": torch.zeros((2, 17), dtype=torch.long)}, cfg, None, 2)


def test_pipeline_train_step_matches_reference(world, ref):
    jax, jnp = ref.jax, ref.jnp
    style, _, ref_mesh = TRAIN
    cfg = _jcfg(ref, style)
    mesh = ref.mesh(**ref_mesh)
    staged = ref.gpt.split_stage_params({k: jnp.asarray(v) for k, v in _np_params(style).items()}, cfg,
                                        ref_mesh["pp"])
    opt = ref.optax.adamw(LR, mu_dtype=jnp.bfloat16, **HYPER)
    step = jax.jit(ref.gpt.make_pipeline_train_step(cfg, opt, mesh, M))
    state = (staged, opt.init(staged))
    batch = {"tokens": jnp.asarray(_tokens(style), jnp.int32)}
    want = []
    for _ in range(2):
        state, m = step(state, batch)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    got = rank_results(world, "rank_pipeline_train_step")
    for rank, g in enumerate(got):
        for (loss, gnorm), (j_loss, j_gnorm) in zip(g["metrics"], want):
            assert loss == pytest.approx(j_loss, rel=1e-4), f"rank {rank}"
            assert gnorm == pytest.approx(j_gnorm, rel=1e-4), f"rank {rank}"
        for k, v in state[0].items():
            np.testing.assert_allclose(g["params"][k], np.asarray(v), atol=3 * LR * 2**-8,
                                       err_msg=f"rank {rank} {k}")
        # The stage dim stays on pp through the step (the mesh: pp, dp).
        assert g["w_qkv"] == ["S(0)", "R"]

"""The port's training step (`ray_tpu_torch.models.gpt` loss, remat and
`make_train_step`, `ray_tpu_torch.optim.AdamW`) against the JAX reference
(`ray_tpu.models.gpt`, optax) in f32 on the CPU, on tiny gpt2-style,
gptj-style and llama-style configs with the same weights and tokens (made
with numpy).

Tolerances: loss and every gradient within 1e-4 of the largest entry of
that gradient (f32 sums taken in another order; measured ~2e-5 at most);
AdamW on identical gradients within 1e-6 (the same f32 arithmetic); the
3-step trajectory within 3·lr·2⁻⁸ on the params (see that test)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt as jg
from ray_tpu_torch.models import gpt as tg
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.ops import attention as t_attention
from ray_tpu_torch.optim import AdamW

GRAD_TOL = 1e-4

BASE = dict(vocab_size=64, n_layers=2, d_model=48, n_heads=3, d_head=16, d_mlp=96,
            max_seq=64, remat=False)
STYLES = {
    "gpt2": dict(),
    "gptj": dict(pos="rotary", rotary_dim=8, parallel_block=True, tie_embeddings=False),
    "llama": dict(pos="rotary", rotary_dim=16, norm="rmsnorm", activation="swiglu",
                  tie_embeddings=False),
}


def _configs(style, **kw):
    kw = {**BASE, **STYLES[style], **kw}
    return jg.GPTConfig(**kw, dtype=jnp.float32), tg.GPTConfig(**kw, dtype=torch.float32)


def _np_params(jcfg, seed=0):
    """numpy params with the reference's keys and shapes; random biases and
    norm weights so that every gradient is exercised."""
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


def _batch(masked: bool, shape=(2, 13), seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, BASE["vocab_size"], shape)}
    if masked:
        batch["mask"] = (rng.random(shape) > 0.3).astype(np.float32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _torch_grads(tcfg, np_params, batch):
    tp = params_from_jax(np_params, tcfg, device="cpu")
    for p in tp.values():
        p.requires_grad_(True)
    loss = tg.loss_fn(tp, _torch_batch(batch), tcfg)
    loss.backward()
    # A param the loss does not use (RMSNorm biases) has no grad: zero, as in JAX.
    return loss.item(), {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
                         for k, p in tp.items()}


def _assert_grads_close(got, want, tol=GRAD_TOL):
    assert set(got) == set(want)
    for name in want:
        w = np.asarray(want[name])
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[name] - w).max())
        assert err <= tol * scale, f"{name}: max |d| {err:.3e} > {tol} x {scale:.3e}"


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("style", list(STYLES))
def test_loss_and_grads_match_jax(style, masked):
    jcfg, tcfg = _configs(style)
    np_params = _np_params(jcfg)
    batch = _batch(masked)
    j_loss, j_grads = jax.value_and_grad(jg.loss_fn)(
        {k: jnp.asarray(v) for k, v in np_params.items()}, _jax_batch(batch), jcfg)
    t_loss, t_grads = _torch_grads(tcfg, np_params, batch)
    np.testing.assert_allclose(t_loss, float(j_loss), rtol=1e-5)
    _assert_grads_close(t_grads, j_grads)


@pytest.mark.parametrize("style", list(STYLES))
def test_remat_policies_give_equal_grads_and_flash_runs(style, monkeypatch):
    """remat False / None / "dots" / "attn" give the same loss and grads;
    the flash forward runs once per layer without remat and under "attn"
    (its outputs are saved), twice when the block is recomputed."""
    calls = {"n": 0}
    fwd = t_attention._flash_fwd

    def counting_fwd(*args):
        calls["n"] += 1
        return fwd(*args)

    monkeypatch.setattr(t_attention, "_flash_fwd", counting_fwd)
    jcfg, _ = _configs(style)
    np_params = _np_params(jcfg)
    batch = _batch(masked=False)
    L = BASE["n_layers"]
    results = {}
    for remat, policy, forwards in ((False, None, L), (True, None, 2 * L), (True, "dots", 2 * L),
                                    (True, "attn", L)):
        _, tcfg = _configs(style, remat=remat, remat_policy=policy)
        calls["n"] = 0
        results[(remat, policy)] = _torch_grads(tcfg, np_params, batch)
        assert calls["n"] == forwards, f"remat={remat} policy={policy}: {calls['n']} flash forwards"
    want_loss, want = results[(False, None)]
    for key, (loss, grads) in results.items():
        assert loss == pytest.approx(want_loss, rel=1e-6), key
        _assert_grads_close(grads, want, tol=1e-6)


@pytest.mark.parametrize("kw", [dict(remat_policy="everything"),
                                dict(remat_policy="attn", attn_impl="ref")])
def test_remat_policy_errors_match_reference(kw):
    jcfg, tcfg = _configs("gpt2", remat=True, **kw)
    with pytest.raises(ValueError) as j_err:
        jg._remat_policy(jcfg)
    with pytest.raises(ValueError) as t_err:
        tg._remat_policy(tcfg)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_adamw_matches_optax_on_the_same_grads(mu_dtype):
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 5), "b": (11,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-4, 0)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(4)]
    opt = optax.adamw(3e-2, weight_decay=0.1, mu_dtype=jnp.bfloat16 if mu_dtype else None)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    topt = AdamW(tp.values(), lr=3e-2, weight_decay=0.1, mu_dtype=mu_dtype)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        topt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6)
    mu = state[0].mu
    for k, p in tp.items():
        t_mu = topt.state[p]["mu"]
        assert t_mu.dtype == (torch.bfloat16 if mu_dtype else torch.float32)
        np.testing.assert_allclose(t_mu.float().numpy(), np.asarray(mu[k], np.float32), atol=1e-6)
        assert topt.state[p]["nu"].dtype == torch.float32


@pytest.mark.parametrize("style", list(STYLES))
def test_train_step_trajectory_matches_optax(style):
    """3 steps of `make_train_step` with the port's AdamW (mu_dtype=bf16)
    against the reference's step with `optax.adamw(mu_dtype=bf16)`: loss,
    grad_norm and params. eps is 1e-3 here, not the default 1e-8: Adam
    divides each gradient element by its own size, so an element whose
    gradient is f32 cancellation noise (~1e-8; the two packages sum in
    other orders) would step by +lr in one package and -lr in the other;
    eps far above that noise keeps the comparison about the arithmetic.
    The params may differ by a bf16 rounding of the first moment per step
    (lr·2⁻⁸ each; the f32 grads differ in their last bits), so they are
    held to 3·lr·2⁻⁸, and loss and grad_norm, which follow the params, to
    1e-4."""
    jcfg, tcfg = _configs(style)
    np_params = _np_params(jcfg)
    batch = _batch(masked=False)
    hyper = dict(weight_decay=0.1, eps=1e-3)
    lr = 1e-2
    opt = optax.adamw(lr, mu_dtype=jnp.bfloat16, **hyper)
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    j_step = jax.jit(jg.make_train_step(jcfg, opt))
    state = (jp, opt.init(jp))
    tp = params_from_jax(np_params, tcfg, device="cpu")
    t_step = tg.make_train_step(tcfg, AdamW(tp.values(), lr=lr, mu_dtype=torch.bfloat16, **hyper))
    for _ in range(3):
        state, j_m = j_step(state, _jax_batch(batch))
        tp, t_m = t_step(tp, _torch_batch(batch))
        np.testing.assert_allclose(t_m["loss"].item(), float(j_m["loss"]), rtol=1e-4)
        np.testing.assert_allclose(t_m["grad_norm"].item(), float(j_m["grad_norm"]), rtol=1e-4)
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(state[0][k]),
                                       atol=3 * lr * 2**-8, err_msg=k)


@pytest.mark.parametrize("style", list(STYLES))
def test_loss_decreases(style):
    """As tests/test_models.py::test_variants_train: 10 AdamW steps on one
    batch of a tiny model with the port's own init must learn."""
    cfg = tg.GPTConfig(vocab_size=256, n_layers=2, d_model=64, n_heads=4, d_head=16, d_mlp=128,
                       max_seq=64, dtype=torch.float32, **STYLES[style])
    params = tg.init_params(cfg, seed=0, device="cpu")
    step = tg.make_train_step(cfg, AdamW(params.values(), lr=1e-3))
    tokens = torch.randint(0, cfg.vocab_size, (4, 33), generator=torch.Generator().manual_seed(1))
    losses = []
    for _ in range(10):
        params, metrics = step(params, {"tokens": tokens})
        losses.append(metrics["loss"].item())
    assert losses[-1] < losses[0] - 0.5, f"no learning: {losses[0]:.3f} -> {losses[-1]:.3f}"

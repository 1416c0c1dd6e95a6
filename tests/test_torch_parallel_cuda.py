"""The mesh path at one rank, as `chip_smoke.py`'s `parallel` phase drives
it, at small sizes: a one-rank world (`make_mesh`, every axis of size 1), a MoE
model trained through `make_train_step(mesh=)`, its loss and gradients
through the mesh against the plain path, the sharded step against the
plain step, and Ulysses / ring attention at sp=1 against the flash forward.

Each case runs twice: on the CPU over gloo (the rehearsal), and marked
`cuda` on the card over NCCL, where the mesh path runs the kernels and is
held against the plain path on the CPU. On the H100:

    python -m pytest --noconftest tests/test_torch_parallel_cuda.py -m cuda

Tolerances: f32 losses 1e-5 relative, gradients 1e-4 of each tensor's
largest entry (`tests/test_torch_train.py`); params after two AdamW steps
1e-5 (the same arithmetic); Ulysses at sp=1 bit for bit (its exchanges move
nothing); ring 2e-4 in f32 (`tests/test_torch_gpt.py`)."""

import dataclasses
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu_torch.models import gpt as tg
from ray_tpu_torch.optim import AdamW
from ray_tpu_torch.parallel import make_mesh, place

TINY = dict(vocab_size=128, n_layers=2, d_model=64, n_heads=4, d_head=16, d_mlp=128, max_seq=64,
            dtype=torch.float32)
MOE = dict(mlp_type="moe", moe_experts=4, moe_top_k=2, moe_capacity_factor=0.75)


@pytest.fixture(scope="module", params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def world(request, tmp_path_factory):
    """(device, mesh) of a one-rank world: gloo on the CPU, NCCL on the card."""
    device = request.param
    if device == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card (run on the H100: pytest -m cuda)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
    store = tmp_path_factory.mktemp("world") / "store"
    dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method=f"file://{store}",
                            world_size=1, rank=0, timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh(device)
        assert tuple(mesh.mesh_dim_names) == ("dp",) and tuple(mesh.mesh.shape) == (1,)
        yield device, mesh
    finally:
        dist.destroy_process_group()


def _placed(params, cfg, mesh):
    shardings = tg.param_shardings(cfg, mesh)
    return {k: place(v, mesh, shardings[k]).detach() for k, v in params.items()}


def _tokens(shape, seed=1):
    return torch.randint(0, TINY["vocab_size"], shape, generator=torch.Generator().manual_seed(seed))


def _close_by_max(got, want, tol, what):
    scale = max(want.abs().max().item(), 1e-30)
    err = (got - want).abs().max().item()
    assert err <= tol * scale, f"{what}: max |d| {err:.3e} > {tol} x {scale:.3e}"


def _local(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def test_moe_model_trains_through_the_mesh(world):
    from ray_tpu_torch.kernels.flash_fwd import flash_fwd

    device, mesh = world
    cfg = tg.GPTConfig(**TINY, **MOE, remat=True, remat_policy="attn")
    params = _placed(tg.init_params(cfg, seed=0, device=device), cfg, mesh)
    step = tg.make_train_step(cfg, AdamW(params.values(), lr=1e-3), mesh=mesh)
    batch = {"tokens": _tokens((4, 33)).to(device)}
    before = flash_fwd.launches
    losses = [step(params, batch)[1]["loss"].item() for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    if device == "cuda":  # one flash forward per layer and step (remat "attn" saves it)
        assert flash_fwd.launches - before == 5 * cfg.n_layers


def test_moe_loss_and_grads_through_the_mesh_equal_the_plain_path(world):
    device, mesh = world
    cfg = tg.GPTConfig(**TINY, **MOE, remat=True, remat_policy="attn")
    plain = tg.init_params(cfg, seed=1, device="cpu")
    placed = _placed({k: v.to(device) for k, v in plain.items()}, cfg, mesh)
    tokens = _tokens((2, 33), seed=5)
    for p in (*plain.values(), *placed.values()):
        p.requires_grad_(True)
    want = tg.loss_fn(plain, {"tokens": tokens}, cfg)
    want.backward()
    got = tg.loss_fn(placed, {"tokens": tokens.to(device)}, cfg, mesh=mesh)
    got.backward()
    assert got.full_tensor().item() == pytest.approx(want.item(), rel=1e-5)
    for k, p in plain.items():
        assert (p.grad is None) == (placed[k].grad is None), k
        if p.grad is not None:
            _close_by_max(_local(placed[k].grad).cpu(), p.grad, 1e-4, k)


@pytest.mark.parametrize("style", [dict(), dict(norm="rmsnorm", activation="swiglu", pos="rotary",
                                                tie_embeddings=False)], ids=["gpt2", "llama"])
def test_sharded_step_equals_the_plain_step(world, style):
    device, mesh = world
    cfg = tg.GPTConfig(**TINY, **style, remat=True, remat_policy="attn")
    batch = {"tokens": _tokens((4, 33)).to(device)}
    runs = {}
    for name, on in (("plain", None), ("mesh", mesh)):
        params = tg.init_params(cfg, seed=0, device=device)
        if on is not None:
            params = _placed(params, cfg, mesh)
        step = tg.make_train_step(cfg, AdamW(params.values(), lr=1e-2, mu_dtype=torch.bfloat16), mesh=on)
        losses = [step(params, batch)[1]["loss"].item() for _ in range(2)]
        runs[name] = (losses, {k: _local(p).detach().cpu() for k, p in params.items()})
    assert runs["mesh"][0] == pytest.approx(runs["plain"][0], rel=1e-5)
    for k, p in runs["plain"][1].items():
        torch.testing.assert_close(runs["mesh"][1][k], p, atol=1e-5, rtol=1e-5, msg=k)


def test_ulysses_and_ring_at_sp1_match_the_flash_forward(world):
    device, mesh = world
    cfg = tg.GPTConfig(**TINY, norm="rmsnorm", activation="swiglu", pos="rotary", tie_embeddings=False)
    plain = tg.init_params(cfg, seed=2, device=device)
    placed = _placed(plain, cfg, mesh)
    tokens = _tokens((2, 64), seed=4).to(device)
    with torch.no_grad():
        want = tg.forward(plain, tokens, cfg)
        got = {impl: tg.forward(placed, tokens, dataclasses.replace(cfg, attn_impl=impl), mesh=mesh).full_tensor()
               for impl in ("ulysses", "ring")}
    assert torch.equal(got["ulysses"], want)
    torch.testing.assert_close(got["ring"], want, atol=2e-4, rtol=2e-4)

"""The port's mesh, shardings, SPMD wrappers and in-program collectives
(`ray_tpu_torch.parallel`, `ray_tpu_torch.collective.ops`) against the
reference (`ray_tpu.parallel`, `ray_tpu.collective.ops`) on its 8-device
fake CPU mesh: the reference's cases of `tests/test_parallel.py`, each with
its gradient, run by 8 gloo ranks (`torch_gloo.run_world`, one world for
the whole module) on the same numpy inputs.

Tolerances: collectives move and sum f32 values, so outputs and gradients
are held to 1e-6 (sums in another order); placements, specs and ZeRO
vectors exactly.

This module's top level imports no JAX: the ranks import it. The reference
side runs in the pytest process, in fixtures."""

import types

import numpy as np
import pytest
import torch

from torch_gloo import rank_results, run_world
from ray_tpu_torch.collective import ops
from ray_tpu_torch.parallel import MeshSpec, P, ShardingRules, make_mesh, parallelize, shard_fn

WORLD = 8
TOL = 1e-6

# name -> (mesh sizes, per-rank function of (ops module, local x), in spec,
# out spec, global x shape). The function is the same code for both
# packages: their `ops` share the reference's API.
COLLECTIVES = {
    "psum": (dict(dp=8), lambda o, x: o.psum(x.sum(), "dp"), ("dp",), (), (8, 4)),
    "psum_two_axes": (dict(dp=2, fsdp=2, tp=2), lambda o, x: o.psum(x, ("dp", "fsdp")),
                      (("dp", "fsdp"),), (), (4, 3)),
    "pmean": (dict(dp=8), lambda o, x: o.pmean(x * x, "dp"), ("dp",), (), (8, 3)),
    "pmax": (dict(dp=8), lambda o, x: o.pmax(x, "dp"), ("dp",), (), (8, 3)),
    "pmin": (dict(dp=8), lambda o, x: o.allreduce_jit(x, "dp", op="min"), ("dp",), (), (8, 3)),
    "all_gather": (dict(sp=8), lambda o, x: o.all_gather(x, "sp", gather_axis=0), ("sp",), (), (8, 1)),
    "all_gather_untiled": (dict(sp=8), lambda o, x: o.all_gather(x, "sp", tiled=False, gather_axis=1),
                           ("sp",), (), (8, 2)),
    "ring_shift": (dict(sp=8), lambda o, x: o.ring_shift(x, "sp", 1), ("sp",), ("sp",), (8, 1)),
    "ring_shift_back": (dict(dp=2, sp=4), lambda o, x: o.ring_shift(x * x, "sp", -1), (("dp", "sp"),),
                        (("dp", "sp"),), (8, 3)),
    "ppermute_partial": (dict(sp=8), lambda o, x: o.ppermute(x, "sp", [(0, 3), (3, 0), (5, 6)]),
                         ("sp",), ("sp",), (8, 2)),
    "reduce_scatter": (dict(dp=8), lambda o, x: o.reduce_scatter(x, "dp", scatter_axis=0), (None,),
                       ("dp",), (8, 2)),
    "reduce_scatter_mean": (dict(dp=8), lambda o, x: o.reduce_scatter(x * x, "dp", scatter_axis=1, op="mean"),
                            (None,), (None, "dp"), (2, 16)),
    "all_to_all": (dict(sp=4, dp=2), lambda o, x: o.all_to_all(x, "sp", split_axis=1, concat_axis=0),
                   ("sp", None), (None, "sp"), (4, 8)),
    "all_to_all_heads": (dict(sp=4, dp=2), lambda o, x: o.all_to_all(x, "sp", split_axis=1, concat_axis=2),
                         ("dp", None, "sp", None), ("dp", "sp", None, None), (2, 8, 4, 3)),
    "all_to_all_untiled": (dict(sp=4, dp=2),
                           lambda o, x: o.all_to_all(x, "sp", split_axis=1, concat_axis=0, tiled=False),
                           (("dp", "sp"),), (None, ("dp", "sp")), (8, 4, 3)),
    "axis_index": (dict(dp=2, sp=4),
                   lambda o, x: x + 10 * o.axis_index(("dp", "sp")) + 100 * o.axis_size("sp"),
                   (("dp", "sp"),), (("dp", "sp"),), (8, 1)),
    "barrier": (dict(dp=8), lambda o, x: x * 2 + o.barrier_jit("dp"), ("dp",), ("dp",), (8, 2)),
}
NO_GRAD = {"pmax", "pmin"}


def _inputs(name):
    shape = COLLECTIVES[name][4]
    seed = sorted(COLLECTIVES).index(name)
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32), rng


def _weights(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ rank cases
def rank_collectives():
    """Each collective under shard_fn: its output, and the gradient of
    sum(out * w) for the input (w seeded after x)."""
    out = {}
    for name, (sizes, fn, in_spec, out_spec, _) in COLLECTIVES.items():
        try:
            mesh = make_mesh("cpu", **sizes)
            x_np, rng = _inputs(name)
            x = torch.tensor(x_np, requires_grad=True)
            y = shard_fn(lambda x: fn(ops, x), mesh, P(*in_spec), P(*out_spec))(x).full_tensor()
            w = torch.tensor(_weights(rng, tuple(y.shape)))
            try:
                (y * w).sum().backward()
                grad = x.grad.numpy()
            except NotImplementedError as e:
                grad = f"NotImplementedError: {e}"
            out[name] = {"out": y.detach().numpy(), "grad": grad}
        except Exception as e:  # recorded per collective, so one fault fails one test
            out[name] = f"{type(e).__name__}: {e}"
    return out


PLACEMENT_MESHES = [dict(dp=8), dict(dp=2, fsdp=2, tp=2), dict(ep=2, dp=4), dict(sp=4, tp=2)]
PLACEMENT_CFGS = {
    "gpt2": dict(),
    "llama": dict(norm="rmsnorm", activation="swiglu", pos="rotary", tie_embeddings=False),
    "moe": dict(mlp_type="moe", moe_experts=4),
    "moe_swiglu_gptj": dict(mlp_type="moe", moe_experts=4, activation="swiglu", parallel_block=True,
                            pos="rotary", tie_embeddings=False),
}


def _tiny(gpt, **kw):
    return gpt.GPTConfig(vocab_size=128, n_layers=2, d_model=32, n_heads=2, d_head=16, d_mlp=64, **kw)


def rank_placements():
    """`param_shardings` as placements, per mesh and config."""
    from ray_tpu_torch.models import gpt as tg

    out = {}
    for i, sizes in enumerate(PLACEMENT_MESHES):
        mesh = make_mesh("cpu", **sizes)
        for name, kw in PLACEMENT_CFGS.items():
            out[(i, name)] = {k: [str(p) for p in v]
                              for k, v in tg.param_shardings(_tiny(tg, **kw), mesh).items()}
    return out


def rank_parallelize():
    """The reference's `test_parallelize_dp_sum`, and its gradient."""
    mesh = make_mesh("cpu", dp=8)
    fn = parallelize(lambda x: (x * 2).sum(), mesh, in_shardings=P(("dp",)), out_shardings=P())
    x = torch.arange(16.0).reshape(16, 1).requires_grad_(True)
    out = fn(x)
    out.full_tensor().backward()
    return {"out": out.full_tensor().item(), "placements": [str(p) for p in out.placements],
            "grad": x.grad.numpy()}


def rank_manual_axes():
    """shard_fn manual over sp only: a ring shift over sp, then a product
    with a weight split over tp that DTensor partitions inside the body."""
    from torch.distributed.tensor import DTensor, Shard

    mesh = make_mesh("cpu", sp=2, tp=4)
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.standard_normal((4, 6)).astype(np.float32), requires_grad=True)
    w = torch.tensor(rng.standard_normal((6, 8)).astype(np.float32), requires_grad=True)
    w_dt = mesh_place(w, mesh, "tp", 1)

    def body(x, w):
        assert isinstance(x, DTensor) and isinstance(w, DTensor)
        assert tuple(x.device_mesh.mesh_dim_names) == ("tp",)
        y = ops.ring_shift(x.to_local(), "sp", 1)
        y = DTensor.from_local(y, x.device_mesh, x.placements, run_check=False) @ w
        assert y.placements[-1] == Shard(1)
        return y

    y = shard_fn(body, mesh, (P("sp"), P()), P("sp"), manual_axes=frozenset({"sp"}))(x, w_dt)
    full = y.full_tensor()
    (full * full).sum().backward()
    return {"out": full.detach().numpy(), "dx": x.grad.numpy(), "dw": w.grad.numpy(),
            "x": x.detach().numpy(), "w": w.detach().numpy()}


def mesh_place(t, mesh, axis, dim):
    from torch.distributed.tensor import Replicate, Shard

    from ray_tpu_torch.parallel import place

    names = list(mesh.mesh_dim_names)
    return place(t, mesh, [Shard(dim) if n == axis else Replicate() for n in names])


def rank_constrain():
    """constrain: a plain (global) tensor and a DTensor laid out by logical
    dims; the values stay the global ones."""
    from ray_tpu_torch.parallel import constrain

    mesh = make_mesh("cpu", dp=2, fsdp=2, tp=2)
    rules = ShardingRules.default()
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    a = constrain(x, mesh, rules, "batch", "mlp")
    b = constrain(a, mesh, rules, None, "embed")
    try:
        constrain(x, mesh, rules, "batch")
        rank_error = None
    except ValueError as e:
        rank_error = str(e)
    return {"a": [str(p) for p in a.placements], "a_local": a.to_local().numpy(), "b": [str(p) for p in b.placements],
            "b_full": b.full_tensor().numpy(), "rank_error": rank_error}


RANK_CASES = ["rank_collectives", "rank_placements", "rank_parallelize", "rank_manual_axes", "rank_constrain"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(__file__, RANK_CASES, WORLD, tmp_path_factory.mktemp("gloo"))


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from ray_tpu.collective import ops as jops
    from ray_tpu.models import gpt as jg
    from ray_tpu.parallel import make_mesh as jmake_mesh, shard_fn as jshard_fn

    assert len(jax.devices()) == WORLD
    return types.SimpleNamespace(jax=jax, jnp=jnp, P=JP, ops=jops, gpt=jg, make_mesh=jmake_mesh,
                                 shard_fn=jshard_fn)


# ------------------------------------------------------------ tests
@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collective_and_its_gradient_match_reference(name, world, ref):
    sizes, fn, in_spec, out_spec, _ = COLLECTIVES[name]
    mesh = ref.make_mesh(**sizes)
    x_np, rng = _inputs(name)
    f = ref.jax.jit(ref.shard_fn(lambda x: fn(ref.ops, x), mesh, in_specs=ref.P(*in_spec),
                                 out_specs=ref.P(*out_spec)))
    want = np.asarray(f(ref.jnp.asarray(x_np)))
    w = _weights(rng, want.shape)
    for rank, got in enumerate(rank_results(world, "rank_collectives")):
        got = got[name]
        assert not isinstance(got, str), f"rank {rank}: {got}"
        np.testing.assert_allclose(got["out"], want, atol=TOL, rtol=TOL, err_msg=f"rank {rank}")
        if name in NO_GRAD:
            with pytest.raises(NotImplementedError) as err:
                ref.jax.grad(lambda x: (f(x) * w).sum())(ref.jnp.asarray(x_np))
            assert got["grad"] == f"NotImplementedError: {err.value}"
            continue
        want_grad = np.asarray(ref.jax.grad(lambda x: (f(x) * w).sum())(ref.jnp.asarray(x_np)))
        np.testing.assert_allclose(got["grad"], want_grad, atol=TOL, rtol=TOL, err_msg=f"rank {rank}")


def test_collective_outputs_of_reference_cases(world):
    """The reference's own expected values (`tests/test_parallel.py`)."""
    got = rank_results(world, "rank_collectives")[0]
    assert got["psum"]["out"] == pytest.approx(float(_inputs("psum")[0].sum()), rel=1e-6)
    np.testing.assert_array_equal(got["ring_shift"]["out"].ravel(), np.roll(_inputs("ring_shift")[0].ravel(), 1))
    np.testing.assert_allclose(got["reduce_scatter"]["out"], 8.0 * _inputs("reduce_scatter")[0], rtol=1e-6)
    assert got["all_to_all"]["out"].shape == (4, 8)
    np.testing.assert_array_equal(got["all_gather"]["out"], _inputs("all_gather")[0])
    np.testing.assert_allclose(got["axis_index"]["out"] - _inputs("axis_index")[0],
                               (10 * np.arange(8) + 400)[:, None], rtol=1e-6)


def test_mesh_spec_resolve_matches_reference():
    from ray_tpu.parallel import MeshSpec as JMeshSpec

    for kw, n in [(dict(dp=-1, tp=4), 8), (dict(dp=3), 8), (dict(dp=-1, tp=-1), 8), (dict(sp=-1), 8),
                  (dict(ep=2, dp=-1), 8), (dict(fsdp=3, dp=-1), 8), (dict(), 1), (dict(tp=2), 1)]:
        try:
            want = JMeshSpec(**kw).resolve(n).sizes()
        except ValueError as e:
            with pytest.raises(ValueError) as err:
                MeshSpec(**kw).resolve(n)
            assert str(err.value) == str(e)
            continue
        assert MeshSpec(**kw).resolve(n).sizes() == want
    assert MeshSpec(dp=-1, tp=4).resolve(8).dp == 2


def test_make_mesh_raises_without_a_card_or_a_world(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no default process group"):
        make_mesh("cpu")


@pytest.mark.parametrize("cfg_name", list(PLACEMENT_CFGS))
def test_sharding_rules_spec_matches_reference(cfg_name, ref):
    from ray_tpu.parallel import ShardingRules as JRules

    from ray_tpu_torch.models import gpt as tg

    dims = tg.param_logical_dims(_tiny(tg, **PLACEMENT_CFGS[cfg_name]))
    assert dims == ref.gpt.param_logical_dims(_tiny(ref.gpt, **PLACEMENT_CFGS[cfg_name]))
    rules, jrules = ShardingRules.default(), JRules.default()
    for name, d in dims.items():
        assert tuple(rules.spec(*d)) == tuple(jrules.spec(*d)), name
    assert tuple(rules.spec("batch", "seq", "embed_act")) == (("dp", "fsdp"), "sp", None)
    with pytest.raises(KeyError, match="Unknown logical dim"):
        rules.spec("batch", "embedd")
    custom = rules.with_rules(embed=None, mlp=["tp", "ep"])
    assert custom.rules["embed"] is None and custom.rules["mlp"] == ("tp", "ep")
    assert custom.rules == jrules.with_rules(embed=None, mlp=["tp", "ep"]).rules


@pytest.mark.parametrize("mesh_i", range(len(PLACEMENT_MESHES)))
def test_placements_follow_reference_shardings(mesh_i, world, ref):
    """Each mesh axis that `sharding()` keeps in entry i is Shard(i) there,
    every other axis Replicate; the port's mesh has the axes of size > 1."""
    sizes = PLACEMENT_MESHES[mesh_i]
    mesh = ref.make_mesh(**sizes)
    got = rank_results(world, "rank_placements")
    for cfg_name, kw in PLACEMENT_CFGS.items():
        want_sh = ref.gpt.param_shardings(_tiny(ref.gpt, **kw), mesh)
        for name, sh in want_sh.items():
            want = []
            for axis in (a for a in ("pp", "dp", "fsdp", "sp", "ep", "tp") if sizes.get(a, 1) > 1):
                dims = [i for i, e in enumerate(sh.spec)
                        if e is not None and axis in ((e,) if isinstance(e, str) else e)]
                want.append(f"S({dims[0]})" if dims else "R")
            for rank in range(WORLD):
                assert got[rank][(mesh_i, cfg_name)][name] == want, (cfg_name, name, rank)


def test_placements_of_a_dim_over_two_axes_go_major_to_minor():
    """("dp", "fsdp") splits batch over dp first: DTensor's order for two
    Shard(0) in mesh order; the reverse order cannot be expressed."""
    from ray_tpu_torch.parallel import spec_placements

    mesh = types.SimpleNamespace(mesh_dim_names=("pp", "dp", "fsdp", "sp", "ep", "tp"), ndim=6,
                                 size=lambda i: (1, 2, 2, 1, 1, 2)[i])
    got = [str(p) for p in spec_placements(mesh, P(("dp", "fsdp"), "tp"))]
    assert got == ["R", "S(0)", "S(0)", "R", "R", "S(1)"]
    with pytest.raises(NotImplementedError, match="minor-to-major"):
        spec_placements(mesh, P(("fsdp", "dp")))
    with pytest.raises(ValueError, match="twice"):
        spec_placements(mesh, P("tp", "tp"))


def test_parallelize_dp_sum(world):
    got = rank_results(world, "rank_parallelize")
    x = np.arange(16.0)
    for r in got:
        assert r["out"] == pytest.approx(2 * x.sum())
        assert r["placements"] == ["R"]
        np.testing.assert_allclose(r["grad"], np.full((16, 1), 2.0))


def test_shard_fn_manual_axes_leaves_the_rest_to_dtensor(world):
    for r in rank_results(world, "rank_manual_axes"):
        x, w = r["x"], r["w"]
        y = np.concatenate([x[2:], x[:2]]) @ w  # ring shift by one shard of 2 rows
        np.testing.assert_allclose(r["out"], y, rtol=1e-5, atol=1e-5)
        dy = 2 * y
        np.testing.assert_allclose(r["dw"], np.concatenate([x[2:], x[:2]]).T @ dy, rtol=1e-5, atol=1e-5)
        dxs = dy @ w.T
        np.testing.assert_allclose(r["dx"], np.concatenate([dxs[2:], dxs[:2]]), rtol=1e-5, atol=1e-5)


def test_constrain_lays_out_by_logical_dims(world):
    x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    for rank, got in enumerate(rank_results(world, "rank_constrain")):
        # the mesh (dp, fsdp, tp): batch over dp then fsdp, mlp over tp
        assert got["a"] == ["S(0)", "S(0)", "S(1)"] and got["b"] == ["R", "S(1)", "R"]
        dp, fsdp, tp = rank // 4, (rank // 2) % 2, rank % 2
        rows = (2 * dp + fsdp) * 2
        np.testing.assert_array_equal(got["a_local"], x[rows:rows + 2, 3 * tp:3 * tp + 3])
        np.testing.assert_array_equal(got["b_full"], x)
        assert "1 logical dims for a 2-dim tensor" in got["rank_error"]


def test_zero_helpers_match_reference():
    from ray_tpu.collective import ops as jops

    rng = np.random.default_rng(3)
    state = {"w": rng.standard_normal((3, 4)).astype(np.float32),
             "b": rng.standard_normal(5).astype(np.float32),
             "inner": {"z": rng.standard_normal((2, 2)).astype(np.float32), "a": np.float32(2.5)}}
    want, jspec = jops.zero_flatten(state)
    got, spec = ops.zero_flatten({k: (torch.as_tensor(v) if not isinstance(v, dict) else
                                      {kk: torch.as_tensor(vv) for kk, vv in v.items()})
                                  for k, v in state.items()})
    np.testing.assert_array_equal(got.numpy(), want)
    back = ops.zero_unflatten(got, spec)
    assert back["inner"]["a"].shape == () and back["w"].dtype == torch.float32
    np.testing.assert_array_equal(back["w"].numpy(), state["w"])
    bf = ops.zero_unflatten(ops.zero_flatten({"x": torch.ones(3, dtype=torch.bfloat16)})[0],
                            ops.zero_flatten({"x": torch.ones(3, dtype=torch.bfloat16)})[1])
    assert bf["x"].dtype == torch.bfloat16
    for n in (0, 1, 7, 16, 1001):
        for world_size in (1, 3, 8):
            bounds = [ops.zero_shard_bounds(n, world_size, r) for r in range(world_size)]
            assert bounds == [jops.zero_shard_bounds(n, world_size, r) for r in range(world_size)]
            assert sum(e - s for s, e in bounds) == n
    assert ops.unreplicate({"a": torch.arange(6).reshape(3, 2)})["a"].tolist() == [0, 1]

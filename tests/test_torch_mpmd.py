"""The port's MPMD pipeline (`ray_tpu_torch.train.mpmd`, `models.gpt`'s
MPMD half) against the reference's (`ray_tpu.train.mpmd`), f32 on the CPU,
the same numpy weights and tokens.

The cases of `tests/test_train_mpmd.py` run on the port:
* the 1F1B and interleaved schedules (the port's copy gives the
  reference's op lists; invariants, deadlock freedom on depth-1 channels,
  the in-flight bound; `:41`, `:165`);
* the ZeRO comms, sharded vs replicated bit for bit, the reshard-restore
  across a dp change, and the update against the reference's (`:248-365`);
* the per-stage checkpoint layout (`:368`);
* the parity gate (`:418-629`): a llama-style config (RMSNorm, SwiGLU,
  rotary, untied, `attn_impl="flash"` so the kernel ops' CPU paths run,
  remat "attn") and a gpt2-style tied one, at (S, dp, M) = (2, 2, 2),
  (2, 1, 4) and v=2 with M = 2, 4, against the reference's unpipelined
  program (`_reference`, `:419-440`) and, at v=1, its `run_local_pipeline`,
  at its bars: losses rtol 2e-5, grad norms 2e-4, params rtol 1e-4 /
  atol 1e-5. The port's v=2 equals its v=1 bit for bit (the reference's
  own v=2 is not held: its test fails on this tree). The tied bridge keeps
  both tok_embed copies equal; zero on/off bit for bit with the optimizer
  bytes dp x apart; against the reference's GPipe on its fake 2-device
  mesh (loss 2e-3, grad norm 2e-2, `:460`); the partitionable checks; the
  wire codec's bf16 bits equal ml_dtypes'; the bf16 wire's loss curve;
* the stage functions' gradients against `loss_fn`'s (every leaf, and
  nonzero where the chunk uses it);
* the arena and span rungs (`:631`) and the SIGKILL reshape (`:664`) on
  the port's runtime in cluster mode.
"""

import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jg
from ray_tpu.train import mpmd as ref_mpmd
from ray_tpu_torch.models import gpt as tg
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.train.mpmd import (
    ReplicatedAdamW,
    ShardedAdamW,
    SoloComm,
    WireCodec,
    build_1f1b,
    build_interleaved_1f1b,
    make_local_comms,
    max_in_flight,
    run_local_pipeline,
    theoretical_bubble_fraction,
)
from ray_tpu_torch.train.mpmd.schedule import B, F

LR = 1e-3
TINY = dict(vocab_size=128, n_layers=4, d_model=32, n_heads=2, d_head=16, d_mlp=64, max_seq=16)
STYLES = {
    "llama": dict(pos="rotary", rotary_dim=16, norm="rmsnorm", activation="swiglu", tie_embeddings=False,
                  attn_impl="flash", remat=True, remat_policy="attn"),
    "gpt2_tied": dict(tie_embeddings=True, attn_impl="flash", remat=False),
}


# --------------------------------------------------------------------------
# Schedules (the copy) — no model
# --------------------------------------------------------------------------
_INTERLEAVE_GRID = [(S, M, v) for S in (2, 3, 4, 5) for v in (2, 3, 4) for M in (S, 2 * S, 4 * S)]


@pytest.mark.parametrize("S,M,v", [(1, 1, 1), (2, 4, 1), (4, 8, 1), (5, 2, 1)] + _INTERLEAVE_GRID[::3])
def test_schedule_is_the_references(S, M, v):
    for s in range(S):
        assert build_interleaved_1f1b(s, S, M, v) == ref_mpmd.build_interleaved_1f1b(s, S, M, v)
        assert max_in_flight(s, S, M, v) == ref_mpmd.max_in_flight(s, S, M, v)
        if v == 1:
            assert build_1f1b(s, S, M) == ref_mpmd.build_1f1b(s, S, M)
    assert theoretical_bubble_fraction(S, M, v) == ref_mpmd.theoretical_bubble_fraction(S, M, v)


@pytest.mark.parametrize("S,M", [(1, 1), (2, 2), (2, 4), (3, 3), (4, 8), (5, 2)])
def test_every_microbatch_once_and_ordered(S, M):
    for s in range(S):
        ops = build_1f1b(s, S, M)
        assert [i for op, i in ops if op == F] == list(range(M))
        assert [i for op, i in ops if op == B] == list(range(M))
        for i in range(M):
            assert ops.index((F, i)) < ops.index((B, i))


def _simulate_depth1(S, M, v):
    """Every stage's op list against depth-1 blocking channels (the
    reference test's simulation, `tests/test_train_mpmd.py:90`); returns the
    per-stage peak in-flight forward count, raises on a deadlock."""
    P = S * v
    lists = {s: build_interleaved_1f1b(s, S, M, v) for s in range(S)}
    pc = {s: 0 for s in range(S)}
    chan: dict = {}
    live = {s: 0 for s in range(S)}
    peak = {s: 0 for s in range(S)}

    def step(s, run):
        op, _, c = lists[s][pc[s]]
        vs = c * S + s
        kind = "a" if op == F else "g"
        src, dst = (vs - 1, vs + 1) if op == F else (vs + 1, vs - 1)
        need = vs > 0 if op == F else vs < P - 1
        out = (vs < P - 1) if op == F else vs > 0
        if not run:
            return not (need and chan.get((kind, src, vs), 0) < 1) and not (
                out and chan.get((kind, vs, dst), 0) >= 1)
        if need:
            chan[(kind, src, vs)] -= 1
        if out:
            chan[(kind, vs, dst)] = chan.get((kind, vs, dst), 0) + 1
        live[s] += 1 if op == F else -1
        peak[s] = max(peak[s], live[s])
        pc[s] += 1

    while any(pc[s] < len(lists[s]) for s in range(S)):
        ran = False
        for s in range(S):
            while pc[s] < len(lists[s]) and step(s, False):
                step(s, True)
                ran = True
        assert ran, f"deadlock: {({s: lists[s][pc[s]] for s in range(S) if pc[s] < len(lists[s])})}"
    return peak


@pytest.mark.parametrize("S,M,v", _INTERLEAVE_GRID)
def test_interleaved_complete_deadlock_free_and_bounded(S, M, v):
    every = {(i, c) for i in range(M) for c in range(v)}
    for s in range(S):
        ops = build_interleaved_1f1b(s, S, M, v)
        fwd = [(i, c) for op, i, c in ops if op == F]
        assert len(ops) == 2 * M * v and set(fwd) == every and len(set(fwd)) == len(fwd)
        for key in every:
            assert ops.index((F, *key)) < ops.index((B, *key))
    peak = _simulate_depth1(S, M, v)
    assert all(peak[s] == max_in_flight(s, S, M, v) for s in range(S)), peak


def test_schedule_validation_bubble_and_dp_picker():
    from ray_tpu_torch.train.mpmd.trainer import MPMDTrainer

    assert build_interleaved_1f1b(0, 2, 2, 2) == [
        (F, 0, 0), (F, 1, 0), (F, 0, 1), (F, 1, 1), (B, 0, 1), (B, 1, 1), (B, 0, 0), (B, 1, 0)]
    with pytest.raises(ValueError, match="num_stages > 1"):
        build_interleaved_1f1b(0, 1, 4, 2)
    with pytest.raises(ValueError, match="num_microbatches % num_stages"):
        build_interleaved_1f1b(0, 2, 3, 2)
    with pytest.raises(ValueError, match="out of range"):
        build_interleaved_1f1b(2, 2, 4, 2)
    assert theoretical_bubble_fraction(2, 4) == pytest.approx(0.2)
    assert theoretical_bubble_fraction(2, 4, 2) == pytest.approx(1 / 9)
    pick = MPMDTrainer._pick_dp
    assert [pick(f, 1, 4) for f in (0, 1, 2, 3, 4, 9)] == [1, 1, 2, 2, 4, 4]
    assert pick(3, 2, 4) == 2 and pick(1, 3, 4) == 4


# --------------------------------------------------------------------------
# ZeRO update
# --------------------------------------------------------------------------
def _run_dp(comms, fn):
    out, errs = [None] * len(comms), []

    def target(i):
        try:
            out[i] = fn(comms[i])
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=target, args=(i,)) for i in range(len(comms))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive(), "dp thread wedged"
    if errs:
        raise errs[0]
    return out


def test_local_comm_reduce_scatter_all_gather():
    comms = make_local_comms(3)
    vecs = [torch.arange(10, dtype=torch.float32) * (r + 1) for r in range(3)]
    outs = _run_dp(comms, lambda c: c.all_gather_flat(c.reduce_scatter_flat(vecs[c.rank])))
    for o in outs:
        assert torch.equal(o, sum(vecs))


def test_sharded_vs_replicated_bit_identical():
    """dp=4 over an odd flat length: the ZeRO path's params equal the
    replicated path's bit for bit, and its state covers the space once."""
    n, dp, steps = 1001, 4, 5
    rng = np.random.default_rng(0)
    init = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    grads = [[torch.from_numpy(rng.standard_normal(n).astype(np.float32)) for _ in range(dp)] for _ in range(steps)]

    def run(cls):
        opts = {}

        def worker(comm):
            opts[comm.rank] = opt = cls(init, comm, lr=1e-2, weight_decay=0.01)
            for t in range(steps):
                full, _ = opt.step(grads[t][comm.rank])
            return full

        return _run_dp(make_local_comms(dp), worker), opts

    (z_outs, z_opts), (r_outs, r_opts) = run(ShardedAdamW), run(ReplicatedAdamW)
    for zo, ro in zip(z_outs, r_outs):
        assert torch.equal(zo, ro) and torch.equal(zo, z_outs[0])
    rb = r_opts[0].optimizer_bytes
    assert rb == 3 * n * 4 and sum(o.optimizer_bytes for o in z_opts.values()) == rb
    assert max(o.optimizer_bytes for o in z_opts.values()) <= rb / dp + 3 * 4


def test_update_matches_the_references_and_solo_matches_dp1():
    """The port's f32 AdamW (in place, the reference's order of operations)
    against the reference's jitted update, over 5 steps; Sharded equals
    Replicated at dp=1."""
    rng = np.random.default_rng(2)
    n = 257
    init = rng.standard_normal(n).astype(np.float32)
    grads = [rng.standard_normal(n).astype(np.float32) for _ in range(5)]
    mine = ShardedAdamW(torch.from_numpy(init), SoloComm(), lr=1e-2, weight_decay=0.1)
    other = ReplicatedAdamW(torch.from_numpy(init), SoloComm(), lr=1e-2, weight_decay=0.1)
    ref = ref_mpmd.ShardedAdamW(init, ref_mpmd.SoloComm(), lr=1e-2, weight_decay=0.1)
    for g in grads:
        a, sa = mine.step(torch.from_numpy(g))
        b, _ = other.step(torch.from_numpy(g))
        r, sr = ref.step(g)
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-6, atol=1e-7)
        assert sa == pytest.approx(sr, rel=1e-12)


def test_reshard_restore_across_dp_change(tmp_path):
    from ray_tpu_torch.train.elastic import AsyncShardWriter, ShardedCheckpoint, stage_root
    from ray_tpu_torch.train.elastic.state import ElasticState

    n, dp = 37, 2
    init = torch.from_numpy(np.random.default_rng(1).standard_normal(n).astype(np.float32))
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(n).astype(np.float32))

    def worker(comm):
        opt = ShardedAdamW(init, comm, lr=1e-2)
        for _ in range(3):
            opt.step(g)
        return opt.ckpt_tree()

    trees = _run_dp(make_local_comms(dp), worker)
    root = stage_root(str(tmp_path), 0)
    writers = [AsyncShardWriter(root, r, dp, gen="g1", mode="sharded") for r in range(dp)]
    for r, w in enumerate(writers):
        st = ElasticState(step=3)
        st.record_pipeline(stage=0, num_stages=2)
        st.extra["opt_t"] = 3
        w.save(3, trees[r], st)
    assert all(w.flush() for w in writers)
    for w in writers:
        w.close()
    state, tree = ShardedCheckpoint.restore(root, 0, 1, step=3)
    state.check_pipeline(0, 2)
    with pytest.raises(ValueError, match="stage splits"):
        state.check_pipeline(1, 2)
    new = ShardedAdamW(init, SoloComm(), lr=1e-2)
    new.load_ckpt_tree(tree, t=state.extra["opt_t"])
    assert new.t == 3
    for name in ("master", "m", "v"):
        assert torch.equal(getattr(new, name), torch.cat([t[name] for t in trees]))
    with pytest.raises(ValueError, match="owns"):
        ShardedAdamW(init, make_local_comms(2)[0]).load_ckpt_tree(tree, t=3)


def test_latest_common_committed(tmp_path):
    from ray_tpu_torch.train.elastic import AsyncShardWriter, latest_common_committed, stage_root
    from ray_tpu_torch.train.elastic.state import ElasticState

    root = str(tmp_path)
    assert latest_common_committed(root, 2) is None
    writers = [AsyncShardWriter(stage_root(root, s), 0, 1, gen="g") for s in range(2)]
    for w in writers:
        w.save(1, {"x": torch.zeros(2)}, ElasticState(step=1))
        assert w.flush()
    step, dirs = latest_common_committed(root, 2)
    assert step == 1 and len(dirs) == 2
    writers[0].save(2, {"x": torch.ones(2)}, ElasticState(step=2))
    assert writers[0].flush()
    assert latest_common_committed(root, 2)[0] == 1
    for w in writers:
        w.close()


# --------------------------------------------------------------------------
# Parity gate
# --------------------------------------------------------------------------
def _configs(style):
    kw = {**TINY, **STYLES[style]}
    return jg.GPTConfig(**kw, dtype=jnp.float32), tg.GPTConfig(**kw, dtype=torch.float32)


def _np_params(jcfg, seed=0):
    return {k: np.asarray(v) for k, v in jg.init_params(jax.random.PRNGKey(seed), jcfg).items()}


BATCHES = [np.random.default_rng(1).integers(0, TINY["vocab_size"], (8, 9)) for _ in range(2)]
_CACHE: dict = {}


def _reference(style):
    """The reference test's unpipelined program (`tests/test_train_mpmd.py:419-440`):
    jax.value_and_grad of loss_fn and the reference's ReplicatedAdamW."""
    if ("ref", style) not in _CACHE:
        from ray_tpu.collective.ops import zero_flatten, zero_unflatten

        jcfg, _ = _configs(style)
        params = _np_params(jcfg)
        flat, spec = zero_flatten(params)
        opt = ref_mpmd.ReplicatedAdamW(flat, ref_mpmd.SoloComm(), lr=LR)
        p, losses, gnorms = params, [], []
        for batch in BATCHES:
            loss, grads = jax.value_and_grad(lambda q: jg.loss_fn(q, {"tokens": batch}, jcfg))(p)
            losses.append(float(loss))
            gnorms.append(float(jg.optax_global_norm(grads)))
            gflat, _ = zero_flatten(jax.tree_util.tree_map(np.asarray, grads))
            new_flat, _ = opt.step(gflat)
            p = zero_unflatten(new_flat, spec)
        _CACHE[("ref", style)] = ({k: np.asarray(v) for k, v in p.items()}, losses, gnorms)
    return _CACHE[("ref", style)]


def _port(style, S, dp, M, v=1, **kw):
    key = ("port", style, S, dp, M, v, tuple(sorted(kw.items())))
    if key not in _CACHE:
        jcfg, tcfg = _configs(style)
        params = params_from_jax(_np_params(jcfg), tcfg, device="cpu")
        _CACHE[key] = run_local_pipeline(tcfg, S, dp, M, BATCHES, params=params, lr=LR, num_chunks=v,
                                         device="cpu", **kw)
    return _CACHE[key]


def _assert_matches(out, losses, gnorms, params, check_gnorm=True):
    np.testing.assert_allclose([h["loss"] for h in out["history"]], losses, rtol=2e-5, atol=1e-6)
    if check_gnorm:
        np.testing.assert_allclose([h["grad_norm"] for h in out["history"]], gnorms, rtol=2e-4, atol=1e-5)
    assert set(out["params"]) == set(params)
    for k, val in out["params"].items():
        np.testing.assert_allclose(val.numpy(), params[k], rtol=1e-4, atol=1e-5, err_msg=k)


CASES = [(S, dp, M, v) for S, dp, M, v in ((2, 2, 2, 1), (2, 1, 4, 1), (2, 1, 2, 2), (2, 1, 4, 2))]


@pytest.mark.parametrize("style", sorted(STYLES))
@pytest.mark.parametrize("S,dp,M,v", CASES)
def test_mpmd_matches_unpipelined_reference(style, S, dp, M, v):
    """The port's pipeline against the reference's unpipelined program. The
    tied model's grad norm double-counts tok_embed (it sits in both boundary
    stages' accumulators by design), so only its losses and params are held."""
    ref_p, ref_losses, ref_gnorms = _reference(style)
    out = _port(style, S, dp, M, v)
    _assert_matches(out, ref_losses, ref_gnorms, ref_p, check_gnorm=style != "gpt2_tied")
    if style == "gpt2_tied":
        te = [out["runners"][s][0].chunk_params_host(c)["tok_embed"] for s, c in ((0, 0), (S - 1, v - 1))]
        assert torch.equal(te[0], te[1]), "bridge copies diverged"


@pytest.mark.parametrize("style", sorted(STYLES))
@pytest.mark.parametrize("S,dp,M", [(2, 2, 2), (2, 1, 4)])
def test_mpmd_matches_reference_pipeline(style, S, dp, M):
    """The port's run_local_pipeline against the reference's, v=1."""
    jcfg, _ = _configs(style)
    key = ("refpipe", style, S, dp, M)
    if key not in _CACHE:
        _CACHE[key] = ref_mpmd.run_local_pipeline(jcfg, S, dp, M, BATCHES, params=_np_params(jcfg), lr=LR)
    ref = _CACHE[key]
    _assert_matches(_port(style, S, dp, M), [h["loss"] for h in ref["history"]],
                    [h["grad_norm"] for h in ref["history"]], {k: np.asarray(v) for k, v in ref["params"].items()})


@pytest.mark.parametrize("style", sorted(STYLES))
@pytest.mark.parametrize("M", [2, 4])
def test_interleaved_equals_v1_bit_for_bit(style, M):
    """v=2 runs the same per-layer ops as v=1 and accumulates each chunk's
    microbatches in the same order: losses and params equal bit for bit."""
    one, two = _port(style, 2, 1, M), _port(style, 2, 1, M, 2)
    assert [h["loss"] for h in two["history"]] == [h["loss"] for h in one["history"]]
    for k, val in two["params"].items():
        assert torch.equal(val, one["params"][k]), k
    assert two["history"][0]["opt_bytes_per_replica"] == one["history"][0]["opt_bytes_per_replica"]


def test_zero_on_off_bit_identical_params():
    z, r = _port("llama", 2, 2, 2), _port("llama", 2, 2, 2, zero=False)
    for k in z["params"]:
        assert torch.equal(z["params"][k], r["params"][k]), k
    assert [h["loss"] for h in z["history"]] == [h["loss"] for h in r["history"]]
    zb, rb = z["history"][-1]["opt_bytes_per_replica"], r["history"][-1]["opt_bytes_per_replica"]
    assert 1.9 < rb / zb < 2.1


def test_mpmd_matches_the_references_gpipe():
    """The port's MPMD against the reference's single-program GPipe on its
    fake 2-device mesh (`tests/test_train_mpmd.py:460`), one step."""
    from ray_tpu.parallel import MeshSpec

    jcfg, tcfg = _configs("llama")
    params = _np_params(jcfg)
    batch = {"tokens": np.asarray(BATCHES[0])}
    mesh = MeshSpec(pp=2).build(jax.devices()[:2])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jg.pipeline_loss_fn(p, batch, jcfg, mesh, 2)))(jg.split_stage_params(params, jcfg, 2))
    gnorm = float(jg.optax_global_norm(jg.merge_stage_params(grads, jcfg)))
    out = run_local_pipeline(tcfg, 2, 1, 2, BATCHES[:1], params=params_from_jax(params, tcfg, device="cpu"),
                             lr=LR, device="cpu")
    np.testing.assert_allclose(out["history"][0]["loss"], float(loss), rtol=2e-3)
    np.testing.assert_allclose(out["history"][0]["grad_norm"], gnorm, rtol=2e-2)


def test_bf16_wire_loss_curve():
    f32, bf16 = _port("llama", 2, 1, 2), _port("llama", 2, 1, 2, wire_dtype="bf16")
    np.testing.assert_allclose([h["loss"] for h in bf16["history"]], [h["loss"] for h in f32["history"]],
                               rtol=2e-2)
    ws = bf16["wire_stats"]
    assert ws["frames"] > 0 and ws["wire_bytes"] * 2 == ws["raw_bytes"]
    assert f32["wire_stats"]["wire_bytes"] == f32["wire_stats"]["raw_bytes"]


def test_wire_codec_round_trip_and_bits_equal_ml_dtypes():
    rng = np.random.default_rng(3)
    arr = (rng.standard_normal((7, 500)) * 10.0 ** rng.integers(-30, 30, (7, 500))).astype(np.float32)
    arr[0, :6] = [np.inf, -np.inf, 0.0, -0.0, 1e-40, np.float32(1.0 + 2.0 ** -8)]  # a tie rounds to even
    w, meta = WireCodec("f32").encode(arr)
    assert w is arr and meta is None
    w, meta = WireCodec("bf16").encode(arr)
    assert w.dtype == np.uint16 and w.nbytes == arr.nbytes // 2
    assert np.array_equal(w, arr.astype(ml_dtypes.bfloat16).view(np.uint16))
    back = WireCodec("bf16").decode(w, meta)
    assert back.dtype == np.float32
    assert np.array_equal(back, w.view(ml_dtypes.bfloat16).astype(np.float32))
    with pytest.raises(ValueError, match="wire_dtype"):
        WireCodec("fp8")


def test_bf16_tensors_cross_an_edge_as_tagged_bits():
    from ray_tpu_torch.train.mpmd import LocalEdge
    from ray_tpu_torch.train.mpmd.transport import from_host, to_host

    t = torch.randn(3, 5).to(torch.bfloat16)
    arr, tag = to_host(t)
    assert arr.dtype == np.uint16 and torch.equal(from_host(arr, tag), t)
    e = LocalEdge(codec=WireCodec("bf16"))
    e.send(t)
    got = e.recv()
    assert got.dtype == torch.bfloat16 and torch.equal(got, t)
    e.send(torch.ones(4))
    assert torch.equal(e.recv(), torch.ones(4))


def test_partitionable_checks():
    tg.check_mpmd_partitionable(tg.gpt2_small(), 2)
    with pytest.raises(NotImplementedError, match="aux loss"):
        tg.check_mpmd_partitionable(tg.gpt2_small(mlp_type="moe"), 2)
    with pytest.raises(ValueError, match="num_stages > 1"):
        tg.check_mpmd_partitionable(tg.gpt2_small(), 1, num_chunks=2)
    with pytest.raises(ValueError, match="not divisible"):
        tg.check_mpmd_partitionable(tg.gpt2_small(), 5, num_chunks=2)
    with pytest.raises(ValueError, match="not divisible"):
        tg.extract_stage_params({}, tg.gpt2_small(), 0, 5)


@pytest.mark.parametrize("style", sorted(STYLES))
def test_stage_fns_give_loss_fns_gradients(style):
    """fwd / fwd_bwd / loss_bwd of two stages chained by hand: the loss and
    every gradient equal `loss_fn`'s (f32 sums in another order: 1e-5 of the
    largest entry), each leaf gets one, and no used leaf's is zero (a
    kernel op without a grad_fn would drop it silently)."""
    _, tcfg = _configs(style)
    params = params_from_jax(_np_params(_configs(style)[0], seed=4), tcfg, device="cpu")
    tokens = torch.as_tensor(BATCHES[0])
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want = tg.loss_fn(leaves, {"tokens": tokens}, tcfg)
    want.backward()
    stage = [tg.extract_stage_params(params, tcfg, s, 2) for s in range(2)]
    f0, f1 = (tg.make_mpmd_stage_fns(tcfg, s, 2) for s in range(2))
    y = f0["fwd"](stage[0], tokens[:, :-1])
    assert not y.requires_grad
    loss, g1, gx = f1["loss_bwd"](stage[1], y, tokens[:, 1:])
    g0, gx0 = f0["fwd_bwd"](stage[0], tokens[:, :-1], gx)
    assert gx0 is None and set(g0) == set(stage[0]) and set(g1) == set(stage[1])
    torch.testing.assert_close(loss, want.detach(), rtol=1e-6, atol=0)
    grads = dict(g0)
    for k, g in g1.items():  # layer slices stack; tied tok_embed's two partials add
        grads[k] = (torch.cat([grads[k], g]) if k in tg._LAYER_KEYS else grads[k] + g) if k in grads else g
    unused = {"ln1_b", "ln2_b", "ln_f_b"} if tcfg.norm == "rmsnorm" else set()
    for k, p in leaves.items():
        ref = p.grad if p.grad is not None else torch.zeros_like(p)
        assert grads[k].dtype == torch.float32
        assert (grads[k] - ref).abs().max() <= 1e-5 * max(ref.abs().max().item(), 1e-30), k
        assert bool(grads[k].abs().max() > 0) == (k not in unused), k


# --------------------------------------------------------------------------
# The port's runtime in cluster mode
# --------------------------------------------------------------------------
@pytest.mark.cluster
def test_arena_and_span_rungs():
    import ray_tpu_torch as rt
    from ray_tpu_torch.train.mpmd.transport import ActTransport

    rt.init(num_cpus=2)
    try:
        t = ActTransport(inline_max_bytes=0, timeout_s=30)
        arr = np.arange(100_000, dtype=np.float32)
        desc, pin = t.publish(arr)
        assert pin is not None and desc["span"] is not None
        np.testing.assert_array_equal(t.fetch(desc), arr)
        assert t.stats["fetch_local"] == 1
        np.testing.assert_array_equal(t.fetch({**desc, "name": None}), arr)
        assert t.stats["fetch_span"] == 1
        desc3, pin3 = t.publish(np.arange(16, dtype=np.float32))
        assert "inline" in desc3 and pin3 is None
        del pin
        with pytest.raises(RuntimeError, match="unreachable"):
            t.fetch({"hex": "0" * 28, "name": None, "span": (0, 4), "dtype": "<f4", "shape": (1,)})
    finally:
        rt.shutdown()


@pytest.mark.chaos
@pytest.mark.cluster
def test_sigkill_stage_member_reshapes_and_resumes(tmp_path):
    """SIGKILL a stage-1 replica mid-run (S=2, dp=2, ZeRO): the supervisor
    aborts the mesh, the pipeline re-spawns at the dp `_pick_dp` chooses,
    the stages restore at the common commit, the step counter runs to the
    total, and re-run steps repeat their losses."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api
    from ray_tpu_torch.train import FailureConfig, RunConfig
    from ray_tpu_torch.train.elastic import latest_common_committed
    from ray_tpu_torch.train.mpmd import MPMDOptions, MPMDTrainer

    cfg = tg.GPTConfig(vocab_size=128, n_layers=2, d_model=32, n_heads=2, d_head=16, d_mlp=64, max_seq=16,
                       dtype=torch.float32, attn_impl="ref", remat=False, tie_embeddings=False)
    total = 6

    def batch_fn(step):
        return np.random.default_rng(step).integers(0, 128, (8, 9))

    rt.init(num_cpus=4)
    try:
        trainer = MPMDTrainer(
            cfg, MPMDOptions(num_stages=2, dp=2, dp_min=1, dp_max=2, num_microbatches=2, zero=True,
                             step_timeout_s=60, ckpt_every=1, num_gpus_per_replica=0, device="cpu"),
            total_steps=total, batch_fn=batch_fn,
            run_config=RunConfig(storage_path=str(tmp_path),
                                 failure_config=FailureConfig(max_failures=2, backoff_base_s=0.25)))
        killed = {}

        def killer():
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                found = latest_common_committed(trainer.run_config.resolve_storage(), 2)
                if found and found[0] >= 2 and trainer.gang is not None:
                    break
                time.sleep(0.05)
            gang = trainer.gang
            if gang is None:
                return
            try:
                pid = api.get(gang.actors[(1, 0)].pid.remote(), timeout=10)
            except Exception:  # noqa: BLE001
                return
            os.kill(pid, signal.SIGKILL)
            killed["pid"], killed["t"] = pid, time.monotonic()

        th = threading.Thread(target=killer, daemon=True)
        th.start()
        res = trainer.fit()
        t_done = time.monotonic()
        sup = trainer._supervisor
        assert killed.get("pid"), "killer thread never fired"
        assert res["error"] is None, res["error"]
        assert res["attempts"] >= 1 and sup.last_recovery_s is not None and sup.last_recovery_s < 60
        assert t_done - killed["t"] < 90
        assert 1 <= res["dp"] <= 2
        assert sorted({h["step"] for h in res["history"]}) == list(range(1, total + 1))
        by_step = {}
        for h in res["history"]:
            by_step.setdefault(h["step"], []).append(h)
        for step, hs in by_step.items():
            same_dp = [h["loss"] for h in hs if h["dp"] == hs[0]["dp"]]
            assert all(x == same_dp[0] for x in same_dp), f"step {step} diverged across incarnations: {hs}"
        assert all(set(h["replicas"]) == {f"s{s}r{r}" for s in range(2) for r in range(h["dp"])}
                   for h in res["history"])
    finally:
        rt.shutdown()

"""The port's Serve (`ray_tpu_torch.serve`) on the CPU: the fleet policy
against the reference's own test cases, run on both packages; the handle,
HTTP and `@serve.batch` basics of `tests/test_serve.py`; `LLMDeployment`
returning the JAX engine's greedy tokens for the same params; the engine's
KV export and import (`TestDisaggEngineParity` of
`tests/test_serve_disagg.py`), a bf16 layout signature included; and in
cluster mode a two-pool (prefill, decode) deployment whose handoff imports
every full block, on replicas that ask for half a GPU each, which the
runtime places two to a card.

Expected tokens come from the JAX engine (`ray_tpu.serve.engine`) on the
TINY model of tests/test_serve_engine.py with its x3 params, converted by
`params_from_jax`; they are never written down. One local-mode runtime and
one small cluster for the whole module (the fixtures are here, not in
`tests/conftest.py`, which belongs to the reference)."""

import importlib
import importlib.util
import json
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models.gpt import GPTConfig as JConfig
from ray_tpu.models.gpt import init_params as j_init_params
from ray_tpu.serve.engine import EngineOptions as JOptions
from ray_tpu.serve.engine import InferenceEngine as JEngine
from ray_tpu_torch import serve
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.gpt import GPTConfig as TConfig
from ray_tpu_torch.serve.engine import EngineOptions, InferenceEngine

TINY = dict(vocab_size=64, n_layers=2, d_model=48, n_heads=3, d_head=16, d_mlp=96, max_seq=256,
            attn_impl="ref", remat=False, pos="rotary", rotary_dim=16, norm="rmsnorm",
            activation="swiglu")
OPTS = dict(num_blocks=64, block_size=4, max_num_seqs=4, seed=3)
PROMPT = [(7 * i + 3) % 60 + 1 for i in range(18)]  # 4 full blocks at block_size 4
N = 12


# ------------------------------------------------------------ fleet policy
def _reference_tests(name: str):
    """The reference's test module `name`, loaded under a private name (its
    globals are swapped per package below, so pytest's own copy is left
    alone)."""
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_port_reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FLEET = _reference_tests("test_serve_fleet")
DISAGG = _reference_tests("test_serve_disagg")
POLICY_CASES = [(cls, name) for cls in (FLEET.TestRoutingPolicy, FLEET.TestAutoscalePolicy,
                                        DISAGG.TestDisaggPolicy)
                for name in sorted(vars(cls)) if name.startswith("test_")]


@pytest.mark.parametrize("package", ["ray_tpu", "ray_tpu_torch"])
@pytest.mark.parametrize("cls,name", POLICY_CASES, ids=[f"{c.__name__}.{n}" for c, n in POLICY_CASES])
def test_fleet_policy_agrees_with_the_reference(package, cls, name, monkeypatch):
    """Each case of the reference's routing, autoscaling and disaggregated
    pool policy tests, run once against the reference's `serve.fleet` (and
    its kv_manager, whose content hash the router shares) and once against
    the port's copies: both must pass the same assertions."""
    fleet = importlib.import_module(f"{package}.serve.fleet")
    kv_manager = importlib.import_module(f"{package}.serve.engine.kv_manager")
    for attr in ("FleetSignals", "decide_scale", "pick_replica", "routing_chain"):
        monkeypatch.setattr(FLEET, attr, getattr(fleet, attr))
    monkeypatch.setattr(FLEET, "KVBlockManager", kv_manager.KVBlockManager)
    # TestDisaggPolicy imports `ray_tpu.serve.fleet` inside each test.
    monkeypatch.setitem(sys.modules, "ray_tpu.serve.fleet", fleet)
    getattr(cls(), name)()


# ------------------------------------------------------------ models
@pytest.fixture(scope="module")
def models():
    jcfg = JConfig(**TINY, dtype=jnp.float32)
    tcfg = TConfig(**TINY, dtype=torch.float32)
    jp = jax.tree_util.tree_map(lambda a: a * 3.0, j_init_params(jax.random.PRNGKey(3), jcfg))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _jax_tokens(models, prompts, n, **opts):
    jcfg, jp, _, _ = models
    e = JEngine(jcfg, params=jp, options=JOptions(**{**OPTS, **opts}))
    e.start()
    try:
        out = [e.generate(p, n) for p in prompts]
    finally:
        e.shutdown()
    assert len({t for o in out for t in o}) > 3, "degenerate decode: parity proves nothing"
    return out


def _engine(models, **opts):
    _, _, tcfg, tp = models
    e = InferenceEngine(tcfg, params=tp, options=EngineOptions(**{**OPTS, **opts}), device="cpu")
    e.start()
    return e


# ------------------------------------------------------------ runtimes
@pytest.fixture(scope="module")
def runtime(request):
    """One runtime per mode for the module: "local" (in process) or
    "cluster" (processes; one advertised GPU without a card, so
    `num_gpus` actors run in GPU workers that are given none)."""
    if request.param == "local":
        rt.init(local_mode=True)
    else:
        rt.init(num_cpus=4, num_gpus=1)
    serve.start(http_options={"host": "127.0.0.1", "port": 0})
    try:
        yield request.param
    finally:
        serve.shutdown()
        rt.shutdown()


def _post(route: str, body: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{serve.http_port()}{route}",
                                 data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("runtime", ["local"], indirect=True)
def test_handle_methods_and_function_deployments(runtime):
    @serve.deployment(num_replicas=2)
    class Doubler:
        def __call__(self, x):
            return 2 * x

        def triple(self, x):
            return 3 * x

    @serve.deployment
    def reverse(s):
        return s[::-1]

    handle = serve.run(Doubler.bind(), name="double", route_prefix="/double")
    assert handle.remote(21).result() == 42
    assert handle.triple.remote(5).result() == 15
    st = serve.status()["applications"]["double"]
    assert st["status"] == "RUNNING"
    assert st["deployments"]["Doubler"]["replica_states"]["RUNNING"] == 2
    assert serve.run(reverse.bind(), name="fn", route_prefix="/fn").remote("abc").result() == "cba"
    serve.delete("double")
    serve.delete("fn")
    assert "double" not in serve.status()["applications"]


@pytest.mark.parametrize("runtime", ["local"], indirect=True)
def test_router_side_batching(runtime):
    @serve.deployment
    class BatchModel:
        def __init__(self):
            self.sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def predict(self, xs):
            self.sizes.append(len(xs))
            return [x * x for x in xs]

        def seen(self):
            return self.sizes

    handle = serve.run(BatchModel.bind(), name="batch", route_prefix="/batch")
    responses = [handle.predict.remote(i) for i in range(8)]
    assert [r.result(timeout_s=10) for r in responses] == [i * i for i in range(8)]
    sizes = handle.seen.remote().result()
    assert max(sizes) > 1 and sum(sizes) == 8, sizes
    serve.delete("batch")


@pytest.mark.parametrize("runtime", ["local"], indirect=True)
def test_http_ingress(runtime):
    @serve.deployment
    class Echo:
        def __call__(self, request: serve.Request):
            if request.method == "POST":
                data = request.json()
                return {"sum": data["a"] + data["b"]}
            return {"path": request.path, "q": request.query_params}

    serve.run(Echo.bind(), name="http", route_prefix="/echo")
    assert _post("/echo", {"a": 2, "b": 3}) == {"sum": 5}
    with urllib.request.urlopen(f"http://127.0.0.1:{serve.http_port()}/echo/sub?x=1", timeout=60) as r:
        got = json.loads(r.read())
    assert got["path"] == "/sub" and got["q"] == {"x": "1"}  # the path below the route prefix
    serve.delete("http")


@pytest.mark.parametrize("runtime", ["local"], indirect=True)
def test_llm_deployment_returns_the_jax_engines_tokens(runtime, models):
    """`LLMDeployment` with the port's params (converted from the JAX
    params): blocking, streamed and HTTP generations equal the JAX engine's
    greedy tokens."""
    prompts = [PROMPT, [(5 * i + 2) % 60 + 1 for i in range(13)]]
    want = _jax_tokens(models, prompts, N)
    app = serve.LLMDeployment.bind(model="gpt2-small", model_overrides={**TINY, "dtype": "float32"},
                                   engine_options=OPTS, params=models[3], device="cpu")
    handle = serve.run(app, name="llm", route_prefix="/llm", timeout_s=120)
    for p, w in zip(prompts, want):
        res = handle.generate.remote(p, N).result(timeout_s=60)
        assert res["tokens"] == w and res["finish_reason"] == "length"
    assert list(handle.options(stream=True).generate_stream.remote(prompts[1], N)) == want[1]
    assert _post("/llm", {"prompt": prompts[0], "max_new_tokens": N})["tokens"] == want[0]
    stats = handle.engine_stats.remote().result()
    assert stats["total_finished"] == 4 and stats["prefix_cache_hits"] > 0
    serve.delete("llm")


# ------------------------------------------------------- engine handoff
def test_disagg_handoff_matches_colocated_decoding(models):
    """Prefill on engine P, export, import on engine D, decode after the
    handed-off first token: the colocated tokens (which are the JAX
    engine's), with every exported block imported and hit at admission."""
    want = _jax_tokens(models, [PROMPT], N)[0]
    colo = _engine(models)
    try:
        assert colo.generate(PROMPT, N) == want
    finally:
        colo.shutdown()
    pre = _engine(models, role="prefill")
    try:
        first = list(pre.stream(pre.submit(PROMPT, 1)))
        desc = pre.export_prompt_kv(PROMPT)
        assert desc is not None and len(desc["digests"]) == len(PROMPT) // 4
        assert pre.stats()["blocks_exported"] == len(PROMPT) // 4
    finally:
        pre.shutdown()
    dec = _engine(models, role="decode")
    try:
        imported = dec.import_blocks(desc)
        assert imported == len(desc["digests"])
        rest = dec.generate(PROMPT + first, N - 1)
        st = dec.stats()
    finally:
        dec.shutdown()
    assert first + rest == want
    assert st["prefix_cache_hits"] >= imported and st["blocks_imported"] == imported
    assert st["role"] == "decode"


def test_disagg_without_descriptor_recomputes(models):
    prompt = [(11 * i + 5) % 60 + 1 for i in range(13)]
    want = _jax_tokens(models, [prompt], 8)[0]
    pre = _engine(models, role="prefill")
    try:
        first = list(pre.stream(pre.submit(prompt, 1)))
    finally:
        pre.shutdown()
    dec = _engine(models, role="decode")
    try:
        assert dec.import_blocks(None) == 0
        assert first + dec.generate(prompt + first, 7) == want
        assert dec.stats()["blocks_imported"] == 0
    finally:
        dec.shutdown()


def test_import_rejects_a_mismatched_layout(models):
    pre = _engine(models)
    try:
        list(pre.stream(pre.submit(PROMPT, 1)))
        desc = pre.export_prompt_kv(PROMPT)
    finally:
        pre.shutdown()
    assert desc is not None
    other = _engine(models, block_size=8)
    try:
        assert other.import_blocks(desc) == 0, "imported KV across block layouts"
    finally:
        other.shutdown()


def test_bf16_blocks_round_trip_and_an_f32_engine_rejects_them(models):
    """A bf16 pool names its dtype in the layout signature ("bfloat16", not
    the int16 its bits travel as): a bf16 engine imports the blocks bit for
    bit, an f32 engine of the same geometry refuses them."""
    _, _, tcfg, tp = models
    cfg16 = TConfig(**TINY, dtype=torch.bfloat16)
    p16 = {k: v.to(torch.bfloat16) for k, v in tp.items()}

    def engine(cfg, params):
        e = InferenceEngine(cfg, params=params, options=EngineOptions(**OPTS), device="cpu")
        e.start()
        return e

    pre = engine(cfg16, p16)
    try:
        list(pre.stream(pre.submit(PROMPT, 1)))
        desc = pre.export_prompt_kv(PROMPT)
        assert desc["sig"].endswith(":bfloat16") and desc["dtype"] == np.dtype(np.int16).str
        src = {h: b for h, b in zip(desc["digests"],
                                    pre.block_manager.export_sources([bytes.fromhex(h)
                                                                      for h in desc["digests"]]))}
        src_blocks = [b for kind, b in src.values() if kind == "hbm"]
        src_kv = {n: a[:, src_blocks].clone() for n, a in pre.kv.items()}
    finally:
        pre.shutdown()
    f32 = engine(tcfg, tp)
    try:
        assert f32.import_blocks(desc) == 0
    finally:
        f32.shutdown()
    dec = engine(cfg16, p16)
    try:
        assert dec.import_blocks(desc) == len(PROMPT) // 4
        # The next step lands the imported bytes in the pool (it takes no request).
        dec.submit([1, 2], 1)
        deadline = time.monotonic() + 30
        while dec.stats()["total_finished"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        with dec._lock:
            srcs = dec.block_manager.export_sources([bytes.fromhex(h) for h in desc["digests"]])
        blocks = [b for kind, b in srcs if kind == "hbm"]
        assert len(blocks) == len(desc["digests"])
        for n, a in dec.kv.items():
            assert torch.equal(a[:, blocks].view(torch.int16), src_kv[n].view(torch.int16)), n
    finally:
        dec.shutdown()


# ------------------------------------------------------------ cluster
@pytest.mark.parametrize("runtime", ["cluster"], indirect=True)
def test_two_pool_handoff_on_half_gpu_replicas(runtime, models):
    """One prefill and one decode replica, each asking for half the one
    advertised GPU: the handle's generate and generate_stream run the
    prefill -> export -> import -> decode handoff across processes and
    return the JAX engine's tokens, and the decode replica imported every
    full block of the prompt (the second request reuses the first import)."""
    want = _jax_tokens(models, [PROMPT], N)[0]
    app = serve.LLMDeployment.options(
        num_replicas=2, prefill_replicas=1, max_ongoing_requests=64,
        ray_actor_options={"num_gpus": 0.5, "max_concurrency": 16},
    ).bind(model="gpt2-small", model_overrides={**TINY, "dtype": "float32"}, engine_options=OPTS,
           params=models[3], device="cpu")
    handle = serve.run(app, name="disagg", route_prefix="/disagg", timeout_s=300)
    assert handle.generate.remote(PROMPT, N).result(timeout_s=120)["tokens"] == want
    assert list(handle.options(stream=True).generate_stream.remote(PROMPT, N)) == want
    from ray_tpu_torch.serve.handle import Router

    router = Router.get_or_create("disagg", "LLMDeployment")
    router._refresh(force=True)
    with router._lock:
        replicas, roles = list(router._info["replicas"]), router._replica_roles()
    assert sorted(r for r in roles if r) == ["decode", "prefill"]
    stats = {role: rt.get(rep.handle_request.remote("engine_stats", (), {}), timeout=60)
             for rep, role in zip(replicas, roles)}
    nfull = len(PROMPT) // 4
    assert stats["prefill"]["blocks_exported"] >= nfull
    assert stats["decode"]["blocks_imported"] == nfull
    assert stats["decode"]["prefix_cache_hits"] >= 2 * nfull
    assert rt.available_resources().get("GPU", 0.0) == 0.0  # two halves hold the card
    serve.delete("disagg")


@pytest.mark.parametrize("runtime", ["cluster"], indirect=True)
def test_half_gpu_actors_place_two_to_a_card(runtime):
    """init(num_gpus=1) without a card: two num_gpus=0.5 actors place at
    once, a third waits until one of them is gone."""
    deadline = time.monotonic() + 60
    while rt.available_resources().get("GPU", 0.0) < 1.0 and time.monotonic() < deadline:
        time.sleep(0.2)  # the previous test's replicas release their halves
    class Holder:  # defined here: workers cannot import this test module
        def pid(self):
            import os

            return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

    remote = rt.remote(num_gpus=0.5)(Holder)
    a, b = remote.remote(), remote.remote()
    pa, pb = rt.get([a.pid.remote(), b.pid.remote()], timeout=120)
    assert pa[0] != pb[0] and pa[1] == pb[1] == "0"
    c = remote.remote()
    ref = c.pid.remote()
    ready, _ = rt.wait([ref], timeout=3)
    assert not ready, "a third half-GPU actor was placed on a full card"
    rt.kill(a)
    assert rt.get(ref, timeout=120)[1] == "0"
    rt.kill(b)
    rt.kill(c)

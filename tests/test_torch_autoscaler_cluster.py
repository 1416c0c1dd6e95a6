"""The port's autoscaler on a live CPU cluster (the reference's
`tests/test_autoscaler.py` end-to-end cases, adapted): `StandardAutoscaler`
over `FakeMultiNodeProvider`, whose nodes are node-agent processes joining
one head-only cluster of one CPU.

* queued tasks scale the cluster up, and all of them finish;
* idle nodes scale down to `min_workers`;
* `request_resources` scales up, and its floor keeps idle nodes until it is
  cleared;
* a pending STRICT_SPREAD placement group is satisfied;
* the port's own: with a `cpu` type and a `gpu` type that advertises a GPU
  (no card here), a lone CPU task launches exactly one `cpu` node and a
  queued `num_gpus=1` task exactly one `gpu` node, each task runs on the
  node launched for it, and both nodes scale back down.

One cluster for the module; each case polls `update()` against a deadline
and ends with its nodes gone."""

import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.autoscaler import FakeMultiNodeProvider, StandardAutoscaler, sdk
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core import api

DEADLINE_S = 30.0


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    rt.init(address=c.address)
    try:
        yield c
    finally:
        rt.shutdown()
        c.shutdown()


def _until(what: str, fn, timeout: float = DEADLINE_S, every: float = 0.1):
    """Poll `fn()` until it returns a true value; that value, or fail."""
    deadline = time.monotonic() + timeout
    while True:
        out = fn()
        if out:
            return out
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(every)


def _alive_workers() -> set:
    nodes = api._global_runtime().backend._request({"type": "load_metrics"})["nodes"]
    return {n["node_id"] for n in nodes if n["alive"] and not n["is_head"]}


@pytest.fixture
def scaler(cluster):
    """make(node_types, **config) -> (provider, autoscaler); on teardown the
    floor is cleared, the provider's nodes end and the head sees none."""
    made = []

    def make(node_types, **cfg):
        provider = FakeMultiNodeProvider({"address": cluster.address, "session_dir": cluster.session_dir})
        autoscaler = StandardAutoscaler({"available_node_types": node_types, "max_workers": 8, **cfg}, provider,
                                        api._global_runtime().backend)
        made.append(provider)
        return provider, autoscaler

    yield make
    sdk.request_resources()
    for provider in made:
        provider.shutdown()
    _until("the head sees the launched nodes gone", lambda: not _alive_workers())


def _launch(autoscaler, what: str) -> dict:
    """update() until it launches; what it launched."""
    return _until(what, autoscaler.update)


def test_scales_up_for_queued_tasks(scaler):
    provider, autoscaler = scaler({"cpu": {"resources": {"CPU": 2}, "min_workers": 0, "max_workers": 4}},
                                  idle_timeout_s=3600)

    @rt.remote(num_cpus=1)
    def busy(x):
        time.sleep(0.5)
        return x

    refs = [busy.remote(i) for i in range(5)]
    launched = _launch(autoscaler, "a launch for 5 queued tasks")
    assert set(launched) == {"cpu"} and launched["cpu"] >= 1
    assert sorted(rt.get(refs, timeout=60)) == list(range(5))


def test_idle_nodes_scale_down_to_min_workers(scaler):
    provider, autoscaler = scaler({"cpu": {"resources": {"CPU": 2}, "min_workers": 1, "max_workers": 4}},
                                  idle_timeout_s=0.5)
    sdk.request_resources(bundles=[{"CPU": 2}] * 3)
    assert _launch(autoscaler, "the floor's launch") == {"cpu": 3}
    _until("3 nodes registered", lambda: len(_alive_workers()) == 3)
    sdk.request_resources()

    def one_left():
        autoscaler.update()
        return len(provider.non_terminated_nodes({})) == 1

    _until("scale-down to min_workers", one_left, every=0.3)
    for _ in range(3):
        assert autoscaler.update() == {}
        time.sleep(0.3)
    assert len(provider.non_terminated_nodes({})) == 1  # min_workers=1 keeps one


def test_request_resources_scales_up_and_its_floor_keeps_idle_nodes(scaler):
    provider, autoscaler = scaler({"cpu": {"resources": {"CPU": 4}, "min_workers": 0, "max_workers": 4}},
                                  idle_timeout_s=0.2)
    sdk.request_resources(num_cpus=6)
    # The head has 1 CPU: 6 need two nodes of 4.
    assert _launch(autoscaler, "the floor's launch") == {"cpu": 2}
    _until("2 nodes registered", lambda: len(_alive_workers()) == 2)
    time.sleep(1.0)  # idle well past the timeout
    for _ in range(3):
        assert autoscaler.update() == {}  # no churn, no extra launch
        time.sleep(0.3)
    assert len(provider.non_terminated_nodes({})) == 2
    sdk.request_resources()

    def none_left():
        autoscaler.update()
        return not provider.non_terminated_nodes({})

    _until("scale-down once the floor is cleared", none_left, every=0.3)


def test_pending_placement_group_is_satisfied(scaler):
    from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group

    provider, autoscaler = scaler({"cpu": {"resources": {"CPU": 2}, "min_workers": 0, "max_workers": 4}},
                                  idle_timeout_s=3600)
    pg = placement_group([{"CPU": 2}, {"CPU": 2}], strategy="STRICT_SPREAD")
    assert not pg.wait(0.2)  # infeasible on the 1-CPU head
    assert _launch(autoscaler, "a launch for the placement group") == {"cpu": 2}
    assert pg.wait(DEADLINE_S)
    remove_placement_group(pg)


def test_gpu_type_takes_a_gpu_task_and_a_lone_cpu_task_launches_cpu(scaler):
    """The head's CPU is held by an actor. A lone CPU task launches exactly
    one `cpu` node (a verbatim copy of the packer launches the `gpu` type
    here) and runs there; a queued `num_gpus=1` task launches exactly one
    `gpu` node, a second update() launches nothing, and the task runs on
    that node in a GPU worker; then both nodes scale down."""
    import os

    provider, autoscaler = scaler({"cpu": {"resources": {"CPU": 4}, "min_workers": 0, "max_workers": 2},
                                   "gpu": {"resources": {"CPU": 2, "GPU": 1}, "min_workers": 0, "max_workers": 1}},
                                  max_workers=3, idle_timeout_s=0.5)

    @rt.remote(num_cpus=1)
    class Holder:
        def node(self):
            return rt.get_runtime_context().get_node_id()

    @rt.remote(num_cpus=1)
    def where():
        return rt.get_runtime_context().get_node_id()

    @rt.remote(num_gpus=1)
    def where_gpu():
        return rt.get_runtime_context().get_node_id(), os.environ.get("CUDA_VISIBLE_DEVICES")

    holder = Holder.remote()
    head = rt.get(holder.node.remote(), timeout=DEADLINE_S)
    try:
        ref = where.remote()
        assert _launch(autoscaler, "the CPU task's launch") == {"cpu": 1}
        assert autoscaler.update() == {}
        (cpu_node,) = provider.non_terminated_nodes({})
        assert rt.get(ref, timeout=DEADLINE_S) == cpu_node != head

        ref = where_gpu.remote()
        assert _launch(autoscaler, "the GPU task's launch") == {"gpu": 1}
        assert autoscaler.update() == {}
        (gpu_node,) = set(provider.non_terminated_nodes({})) - {cpu_node}
        node, visible = rt.get(ref, timeout=DEADLINE_S)
        assert node == gpu_node and visible == "0"
    finally:
        rt.kill(holder)

    def none_left():
        autoscaler.update()
        return not provider.non_terminated_nodes({})

    _until("both nodes scaled down", none_left, every=0.3)
    _until("the head sees both nodes gone", lambda: not _alive_workers())

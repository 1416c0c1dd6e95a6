"""The port's autoscaler (`ray_tpu_torch.autoscaler`, a copy of the
reference's) against the reference's, with no cluster:

* the demand packer (`get_nodes_to_launch`, `pack_feasible`) on seeded
  random node types, capacities, demands, explicit floors and STRICT_SPREAD
  groups: equal results, the reference given "TPU" wherever the port is
  given "GPU";
* the one divergence, `_size`: the reference's packer given the port's "GPU"
  key launches a GPU node for a CPU task, and one node more than needed for
  a CPU bundle beside a GPU one; the port's does what the reference does with
  its own key;
* the reference's scheduler and TPU-VM provider cases
  (`tests/test_autoscaler.py`) and its KubeRay cases (`tests/test_kuberay.py`)
  on both packages; `StandardAutoscaler` over KubeRay's in-memory operator,
  fed the same load-metrics snapshots, makes the same create and terminate
  calls, CR patches and pod sets in both."""

import copy
import json

import numpy as np
import pytest

import ray_tpu.autoscaler as ref_autoscaler
import ray_tpu.autoscaler.kuberay_provider as ref_kuberay
import ray_tpu.autoscaler.node_provider as ref_node_provider
import ray_tpu.autoscaler.resource_demand_scheduler as ref_rds
import ray_tpu_torch.autoscaler as port_autoscaler
import ray_tpu_torch.autoscaler.kuberay_provider as port_kuberay
import ray_tpu_torch.autoscaler.node_provider as port_node_provider
import ray_tpu_torch.autoscaler.resource_demand_scheduler as port_rds

# Each package with its accelerator key.
PACKAGES = {
    "reference": {"autoscaler": ref_autoscaler, "rds": ref_rds, "kuberay": ref_kuberay, "np": ref_node_provider,
                  "acc": "TPU"},
    "port": {"autoscaler": port_autoscaler, "rds": port_rds, "kuberay": port_kuberay, "np": port_node_provider,
             "acc": "GPU"},
}


def _acc(obj, acc: str):
    """`obj` (dicts, lists, tuples of them) with the key "ACC" renamed `acc`
    and a key "ACC-<x>" renamed "<acc>-<x>"."""
    if isinstance(obj, dict):
        return {(acc + k[3:] if k.startswith("ACC") else k): _acc(v, acc) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_acc(v, acc) for v in obj)
    return obj


# --------------------------------------------------------- seeded packer draws
def _bundle(rng, acc_share: float) -> dict:
    b = {"CPU": float(rng.choice([0.5, 1, 2, 3, 4, 6]))}
    if rng.random() < acc_share:
        b["ACC"] = float(rng.choice([0.5, 1, 2, 4]))
        if rng.random() < 0.3:
            b.pop("CPU")
    if rng.random() < 0.1:
        b["mem"] = float(rng.integers(1, 4))
    return b


def _draw(rng) -> dict:
    node_types = {}
    for i in range(int(rng.integers(1, 4))):
        res = {"CPU": float(rng.choice([2, 4, 8, 16]))}
        if rng.random() < 0.5:
            res["ACC"] = float(rng.choice([1, 2, 4, 8]))
        if rng.random() < 0.2:
            res["mem"] = float(rng.integers(2, 8))
        spec = {"resources": res}
        if rng.random() < 0.3:
            spec["min_workers"] = int(rng.integers(0, 3))
        if rng.random() < 0.7:
            spec["max_workers"] = int(rng.integers(1, 6))
        node_types[f"t{i}"] = spec
    n_live = int(rng.integers(0, 4))
    totals = [_bundle(rng, 0.4) for _ in range(n_live)]
    avail = [{k: v * float(rng.choice([0.0, 0.5, 1.0])) for k, v in t.items()} for t in totals]
    as_dict = rng.random() < 0.5
    ids = [f"n{i}" for i in range(n_live)]
    strict = []
    for _ in range(int(rng.integers(0, 3))):
        bundles = [_bundle(rng, 0.3) for _ in range(int(rng.integers(1, 4)))]
        if as_dict and rng.random() < 0.5:
            strict.append({"bundles": bundles, "occupied": [i for i in ids if rng.random() < 0.5]})
        else:
            strict.append(bundles)
    kw = {
        "node_types": node_types,
        "counts_by_type": {t: int(rng.integers(0, 3)) for t in node_types if rng.random() < 0.4},
        "existing_avail": dict(zip(ids, avail)) if as_dict else avail,
        "demands": [_bundle(rng, 0.4) for _ in range(int(rng.integers(0, 12)))],
        "explicit_demands": [_bundle(rng, 0.3) for _ in range(int(rng.integers(0, 4)))],
        "max_workers": int(rng.integers(1, 12)),
        "strict_spread_groups": strict,
    }
    if rng.random() < 0.6:
        kw["existing_totals"] = dict(zip(ids, totals)) if as_dict else totals
    return kw


@pytest.mark.parametrize("seed", range(4))
def test_packer_equals_the_reference_on_seeded_draws(seed):
    rng = np.random.default_rng(seed)
    launched = 0
    for _ in range(100):
        kw = _draw(rng)
        got = {name: p["rds"].get_nodes_to_launch(**_acc(copy.deepcopy(kw), p["acc"]))
               for name, p in PACKAGES.items()}
        assert got["port"] == got["reference"], kw
        launched += sum(got["port"].values())
        caps = list(kw["existing_avail"].values()) if isinstance(kw["existing_avail"], dict) \
            else kw["existing_avail"]
        feasible = {name: p["rds"].pack_feasible(_acc(caps, p["acc"]), _acc(kw["demands"], p["acc"]))
                    for name, p in PACKAGES.items()}
        assert feasible["port"] == feasible["reference"], kw
    assert launched > 50  # the draws launch nodes, not only {}


# ------------------------------------------------------ the divergence: _size
CPU_TYPE = {"resources": {"CPU": 8}}


def _lone_cpu_task(acc: str) -> dict:
    return {"node_types": {"cpu": CPU_TYPE, "acc": {"resources": {"CPU": 2, acc: 1}}}, "counts_by_type": {},
            "existing_avail": [], "demands": [{"CPU": 1}], "explicit_demands": []}


def _cpu_beside_acc(acc: str) -> dict:
    return {"node_types": {"cpu": CPU_TYPE, "acc": {"resources": {"CPU": 8, acc: 1}}}, "counts_by_type": {},
            "existing_avail": [], "demands": [{"CPU": 6}, {acc: 1}], "explicit_demands": []}


@pytest.mark.parametrize("case, right, verbatim", [
    (_lone_cpu_task, {"cpu": 1}, {"acc": 1}),              # a GPU node for a CPU task
    (_cpu_beside_acc, {"acc": 1}, {"cpu": 1, "acc": 1}),   # one node more than needed
])
def test_size_weighs_the_ports_accelerator_key(case, right, verbatim):
    # The reference with its own key: what both should do.
    assert ref_rds.get_nodes_to_launch(**case("TPU")) == right
    # A verbatim copy (the reference's _size) given the port's key.
    assert ref_rds.get_nodes_to_launch(**case("GPU")) == verbatim
    # The port given its key does what the reference does with its own.
    assert port_rds.get_nodes_to_launch(**case("GPU")) == right
    assert port_rds._size({"GPU": 1}) > port_rds._size({"CPU": 64}) and ref_rds._size({"GPU": 1}) < 64


# ------------------------------- the reference's scheduler cases (test_autoscaler.py)
SCHEDULER_CASES = {
    "packs_onto_existing_capacity": (
        dict(node_types={"cpu": {"resources": {"CPU": 4}, "min_workers": 0, "max_workers": 4}},
             counts_by_type={}, existing_avail=[{"CPU": 4}], demands=[{"CPU": 1}, {"CPU": 1}],
             explicit_demands=[]), {}),
    "launches_for_unmet_demand": (
        dict(node_types={"cpu": {"resources": {"CPU": 2}, "min_workers": 0, "max_workers": 8}},
             counts_by_type={}, existing_avail=[{"CPU": 0}], demands=[{"CPU": 1}] * 5, explicit_demands=[]),
        {"cpu": 3}),
    "honors_max_workers": (
        dict(node_types={"cpu": {"resources": {"CPU": 1}, "min_workers": 0, "max_workers": 2}},
             counts_by_type={"cpu": 1}, existing_avail=[], demands=[{"CPU": 1}] * 10, explicit_demands=[]),
        {"cpu": 1}),
    "min_workers_floor": (
        dict(node_types={"cpu": {"resources": {"CPU": 1}, "min_workers": 2, "max_workers": 4}},
             counts_by_type={}, existing_avail=[], demands=[], explicit_demands=[]),
        {"cpu": 2}),
    "picks_accelerator_type_for_accelerator_demand": (
        dict(node_types={"cpu": {"resources": {"CPU": 8}, "min_workers": 0, "max_workers": 8},
                         "acc": {"resources": {"CPU": 4, "ACC": 4}, "min_workers": 0, "max_workers": 2}},
             counts_by_type={}, existing_avail=[], demands=[{"ACC": 4.0}, {"CPU": 1.0}], explicit_demands=[]),
        {"acc": 1}),
    "explicit_capacity_floor": (
        dict(node_types={"cpu": {"resources": {"CPU": 2}, "min_workers": 0, "max_workers": 8}},
             counts_by_type={}, existing_avail=[{"CPU": 0}], existing_totals=[{"CPU": 2}], demands=[],
             explicit_demands=[{"CPU": 1}] * 4),
        {"cpu": 1}),
    "strict_spread_needs_distinct_nodes": (
        dict(node_types={"cpu": {"resources": {"CPU": 4}, "min_workers": 0, "max_workers": 8}},
             counts_by_type={}, existing_avail=[], demands=[], explicit_demands=[],
             strict_spread_groups=[[{"CPU": 2}, {"CPU": 2}]]),
        {"cpu": 2}),
    # TestTPUVMProvider.test_demand_scheduler_launches_one_slice_for_gang
    "one_slice_for_a_gang": (
        dict(node_types={"acc16": {"resources": {"ACC": 16.0, "ACC-16-head": 1.0}, "min_workers": 0,
                                   "max_workers": 4}},
             counts_by_type={}, existing_avail=[], demands=[{"ACC-16-head": 1.0}] + [{"ACC": 4.0}] * 4,
             explicit_demands=[]),
        {"acc16": 1}),
}


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", SCHEDULER_CASES)
def test_reference_scheduler_cases(case, package):
    kw, want = SCHEDULER_CASES[case]
    acc = PACKAGES[package]["acc"]
    kw = _acc(copy.deepcopy(kw), acc)
    assert PACKAGES[package]["rds"].get_nodes_to_launch(**kw) == want


# ------------------------------------------ TPU-VM provider (test_autoscaler.py)
def _tpu_vm(package: str, delay: float = 0.0):
    a = PACKAGES[package]["autoscaler"]
    api = a.InMemoryTPUAPI(provision_delay_s=delay)
    provider = a.TPUVMProvider({"project": "proj-x", "zone": "us-central2-b", "accelerator_type": "v5litepod-16",
                                "runtime_version": "v2-alpha-tpuv5-lite", "transport": api.transport},
                               cluster_name="testclu")
    return api, provider, PACKAGES[package]["np"].TAG_NODE_TYPE


@pytest.mark.parametrize("package", PACKAGES)
def test_tpu_vm_create_list_terminate_lifecycle(package):
    api, provider, tag = _tpu_vm(package)
    ids = provider.create_node({"accelerator_type": "v5litepod-16"}, {tag: "tpu16"}, count=2)
    assert len(ids) == 2
    assert sum(1 for m, _u in api.calls if m == "POST") == 2
    assert api.nodes[ids[0]]["acceleratorType"] == "v5litepod-16"
    assert sorted(provider.non_terminated_nodes({tag: "tpu16"})) == sorted(ids)
    assert provider.is_running(ids[0])
    provider.terminate_node(ids[0])
    assert provider.non_terminated_nodes({tag: "tpu16"}) == [ids[1]]
    assert provider.node_tags(ids[0])[PACKAGES[package]["np"].TAG_NODE_STATUS] == "terminated"


@pytest.mark.parametrize("package", PACKAGES)
def test_tpu_vm_tag_filtering_and_pending_state(package):
    api, provider, tag = _tpu_vm(package, delay=3600.0)
    ids = provider.create_node({}, {tag: "tpu16"}, 1)
    assert provider.non_terminated_nodes({}) == ids
    assert not provider.is_running(ids[0])
    assert provider.node_tags(ids[0])[tag] == "tpu16"
    assert provider.non_terminated_nodes({tag: "other"}) == []


def test_tag_keys_carry_the_ports_name():
    """The rewrite gives the port's tags its own prefix; tests read the
    constants, not the literals."""
    for name in ("TAG_NODE_KIND", "TAG_NODE_TYPE", "TAG_NODE_STATUS"):
        ref, port = getattr(ref_node_provider, name), getattr(port_node_provider, name)
        assert port == ref.replace("ray_tpu-", "ray_tpu_torch-", 1) and port != ref
    assert port_kuberay.KubeRayProvider.GROUP_KEY == "ray_tpu_torch-group"


# ---------------------------------------------------- KubeRay (test_kuberay.py)
class _Recorder:
    """A transport in front of `InMemoryK8sAPI`: every (method, path, body)."""

    def __init__(self, api):
        self.api, self.log = api, []

    def __call__(self, method, path, body):
        self.log.append((method, path, copy.deepcopy(body)))
        return self.api.transport(method, path, body)


def _raycluster(package: str, hosts: int = 2) -> dict:
    np_ = PACKAGES[package]["np"]
    acc = PACKAGES[package]["acc"].lower()
    return {"metadata": {"name": "rtpu"}, "spec": {"workerGroupSpecs": [
        {"groupName": "cpu-workers", "replicas": 0, "numOfHosts": 1,
         "labels": {np_.TAG_NODE_KIND: np_.NODE_KIND_WORKER, np_.TAG_NODE_TYPE: "cpu-workers"}},
        {"groupName": f"{acc}-workers", "replicas": 0, "numOfHosts": hosts,
         "labels": {np_.TAG_NODE_KIND: np_.NODE_KIND_WORKER, np_.TAG_NODE_TYPE: f"{acc}-workers"}},
    ]}}


def _kuberay(package: str, delay: float = 0.0, hosts: int = 2):
    k = PACKAGES[package]["kuberay"]
    api = k.InMemoryK8sAPI(_raycluster(package, hosts), provision_delay_s=delay)
    rec = _Recorder(api)
    provider = k.KubeRayProvider({"namespace": "ml", "raycluster_name": "rtpu", "transport": rec},
                                 cluster_name="rtpu")
    return api, provider, rec, PACKAGES[package]["np"].TAG_NODE_TYPE, f"{PACKAGES[package]['acc'].lower()}-workers"


@pytest.mark.parametrize("package", PACKAGES)
def test_kuberay_scale_up_makes_slice_pods(package):
    api, provider, _, tag, acc_group = _kuberay(package, hosts=2)
    provider.create_node({"group": acc_group}, {}, count=1)
    pods = provider.non_terminated_nodes({tag: acc_group})
    assert len(pods) == 2 and all(provider.is_running(p) for p in pods)


@pytest.mark.parametrize("package", PACKAGES)
def test_kuberay_terminate_removes_whole_replica(package):
    api, provider, _, tag, acc_group = _kuberay(package, hosts=2)
    provider.create_node({"group": acc_group}, {}, count=2)
    pods = provider.non_terminated_nodes({tag: acc_group})
    assert len(pods) == 4
    provider.terminate_node(pods[0])
    assert len(provider.non_terminated_nodes({tag: acc_group})) == 2
    assert api.cr["spec"]["workerGroupSpecs"][1]["replicas"] == 1


@pytest.mark.parametrize("package", PACKAGES)
def test_kuberay_pending_pods_not_running(package):
    api, provider, _, tag, _ = _kuberay(package, delay=3600.0)
    provider.create_node({"group": "cpu-workers"}, {}, count=1)
    pods = provider.non_terminated_nodes({tag: "cpu-workers"})
    assert len(pods) == 1 and not provider.is_running(pods[0])


@pytest.mark.parametrize("package", PACKAGES)
def test_kuberay_patch_preserves_sibling_groups_and_template(package):
    api, provider, _, tag, acc_group = _kuberay(package, hosts=2)
    api.cr["spec"]["workerGroupSpecs"][1]["template"] = {"spec": {"x": 1}}
    provider.create_node({"group": "cpu-workers"}, {}, count=2)
    groups = api.cr["spec"]["workerGroupSpecs"]
    assert [g["groupName"] for g in groups] == ["cpu-workers", acc_group]
    assert groups[1]["template"] == {"spec": {"x": 1}} and groups[1]["numOfHosts"] == 2
    provider.create_node({"group": acc_group}, {}, count=1)
    provider.terminate_node(provider.non_terminated_nodes({tag: acc_group})[0])
    groups = api.cr["spec"]["workerGroupSpecs"]
    assert groups[0]["replicas"] == 2 and groups[1]["template"] == {"spec": {"x": 1}}


class _ScriptedBackend:
    """ClusterBackend double: the load-metrics snapshot it is given."""

    def __init__(self):
        self.raw = {"pending_demands": [], "nodes": []}

    def _request(self, msg):
        assert msg["type"] == "load_metrics"
        return copy.deepcopy(self.raw)


def _node(pod: str, total: dict, used: float, idle_s: float) -> dict:
    return {"node_id": pod, "total": dict(total), "available": {k: v * (1 - used) for k, v in total.items()},
            "idle_s": idle_s, "alive": True, "is_head": False}


def _snapshots(pods: dict) -> list:
    """The load-metrics sequence both autoscalers see, in the reference's
    key ("ACC" renamed per package): gang demand for one 16-card slice beside
    CPU tasks; the pods registered and busy, an explicit floor; the floor
    kept while they idle; a STRICT_SPREAD group with the surviving CPU pod
    occupied, beside a CPU task; the floor cleared, every pod idle."""
    acc16 = {"ACC": 16.0, "ACC-head": 1.0}
    cpu4 = {"CPU": 4.0}
    acc_pods, cpu_pods = pods.get("acc", []), pods.get("cpu", [])
    floor = [{"CPU": 4.0}]

    def nodes(used: float, idle_s: float) -> list:
        return [_node(p, acc16, used, idle_s) for p in acc_pods] + [_node(p, cpu4, used, idle_s) for p in cpu_pods]

    return [
        {"pending_demands": [{"ACC-head": 1.0}, {"ACC": 8.0}, {"CPU": 1.0}, {"CPU": 3.0}, {"CPU": 2.0}], "nodes": []},
        {"pending_demands": [], "explicit_demands": floor, "nodes": nodes(1.0, 0.0)},
        {"pending_demands": [], "explicit_demands": floor, "nodes": nodes(0.0, 3600.0)},
        {"pending_demands": [{"CPU": 1.0}], "explicit_demands": floor,
         "pending_pgs": [{"strategy": "STRICT_SPREAD", "bundles": [{"CPU": 2.0}, {"CPU": 2.0}],
                          "occupied": cpu_pods}],
         "nodes": nodes(0.0, 0.0)},
        {"pending_demands": [], "explicit_demands": [], "nodes": nodes(0.0, 3600.0)},
    ]


def _normalise(obj, package: str):
    """JSON text of `obj` in the reference's names: tag keys and the
    accelerator key and group."""
    text = json.dumps(obj, sort_keys=True)
    if package == "port":
        text = text.replace("ray_tpu_torch-", "ray_tpu-").replace("gpu-workers", "tpu-workers")
        text = text.replace('"GPU', '"TPU')
    return text


def _run_autoscaler(package: str) -> dict:
    p = PACKAGES[package]
    acc = p["acc"]
    api, provider, rec, tag, acc_group = _kuberay(package, hosts=2)
    calls = []
    create, terminate = provider.create_node, provider.terminate_node
    provider.create_node = lambda cfg, tags, count: calls.append(("create", cfg["group"], count)) or create(
        cfg, tags, count)
    provider.terminate_node = lambda nid: calls.append(("terminate", nid)) or terminate(nid)
    backend = _ScriptedBackend()
    node_types = _acc({
        "cpu-workers": {"resources": {"CPU": 4.0}, "min_workers": 0, "max_workers": 10, "group": "cpu-workers"},
        acc_group: {"resources": {"ACC": 16.0, "ACC-head": 1.0}, "min_workers": 0, "max_workers": 4,
                    "group": acc_group},
    }, acc)
    autoscaler = p["autoscaler"].StandardAutoscaler(
        {"available_node_types": node_types, "max_workers": 6, "idle_timeout_s": 60.0}, provider, backend)
    trace = []
    for i in range(5):
        pods = {"acc": sorted(provider.non_terminated_nodes({tag: acc_group})),
                "cpu": sorted(provider.non_terminated_nodes({tag: "cpu-workers"}))}
        backend.raw = _acc(_snapshots(pods)[i], acc)
        launched = autoscaler.update()
        trace.append({"launched": launched,
                      "pods": sorted(provider.non_terminated_nodes({})),
                      "replicas": [g["replicas"] for g in api.cr["spec"]["workerGroupSpecs"]]})
    return {"calls": calls, "trace": trace, "patches": [(m, path, body) for m, path, body in rec.log
                                                          if m == "PATCH"],
            "labels": {name: pod["metadata"]["labels"] for name, pod in api.pods.items()}}


def test_standard_autoscaler_over_kuberay_matches_the_reference():
    """The same load-metrics snapshots through both packages'
    StandardAutoscaler over KubeRay's in-memory operator: equal launches,
    create and terminate calls, CR patches and pod sets (pod names are
    deterministic here, so they are compared too)."""
    runs = {name: _run_autoscaler(name) for name in PACKAGES}
    ref, port = runs["reference"], runs["port"]
    for key in ("calls", "trace", "patches", "labels"):
        assert _normalise(port[key], "port") == _normalise(ref[key], "reference"), key
    # The sequence exercises scale-up, the floor, scale-down and STRICT_SPREAD.
    trace = ref["trace"]
    assert [s["launched"] for s in trace] == [{"tpu-workers": 1, "cpu-workers": 2}, {}, {}, {"cpu-workers": 2}, {}]
    assert [s["replicas"] for s in trace] == [[2, 1], [2, 1], [1, 0], [3, 0], [0, 0]]
    assert sum(c[0] == "terminate" for c in ref["calls"]) >= 5

"""KubeRay-style node provider — scale by patching a RayCluster custom
resource; an operator reconciles pods.

Reference analog: `python/ray/autoscaler/_private/kuberay/node_provider.py`
— the autoscaler never creates machines itself on Kubernetes: it PATCHes
the RayCluster CR's `workerGroupSpecs[].replicas` (and names doomed pods in
`scaleStrategy.workersToDelete`), and the KubeRay operator converges pods
to the spec. "Nodes" are the pods carrying the cluster label.

TPU redesign: worker groups are SLICE-granular. A group with
`numOfHosts: k` (the KubeRay TPU convention — one multi-host slice is k
pods that must exist together) scales in whole replicas; terminating any
pod of a replica removes the whole replica, because a partial TPU slice
can do no useful SPMD work.

Transport is injectable: production speaks to the in-cluster apiserver
(service-account token); tests inject `InMemoryK8sAPI`, which doubles BOTH
the apiserver verbs and the operator's reconcile loop, so scale-up/down is
exercised hermetically (zero egress here).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from .node_provider import (
    NodeProvider,
    TAG_NODE_KIND,
    TAG_NODE_TYPE,
)


def _in_cluster_transport(method: str, path: str, body: Optional[dict]) -> dict:
    """Default transport (production): apiserver REST with the pod's
    service-account token. Untestable here — tests inject InMemoryK8sAPI."""
    import json
    import os
    import urllib.request

    host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    token_path = "/var/run/secrets/kubernetes.io/serviceaccount/token"
    token = ""
    if os.path.exists(token_path):
        with open(token_path) as f:
            token = f.read().strip()
    req = urllib.request.Request(
        f"https://{host}:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        method=method,
        headers={
            "Authorization": f"Bearer {token}",
            "Content-Type": (
                "application/merge-patch+json" if method == "PATCH"
                else "application/json"
            ),
        },
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read() or b"{}")


class KubeRayProvider(NodeProvider):
    """provider_config keys:
        namespace          — k8s namespace of the RayCluster
        raycluster_name    — CR name (defaults to cluster_name)
        transport          — optional callable(method, path, body) -> dict
    """

    GROUP_KEY = "ray_tpu_torch-group"  # pod label: which workerGroupSpec

    def __init__(self, provider_config: dict, cluster_name: str = "ray-tpu"):
        super().__init__(provider_config, cluster_name)
        self.namespace = provider_config.get("namespace", "default")
        self.cr_name = provider_config.get("raycluster_name", cluster_name)
        self.transport: Callable = provider_config.get(
            "transport", _in_cluster_transport
        )
        self._lock = threading.Lock()
        self._tag_cache: Dict[str, Dict[str, str]] = {}

    # ------------------------------------------------------------- helpers
    def _cr_path(self) -> str:
        return (
            f"/apis/ray.io/v1/namespaces/{self.namespace}"
            f"/rayclusters/{self.cr_name}"
        )

    def _pods_path(self) -> str:
        return (
            f"/api/v1/namespaces/{self.namespace}/pods"
            f"?labelSelector=ray.io/cluster={self.cr_name}"
        )

    def _get_cr(self) -> dict:
        return self.transport("GET", self._cr_path(), None)

    def _patch_cr(self, patch: dict) -> dict:
        return self.transport("PATCH", self._cr_path(), patch)

    def _pods(self) -> List[dict]:
        return self.transport("GET", self._pods_path(), None).get("items", [])

    def _group_spec(self, cr: dict, group: str) -> Optional[dict]:
        for g in cr["spec"].get("workerGroupSpecs", []):
            if g["groupName"] == group:
                return g
        return None

    def _groups_with(self, cr: dict, group: str, **changes) -> List[dict]:
        """The COMPLETE workerGroupSpecs array with one group modified.
        RFC 7386 merge-patch replaces arrays wholesale — patching a
        one-element list would delete every other worker group and strip
        the patched group's template, so every patch ships the full
        read-modify-write array (the reference provider does the same:
        `kuberay/node_provider.py` patches the whole workerGroupSpecs)."""
        import copy

        groups = copy.deepcopy(cr["spec"].get("workerGroupSpecs", []))
        for g in groups:
            if g["groupName"] == group:
                g.update(copy.deepcopy(changes))
        return groups

    # ------------------------------------------------------- NodeProvider
    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        out = []
        for pod in self._pods():
            if pod["status"].get("phase") in ("Succeeded", "Failed"):
                continue
            if pod["metadata"].get("deletionTimestamp"):
                continue
            labels = pod["metadata"].get("labels", {})
            if all(labels.get(k) == v for k, v in tag_filters.items()):
                name = pod["metadata"]["name"]
                with self._lock:
                    self._tag_cache[name] = dict(labels)
                out.append(name)
        return out

    def node_tags(self, node_id: str) -> Dict[str, str]:
        with self._lock:
            cached = self._tag_cache.get(node_id)
        if cached is not None:
            return cached
        for pod in self._pods():
            if pod["metadata"]["name"] == node_id:
                return pod["metadata"].get("labels", {})
        return {}

    def is_running(self, node_id: str) -> bool:
        for pod in self._pods():
            if pod["metadata"]["name"] == node_id:
                return pod["status"].get("phase") == "Running"
        return False

    def create_node(
        self, node_config: dict, tags: Dict[str, str], count: int
    ) -> List[str]:
        """Scale-up = bump the group's replica count; the operator makes
        pods. Returns [] — pods surface through non_terminated_nodes once
        reconciled (the reference provider is likewise asynchronous)."""
        group = node_config.get("group", tags.get(TAG_NODE_TYPE, "workers"))
        cr = self._get_cr()
        spec = self._group_spec(cr, group)
        if spec is None:
            raise ValueError(
                f"RayCluster {self.cr_name} has no worker group {group!r}"
            )
        self._patch_cr({
            "spec": {
                "workerGroupSpecs": self._groups_with(
                    cr, group, replicas=int(spec.get("replicas", 0)) + count
                )
            }
        })
        return []

    def terminate_node(self, node_id: str) -> None:
        """Scale-down is REPLICA-granular: name the pod in workersToDelete
        and drop the replica count; for a multi-host (TPU slice) group the
        operator removes every pod of that replica — a partial slice cannot
        run SPMD work."""
        tags = self.node_tags(node_id)
        group = tags.get(self.GROUP_KEY) or tags.get(TAG_NODE_TYPE, "workers")
        cr = self._get_cr()
        spec = self._group_spec(cr, group)
        if spec is None:
            return
        self._patch_cr({
            "spec": {
                "workerGroupSpecs": self._groups_with(
                    cr, group,
                    replicas=max(0, int(spec.get("replicas", 0)) - 1),
                    scaleStrategy={
                        "workersToDelete":
                            spec.get("scaleStrategy", {}).get(
                                "workersToDelete", []
                            ) + [node_id],
                    },
                )
            }
        })

    def shutdown(self):
        pass


# ---------------------------------------------------------------- test double
class InMemoryK8sAPI:
    """Hermetic double of the apiserver + KubeRay operator: PATCHed replica
    counts reconcile into pods (Pending → Running after
    `provision_delay_s`); workersToDelete removes the named pod's whole
    replica (numOfHosts pods for multi-host TPU groups)."""

    def __init__(self, raycluster: dict, provision_delay_s: float = 0.0):
        self.cr = raycluster
        self.provision_delay_s = provision_delay_s
        self.pods: Dict[str, dict] = {}
        self.calls: List[tuple] = []
        self._replica_seq: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._reconcile()

    # -------------------------------------------------------- REST double
    def transport(self, method: str, path: str, body: Optional[dict]) -> dict:
        with self._lock:
            self.calls.append((method, path))
            if "/rayclusters/" in path:
                if method == "GET":
                    return self._copy_cr()
                if method == "PATCH":
                    self._merge_patch(body or {})
                    self._reconcile()
                    return self._copy_cr()
            if method == "GET" and "/pods" in path:
                self._advance()
                return {"items": [dict(p) for p in self.pods.values()]}
            raise ValueError(f"unhandled {method} {path}")

    def _copy_cr(self) -> dict:
        import copy

        return copy.deepcopy(self.cr)

    def _merge_patch(self, patch: dict):
        """RFC 7386 semantics — dicts merge recursively, arrays and scalars
        REPLACE wholesale, null deletes. Faithful to a real apiserver so the
        provider can't pass tests with patches that would destroy sibling
        worker groups in production."""
        import copy

        def merge(target: dict, p: dict):
            for k, v in p.items():
                if v is None:
                    target.pop(k, None)
                elif isinstance(v, dict) and isinstance(target.get(k), dict):
                    merge(target[k], v)
                else:
                    target[k] = copy.deepcopy(v)

        merge(self.cr, patch)

    # ---------------------------------------------------- operator double
    def _reconcile(self):
        cluster = self.cr["metadata"]["name"]
        for spec in self.cr["spec"]["workerGroupSpecs"]:
            group = spec["groupName"]
            hosts = int(spec.get("numOfHosts", 1))
            # Deletion first (mirrors the operator: doomed workers go away
            # before replica arithmetic is reconciled).
            doomed = set(
                spec.get("scaleStrategy", {}).get("workersToDelete", [])
            )
            doomed_replicas = {
                p["metadata"]["labels"]["replica-index"]
                for name, p in self.pods.items()
                if name in doomed
            }
            for name, p in list(self.pods.items()):
                if (
                    p["metadata"]["labels"][KubeRayProvider.GROUP_KEY] == group
                    and p["metadata"]["labels"]["replica-index"]
                    in doomed_replicas
                ):
                    del self.pods[name]
            if doomed:
                spec.setdefault("scaleStrategy", {})["workersToDelete"] = []
            live_replicas = {
                p["metadata"]["labels"]["replica-index"]
                for p in self.pods.values()
                if p["metadata"]["labels"][KubeRayProvider.GROUP_KEY] == group
            }
            want = int(spec.get("replicas", 0))
            while len(live_replicas) < want:
                seq = self._replica_seq.get(group, 0)
                self._replica_seq[group] = seq + 1
                ridx = f"{group}-{seq}"
                for h in range(hosts):
                    name = f"{cluster}-{ridx}-{h}"
                    self.pods[name] = {
                        "metadata": {
                            "name": name,
                            "labels": {
                                "ray.io/cluster": cluster,
                                KubeRayProvider.GROUP_KEY: group,
                                "replica-index": ridx,
                                **spec.get("labels", {}),
                            },
                        },
                        "status": {"phase": "Pending"},
                        "_created": time.monotonic(),
                    }
                live_replicas.add(ridx)

    def _advance(self):
        now = time.monotonic()
        for p in self.pods.values():
            if (
                p["status"]["phase"] == "Pending"
                and now - p["_created"] >= self.provision_delay_s
            ):
                p["status"]["phase"] = "Running"

"""TPU-VM node provider — slice-granular scale-up against the GCE TPU API.

Reference analog: the cloud node providers under
`python/ray/autoscaler/_private/` (the KubeRay provider,
`kuberay/node_provider.py`, is the closest shape: translate autoscaler
create/terminate calls into REST operations against a managed API and poll
the resource state). Here the managed API is the Cloud TPU v2 surface
(`projects.locations.nodes` create / get / list / delete): one autoscaler
node == one TPU SLICE (`acceleratorType` like "v5litepod-16"), because TPU
capacity arrives in slices, not single hosts.

Transport is injectable: production uses HTTPS against
tpu.googleapis.com; tests inject `InMemoryTPUAPI`, an in-memory
implementation of the same REST verbs, so slice-granular scale-up is
exercised hermetically (this environment has zero egress).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from .node_provider import (
    NodeProvider,
    STATUS_TERMINATED,
    TAG_NODE_STATUS,
)

_API_ROOT = "https://tpu.googleapis.com/v2"


def _https_transport(method: str, url: str, body: Optional[dict]) -> dict:
    """Default transport (production): REST over urllib with an access token
    from the metadata server / env. Untestable here (zero egress) — tests
    inject InMemoryTPUAPI.transport instead."""
    import os
    import urllib.request

    req = urllib.request.Request(
        url,
        data=json.dumps(body).encode() if body is not None else None,
        method=method,
        headers={
            "Content-Type": "application/json",
            "Authorization": f"Bearer {os.environ.get('GCP_ACCESS_TOKEN', '')}",
        },
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read() or b"{}")


class TPUVMProvider(NodeProvider):
    """provider_config keys:
        project, zone            — GCE location
        accelerator_type         — e.g. "v5litepod-16" (the SLICE unit)
        runtime_version          — e.g. "v2-alpha-tpuv5-lite"
        transport                — optional callable(method, url, body)->dict
    """

    def __init__(self, provider_config: dict, cluster_name: str = "ray-tpu"):
        super().__init__(provider_config, cluster_name)
        self.project = provider_config["project"]
        self.zone = provider_config["zone"]
        self.transport: Callable = provider_config.get(
            "transport", _https_transport
        )
        self._lock = threading.Lock()
        self._tag_cache: Dict[str, Dict[str, str]] = {}

    # ------------------------------------------------------------- helpers
    def _parent(self) -> str:
        return f"{_API_ROOT}/projects/{self.project}/locations/{self.zone}"

    def _node_url(self, node_id: str) -> str:
        return f"{self._parent()}/nodes/{node_id}"

    def _list(self) -> List[dict]:
        out = self.transport("GET", f"{self._parent()}/nodes", None)
        return out.get("nodes", [])

    # ------------------------------------------------------- NodeProvider
    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        nodes = []
        for n in self._list():
            if n.get("state") in ("DELETING", "TERMINATED"):
                continue
            labels = n.get("labels", {})
            if all(labels.get(k) == v for k, v in tag_filters.items()):
                node_id = n["name"].rsplit("/", 1)[-1]
                with self._lock:
                    self._tag_cache[node_id] = dict(labels)
                nodes.append(node_id)
        return nodes

    def node_tags(self, node_id: str) -> Dict[str, str]:
        with self._lock:
            cached = self._tag_cache.get(node_id)
        if cached is not None:
            return cached
        n = self.transport("GET", self._node_url(node_id), None)
        return n.get("labels", {})

    def is_running(self, node_id: str) -> bool:
        try:
            n = self.transport("GET", self._node_url(node_id), None)
        except Exception:  # noqa: BLE001
            return False
        return n.get("state") == "READY"

    def create_node(
        self, node_config: dict, tags: Dict[str, str], count: int
    ) -> List[str]:
        """One CREATE per slice — `count` slices, never partial hosts."""
        created = []
        accel = node_config.get(
            "accelerator_type", self.provider_config.get("accelerator_type")
        )
        runtime = node_config.get(
            "runtime_version",
            self.provider_config.get("runtime_version", "v2-alpha-tpuv5-lite"),
        )
        for _ in range(count):
            node_id = f"{self.cluster_name}-{uuid.uuid4().hex[:8]}"
            body = {
                "acceleratorType": accel,
                "runtimeVersion": runtime,
                "labels": {**tags, "ray-cluster": self.cluster_name},
                "metadata": {
                    "startup-script": node_config.get("startup_script", ""),
                },
            }
            self.transport(
                "POST", f"{self._parent()}/nodes?nodeId={node_id}", body
            )
            with self._lock:
                self._tag_cache[node_id] = dict(body["labels"])
            created.append(node_id)
        return created

    def terminate_node(self, node_id: str) -> None:
        self.transport("DELETE", self._node_url(node_id), None)
        with self._lock:
            tags = self._tag_cache.get(node_id)
            if tags is not None:
                tags[TAG_NODE_STATUS] = STATUS_TERMINATED


class InMemoryTPUAPI:
    """Hermetic double of the Cloud TPU REST surface (create/get/list/
    delete on `projects.locations.nodes`) — nodes move CREATING → READY
    after `provision_delay_s`, mirroring real slice provisioning."""

    def __init__(self, provision_delay_s: float = 0.0):
        self.nodes: Dict[str, dict] = {}
        self.provision_delay_s = provision_delay_s
        self.calls: List[tuple] = []
        self._lock = threading.Lock()

    def transport(self, method: str, url: str, body: Optional[dict]) -> dict:
        with self._lock:
            self.calls.append((method, url))
            if method == "POST":
                node_id = url.rsplit("nodeId=", 1)[-1]
                self.nodes[node_id] = {
                    "name": f"nodes/{node_id}",
                    "state": "CREATING",
                    "created_at": time.monotonic(),
                    **(body or {}),
                }
                return {"name": f"operations/{uuid.uuid4().hex}"}
            if method == "DELETE":
                node_id = url.rsplit("/", 1)[-1]
                node = self.nodes.get(node_id)
                if node is not None:
                    node["state"] = "TERMINATED"
                return {}
            # GET
            self._advance()
            if url.endswith("/nodes"):
                return {"nodes": [dict(n) for n in self.nodes.values()]}
            node_id = url.rsplit("/", 1)[-1]
            node = self.nodes.get(node_id)
            if node is None:
                raise KeyError(node_id)
            return dict(node)

    def _advance(self):
        now = time.monotonic()
        for n in self.nodes.values():
            if (
                n["state"] == "CREATING"
                and now - n["created_at"] >= self.provision_delay_s
            ):
                n["state"] = "READY"

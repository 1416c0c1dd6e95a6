"""Node providers — how the autoscaler actually adds/removes machines.

Reference analog: `python/ray/autoscaler/node_provider.py` `NodeProvider`
ABC with cloud implementations (aws/gcp/...) and the hermetic
`FakeMultiNodeProvider` (`_private/fake_multi_node/node_provider.py`) that
"launches nodes" as local processes — the pattern all autoscaler CI uses.

The TPU-cloud provider (GKE / TPU-VM REST calls) is a deliberate stub here:
this environment has zero egress, so only its interface is laid down.
"""

from __future__ import annotations

import subprocess
import threading
import time
from typing import Dict, List, Optional

TAG_NODE_KIND = "ray_tpu_torch-node-kind"  # "head" | "worker"
TAG_NODE_TYPE = "ray_tpu_torch-user-node-type"
TAG_NODE_STATUS = "ray_tpu_torch-node-status"

NODE_KIND_HEAD = "head"
NODE_KIND_WORKER = "worker"
STATUS_UP_TO_DATE = "up-to-date"
STATUS_TERMINATED = "terminated"


class NodeProvider:
    """Minimal provider contract the autoscaler needs.

    Node ids returned here are the same ids the node agents register with the
    controller under, so the autoscaler can join provider state with
    `load_metrics` node reports without an ip-mapping layer (the reference
    joins on internal_ip)."""

    def __init__(self, provider_config: dict, cluster_name: str):
        self.provider_config = provider_config
        self.cluster_name = cluster_name

    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        raise NotImplementedError

    def node_tags(self, node_id: str) -> Dict[str, str]:
        raise NotImplementedError

    def is_running(self, node_id: str) -> bool:
        raise NotImplementedError

    def create_node(
        self, node_config: dict, tags: Dict[str, str], count: int
    ) -> List[str]:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError


class FakeMultiNodeProvider(NodeProvider):
    """Launches "nodes" as local `node_agent` processes against a live
    controller — autoscaler logic is testable with no cloud at all
    (reference: `fake_multi_node/node_provider.py`)."""

    def __init__(self, provider_config: dict, cluster_name: str = "fake"):
        super().__init__(provider_config, cluster_name)
        self.address: str = provider_config["address"]
        self.session_dir: str = provider_config["session_dir"]
        self._lock = threading.Lock()
        self._counter = 0
        # node_id -> {proc, tags}
        self._nodes: Dict[str, dict] = {}

    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        with self._lock:
            out = []
            for nid, info in self._nodes.items():
                if info["proc"].poll() is not None:
                    continue
                tags = info["tags"]
                if all(tags.get(k) == v for k, v in tag_filters.items()):
                    out.append(nid)
            return out

    def node_tags(self, node_id: str) -> Dict[str, str]:
        with self._lock:
            return dict(self._nodes[node_id]["tags"])

    def is_running(self, node_id: str) -> bool:
        with self._lock:
            info = self._nodes.get(node_id)
            return info is not None and info["proc"].poll() is None

    def create_node(
        self, node_config: dict, tags: Dict[str, str], count: int
    ) -> List[str]:
        from ..cluster_utils import launch_node_agent

        created = []
        for _ in range(count):
            with self._lock:
                self._counter += 1
                node_id = f"fake-{self.cluster_name}-{self._counter}"
            proc = launch_node_agent(
                self.address,
                self.session_dir,
                node_id,
                {k: float(v) for k, v in node_config.get("resources", {}).items()},
                node_config.get("object_store_memory"),
            )
            with self._lock:
                self._nodes[node_id] = {
                    "proc": proc,
                    "tags": {**tags, TAG_NODE_STATUS: STATUS_UP_TO_DATE},
                }
            created.append(node_id)
        return created

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            info = self._nodes.get(node_id)
            if info is None:
                return
            info["tags"][TAG_NODE_STATUS] = STATUS_TERMINATED
            proc: subprocess.Popen = info["proc"]
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()

    def shutdown(self):
        for nid in list(self._nodes):
            self.terminate_node(nid)


class TPUVMNodeProvider(NodeProvider):
    """Interface stub for real TPU-VM / GKE provisioning (requires cloud
    APIs — unavailable here; reference cloud analog:
    `autoscaler/_private/gcp/node_provider.py`). Raises on use."""

    def _unavailable(self):
        raise RuntimeError(
            "TPUVMNodeProvider needs GCP API access; use FakeMultiNodeProvider "
            "for local clusters or implement create_node via the TPU VM REST API."
        )

    def non_terminated_nodes(self, tag_filters):
        self._unavailable()

    def node_tags(self, node_id):
        self._unavailable()

    def is_running(self, node_id):
        self._unavailable()

    def create_node(self, node_config, tags, count):
        self._unavailable()

    def terminate_node(self, node_id):
        self._unavailable()

"""Autoscaler — demand-driven cluster scaling.

Reference analog: `python/ray/autoscaler/_private/autoscaler.py`
(`StandardAutoscaler.update` :171,373) driven by `LoadMetrics`
(`load_metrics.py:63`) and `resource_demand_scheduler.py` bin-packing, with
pluggable `NodeProvider`s (fake multinode provider for hermetic tests:
`autoscaler/_private/fake_multi_node/node_provider.py`).

Redesign (TPU-first): the controller already holds the whole demand picture
(ready queue, pending placement groups, explicit requests) in one process, so
`LoadMetrics` is a single `load_metrics` RPC instead of a GCS-batched
resource stream. Node types describe whole TPU hosts (a v5e host = one node
with `{"CPU": N, "TPU": 4}`), so scaling a slice gang = bin-packing its
STRICT_SPREAD placement-group bundles onto `tpu_node` types.
"""

from .autoscaler import Monitor, StandardAutoscaler
from .load_metrics import LoadMetrics
from .node_provider import FakeMultiNodeProvider, NodeProvider
from .tpu_vm_provider import InMemoryTPUAPI, TPUVMProvider
from .resource_demand_scheduler import get_nodes_to_launch
from . import sdk

__all__ = [
    "StandardAutoscaler",
    "Monitor",
    "LoadMetrics",
    "NodeProvider",
    "FakeMultiNodeProvider",
    "TPUVMProvider",
    "InMemoryTPUAPI",
    "get_nodes_to_launch",
    "sdk",
]

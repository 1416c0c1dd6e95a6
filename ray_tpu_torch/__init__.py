"""ray_tpu_torch: the PyTorch/CUDA port of `ray_tpu`, for NVIDIA H100s.

Layout mirrors the JAX package (`ops/attention.py` is the counterpart of
`ray_tpu/ops/attention.py`, `core/controller.py` of
`ray_tpu/core/controller.py`, and so on). The port imports `torch`, never
`jax`, and nothing from `ray_tpu`: the JAX-free pieces it needs (the
runtime in `core/`, `native/`, `protocol/`, `dag/`, `experimental/`, the
serve engine's KV bookkeeping, `util/`) are copies kept in this package.

The public API is the reference's (`init`, `remote`, `get`, `put`,
`wait`, ...): tasks and actors that ask for `num_gpus` run in workers that
see the card; every other worker sees none (`CUDA_VISIBLE_DEVICES=""`).

Every TPU (Pallas) kernel on the ported path is a CUDA C++ kernel under
`kernels/csrc/`, built with `nvcc` for `sm_90a` at first use. Entry points
run on `cuda` unless the caller passes `device="cpu"`; on the CPU every
kernel wrapper takes its plain PyTorch version instead.
"""

from ._version import __version__
from .core.api import (
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    get_actor_or_none,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    remote,
    shutdown,
    timeline,
    wait,
)
from .core.actor import ActorClass, ActorHandle, method
from .core.exceptions import (
    ActorDiedError,
    ActorUnavailableError,
    GetTimeoutError,
    ObjectLostError,
    OutOfMemoryError,
    RayTpuError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from .core.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    UniqueID,
    WorkerID,
)
from .core.object_ref import DynamicObjectRefGenerator, ObjectRef, ObjectRefGenerator
from .core.runtime_context import get_runtime_context


def __getattr__(name):
    # The runtime's processes (controller, node agents, workers) import this
    # package; `device` imports torch, so it loads only when asked for.
    if name in ("resolve_device", "resolve_dtype"):
        from . import device

        return getattr(device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "__version__",
    "resolve_device",
    "resolve_dtype",
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "method",
    "get_actor",
    "get_actor_or_none",
    "nodes",
    "cluster_resources",
    "available_resources",
    "timeline",
    "get_runtime_context",
    "ObjectRef",
    "ObjectRefGenerator",
    "DynamicObjectRefGenerator",
    "ActorClass",
    "ActorHandle",
    "JobID",
    "TaskID",
    "ActorID",
    "ObjectID",
    "NodeID",
    "WorkerID",
    "PlacementGroupID",
    "UniqueID",
    "RayTpuError",
    "TaskError",
    "ActorDiedError",
    "ActorUnavailableError",
    "WorkerCrashedError",
    "ObjectLostError",
    "GetTimeoutError",
    "TaskCancelledError",
    "OutOfMemoryError",
]

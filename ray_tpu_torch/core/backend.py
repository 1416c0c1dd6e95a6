"""RuntimeBackend — the seam between the user API and an execution plane.

Two implementations:
  * LocalBackend   — in-process thread-pool execution (reference analog:
    `ray.init(local_mode=True)`); used for fast tests and debugging.
  * ClusterBackend — multiprocess workers + shared-memory object store +
    socket control plane (reference analog: raylet + GCS + plasma).
"""

from __future__ import annotations

import abc
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .ids import ActorID, PlacementGroupID
from .object_ref import ObjectRef
from .task_spec import TaskSpec


class RuntimeBackend(abc.ABC):
    @abc.abstractmethod
    def put(self, value: Any, owner_task_hex: str) -> ObjectRef:
        ...

    @abc.abstractmethod
    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float]) -> List[Any]:
        ...

    @abc.abstractmethod
    def wait(
        self,
        refs: Sequence[ObjectRef],
        num_returns: int,
        timeout: Optional[float],
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        ...

    @abc.abstractmethod
    def submit_task(self, spec: TaskSpec) -> None:
        ...

    @abc.abstractmethod
    def create_actor(self, spec: TaskSpec, name: str, namespace: str) -> None:
        ...

    @abc.abstractmethod
    def submit_actor_task(self, spec: TaskSpec) -> None:
        ...

    @abc.abstractmethod
    def kill_actor(self, actor_id: ActorID, no_restart: bool) -> None:
        ...

    @abc.abstractmethod
    def cancel(self, ref: ObjectRef, force: bool, recursive: bool) -> None:
        ...

    @abc.abstractmethod
    def get_named_actor(self, name: str, namespace: str) -> Optional[bytes]:
        """Returns pickled actor handle state or None."""

    @abc.abstractmethod
    def cluster_resources(self) -> Dict[str, float]:
        ...

    @abc.abstractmethod
    def available_resources(self) -> Dict[str, float]:
        ...

    @abc.abstractmethod
    def nodes(self) -> List[dict]:
        ...

    @abc.abstractmethod
    def create_placement_group(
        self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]], strategy: str, name: str
    ) -> None:
        ...

    @abc.abstractmethod
    def placement_group_ready(self, pg_id: PlacementGroupID, timeout: Optional[float]) -> bool:
        ...

    @abc.abstractmethod
    def remove_placement_group(self, pg_id: PlacementGroupID) -> None:
        ...

    @abc.abstractmethod
    def shutdown(self) -> None:
        ...

    # Optional capabilities ------------------------------------------------
    def free_objects(self, refs: Sequence[ObjectRef]) -> None:
        pass

    def state_summary(self) -> dict:
        return {}

    def stream_next(self, task_hex: str, index: int, timeout=300.0) -> str:
        """Streaming-generator protocol: block until item `index` exists
        ("ready"), the stream ended before it ("end"), or raise
        GetTimeoutError. Required for num_returns="streaming" tasks."""
        raise NotImplementedError(f"{type(self).__name__} does not support streaming")

    def stream_release(self, task_hex: str, from_index: int) -> None:
        """Consumer will never claim items >= from_index (GC hint)."""

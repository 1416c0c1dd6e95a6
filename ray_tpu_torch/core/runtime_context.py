"""Runtime context (reference: `python/ray/runtime_context.py`)."""

from __future__ import annotations

from typing import Optional


class RuntimeContext:
    def __init__(self, runtime):
        self._runtime = runtime

    def get_job_id(self) -> str:
        return self._runtime.job_id.hex()

    def get_task_id(self) -> Optional[str]:
        tid = self._runtime._context.task_id
        return tid.hex() if tid else None

    def get_actor_id(self) -> Optional[str]:
        aid = self._runtime._context.actor_id
        return aid.hex() if aid else None

    def get_node_id(self) -> str:
        return getattr(self._runtime.backend, "node_id_hex", "local")

    def get_worker_id(self) -> str:
        return getattr(self._runtime.backend, "worker_id_hex", "driver")

    @property
    def gcs_address(self) -> str:
        return self._runtime.address

    def get_assigned_resources(self) -> dict:
        return getattr(self._runtime.backend, "assigned_resources", {})


def get_runtime_context() -> RuntimeContext:
    from . import api

    return RuntimeContext(api._global_runtime())

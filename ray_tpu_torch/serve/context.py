"""Replica-side request context (reference: `serve/context.py`
`get_replica_context`, `serve/multiplex.py` `get_multiplexed_model_id`)."""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

_local = threading.local()


@dataclasses.dataclass
class ReplicaContext:
    app_name: str
    deployment: str
    replica_tag: str


def get_replica_context() -> ReplicaContext:
    ctx = getattr(_local, "replica_context", None)
    if ctx is None:
        raise RuntimeError("get_replica_context() called outside a Serve replica")
    return ctx


def _set_replica_context(ctx: Optional[ReplicaContext]):
    _local.replica_context = ctx


def get_multiplexed_model_id() -> str:
    return getattr(_local, "multiplexed_model_id", "")


def _set_multiplexed_model_id(model_id: str):
    _local.multiplexed_model_id = model_id


def get_request_id() -> str:
    """Id of the Serve request being handled on this thread (assigned per
    HTTP request by the proxy, equal to the request's trace_id — the same
    id keys `/api/traces` and `ray_tpu_torch trace`). Empty outside a request."""
    return getattr(_local, "request_id", "")


def _set_request_id(request_id: str):
    _local.request_id = request_id

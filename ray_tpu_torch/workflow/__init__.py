"""Workflow — durable DAG execution with storage-backed resume.

Reference analog: `python/ray/workflow` (`workflow_executor.py`,
`workflow_state.py`, `workflow_storage.py`, `api.py`): build a DAG with
`.bind()`, run it with `workflow.run(dag, workflow_id=...)`; every step's
result is durably checkpointed, so a crashed/failed workflow resumes from
the last completed step with `workflow.resume(workflow_id)`.

Redesign notes (TPU-first): steps are ordinary tasks on the cluster; the
executor walks the DAG in-process and checkpoints to a filesystem root
(point it at NFS/GCS-fuse for multi-host durability). Deterministic
structural step keys replace the reference's workflow-step registry.

Usage:
    from ray_tpu_torch import workflow

    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    dag = add.bind(add.bind(1, 2), 3)
    assert workflow.run(dag, workflow_id="sum3") == 6
    workflow.get_status("sum3")  # "SUCCESSFUL"
"""

from __future__ import annotations

import threading
import uuid
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from ..dag import DAGNode
from .executor import (
    CANCELED,
    FAILED,
    RESUMABLE,
    RUNNING,
    SUCCESSFUL,
    WorkflowCancellationError,
    WorkflowExecutor,
)
from .event_listener import EventListener, TimerListener, wait_for_event
from .storage import WorkflowStorage, default_root

__all__ = [
    "EventListener",
    "TimerListener",
    "wait_for_event",
    "init",
    "run",
    "run_async",
    "resume",
    "resume_async",
    "resume_all",
    "get_status",
    "get_output",
    "get_metadata",
    "list_all",
    "cancel",
    "delete",
    "continuation",
    "with_options",
    "WorkflowStatus",
]


class WorkflowStatus:
    RUNNING = RUNNING
    SUCCESSFUL = SUCCESSFUL
    FAILED = FAILED
    CANCELED = CANCELED
    RESUMABLE = RESUMABLE


_storage: Optional[WorkflowStorage] = None
_lock = threading.Lock()
# Workflow ids executing in THIS process — closes the submit→RUNNING race a
# status file alone cannot (two quick run_async calls before the first
# executor sets its status).
_running_local: set = set()


def init(storage: Optional[str] = None):
    """Set the durable storage root (default: $RAY_TPU_WORKFLOW_STORAGE or
    `workflows` under the session root, core/host_names.SESSION_ROOT;
    reference: a fixed root in /tmp, ray_tpu/workflow/__init__.py:87-88)."""
    global _storage
    with _lock:
        _storage = WorkflowStorage(storage)


def _get_storage() -> WorkflowStorage:
    global _storage
    with _lock:
        if _storage is None:
            _storage = WorkflowStorage(default_root())
        return _storage


# ------------------------------------------------------------------- running
def run(
    dag: DAGNode,
    *,
    workflow_id: Optional[str] = None,
    metadata: Optional[dict] = None,
) -> Any:
    """Run a DAG durably to completion; returns its output."""
    return run_async(dag, workflow_id=workflow_id, metadata=metadata).result()


def run_async(
    dag: DAGNode,
    *,
    workflow_id: Optional[str] = None,
    metadata: Optional[dict] = None,
) -> Future:
    storage = _get_storage()
    workflow_id = workflow_id or f"workflow-{uuid.uuid4().hex[:12]}"
    with _lock:
        already_local = workflow_id in _running_local
    if storage.exists(workflow_id):
        status = storage.get_status(workflow_id)
        if status == SUCCESSFUL:
            # Idempotent re-run of a finished workflow returns its output.
            fut: Future = Future()
            fut.set_result(storage.load_output(workflow_id))
            return fut
        if status == RUNNING or already_local:
            raise RuntimeError(
                f"workflow '{workflow_id}' is already running; use resume() "
                "after a crash or wait for it to finish"
            )
        # FAILED/CANCELED/RESUMABLE: fall through — re-running resumes from
        # checkpoints (cancel marker cleared).
        storage.clear_cancel(workflow_id)
    else:
        storage.create(workflow_id, cloudpickle.dumps(dag), metadata or {})
    return _spawn(storage, workflow_id, dag)


def _spawn(storage: WorkflowStorage, workflow_id: str, dag: DAGNode) -> Future:
    # Claim RUNNING synchronously — before the executor thread exists — so a
    # concurrent run_async for the same id cannot start a duplicate executor.
    with _lock:
        if workflow_id in _running_local:
            raise RuntimeError(f"workflow '{workflow_id}' is already running")
        _running_local.add(workflow_id)
    storage.set_status(workflow_id, RUNNING)
    fut: Future = Future()
    executor = WorkflowExecutor(storage, workflow_id)

    def go():
        try:
            fut.set_result(executor.run(dag))
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)
        finally:
            with _lock:
                _running_local.discard(workflow_id)

    t = threading.Thread(target=go, daemon=True, name=f"workflow-{workflow_id}")
    t.start()
    return fut


# ------------------------------------------------------------------ resuming
def resume(workflow_id: str) -> Any:
    return resume_async(workflow_id).result()


def resume_async(workflow_id: str) -> Future:
    storage = _get_storage()
    if not storage.exists(workflow_id):
        raise ValueError(f"no such workflow: {workflow_id}")
    if storage.get_status(workflow_id) == SUCCESSFUL:
        fut: Future = Future()
        fut.set_result(storage.load_output(workflow_id))
        return fut
    storage.clear_cancel(workflow_id)
    dag = storage.load_dag(workflow_id)
    return _spawn(storage, workflow_id, dag)


def resume_all() -> List[Tuple[str, Future]]:
    """Resume every workflow that did not finish (reference:
    `workflow.resume_all` after cluster restart)."""
    storage = _get_storage()
    out = []
    for wid, status in storage.list_all():
        if status in (RUNNING, FAILED, RESUMABLE):
            out.append((wid, resume_async(wid)))
    return out


# ----------------------------------------------------------------- inspection
def get_status(workflow_id: str) -> Optional[str]:
    return _get_storage().get_status(workflow_id)


def get_output(workflow_id: str) -> Any:
    storage = _get_storage()
    if not storage.has_output(workflow_id):
        status = storage.get_status(workflow_id)
        raise ValueError(f"workflow '{workflow_id}' has no output (status={status})")
    return storage.load_output(workflow_id)


def get_metadata(workflow_id: str) -> dict:
    meta = _get_storage().get_metadata(workflow_id)
    meta["status"] = get_status(workflow_id)
    return meta


def list_all(status_filter: Optional[str] = None) -> List[Tuple[str, Optional[str]]]:
    all_wfs = _get_storage().list_all()
    if status_filter is None:
        return all_wfs
    return [(w, s) for w, s in all_wfs if s == status_filter]


# ----------------------------------------------------------------- mutation
def cancel(workflow_id: str):
    """Request cancellation; takes effect at the next step boundary."""
    storage = _get_storage()
    if not storage.exists(workflow_id):
        raise ValueError(f"no such workflow: {workflow_id}")
    storage.mark_cancel(workflow_id)


def delete(workflow_id: str):
    _get_storage().delete(workflow_id)


# ------------------------------------------------------------------- helpers
def continuation(dag: DAGNode) -> DAGNode:
    """Mark a step's return value as a continuation DAG (reference:
    `workflow.continuation`) — the executor keeps walking it durably."""
    return dag


def with_options(node: DAGNode, **options) -> DAGNode:
    """Attach per-step options: max_retries (int), checkpoint (bool),
    catch_exceptions (bool) — reference analog: `workflow.options()`."""
    node._workflow_options = dict(options)
    return node

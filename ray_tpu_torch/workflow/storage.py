"""Durable workflow storage.

Reference analog: `python/ray/workflow/workflow_storage.py` — step results,
DAG, and status durably recorded so a crashed workflow resumes from its last
checkpoint. Filesystem-backed (one directory per workflow); the root can live
on NFS/GCS-fuse for cross-host durability.

Layout:
    <root>/<workflow_id>/dag.pkl            the bound DAG (cloudpickle)
    <root>/<workflow_id>/status             text status marker
    <root>/<workflow_id>/meta.json          creation time, user metadata
    <root>/<workflow_id>/cancel             cancel marker (presence = cancel)
    <root>/<workflow_id>/steps/<key>.pkl    checkpointed step results
    <root>/<workflow_id>/output.pkl         final workflow output
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, List, Optional, Tuple

import cloudpickle

from ..core.host_names import SESSION_ROOT

# Under TMPDIR, beside the sessions (reference: "/tmp/ray_tpu/workflows",
# ray_tpu/workflow/storage.py:26).
_DEFAULT_ROOT = os.path.join(SESSION_ROOT, "workflows")


def default_root() -> str:
    return os.environ.get("RAY_TPU_WORKFLOW_STORAGE", _DEFAULT_ROOT)


def _atomic_write(path: str, data: bytes):
    import threading
    import uuid

    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}.{uuid.uuid4().hex[:6]}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class WorkflowStorage:
    def __init__(self, root: Optional[str] = None):
        self.root = root or default_root()
        os.makedirs(self.root, exist_ok=True)

    # ------------------------------------------------------------- layout
    def _wf_dir(self, workflow_id: str) -> str:
        return os.path.join(self.root, workflow_id)

    def _steps_dir(self, workflow_id: str) -> str:
        return os.path.join(self._wf_dir(workflow_id), "steps")

    def exists(self, workflow_id: str) -> bool:
        return os.path.isdir(self._wf_dir(workflow_id))

    # ------------------------------------------------------------ lifecycle
    def create(self, workflow_id: str, dag_bytes: bytes, metadata: dict):
        os.makedirs(self._steps_dir(workflow_id), exist_ok=True)
        _atomic_write(os.path.join(self._wf_dir(workflow_id), "dag.pkl"), dag_bytes)
        meta = {"created_at": time.time(), **metadata}
        _atomic_write(
            os.path.join(self._wf_dir(workflow_id), "meta.json"),
            json.dumps(meta).encode(),
        )

    def load_dag(self, workflow_id: str) -> Any:
        with open(os.path.join(self._wf_dir(workflow_id), "dag.pkl"), "rb") as f:
            return cloudpickle.loads(f.read())

    def set_status(self, workflow_id: str, status: str):
        _atomic_write(
            os.path.join(self._wf_dir(workflow_id), "status"), status.encode()
        )

    def get_status(self, workflow_id: str) -> Optional[str]:
        try:
            with open(os.path.join(self._wf_dir(workflow_id), "status"), "rb") as f:
                return f.read().decode()
        except OSError:
            return None

    def get_metadata(self, workflow_id: str) -> dict:
        try:
            with open(os.path.join(self._wf_dir(workflow_id), "meta.json")) as f:
                return json.load(f)
        except OSError:
            return {}

    def list_all(self) -> List[Tuple[str, Optional[str]]]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if os.path.isdir(self._wf_dir(name)):
                out.append((name, self.get_status(name)))
        return out

    def delete(self, workflow_id: str):
        import shutil

        shutil.rmtree(self._wf_dir(workflow_id), ignore_errors=True)

    # -------------------------------------------------------------- cancel
    def mark_cancel(self, workflow_id: str):
        _atomic_write(os.path.join(self._wf_dir(workflow_id), "cancel"), b"1")

    def cancel_requested(self, workflow_id: str) -> bool:
        return os.path.exists(os.path.join(self._wf_dir(workflow_id), "cancel"))

    def clear_cancel(self, workflow_id: str):
        try:
            os.remove(os.path.join(self._wf_dir(workflow_id), "cancel"))
        except OSError:
            pass

    # --------------------------------------------------------------- steps
    def _step_path(self, workflow_id: str, key: str) -> str:
        return os.path.join(self._steps_dir(workflow_id), f"{key}.pkl")

    def has_step(self, workflow_id: str, key: str) -> bool:
        return os.path.exists(self._step_path(workflow_id, key))

    def save_step(self, workflow_id: str, key: str, value: Any):
        _atomic_write(
            self._step_path(workflow_id, key), cloudpickle.dumps(value)
        )

    def load_step(self, workflow_id: str, key: str) -> Any:
        with open(self._step_path(workflow_id, key), "rb") as f:
            return cloudpickle.loads(f.read())

    # --------------------------------------------------------------- output
    def save_output(self, workflow_id: str, value: Any):
        _atomic_write(
            os.path.join(self._wf_dir(workflow_id), "output.pkl"),
            cloudpickle.dumps(value),
        )

    def load_output(self, workflow_id: str) -> Any:
        with open(os.path.join(self._wf_dir(workflow_id), "output.pkl"), "rb") as f:
            return cloudpickle.loads(f.read())

    def has_output(self, workflow_id: str) -> bool:
        return os.path.exists(os.path.join(self._wf_dir(workflow_id), "output.pkl"))

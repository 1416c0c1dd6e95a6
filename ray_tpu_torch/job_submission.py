"""Job submission SDK (reference: `dashboard/modules/job/sdk.py:39`
`JobSubmissionClient` — submit_job `:129`, job run as a supervised driver
subprocess on the cluster; status/logs/stop round-trips).

    client = JobSubmissionClient()            # session_latest discovery
    job_id = client.submit_job(entrypoint="python my_train.py",
                               runtime_env={"env_vars": {"MODE": "prod"}})
    client.get_job_status(job_id)             # RUNNING/SUCCEEDED/FAILED/STOPPED
    print(client.get_job_logs(job_id))
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"


class JobSubmissionClient:
    def __init__(self, address: Optional[str] = None):
        if address is None:
            address = os.environ.get("RAY_TPU_ADDRESS")
        if address is None:
            from .core.host_names import SESSION_ROOT

            # reference: "/tmp/ray_tpu/session_latest/address.json", ray_tpu/job_submission.py:33
            with open(os.path.join(SESSION_ROOT, "session_latest", "address.json")) as f:
                info = json.load(f)
            address = info["address"]
            from .core.rpc import adopt_auth_token

            adopt_auth_token(info.get("auth_token", ""))
        from .core.cluster_backend import ClusterBackend

        self._backend = ClusterBackend(address)
        self._backend._connect(register_as="register_client")

    def submit_job(
        self,
        *,
        entrypoint: str,
        runtime_env: Optional[dict] = None,
        submission_id: Optional[str] = None,  # accepted for API parity
    ) -> str:
        resp = self._backend._request(
            {"type": "submit_job", "entrypoint": entrypoint, "runtime_env": runtime_env}
        )
        if resp.get("error"):
            raise RuntimeError(f"job submission failed: {resp['error']}")
        return resp["job_id"]

    def get_job_status(self, job_id: str) -> str:
        resp = self._backend._request({"type": "job_status", "job_id": job_id})
        if resp.get("error"):
            raise ValueError(resp["error"])
        return resp["status"]

    def get_job_info(self, job_id: str) -> Dict:
        resp = self._backend._request({"type": "job_status", "job_id": job_id})
        if resp.get("error"):
            raise ValueError(resp["error"])
        return resp

    def list_jobs(self) -> List[Dict]:
        return self._backend._request({"type": "list_jobs"})["jobs"]

    def get_job_logs(self, job_id: str) -> str:
        resp = self._backend._request({"type": "job_logs", "job_id": job_id})
        if resp.get("error"):
            raise ValueError(resp["error"])
        return resp["data"]

    def stop_job(self, job_id: str) -> bool:
        return self._backend._request({"type": "stop_job", "job_id": job_id})["ok"]

    def wait_until_finish(self, job_id: str, timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in (JobStatus.SUCCEEDED, JobStatus.FAILED, JobStatus.STOPPED):
                return status
            time.sleep(0.5)
        raise TimeoutError(f"job {job_id} still {status} after {timeout}s")

    def close(self):
        self._backend.conn.close()
        self._backend.io.stop()

"""The port's host tools (copies of the reference's) on one running port
cluster: the ops CLI (`python -m ray_tpu_torch.scripts.cli`) and the job
submission client find it through `session_latest` under the port's
session root, which follows TMPDIR, with no `--address` and no
`RAY_TPU_ADDRESS`; a submitted job gets its runtime env; the
multiprocessing `Pool`; the joblib backend (where joblib is installed).

The cluster runs under a TMPDIR of its own, as in a checkout of its own, so
no other cluster on this machine can be the one `session_latest` names."""

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core import host_names
from ray_tpu_torch.core.rpc import AUTH_ENV

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cluster():
    tempfile.gettempdir()  # pins this process's temp root (pytest's tmp_path) before TMPDIR moves
    tmpdir = tempfile.mkdtemp(prefix="rtct-", dir="/tmp")
    saved = {k: os.environ.get(k) for k in ("TMPDIR", "RAY_TPU_ADDRESS")}
    saved_root = host_names.SESSION_ROOT
    os.environ["TMPDIR"] = tmpdir  # the controller, its workers and the CLI start with it
    os.environ.pop("RAY_TPU_ADDRESS", None)
    # What host_names computes in a process started with this TMPDIR (a
    # short one: no hashed fallback).
    host_names.SESSION_ROOT = os.path.join(tmpdir, "ray_tpu_torch")
    try:
        rt.init(num_cpus=4)
        try:
            yield {"tmpdir": tmpdir, "root": host_names.SESSION_ROOT}
        finally:
            rt.shutdown()
    finally:
        host_names.SESSION_ROOT = saved_root
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmpdir, ignore_errors=True)


def _address_json(cluster) -> dict:
    with open(os.path.join(cluster["root"], "session_latest", "address.json")) as f:
        return json.load(f)


def test_the_cli_finds_the_cluster_through_session_latest(cluster, tmp_path):
    """`status`, `list workers` and `workflow list` in one shell, given only
    the cluster's TMPDIR (no address, no token): the status names the
    running controller's address, the worker list has the cluster's workers,
    and the workflow list shows a workflow just run on the cluster."""
    from ray_tpu_torch import workflow

    @rt.remote
    def add(a, b):
        return a + b

    storage = str(tmp_path / "wf")
    workflow.init(storage)
    try:
        assert workflow.run(add.bind(add.bind(1, 2), 3), workflow_id="cli_wf") == 6
    finally:
        workflow.init(None)
    address = _address_json(cluster)["address"]
    assert cluster["root"].startswith(cluster["tmpdir"])
    env = {k: v for k, v in os.environ.items() if k not in ("RAY_TPU_ADDRESS", AUTH_ENV)}
    env["TMPDIR"] = cluster["tmpdir"]
    cli = f"{sys.executable} -m ray_tpu_torch.scripts.cli"
    out = subprocess.run(["bash", "-c", f"set -e; {cli} status; {cli} list workers; "
                                        f"{cli} workflow list --storage {storage}"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == f"Cluster: {address}"
    assert "Nodes: 1 alive / 1 total" in lines and any(line.strip().startswith("CPU: ") for line in lines)
    header = next(i for i, line in enumerate(lines) if line.startswith("worker_id"))
    assert "has_tpu" in lines[header] and lines[header + 1].startswith("w")
    assert any(line.split() == ["cli_wf", "SUCCESSFUL"] for line in lines)


def test_the_cli_names_the_session_root_when_no_cluster_runs():
    tmpdir = tempfile.mkdtemp(prefix="rtcn-", dir="/tmp")
    try:
        env = {k: v for k, v in os.environ.items() if k not in ("RAY_TPU_ADDRESS", AUTH_ENV)}
        env["TMPDIR"] = tmpdir
        out = subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts.cli", "status"], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=60)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    assert out.returncode != 0
    assert f"no {tmpdir}/ray_tpu_torch/session_latest)" in out.stderr


def test_a_submitted_job_gets_its_runtime_env(cluster):
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

    assert "RAY_TPU_ADDRESS" not in os.environ
    client = JobSubmissionClient()  # session_latest under the port's root
    try:
        assert client._backend.address == _address_json(cluster)["address"]
        ok = client.submit_job(entrypoint=f'{sys.executable} -c "import os; print(os.environ[\'MY_FLAG\'])"',
                               runtime_env={"env_vars": {"MY_FLAG": "prod-7"}})
        bad = client.submit_job(entrypoint=f'{sys.executable} -c "raise SystemExit(3)"')
        assert client.wait_until_finish(ok, timeout=60) == JobStatus.SUCCEEDED
        assert "prod-7" in client.get_job_logs(ok)
        assert client.wait_until_finish(bad, timeout=60) == JobStatus.FAILED
        assert client.get_job_info(bad)["returncode"] == 3
        assert {j["job_id"]: j["status"] for j in client.list_jobs()}[ok] == JobStatus.SUCCEEDED
    finally:
        client.close()


def test_multiprocessing_pool(cluster):
    from ray_tpu_torch.util.multiprocessing import Pool

    with Pool() as p:
        assert p.map(lambda x: x * x, range(6)) == [0, 1, 4, 9, 16, 25]
        assert p.starmap(lambda a, b: a + b, [(1, 2), (3, 4)]) == [3, 7]
        assert p.apply(lambda a, b: a * b, (3, 4)) == 12
        assert p.apply_async(lambda: "async").get(timeout=30) == "async"
        assert sorted(p.imap_unordered(lambda x: -x, range(3))) == [-2, -1, 0]
    with pytest.raises(ValueError):
        p.map(lambda x: x, [1])


def test_joblib_backend(cluster):
    joblib = pytest.importorskip("joblib")
    from ray_tpu_torch.util.joblib import register_ray_tpu

    register_ray_tpu()
    with joblib.parallel_backend("ray_tpu_torch", n_jobs=4):
        out = joblib.Parallel()(joblib.delayed(lambda x: x ** 2)(i) for i in range(8))
    assert out == [i ** 2 for i in range(8)]

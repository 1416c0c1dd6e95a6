"""Worker-process isolation for runtime envs: conda + container.

Reference analog: `python/ray/_private/runtime_env/conda.py` and
`container.py` — these envs can't be applied inside a running worker (they
change the interpreter / the filesystem), so the RAYLET starts the worker
through a wrapper command (`conda run` / `podman run`). Same design here:
the node agent wraps the worker argv, the scheduler keys workers by
isolation hash (`isolation_key`) and only dispatches matching tasks onto
them — a task with `runtime_env={"conda": "myenv"}` never lands on a plain
pooled worker.

Zero-egress scoping: conda env CREATION from a spec dict needs an index and
is rejected; existing envs (by name or prefix) are supported. Both features
gate on the binary actually existing on the node (`conda`, and
`podman`/`docker` for containers) — absent binaries fail the worker spawn,
which surfaces as the task error, exactly like the reference's
RUNTIME_ENV_SETUP_FAILED path.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, List, Optional


def resolve(renv: Optional[dict]) -> Optional[Dict[str, Any]]:
    """runtime_env -> {"kind", "spec", "key"} or None if not isolated."""
    if not renv:
        return None
    if renv.get("conda"):
        spec = renv["conda"]
        return {"kind": "conda", "spec": spec, "key": _key("conda", spec)}
    if renv.get("container"):
        spec = renv["container"]
        return {"kind": "container", "spec": spec, "key": _key("container", spec)}
    return None


def isolation_key(renv: Optional[dict]) -> str:
    iso = resolve(renv)
    return iso["key"] if iso else ""


def _key(kind: str, spec: Any) -> str:
    blob = json.dumps(spec, sort_keys=True) if isinstance(spec, dict) else str(spec)
    return f"{kind}:{hashlib.sha256(blob.encode()).hexdigest()[:12]}"


def validate_spec(kind: str, spec: Any):
    if kind == "conda":
        if isinstance(spec, dict):
            raise ValueError(
                "runtime_env conda env CREATION from a spec dict needs a "
                "package index (zero-egress image); pass an existing env "
                "name or prefix path instead"
            )
        if not isinstance(spec, str) or not spec:
            raise ValueError("runtime_env conda must be an env name or prefix path")
    elif kind == "container":
        if not isinstance(spec, dict) or not spec.get("image"):
            raise ValueError(
                'runtime_env container must be {"image": ..., '
                '"run_options": [...]} (reference container field shape)'
            )
    else:
        raise ValueError(f"unknown isolation kind {kind!r}")


def _container_engine() -> Optional[str]:
    engine = os.environ.get("RAY_TPU_CONTAINER_ENGINE")
    if engine:
        return engine if shutil.which(engine) else None
    for candidate in ("podman", "docker"):
        if shutil.which(candidate):
            return candidate
    return None


# Env vars a containerized worker needs forwarded explicitly (`docker run`
# does not inherit the spawner's environment the way fork/exec does).
_FORWARD_PREFIXES = ("RAY_TPU_", "JAX_", "XLA_")
_FORWARD_EXACT = ("PYTHONPATH", "PYTHONUNBUFFERED", "TPU_SKIP_MDS_QUERY")


def _relocated(base_argv: List[str]) -> List[str]:
    """The wrapped command runs in a DIFFERENT interpreter world; the
    spawner's absolute `sys.executable` would escape it (`conda run` would
    exec the HOST interpreter with host site-packages; a container image
    likely has no python at that host path at all). Swap an absolute
    interpreter path for PATH-resolved `python3` (the PEP 394 guaranteed
    name; Debian-family images often ship no bare `python`), which the
    wrapper environment resolves to ITS interpreter — the entire point of the
    feature."""
    if base_argv and os.path.isabs(base_argv[0]):
        return ["python3"] + base_argv[1:]
    return list(base_argv)


def build_argv(
    isolation: Dict[str, Any], base_argv: List[str], env: Dict[str, str],
    session_dir: str,
) -> List[str]:
    """Wrap `base_argv` (the worker command) for the isolation kind.
    Raises RuntimeError when the needed binary is absent on this node."""
    kind, spec = isolation["kind"], isolation["spec"]
    validate_spec(kind, spec)
    base_argv = _relocated(base_argv)
    if kind == "conda":
        conda = os.environ.get("CONDA_EXE") or shutil.which("conda")
        if conda is None:
            raise RuntimeError(
                "runtime_env conda requested but no `conda` binary on this "
                "node (set CONDA_EXE or install conda in the node image)"
            )
        flag = "-p" if os.sep in spec else "-n"
        return [conda, "run", flag, spec, "--no-capture-output"] + base_argv

    engine = _container_engine()
    if engine is None:
        raise RuntimeError(
            "runtime_env container requested but neither podman nor docker "
            "is on this node (set RAY_TPU_CONTAINER_ENGINE to override)"
        )
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    argv = [
        engine, "run", "--rm",
        # The worker must reach the controller (TCP), the node arena
        # (/dev/shm), and the session dir — same trust domain as the host
        # worker, different filesystem (the point of the feature).
        "--network=host", "--ipc=host",
        "-v", f"{session_dir}:{session_dir}",
        "-v", f"{pkg_root}:{pkg_root}:ro",
    ]
    for k, v in env.items():
        if k.startswith(_FORWARD_PREFIXES) or k in _FORWARD_EXACT:
            argv += ["-e", f"{k}={v}"]
    argv += list(spec.get("run_options", []))
    argv += [spec["image"]] + base_argv
    return argv

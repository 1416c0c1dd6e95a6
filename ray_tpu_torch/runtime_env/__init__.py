"""Runtime environments — per-task/actor execution environments.

Reference analog: `python/ray/runtime_env/` (user API) +
`python/ray/_private/runtime_env/` (plugins: `working_dir.py`,
`py_modules.py`, `pip.py`, `conda.py`, plugin system `plugin.py`, served by
the per-node agent `agent/runtime_env_agent.py:161`).

Redesign (TPU-first, zero-egress aware):
  * `env_vars` — applied around task execution in the worker (persists for
    an actor's lifetime).
  * `working_dir` / `py_modules` — local dirs are content-hash packaged at
    submission into the session package root and unpacked once per worker
    node cache; applied as cwd / sys.path mutations around execution.
  * `pip` — requirement availability is VERIFIED against the worker's
    interpreter (distribution metadata first, import fallback); missing
    requirements raise `RuntimeEnvSetupError` exactly like the reference's
    failed env setup. RAY_TPU_RUNTIME_ENV_ALLOW_PIP=1 additionally installs
    missing requirements into the (shared, non-isolated) worker interpreter
    — a bootstrap escape hatch for images with an index, not per-task
    isolation.
  * `conda` / `container` — WORKER-LEVEL isolation (these can't be applied
    inside a running interpreter): the scheduler keys workers by isolation
    hash and the node agent spawns them through `conda run` / `podman run`
    (see `isolation.py`; reference: `_private/runtime_env/conda.py`,
    `container.py`). Gated on the binary existing on the node; conda env
    CREATION from spec dicts stays rejected (zero-egress image).
  * custom plugins — `register_plugin(name, plugin)` with driver-side
    `prepare` and worker-side `apply` hooks.
"""

from __future__ import annotations

import importlib
import os
import re
import sys
from typing import Any, Callable, Dict, List, Optional

from .packaging import ensure_unpacked, package_directory

KNOWN_FIELDS = {
    "env_vars",
    "working_dir",
    "py_modules",
    "pip",
    "conda",
    "container",
    "config",
    # Internal (driver-prepared) fields:
    "_working_dir_pkg",
    "_py_module_pkgs",
}


class RuntimeEnvSetupError(RuntimeError):
    """Environment could not be set up on the worker (reference:
    `ray.exceptions.RuntimeEnvSetupError`)."""


class RuntimeEnvPlugin:
    """Custom plugin seam (reference: `_private/runtime_env/plugin.py`).

    `prepare` runs on the driver at submission (package/validate);
    `apply` runs on the worker around execution and returns a restore
    callable (or None)."""

    def prepare(self, value: Any, session_dir: str) -> Any:
        return value

    def apply(self, value: Any, session_dir: str) -> Optional[Callable[[], None]]:
        return None


_PLUGINS: Dict[str, RuntimeEnvPlugin] = {}


def register_plugin(name: str, plugin: RuntimeEnvPlugin):
    if name in KNOWN_FIELDS:
        raise ValueError(f"'{name}' is a builtin runtime_env field")
    _PLUGINS[name] = plugin


class RuntimeEnv(dict):
    """Validated runtime_env mapping (reference:
    `python/ray/runtime_env/runtime_env.py`)."""

    def __init__(self, **kwargs):
        validate(kwargs)
        super().__init__(**kwargs)


def validate(renv: dict):
    for key, value in renv.items():
        if key not in KNOWN_FIELDS and key not in _PLUGINS:
            raise ValueError(
                f"Unknown runtime_env field '{key}' "
                f"(known: {sorted(KNOWN_FIELDS - {'_working_dir_pkg', '_py_module_pkgs'})}, "
                f"plugins: {sorted(_PLUGINS)})"
            )
        if key == "env_vars":
            if not isinstance(value, dict) or not all(
                isinstance(k, str) for k in value
            ):
                raise ValueError("runtime_env env_vars must be a str-keyed dict")
        if key == "working_dir" and not isinstance(value, str):
            raise ValueError("runtime_env working_dir must be a directory path")
        if key == "py_modules" and not isinstance(value, (list, tuple)):
            raise ValueError("runtime_env py_modules must be a list of paths")
        if key == "pip":
            if isinstance(value, dict):
                value = value.get("packages", [])
            if not isinstance(value, (list, tuple)):
                raise ValueError("runtime_env pip must be a list of requirements")
        if key in ("conda", "container"):
            from .isolation import validate_spec

            validate_spec(key, value)


# ------------------------------------------------------------- driver side
def pkg_root_for(session_dir: str) -> str:
    return os.path.join(session_dir, "runtime_env_packages")


def prepare_runtime_env(renv: Optional[dict], session_dir: str) -> Optional[dict]:
    """Submission-time transform: package local dirs into the session package
    root so any worker (node) can unpack them. Idempotent — already-prepared
    envs pass through."""
    if not renv:
        return renv
    validate(renv)
    out = dict(renv)
    root = pkg_root_for(session_dir)
    if renv.get("working_dir") and "_working_dir_pkg" not in renv:
        out["_working_dir_pkg"] = package_directory(renv["working_dir"], root)
    if renv.get("py_modules") and "_py_module_pkgs" not in renv:
        out["_py_module_pkgs"] = [
            package_directory(p, root) for p in renv["py_modules"]
        ]
    # Custom plugins ship BY VALUE (cloudpickle) so workers need no import
    # path or registry of their own (redesign of the reference's
    # RAY_RUNTIME_ENV_PLUGINS class-path env var).
    import cloudpickle

    for name, plugin in _PLUGINS.items():
        if name in out and not (
            isinstance(out[name], dict) and "__plugin__" in out[name]
        ):
            out[name] = {
                "__plugin__": cloudpickle.dumps(plugin),
                "value": plugin.prepare(out[name], session_dir),
            }
    return out


# ------------------------------------------------------------- worker side
_REQ_SPLIT = re.compile(r"[<>=!~\[;]")


def _requirement_available(req: str) -> bool:
    name = _REQ_SPLIT.split(req)[0].strip()
    # Distribution lookup first — module names often differ from PyPI names
    # (pillow→PIL, scikit-learn→sklearn); import guess only as fallback.
    try:
        import importlib.metadata as md

        md.distribution(re.sub(r"[-_.]+", "-", name))
        return True
    except Exception:  # noqa: BLE001 — PackageNotFoundError and exotica
        pass
    try:
        importlib.import_module(name.replace("-", "_"))
        return True
    except ImportError:
        return False


def _check_pip(requirements) -> None:
    if isinstance(requirements, dict):
        requirements = requirements.get("packages", [])
    missing = [req for req in requirements if not _requirement_available(req)]
    if not missing:
        return
    if os.environ.get("RAY_TPU_RUNTIME_ENV_ALLOW_PIP") == "1":
        # Deliberately NOT isolated: installs into the worker interpreter and
        # persists for the process (a bootstrap escape hatch, not per-task
        # isolation — bake real deps into the image).
        import subprocess

        subprocess.check_call(
            [sys.executable, "-m", "pip", "install", *missing]
        )
        return
    raise RuntimeEnvSetupError(
        f"runtime_env pip requirements not available in the worker image: "
        f"{missing}. This environment has no package egress; bake the "
        "dependency into the image or set RAY_TPU_RUNTIME_ENV_ALLOW_PIP=1 "
        "where an index is reachable."
    )


def apply_runtime_env(
    renv: Optional[dict], cache_root: str
) -> Callable[[], None]:
    """Apply working_dir / py_modules / pip / plugins on the worker; returns
    a restore closure (env_vars are handled by the caller, which owns the
    process env lock)."""
    if not renv:
        return lambda: None
    restores: List[Callable[[], None]] = []
    try:
        if renv.get("pip"):
            _check_pip(renv["pip"])
        if renv.get("_py_module_pkgs"):
            added = []
            for pkg in renv["_py_module_pkgs"]:
                d = ensure_unpacked(pkg, cache_root)
                sys.path.insert(0, d)
                added.append(d)

            def _pop_modules(added=added):
                for d in added:
                    try:
                        sys.path.remove(d)
                    except ValueError:
                        pass

            restores.append(_pop_modules)
        if renv.get("_working_dir_pkg"):
            d = ensure_unpacked(renv["_working_dir_pkg"], cache_root)
            old_cwd = os.getcwd()
            os.chdir(d)
            sys.path.insert(0, d)

            def _restore_cwd(d=d, old_cwd=old_cwd):
                try:
                    sys.path.remove(d)
                except ValueError:
                    pass
                try:
                    os.chdir(old_cwd)
                except OSError:
                    pass

            restores.append(_restore_cwd)
        elif renv.get("working_dir"):
            # Unpackaged path (e.g. local_mode or same-host job): use as-is.
            old_cwd = os.getcwd()
            os.chdir(renv["working_dir"])

            def _restore_plain(old_cwd=old_cwd):
                try:
                    os.chdir(old_cwd)
                except OSError:
                    pass

            restores.append(_restore_plain)
        for name, value in renv.items():
            if isinstance(value, dict) and "__plugin__" in value:
                import cloudpickle

                plugin = cloudpickle.loads(value["__plugin__"])
                r = plugin.apply(value["value"], cache_root)
                if r is not None:
                    restores.append(r)
    except BaseException:
        for r in reversed(restores):
            r()
        raise

    def restore_all():
        for r in reversed(restores):
            r()

    return restore_all

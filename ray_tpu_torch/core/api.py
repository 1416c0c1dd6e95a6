"""Module-level public API (reference: `python/ray/_private/worker.py`).

`init` (`worker.py:1227`), `get` (`:2575`), `put` (`:2687`), `wait`, `kill`,
`cancel`, `remote`, `get_actor`, `nodes`, `cluster_resources`,
`available_resources`, `shutdown`, `is_initialized`.
"""

from __future__ import annotations

import atexit
import inspect
import os
import threading
from typing import Any, List, Optional, Sequence, Tuple, Union

import cloudpickle

from .actor import ActorClass, ActorHandle
from .devices import ACCELERATOR  # the GPU worker kind (reference: none)
from .exceptions import RayTpuError
from .ids import JobID
from .object_ref import ObjectRef
from .remote_function import RemoteFunction, options_from_kwargs
from .runtime import Runtime
from .task_spec import TaskOptions

_runtime: Optional[Runtime] = None
_runtime_lock = threading.RLock()
_runtime_factory = None
_job_counter = 0


def set_runtime_factory(factory) -> None:
    """Deferred worker bootstrap: `factory()` builds and installs this
    process's Runtime (via set_global_runtime) on FIRST API use. Workers
    set this instead of connecting a full client backend at boot — actors
    and tasks that never call the API back into the runtime skip that cost
    entirely (it dominated fork-to-ready time on the bench host)."""
    global _runtime_factory
    _runtime_factory = factory


def _global_runtime() -> Runtime:
    global _runtime
    if _runtime is None:
        with _runtime_lock:
            if _runtime is None:
                if _runtime_factory is not None:
                    _runtime_factory()
                else:
                    init()
    return _runtime


def _runtime_or_attach() -> Optional[Runtime]:
    """Runtime if this process has one (or a pending worker factory, which
    is forced — the same cost any API call pays). Never BOOTS a runtime
    from a plain script: observability helpers (metrics, tracing) use this
    so an un-inited process stays un-inited."""
    rt = _runtime_if_initialized()
    if rt is None and is_initialized():
        rt = _global_runtime()
    return rt


def _runtime_if_initialized() -> Optional[Runtime]:
    """Lock-free, non-initializing peek at the runtime. The ONLY safe
    accessor from __del__/GC paths: a destructor can fire on ANY thread —
    including a backend's io loop thread during init(), while the MAIN
    thread holds _runtime_lock waiting on that same loop. _global_runtime()
    there deadlocks the client (observed: connect coroutines frozen
    mid-sock_connect for the full timeout)."""
    return _runtime


def set_global_runtime(runtime: Optional[Runtime]):
    """Install the process-wide runtime (used by worker bootstrap)."""
    global _runtime
    _runtime = runtime


def is_initialized() -> bool:
    # A worker with a pending runtime factory IS part of an initialized
    # session — the runtime just hasn't been forced yet.
    return _runtime is not None or _runtime_factory is not None


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,  # reference: num_tpus, ray_tpu/core/api.py:91
    resources: Optional[dict] = None,
    local_mode: bool = False,
    namespace: Optional[str] = None,
    ignore_reinit_error: bool = False,
    object_store_memory: Optional[int] = None,
    log_to_driver: bool = True,
    _node_cpus: Optional[float] = None,
    **_ignored,
) -> "RuntimeContextInfo":
    """Start (or connect to) the runtime.

    * ``local_mode=True`` → in-process thread-pool plane.
    * default → per-machine cluster plane (shared-memory store + worker
      processes), auto-started if ``address`` is None.
    * ``address="<host:port>"`` → connect to an existing controller.
    * ``address="ray://<host:port>"`` → REMOTE-driver (client) mode:
      no shared-memory locality assumed; objects ride the RPC plane
      (reference analog: Ray Client, `python/ray/util/client`).
    """
    global _runtime, _job_counter
    remote_client = False
    if address and address.startswith("ray://"):
        address = address[len("ray://"):]
        remote_client = True
    with _runtime_lock:
        if _runtime is None and _runtime_factory is not None:
            _runtime_factory()  # worker: force the deferred bootstrap
        if _runtime is not None:
            if ignore_reinit_error:
                return RuntimeContextInfo(_runtime)
            raise RuntimeError("ray_tpu_torch.init() called twice; pass ignore_reinit_error=True.")

        _job_counter += 1
        job_id = JobID.from_int(os.getpid() % (2**24) * 100 + _job_counter)

        env_local = os.environ.get("RAY_TPU_LOCAL_MODE", "")
        if env_local == "1":
            local_mode = True

        if not local_mode:
            try:
                from .cluster_backend import ClusterBackend  # noqa: F401
            except ImportError:
                local_mode = True  # cluster plane not built yet; fall back

        if local_mode:
            from .local_backend import LocalBackend

            cpus = num_cpus if num_cpus is not None else float(os.cpu_count() or 8)
            # reference: _with_tpus(resources, num_tpus), ray_tpu/core/api.py:141
            backend = LocalBackend(num_cpus=max(cpus, 4.0), resources=_with_gpus(resources, num_gpus))
            runtime = Runtime(backend, job_id, address="local")
            backend.set_runtime(runtime)
        else:
            from .cluster_backend import ClusterBackend

            if remote_client and not address:
                raise ValueError("ray:// client mode requires a host:port")
            backend = ClusterBackend.connect_or_start(
                address=address,
                num_cpus=num_cpus if _node_cpus is None else _node_cpus,
                resources=_with_gpus(resources, num_gpus),  # reference: ray_tpu/core/api.py:152
                object_store_memory=object_store_memory,
                remote_client=remote_client,
            )
            runtime = Runtime(backend, job_id, address=backend.client_address)
            backend.set_runtime(runtime)
            if log_to_driver and os.environ.get("RAY_TPU_LOG_TO_DRIVER", "1") != "0":
                backend.start_log_tailer()

        _runtime = runtime
        atexit.register(_atexit_shutdown)
        return RuntimeContextInfo(runtime)


def _with_gpus(resources: Optional[dict], num_gpus: Optional[float]) -> dict:
    # reference: _with_tpus setting resources["TPU"], ray_tpu/core/api.py:166-169
    resources = dict(resources or {})
    if num_gpus is not None:
        resources[ACCELERATOR] = float(num_gpus)
    # Autodetect via the accelerator-manager plugin layer (reference:
    # `_private/accelerators/` consulted at node start). Explicit user
    # values always win.
    try:
        from ..util.accelerators import detect_node_accelerator_resources

        for key, val in detect_node_accelerator_resources().items():
            resources.setdefault(key, val)
    except Exception:  # noqa: BLE001
        pass
    return resources


def _atexit_shutdown():
    try:
        shutdown()
    except Exception:  # noqa: BLE001
        pass


def shutdown():
    global _runtime, _runtime_factory
    with _runtime_lock:
        _runtime_factory = None
        if _runtime is not None:
            _runtime.shutdown()
            _runtime = None


class RuntimeContextInfo:
    """Returned by `init`; context-manager for scoped clusters."""

    def __init__(self, runtime: Runtime):
        self._runtime = runtime

    @property
    def address_info(self) -> dict:
        return {"address": self._runtime.address, "job_id": self._runtime.job_id.hex()}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        shutdown()


# ----------------------------------------------------------------- core ops
def put(value: Any) -> ObjectRef:
    return _global_runtime().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None):
    return _global_runtime().get(refs, timeout)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    return _global_runtime().wait(refs, num_returns, timeout, fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle; use cancel() for tasks.")
    _global_runtime().backend.kill_actor(actor._id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    _global_runtime().backend.cancel(ref, force, recursive)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    handle = get_actor_or_none(name, namespace)
    if handle is None:
        raise ValueError(f"Failed to look up actor with name '{name}'")
    return handle


def get_actor_or_none(name: str, namespace: Optional[str] = None) -> Optional[ActorHandle]:
    state = _global_runtime().backend.get_named_actor(name, namespace or "default")
    if state is None:
        return None
    handle = cloudpickle.loads(state)
    assert isinstance(handle, ActorHandle), type(handle)
    return handle


# ----------------------------------------------------------------- cluster
def nodes() -> List[dict]:
    return _global_runtime().backend.nodes()


def cluster_resources() -> dict:
    return _global_runtime().backend.cluster_resources()


def available_resources() -> dict:
    return _global_runtime().backend.available_resources()


def timeline(filename: Optional[str] = None, *, raw: bool = False):
    """Task events for the live session (reference: `ray.timeline`).

    Returns the raw controller timeline events. With ``filename``, writes
    chrome://tracing / Perfetto-loadable JSON (spans + causality flow
    arrows via `util.tracing.chrome_trace_with_flows`); pass ``raw=True``
    to dump the raw event dicts instead.
    """
    events = _global_runtime().backend.state_summary().get("timeline", [])
    if filename:
        import json

        if raw:
            data = events
        else:
            from ..util.tracing import chrome_trace_with_flows

            data = chrome_trace_with_flows(events)
        with open(filename, "w") as f:
            json.dump(data, f)
    return events


# ----------------------------------------------------------------- remote
def remote(*args, **kwargs):
    """`@remote` / `@remote(num_cpus=..., ...)` for functions and classes."""

    def make(target):
        opts = TaskOptions()
        if kwargs:
            opts = options_from_kwargs(opts, **{k: v for k, v in kwargs.items() if k not in ("name", "namespace")})
        if inspect.isclass(target):
            ac = ActorClass(target, opts)
            if "name" in kwargs or "namespace" in kwargs:
                ac._pending_name = kwargs.get("name")
                ac._pending_namespace = kwargs.get("namespace")
            return ac
        if callable(target):
            return RemoteFunction(target, opts)
        raise TypeError(f"@remote target must be a function or class, got {type(target)}")

    if len(args) == 1 and callable(args[0]) and not kwargs:
        return make(args[0])
    if args:
        raise TypeError("@remote accepts only keyword options, e.g. @remote(num_cpus=2)")
    return make

"""Runtime — per-process façade that turns API calls into TaskSpecs.

Equivalent role to the reference's CoreWorker (`src/ray/core_worker/core_worker.cc`):
it owns the process's job/task context, builds TaskSpecs (`SubmitTask`
`core_worker.cc:1935`), allocates deterministic return ObjectIDs (object index
within creating task — `common/id.h:272`), and routes to the backend.
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from .backend import RuntimeBackend
from .exceptions import TaskError
from .ids import ActorID, JobID, ObjectID, TaskID
from .object_ref import ObjectRef
from .task_spec import TaskOptions, TaskSpec, TaskType

# Default CPU demand for tasks / actors (matches the reference's defaults:
# tasks require 1 CPU, actors require 0 by default for scheduling).
DEFAULT_TASK_CPUS = 1.0
DEFAULT_ACTOR_CPUS = 0.0


class _ArgRefMarker:
    """Placeholder for a top-level ObjectRef arg; resolved before execution."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __reduce__(self):
        return (_ArgRefMarker, (self.index,))


class CachedFuncBlob:
    """Pre-pickled function: the submitter walks the closure ONCE
    (cloudpickle.dumps of a function costs ~100µs+, the single largest
    per-submit cost) and ships the blob; executors cache the unpickled
    function by content hash. Reference analog: the function table —
    functions export once, tasks carry only the descriptor."""

    __slots__ = ("blob", "fhash", "name")

    def __init__(self, blob: bytes, fhash: str, name: str = "task"):
        self.blob = blob
        self.fhash = fhash
        self.name = name

    @property
    def __name__(self) -> str:  # submit paths read func.__name__
        return self.name

    def __reduce__(self):
        return (CachedFuncBlob, (self.blob, self.fhash, self.name))


# Exact types the submit payload fast path may plain-pickle (see
# _build_payload): primitives cannot nest ObjectRefs and pickle identically
# under pickle and cloudpickle; markers and the blob carry __reduce__.
_PLAIN_ARG_TYPES = frozenset(
    (int, float, str, bytes, bool, type(None), _ArgRefMarker)
)
_PLAIN_FUNC_TYPES = frozenset((CachedFuncBlob, type(None)))


_FUNC_CACHE: Dict[str, Any] = {}
_FUNC_CACHE_ORDER: List[str] = []


def resolve_func(obj: Any) -> Any:
    """Executor side: CachedFuncBlob → function (hash-cached, bounded)."""
    if not isinstance(obj, CachedFuncBlob):
        return obj
    fn = _FUNC_CACHE.get(obj.fhash)
    if fn is None:
        fn = cloudpickle.loads(obj.blob)
        _FUNC_CACHE[obj.fhash] = fn
        _FUNC_CACHE_ORDER.append(obj.fhash)
        if len(_FUNC_CACHE_ORDER) > 512:
            _FUNC_CACHE.pop(_FUNC_CACHE_ORDER.pop(0), None)
    return fn


class TaskContext(threading.local):
    """Per-thread execution context: which task is running here."""

    def __init__(self):
        self.task_id: Optional[TaskID] = None
        self.actor_id: Optional[ActorID] = None
        # Dapper-style trace id this thread's submissions inherit (set by the
        # executing worker from spec.trace_id, or explicitly via
        # `util.tracing.set_trace_id` at a request entry point like the
        # Serve HTTP proxy).
        self.trace_id: Optional[str] = None


class Runtime:
    def __init__(self, backend: RuntimeBackend, job_id: JobID,
                 address: str = "local", context: Optional[TaskContext] = None):
        self.backend = backend
        self.job_id = job_id
        self.address = address
        self.driver_task_id = TaskID.for_driver(job_id)
        # Workers pass their own pre-existing context so task ids recorded
        # BEFORE the lazy runtime materialized (on any thread) stay visible
        # — a replay-on-init would only cover the initializing thread.
        self._context = context if context is not None else TaskContext()
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ ctx
    @property
    def current_task_id(self) -> TaskID:
        return self._context.task_id or self.driver_task_id

    @property
    def current_trace_id(self) -> str:
        return getattr(self._context, "trace_id", None) or ""

    def set_task_context(self, task_id: Optional[TaskID], actor_id: Optional[ActorID] = None):
        self._context.task_id = task_id
        self._context.actor_id = actor_id

    # ------------------------------------------------------------------ put
    def put(self, value: Any) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("Calling put() on an ObjectRef is not allowed.")
        return self.backend.put(value, self.current_task_id.hex())

    # ------------------------------------------------------------------ get
    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        refs = [refs] if single else list(refs)
        if not all(isinstance(r, ObjectRef) for r in refs):
            raise TypeError(
                "get() expects an ObjectRef or a list of ObjectRefs, got "
                f"{[type(r).__name__ for r in refs if not isinstance(r, ObjectRef)]}"
            )
        values = self.backend.get(refs, timeout)
        out = []
        for v in values:
            if isinstance(v, TaskError):
                raise v.as_instanceof_cause()
            out.append(v)
        return out[0] if single else out

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        if isinstance(refs, ObjectRef):
            raise TypeError("wait() expects a list of ObjectRefs.")
        refs = list(refs)
        if len(set(refs)) != len(refs):
            raise ValueError("wait() expects a list of unique ObjectRefs.")
        if num_returns > len(refs):
            raise ValueError(f"num_returns={num_returns} > len(refs)={len(refs)}")
        return self.backend.wait(refs, num_returns, timeout)

    # ---------------------------------------------------------------- tasks
    def _next_task_id(self) -> TaskID:
        return TaskID.of(
            self._context.actor_id
            or ActorID(b"\xff" * 12 + self.job_id.binary())
        )

    def _build_payload(
        self, func_or_none: Any, args: tuple, kwargs: dict
    ) -> Tuple[bytes, List[ObjectRef]]:
        """Serialize (func, args, kwargs), extracting top-level ObjectRef args.

        Top-level ObjectRefs become markers resolved to values before execution
        (reference semantics); nested refs travel as refs.
        """
        refs: List[ObjectRef] = []

        def sub(x):
            if isinstance(x, ObjectRef):
                refs.append(x)
                return _ArgRefMarker(len(refs) - 1)
            return x

        args2 = tuple(sub(a) for a in args)
        kwargs2 = {k: sub(v) for k, v in kwargs.items()}
        # Payload fast path: a pre-pickled function blob with primitive args
        # needs none of cloudpickle's by-value machinery — plain C pickle is
        # ~10× cheaper per call and was the submit loop's largest single
        # cost after the blob cache. Exact-type checks keep anything that
        # could pickle DIFFERENTLY under cloudpickle (closures, __main__
        # classes, containers that might nest refs) on the safe path.
        if (
            type(func_or_none) in _PLAIN_FUNC_TYPES
            and all(type(a) in _PLAIN_ARG_TYPES for a in args2)
            and all(type(v) in _PLAIN_ARG_TYPES for v in kwargs2.values())
        ):
            import pickle as _pickle

            payload = _pickle.dumps((func_or_none, args2, kwargs2), protocol=5)
            nested: List[str] = []  # primitives cannot nest refs
        else:
            from .serialization import CONTAINED

            CONTAINED.active = nested = []
            try:
                payload = cloudpickle.dumps((func_or_none, args2, kwargs2))
            finally:
                CONTAINED.active = None
        # Any ref escaping this process (top-level arg or nested in the
        # payload) must exist in the shared object directory — publish
        # locally-owned direct results first (no-op for classic refs).
        escaping = [r.id.hex() for r in refs] + nested
        if escaping:
            publish = getattr(self.backend, "ensure_published", None)
            if publish is not None:
                publish(escaping)
        return payload, refs

    def submit_task(
        self,
        func: Any,
        args: tuple,
        kwargs: dict,
        options: TaskOptions,
    ):
        task_id = self._next_task_id()
        options = self._prepare_runtime_env(options)
        payload, arg_refs = self._build_payload(func, args, kwargs)
        num_returns = options.num_returns
        streaming = num_returns == -1  # canonical sentinel (TaskOptions)
        if streaming:
            return_ids: List[ObjectID] = []
        else:
            return_ids = [ObjectID.of(task_id, i) for i in range(max(num_returns, 1))]
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            task_type=TaskType.NORMAL_TASK,
            parent_task_id=self.current_task_id,
            trace_id=self.current_trace_id,
            func_payload=payload,
            arg_refs=[r.id for r in arg_refs],
            num_returns=num_returns,
            return_ids=return_ids,
            resources=options.resource_demand(DEFAULT_TASK_CPUS),
            options=options,
            name=options.name or getattr(func, "__name__", "task"),
            owner_address=self.address,
        )
        self.backend.submit_task(spec)
        if streaming:
            from .object_ref import ObjectRefGenerator

            return ObjectRefGenerator(task_id, self.address)
        return [ObjectRef(oid, self.address) for oid in return_ids]

    def _prepare_runtime_env(self, options: TaskOptions) -> TaskOptions:
        """Submission-time runtime_env validation + packaging (reference:
        driver-side upload in `_private/runtime_env/working_dir.py`)."""
        renv = options.runtime_env
        if not renv:
            return options
        import dataclasses

        from .. import runtime_env as renv_mod
        from .host_names import SESSION_ROOT  # (reference: "/tmp/ray_tpu", ray_tpu/core/runtime.py:272)

        session_dir = (
            getattr(self.backend, "session_dir", None)
            or os.environ.get("RAY_TPU_SESSION_DIR")
            or os.path.join(SESSION_ROOT, "local_session")  # (reference: ray_tpu/core/runtime.py:272)
        )
        prepared = renv_mod.prepare_runtime_env(renv, session_dir)
        if prepared == renv:
            return options
        return dataclasses.replace(options, runtime_env=prepared)

    # --------------------------------------------------------------- actors
    def create_actor(
        self,
        cls: Any,
        args: tuple,
        kwargs: dict,
        options: TaskOptions,
        name: str = "",
        namespace: str = "",
        method_meta: Optional[Dict[str, int]] = None,
    ) -> ActorID:
        actor_id = ActorID.of(self.job_id)
        task_id = self._next_task_id()
        options = self._prepare_runtime_env(options)
        payload, arg_refs = self._build_payload(cls, args, kwargs)
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            task_type=TaskType.ACTOR_CREATION_TASK,
            parent_task_id=self.current_task_id,
            trace_id=self.current_trace_id,
            func_payload=payload,
            arg_refs=[r.id for r in arg_refs],
            num_returns=0,
            return_ids=[],
            resources=options.resource_demand(DEFAULT_ACTOR_CPUS),
            options=options,
            name=name or getattr(cls, "__name__", "Actor"),
            actor_id=actor_id,
            owner_address=self.address,
            method_meta=method_meta or {},
        )
        self.backend.create_actor(spec, name, namespace)
        return actor_id

    def submit_actor_task(
        self,
        actor_id: ActorID,
        method_name: str,
        args: tuple,
        kwargs: dict,
        options: TaskOptions,
        sequence_number: int,
    ) -> List[ObjectRef]:
        task_id = TaskID.of(actor_id)
        payload, arg_refs = self._build_payload(None, args, kwargs)
        num_returns = options.num_returns
        # Streaming generator method (reference: `returns_dynamic` on
        # actor tasks) — items flow through the same stream bookkeeping
        # normal tasks use; the actor stays busy until the stream ends
        # (ordered per-actor delivery is preserved).
        streaming = num_returns == -1  # canonical sentinel (TaskOptions)
        if streaming:
            return_ids: List[ObjectID] = []
        else:
            return_ids = [ObjectID.of(task_id, i) for i in range(max(num_returns, 1))]
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            task_type=TaskType.ACTOR_TASK,
            parent_task_id=self.current_task_id,
            trace_id=self.current_trace_id,
            func_payload=payload,
            arg_refs=[r.id for r in arg_refs],
            num_returns=num_returns,
            return_ids=return_ids,
            resources={},
            options=options,
            name=method_name,
            actor_id=actor_id,
            method_name=method_name,
            sequence_number=sequence_number,
            owner_address=self.address,
        )
        self.backend.submit_actor_task(spec)
        if streaming:
            from .object_ref import ObjectRefGenerator

            return ObjectRefGenerator(task_id, self.address)
        return [ObjectRef(oid, self.address) for oid in return_ids]

    # -------------------------------------------------------------- futures
    def as_future(self, ref: ObjectRef) -> concurrent.futures.Future:
        fut = concurrent.futures.Future()

        def worker():
            try:
                fut.set_result(self.get(ref))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        return fut

    def as_asyncio_future(self, ref: ObjectRef):
        import asyncio

        loop = asyncio.get_event_loop()
        return asyncio.wrap_future(self.as_future(ref), loop=loop)

    def shutdown(self):
        self.backend.shutdown()


def resolve_payload(payload: bytes, resolved_args: List[Any]):
    """Deserialize a task payload, substituting resolved top-level arg values."""
    func, args, kwargs = cloudpickle.loads(payload)
    func = resolve_func(func)

    def sub(x):
        if isinstance(x, _ArgRefMarker):
            val = resolved_args[x.index]
            if isinstance(val, TaskError):
                raise val.as_instanceof_cause()
            return val
        return x

    args = tuple(sub(a) for a in args)
    kwargs = {k: sub(v) for k, v in kwargs.items()}
    return func, args, kwargs

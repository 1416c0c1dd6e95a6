"""LocalBackend — in-process execution plane.

Reference analog: `ray.init(local_mode=True)`. Tasks run on a thread pool,
actors get a dedicated serial executor (preserving per-actor call ordering,
like the reference's `ActorSchedulingQueue`), objects live in a dict. Used by
tests and as a fallback when no cluster is desired.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from .backend import RuntimeBackend
from .exceptions import ActorDiedError, GetTimeoutError, TaskCancelledError, TaskError
from .ids import ActorID, ObjectID, PlacementGroupID, TaskID
from .object_ref import ObjectRef
from .task_spec import TaskSpec, TaskType


class _ObjectTable:
    """In-memory object table with blocking get (condition-variable based)."""

    def __init__(self):
        self._values: Dict[ObjectID, Any] = {}
        self._cv = threading.Condition()

    def put(self, oid: ObjectID, value: Any):
        with self._cv:
            self._values[oid] = value
            self._cv.notify_all()

    def contains(self, oid: ObjectID) -> bool:
        with self._cv:
            return oid in self._values

    def get(self, oid: ObjectID, timeout: Optional[float]) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while oid not in self._values:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError(f"Timed out getting object {oid.hex()}")
                self._cv.wait(timeout=remaining if remaining is None else min(remaining, 1.0))
            return self._values[oid]

    def wait_any(self, oids: Sequence[ObjectID], num_returns: int, timeout: Optional[float]):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                ready = [o for o in oids if o in self._values]
                if len(ready) >= num_returns:
                    return ready
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return ready
                self._cv.wait(timeout=remaining if remaining is None else min(remaining, 1.0))


class _LocalActor:
    def __init__(self, actor_id: ActorID, max_concurrency: int = 1):
        self.actor_id = actor_id
        self.instance: Any = None
        self.executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, max_concurrency), thread_name_prefix=f"actor-{actor_id.hex()[:8]}"
        )
        self.dead = False
        self.init_error: Optional[TaskError] = None
        # With max_concurrency > 1, method tasks may be picked up by a second
        # executor thread while __init__ is still running — gate on this.
        self.initialized = threading.Event()


class LocalBackend(RuntimeBackend):
    def __init__(self, num_cpus: float = 8.0, resources: Optional[dict] = None):
        self._objects = _ObjectTable()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=int(max(4, num_cpus)), thread_name_prefix="task"
        )
        self._actors: Dict[ActorID, _LocalActor] = {}
        # (namespace, name) -> (actor_id, pickled ActorHandle)
        self._named_actors: Dict[Tuple[str, str], Tuple[ActorID, bytes]] = {}
        self._cancelled: set = set()
        self._streams: Dict[str, dict] = {}  # streaming-generator progress
        self._lock = threading.Lock()
        self._resources = {"CPU": float(num_cpus), **(resources or {})}
        self._pgs: Dict[PlacementGroupID, dict] = {}
        self._runtime = None  # set by api.init
        self._put_idx = 0

    def set_runtime(self, runtime):
        self._runtime = runtime

    # ---------------------------------------------------------------- store
    def put(self, value: Any, owner_task_hex: str) -> ObjectRef:
        with self._lock:
            self._put_idx += 1
            idx = self._put_idx
        oid = ObjectID.of(TaskID.from_hex(owner_task_hex), 2**20 + idx)
        self._objects.put(oid, value)
        return ObjectRef(oid, "local")

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float]) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for r in refs:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            out.append(self._objects.get(r.id, remaining if timeout is not None else None))
        return out

    def wait(self, refs, num_returns, timeout):
        ready_ids = self._objects.wait_any([r.id for r in refs], num_returns, timeout)
        ready_set = set(ready_ids)
        ready = [r for r in refs if r.id in ready_set][:num_returns]
        ready_final = set(r.id for r in ready)
        not_ready = [r for r in refs if r.id not in ready_final]
        return ready, not_ready

    # ---------------------------------------------------------------- tasks
    def _resolve_args(self, spec: TaskSpec) -> List[Any]:
        return [self._objects.get(oid, None) for oid in spec.arg_refs]

    def _store_results(self, spec: TaskSpec, result: Any):
        n = spec.num_returns
        if n == 0:
            return
        if n == 1:
            self._objects.put(spec.return_ids[0], result)
        else:
            if not isinstance(result, tuple) or len(result) != n:
                err = TaskError(
                    ValueError(
                        f"Task {spec.name} declared num_returns={n} but returned "
                        f"{type(result).__name__}"
                    ),
                    "",
                    spec.name,
                )
                for oid in spec.return_ids:
                    self._objects.put(oid, err)
                return
            for oid, v in zip(spec.return_ids, result):
                self._objects.put(oid, v)

    def _store_error(self, spec: TaskSpec, err: TaskError):
        if spec.num_returns == -1:
            # Streaming spec has no return ids — end the stream with the
            # error so consumers raise instead of long-polling forever.
            self._end_stream(spec, error=err)
            return
        for oid in spec.return_ids:
            self._objects.put(oid, err)

    def _run_task(self, spec: TaskSpec):
        from .runtime import resolve_payload

        if spec.task_id in self._cancelled:
            err = TaskError(TaskCancelledError(), "", spec.name)
            self._store_error(spec, err)  # stream-aware
            return
        try:
            resolved = self._resolve_args(spec)
            func, args, kwargs = resolve_payload(spec.func_payload, resolved)
            if self._runtime is not None:
                self._runtime.set_task_context(spec.task_id)
            try:
                result = func(*args, **kwargs)
            finally:
                if self._runtime is not None:
                    self._runtime.set_task_context(None)
            import inspect

            if spec.num_returns == -1:  # streaming generator
                gen = result if inspect.isgenerator(result) else iter((result,))
                self._run_stream(spec, gen)
                return
            if inspect.isgenerator(result):
                result = tuple(result) if spec.num_returns > 1 else list(result)
            self._store_results(spec, result)
        except BaseException as e:  # noqa: BLE001
            err = TaskError(e, traceback.format_exc(), spec.name)
            if spec.num_returns == -1:
                self._end_stream(spec, error=err)
            else:
                self._store_error(spec, err)

    def _stream_state(self, task_hex: str) -> dict:
        with self._lock:
            s = self._streams.get(task_hex)
            if s is None:
                s = self._streams[task_hex] = {
                    "produced": 0, "done": False, "cv": threading.Condition()
                }
            return s

    def _run_stream(self, spec: TaskSpec, gen):
        s = self._stream_state(spec.task_id.hex())
        idx = 0
        try:
            for item in gen:
                self._objects.put(ObjectID.of(spec.task_id, idx), item)
                with s["cv"]:
                    idx += 1
                    s["produced"] = idx
                    s["cv"].notify_all()
        except BaseException as e:  # noqa: BLE001
            self._end_stream(spec, TaskError(e, traceback.format_exc(), spec.name), base=idx)
            return
        with s["cv"]:
            s["done"] = True
            s["cv"].notify_all()

    def _end_stream(self, spec: TaskSpec, error=None, base: int = 0):
        s = self._stream_state(spec.task_id.hex())
        with s["cv"]:
            if error is not None:
                self._objects.put(ObjectID.of(spec.task_id, base), error)
                s["produced"] = base + 1
            s["done"] = True
            s["cv"].notify_all()

    def stream_release(self, task_hex: str, from_index: int) -> None:
        with self._lock:
            s = self._streams.get(task_hex)
            if s is not None and s["done"]:
                self._streams.pop(task_hex, None)

    def stream_next(self, task_hex: str, index: int, timeout=300.0) -> str:
        s = self._stream_state(task_hex)
        deadline = None if timeout is None else time.monotonic() + timeout
        with s["cv"]:
            while True:
                if index < s["produced"]:
                    return "ready"
                if s["done"]:
                    return "end"
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError(f"stream item {index} timed out")
                s["cv"].wait(remaining if remaining is not None else 1.0)

    def submit_task(self, spec: TaskSpec) -> None:
        self._pool.submit(self._run_task, spec)

    # --------------------------------------------------------------- actors
    def create_actor(self, spec: TaskSpec, name: str, namespace: str) -> None:
        actor = _LocalActor(spec.actor_id, spec.options.max_concurrency)
        with self._lock:
            if name:
                key = (namespace or "default", name)
                if key in self._named_actors:
                    # Same contract as the cluster controller: duplicate names
                    # fail the creation (callers race on get-or-create).
                    raise ValueError(f"Actor name '{name}' already taken")
                from .actor import ActorHandle

                handle = ActorHandle(spec.actor_id, spec.name, dict(spec.method_meta))
                self._named_actors[key] = (spec.actor_id, cloudpickle.dumps(handle))
            self._actors[spec.actor_id] = actor

        def init():
            from .runtime import resolve_payload

            try:
                resolved = self._resolve_args(spec)
                cls, args, kwargs = resolve_payload(spec.func_payload, resolved)
                if self._runtime is not None:
                    self._runtime.set_task_context(spec.task_id, spec.actor_id)
                try:
                    actor.instance = cls(*args, **kwargs)
                finally:
                    if self._runtime is not None:
                        self._runtime.set_task_context(None)
            except BaseException as e:  # noqa: BLE001
                actor.init_error = TaskError(e, traceback.format_exc(), spec.name)
                actor.dead = True
            finally:
                actor.initialized.set()

        actor.executor.submit(init)

    def submit_actor_task(self, spec: TaskSpec) -> None:
        actor = self._actors.get(spec.actor_id)
        if actor is None or actor.dead:
            err = actor.init_error if actor and actor.init_error else None
            self._store_error(
                spec, err or TaskError(ActorDiedError(), "", spec.name)
            )
            return

        def run():
            from .runtime import resolve_payload

            actor.initialized.wait()
            if actor.dead:
                self._store_error(
                    spec, actor.init_error or TaskError(ActorDiedError(), "", spec.name)
                )
                return
            try:
                resolved = self._resolve_args(spec)
                _, args, kwargs = resolve_payload(spec.func_payload, resolved)
                method = getattr(actor.instance, spec.method_name)
                if self._runtime is not None:
                    self._runtime.set_task_context(spec.task_id, spec.actor_id)
                try:
                    result = method(*args, **kwargs)
                    if spec.num_returns == -1:  # streaming actor method
                        import inspect

                        gen = (
                            result
                            if inspect.isgenerator(result)
                            else iter((result,))
                        )
                        self._run_stream(spec, gen)
                        return
                finally:
                    if self._runtime is not None:
                        self._runtime.set_task_context(None)
                self._store_results(spec, result)
            except BaseException as e:  # noqa: BLE001
                self._store_error(spec, TaskError(e, traceback.format_exc(), spec.name))

        actor.executor.submit(run)

    def kill_actor(self, actor_id: ActorID, no_restart: bool) -> None:
        actor = self._actors.get(actor_id)
        if actor is not None:
            # Mark dead but let queued tasks drain: each queued run() observes
            # `dead` and stores ActorDiedError on its return refs, so pending
            # get() calls fail instead of hanging (no cancel_futures here).
            actor.dead = True
            actor.initialized.set()
            actor.executor.shutdown(wait=False)
        with self._lock:
            for key, (aid, _) in list(self._named_actors.items()):
                if aid == actor_id:
                    del self._named_actors[key]

    def cancel(self, ref: ObjectRef, force: bool, recursive: bool) -> None:
        self._cancelled.add(ref.id.task_id())
        if not self._objects.contains(ref.id):
            self._objects.put(ref.id, TaskError(TaskCancelledError(), "", "task"))

    def get_named_actor(self, name: str, namespace: str) -> Optional[bytes]:
        entry = self._named_actors.get((namespace or "default", name))
        if entry is None:
            return None
        return entry[1]

    # ------------------------------------------------------------ resources
    def cluster_resources(self) -> Dict[str, float]:
        return dict(self._resources)

    def available_resources(self) -> Dict[str, float]:
        return dict(self._resources)

    def nodes(self) -> List[dict]:
        return [
            {
                "NodeID": "local",
                "Alive": True,
                "Resources": dict(self._resources),
                "NodeManagerAddress": "127.0.0.1",
            }
        ]

    # ----------------------------------------------------- placement groups
    def create_placement_group(self, pg_id, bundles, strategy, name) -> None:
        self._pgs[pg_id] = {"bundles": bundles, "strategy": strategy, "name": name}

    def placement_group_ready(self, pg_id, timeout) -> bool:
        return pg_id in self._pgs

    def remove_placement_group(self, pg_id) -> None:
        self._pgs.pop(pg_id, None)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
        for actor in self._actors.values():
            actor.executor.shutdown(wait=False, cancel_futures=True)
        self._actors.clear()

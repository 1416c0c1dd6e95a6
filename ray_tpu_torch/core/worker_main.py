"""Worker process — executes tasks and hosts actors.

Reference analog: `python/ray/_private/workers/default_worker.py` +
`CoreWorkerProcess::RunTaskExecutionLoop` (`_raylet.pyx:3269`) + the task
execution handler (`_raylet.pyx:2174`).

Threading model: an asyncio thread owns the controller connection; user code
runs on the MAIN thread via a queue (important for JAX/TPU: device runtimes
prefer main-thread init). Actors with max_concurrency > 1 get a thread pool.
"""

from __future__ import annotations

import collections
import concurrent.futures
import os
import queue
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import cloudpickle

from . import serialization, store
from .exceptions import TaskError
from .rpc import Connection, EventLoopThread, auth_token, open_rpc_connection
from .task_spec import TaskSpec


# Shared immutable-by-convention defaults for compact actor specs — the
# execution path only reads options (runtime_env / max_* untouched here).
from .task_spec import TaskOptions as _TaskOptions  # noqa: E402

_DEFAULT_ACTOR_OPTIONS = _TaskOptions()


def _spec_from_compact(c) -> TaskSpec:
    """Decode the direct actor-call wire form (direct.py _compact_actor_spec)
    — a plain tuple instead of the full proto (~25µs/call cheaper)."""
    from .ids import ActorID, JobID, ObjectID, TaskID
    from .task_spec import TaskType

    task_bytes, actor_bytes, method, payload, nret, arg_ref_bytes, seq, parent, trace = c
    task_id = TaskID(task_bytes)
    return TaskSpec(
        task_id=task_id,
        job_id=task_id.job_id(),
        task_type=TaskType.ACTOR_TASK,
        func_payload=payload,
        arg_refs=[ObjectID(b) for b in arg_ref_bytes],
        num_returns=nret,
        return_ids=(
            [] if nret == -1
            else [ObjectID.of(task_id, i) for i in range(max(nret, 1))]
        ),
        resources={},
        options=_DEFAULT_ACTOR_OPTIONS,
        name=method,
        actor_id=ActorID(actor_bytes),
        method_name=method,
        sequence_number=seq,
        parent_task_id=TaskID(parent) if parent else None,
        trace_id=trace,
    )


def _spec_from_compact_task(c) -> TaskSpec:
    """Decode the NORMAL direct-task wire form (direct.py
    _compact_task_spec): a plain list instead of the full proto — the
    proto encode/decode round trip measured ~100µs per task across both
    sides of the submit hot path. eligible() guarantees the omitted fields
    (arg_refs, runtime_env, scheduling strategy) are defaults."""
    from .ids import ObjectID, TaskID
    from .task_spec import TaskOptions, TaskType

    task_bytes, payload, nret, name, trace, parent, resources, retries, owner = c
    task_id = TaskID(task_bytes)
    return TaskSpec(
        task_id=task_id,
        job_id=task_id.job_id(),
        task_type=TaskType.NORMAL_TASK,
        func_payload=payload,
        arg_refs=[],
        num_returns=nret,
        return_ids=(
            [] if nret == -1
            else [ObjectID.of(task_id, i) for i in range(max(nret, 1))]
        ),
        resources=dict(resources),
        options=TaskOptions(num_returns=nret, max_retries=retries, name=name),
        name=name,
        parent_task_id=TaskID(parent) if parent else None,
        trace_id=trace,
        owner_address=owner,
    )


class WorkerProcess:
    def __init__(self, address: str, worker_id: str, session_dir: str):
        host, port = address.rsplit(":", 1)
        self.host, self.port = host, int(port)
        self.worker_id = worker_id
        self.session_dir = session_dir
        self.local_store = store.make_store()  # arena attach (tag already set)
        self.io = EventLoopThread(name=f"worker-{worker_id}-io")
        self.conn: Optional[Connection] = None
        self.task_queue: "queue.Queue[dict]" = queue.Queue()
        self.actor_instance: Any = None
        self._actor_hex: Optional[str] = None
        self.actor_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._stop = False
        # Task hexes cancelled while queued behind the current task
        # (controller "drop_task") — set from the io thread, read by the
        # main loop BEFORE executing each queued task.
        self._dropped: set = set()
        # Guards _dropped + _current_task_hex across the io thread (reclaim
        # requests) and the main loop (dequeue→execute transition): a reclaim
        # must land either strictly before execution starts (dropped=True) or
        # observe the task as started (dropped=False) — never in between.
        self._task_lock = threading.Lock()
        self._current_task_hex: Optional[str] = None
        # Recently completed task hexes (bounded): a reclaim for a task that
        # already EXECUTED must answer "not dropped" even after current has
        # moved on — a spurious drop would poison a later re-dispatch of the
        # same task id (retry/reconstruction) on this worker.
        self._done_hexes = collections.deque(maxlen=128)
        # Per-connection pending direct replies (backlog batching). The
        # lock covers on_nested_block calls from actor-pool threads.
        self._reply_lock = threading.Lock()
        self._reply_batch: Dict[Connection, list] = {}
        self._reply_batch_t0 = 0.0
        self._in_batch = False  # inside execute_actor_batch processing
        # Reply-hold bound: a batched completed reply must never wait out
        # the NEXT task's execution (observed: a fast task's result blind
        # to wait() for a 5s sleeper processed in the same burst). The io
        # loop flushes any batch older than the 2ms window, independent of
        # what the main thread is executing.
        self._reply_timer_scheduled = False
        # Timeline events for direct tasks (the controller never sees their
        # dispatch/done) — batched to the controller like the reference's
        # profile-event flushes, so tracing/state stay complete without a
        # per-task control-plane message.
        self._task_events: List[dict] = []
        # Storm protection: past this backlog, per-task timeline events are
        # COUNTED instead of recorded (one task_events_dropped marker ships
        # with the next flush). A 500k-task drain burst otherwise spends
        # more control-plane CPU narrating itself than executing — the
        # reference's profile-event channel drops under pressure too.
        self._task_events_cap = 4096
        self._task_events_dropped = 0
        # Lazily-built in-task API runtime (see _init_client_api): None until
        # user code actually calls back into the ray_tpu_torch API. The task
        # context lives in OUR TaskContext object, which the runtime adopts
        # at construction — ids recorded on any thread before the runtime
        # exists are visible through it afterwards.
        from .runtime import TaskContext

        self._runtime = None
        self._runtime_init_lock = threading.Lock()
        self._ctx_local = TaskContext()
        self._start_orphan_watchdog()

    def _set_ctx(self, task_id, actor_id=None, trace_id=None):
        """Record the current task/actor context (shared with the lazy API
        runtime by construction — see _init_client_api). `trace_id` is the
        Dapper-style trace this thread's nested submissions inherit."""
        self._ctx_local.task_id = task_id
        self._ctx_local.actor_id = actor_id
        self._ctx_local.trace_id = trace_id

    @staticmethod
    def _trace_of(spec: TaskSpec) -> str:
        """Effective trace id: inherited from the submitter, else this task
        roots its own trace."""
        return spec.trace_id or spec.task_id.hex()

    def _record_event(self, ev: dict):
        """Thread-safe append to the batched task_events channel (actor-pool
        threads record phases too; the flush swap runs under _reply_lock)."""
        with self._reply_lock:
            if len(self._task_events) >= self._task_events_cap:
                self._task_events_dropped += 1
                return
            self._task_events.append(ev)

    def _start_orphan_watchdog(self):
        """A STATELESS worker whose controller died must not linger: normally
        the connection close triggers exit, but a SIGKILLed controller can
        leave the close undetected (observed: orphans parked in queue.get for
        minutes, loading the machine). The unambiguous signal is the parent
        pid CHANGING (reparenting) — the literal value 1 is a healthy parent
        in containers, where the controller IS pid 1. Actor hosts are exempt
        — controller-FT re-adopts
        them after a restart, and they run their own reconnect grace logic."""
        parent0 = os.getppid()

        def watch():
            strikes = 0
            while not self._stop:
                time.sleep(5.0)
                if os.getppid() != parent0 and self.actor_instance is None:
                    strikes += 1
                    if strikes >= 2:  # ~10s of confirmed orphanhood
                        os._exit(0)
                else:
                    strikes = 0

        threading.Thread(target=watch, daemon=True, name="orphan-watchdog").start()

    # ------------------------------------------------- direct task plane
    # Reference analog: the core worker's own gRPC server receiving
    # PushNormalTask / actor pushes (`direct_task_transport.cc:241`) — the
    # submitter talks to this worker without the scheduler in the loop.
    async def _start_direct_server(self):
        import asyncio

        from . import config as rt_config

        node_ip = rt_config.get("node_ip")
        bind = rt_config.get("bind_address") or node_ip
        self._direct_server = await asyncio.start_server(
            self._on_direct_connection, host=bind, port=0
        )
        port = self._direct_server.sockets[0].getsockname()[1]
        self.direct_addr = f"{node_ip}:{port}"

    async def _on_direct_connection(self, reader, writer):
        conn = Connection(reader, writer, expected_token=auth_token())

        async def on_push(msg: dict):
            t = msg.get("type")
            if t == "direct_task":
                self.task_queue.put(
                    {"type": "execute_task", "spec": msg.get("spec"),
                     "ct": msg.get("c"), "deps": None, "direct_conn": conn}
                )
            elif t == "direct_task_batch":
                # One queue item per burst (the actor-batch discipline):
                # per-task queue traffic on this io thread competes with the
                # executing main thread for the GIL.
                self.task_queue.put(
                    {"type": "execute_task_batch", "items": msg["items"],
                     "direct_conn": conn}
                )
            elif t == "agent_task":
                # LocalDispatcher push (local_dispatch.py): CLASSIC result
                # semantics (task_done → controller) — only the done PING
                # returns on this conn so the agent can dispatch the next.
                self.task_queue.put(
                    {"type": "execute_task", "spec": msg["spec"],
                     "deps": msg.get("deps") or {}, "agent_conn": conn}
                )
            elif t == "direct_actor_task":
                self.task_queue.put(
                    {"type": "execute_actor_task", "c": msg["c"],
                     "deps": None, "direct_conn": conn}
                )
            elif t == "direct_actor_batch":
                # One queue item per burst — per-call queue traffic on this
                # io thread competes with the executing main thread.
                self.task_queue.put(
                    {"type": "execute_actor_batch", "items": msg["items"],
                     "direct_conn": conn}
                )
            elif t == "drop_task":
                with self._task_lock:
                    dropped = (
                        msg["task"] != self._current_task_hex
                        and msg["task"] not in self._done_hexes
                    )
                    if dropped:
                        self._dropped.add(msg["task"])
                if dropped:
                    await conn.send({"type": "direct_dropped", "task": msg["task"]})
            elif t == "drop_tasks":
                # Bulk steal (direct.py _steal_for): one frame carries every
                # task the submitter wants back from this worker; the acks
                # return as one frame too.
                acked = []
                with self._task_lock:
                    for task_hex in msg["tasks"]:
                        if (
                            task_hex != self._current_task_hex
                            and task_hex not in self._done_hexes
                        ):
                            self._dropped.add(task_hex)
                            acked.append(task_hex)
                if acked:
                    await conn.send(
                        {"type": "direct_dropped_batch", "tasks": acked}
                    )
            elif t == "lease_ping" and msg.get("req_id") is not None:
                # Stall-watchdog health probe: answering proves this conn's
                # read AND write paths plus the io loop are alive.
                await conn.respond(msg["req_id"], {"ok": True})

        conn.on_push = on_push
        conn.start()

    def _queue_direct_result(
        self, conn: Connection, spec: TaskSpec, results, spec_blob=None
    ):
        """Reply path with backlog batching: while more tasks wait in the
        queue, inline results accumulate and flush as ONE message per drain
        (syscall + wakeup per reply dominated the single-actor call rate)."""
        all_inline = all(
            r.get("inline") is not None and not r.get("contains") for r in results
        )
        if not all_inline:
            self._flush_direct_replies()
            self._send_direct_result(conn, spec, results, spec_blob=spec_blob)
            return
        schedule_timer = False
        with self._reply_lock:
            if not self._reply_batch:
                self._reply_batch_t0 = time.monotonic()
            self._reply_batch.setdefault(conn, []).append(
                {"task": spec.task_id.hex(), "results": results}
            )
            # Flush on: batch full, 2ms elapsed (a long task must never hold
            # earlier results hostage — submitters may be blocked on them),
            # or queue drained outside a burst.
            flush = (
                len(self._reply_batch[conn]) >= 128
                or time.monotonic() - self._reply_batch_t0 >= 0.002
                or (not self._in_batch and self.task_queue.empty())
            )
            if not flush and not self._reply_timer_scheduled:
                # Arm the io-loop backstop: if the main thread disappears
                # into a long execution, the batch still ships at ~2ms.
                self._reply_timer_scheduled = True
                schedule_timer = True
        if schedule_timer:
            try:
                self.io.loop.call_soon_threadsafe(self._arm_reply_timer)
            except RuntimeError:
                with self._reply_lock:
                    self._reply_timer_scheduled = False
        if flush:
            self._flush_direct_replies()

    def _arm_reply_timer(self):
        self.io.loop.call_later(0.002, self._reply_timer_fire)

    def _reply_timer_fire(self):
        with self._reply_lock:
            self._reply_timer_scheduled = False
        self._flush_direct_replies()

    def _flush_task_events(self):
        # Piggyback the flight-recorder ring on the batched task_events
        # channel — spans recorded by actor threads (engine steps, stage
        # slots) leave with the next flush instead of waiting out the
        # flight module's own flusher period. drain() is an atomic
        # pop-all, so the two shippers can never duplicate a span.
        from ..util import flight as _flight

        fevs = _flight.recorder().drain() if _flight.enabled() else []
        for ev in fevs:
            ev.setdefault("worker", self.worker_id)
        with self._reply_lock:
            if not self._task_events and not self._task_events_dropped \
                    and not fevs:
                return
            events, self._task_events = self._task_events, []
            dropped, self._task_events_dropped = self._task_events_dropped, 0
        if dropped:
            events.append(
                {"ts": time.time(), "event": "task_events_dropped",
                 "n": dropped, "worker": self.worker_id}
            )
        events.extend(fevs)
        self.send({"type": "task_events", "events": events})

    def _flush_direct_replies(self):
        with self._reply_lock:
            if not self._reply_batch:
                return
            batches, self._reply_batch = self._reply_batch, {}
        for conn, items in batches.items():
            try:
                if len(items) == 1:
                    conn.post({"type": "direct_done", **items[0]})
                else:
                    conn.post({"type": "direct_done_batch", "items": items})
            except ConnectionError:
                pass

    def _send_direct_result(
        self, conn: Connection, spec: TaskSpec, results, spec_blob=None
    ):
        """Result routing for a direct task: inline results ride the
        submitter socket; big / ref-carrying results register with the
        controller's object directory (the submitter resolves them there)."""
        task_hex = spec.task_id.hex()
        all_inline = all(
            r.get("inline") is not None and not r.get("contains") for r in results
        )
        try:
            if all_inline:
                conn.post(
                    {"type": "direct_done", "task": task_hex, "results": results}
                )
                return
            contains = [h for r in results for h in (r.get("contains") or ())]
            if contains:
                # A result may embed refs this worker owns only locally —
                # publish them before the directory learns the container.
                from . import api

                publish = getattr(
                    api._global_runtime().backend, "ensure_published", None
                )
                if publish is not None:
                    publish(contains)
            done = {"type": "task_done", "task": task_hex,
                    "results": results, "direct": True}
            if spec_blob is not None:
                # Registered results live in a node arena — ship the spec so
                # the controller can reconstruct them after a node death
                # (inline results live with the submitter; no lineage needed).
                # Compact-wire tasks re-encode here, off the inline fast path.
                if spec_blob == "lazy":
                    from .task_spec import spec_to_proto_bytes

                    spec_blob = spec_to_proto_bytes(spec)
                done["spec"] = spec_blob
            self.send(done)
            conn.post({"type": "direct_done", "task": task_hex, "registered": True})
        except ConnectionError:
            pass  # submitter gone; objects (if registered) outlive it

    # ----------------------------------------------------------------- io
    async def _connect(self):
        import asyncio

        reader, writer = await open_rpc_connection(self.host, self.port)
        conn = Connection(reader, writer, on_push=self._on_push, on_close=self._on_close)
        conn.start()
        self.conn = conn
        payload = {
            "type": "register_worker",
            "worker_id": self.worker_id,
            "pid": os.getpid(),
            "has_tpu": os.environ.get("RAY_TPU_WORKER_TPU") == "1",
            "node_id": os.environ.get("RAY_TPU_NODE_ID", "node0"),
            "direct_addr": getattr(self, "direct_addr", ""),
            # Isolation hash (conda/container) — self-reported so a
            # restarted controller re-adopts this worker into the RIGHT
            # env-keyed pool, not the plain one.
            "env_key": os.environ.get("RAY_TPU_ENV_KEY", ""),
        }
        if self.actor_instance is not None and self._actor_hex:
            payload["actor_hex"] = self._actor_hex  # controller-restart re-adoption
        t0 = time.time()
        out = await conn.request(payload)
        t1 = time.time()
        if isinstance(out, dict) and out.get("time") is not None:
            # RTT-midpoint clock alignment (see cluster_backend._connect):
            # flight-recorder spans from this worker land on the
            # controller's clock, not this host's.
            from ..util import flight

            flight.set_clock_offset(float(out["time"]) - (t0 + t1) / 2.0)
            flight.set_component("worker")

    async def _on_push(self, msg: dict):
        if msg.get("type") == "flight_pull":
            # On-demand flight-recorder flush (`ray-tpu flight` /
            # /api/flight poke every worker through the controller so the
            # merged export is current, not one flusher period stale).
            try:
                self._flush_task_events()
            except ConnectionError:
                pass
            return
        if msg.get("type") == "drop_task":
            # Out-of-band: must take effect before the queued execute_task
            # reaches the main loop.
            with self._task_lock:
                self._dropped.add(msg["task"])
            return
        if msg.get("type") == "reclaim_task":
            # Controller wants a queued (prefetched) task back for an idle
            # worker. Droppable only if execution has not started; executed
            # tasks stay silent — their task_done is already ahead of any
            # reply on the FIFO connection. The ack is a one-way push so a
            # slow reply can never be mistaken for a dead worker.
            hex_ = msg["task"]
            with self._task_lock:
                dropped = (
                    hex_ != self._current_task_hex and hex_ not in self._done_hexes
                )
                if dropped:
                    self._dropped.add(hex_)
            if dropped:
                await self.conn.send({"type": "task_dropped", "task": hex_})
            return
        self.task_queue.put(msg)

    async def _on_close(self):
        # Controller connection dropped. A plain worker exits; a worker
        # HOSTING AN ACTOR tries to reconnect — the controller may be
        # restarting from its snapshot (GCS-FT semantics: actor state
        # survives in this process, the directory re-adopts us).
        if self.actor_instance is not None:
            print(f"[worker {self.worker_id}] controller connection lost; "
                  "attempting reconnect (actor host)", flush=True)
            self.task_queue.put({"type": "reconnect"})
        else:
            self.task_queue.put({"type": "exit"})

    async def _reconnect(self, deadline_s: Optional[float] = None) -> bool:
        import asyncio
        import time as _time

        if deadline_s is None:
            from . import config as rt_config

            deadline_s = rt_config.get("head_reconnect_deadline_s")
        end = _time.monotonic() + deadline_s
        # Jittered capped-exponential backoff: at a 2,000-worker fleet, a
        # fixed 0.5s retry is a thundering herd that starves the very head
        # process everyone is waiting on (measured: loadavg 500+ on a
        # 1-vCPU host, head boot >60s).
        import random as _random

        delay = 0.5
        while _time.monotonic() < end:
            try:
                await self._connect()
                print(f"[worker {self.worker_id}] reconnected to controller", flush=True)
                # The nested API backend must follow — actor code calling
                # ray_tpu_torch.* would otherwise hit the dead socket. Only if it
                # was ever built (it is lazy); a fresh one connects cleanly.
                if self._runtime is not None and hasattr(
                    self._runtime.backend, "reconnect"
                ):
                    self._runtime.backend.reconnect()
                return True
            except (OSError, ConnectionError) as e:
                await asyncio.sleep(delay * (0.5 + _random.random()))
                delay = min(delay * 2, 5.0)
                err = e
        print(f"[worker {self.worker_id}] reconnect gave up: {err!r}", flush=True)
        return False

    def send(self, msg: dict):
        try:
            self.conn.post(msg)  # batched fire-and-forget (FIFO per conn)
        except ConnectionError:
            # Mid-outage result delivery is lost; the restarted controller's
            # retry/ref machinery handles it. Don't kill the worker thread.
            pass

    def on_nested_block(self):
        """User code on the MAIN thread is about to block (nested get):
        everything batched must go out first — a held-back reply could be
        exactly what the blocking get (transitively) waits on."""
        self._flush_direct_replies()
        self._flush_task_events()

    # ------------------------------------------------------------ obj I/O
    def read_location(self, loc: dict) -> Any:
        status = loc["status"]
        if status == "inline":
            return serialization.unpack(loc["data"])
        if status == "shm":
            return self.local_store.read(loc["name"])
        if status == "spilled":
            return self.local_store.read_from_file(loc["path"])
        raise RuntimeError(f"Cannot read object location {status}")

    def store_result(self, object_hex: str, value: Any) -> dict:
        payload, buffers = serialization.serialize(value)
        contains = serialization.last_contained_refs()
        size = serialization.packed_size(payload, buffers)
        if size <= store.INLINE_THRESHOLD:
            frame = bytearray(size)
            serialization.pack_into(payload, buffers, memoryview(frame))
            return {"id": object_hex, "inline": bytes(frame), "contains": contains}
        try:
            name, size = self.local_store.create_packed(object_hex, payload, buffers)
        except FileExistsError:
            name = store.shm_name_for(object_hex)
        return {"id": object_hex, "name": name, "size": size, "contains": contains}

    # -------------------------------------------------------------- tasks
    def _resolve(self, spec: TaskSpec, deps: Optional[Dict[str, dict]]) -> List[Any]:
        if deps is None:
            # Direct-path task: no controller-materialized dep map — fetch
            # through this worker's own API backend (blocks with the
            # worker_blocked grant release, like any nested get).
            if not spec.arg_refs:
                return []
            from . import api
            from .object_ref import ObjectRef

            backend = api._global_runtime().backend
            return backend.get(
                [ObjectRef(oid, _weak=True) for oid in spec.arg_refs], None
            )
        return [self.read_location(deps[oid.hex()]) for oid in spec.arg_refs]

    def _end_stream_with_error(self, spec: TaskSpec, err: "TaskError", index: int):
        """Terminate a streaming task: one error item at `index`, then
        end-of-stream (a waiting consumer must never hang)."""
        from .ids import ObjectID

        d = self.store_result(ObjectID.of(spec.task_id, index).hex(), err)
        self.send({"type": "stream_item", "task": spec.task_id.hex(),
                   "index": index, "item": d})
        self.send({"type": "task_done", "task": spec.task_id.hex(),
                   "results": [], "stream_count": index + 1})

    _ENV_LOCK = threading.RLock()  # os.environ is process-global

    @classmethod
    def _runtime_env_vars(cls, spec: TaskSpec):
        """Per-task/actor runtime_env: env vars applied here; working_dir /
        py_modules / pip / plugins via `ray_tpu_torch.runtime_env.apply_runtime_env`
        (reference: `_private/runtime_env/` agent-applied envs). Returns a
        restore closure; setup failure raises `RuntimeEnvSetupError`, failing
        the task like the reference's RUNTIME_ENV_SETUP_FAILED.

        Tasks CARRYING a runtime_env hold a process lock until restore — two
        concurrent actor methods (max_concurrency > 1) mutating the global
        environment (env/cwd/sys.path) would otherwise race. Tasks without
        one never touch the lock."""
        renv = spec.options.runtime_env or {}
        env_vars = renv.get("env_vars") or {}
        has_env = bool(
            renv.get("_working_dir_pkg")
            or renv.get("working_dir")
            or renv.get("_py_module_pkgs")
            or renv.get("pip")
            or any(
                isinstance(v, dict) and "__plugin__" in v for v in renv.values()
            )
        )
        if not env_vars and not has_env:
            return lambda: None
        cls._ENV_LOCK.acquire()
        saved = {k: os.environ.get(k) for k in env_vars}
        os.environ.update({k: str(v) for k, v in env_vars.items()})
        try:
            from ..runtime_env import apply_runtime_env
            from .host_names import SESSION_ROOT  # (reference: "/tmp/ray_tpu", ray_tpu/core/worker_main.py:652)

            cache_root = os.path.join(
                os.environ.get("RAY_TPU_SESSION_DIR", SESSION_ROOT),
                "runtime_env_cache",
            )
            restore_renv = apply_runtime_env(renv, cache_root)
        except BaseException:
            for k, old in saved.items():
                if old is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = old
            cls._ENV_LOCK.release()
            raise

        def restore():
            try:
                restore_renv()
                for k, old in saved.items():
                    if old is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = old
            finally:
                cls._ENV_LOCK.release()

        return restore

    def _flush_phases(self, spec: TaskSpec, phases):
        """Ship per-task phase spans (dep-fetch/deserialize/execute/store)
        through the batched task_events channel — the controller timeline
        nests them under the task via util/tracing. ONE compact event
        carries all phases (tracing.build_trace expands it): four dicts per
        task measured on the drain-throughput hot path."""
        if not phases:
            return
        self._record_event(
            {"ts": phases[0][1], "event": "task_phases",
             "task": spec.task_id.hex(), "trace": self._trace_of(spec),
             "worker": self.worker_id,
             "spans": [[name, t0, max(t1 - t0, 0.0)] for name, t0, t1 in phases]}
        )

    def _execute(
        self,
        spec: TaskSpec,
        deps: Optional[Dict[str, dict]],
        is_actor_method: bool,
        reply=None,
    ):
        from .runtime import resolve_payload

        results: List[dict] = []
        restore_once = None
        phases: List[tuple] = []  # (name, start, end) wall-clock
        try:
            t0 = time.time()
            resolved = self._resolve(spec, deps)
            t1 = time.time()
            phases.append(("dep_fetch", t0, t1))
            func, args, kwargs = resolve_payload(spec.func_payload, resolved)
            phases.append(("deserialize", t1, time.time()))
            if is_actor_method:
                func = getattr(self.actor_instance, spec.method_name)
            # Env setup BEFORE context: if it raises (RuntimeEnvSetupError),
            # no task context was set, so nothing leaks onto later work.
            restore_env = self._runtime_env_vars(spec)
            self._set_ctx(spec.task_id, spec.actor_id, self._trace_of(spec))
            streaming = spec.num_returns == -1
            _restored = [False]

            def restore_once():
                if not _restored[0]:
                    _restored[0] = True
                    restore_env()
                    self._set_ctx(None)

            t_exec = time.time()
            try:
                result = func(*args, **kwargs)
            finally:
                # Streaming tasks keep env + task context ALIVE past the call:
                # func() only built the lazy generator — its body runs during
                # iteration below and must still see cwd/sys.path/env_vars.
                if not streaming:
                    restore_once()
                    phases.append(("execute", t_exec, time.time()))
            import inspect

            if streaming:
                # Streaming generator (reference: `returns_dynamic`): each
                # yield becomes object (task_id, index) the moment it is
                # produced — consumers iterate while the task still runs.
                gen = result if inspect.isgenerator(result) else iter((result,))
                count = 0
                from .ids import ObjectID

                try:
                    for item in gen:
                        d = self.store_result(ObjectID.of(spec.task_id, count).hex(), item)
                        self.send({"type": "stream_item", "task": spec.task_id.hex(),
                                   "index": count, "item": d})
                        count += 1
                except BaseException as e:  # noqa: BLE001 — mid-stream error
                    err = TaskError(e, traceback.format_exc(), spec.name)
                    self._end_stream_with_error(spec, err, count)
                    return
                finally:
                    restore_once()
                    # Streaming: the generator body runs during iteration —
                    # the execute phase spans construction through last yield.
                    phases.append(("execute", t_exec, time.time()))
                self.send({"type": "task_done", "task": spec.task_id.hex(),
                           "results": [], "stream_count": count})
                return
            if inspect.isgenerator(result):
                result = tuple(result) if spec.num_returns > 1 else list(result)
            n = spec.num_returns
            t_store = time.time()
            if n == 1:
                results.append(self.store_result(spec.return_ids[0].hex(), result))
            elif n > 1:
                if not isinstance(result, tuple) or len(result) != n:
                    raise ValueError(
                        f"Task {spec.name} declared num_returns={n} but returned "
                        f"{type(result).__name__}"
                    )
                for oid, v in zip(spec.return_ids, result):
                    results.append(self.store_result(oid.hex(), v))
            phases.append(("store_result", t_store, time.time()))
        except BaseException as e:  # noqa: BLE001
            if restore_once is not None:
                restore_once()  # streaming path may still hold env + context
            err = TaskError(e, traceback.format_exc(), spec.name)
            if spec.num_returns == -1:
                # Pre-generator failure of a streaming task.
                self._end_stream_with_error(spec, err, 0)
                return
            results = [
                self.store_result(oid.hex(), err) for oid in spec.return_ids
            ]
        finally:
            self._flush_phases(spec, phases)
        if reply is not None:
            reply(results)
        else:
            self.send(
                {"type": "task_done", "task": spec.task_id.hex(), "results": results}
            )

    def _execute_task_fast(self, spec: TaskSpec, reply):
        """Hot path for simple direct NORMAL tasks (no arg refs, one
        return, no runtime_env, not streaming) — the actor fast path's
        twin. Skips the generic machinery (env save/restore closures,
        streaming plumbing, per-phase list juggling) that measured ~40% of
        a trivial task's worker-side cost; phase timestamps stay honest."""
        import inspect

        from .runtime import resolve_payload

        self._set_ctx(spec.task_id, None, self._trace_of(spec))
        t0 = time.time()
        try:
            func, args, kwargs = resolve_payload(spec.func_payload, ())
            t1 = time.time()
            result = func(*args, **kwargs)
            if inspect.isgenerator(result):
                result = list(result)
            t2 = time.time()
            results = [self.store_result(spec.return_ids[0].hex(), result)]
        except BaseException as e:  # noqa: BLE001
            err = TaskError(e, traceback.format_exc(), spec.name)
            t1 = t2 = time.time()
            results = [self.store_result(spec.return_ids[0].hex(), err)]
        finally:
            self._set_ctx(None)
        t3 = time.time()
        self._flush_phases(spec, [
            ("dep_fetch", t0, t0), ("deserialize", t0, t1),
            ("execute", t1, t2), ("store_result", t2, t3),
        ])
        reply(results)

    def _execute_actor_fast(self, spec: TaskSpec, reply):
        """Hot path for simple direct actor calls (no arg refs, one return,
        no runtime_env, no thread pool): skips the generic machinery that
        profiling showed dominating per-call cost."""
        import inspect

        self._set_ctx(spec.task_id, spec.actor_id, self._trace_of(spec))
        try:
            _, args, kwargs = cloudpickle.loads(spec.func_payload)
            result = getattr(self.actor_instance, spec.method_name)(*args, **kwargs)
            if inspect.isgenerator(result):
                result = list(result)
            results = [self.store_result(spec.return_ids[0].hex(), result)]
        except BaseException as e:  # noqa: BLE001
            err = TaskError(e, traceback.format_exc(), spec.name)
            results = [self.store_result(spec.return_ids[0].hex(), err)]
        finally:
            self._set_ctx(None)
        reply(results)

    def _create_actor(self, spec: TaskSpec, deps: Dict[str, dict]):
        from .runtime import resolve_payload

        try:
            resolved = self._resolve(spec, deps)
            cls, args, kwargs = resolve_payload(spec.func_payload, resolved)
            self._set_ctx(spec.task_id, spec.actor_id, self._trace_of(spec))
            # Actor env vars persist for the actor's lifetime (its process
            # is dedicated) — reference behavior for actor runtime_env.
            self._runtime_env_vars(spec)
            try:
                self.actor_instance = cls(*args, **kwargs)
                self._actor_hex = spec.actor_id.hex()
            finally:
                self._set_ctx(None)
            if spec.options.max_concurrency > 1:
                self.actor_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=spec.options.max_concurrency
                )
            self.send(
                {
                    "type": "actor_ready",
                    "actor": spec.actor_id.hex(),
                    "task": spec.task_id.hex(),
                    "error": None,
                }
            )
        except BaseException as e:  # noqa: BLE001
            err = TaskError(e, traceback.format_exc(), spec.name)
            self.send(
                {
                    "type": "actor_ready",
                    "actor": spec.actor_id.hex(),
                    "task": spec.task_id.hex(),
                    "error": serialization.pack(err),
                }
            )

    # --------------------------------------------------------------- loop
    def run(self):
        mark = getattr(self, "_boot_mark", lambda p: None)
        self.io.call(self._start_direct_server())
        mark("direct-server")
        self.io.call(self._connect())
        mark("connected")
        from . import api

        # DEFERRED bootstrap: the in-task API backend (its own RPC
        # connection + io thread) is built on first API use, not at boot —
        # fork-to-ready profiling showed it dominating worker start, and
        # most workers/actors never call back into the API at all.
        api.set_runtime_factory(self._init_client_api)
        first_msg = [True]
        while not self._stop:
            if self.task_queue.empty():
                if self._reply_batch:
                    self._flush_direct_replies()  # never strand a batched reply
                self._flush_task_events()
            elif len(self._task_events) >= 512:
                self._flush_task_events()
            msg = self.task_queue.get()
            if first_msg[0]:
                first_msg[0] = False
                mark("first-msg")
            mtype = msg["type"]
            if mtype == "exit":
                break
            if mtype == "reconnect":
                # NON-blocking: the head may be down for seconds, and this
                # thread is also the DIRECT execution loop — an actor must
                # keep answering direct calls through the whole outage
                # (blocking here froze every hosted actor for the
                # reconnect deadline). Failure to reconnect exits via the
                # queued message, after in-flight work drains. DEDUPED:
                # every failed attempt's conn close enqueues another
                # reconnect message, and concurrent loops double-register
                # (the stale conn's close then used to kill the live
                # registration on the controller).
                if getattr(self, "_reconnect_inflight", False):
                    continue
                self._reconnect_inflight = True

                def _done(fut):
                    ok = False
                    try:
                        ok = bool(fut.result())
                    except Exception:  # noqa: BLE001
                        ok = False
                    self._reconnect_inflight = False
                    if not ok:
                        self.task_queue.put({"type": "exit"})

                self.io.call_nowait(self._reconnect()).add_done_callback(_done)
                continue
            if mtype == "actor_handoff":
                # Direct actor-call fence: every classic call dispatched
                # before this marker is already behind us in this queue —
                # safe for the submitter to switch to the direct socket.
                self.send({"type": "handoff_ready", "token": msg["token"]})
                continue
            if mtype == "execute_actor_batch":
                conn = msg["direct_conn"]
                self._in_batch = True  # one reply flush per burst, not per call
                try:
                    for c in msg["items"]:
                        self._process_task_msg(
                            "execute_actor_task",
                            {"c": c, "deps": None, "direct_conn": conn},
                        )
                finally:
                    self._in_batch = False
                    self._flush_direct_replies()
                continue
            if mtype == "execute_task_batch":
                conn = msg["direct_conn"]
                self._in_batch = True  # one reply flush per burst, not per call
                try:
                    for ct in msg["items"]:
                        self._process_task_msg(
                            "execute_task",
                            {"ct": ct, "deps": None, "direct_conn": conn},
                        )
                finally:
                    self._in_batch = False
                    self._flush_direct_replies()
                continue
            if self._reply_batch:
                # Backlog batching must never hold a COMPLETED result
                # hostage behind the NEXT task's execution: with the queue
                # never empty (a burst arrived together), a fast task's
                # reply would otherwise wait out its successor entirely —
                # observed as a finished task invisible to wait() for the
                # whole 10 s of the sleeper behind it. Actor-call bursts
                # keep their one-flush-per-burst batching via _in_batch
                # (execute_actor_batch above); everything else ships
                # completed replies before the next execute begins.
                self._flush_direct_replies()
            self._process_task_msg(mtype, msg)
        self.local_store.close_all()
        dump = getattr(self, "_profile_dump", None)
        if dump is not None:
            dump()
        os._exit(0)

    def _process_task_msg(self, mtype: str, msg: dict):
        from .task_spec import spec_from_proto_bytes

        compact = msg.get("c")
        compact_task = msg.get("ct")
        # Drop check BEFORE the spec decode for the compact forms (the task
        # id is their first element): a bulk steal leaves thousands of
        # to-be-skipped frames in the queue, and decoding each one first
        # measured ~30% of the victim worker's drain-burst CPU.
        pre_hex = (
            compact[0].hex() if compact is not None
            else compact_task[0].hex() if compact_task is not None
            else None
        )
        if pre_hex is not None:
            with self._task_lock:
                if pre_hex in self._dropped:
                    self._dropped.discard(pre_hex)
                    return
        if compact is not None:
            spec = _spec_from_compact(compact)
        elif compact_task is not None:
            spec = _spec_from_compact_task(compact_task)
        else:
            spec = spec_from_proto_bytes(msg["spec"])
        deps = msg.get("deps", {})
        direct_conn = msg.get("direct_conn")
        reply = None
        if direct_conn is not None:
            # spec_blob: proto bytes when they rode the wire, the sentinel
            # "lazy" for compact normal tasks (re-encoded only on the rare
            # registered-result path so lineage survives), None for actor
            # calls (actor results are not reconstructible).
            blob = msg.get("spec")
            if blob is None and compact_task is not None:
                blob = "lazy"
            reply = (
                lambda results, s=spec, c=direct_conn, b=blob:
                self._queue_direct_result(c, s, results, spec_blob=b)
            )
        with self._task_lock:
            if spec.task_id.hex() in self._dropped:
                self._dropped.discard(spec.task_id.hex())
                skip = True  # dropped/reclaimed while queued — no task_done
            else:
                skip = False
                self._current_task_hex = spec.task_id.hex()
        if skip:
            return
        t_span = None
        if direct_conn is not None and self.actor_pool is None:
            task_hex = spec.task_id.hex()
            now = time.time()
            early = not self._in_batch and self.task_queue.empty()
            t_span = (now, early)
            if early:
                # Nothing queued behind: this may be a LONG task — make it
                # visible as RUNNING before execution starts. Burst tasks
                # skip this pair entirely and report ONE task_span event at
                # completion instead (7 dicts/task measured on the drain
                # hot path before the consolidation).
                self._task_events.append(
                    {"ts": now, "event": "task_submitted", "task": task_hex,
                     "name": spec.name,
                     "parent": spec.parent_task_id.hex()
                     if spec.parent_task_id else None,
                     "trace": spec.trace_id or None}
                )
                self._task_events.append(
                    {"ts": now, "event": "task_dispatched", "task": task_hex,
                     "worker": self.worker_id}
                )
                self._flush_task_events()
        if mtype == "execute_task":
            if (
                reply is not None
                and deps is None
                and not spec.arg_refs
                and spec.num_returns == 1
                and spec.options.runtime_env is None
            ):
                self._execute_task_fast(spec, reply)
            else:
                self._execute(spec, deps, is_actor_method=False, reply=reply)
            with self._task_lock:
                self._done_hexes.append(spec.task_id.hex())
            agent_conn = msg.get("agent_conn")
            if agent_conn is not None:
                try:
                    agent_conn.post(
                        {"type": "agent_task_done", "task": spec.task_id.hex()}
                    )
                except ConnectionError:
                    pass  # agent gone; controller owns the result anyway
            if t_span is not None:
                self._emit_task_span(spec, t_span)
        elif mtype == "create_actor":
            self._create_actor(spec, deps)
        elif mtype == "execute_actor_task":
            if self.actor_pool is not None:
                # Pool threads must not touch the main-thread reply batch.
                pool_reply = None
                if direct_conn is not None:
                    pool_reply = (
                        lambda results, s=spec, c=direct_conn:
                        self._send_direct_result(c, s, results)
                    )
                self.actor_pool.submit(self._execute, spec, deps, True, pool_reply)
            elif (
                reply is not None
                and spec.num_returns == 1
                and not spec.arg_refs
                and spec.options.runtime_env is None
            ):
                self._execute_actor_fast(spec, reply)
                if t_span is not None:
                    self._emit_task_span(spec, t_span)
            else:
                self._execute(spec, deps, is_actor_method=True, reply=reply)
                if t_span is not None:
                    self._emit_task_span(spec, t_span)

    def _emit_task_span(self, spec: TaskSpec, t_span):
        """One consolidated timeline event per completed direct task:
        submit/dispatch/done timestamps + identity in a single dict
        (tracing.build_trace expands it; the controller's running view
        only needs the pop when the early RUNNING pair was emitted)."""
        t0, early = t_span
        self._record_event(
            {"ts": t0, "event": "task_span", "task": spec.task_id.hex(),
             "name": spec.name,
             "parent": spec.parent_task_id.hex()
             if spec.parent_task_id else None,
             "trace": spec.trace_id or None, "worker": self.worker_id,
             "done": time.time(), "early": early}
        )

    def _init_client_api(self):
        """Install a Runtime so user code can call the full API from tasks.
        Lazy (registered as api.set_runtime_factory at boot) + idempotent:
        runs on whatever thread first touches the API; the thread's pending
        task context (recorded by _set_ctx) is replayed onto the runtime."""
        with self._runtime_init_lock:
            if self._runtime is not None:
                return self._runtime
            from . import api
            from .cluster_backend import ClusterBackend
            from .ids import JobID
            from .runtime import Runtime

            backend = ClusterBackend.connect(
                f"{self.host}:{self.port}", role="worker", worker=self
            )
            runtime = Runtime(
                backend, JobID.from_int(os.getpid() % (2**28)),
                address=f"{self.host}:{self.port}", context=self._ctx_local,
            )
            backend.set_runtime(runtime)
            api.set_global_runtime(runtime)
            self._runtime = runtime  # fast-path handle (no api lookup per call)
            return runtime


def main():
    address = os.environ["RAY_TPU_ADDRESS"]
    worker_id = os.environ["RAY_TPU_WORKER_ID"]
    from .host_names import SESSION_ROOT  # (reference: "/tmp/ray_tpu", ray_tpu/core/worker_main.py:1163)

    session_dir = os.environ.get("RAY_TPU_SESSION_DIR", SESSION_ROOT)
    store.set_session_tag(os.environ.get("RAY_TPU_SESSION_TAG", ""))
    trace_boot = os.environ.get("RAY_TPU_BOOT_TRACE") == "1"
    if trace_boot:
        def _proc_cpu():
            # utime+stime across ALL threads (time.process_time misses the
            # io thread) — /proc/self/stat fields 14/15, in clock ticks.
            with open("/proc/self/stat") as f:
                p = f.read().rsplit(")", 1)[1].split()
            return (int(p[11]) + int(p[12])) / os.sysconf("SC_CLK_TCK")

        t0 = time.monotonic()
        c0 = _proc_cpu()

        def _mark(phase):
            print(
                f"[boot-trace {worker_id}] {phase}: wall "
                f"{(time.monotonic() - t0) * 1000:.1f}ms cpu "
                f"{(_proc_cpu() - c0) * 1000:.1f}ms",
                flush=True,
            )
    else:
        def _mark(phase):
            pass

    _mark("main-entry")
    wp = WorkerProcess(address, worker_id, session_dir)
    _mark("worker-init")
    wp._boot_mark = _mark
    profile_dir = os.environ.get("RAY_TPU_WORKER_PROFILE")
    if profile_dir:
        # Dev tool (mirrors the controller's profile hook): cProfile the
        # main execution loop; run() dumps before its os._exit.
        import cProfile
        import signal

        prof = cProfile.Profile()

        def _dump():
            prof.disable()
            prof.dump_stats(
                os.path.join(profile_dir, f"worker-{worker_id}.pstats")
            )

        wp._profile_dump = _dump
        # Actor workers die by SIGTERM at shutdown — still dump.
        signal.signal(signal.SIGTERM, lambda *_: (_dump(), os._exit(0)))
        prof.enable()
    try:
        wp.run()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()

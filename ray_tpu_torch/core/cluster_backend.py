"""ClusterBackend — client of the controller; used by drivers and workers.

Reference analog: the Cython CoreWorker client surface (`_raylet.pyx`
`submit_task`/`get_objects`) plus the plasma client: metadata over the control
socket, bulk data via direct shm access (zero-copy on read).
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from . import serialization, store
from .backend import RuntimeBackend
from .exceptions import GetTimeoutError, RayTpuError
from .ids import ActorID, ObjectID, PlacementGroupID, TaskID
from .object_ref import ObjectRef
from .rpc import Connection, EventLoopThread, ensure_auth_token, open_rpc_connection
from .task_spec import TaskSpec


class ClusterBackend(RuntimeBackend):
    def __init__(self, address: str, role: str = "driver", worker=None):
        self.address = address
        self.client_address = address
        self.role = role
        self.node_id_hex = os.environ.get("RAY_TPU_NODE_ID", "node0")
        self.worker = worker  # WorkerProcess when role == "worker"
        self.local_store = store.LocalStore()
        self.io = EventLoopThread(name="client-io")
        self.conn: Optional[Connection] = None
        self._controller_proc: Optional[subprocess.Popen] = None
        self._runtime = None
        self._put_idx = 0
        self._put_lock = __import__("threading").Lock()
        # Remote-driver ("Ray Client") mode: no shared-memory locality with
        # the cluster — objects ride the RPC plane both ways (reference:
        # `python/ray/util/client`, redesigned onto the native protocol
        # instead of a separate proxy server).
        self.remote_client = False
        # Direct call plane (leases + actor channels) — attached on connect
        # for shm-local drivers/workers (core/direct.py).
        self.direct = None
        # Anonymous actor-creation coalescing: creations buffer here and
        # ship as ONE create_actor_batch frame (flushed before any other
        # outbound message on this conn, so FIFO with the first method
        # call is preserved; a timer covers create-then-idle drivers).
        self._create_buf: list = []
        self._create_lock = __import__("threading").Lock()
        self._create_flush_scheduled = False
        # Head-failover survivability: recently-sent creation frames, kept
        # so a reconnect can RESUBMIT in-flight creations (the controller
        # dedups on the client-minted actor id, so replay + resubmission
        # can't double-create). (monotonic, frame) pairs, bounded.
        from collections import deque as _deque

        self._create_ledger = _deque(maxlen=512)
        self._reconnect_lock = __import__("threading").Lock()
        self._shutting_down = False

    def set_runtime(self, runtime):
        self._runtime = runtime

    # ------------------------------------------------------------- connect
    @classmethod
    def connect_or_start(
        cls,
        address: Optional[str],
        num_cpus: Optional[float],
        resources: Optional[dict],
        object_store_memory: Optional[int],
        remote_client: bool = False,
    ) -> "ClusterBackend":
        proc = None
        if address is None:
            address, proc = cls._start_controller(
                num_cpus if num_cpus is not None else float(os.cpu_count() or 4),
                resources or {},
                object_store_memory,
            )
        backend = cls(address, role="driver")
        backend.remote_client = remote_client
        backend._controller_proc = proc
        try:
            backend._connect(register_as="register_driver")
        except BaseException:
            # Failed bootstrap must not leak the controller we just spawned
            # (observed: timed-out registrations piling up orphan controllers
            # that load the machine and poison later runs).
            backend.io.stop()
            if proc is not None and proc.poll() is None:
                proc.terminate()
            raise
        return backend

    @classmethod
    def connect(cls, address: str, role: str = "client", worker=None) -> "ClusterBackend":
        backend = cls(address, role=role, worker=worker)
        backend._connect(register_as="register_client")
        return backend

    @staticmethod
    def _start_controller(
        num_cpus: float, resources: dict, object_store_memory: Optional[int]
    ) -> Tuple[str, subprocess.Popen]:
        from .host_names import SESSION_ROOT  # (reference: "/tmp/ray_tpu", ray_tpu/core/cluster_backend.py:113)

        session_dir = os.path.join(
            SESSION_ROOT, f"session_{int(time.time() * 1000)}_{os.getpid()}"
        )
        os.makedirs(session_dir, exist_ok=True)
        args = {
            "num_cpus": num_cpus,
            "resources": resources,
            "session_dir": session_dir,
            "object_store_memory": object_store_memory,
            "port": 0,
        }
        ensure_auth_token()  # children inherit; connections authenticate
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        env["RAY_TPU_CONTROLLER_ARGS"] = cloudpickle.dumps(args).hex()
        log_f = open(os.path.join(session_dir, "controller.log"), "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.controller_main"],
            env=env,
            stdout=subprocess.PIPE,
            stderr=log_f,
            cwd=pkg_root,
        )
        # Handshake: controller prints its bound port on stdout.
        from ..cluster_utils import read_sentinel

        val = read_sentinel(proc, "RAY_TPU_CONTROLLER_PORT=", 30)
        if val is None:
            proc.terminate()
            raise RayTpuError(
                f"Controller failed to start (or timed out); see {session_dir}/controller.log"
            )
        from . import config as rt_config

        return f"{rt_config.get('node_ip')}:{int(val)}", proc

    def reconnect(self) -> bool:
        """Re-establish this backend's connection after a controller restart
        (used by actor workers being re-adopted — their nested API must not
        keep pointing at the dead socket — and by the driver-side failover
        loop below). Registration is idempotent on the controller."""
        if self._shutting_down or self.io.loop.is_closed():
            return False  # shutdown raced the failover loop
        try:
            if self.conn is not None:
                self.conn.close()
        except Exception:  # noqa: BLE001
            pass
        # The direct manager is KEPT: its actor channels ride worker conns
        # that never touched the head (surviving actors keep answering
        # through the outage, and locally-held results stay resolvable).
        # Leases self-heal — leased plain workers exited with the old head
        # and their channel-close handlers resubmit against the new conn.
        try:
            self._connect(self._register_as)
            self._resubmit_creates()
            return True
        except Exception:  # noqa: BLE001
            return False

    # Creation frames sent within this window BEFORE the outage began are
    # resubmitted after a failover (older ones were acked + checkpointed
    # many ticks ago; the window also bounds the re-create risk for a
    # freshly killed-and-GCed actor id). Anchored at connection-loss time,
    # NOT at reconnect time: a slow head restart (a 2,000-worker fleet can
    # stretch boot past a minute) must not age in-flight creations out of
    # their own recovery path.
    _RESUBMIT_WINDOW_S = 15.0

    def _resubmit_creates(self):
        base = getattr(self, "_conn_lost_at", None)
        if base is None:
            base = time.monotonic()
        frames = [
            dict(m) for t, m in list(self._create_ledger)
            if t >= base - self._RESUBMIT_WINDOW_S
        ]
        if not frames or self.conn is None:
            return
        try:
            self.conn.post({"type": "create_actor_batch", "items": frames})
        except ConnectionError:
            pass  # next close/reconnect cycle retries

    def _on_conn_lost(self):
        """Controller connection dropped. Drivers attached to an EXTERNAL
        (standalone) cluster retry with capped exponential backoff — the
        head may be restarting from its WAL; a session whose controller is
        our own child is simply over."""
        if (
            self._shutting_down
            or self.role not in ("driver", "client")
            or self._controller_proc is not None
        ):
            return
        self._conn_lost_at = time.monotonic()  # resubmit-window anchor
        import threading

        threading.Thread(
            target=self._reconnect_with_backoff, name="head-reconnect",
            daemon=True,
        ).start()

    def _reconnect_with_backoff(self) -> bool:
        from . import config as rt_config

        if not self._reconnect_lock.acquire(blocking=False):
            return False  # a reconnect loop is already running
        try:
            deadline = time.monotonic() + rt_config.get(
                "head_reconnect_deadline_s"
            )
            delay = 0.1
            while not self._shutting_down and time.monotonic() < deadline:
                time.sleep(delay)
                delay = min(delay * 2, 2.0)  # capped exponential backoff
                if self.io.loop.is_closed():
                    return False  # backend shut down under us
                if self.reconnect():
                    return True
            return False
        finally:
            self._reconnect_lock.release()

    def _connect(self, register_as: str):
        from .rpc import adopt_local_session_token

        # Explicit-address clients on the head machine still need the
        # session secret — discover it from session_latest if env lacks it.
        adopt_local_session_token()
        self._register_as = register_as
        phases = {}  # diagnostic: where did a timed-out connect spend time?

        async def go():
            import time as _t

            t0 = _t.monotonic()
            phases["enter"] = 0.0  # loop ran the coroutine at all
            host, port = self.address.rsplit(":", 1)
            try:
                reader, writer = await asyncio.wait_for(
                    open_rpc_connection(host, int(port)), 10
                )
            except TimeoutError:
                phases["tcp_timeout"] = round(_t.monotonic() - t0, 2)
                raise
            phases["tcp"] = round(_t.monotonic() - t0, 2)
            conn = Connection(
                reader, writer, on_push=self._on_controller_push,
                on_close=self._on_conn_close,
            )
            conn.start()
            self.conn = conn
            payload = {"type": register_as, "node_id": os.environ.get("RAY_TPU_NODE_ID", "node0")}
            if register_as == "register_worker" and self.worker is not None:
                payload["worker_id"] = self.worker.worker_id
            # Generous: worker boot storms (many interpreters importing
            # concurrently) legitimately delay controller responses.
            w0 = _t.time()
            out = await conn.request(payload, timeout=60)
            phases["register"] = round(_t.monotonic() - t0, 2)
            if isinstance(out, dict):
                # RTT midpoint of the register round-trip — the instant
                # the controller most plausibly sampled the "time" it
                # returns. Used below for flight-recorder clock alignment.
                out["_rtt_mid"] = (w0 + _t.time()) / 2.0
            return out

        try:
            result = self.io.call(go(), timeout=70)
        except ConnectionError as e:
            raise RayTpuError(
                "controller closed the connection during registration — "
                "likely an auth mismatch (set RAY_TPU_AUTH_TOKEN to the "
                "session token from the head's address.json)"
            ) from e
        except TimeoutError as e:
            raise RayTpuError(
                f"controller connect timed out (phases reached: {phases}; "
                f"an empty dict means the io loop never ran the coroutine — "
                f"loop blocked?)"
            ) from e
        if not (result or {}).get("ok"):
            raise RayTpuError(f"Failed to register with controller: {result}")
        rtt_mid = result.pop("_rtt_mid", None)
        if result.get("time") is not None and rtt_mid is not None:
            # Cross-host clock alignment for the flight recorder: offset =
            # controller wall clock minus the RTT midpoint, so spans from
            # this process merge onto the controller's timeline honestly
            # (error bounded by half the register RTT — microseconds on a
            # LAN, and registration is once per process).
            from ..util import flight

            flight.set_clock_offset(float(result["time"]) - rtt_mid)
            flight.set_component(self.role)
        if result.get("session_dir"):
            self.session_dir = result["session_dir"]
        # Adopt the head's session tag unless this process is env-pinned to a
        # node arena: a worker on a remote node carries ITS node's tag
        # (RAY_TPU_SESSION_TAG from the agent) and must keep attaching there.
        if result.get("session_tag") and not os.environ.get("RAY_TPU_SESSION_TAG"):
            store.set_session_tag(result["session_tag"])
        # Distributed ref counting: batch local ObjectRef 0↔1 transitions to
        # the controller (reference: `reference_count.h` borrower protocol).
        from .ref_tracker import TRACKER

        def _flush_refs(add, release):
            direct = self.direct
            if direct is not None:
                # Locally-owned direct results never hit the controller's
                # directory: filter their adds; releases free the local copy.
                add = [h for h in add if not direct.owns(h)]
                release = [h for h in release if not direct.release(h)]
                if not add and not release:
                    return
            if self.conn is not None and not self.conn._closed:
                self._send_nowait({"type": "update_refs", "add": add, "release": release})

        TRACKER.set_flusher(_flush_refs)
        # With the tag known, upgrade to the native arena store if this
        # session's controller created one (falls back silently otherwise).
        self.local_store = store.make_store()
        # Steady-state fast path: leases + direct actor channels. Remote
        # (ray://) clients stay on the classic plane — no shm locality and
        # possibly no route to worker sockets.
        if self.role in ("driver", "worker") and not self.remote_client:
            if self.direct is None:  # kept across failover reconnects
                from .direct import DirectCallManager

                self.direct = DirectCallManager(self)

    async def _on_controller_push(self, msg: dict):
        if msg.get("type") == "revoke_lease" and self.direct is not None:
            self.direct.on_revoke(msg["worker_id"])

    async def _on_conn_close(self):
        self._on_conn_lost()

    # ------------------------------------------- actor-creation coalescing
    def _buffer_create(self, msg: dict):
        """Queue an anonymous creation; ships batched. Every other outbound
        path flushes this buffer FIRST, so controller-observed order is
        identical to per-message sends."""
        with self._create_lock:
            self._create_buf.append(msg)
            schedule = not self._create_flush_scheduled
            self._create_flush_scheduled = True  # latched; flush resets it
            deep = len(self._create_buf) >= 512
        if deep:
            self._flush_creates()
        elif schedule:
            # Timer backstop for create-then-idle drivers (3ms ≈ one loop
            # wake-up; a creation burst flushes far earlier via the next
            # submit/get on this conn).
            def flush_safe():
                try:
                    self._flush_creates()
                except Exception:  # noqa: BLE001 — conn died; the NEXT
                    pass  # user-thread call surfaces the loss at its site

            def arm():
                self.io.loop.call_later(0.003, flush_safe)

            try:
                self.io.loop.call_soon_threadsafe(arm)
            except RuntimeError:
                self._flush_creates()

    def _flush_creates(self):
        with self._create_lock:
            if not self._create_buf:
                self._create_flush_scheduled = False
                return
            items, self._create_buf = self._create_buf, []
            self._create_flush_scheduled = False
        now = time.monotonic()
        for m in items:
            self._create_ledger.append((now, m))
        if self.conn is None or self.conn._closed:
            raise RayTpuError("Lost connection to controller (connection closed)")
        try:
            if len(items) == 1:
                self.conn.post(dict(items[0], type="create_actor"))
            else:
                self.conn.post({"type": "create_actor_batch", "items": items})
        except ConnectionError as e:
            raise RayTpuError(f"Lost connection to controller: {e}") from e

    def _request(self, msg: dict, timeout: Optional[float] = None) -> Any:
        # Leave generous slack over the server-side timeout.
        client_timeout = None if timeout is None else timeout + 30
        if self._create_buf:
            self._flush_creates()
        try:
            return self.io.call(self.conn.request(msg, timeout), client_timeout)
        except ConnectionError as e:
            raise RayTpuError(f"Lost connection to controller: {e}") from e

    def _send(self, msg: dict):
        """Blocking one-way send — user-thread paths (submit, metrics) get an
        immediate 'Lost connection' at the call site."""
        if self._create_buf:
            self._flush_creates()
        try:
            self.io.call(self.conn.send(msg))
        except ConnectionError as e:
            raise RayTpuError(f"Lost connection to controller: {e}") from e

    def _send_nowait(self, msg: dict):
        """Fire-and-forget — the ONLY safe send from __del__/GC paths, which
        can run on ANY thread including the io loop thread itself (observed:
        a future-chain callback freeing a generator's refs; a blocking call
        from that thread deadlocks the whole client)."""
        self.io.call_nowait(self.conn.send(msg))

    def _send_pipelined(self, msg: dict):
        """Submit-path send: non-blocking (a per-submit io round trip costs
        ~1ms and dominates task throughput) but NOT silent — a closed
        connection raises immediately, and an async send failure is stashed
        and raised at the very next submit ('Lost connection' one call late
        instead of a 300s get timeout)."""
        if self.conn is None or self.conn._closed:
            raise RayTpuError("Lost connection to controller (connection closed)")
        if self._create_buf:
            self._flush_creates()
        try:
            self.conn.post(msg)  # batched; a dead conn raises on the NEXT call
        except ConnectionError as e:
            raise RayTpuError(f"Lost connection to controller: {e}") from e

    def _note_send_error(self, fut):
        exc = fut.exception()
        if exc is not None and getattr(self, "_pipelined_send_error", None) is None:
            self._pipelined_send_error = exc

    # ----------------------------------------------------------------- put
    def put(self, value: Any, owner_task_hex: str) -> ObjectRef:
        # Counter-based index: collision-free within an owner task (random
        # indices hit 24-bit birthday collisions after a few thousand puts).
        with self._put_lock:
            self._put_idx += 1
            idx = self._put_idx
        oid = ObjectID.of(TaskID.from_hex(owner_task_hex), 2**24 + idx)
        hex_id = oid.hex()
        if self.remote_client:
            # No shm on a remote driver: the packed frame ships over RPC.
            # Large frames land in the HEAD's arena (put_data) so they stay
            # under object-store accounting/spilling instead of growing the
            # controller heap; small ones ride inline as usual.
            frame = serialization.pack(value)
            contains = serialization.last_contained_refs()
            if len(frame) > store.INLINE_THRESHOLD:
                self._request(
                    {"type": "put_data", "id": hex_id, "data": frame,
                     "contains": contains}
                )
                return ObjectRef(oid, self.client_address)
            shm_name, inline, size = None, frame, len(frame)
        else:
            shm_name, inline, size = self.local_store.put(hex_id, value)
            contains = serialization.last_contained_refs()
        if contains:
            # The controller pins contained objects — locally-owned direct
            # results must be in its directory before it learns the container.
            self.ensure_published(contains)
        if inline is not None:
            self._request(
                {"type": "put_inline", "id": hex_id, "data": inline, "contains": contains}
            )
        else:
            self._request(
                {
                    "type": "register_object",
                    "id": hex_id,
                    "name": shm_name,
                    "size": size,
                    "contains": contains,
                }
            )
        return ObjectRef(oid, self.client_address)

    def put_serialized(self, payload: bytes, buffers, owner_task_hex: str,
                       contains=()) -> "Tuple[ObjectRef, Optional[str], bool]":
        """Store an ALREADY-serialized (payload, out-of-band buffers) pair as
        a first-class object. The data plane's block transport serializes
        columnar segments itself so it can compute every buffer's (offset,
        length) span within the stored frame (`serialization.pack` wire
        format) — consumers then pull single spans over the bulk plane.
        Returns (ref, local_store_name, span_addressable): the name lets a
        SAME-NODE consumer read the segment straight out of the shared store
        with zero controller round trips (the deps-map fast path's
        equivalent); span_addressable False means the frame rode the inline
        plane, where span-addressed bulk reads are impossible."""
        with self._put_lock:
            self._put_idx += 1
            idx = self._put_idx
        oid = ObjectID.of(TaskID.from_hex(owner_task_hex), 2**24 + idx)
        hex_id = oid.hex()
        size = serialization.packed_size(payload, buffers)
        if contains:
            self.ensure_published(list(contains))
        if size <= store.INLINE_THRESHOLD:
            frame = bytearray(size)
            serialization.pack_into(payload, buffers, memoryview(frame))
            self._request({"type": "put_inline", "id": hex_id,
                           "data": bytes(frame), "contains": list(contains)})
            return ObjectRef(oid, self.client_address), None, False
        if self.remote_client:
            frame = bytearray(size)
            serialization.pack_into(payload, buffers, memoryview(frame))
            self._request({"type": "put_data", "id": hex_id,
                           "data": bytes(frame), "contains": list(contains)})
            # Lands in the HEAD arena with the same frame layout — spans stay
            # valid there (resolved via object_sources; no local name here).
            return ObjectRef(oid, self.client_address), None, True
        shm_name, size = self.local_store.create_packed(hex_id, payload, buffers)
        self._request({
            "type": "register_object", "id": hex_id, "name": shm_name,
            "size": size, "contains": list(contains),
        })
        return ObjectRef(oid, self.client_address), shm_name, True

    def object_sources(self, hex_ids: Sequence[str]) -> List[Optional[dict]]:
        """(bulk addr, store name, size) of a live copy of each id, or None
        where no span-servable copy exists (inline/spilled/unknown). One
        controller round trip for the whole list."""
        try:
            resp = self._request(
                {"type": "object_sources", "ids": list(hex_ids)}
            )
            out = (resp or {}).get("sources")
        except Exception:  # noqa: BLE001 — resolution is best-effort
            out = None
        if not isinstance(out, list) or len(out) != len(hex_ids):
            return [None] * len(hex_ids)
        return out

    # ----------------------------------------------------------------- get
    def _read_location(self, loc: dict, hex_id: str) -> Any:
        status = loc["status"]
        if status == "inline":
            return serialization.unpack(loc["data"])
        if status == "shm":
            if self.remote_client:
                return self._fetch_remote(name=loc["name"])
            return self.local_store.read(loc["name"])
        if status == "spilled":
            if self.remote_client:
                return self._fetch_remote(path=loc["path"])
            return self.local_store.read_from_file(loc["path"])
        raise RayTpuError(f"Object {hex_id} unavailable: {status}")

    def _fetch_remote(self, **where) -> Any:
        """Client-mode object fetch: the controller serves the packed frame
        over the control plane (reference analog: Ray Client data channel)."""
        resp = self._request({"type": "fetch_object", **where})
        if resp.get("error"):
            raise RayTpuError(f"client fetch failed: {resp['error']}")
        return serialization.unpack(resp["data"])

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float]) -> List[Any]:
        if not refs:
            return []
        if self.role == "worker" and self.worker is not None:
            block_hook = getattr(self.worker, "on_nested_block", None)
            if block_hook is not None:
                block_hook()
        if self.direct is None:
            return self._get_classic(refs, timeout)
        import time as _t

        t0 = _t.monotonic()
        pending = []
        for r in refs:
            got = self.direct.lookup(r.id.hex())
            if got is not None and hasattr(got, "event"):
                pending.append(got)
        if pending and not self.direct.wait_pending(pending, timeout):
            raise GetTimeoutError(
                f"Timed out waiting for {len(pending)} direct task result(s)"
            )
        out: List[Any] = [None] * len(refs)
        classic_refs, classic_pos = [], []
        for i, r in enumerate(refs):
            frame = self.direct.local_frame(r.id.hex())
            if frame is not None:
                out[i] = serialization.unpack(frame)
            else:
                classic_refs.append(r)
                classic_pos.append(i)
        if classic_refs:
            rem = None if timeout is None else max(
                0.0, timeout - (_t.monotonic() - t0)
            )
            for i, v in zip(classic_pos, self._get_classic(classic_refs, rem)):
                out[i] = v
        return out

    def _get_classic(self, refs: Sequence[ObjectRef], timeout: Optional[float]) -> List[Any]:
        blocked = False
        if self.role == "worker" and self.worker is not None:
            blocked = True
            self.worker.send({"type": "worker_blocked", "worker_id": self.worker.worker_id})
        try:
            async def gather():
                # One batched RPC per chunk instead of one per ref — envelope
                # + response framing dominates many-ref gets otherwise.
                CHUNK = 2000
                chunks = [refs[i:i + CHUNK] for i in range(0, len(refs), CHUNK)]
                replies = await asyncio.gather(*(
                    self.conn.request(
                        {"type": "get_objects",
                         "ids": [r.id.hex() for r in chunk],
                         "timeout": timeout}
                    )
                    for chunk in chunks
                ))
                out = []
                for reply in replies:
                    out.extend(reply["locations"])
                return out

            locs = self.io.call(gather(), None if timeout is None else timeout + 30)
        finally:
            if blocked:
                self.worker.send(
                    {"type": "worker_unblocked", "worker_id": self.worker.worker_id}
                )
        out = []
        for r, loc in zip(refs, locs):
            if loc["status"] == "timeout":
                raise GetTimeoutError(f"Timed out getting {r.id.hex()}")
            out.append(self._read_location(loc, r.id.hex()))
        return out

    def wait(self, refs, num_returns, timeout):
        if self.direct is not None and any(
            self.direct.lookup(r.id.hex()) is not None for r in refs
        ):
            return self._wait_composite(refs, num_returns, timeout)
        return self._wait_classic(refs, num_returns, timeout)

    def _wait_composite(self, refs, num_returns, timeout):
        """Direct-owned refs resolve via local events; poll both planes
        (wait() is not a throughput path)."""
        import time as _t

        deadline = None if timeout is None else _t.monotonic() + timeout
        while True:
            ready = []
            maybe_classic = []
            for r in refs:
                got = self.direct.lookup(r.id.hex())
                if got is None or got == ("registered",):
                    maybe_classic.append(r)
                elif not hasattr(got, "event"):
                    ready.append(r)  # local frame
            if maybe_classic and len(ready) < num_returns:
                c_ready, _ = self._wait_classic(
                    maybe_classic, min(num_returns, len(maybe_classic)), 0.05
                )
                ready.extend(c_ready)
            if len(ready) >= num_returns or (
                deadline is not None and _t.monotonic() >= deadline
            ):
                chosen = ready[:num_returns]
                chosen_set = {r.id.hex() for r in chosen}
                ordered = [r for r in refs if r.id.hex() in chosen_set]
                not_ready = [r for r in refs if r.id.hex() not in chosen_set]
                return ordered, not_ready
            _t.sleep(0.02)

    def _wait_classic(self, refs, num_returns, timeout):
        ids = [r.id.hex() for r in refs]
        resp = self._request(
            {"type": "wait_objects", "ids": ids, "num_returns": num_returns, "timeout": timeout},
            timeout=None,
        )
        ready_set = set(resp["ready"])
        ready = [r for r in refs if r.id.hex() in ready_set][:num_returns]
        chosen = {r.id.hex() for r in ready}
        not_ready = [r for r in refs if r.id.hex() not in chosen]
        return ready, not_ready

    # --------------------------------------------------------------- tasks
    def submit_task(self, spec: TaskSpec) -> None:
        from .task_spec import spec_to_proto_bytes

        if (
            self.direct is not None
            and self.direct.eligible(spec)
            and self.direct.submit(spec)
        ):
            return
        self._send_pipelined({"type": "submit_task", "spec": spec_to_proto_bytes(spec)})

    def create_actor(self, spec: TaskSpec, name: str, namespace: str) -> None:
        from .task_spec import spec_to_proto_bytes

        from .actor import ActorHandle

        handle = ActorHandle(spec.actor_id, spec.name, dict(spec.method_meta))
        msg = {
            "type": "create_actor",
            "spec": spec_to_proto_bytes(spec),
            "name": name,
            "namespace": namespace or "default",
            "handle": cloudpickle.dumps(handle),
        }
        if name:
            # Named creation stays a round trip: the name-taken conflict is
            # a synchronous ValueError by API contract. Ledgered first so a
            # head failover mid-request still lands the creation on
            # reconnect (dedup'd by actor id server-side); a creation the
            # CALLER saw rejected is un-ledgered — resubmitting it after a
            # failover could spawn an orphan nobody holds a handle to.
            entry = (
                time.monotonic(),
                {k: v for k, v in msg.items() if k != "type"},
            )
            self._create_ledger.append(entry)
            resp = self._request(msg)
            if resp and resp.get("error"):
                try:
                    self._create_ledger.remove(entry)
                except ValueError:
                    pass  # already rotated out of the bounded deque
                raise ValueError(resp["error"])
            return
        # Anonymous creation is fire-and-forget (reference semantics: actor
        # creation is async; errors — infeasibility, init failure — surface
        # on the first method call via the actor's error state) AND
        # coalesced: a creation burst ships as create_actor_batch frames —
        # one controller handler + one scheduling round per batch instead
        # of per actor. FIFO with subsequent submits is preserved because
        # every other outbound path flushes the buffer first.
        msg.pop("type", None)
        self._buffer_create(msg)

    def submit_actor_task(self, spec: TaskSpec) -> None:
        from .task_spec import spec_to_proto_bytes

        if self.direct is not None and self.direct.submit_actor(spec):
            return
        self._send_pipelined(
            {"type": "submit_actor_task", "spec": spec_to_proto_bytes(spec)}
        )

    def kill_actor(self, actor_id: ActorID, no_restart: bool) -> None:
        # Pipelined (reference semantics: ray.kill is asynchronous). Rides
        # the same conn FIFO as submits, so kill-then-call still errors the
        # call; a 5,000-actor teardown wave is one coalesced write instead
        # of 5,000 round trips against a loaded controller.
        self._send_pipelined(
            {"type": "kill_actor", "actor": actor_id.hex(),
             "no_restart": no_restart}
        )

    def cancel(self, ref: ObjectRef, force: bool, recursive: bool) -> None:
        if self.direct is not None and self.direct.cancel(ref.id.task_id().hex()):
            return
        self._request({"type": "cancel", "task": ref.id.task_id().hex(), "force": force})

    def get_named_actor(self, name: str, namespace: str) -> Optional[bytes]:
        resp = self._request({"type": "get_named_actor", "name": name, "namespace": namespace})
        return resp.get("handle")

    # ------------------------------------------------------------- cluster
    def cluster_resources(self) -> Dict[str, float]:
        return self._request({"type": "cluster_resources"})["total"]

    def available_resources(self) -> Dict[str, float]:
        return self._request({"type": "cluster_resources"})["available"]

    def nodes(self) -> List[dict]:
        return self._request({"type": "nodes"})["nodes"]

    def state_summary(self) -> dict:
        return self._request({"type": "state_summary"})

    # ----------------------------------------------------- placement groups
    def create_placement_group(self, pg_id, bundles, strategy, name) -> None:
        self._request(
            {
                "type": "create_pg",
                "id": pg_id.hex(),
                "bundles": bundles,
                "strategy": strategy,
                "name": name,
            }
        )

    def placement_group_ready(self, pg_id, timeout) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._request({"type": "pg_ready", "id": pg_id.hex()})["ready"]:
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.05)

    def remove_placement_group(self, pg_id) -> None:
        self._request({"type": "remove_pg", "id": pg_id.hex()})

    def free_objects(self, refs: Sequence[ObjectRef]) -> None:
        ids = [r.id.hex() for r in refs]
        if self.direct is not None:
            ids = [h for h in ids if not self.direct.release(h)]
            if not ids:
                return
        self._request({"type": "free_objects", "ids": ids})

    def ensure_published(self, hexes) -> None:
        """Promote locally-owned direct results into the controller's object
        directory before they escape this process (args / nested refs /
        contained-in-put). FIFO on the controller conn guarantees the
        publish lands before any dependent submission."""
        if self.direct is None:
            return
        from .ref_tracker import TRACKER

        for h in set(hexes):
            # Flag FIRST: checking the frame first races task completion —
            # resolve-between-the-two leaves the object unpublished forever.
            if self.direct.flag_publish_on_done(h):
                continue  # in flight — publishes the moment it resolves
            frame = self.direct.local_frame(h)
            if frame is None:
                continue  # not direct-owned (classic or already registered)
            self._send_pipelined({"type": "put_inline", "id": h, "data": frame})
            self.direct.mark_registered(h)
            if TRACKER.local_count(h) > 0:
                self._send_nowait({"type": "update_refs", "add": [h], "release": []})

    # ------------------------------------------------- streaming generators
    def stream_next(self, task_hex: str, index: int, timeout: Optional[float] = 300.0) -> str:
        resp = self._request(
            {"type": "stream_next", "task": task_hex, "index": index, "timeout": timeout},
            timeout=timeout,
        )
        if resp["status"] == "timeout":
            raise GetTimeoutError(f"stream item {index} of {task_hex[:12]} timed out")
        return resp["status"]  # "ready" | "end"

    def stream_release(self, task_hex: str, from_index: int) -> None:
        # Reachable from ObjectRefGenerator.__del__ — must never block.
        self._send_nowait({"type": "stream_release", "task": task_hex, "from_index": from_index})

    # ------------------------------------------------------------- metrics
    def record_metric(self, name: str, kind: str, value: float, tags: dict,
                      **extra) -> None:
        # `extra` carries family metadata (help) and histogram bucket deltas
        # (boundaries/buckets/sum/count) — see util/metrics.py.
        self._send(
            {"type": "record_metric", "name": name, "kind": kind,
             "value": value, "tags": tags, **extra}
        )

    def poll_events(self, cursor: int = -1, kinds=None, limit: int = 2000) -> dict:
        """Cursor-based read of controller timeline events (actor_restarting,
        actor_death, node_died, chaos_worker_killed, ...). Returns
        {"cursor": next_cursor, "events": [...]}; cursor=-1 subscribes from
        the current tail. Used by the elastic-training gang supervisor."""
        return self._request({
            "type": "poll_events", "cursor": cursor,
            "kinds": list(kinds or ()), "limit": limit,
        })

    def prune_metrics(self, tags: dict) -> None:
        """Drop exported series whose tags include all of `tags`."""
        self._send({"type": "prune_metrics", "tags": tags})

    def record_trace_event(self, ev) -> None:
        """Ship tracing span/timeline events (one dict or a batch list —
        util/tracing.record_span / record_events); rides the same controller
        channel as worker task_events batches."""
        events = ev if isinstance(ev, list) else [ev]
        if self.worker is not None:
            for e in events:
                e.setdefault("worker", self.worker.worker_id)
        self._send({"type": "task_events", "events": events})

    # --------------------------------------------------------- log tailing
    def start_log_tailer(self):
        """Stream worker logs to this driver's stdout (reference analog:
        `log_monitor.py` → driver). Poll-based over the control plane."""
        import threading

        if getattr(self, "_log_tailer", None) is not None:
            return
        self._log_tailer_stop = threading.Event()

        def tail():
            # Seed cursors at each file's current end: a driver joining a
            # long-lived cluster streams from 'now', not hours of history.
            cursors: Dict[str, int] = {}
            seeded = False
            failures = 0
            while not self._log_tailer_stop.wait(1.0):
                if self.conn is None or self.conn._closed:
                    return
                try:
                    if not seeded:
                        # Never poll with empty cursors un-seeded: that would
                        # replay full history on the next success.
                        resp = self._request(
                            {"type": "tail_logs", "cursors": {}, "init": True}
                        )
                        cursors = {
                            w: c["offset"]
                            for w, c in (resp or {}).get("logs", {}).items()
                        }
                        seeded = True
                        failures = 0
                        continue
                    resp = self._request({"type": "tail_logs", "cursors": cursors})
                    failures = 0
                except Exception:  # noqa: BLE001
                    # Transient hiccups must not silently kill log streaming
                    # for the rest of the job — retry until persistent.
                    failures += 1
                    if failures >= 5:
                        return
                    continue
                for wid, chunk in sorted((resp or {}).get("logs", {}).items()):
                    cursors[wid] = chunk["offset"]
                    for line in chunk["data"].splitlines():
                        print(f"({wid}) {line}")

        self._log_tailer = threading.Thread(target=tail, name="log-tailer", daemon=True)
        self._log_tailer.start()

    # ------------------------------------------------------------ shutdown
    def shutdown(self) -> None:
        from .ref_tracker import TRACKER

        self._shutting_down = True  # no failover reconnects past this point
        TRACKER.set_flusher(None)
        if self.direct is not None:
            self.direct.close()
        if getattr(self, "_log_tailer", None) is not None:
            self._log_tailer_stop.set()
            self._log_tailer = None
        if self.role == "driver" and self._controller_proc is not None:
            # Only the driver that STARTED the controller ends the session —
            # a secondary driver (e.g. a submitted job) disconnecting must
            # not take the cluster down with it.
            try:
                self._request({"type": "shutdown"}, timeout=2)
            except Exception:  # noqa: BLE001
                pass
            try:
                self._controller_proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._controller_proc.terminate()
        if self.conn is not None:
            # Drain the post pipeline before closing: coalesced frames
            # (pipelined kills, buffered creations) sit in _post_buf until
            # the loop turns — close() first would discard them (a killed
            # detached actor would survive its kill).
            try:
                if self._create_buf:
                    self._flush_creates()

                async def drain():
                    self.conn._flush_posts()
                    await self.conn.writer.drain()

                self.io.call(drain(), timeout=2)
            except Exception:  # noqa: BLE001 — conn already dead
                pass
            self.conn.close()
        self.local_store.close_all()
        self.io.stop()

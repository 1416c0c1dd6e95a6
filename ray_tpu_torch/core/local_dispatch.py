"""LocalDispatcher — the node agent's half of two-level scheduling.

Reference analog: `src/ray/raylet/local_task_manager.cc:1` (the raylet
drains its own task queue against local workers once the cluster scheduler
has picked the node) with `scheduling/cluster_task_manager.h:42` doing the
node pick. Redesign for this runtime: the controller hands the BACKLOG
(tasks that found no idle worker) to the agent; the agent leases local
workers through the normal lease plane and pushes specs straight to each
worker's direct-plane listener. Once tasks and leases are local, dispatch
continues with ZERO head involvement — a stalled controller stops lease
GROWTH and result registration, not dispatch.

Worker protocol: the `agent_task` message on the worker's direct listener
executes with CLASSIC result semantics (task_done → controller, so the
object directory, lineage and refcounts are untouched) plus an
`agent_task_done` ping back to this dispatcher so the next queued task
dispatches immediately.

Failure paths:
  * worker conn drops mid-task → `agent_task_lost` to the controller
    (same retry policy as central worker death);
  * no lease obtainable for `local_dispatch_spill_s` → `agent_spillback`
    (the reference's spillback, applied to the queue);
  * `cancel_task` from the controller drops queued entries.
"""

from __future__ import annotations

import asyncio
import collections
import time
from typing import Deque, Dict, Optional, Tuple

from . import config as rt_config
from .rpc import Connection, open_rpc_connection


class _WorkerLease:
    __slots__ = ("worker_id", "addr", "conn", "current", "last_used", "draining")

    def __init__(self, worker_id: str, addr: str, conn: Connection):
        self.worker_id = worker_id
        self.addr = addr
        self.conn = conn
        self.current: Optional[Tuple[str, bytes, dict]] = None  # inflight task
        self.last_used = time.monotonic()
        self.draining = False  # revoked: return to the controller when free


class LocalDispatcher:
    def __init__(self, agent):
        self.agent = agent  # NodeAgent: .conn (controller), .node_id, loop
        self.queue: Deque[Tuple[str, bytes, dict, float]] = collections.deque()
        self.leases: Dict[str, _WorkerLease] = {}
        self._lease_request_inflight = False
        self._pump_scheduled = False
        self._idle_reaper: Optional[asyncio.Task] = None

    # ------------------------------------------------------- agent plumbing
    def start(self):
        self._idle_reaper = asyncio.get_running_loop().create_task(
            self._reap_idle_loop()
        )

    def stop(self):
        if self._idle_reaper is not None:
            self._idle_reaper.cancel()
        for lease in self.leases.values():
            lease.conn.close()
        self.leases.clear()

    def enqueue(self, task_hex: str, spec_bytes: bytes, deps: dict):
        self.queue.append((task_hex, spec_bytes, deps or {}, time.monotonic()))
        self._pump()

    def on_revoke(self, worker_id: str):
        """Controller wants the worker back for central scheduling. Idle →
        return now; busy → finish the inflight task, then return (the
        reaper's idle pass will send it home)."""
        lease = self.leases.get(worker_id)
        if lease is None:
            return
        if lease.current is None:
            self._return_lease(lease)
        else:
            lease.draining = True  # returned on completion (_pump/on_push)

    def cancel(self, task_hex: str, force: bool = False, worker_procs=None):
        """Drop a still-queued task; with force, kill the worker executing
        it (mirrors the central path's _terminate_worker on force-cancel —
        the agent owns the local worker processes)."""
        for item in list(self.queue):
            if item[0] == task_hex:
                try:
                    self.queue.remove(item)
                except ValueError:
                    return
                self.agent.conn.post(
                    {"type": "agent_task_cancelled", "task": task_hex}
                )
                return
        if not force:
            return
        for lease in self.leases.values():
            if lease.current is not None and lease.current[0] == task_hex:
                proc = (worker_procs or {}).get(lease.worker_id)
                if proc is not None and proc.poll() is None:
                    proc.terminate()  # conn close → _on_worker_gone cleanup
                return

    # ------------------------------------------------------------ dispatch
    def _pump(self):
        """Dispatch as many queued tasks as free leases allow; top up the
        lease pool for the remainder. Collapsed per loop tick."""
        if self._pump_scheduled:
            return
        self._pump_scheduled = True
        asyncio.get_running_loop().call_soon(self._pump_now)

    def _return_lease(self, lease: _WorkerLease):
        self.leases.pop(lease.worker_id, None)
        lease.conn.close()
        try:
            self.agent.conn.post(
                {"type": "return_lease", "worker_id": lease.worker_id}
            )
        except ConnectionError:
            pass

    def _pump_now(self):
        self._pump_scheduled = False
        for lease in list(self.leases.values()):
            if lease.draining and lease.current is None:
                self._return_lease(lease)
        while self.queue:
            lease = next(
                (l for l in self.leases.values()
                 if l.current is None and not l.draining),
                None,
            )
            if lease is None:
                break
            task_hex, spec_bytes, deps, _ = self.queue.popleft()
            lease.current = (task_hex, spec_bytes, deps)
            lease.last_used = time.monotonic()
            try:
                lease.conn.post({
                    "type": "agent_task", "task": task_hex,
                    "spec": spec_bytes, "deps": deps,
                })
            except ConnectionError:
                self._on_worker_gone(lease)
        if self.queue and not self._lease_request_inflight:
            asyncio.ensure_future(self._grow_leases())
        self._maybe_spill()

    async def _grow_leases(self):
        self._lease_request_inflight = True
        try:
            want = min(len(self.queue), 8)
            resp = await self.agent.conn.request(
                {"type": "request_lease", "resources": {"CPU": 1.0},
                 "count": want, "wait_s": 2.0,
                 "node_id": self.agent.node_id},
                timeout=30,
            )
            for grant in (resp or {}).get("leases", []):
                await self._adopt_lease(grant["worker_id"], grant["addr"])
        except Exception:  # noqa: BLE001 — head unreachable/stalled: the
            pass           # queue keeps draining on existing leases
        finally:
            self._lease_request_inflight = False
        if self.queue:
            self._pump()

    async def _adopt_lease(self, worker_id: str, addr: str):
        host, port = addr.rsplit(":", 1)
        try:
            reader, writer = await open_rpc_connection(host, int(port))
        except OSError:
            self.agent.conn.post({"type": "return_lease", "worker_id": worker_id})
            return
        lease = _WorkerLease(worker_id, addr, None)

        async def on_push(msg):
            if msg.get("type") == "agent_task_done":
                if lease.current is not None and lease.current[0] == msg.get("task"):
                    lease.current = None
                    lease.last_used = time.monotonic()
                self._pump()

        async def on_close():
            self._on_worker_gone(lease)

        conn = Connection(reader, writer, on_push=on_push, on_close=on_close)
        lease.conn = conn
        conn.start()
        self.leases[worker_id] = lease
        self._pump()

    def _on_worker_gone(self, lease: _WorkerLease):
        self.leases.pop(lease.worker_id, None)
        lease.conn.close()
        if lease.current is not None:
            task_hex = lease.current[0]
            lease.current = None
            try:
                self.agent.conn.post({
                    "type": "agent_task_lost", "task": task_hex,
                    "worker_id": lease.worker_id,
                })
            except ConnectionError:
                pass
        self._pump()

    # -------------------------------------------------------- housekeeping
    def _maybe_spill(self):
        """Send home tasks that have waited out the spill deadline — the
        node cannot serve them promptly (no lease at all, or every lease
        stuck behind long-running tasks); central scheduling may place them
        on idle capacity elsewhere."""
        if not self.queue:
            return
        if any(l.current is None and not l.draining for l in self.leases.values()):
            return  # a free lease exists; the pump will drain the queue
        spill_s = rt_config.get("local_dispatch_spill_s")
        now = time.monotonic()
        stale = [t for t in self.queue if now - t[3] > spill_s]
        if not stale:
            return
        for item in stale:
            try:
                self.queue.remove(item)
            except ValueError:
                continue
        try:
            self.agent.conn.post({
                "type": "agent_spillback",
                "tasks": [t[0] for t in stale],
            })
        except ConnectionError:
            pass

    async def _reap_idle_loop(self):
        """Idle leases return to the controller pool (mirrors direct.py's
        LEASE_IDLE_RETURN_S); also the periodic spill check."""
        while True:
            await asyncio.sleep(1.0)
            now = time.monotonic()
            for lease in list(self.leases.values()):
                if (
                    lease.current is None
                    and not self.queue
                    and now - lease.last_used > 2.0
                ):
                    self._return_lease(lease)
            self._maybe_spill()
            if self.queue:
                self._pump()

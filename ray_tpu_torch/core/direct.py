"""Direct call plane — steady-state submissions bypass the controller.

Reference analog: `src/ray/core_worker/transport/direct_task_transport.cc`
(lines 135-247): submitters cache worker LEASES per scheduling class and
push task specs straight to the leased worker (`PushNormalTask`), touching
the scheduler only for lease grant/return; actor calls likewise flow
submitter→actor-worker once the actor is located (direct actor transport).

Redesign for this runtime: the controller grants leases over its existing
worker pool and stays out of BOTH directions of the hot path — specs ride a
submitter↔worker socket, and small results return inline on the same
socket, so a steady-state task costs the controller nothing. Big or
ref-carrying results register with the controller's object directory (the
one source of truth for shared objects) and resolve via the classic path.

Ordering for actor calls is preserved across the classic→direct switch by a
HANDOFF FENCE: the switch request threads through the same
controller→worker FIFO as every previously submitted classic call, so the
direct socket only activates once those calls are already in the actor's
queue (see `Controller.h_actor_handoff`).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import serialization
from .exceptions import (
    ActorDiedError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from .devices import ACCELERATOR  # the GPU worker kind (reference: none)
from .rpc import Connection, open_rpc_connection
from .task_spec import (
    DefaultSchedulingStrategy,
    TaskSpec,
    TaskType,
    spec_to_proto_bytes,
)

def _compact_actor_spec(spec: TaskSpec):
    return (
        spec.task_id.binary(),
        spec.actor_id.binary(),
        spec.method_name,
        spec.func_payload,
        spec.num_returns,
        [oid.binary() for oid in spec.arg_refs],
        spec.sequence_number,
        spec.parent_task_id.binary() if spec.parent_task_id else b"",
        spec.trace_id,
    )


def _compact_task_spec(spec: TaskSpec):
    """Compact wire form for NORMAL direct tasks (the actor analog above):
    a plain list instead of the full proto — eligible() guarantees no
    arg_refs / runtime_env / non-default scheduling, so the proto's
    encode+decode (~100µs round trip per task) bought nothing. Everything
    the worker needs for execution, task_events, AND a faithful lazy proto
    re-encode (registered-result lineage) rides along."""
    return [
        spec.task_id.binary(),
        spec.func_payload,
        spec.num_returns,
        spec.name,
        spec.trace_id,
        spec.parent_task_id.binary() if spec.parent_task_id else b"",
        dict(spec.resources),
        spec.options.max_retries,
        spec.owner_address,
    ]


def _spec_blob(spec_or_bytes) -> bytes:
    """Resubmission fallback: encode retained TaskSpecs lazily."""
    if isinstance(spec_or_bytes, (bytes, bytearray)):
        return spec_or_bytes
    return spec_to_proto_bytes(spec_or_bytes)


# A lease idle longer than this returns to the controller's pool.
LEASE_IDLE_RETURN_S = 2.0
# A lease with tasks in flight but NO completion for this long gets a
# health probe; an unanswered probe closes the conn (the close handler
# resubmits its pendings). Catches wedged conns/workers that look open.
LEASE_STALL_PING_S = 10.0
# Leases requested per scheduling key when the fast path misses (the
# controller grants up to available capacity; extras idle-return). 8 (was
# 4): a burst arriving on a cold key now spreads over a whole node's worth
# of workers in ONE grant round instead of piling onto the first four and
# waiting out steal rounds.
LEASE_WANT = 8
# Max tasks committed to one lease ahead of completion. Beyond this depth a
# burst parks in the central per-key buffer and leases PULL from it as
# completions free capacity (_refill_lease_locked) — the reference's
# client-side task queue, where tasks wait on the LEASE. Deep enough to
# amortize wake-ups and keep the worker fed across the completion RTT
# (with refill at half depth, one refill frame carries DEPTH/2 tasks);
# shallow enough that the drain tail and rebalancing stay cheap
# (unbounded pipelining measured one worker executing an entire 10k burst
# while seven sat idle, with the steal plane shuffling thousands of
# drop/reassign frames after the fact).
DIRECT_PIPELINE_DEPTH = 64


class _Lease:
    __slots__ = ("worker_id", "addr", "conn", "inflight", "draining",
                 "last_used", "pinging", "out_batch", "out_scheduled", "key")

    def __init__(self, worker_id: str, addr: str, conn: Connection,
                 key: Tuple = ()):
        self.worker_id = worker_id
        self.addr = addr
        self.conn = conn
        self.key = key  # scheduling key — buffer refills look it up
        self.inflight = 0
        self.draining = False
        self.last_used = time.monotonic()
        self.pinging = False  # stall-watchdog health probe in flight
        # Submission coalescing (the actor channel's out_batch, per lease):
        # compact specs accumulated between io-loop wake-ups ship as ONE
        # direct_task_batch frame — one encode, one worker-side decode and
        # queue put per burst instead of per task.
        self.out_batch: List = []
        self.out_scheduled = False


class _Pending:
    """One in-flight direct task (normal or actor)."""

    __slots__ = ("spec_bytes", "return_hexes", "event", "done", "retries",
                 "lease", "actor_hex", "resubmit_kind", "publish", "arg_pins",
                 "discard", "rebalance", "rebalance_t", "cancelled")

    def __init__(self, spec_bytes, return_hexes: List[str],
                 retries: int, resubmit_kind: str, actor_hex: str = ""):
        # TaskSpec (normal tasks — re-encoded lazily via _spec_blob on the
        # classic-fallback paths) or proto bytes (legacy callers).
        self.spec_bytes = spec_bytes
        self.return_hexes = return_hexes
        # Completion signal. The Event is LAZY: most results land before
        # anyone waits (get() finds the frame in the table), so the three
        # lock objects behind threading.Event were pure submit-path cost.
        self.event: Optional[threading.Event] = None
        self.done = False
        self.retries = retries
        self.lease: Optional[_Lease] = None
        self.actor_hex = actor_hex
        self.resubmit_kind = resubmit_kind  # "submit_task" | "submit_actor_task"
        # A ref to this task's result ESCAPED (arg / nested / put-contained)
        # before the task resolved — the result must publish into the
        # controller directory the moment it lands (see ensure_published).
        self.publish = False
        # The result's last ref was RELEASED while the task ran
        # (fire-and-forget): don't retain the frame when it arrives.
        self.discard = False
        # A steal is in flight: if the worker drops it (unstarted), it
        # REASSIGNS to a fresher lease instead of resolving as cancelled.
        self.rebalance = False
        self.rebalance_t = 0.0  # when the steal was sent (ack watchdog)
        # cancel() beat the rebalance: a drop resolves as cancelled.
        self.cancelled = False
        # Strong ObjectRefs pinning this call's arguments until completion —
        # the classic path's _pin_args has no analog here, so the submitter
        # itself keeps the objects alive (refs die with this entry).
        self.arg_pins: list = []

    def mark_done(self):
        self.done = True
        ev = self.event  # read AFTER setting done (see wait_done's order)
        if ev is not None:
            ev.set()

    # One shared lock for ALL entries' lazy-Event creation: contention is
    # nil (only the get()-before-result slow path takes it), and a per-entry
    # lock would resurrect the allocation cost laziness exists to avoid.
    _event_lock = threading.Lock()

    def wait_done(self, timeout: Optional[float]) -> bool:
        if self.done:
            return True
        ev = self.event
        if ev is None:
            with _Pending._event_lock:
                # Under the lock: two concurrent waiters must agree on ONE
                # Event — an overwritten orphan would leave the loser
                # blocked past the result.
                ev = self.event
                if ev is None:
                    ev = self.event = threading.Event()
            if self.done:
                # mark_done may have read self.event as None just before
                # the assignment — its done=True write precedes that read,
                # so re-checking here closes the race.
                return True
        return ev.wait(timeout)


class _ActorChannel:
    __slots__ = ("mode", "conn", "addr", "buffer", "pending_hexes", "cooldown",
                 "out_batch", "out_scheduled", "calls")

    def __init__(self):
        self.mode = "classic"  # classic | handoff | direct
        self.conn: Optional[Connection] = None
        self.addr = ""
        self.buffer: List[TaskSpec] = []  # specs queued during handoff
        self.pending_hexes: set = set()
        self.cooldown = 0.0  # monotonic time before retrying a failed handoff
        self.calls = 0  # classic submissions so far (handoff gates on >1)
        # Submission coalescing: compact calls accumulated between io-loop
        # wake-ups ship as ONE message (the worker's io thread unpickling
        # one frame per call stole the GIL from its executing main thread).
        self.out_batch: List[Tuple] = []
        self.out_scheduled = False


class DirectCallManager:
    """Per-backend manager: leases, actor channels, locally-owned results.

    Thread model: user threads call submit/lookup/wait; the backend's io
    loop delivers socket events. One lock guards all state; io callbacks
    hold it only for dict/flag updates (never across awaits).
    """

    def __init__(self, backend):
        self.backend = backend  # ClusterBackend
        self.io = backend.io
        self._lock = threading.Lock()
        self._leases: Dict[Tuple, List[_Lease]] = {}
        self._lease_requesting: set = set()
        # Specs awaiting a lease grant, per key (reference: the client-side
        # task queue in the direct transport — tasks wait on the LEASE, they
        # do not fall back to the scheduler and fight it for capacity).
        self._send_buffer: Dict[Tuple, List[Tuple[bytes, str]]] = {}
        # Grow-request verdicts: key → monotonic time until which the
        # cluster is known FULL for this key (pipelining onto busy leases is
        # then the best move — there is no idle capacity to wait for).
        self._full_until: Dict[Tuple, float] = {}
        # Grow-probe rate limit: a probe per submit would put one
        # run_coroutine_threadsafe (~0.4ms) on every submission.
        self._next_grow: Dict[Tuple, float] = {}
        # Steal-scan rate limit: the scan is O(pending) and lease inflight
        # hits zero constantly during tiny-task bursts.
        self._next_steal: Dict[Tuple, float] = {}
        self._pending: Dict[str, _Pending] = {}  # task_hex → entry
        # Task hexes with a steal in flight — the sweep's unacked-steal
        # watchdog iterates THIS small set, not all of _pending (an
        # O(pending) scan per tick under the submit lock collapsed the
        # submit rate at 500k queued tasks).
        self._rebalancing: set = set()
        # hex → ("frame", bytes) | ("registered",) — resolved direct results.
        self._table: Dict[str, Tuple] = {}
        self._hex_to_task: Dict[str, str] = {}  # return hex → task hex
        self._actors: Dict[str, _ActorChannel] = {}
        self._closed = False
        self._idle_timer_started = False
        self._idle_task_fut = None
        # Debug ring: lease lifecycle events (cheap; dumped by forensics).
        self._lease_log: List[Tuple] = []

    def _llog(self, *ev):
        self._lease_log.append((round(time.monotonic(), 3),) + ev)
        if len(self._lease_log) > 200:
            del self._lease_log[:100]

    # ------------------------------------------------------------ normal
    def eligible(self, spec: TaskSpec) -> bool:
        o = spec.options
        return (
            spec.task_type == TaskType.NORMAL_TASK
            and spec.num_returns >= 1
            and not spec.arg_refs
            and not o.runtime_env
            and (o.scheduling_strategy is None
                 or isinstance(o.scheduling_strategy, DefaultSchedulingStrategy))
        )

    def submit(self, spec: TaskSpec) -> bool:
        """Take ownership of an eligible task: send to an IDLE lease now, or
        buffer while more leases are requested. Queuing behind a busy lease
        happens only when the grow-request comes back empty (cluster full) —
        an eager pile-on would serialize parallel work behind one worker.
        False → classic."""
        if self._closed:
            return False
        key = (tuple(sorted(spec.resources.items())),
               spec.resources.get(ACCELERATOR, 0) > 0)  # reference: "TPU", ray_tpu/core/direct.py:293
        compact = _compact_task_spec(spec)
        # Retain the SPEC, not its proto bytes: the classic-fallback paths
        # re-encode lazily via _spec_blob, and the hot path never pays the
        # proto round trip at all (compact wire form).
        entry = _Pending(
            spec, [oid.hex() for oid in spec.return_ids],
            spec.options.max_retries, "submit_task",
        )
        task_hex = spec.task_id.hex()
        with self._lock:
            lease = self._pick_lease(key)
            now = time.monotonic()
            if lease is None or lease.inflight >= DIRECT_PIPELINE_DEPTH:
                # No lease yet, or every lease at depth: park centrally.
                # Completions pull from this buffer (_refill_lease_locked),
                # new grants drain it balanced, and the idle sweep is the
                # rescue backstop — parking can never strand the task.
                self._pending[task_hex] = entry
                for h in entry.return_hexes:
                    self._hex_to_task[h] = task_hex
                self._send_buffer.setdefault(
                    key, collections.deque()
                ).append((compact, task_hex))
                if lease is None:
                    self._maybe_request_leases(key, spec)
                elif (
                    now >= self._full_until.get(key, 0.0)
                    and now >= self._next_grow.get(key, 0.0)
                ):
                    self._next_grow[key] = now + 0.25
                    self._maybe_request_leases(key, spec)
                return True
            # Pipeline (bounded) and GROW in the background when queuing
            # starts, so a burst ramps the pool while the first tasks run.
            if (
                lease.inflight > 0
                and now >= self._full_until.get(key, 0.0)
                and now >= self._next_grow.get(key, 0.0)
            ):
                self._next_grow[key] = now + 0.25
                self._maybe_request_leases(key, spec)
            entry.lease = lease
            self._pending[task_hex] = entry
            for h in entry.return_hexes:
                self._hex_to_task[h] = task_hex
            lease.inflight += 1
            lease.last_used = time.monotonic()
            wake = self._enqueue_compact_locked(lease, compact)
        if wake:
            self._wake_lease_flush(lease)
        return True

    # --- per-lease submission batching (mirrors _ActorChannel.out_batch) ---
    def _enqueue_compact_locked(self, lease: _Lease, compact) -> bool:
        """Under lock: park a compact spec on the lease's out batch. Returns
        True when the caller must schedule a flush wake-up."""
        lease.out_batch.append(compact)
        wake = not lease.out_scheduled
        lease.out_scheduled = True
        return wake

    def _wake_lease_flush(self, lease: _Lease):
        try:
            lease.conn._loop.call_soon_threadsafe(self._flush_lease_batch, lease)
        except RuntimeError:
            pass  # loop closed — close handler recovers the pendings

    def _flush_lease_batch(self, lease: _Lease):
        """On the io loop: ship every compact spec accumulated since the
        wake was scheduled as one frame."""
        with self._lock:
            items, lease.out_batch = lease.out_batch, []
            lease.out_scheduled = False
        if not items:
            return
        try:
            if len(items) == 1:
                lease.conn.post({"type": "direct_task", "c": items[0]})
            else:
                lease.conn.post({"type": "direct_task_batch", "items": items})
        except ConnectionError:
            pass  # close handler resubmits pendings

    def _pick_lease(self, key) -> Optional[_Lease]:
        """Under lock: least-loaded usable lease for this key, or None."""
        lease = None
        for cand in self._leases.get(key) or ():
            if cand.draining or cand.conn._closed:
                continue
            if lease is None or cand.inflight < lease.inflight:
                lease = cand
        return lease

    def _flush_buffer_locked(self, key) -> List[Tuple[Any, _Lease, "_Pending"]]:
        """Under lock: assign buffered specs to leases, least-loaded first,
        each lease topped up to DIRECT_PIPELINE_DEPTH only — the remainder
        stays parked for completion-driven refills. Entries keep their
        _Pending; only transport changes."""
        out = []
        buf = self._send_buffer.get(key)
        while buf:
            lease = self._pick_lease(key)
            if lease is None or lease.inflight >= DIRECT_PIPELINE_DEPTH:
                break
            blob, task_hex = buf.popleft()
            entry = self._pending.get(task_hex)
            if entry is None or entry.lease is not None:
                continue  # cancelled/resolved/claimed while buffered
            entry.lease = lease
            lease.inflight += 1
            lease.last_used = time.monotonic()
            out.append((blob, lease, entry))
        if not buf:
            self._send_buffer.pop(key, None)
        return out

    def _refill_lease_locked(self, lease: _Lease) -> bool:
        """Under lock: top one lease back up to DIRECT_PIPELINE_DEPTH from
        the central buffer (completions pull work — no steal round trips).
        Returns True when the caller must schedule a flush wake-up."""
        buf = self._send_buffer.get(lease.key)
        if not buf or lease.draining or lease.conn._closed:
            return False
        wake = False
        while buf and lease.inflight < DIRECT_PIPELINE_DEPTH:
            compact, task_hex = buf.popleft()
            entry = self._pending.get(task_hex)
            if entry is None or entry.lease is not None:
                continue  # cancelled/resolved/claimed while buffered
            entry.lease = lease
            lease.inflight += 1
            lease.last_used = time.monotonic()
            wake = self._enqueue_compact_locked(lease, compact) or wake
        if not buf:
            self._send_buffer.pop(lease.key, None)
        return wake

    def _drain_buffer_stranded_locked(self, key) -> List[Tuple]:
        """Under lock, NO leases exist for the key: pop every buffered spec
        for the classic path (safe — never pushed to any worker)."""
        out = []
        for blob, task_hex in self._send_buffer.pop(key, ()):
            entry = self._pending.get(task_hex)
            if entry is not None and entry.lease is None:
                out.append((blob, None, entry))
        return out

    def _pipelined(self, conn: Connection, msg: dict):
        try:
            conn.post(msg)  # batched, fire-and-forget; close handler recovers
        except ConnectionError:
            pass

    def _maybe_request_leases(self, key, spec: TaskSpec):
        """Called under lock."""
        if key in self._lease_requesting:
            return
        self._lease_requesting.add(key)
        resources = dict(spec.resources)
        self.io.call_nowait(self._request_leases(key, resources))

    async def _request_leases(self, key, resources):
        # The finally-block is load-bearing: if this coroutine dies with the
        # key still in _lease_requesting, every future submission for the
        # key buffers forever (no lease, no new request — a deadlock).
        try:
            await self._request_leases_inner(key, resources)
        finally:
            wake: set = set()
            stranded: List[Tuple] = []
            with self._lock:
                self._lease_requesting.discard(key)
                if self._leases.get(key):
                    # Top existing leases back up to depth; the remainder
                    # stays parked for completion-driven refills.
                    for blob, lease, entry in self._flush_buffer_locked(key):
                        if self._enqueue_compact_locked(lease, blob):
                            wake.add(lease)
                else:
                    # No leases at all (exhausted / unreachable / closed /
                    # crashed): buffered work goes to the scheduler — safe,
                    # it was never pushed to any worker.
                    stranded = self._drain_buffer_stranded_locked(key)
                    for _blob, _l, entry in stranded:
                        self._pending.pop(
                            self._hex_to_task.get(entry.return_hexes[0], "")
                            if entry.return_hexes else "", None,
                        )
                        for h in entry.return_hexes:
                            self._table[h] = ("registered",)
            for lease in wake:
                self._wake_lease_flush(lease)
            if stranded:
                self._classic_fallback(stranded, pop=False)

    async def _request_leases_inner(self, key, resources):
        import asyncio

        # The controller PARKS under-supplied requests until workers
        # register — so no client backoff. A COLD key (no leases yet) waits
        # out a spawn round; a GROW request (leases exist, work queuing
        # behind them) asks briefly and falls back to pipelining.
        for attempt in range(4):
            with self._lock:
                lst = self._leases.get(key, ())
                existing = bool(lst)
                oversub = any(l.inflight > 1 for l in lst)
                # The tasks that would start now on more workers: parked
                # ones and those queued behind a running one. The autoscaler
                # reads them as demand, not the LEASE_WANT leases asked for
                # (reference: no such count, ray_tpu/core/direct.py:504).
                waiting = len(self._send_buffer.get(key, ())) + sum(
                    max(0, l.inflight - 1) for l in lst)
            try:
                resp = await self.backend.conn.request(
                    {"type": "request_lease", "resources": resources,
                     "count": LEASE_WANT,
                     "backlog": waiting,  # reference: none, ray_tpu/core/direct.py:504
                     # Cold keys wait out a spawn round; OVERSUBSCRIBED keys
                     # park briefly for freed capacity (arriving grants steal
                     # queued work back); pure grow probes must not park —
                     # submissions pipeline meanwhile either way.
                     "wait_s": 8.0 if not existing else (2.0 if oversub else 0.05)},
                    timeout=20,
                )
            except Exception:  # noqa: BLE001 — controller unreachable
                resp = None
                break
            grants = (resp or {}).get("leases") or []
            new = []
            for g in grants:
                try:
                    host, port = g["addr"].rsplit(":", 1)
                    reader, writer = await open_rpc_connection(host, int(port))
                except OSError:
                    await self._return_lease_id(g["worker_id"])
                    continue
                lease = _Lease(g["worker_id"], g["addr"],
                               Connection(reader, writer), key=key)
                lease.conn.on_push = self._make_on_result(lease)
                lease.conn.on_close = self._make_on_lease_close(lease)
                lease.conn.start()
                new.append(lease)
            give_back: List[_Lease] = []
            flush: List[Tuple] = []
            buffered_left = False
            with self._lock:
                if self._closed:
                    give_back = new
                else:
                    if new:
                        for _l in new:
                            self._llog("grant", _l.worker_id, id(_l))
                        self._leases.setdefault(key, []).extend(new)
                        if not self._idle_timer_started:
                            self._idle_timer_started = True
                            self._llog("idle_loop_start")
                            self._idle_task_fut = self.io.call_nowait(
                                self._idle_return_loop()
                            )
                    if self._leases.get(key):
                        # Only drain the buffer onto REAL leases — flushing
                        # with none would dump everything to the classic
                        # path on attempt 1 instead of waiting out a cold
                        # pool's spawn round.
                        flush = self._flush_buffer_locked(key)
                    buffered_left = bool(self._send_buffer.get(key))
            for lease in give_back:
                lease.conn.close()
                await self._return_lease_id(lease.worker_id)
            if give_back:
                break
            wake: set = set()
            with self._lock:
                for blob, lease, entry in flush:
                    # Enqueue, not await-send: a lease that died this
                    # instant must not kill the request loop — its pendings
                    # recover via the conn close handler.
                    if lease is not None and self._enqueue_compact_locked(lease, blob):
                        wake.add(lease)
            for lease in wake:
                self._wake_lease_flush(lease)
            if new:
                self._steal_for(key)
            with self._lock:
                oversub = any(
                    l.inflight > 1 for l in self._leases.get(key, ())
                )
            if existing and not new and not oversub:
                # Grow attempt found no idle capacity and nothing queues
                # behind busy leases: the cluster is FULL for this key —
                # pipeline for a while instead of stalling on doomed probes.
                with self._lock:
                    self._full_until[key] = time.monotonic() + 1.0
                break
            if not buffered_left and not oversub:
                break
            await asyncio.sleep(0.05)
        else:
            # Attempts exhausted while oversubscribed: capacity is genuinely
            # scarce — stop probing for a while.
            with self._lock:
                self._full_until[key] = time.monotonic() + 1.0

    def _steal_for(self, key):
        """New idle leases just arrived: ask deep-queued leases to give
        unstarted tasks back (client-side analog of the controller's
        prefetch reclaim). The worker refuses once a task started; a
        dropped task reassigns in _on_dropped.

        Steals move in BULK: each idle lease takes up to half the deepest
        lease's excess per round (one task per round redistributed a 10k
        pile-up at ~20 tasks/s — observed as one worker executing an entire
        burst while seven sat idle), and each victim lease gets ONE batched
        drop frame instead of a frame per task."""
        steals: Dict[_Lease, List[str]] = {}
        refill_wake: List[_Lease] = []
        now = time.monotonic()
        with self._lock:
            if now < self._next_steal.get(key, 0.0):
                return
            self._next_steal[key] = now + 0.05
            idle = [
                l for l in self._leases.get(key, ())
                if l.inflight == 0 and not l.draining and not l.conn._closed
            ]
            if not idle:
                return
            if self._send_buffer.get(key):
                # Central queue still holds unassigned work: refilling from
                # it is strictly cheaper than stealing committed tasks
                # (no drop round trip) — and while it is non-empty, every
                # lease is at depth anyway.
                for l in idle:
                    if self._refill_lease_locked(l):
                        refill_wake.append(l)
            if refill_wake or self._send_buffer.get(key):
                for l in refill_wake:
                    self._wake_lease_flush(l)
                return
            by_lease: Dict[_Lease, List[Tuple[str, _Pending]]] = {}
            for task_hex, entry in self._pending.items():
                l = entry.lease
                if (
                    l is not None and l.inflight > 1
                    and not entry.rebalance and not entry.actor_hex
                ):
                    by_lease.setdefault(l, []).append((task_hex, entry))
            planned: Dict[_Lease, int] = {}
            budget = 2048  # bound one round's drop traffic
            for idle_lease in idle:
                if budget <= 0:
                    break
                deep = max(
                    (l for l in by_lease
                     if by_lease[l]
                     # Leave one task per lease un-stolen: the deepest one
                     # is (usually) RUNNING — stealing it is a guaranteed
                     # refusal round trip, and a fully-emptied healthy
                     # lease would sit idle.
                     and planned.get(l, 0) < l.inflight - 1),
                    key=lambda l: l.inflight - planned.get(l, 0), default=None,
                )
                if deep is None:
                    break
                excess = deep.inflight - 1 - planned.get(deep, 0)
                # Half the victim's remaining excess, so repeated rounds
                # converge instead of sloshing the whole queue around.
                want = min(max(1, excess // 2), budget, len(by_lease[deep]))
                batch = steals.setdefault(deep, [])
                for _ in range(want):
                    task_hex, entry = by_lease[deep].pop()
                    entry.rebalance = True
                    entry.rebalance_t = now
                    self._rebalancing.add(task_hex)
                    batch.append(task_hex)
                planned[deep] = planned.get(deep, 0) + want
                budget -= want
            # Post the drop frames UNDER the lock: marking rebalance and
            # enqueueing the frame must be atomic w.r.t. the stall probe's
            # (snapshot marked steals, enqueue ping) — otherwise a pong can
            # "prove" a drop processed whose frame was sent after the ping,
            # and a real drop later resolves as a bogus TaskCancelledError.
            # post() only appends to a buffer, so this is cheap.
            for lease, hexes in steals.items():
                if len(hexes) == 1:
                    self._pipelined(lease.conn, {"type": "drop_task", "task": hexes[0]})
                else:
                    self._pipelined(lease.conn, {"type": "drop_tasks", "tasks": hexes})

    def _classic_fallback(self, triples, pop: bool = True):
        """Buffered-but-never-sent specs go to the scheduler (safe: zero
        execution risk — they were never pushed to any worker)."""
        for _blob, _lease, entry in triples:
            if pop and entry.return_hexes:
                with self._lock:
                    task_hex = self._hex_to_task.get(entry.return_hexes[0])
                    if task_hex is not None:
                        self._pending.pop(task_hex, None)
                    for h in entry.return_hexes:
                        self._table[h] = ("registered",)
            try:
                self.backend._send_pipelined(
                    {"type": entry.resubmit_kind, "spec": _spec_blob(entry.spec_bytes)}
                )
            except Exception:  # noqa: BLE001
                pass
            self._announce_refs(entry.return_hexes)
            entry.mark_done()

    async def _return_lease_id(self, worker_id: str):
        try:
            await self.backend.conn.send(
                {"type": "return_lease", "worker_id": worker_id}
            )
        except Exception:  # noqa: BLE001
            pass

    async def _return_lease_ids(self, worker_ids):
        """Batched give-back (idle sweep / shutdown): one frame returns the
        whole set — under lease churn the per-lease frames measurably
        competed with the submit path on the controller conn."""
        if not worker_ids:
            return
        if len(worker_ids) == 1:
            await self._return_lease_id(worker_ids[0])
            return
        try:
            await self.backend.conn.send(
                {"type": "return_lease_batch", "worker_ids": list(worker_ids)}
            )
        except Exception:  # noqa: BLE001
            pass

    # ---------------------------------------------------------- results
    def _make_on_result(self, lease: Optional[_Lease]):
        async def on_push(msg: dict):
            t = msg.get("type")
            if t == "direct_done":
                self._on_done(lease, msg)
            elif t == "direct_done_batch":
                for item in msg["items"]:
                    self._on_done(lease, item)
            elif t == "direct_dropped":
                self._on_dropped(msg)
            elif t == "direct_dropped_batch":
                for task_hex in msg["tasks"]:
                    self._on_dropped({"task": task_hex})

        return on_push

    def _on_done(self, lease: Optional[_Lease], msg: dict):
        registered: List[str] = []
        publish: List[str] = []
        with self._lock:
            entry = self._pending.pop(msg["task"], None)
            if entry is None:
                return
            if lease is not None:
                lease.inflight -= 1
                lease.last_used = time.monotonic()
            if msg.get("registered"):
                for h in entry.return_hexes:
                    self._table[h] = ("registered",)
                registered = entry.return_hexes
            else:
                for item in msg.get("results", ()):
                    h = item["id"]
                    # Fire-and-forget: the ref already died (release()
                    # marked the entry) — storing the frame would leak it.
                    if entry.publish or not entry.discard:
                        self._table[h] = ("frame", item["inline"])
                    else:
                        self._hex_to_task.pop(h, None)
                if entry.publish:
                    publish = entry.return_hexes
            ch = self._actors.get(entry.actor_hex) if entry.actor_hex else None
            if ch is not None:
                ch.pending_hexes.discard(msg["task"])
            drained = (
                lease is not None and lease.draining and lease.inflight == 0
            )
            # Completion-driven refill: this lease freed capacity — pull
            # buffered tasks onto it (the reference's lease queue: work
            # waits centrally, leases take it as they free up). Hysteresis:
            # refill only once HALF the depth has drained, then top all the
            # way up — per-completion single-task refills collapsed the
            # wire batching to one frame per task.
            refill_wake = (
                lease is not None and not lease.draining
                and lease.inflight <= DIRECT_PIPELINE_DEPTH // 2
                and self._refill_lease_locked(lease)
            )
            freed = (
                lease is not None and not lease.draining and lease.inflight == 0
            )
            freed_key = None
            if freed:
                for k, lst in self._leases.items():
                    if lease in lst:
                        # Only worth a steal scan when real imbalance exists.
                        if any(l.inflight > 1 for l in lst):
                            freed_key = k
                        break
        if refill_wake:
            self._wake_lease_flush(lease)
        if freed_key is not None:
            # This lease just went idle while others may be deep-queued —
            # the same steal that runs on new grants (a long task must not
            # hold later submissions while capacity sits idle).
            self._steal_for(freed_key)
        if registered:
            self._announce_refs(registered)
        if publish:
            # The ref escaped while the task was in flight — deliver on the
            # promise made by ensure_published (consumers long-poll on the
            # directory entry until this lands).
            try:
                self.backend.ensure_published(publish)
            except Exception:  # noqa: BLE001
                pass
        entry.mark_done()
        if drained:
            self._finish_drain(lease)

    def _announce_refs(self, hexes: List[str]):
        """A result just became controller-owned: the directory must see our
        holds (the flusher suppressed them while the object looked local).
        Dead-already refs go add+release in one batch — the controller
        processes adds first, so ever_held is still recorded."""
        from .ref_tracker import TRACKER

        dead = [h for h in hexes if TRACKER.local_count(h) <= 0]
        try:
            self.backend._send_nowait(
                {"type": "update_refs", "add": list(hexes), "release": dead}
            )
        except Exception:  # noqa: BLE001
            pass

    def _on_dropped(self, msg: dict):
        task_hex = msg["task"]
        with self._lock:
            entry = self._pending.get(task_hex)
            if entry is None:
                return
            if entry.lease is not None:
                entry.lease.inflight -= 1
            self._rebalancing.discard(task_hex)
            if entry.rebalance and not entry.cancelled:
                # Steal succeeded: the old worker will skip the spec —
                # reassign to the least-loaded OTHER lease.
                entry.rebalance = False
                old = entry.lease
                entry.lease = None
                key = None
                for k, lst in self._leases.items():
                    if old in lst:
                        key = k
                        break
                lease = None
                for cand in self._leases.get(key, ()) if key else ():
                    if cand is old or cand.draining or cand.conn._closed:
                        continue
                    if lease is None or cand.inflight < lease.inflight:
                        lease = cand
                if lease is not None:
                    entry.lease = lease
                    lease.inflight += 1
                    lease.last_used = time.monotonic()
                    blob = (
                        _compact_task_spec(entry.spec_bytes)
                        if isinstance(entry.spec_bytes, TaskSpec)
                        else entry.spec_bytes
                    )
                else:
                    blob = None  # no other lease — classic below
            else:
                self._pending.pop(task_hex, None)
                err = TaskError(TaskCancelledError(), "", "direct_task")
                for h in entry.return_hexes:
                    if entry.publish or not entry.discard:
                        self._table[h] = ("frame", serialization.pack(err))
                    else:
                        self._hex_to_task.pop(h, None)
                if entry.publish:
                    try:
                        self.backend.ensure_published(entry.return_hexes)
                    except Exception:  # noqa: BLE001
                        pass
                entry.mark_done()
                return
        # Rebalance continuation (outside lock). Rides the lease out batch:
        # a bulk steal's reassignments (hundreds at once) coalesce into one
        # frame per destination lease instead of one each.
        if entry.lease is not None:
            with self._lock:
                wake = self._enqueue_compact_locked(entry.lease, blob)
            if wake:
                self._wake_lease_flush(entry.lease)
        else:
            with self._lock:
                self._pending.pop(task_hex, None)
                for h in entry.return_hexes:
                    self._table[h] = ("registered",)
            try:
                self.backend._send_pipelined(
                    {"type": entry.resubmit_kind, "spec": _spec_blob(entry.spec_bytes)}
                )
            except Exception:  # noqa: BLE001
                pass
            self._announce_refs(entry.return_hexes)
            entry.mark_done()

    def _make_on_lease_close(self, lease: _Lease):
        async def on_close():
            self._recover_lost(lease=lease)

        return on_close

    def _recover_lost(self, lease: Optional[_Lease] = None, actor_hex: str = ""):
        """A direct socket died (worker crash / kill): resubmit its pending
        tasks via the classic path when retry policy allows, else resolve
        them with the matching error locally (reference semantics:
        max_retries / max_task_retries gate re-execution)."""
        to_resubmit: List[_Pending] = []
        to_fail: List[_Pending] = []
        with self._lock:
            if lease is not None:
                self._llog("recover_lost", lease.worker_id, id(lease))
                for lst in self._leases.values():
                    if lease in lst:
                        lst.remove(lease)
            doomed = [
                (h, e) for h, e in self._pending.items()
                if (lease is not None and e.lease is lease)
                or (actor_hex and e.actor_hex == actor_hex)
            ]
            for task_hex, entry in doomed:
                self._pending.pop(task_hex, None)
                (to_resubmit if entry.retries > 0 else to_fail).append(entry)
        for entry in to_fail:
            exc = (
                TaskError(ActorDiedError(), "", "direct_actor_task")
                if entry.actor_hex
                else TaskError(
                    WorkerCrashedError("leased worker died mid-task"),
                    "", "direct_task",
                )
            )
            with self._lock:
                for h in entry.return_hexes:
                    self._table[h] = ("frame", serialization.pack(exc))
            if entry.publish:
                try:
                    self.backend.ensure_published(entry.return_hexes)
                except Exception:  # noqa: BLE001
                    pass
            entry.mark_done()
        for entry in to_resubmit:
            # Controller re-owns the task: results land in the directory.
            with self._lock:
                for h in entry.return_hexes:
                    self._table[h] = ("registered",)
            try:
                self.backend._send_pipelined(
                    {"type": entry.resubmit_kind, "spec": _spec_blob(entry.spec_bytes)}
                )
            except Exception:  # noqa: BLE001 — controller gone too
                pass
            self._announce_refs(entry.return_hexes)
            entry.mark_done()

    # -------------------------------------------------- lease lifecycle
    async def _idle_return_loop(self):
        import asyncio
        import traceback

        while not self._closed:
            await asyncio.sleep(LEASE_IDLE_RETURN_S / 2)
            try:
                await self._idle_sweep_once()
            except Exception:  # noqa: BLE001 — the sweep is the liveness
                # backstop for the whole lease plane; one bad tick (a lease
                # mutated mid-scan, a closing conn) must never kill it.
                self._llog("sweep_error", traceback.format_exc()[-400:])

    async def _idle_sweep_once(self):
        now = time.monotonic()
        give_back: List[_Lease] = []
        rebalance: List[Tuple] = []
        stalled: List[_Lease] = []
        busy: List[_Lease] = []
        refill_wake: List[_Lease] = []
        rescue: List[Tuple] = []
        with self._lock:
            # Buffer backstop: parked work must always have a drain path —
            # under-depth leases refill here if a completion wake was lost;
            # a key whose every lease died (refills impossible, no request
            # in flight) re-enters the lease request machinery, whose
            # no-lease path hands the work to the scheduler.
            for key, buf in list(self._send_buffer.items()):
                if not buf:
                    self._send_buffer.pop(key, None)
                    continue
                lst = self._leases.get(key)
                if lst:
                    for l in lst:
                        if (
                            l.inflight < DIRECT_PIPELINE_DEPTH
                            and not l.draining and not l.conn._closed
                            and self._refill_lease_locked(l)
                        ):
                            refill_wake.append(l)
                elif key not in self._lease_requesting:
                    entry = self._pending.get(buf[0][1])
                    if entry is not None and isinstance(entry.spec_bytes, TaskSpec):
                        rescue.append((key, dict(entry.spec_bytes.resources)))
        for l in refill_wake:
            self._wake_lease_flush(l)
        for key, resources in rescue:
            with self._lock:
                if key not in self._lease_requesting:
                    self._lease_requesting.add(key)
                    self.io.call_nowait(self._request_leases(key, resources))
        with self._lock:
            # Counters read under the lock: a concurrent mutation outside it
            # raises "dict changed size during iteration", which the outer
            # catch turns into a whole aborted sweep tick (ADVICE r4).
            self._llog("sweep", sum(len(v) for v in self._leases.values()),
                       len(self._pending))
            for key, lst in list(self._leases.items()):
                for lease in list(lst):
                    if (
                        lease.inflight == 0
                        and now - lease.last_used > LEASE_IDLE_RETURN_S
                    ):
                        self._llog("idle_return", lease.worker_id, id(lease))
                        lst.remove(lease)
                        give_back.append(lease)
                if not lst:
                    self._leases.pop(key, None)
                    continue
                # Liveness backstop: a task pipelined behind a long one
                # while another lease sits idle normally rebalances on
                # the grant/idle-transition steals — but those are
                # single events; if either notification is lost (worker
                # hiccup, conn race) the task would wait out the ENTIRE
                # long task. This periodic sweep bounds that to one
                # idle-loop tick (observed once as a stranded fast task
                # behind a 10 s sleeper with three idle leases).
                if any(l.inflight > 1 for l in lst) and any(
                    l.inflight == 0 and not l.draining
                    and not l.conn._closed for l in lst
                ):
                    rebalance.append(key)
                for lease in lst:
                    if lease.inflight > 0 and not lease.conn._closed:
                        busy.append(lease)
                        if (
                            not lease.pinging
                            and now - lease.last_used > LEASE_STALL_PING_S
                        ):
                            lease.pinging = True
                            stalled.append(lease)
            # A steal sent but never acked (dropped OR executed) within
            # 2 s means the lease conn is likely blackholed — probe it
            # NOW rather than waiting out LEASE_STALL_PING_S (observed:
            # both a fast task and its drop request vanishing on one
            # lease while the socket looked open).
            for task_hex in list(self._rebalancing):
                entry = self._pending.get(task_hex)
                if entry is None or not entry.rebalance:
                    self._rebalancing.discard(task_hex)
                    continue
                l = entry.lease
                if (
                    l is not None
                    and now - entry.rebalance_t > 0.75
                    and not l.pinging and not l.conn._closed
                ):
                    l.pinging = True
                    stalled.append(l)
        for key in rebalance:
            self._steal_for(key)
        for lease in busy:
            # Lost-wakeup repair: a dropped post-flush wakeup leaves
            # direct_task frames parked in the conn's buffer (or compact
            # specs parked in the lease's out batch) while the worker looks
            # idle (observed as two tasks blackholed on one lease).
            # Re-firing the (idempotent) flushes every sweep tick bounds
            # that wedge to one tick.
            try:
                lease.conn._loop.call_soon_threadsafe(
                    self._flush_lease_batch, lease
                )
                lease.conn._loop.call_soon_threadsafe(
                    lease.conn._flush_posts
                )
            except RuntimeError:
                pass
        for lease in stalled:
            # No completion for LEASE_STALL_PING_S: prove the worker's
            # io round trip, or the conn dies and its pendings resubmit
            # via the close handler.
            self.io.call_nowait(self._probe_stalled_lease(lease))
        for lease in give_back:
            lease.conn.close()
        await self._return_lease_ids([l.worker_id for l in give_back])

    async def _probe_stalled_lease(self, lease: _Lease):
        """Health-probe a lease that has inflight work but no completions:
        an answered ping proves the socket + worker io loop both ways (the
        tasks are just long); an unanswered one means a wedged conn or dead
        worker — close it, and the close handler resubmits its pendings."""
        import asyncio

        try:
            # The ping rides the POST pipeline (post_request), and the set of
            # steals it can prove anything about is snapshotted in the same
            # locked region that enqueues it. Steals also enqueue their drop
            # frame under this lock, so: marked ⇒ drop frame FIFO-before the
            # ping ⇒ the pong proves the worker saw the drop. Steals issued
            # after the snapshot post after the ping and stay marked.
            with self._lock:
                marked = [
                    h for h, e in self._pending.items()
                    if e.lease is lease and e.rebalance
                ]
                fut = lease.conn.post_request({"type": "lease_ping"})
            await asyncio.wait_for(fut, timeout=2.5)
        except Exception:  # noqa: BLE001 — no pong: recover via close
            lease.conn.close()
        else:
            # A pong settles the lease: the worker demonstrably processed
            # everything posted before the ping (same-conn FIFO) — any
            # still-unacked marked steal was a REFUSAL (the task already
            # started; it completes normally), so clear those markers and
            # refresh the stall clock, else this probe would refire every
            # sweep tick for a long task's whole runtime.
            with self._lock:
                lease.last_used = time.monotonic()
                for h in marked:
                    e = self._pending.get(h)
                    if e is not None and e.lease is lease and e.rebalance:
                        e.rebalance = False
                        self._rebalancing.discard(h)
        finally:
            lease.pinging = False

    def on_revoke(self, worker_id: str):
        """Controller wants the worker back (queued-path backlog)."""
        drained = None
        with self._lock:
            for lst in self._leases.values():
                for lease in lst:
                    if lease.worker_id == worker_id:
                        self._llog("revoke", worker_id, id(lease), lease.inflight)
                        lease.draining = True
                        if lease.inflight == 0:
                            lst.remove(lease)
                            drained = lease
                        break
        if drained is not None:
            self._finish_drain(drained)

    def _finish_drain(self, lease: _Lease):
        with self._lock:
            self._llog("finish_drain", lease.worker_id, id(lease))
            for lst in self._leases.values():
                if lease in lst:
                    lst.remove(lease)
        lease.conn.close()
        self.io.call_nowait(self._return_lease_id(lease.worker_id))

    # ------------------------------------------------------ actor calls
    def actor_eligible(self, spec: TaskSpec) -> bool:
        # Once a channel is direct, EVERYTHING eligible-by-transport rides
        # it (ordering); streaming still works (controller stream plane).
        return spec.task_type == TaskType.ACTOR_TASK and not spec.options.runtime_env

    def submit_actor(self, spec: TaskSpec) -> bool:
        if self._closed or not self.actor_eligible(spec):
            return False
        actor_hex = spec.actor_id.hex()
        with self._lock:
            ch = self._actors.get(actor_hex)
            if ch is None:
                ch = self._actors[actor_hex] = _ActorChannel()
            if ch.mode == "classic":
                # Direct-channel handoff costs a round trip + fence + a TCP
                # connect per actor — pure loss for one-shot actors (envelope
                # ping probes, init-then-idle patterns). The FIRST call rides
                # the classic plane; sustained traffic (second call onward)
                # triggers the upgrade.
                ch.calls += 1
                if ch.calls > 1 and time.monotonic() >= ch.cooldown:
                    ch.mode = "handoff"
                    self.io.call_nowait(self._handoff(actor_hex, ch))
                    # THIS call buffers behind the fence (order preserved:
                    # it was submitted after every already-sent classic call).
                    self._buffer_call(ch, spec, actor_hex)
                    return True
                return False
            if ch.mode == "handoff":
                self._buffer_call(ch, spec, actor_hex)
                return True
            # direct
            if ch.conn is None or ch.conn._closed:
                ch.mode = "classic"
                return False
            compact = self._register_actor_pending(ch, spec, actor_hex)
            ch.out_batch.append(compact)
            wake = not ch.out_scheduled
            ch.out_scheduled = True
        if wake:
            try:
                ch.conn._loop.call_soon_threadsafe(self._flush_actor_batch, ch)
            except RuntimeError:  # loop closed — close handler recovers
                pass
        return True

    def _flush_actor_batch(self, ch: _ActorChannel):
        """On the io loop: ship everything accumulated since scheduling."""
        with self._lock:
            items, ch.out_batch = ch.out_batch, []
            ch.out_scheduled = False
            conn = ch.conn
        if not items or conn is None:
            return
        try:
            if len(items) == 1:
                conn.post({"type": "direct_actor_task", "c": items[0]})
            else:
                conn.post({"type": "direct_actor_batch", "items": items})
        except ConnectionError:
            pass  # close handler resubmits pendings

    def _buffer_call(self, ch: _ActorChannel, spec: TaskSpec, actor_hex: str):
        """Under lock: queue the spec until the fence resolves."""
        self._register_actor_pending(ch, spec, actor_hex)
        ch.buffer.append(spec)

    def _register_actor_pending(
        self, ch: _ActorChannel, spec: TaskSpec, actor_hex: str
    ):
        """Under lock. Returns the COMPACT wire form (proto encode/decode
        showed up as ~25µs/call on the hot actor path; the resubmission
        fallback re-encodes the retained TaskSpec lazily instead)."""
        compact = _compact_actor_spec(spec)
        if spec.num_returns == -1:
            return compact  # streaming resolves via the controller stream plane
        task_hex = spec.task_id.hex()
        entry = _Pending(
            spec, [oid.hex() for oid in spec.return_ids],
            spec.options.max_task_retries, "submit_actor_task", actor_hex,
        )
        if spec.arg_refs:
            from .object_ref import ObjectRef

            entry.arg_pins = [ObjectRef(oid) for oid in spec.arg_refs]
        self._pending[task_hex] = entry
        for h in entry.return_hexes:
            self._hex_to_task[h] = task_hex
        ch.pending_hexes.add(task_hex)
        return compact

    async def _handoff(self, actor_hex: str, ch: _ActorChannel):
        ok = False
        try:
            resp = await self.backend.conn.request(
                {"type": "actor_handoff", "actor": actor_hex}, timeout=35
            )
            ok = bool(resp and resp.get("ok"))
        except Exception:  # noqa: BLE001
            ok = False
        if ok:
            try:
                host, port = resp["addr"].rsplit(":", 1)
                reader, writer = await open_rpc_connection(host, int(port))
            except OSError:
                ok = False
        if not ok:
            flush: List[TaskSpec] = []
            reverted: List[_Pending] = []
            with self._lock:
                ch.mode = "classic"
                ch.cooldown = time.monotonic() + 5.0
                flush, ch.buffer = ch.buffer, []
                # Buffered entries revert to controller ownership.
                for task_hex in list(ch.pending_hexes):
                    entry = self._pending.pop(task_hex, None)
                    if entry is not None:
                        for h in entry.return_hexes:
                            self._table[h] = ("registered",)
                        reverted.append(entry)
                ch.pending_hexes.clear()
            for spec in flush:
                try:
                    self.backend._send_pipelined(
                        {"type": "submit_actor_task",
                         "spec": spec_to_proto_bytes(spec)}
                    )
                except Exception:  # noqa: BLE001
                    pass
            for entry in reverted:
                self._announce_refs(entry.return_hexes)
                entry.mark_done()
            return
        conn = Connection(reader, writer)
        conn.on_push = self._make_on_result(None)
        conn.on_close = self._make_on_actor_close(actor_hex)
        conn.start()
        with self._lock:
            ch.conn = conn
            ch.addr = resp["addr"]
            ch.mode = "direct"
            flush, ch.buffer = ch.buffer, []
        # post (not await send): later batched submissions are posts too, so
        # FIFO across the fence flush and everything after it is preserved.
        for spec in flush:
            conn.post(
                {"type": "direct_actor_task", "c": _compact_actor_spec(spec)}
            )

    def _make_on_actor_close(self, actor_hex: str):
        async def on_close():
            with self._lock:
                ch = self._actors.get(actor_hex)
                if ch is not None:
                    ch.mode = "classic"
                    ch.conn = None
                    ch.cooldown = time.monotonic() + 2.0
            self._recover_lost(actor_hex=actor_hex)

        return on_close

    # ------------------------------------------------------------ lookup
    def lookup(self, hex_id: str):
        """None = not direct-owned; ("frame", bytes) ready; ("registered",)
        = controller-owned; _Pending = still executing."""
        with self._lock:
            got = self._table.get(hex_id)
            if got is not None:
                return got
            task_hex = self._hex_to_task.get(hex_id)
            if task_hex is None:
                return None
            return self._pending.get(task_hex) or self._table.get(hex_id)

    def wait_pending(self, entries: List["_Pending"], timeout: Optional[float]):
        deadline = None if timeout is None else time.monotonic() + timeout
        for entry in entries:
            rem = None if deadline is None else deadline - time.monotonic()
            if rem is not None and rem <= 0:
                return False
            if not entry.wait_done(rem):
                return False
        return True

    def cancel(self, task_hex: str):
        """Cancel an in-flight direct task: the ref resolves CANCELLED
        immediately and deterministically; the drop push is best-effort
        execution avoidance (reference semantics — a task that already
        started may still run, but its result is discarded). Resolving
        locally first closes every race with steals/rebalances: any late
        direct_done/direct_dropped finds no pending entry and is ignored."""
        with self._lock:
            entry = self._pending.pop(task_hex, None)
            if entry is None:
                return False
            entry.cancelled = True
            if entry.lease is not None:
                # _on_done/_on_dropped skip popped entries, so this is the
                # one and only decrement.
                entry.lease.inflight -= 1
            conn = entry.lease.conn if entry.lease is not None else None
            if conn is None and entry.actor_hex:
                ch = self._actors.get(entry.actor_hex)
                conn = ch.conn if ch is not None else None
                if ch is not None:
                    ch.pending_hexes.discard(task_hex)
            err = TaskError(TaskCancelledError(), "", "direct_task")
            frame = serialization.pack(err)
            for h in entry.return_hexes:
                self._table[h] = ("frame", frame)
        if entry.publish:
            try:
                self.backend.ensure_published(entry.return_hexes)
            except Exception:  # noqa: BLE001
                pass
        entry.mark_done()
        if conn is not None and not conn._closed:
            self._pipelined(conn, {"type": "drop_task", "task": task_hex})
        return True

    def release(self, hex_id: str) -> bool:
        """GC of a locally-owned result; True if the release is fully
        handled here (the controller never knew the object)."""
        with self._lock:
            got = self._table.pop(hex_id, None)
            task_hex = self._hex_to_task.pop(hex_id, None)
            if got is not None:
                return got[0] == "frame"
            entry = self._pending.get(task_hex) if task_hex else None
            if entry is not None:
                # Fire-and-forget: consume the release now; the arriving
                # result is dropped instead of retained forever.
                entry.discard = True
                return True
            return False

    def owns(self, hex_id: str) -> bool:
        with self._lock:
            if hex_id in self._table:
                return self._table[hex_id][0] == "frame"
            return self._hex_to_task.get(hex_id) in self._pending

    def local_frame(self, hex_id: str) -> Optional[bytes]:
        with self._lock:
            got = self._table.get(hex_id)
            return got[1] if got is not None and got[0] == "frame" else None

    def mark_registered(self, hex_id: str):
        """The object was published to the controller (ensure_published) —
        future ref transitions must flush there, not stay local."""
        with self._lock:
            self._table[hex_id] = ("registered",)

    def flag_publish_on_done(self, hex_id: str) -> bool:
        """A ref escaped before its direct task resolved: promise to publish
        the result the moment it lands. True if a pending task claimed it."""
        with self._lock:
            task_hex = self._hex_to_task.get(hex_id)
            entry = self._pending.get(task_hex) if task_hex else None
            if entry is None:
                return False
            entry.publish = True
            return True

    # ---------------------------------------------------------- shutdown
    def close(self):
        self._closed = True
        if self._idle_task_fut is not None:
            self._idle_task_fut.cancel()
        with self._lock:
            leases = [l for lst in self._leases.values() for l in lst]
            self._leases.clear()
            chans = list(self._actors.values())
            self._actors.clear()
        for lease in leases:
            lease.conn.close()
        for ch in chans:
            if ch.conn is not None:
                ch.conn.close()



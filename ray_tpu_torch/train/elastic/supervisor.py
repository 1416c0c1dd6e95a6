"""Gang supervisor — death detection, mesh abort, restart policy.

Plane 1 of the elastic-training subsystem (ISSUE 4). The supervisor sits on
the driver next to BackendExecutor and answers three questions:

1. **Did a gang member die?** It subscribes to the controller's timeline
   through `poll_events` (the same feed `_on_actor_worker_death` writes
   `actor_restarting`/`actor_death` into — the actor-restart notification
   path reused, per the Ray paper's supervisor pattern, arXiv 1712.05889)
   and filters for the watched actor ids. Local mode has no controller —
   there the executor's poll loop (worker errors / failed actor calls) is
   the only detector, which is enough because local actors cannot be
   SIGKILLed independently anyway.
2. **How do we abort the whole mesh within the deadline?** Interrupt the
   collective first (`abort_collective_group` releases every member blocked
   in a rendezvous round instead of letting them wait out the full round
   timeout on a dead peer), then kill the surviving member actors, then
   tear down the worker group/placement group.
3. **Restart, shrink, or give up?** A capped restart budget
   (FailureConfig.max_failures) with exponential backoff
   (backoff_base_s * 2**attempt, capped at backoff_max_s); the new world
   size is chosen inside the ScalingConfig elasticity band
   [min_workers, max_workers] from currently-feasible capacity.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional, Set

from ..config import FailureConfig, ScalingConfig

# Timeline event kinds that mean "a watched gang member (or its host) is
# gone". node_died / chaos_worker_killed carry node/worker ids, matched
# against the gang placement resolved at watch() time — they fire a hair
# earlier than the per-actor events the same death eventually produces.
DEATH_EVENT_KINDS = (
    "actor_restarting",
    "actor_death",
    "chaos_worker_killed",
    "node_died",
)

_POLL_PERIOD_S = 0.1


@dataclass
class RestartDecision:
    stop: bool
    backoff_s: float = 0.0
    reason: str = ""


class GangSupervisor:
    """One instance per BackendExecutor.run(); watch() re-arms it on every
    gang (re)start."""

    def __init__(
        self,
        scaling: ScalingConfig,
        failure_config: Optional[FailureConfig] = None,
        experiment_name: str = "train",
    ):
        self.scaling = scaling
        # The band is snapshotted from the CONFIGURED scaling: run()
        # replaces scaling.num_workers on a shrink, and deriving the
        # ceiling from the mutated value would ratchet the gang down
        # permanently — a recovered node could never grow it back.
        self._band = scaling.elastic_band()
        self.failure_cfg = failure_config or FailureConfig()
        self.experiment_name = experiment_name
        self.attempts = 0
        self.last_recovery_s: Optional[float] = None
        self._actor_hexes: Set[str] = set()
        self._member_workers: Set[str] = set()
        self._member_nodes: Set[str] = set()
        self._cursor = -1
        self._failure_reason: Optional[str] = None
        self._failure_evt = threading.Event()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._collective_group: Optional[str] = None

    # ------------------------------------------------------------ watching
    def watch(self, worker_group, collective_group: Optional[str] = None):
        """Arm the supervisor on a (re)formed gang: remember the member
        actor ids and start the event-feed monitor (cluster mode only)."""
        self.stop_watch()
        self._collective_group = collective_group or self._collective_group
        ids = getattr(worker_group, "actor_ids", None)
        self._actor_hexes = set(ids() if ids else ())
        self._member_workers = set()
        self._member_nodes = set()
        self._failure_reason = None
        self._failure_evt.clear()
        backend = self._backend()
        if backend is None or not hasattr(backend, "poll_events"):
            return  # local mode: executor-poll detection only
        try:
            # Gang placement, so worker/node-level death events can be
            # scoped to THIS gang (an unrelated node scaling down must not
            # abort a healthy mesh; a member's node death is just detected
            # earlier than its actor_death).
            for a in backend._request({"type": "list_actors"})["actors"]:
                if a.get("actor_id") in self._actor_hexes:
                    if a.get("worker_id"):
                        self._member_workers.add(a["worker_id"])
                    if a.get("node_id"):
                        self._member_nodes.add(a["node_id"])
        except Exception:  # noqa: BLE001 — placement scoping is best-effort
            pass
        try:  # subscribe from the current tail
            self._cursor = backend.poll_events(cursor=-1)["cursor"]
        except Exception:  # noqa: BLE001 — controller mid-restart
            self._cursor = -1
        # Each arm gets a FRESH stop event: stop_watch's join is bounded
        # (2s), so a previous monitor can still be blocked inside an
        # unbounded poll_events RPC when the next watch() arms — clearing a
        # shared event would revive that zombie alongside the new monitor.
        # The old thread keeps its own (set) event and exits on return.
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(
            target=self._monitor,
            args=(self._stop_evt,),
            name="gang-supervisor",
            daemon=True,
        )
        self._thread.start()

    def stop_watch(self):
        self._stop_evt.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        self._thread = None

    def _backend(self):
        from ...core import api

        rt = api._runtime_if_initialized()
        return rt.backend if rt is not None else None

    def _monitor(self, stop_evt: threading.Event):
        backend = self._backend()
        # Snapshot the gang this thread watches: watch() replaces the
        # instance-level sets when the NEXT incarnation arms, and a
        # straggler thread must not report a stale death against it.
        actor_hexes = set(self._actor_hexes)
        member_nodes = set(self._member_nodes)
        member_workers = set(self._member_workers)
        cursor = self._cursor
        while not stop_evt.is_set():
            try:
                resp = backend.poll_events(
                    cursor=cursor, kinds=DEATH_EVENT_KINDS
                )
            except Exception:  # noqa: BLE001 — controller unreachable: the
                # head may be mid-failover (docs/CONTROL_PLANE_HA.md). The
                # backend reconnects underneath us with its own backoff;
                # this cursor survives the restart because poll_events
                # re-anchors a previous incarnation's cursor to the NEW
                # timeline's base server-side (deaths landing during the
                # gap still arrive) — re-arm nothing, just retry.
                if stop_evt.wait(_POLL_PERIOD_S * 5):
                    return
                continue
            cursor = resp.get("cursor", cursor)
            for ev in resp.get("events", ()):
                kind = ev.get("event")
                actor = ev.get("actor")
                hit = (
                    (actor and actor in actor_hexes)
                    or (kind == "node_died"
                        and ev.get("node") in member_nodes)
                    or (kind == "chaos_worker_killed"
                        and ev.get("worker") in member_workers)
                )
                if hit and not stop_evt.is_set():
                    self._failure_reason = (
                        f"{kind}: "
                        f"{actor or ev.get('node') or ev.get('worker', '?')}"
                    )
                    self._failure_evt.set()
                    return
            if stop_evt.wait(_POLL_PERIOD_S):
                return

    def failure(self) -> Optional[str]:
        """Non-blocking: the detected death (as a reason string), or None."""
        return self._failure_reason if self._failure_evt.is_set() else None

    # -------------------------------------------------------------- abort
    def abort_mesh(self, worker_group) -> float:
        """Abort the ENTIRE mesh: interrupt in-flight collectives, kill every
        member, drop the placement group. Returns seconds taken; logs a
        deadline breach (the deadline bounds the wedge, it cannot hard-stop
        a teardown that is already past it)."""
        t0 = time.monotonic()
        self.stop_watch()
        if self._collective_group:
            from ... import collective

            # One group (data-parallel gang) or a list of them (MPMD: one
            # dp group per pipeline stage) — every group a surviving member
            # could be blocked in gets aborted.
            groups = (
                self._collective_group
                if isinstance(self._collective_group, (list, tuple))
                else [self._collective_group]
            )
            for g in groups:
                collective.abort_collective_group(
                    g, timeout=self.failure_cfg.abort_deadline_s,
                )
        if worker_group is not None:
            worker_group.shutdown()
        took = time.monotonic() - t0
        if took > self.failure_cfg.abort_deadline_s:
            import logging

            logging.getLogger(__name__).warning(
                "gang abort took %.1fs (deadline %.1fs)",
                took, self.failure_cfg.abort_deadline_s,
            )
        return took

    # ------------------------------------------------------------- policy
    def feasible_workers(self) -> Optional[int]:
        """How many workers the cluster could place right now, from
        available CPU/TPU vs the per-worker ask. None when unknowable
        (no cluster backend)."""
        backend = self._backend()
        if backend is None or not hasattr(backend, "available_resources"):
            return None
        try:
            avail = backend.available_resources()
        except Exception:  # noqa: BLE001
            return None
        need = self.scaling.worker_resources()
        counts = []
        for res, per in need.items():
            if per <= 0:
                continue
            counts.append(int(avail.get(res, 0.0) // per))
        return min(counts) if counts else None

    def on_failure(self, reason: str) -> RestartDecision:
        """Consume one unit of restart budget and decide restart vs stop.
        The new world size is NOT chosen here: right after abort_mesh the
        just-killed survivors' resources are still draining on the
        controller, so a feasibility reading now would spuriously shrink
        the gang to the band floor — the executor calls plan_world_size()
        after the backoff sleep instead."""
        self.attempts += 1
        budget = self.failure_cfg.max_failures
        if budget >= 0 and self.attempts > budget:
            return RestartDecision(stop=True, reason=reason)
        backoff = min(
            self.failure_cfg.backoff_base_s * (2 ** (self.attempts - 1)),
            self.failure_cfg.backoff_max_s,
        )
        return RestartDecision(stop=False, backoff_s=backoff, reason=reason)

    def plan_world_size(self) -> int:
        """World size for the next incarnation, from the ORIGINAL
        elasticity band and capacity measured NOW (call after the backoff,
        when the dead gang's resources have been released). Growth back up
        to the configured ceiling happens here too, once capacity
        returns."""
        return self.scaling.pick_world_size(
            self.feasible_workers(), band=self._band
        )

    def record_recovery(self, seconds: float):
        """Count the restart + observe death-to-reformed-gang MTTR."""
        self.last_recovery_s = seconds
        try:
            from ...util.metrics import elastic_metrics

            m = elastic_metrics()
            tags = {"experiment": self.experiment_name}
            m["elastic_restarts_total"].inc(1.0, tags=tags)
            m["elastic_recovery_seconds"].observe(seconds, tags=tags)
        except Exception:  # noqa: BLE001 — metrics never load-bearing
            pass

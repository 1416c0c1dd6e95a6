"""Chaos testing actors (reference: `python/ray/_private/test_utils.py:1527`
`WorkerKillerActor` / `ResourceKillerActor`, and the chaos release suites
under `python/ray/tests/chaos/`).

Reusable kill-loops for fault-tolerance tests: run them as actors next to a
workload and assert the workload still completes (task retries, actor
restarts, lineage reconstruction absorb the damage).

    killer = WorkerKiller.options(name="chaos").remote(interval_s=1.0, max_kills=3)
    killer.run.remote()            # fire-and-forget kill loop
    ... run workload ...
    print(ray_tpu_torch.get(killer.kills.remote()))
"""

from __future__ import annotations

import random
import time
from typing import List, Optional


class _KillerBase:
    def __init__(self, interval_s: float = 1.0, max_kills: int = 3, seed: int = 0):
        self.interval_s = interval_s
        self.max_kills = max_kills
        self._rng = random.Random(seed)
        self._kills: List[str] = []
        self._stop = False

    def _backend(self):
        from ..core import api

        return api._global_runtime().backend

    def kills(self) -> List[str]:
        return list(self._kills)

    def stop(self):
        self._stop = True
        return True

    def _pick(self) -> Optional[str]:
        raise NotImplementedError

    def _kill(self, target: str) -> bool:
        raise NotImplementedError

    def run(self) -> bool:
        """Start the kill loop on a background thread and return immediately
        — `stop()`/`kills()` stay callable mid-chaos even on a default
        (max_concurrency=1) actor."""
        import threading

        def loop():
            while not self._stop and len(self._kills) < self.max_kills:
                time.sleep(self.interval_s)
                if self._stop:
                    break
                try:
                    target = self._pick()
                    if target is None:
                        continue
                    if self._kill(target):
                        self._kills.append(target)
                except Exception:  # noqa: BLE001 — backend gone (session
                    # teardown raced the kill loop, or the head is mid-
                    # failover): stop quietly instead of dying with a
                    # traceback that races test teardown.
                    return

        self._thread = threading.Thread(target=loop, name="chaos-killer", daemon=True)
        self._thread.start()
        return True

    def join(self, timeout: float = 60.0) -> int:
        """Wait for the loop to finish; returns kills performed."""
        t = getattr(self, "_thread", None)
        if t is not None:
            t.join(timeout)
        return len(self._kills)


class WorkerKiller(_KillerBase):
    """Kills BUSY workers (never itself, never actor hosts unless
    `include_actors=True`) — exercising task retry paths."""

    def __init__(self, interval_s: float = 1.0, max_kills: int = 3, seed: int = 0,
                 include_actors: bool = False):
        super().__init__(interval_s, max_kills, seed)
        self.include_actors = include_actors

    def _pick(self) -> Optional[str]:
        backend = self._backend()
        me = getattr(getattr(backend, "worker", None), "worker_id", None)
        workers = backend._request({"type": "list_workers"})["workers"]
        victims = [
            w["worker_id"]
            for w in workers
            if w["worker_id"] != me
            and (w["state"] in ("busy", "leased")
                 or (self.include_actors and w["state"] == "actor"))
        ]
        return self._rng.choice(victims) if victims else None

    def _kill(self, worker_id: str) -> bool:
        return bool(
            self._backend()._request({"type": "kill_worker", "worker_id": worker_id})["ok"]
        )


class GangKiller(_KillerBase):
    """Kills training-gang member processes (SIGKILL — no atexit, no
    graceful teardown), exercising the elastic-training supervisor path:
    whole-mesh abort within the deadline, gang restart, resume from the
    last committed checkpoint (ISSUE 4 / VERDICT item 4).

    `actor_ids`: hex actor ids of the gang members (from
    `WorkerGroup.actor_ids()` or `list_actors`); without them any
    actor-hosting worker is fair game. SIGKILL is sent straight to the
    hosting worker's pid — deliberately harsher than `kill_worker`'s
    SIGTERM so the victim gets no chance to leave the collective cleanly."""

    def __init__(self, interval_s: float = 1.0, max_kills: int = 1, seed: int = 0,
                 actor_ids: Optional[List[str]] = None):
        super().__init__(interval_s, max_kills, seed)
        self.actor_ids = set(actor_ids or ())

    def set_targets(self, actor_ids: List[str]) -> bool:
        self.actor_ids = set(actor_ids)
        return True

    def _pick(self) -> Optional[str]:
        backend = self._backend()
        me = getattr(getattr(backend, "worker", None), "worker_id", None)
        workers = backend._request({"type": "list_workers"})["workers"]
        victims = [
            w["worker_id"]
            for w in workers
            if w["worker_id"] != me
            and w.get("actor")
            and (not self.actor_ids or w["actor"] in self.actor_ids)
        ]
        return self._rng.choice(victims) if victims else None

    def _kill(self, worker_id: str) -> bool:
        import os
        import signal

        backend = self._backend()
        workers = backend._request({"type": "list_workers"})["workers"]
        pid = next(
            (w.get("pid") for w in workers if w["worker_id"] == worker_id), 0
        )
        if not pid:
            return False
        try:
            os.kill(pid, signal.SIGKILL)
            return True
        except OSError:
            return False


class HeadKiller:
    """Driver-side head chaos (controller HA harness): `kill -9` the head
    controller mid-workload and restart it against the same session dir —
    restore = checkpoint + WAL replay (docs/CONTROL_PLANE_HA.md). NOT an
    actor: an actor's own backend dies with the head; this runs in the
    driver process next to a `cluster_utils.Cluster`.

    Fault-point injection composes with it: export `RAY_TPU_FAULT_POINTS`
    (see core/event_log.py — crash-before-fsync / crash-after-log /
    torn-tail, each optionally scoped `@record_kind`) before starting the
    head, and the controller kills ITSELF at the named WAL site instead;
    `restart()` recovers either way.

        killer = HeadKiller(cluster)
        killer.kill()                  # SIGKILL, head gone mid-wave
        ... assert the fleet keeps serving ...
        killer.restart()               # checkpoint + replay, same port
    """

    def __init__(self, cluster, restart_delay_s: float = 0.2):
        self.cluster = cluster
        self.restart_delay_s = restart_delay_s
        self.kills = 0
        self._thread = None

    def kill(self):
        self.cluster.kill_head()
        self.kills += 1

    def restart(self):
        self.cluster.restart_head()

    def kill_and_restart(self):
        self.kill()
        time.sleep(self.restart_delay_s)
        self.restart()

    def run(self, interval_s: float = 2.0, max_kills: int = 1):
        """Background kill→restart loop (cluster-wide chaos next to a
        workload); join() to wait it out."""
        import threading

        def loop():
            for _ in range(max_kills):
                time.sleep(interval_s)
                self.kill_and_restart()

        self._thread = threading.Thread(
            target=loop, name="chaos-head-killer", daemon=True
        )
        self._thread.start()

    def join(self, timeout: float = 120.0) -> int:
        if self._thread is not None:
            self._thread.join(timeout)
        return self.kills


class NodeKiller(_KillerBase):
    """Kills non-head nodes (agent + its workers) — exercising node-death
    retry and lineage reconstruction."""

    def _pick(self) -> Optional[str]:
        nodes = self._backend()._request({"type": "nodes"})["nodes"]
        victims = [n["NodeID"] for n in nodes if n["Alive"] and n["NodeID"] != "node0"]
        return self._rng.choice(victims) if victims else None

    def _kill(self, node_id: str) -> bool:
        return bool(
            self._backend()._request({"type": "kill_node", "node_id": node_id})["ok"]
        )

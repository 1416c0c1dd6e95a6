"""Per-process ObjectRef reference tracking with batched release RPCs.

Reference analog: `ReferenceCounter` (`src/ray/core_worker/reference_count.h:39-52`)
— the owner tracks local+submitted refs; borrowers register and the owner
learns of release via batched pubsub rather than per-object RPCs
(`src/ray/pubsub/README.md:7-27`). Redesign for the controller-owned model:
every process counts its live `ObjectRef` instances per object; 0→1 and →0
transitions are BATCHED into one `update_refs` message to the controller,
which frees an object when no process holds it and no pending task pins it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Set

def _flush_interval() -> float:
    from . import config as rt_config

    return rt_config.get("ref_flush_interval_s")


class RefTracker:
    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._pending_add: Set[str] = set()
        self._pending_release: Set[str] = set()
        # __del__-path decrefs land here WITHOUT taking the lock: cyclic GC
        # can fire ObjectRef.__del__ on a thread that already holds _lock
        # (any allocation inside a locked section can trigger it) — a plain
        # lock acquire there would self-deadlock. deque.append is atomic.
        self._dec_queue: deque = deque()
        self._flusher: Optional[Callable[[list, list], None]] = None
        self._gen = 0  # flush-thread generation: bumping it retires old threads

    # ------------------------------------------------------------- wiring
    def set_flusher(self, flusher: Optional[Callable[[list, list], None]]):
        """Install the send function (backend connect) or detach (shutdown).
        Every install spawns a fresh generation-bound thread — no alive-check
        race with a retiring predecessor (shutdown→init in one process)."""
        with self._lock:
            self._gen += 1
            gen = self._gen
            self._flusher = flusher
            if flusher is not None:
                # Announce refs created before the backend connected.
                self._pending_add.update(
                    h for h, c in self._counts.items() if c > 0
                )
        if flusher is not None:
            threading.Thread(
                target=self._flush_loop, args=(gen,), name="ref-flusher", daemon=True
            ).start()

    # ------------------------------------------------------------ counting
    def incref(self, hex_id: str):
        with self._lock:
            self._apply_decrefs_locked()  # keep per-thread del→create ordering
            c = self._counts.get(hex_id, 0)
            self._counts[hex_id] = c + 1
            if c == 0 and self._flusher is not None:
                self._pending_release.discard(hex_id)
                self._pending_add.add(hex_id)

    def decref(self, hex_id: str):
        # Lock-free and non-blocking: __del__ may run on ANY thread (the
        # backend's IO loop, or a thread that already holds _lock via cyclic
        # GC). The flush thread applies queued decrefs under the lock.
        self._dec_queue.append(hex_id)

    def _apply_decrefs_locked(self):
        while True:
            try:
                hex_id = self._dec_queue.popleft()
            except IndexError:
                return
            c = self._counts.get(hex_id, 0) - 1
            if c <= 0:
                self._counts.pop(hex_id, None)
                if self._flusher is not None:
                    # Keep BOTH sides even when the add was never flushed: the
                    # controller processes adds before releases, so a
                    # short-lived ref still marks its object ever_held (else
                    # `get(f.remote())` results would never be GC-eligible).
                    self._pending_release.add(hex_id)
            else:
                self._counts[hex_id] = c

    # ------------------------------------------------------------- flushing
    def flush(self):
        with self._lock:
            self._apply_decrefs_locked()
            flusher = self._flusher
            if flusher is None or (not self._pending_add and not self._pending_release):
                return
            add = list(self._pending_add)
            release = list(self._pending_release)
            self._pending_add.clear()
            self._pending_release.clear()
        try:
            flusher(add, release)
        except Exception:  # noqa: BLE001 — backend gone; drop silently
            pass

    def _flush_loop(self, gen: int):
        while True:
            time.sleep(_flush_interval())
            with self._lock:
                if self._gen != gen or self._flusher is None:
                    return
            self.flush()

    def local_count(self, hex_id: str) -> int:
        with self._lock:
            self._apply_decrefs_locked()
            return self._counts.get(hex_id, 0)


TRACKER = RefTracker()

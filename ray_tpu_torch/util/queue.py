"""Distributed Queue — an actor-backed multi-producer/consumer queue.

Reference analog: `python/ray/util/queue.py` (asyncio-actor-backed Queue
with Empty/Full mirroring the stdlib `queue` contract). Blocking put/get
park SERVER-SIDE on a condition variable inside the actor (the reference
blocks in the asyncio actor the same way) — a blocked caller holds one
in-flight RPC instead of polling the control plane.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from queue import Empty, Full  # re-exported, stdlib-compatible
from typing import Any, List, Optional

from ..core import api

__all__ = ["Queue", "Empty", "Full"]

# Server-side waits are chunked: the actor's thread pool is finite, so a
# wait must release its thread periodically or fully-parked getters could
# starve the put that would wake them.
_WAIT_CHUNK_S = 2.0


class _QueueActor:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.items: deque = deque()
        self._cv = threading.Condition()

    def qsize(self) -> int:
        with self._cv:
            return len(self.items)

    def _has_room(self, n: int = 1) -> bool:
        return self.maxsize <= 0 or len(self.items) + n <= self.maxsize

    def put_nowait(self, item) -> bool:
        with self._cv:
            if not self._has_room():
                return False
            self.items.append(item)
            self._cv.notify_all()
            return True

    def put_nowait_batch(self, items: List[Any]) -> bool:
        with self._cv:
            if not self._has_room(len(items)):
                return False
            self.items.extend(items)
            self._cv.notify_all()
            return True

    def put_wait(self, item, timeout_s: float) -> bool:
        """Blocking put: parks up to timeout_s on the actor, not the caller."""
        with self._cv:
            if not self._cv.wait_for(self._has_room, timeout_s):
                return False
            self.items.append(item)
            self._cv.notify_all()
            return True

    def get_nowait(self):
        with self._cv:
            if not self.items:
                return False, None
            item = self.items.popleft()
            self._cv.notify_all()
            return True, item

    def get_nowait_batch(self, n: int):
        with self._cv:
            got = []
            while self.items and len(got) < n:
                got.append(self.items.popleft())
            if got:
                self._cv.notify_all()
            return got

    def get_wait(self, timeout_s: float):
        with self._cv:
            if not self._cv.wait_for(lambda: len(self.items) > 0, timeout_s):
                return False, None
            item = self.items.popleft()
            self._cv.notify_all()
            return True, item


class Queue:
    """Sync facade over the queue actor; blocking calls wait server-side."""

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0)
        # Enough actor threads that parked waiters leave room for the
        # put/get that wakes them (waits also self-expire per _WAIT_CHUNK_S).
        opts.setdefault("max_concurrency", 32)
        self.maxsize = maxsize
        self.actor = api.remote(**opts)(_QueueActor).remote(maxsize)

    # ------------------------------------------------------------- inspect
    def qsize(self) -> int:
        return api.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    # ----------------------------------------------------------------- put
    def put(self, item: Any, block: bool = True, timeout: Optional[float] = None):
        if not block:
            if not api.get(self.actor.put_nowait.remote(item)):
                raise Full
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            chunk = _WAIT_CHUNK_S
            if deadline is not None:
                chunk = min(chunk, deadline - time.monotonic())
                if chunk <= 0:
                    raise Full
            if api.get(self.actor.put_wait.remote(item, chunk)):
                return

    def put_nowait(self, item: Any):
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]):
        if not api.get(self.actor.put_nowait_batch.remote(list(items))):
            raise Full

    # ----------------------------------------------------------------- get
    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if not block:
            ok, item = api.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty
            return item
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            chunk = _WAIT_CHUNK_S
            if deadline is not None:
                chunk = min(chunk, deadline - time.monotonic())
                if chunk <= 0:
                    raise Empty
            ok, item = api.get(self.actor.get_wait.remote(chunk))
            if ok:
                return item

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_nowait_batch(self, n: int) -> List[Any]:
        return api.get(self.actor.get_nowait_batch.remote(n))

    # -------------------------------------------------------------- manage
    def shutdown(self):
        api.kill(self.actor)

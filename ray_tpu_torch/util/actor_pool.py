"""ActorPool — mapping work over a fixed set of actors.

Reference analog: `python/ray/util/actor_pool.py` — submit/get_next
round-robin over idle actors with in-order and unordered result streams.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

from ..core import api


class ActorPool:
    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        if not self._idle:
            raise ValueError("ActorPool needs at least one actor")
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0

    # ------------------------------------------------------------ submit
    def submit(self, fn: Callable[[Any, Any], Any], value: Any):
        """fn(actor, value) -> ObjectRef; blocks only when no actor is idle
        (waits for the oldest in-flight call and re-queues its actor)."""
        if not self._idle:
            if not self._future_to_actor:
                raise RuntimeError(
                    "ActorPool has no actors (all were pop_idle()d away)"
                )
            self._wait_for_any()
        if not self._idle:
            raise RuntimeError("ActorPool could not reclaim an idle actor")
        actor = self._idle.pop(0)
        ref = fn(actor, value)
        self._future_to_actor[ref] = actor
        self._index_to_future[self._next_task_index] = ref
        self._next_task_index += 1

    def _wait_for_any(self):
        refs = list(self._future_to_actor)
        ready, _ = api.wait(refs, num_returns=1, timeout=None)
        for r in ready:
            self._reclaim(r)

    def _reclaim(self, ref):
        actor = self._future_to_actor.get(ref)
        if actor is not None and actor not in self._idle:
            # The actor becomes reusable the moment its call finished; the
            # result stays fetchable from the future maps.
            self._idle.append(actor)

    # ------------------------------------------------------------ results
    def has_next(self) -> bool:
        return self._next_return_index < self._next_task_index

    def get_next(self, timeout: float | None = None) -> Any:
        """Next result in SUBMISSION order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        ref = self._index_to_future.get(self._next_return_index)
        if ref is None:
            raise RuntimeError(
                "get_next after get_next_unordered consumed this index — "
                "pick one consumption order per batch"
            )
        # A TIMEOUT leaves pool state untouched (get_next is retryable); a
        # task-raised error consumes the index so iteration can continue
        # past the failed task.
        from ..core.exceptions import GetTimeoutError

        try:
            value = api.get(ref, timeout=timeout)
        except GetTimeoutError:
            raise
        except BaseException:
            del self._index_to_future[self._next_return_index]
            self._next_return_index += 1
            actor = self._future_to_actor.pop(ref, None)
            if actor is not None and actor not in self._idle:
                self._idle.append(actor)
            raise
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        actor = self._future_to_actor.pop(ref, None)
        if actor is not None and actor not in self._idle:
            self._idle.append(actor)
        return value

    def get_next_unordered(self, timeout: float | None = None) -> Any:
        """Next result in COMPLETION order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        ready, _ = api.wait(
            list(self._future_to_actor), num_returns=1, timeout=timeout
        )
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        ref = ready[0]
        for idx, fut in list(self._index_to_future.items()):
            if fut == ref:
                del self._index_to_future[idx]
                break
        self._next_return_index += 1
        value = api.get(ref)
        actor = self._future_to_actor.pop(ref, None)
        if actor is not None and actor not in self._idle:
            self._idle.append(actor)
        return value

    # --------------------------------------------------------------- map
    def map(self, fn: Callable[[Any, Any], Any], values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any], values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # ------------------------------------------------------------- manage
    def push(self, actor: Any):
        """Add an idle actor to the pool."""
        self._idle.append(actor)

    def pop_idle(self) -> Any | None:
        """Remove and return an idle actor (None if all are busy)."""
        return self._idle.pop() if self._idle else None

    def has_free(self) -> bool:
        return bool(self._idle)

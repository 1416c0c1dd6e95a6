"""ObjectRef: a first-class future handle to an immutable object.

Equivalent of the reference's `ray.ObjectRef` (`python/ray/includes/object_ref.pxi`)
— holds the binary ObjectID (which encodes the creating task, see ids.py) plus
the owner's address hint so any process can resolve it without a directory hop.
"""

from __future__ import annotations

from typing import Any, Optional

from .ids import ObjectID


class ObjectRef:
    __slots__ = ("id", "owner_address", "_weak")

    def __init__(
        self,
        object_id: ObjectID,
        owner_address: Optional[str] = None,
        _weak: bool = False,
    ):
        self.id = object_id
        self.owner_address = owner_address
        self._weak = _weak
        if not _weak:
            from .ref_tracker import TRACKER

            TRACKER.incref(object_id.hex())

    def __del__(self):
        try:
            if not self._weak:
                from .ref_tracker import TRACKER

                TRACKER.decref(self.id.hex())
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def hex(self) -> str:
        return self.id.hex()

    def binary(self) -> bytes:
        return self.id.binary()

    def task_id(self):
        return self.id.task_id()

    def job_id(self):
        return self.id.job_id()

    def future(self):
        """Return a concurrent.futures.Future resolving to the object value."""
        from . import api

        return api._global_runtime().as_future(self)

    def __await__(self):
        from . import api

        runtime = api._global_runtime()
        return runtime.as_asyncio_future(self).__await__()

    def __hash__(self) -> int:
        return hash(self.id)

    def __eq__(self, other) -> bool:
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self) -> str:
        return f"ObjectRef({self.id.hex()})"

    def __reduce__(self):
        from .serialization import CONTAINED

        if CONTAINED.active is not None:
            CONTAINED.active.append(self.id.hex())
        return (ObjectRef, (self.id, self.owner_address))


class ObjectRefGenerator:
    """Streaming generator handle (reference: `_raylet.pyx:272`
    ObjectRefGenerator / `returns_dynamic`).

    Yields ObjectRefs for a `num_returns="streaming"` task AS THE TASK
    PRODUCES THEM: each `__next__` long-polls the directory for the next
    yielded index (ObjectID = task_id + index, so refs mint locally) and
    raises StopIteration when the producer finishes."""

    def __init__(self, task_id, owner_address: Optional[str] = None):
        self._task_id = task_id
        self._owner_address = owner_address
        self._index = 0

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        from . import api
        from .ids import ObjectID

        backend = api._global_runtime().backend
        status = backend.stream_next(self._task_id.hex(), self._index)
        if status == "end":
            self._release()
            raise StopIteration
        ref = ObjectRef(ObjectID.of(self._task_id, self._index), self._owner_address)
        self._index += 1
        return ref

    def completed(self) -> list:
        """Drain the remaining stream into a list of refs."""
        return list(self)

    def _release(self):
        """Tell the directory which indices this consumer will never claim
        (items past _index) so they become GC-eligible, and let the stream's
        bookkeeping go once done. Runs on exhaustion AND on drop."""
        if getattr(self, "_released", False):
            return
        self._released = True
        try:
            from . import api

            # _release runs from __del__/GC on arbitrary threads — only the
            # lock-free peek is safe here (never _global_runtime()).
            runtime = api._runtime_if_initialized()
            if runtime is None:
                return
            release = getattr(runtime.backend, "stream_release", None)
            if release is not None:
                release(self._task_id.hex(), self._index)
        except Exception:  # noqa: BLE001 — interpreter teardown / backend gone
            pass

    def __del__(self):
        try:
            self._release()
        except Exception:  # noqa: BLE001
            pass


# Alias kept for API parity with the reference (`DynamicObjectRefGenerator`).
DynamicObjectRefGenerator = ObjectRefGenerator

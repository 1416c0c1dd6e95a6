"""Binary IDs for the runtime.

Design follows the reference's bit-layout property (ray `src/ray/common/id.h`):
an ObjectID embeds the TaskID that created it (`id.h:272`), a TaskID embeds the
ActorID/JobID context (`id.h:182`), so ownership and lineage lookups are pure
bit-slicing — no directory round-trip is needed to find an object's creator.

Layouts (bytes):
    JobID            = 4  (unique)
    ActorID          = 12 unique + 4 JobID                  = 16
    TaskID           = 8  unique + 16 ActorID               = 24
    ObjectID         = 24 TaskID + 4 little-endian index    = 28
    NodeID, WorkerID, PlacementGroupID = 16 random
"""

from __future__ import annotations

import os
import random
import threading

# ID randomness needs uniqueness, not unpredictability — a per-process PRNG
# seeded from the OS is ~20× cheaper than os.urandom per ID (urandom showed
# up as the #3 submit-path cost at 6k IDs/s). Reseeded after fork so child
# processes (workers fork from the forkserver template) never repeat a
# stream. The fork check rides os.register_at_fork instead of a getpid()
# per call: under GIL contention the "trivial" getpid syscall measured
# ~140µs/call on the submit hot path (the thread loses the GIL around every
# syscall), ~14% of total submit cost at 10k tasks.
_rng = random.Random(os.urandom(16))
_rng_lock = threading.Lock()


def _reseed_after_fork():
    global _rng
    _rng = random.Random(os.urandom(16))


os.register_at_fork(after_in_child=_reseed_after_fork)


def _rand_bytes(n: int) -> bytes:
    with _rng_lock:
        return _rng.randbytes(n)

_JOB_ID_SIZE = 4
_ACTOR_UNIQUE_SIZE = 12
_ACTOR_ID_SIZE = _ACTOR_UNIQUE_SIZE + _JOB_ID_SIZE  # 16
_TASK_UNIQUE_SIZE = 8
_TASK_ID_SIZE = _TASK_UNIQUE_SIZE + _ACTOR_ID_SIZE  # 24
_OBJECT_INDEX_SIZE = 4
_OBJECT_ID_SIZE = _TASK_ID_SIZE + _OBJECT_INDEX_SIZE  # 28
_UNIQUE_ID_SIZE = 16


class BaseID:
    """Immutable binary ID; hashable, comparable, hex-printable."""

    SIZE = _UNIQUE_ID_SIZE
    __slots__ = ("_bytes", "_hash", "_hex")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(id_bytes)}"
            )
        self._bytes = bytes(id_bytes)
        self._hash = hash((type(self).__name__, self._bytes))
        self._hex = None

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(_rand_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str) -> "BaseID":
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(b"\xff" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        # Cached: ids get hexed on every directory/table touch — the task
        # hot path hexes the same TaskID/ObjectIDs several times each.
        h = self._hex
        if h is None:
            h = self._hex = self._bytes.hex()
        return h

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other) -> bool:
        return self._bytes < other._bytes

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class UniqueID(BaseID):
    SIZE = _UNIQUE_ID_SIZE


class NodeID(UniqueID):
    pass


class WorkerID(UniqueID):
    pass


class PlacementGroupID(UniqueID):
    pass


class JobID(BaseID):
    SIZE = _JOB_ID_SIZE

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(_JOB_ID_SIZE, "little"))

    def int_value(self) -> int:
        return int.from_bytes(self._bytes, "little")


class ActorID(BaseID):
    SIZE = _ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID, unique: bytes | None = None) -> "ActorID":
        unique = unique if unique is not None else _rand_bytes(_ACTOR_UNIQUE_SIZE)
        return cls(unique + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[_ACTOR_UNIQUE_SIZE:])


class TaskID(BaseID):
    SIZE = _TASK_ID_SIZE

    @classmethod
    def of(cls, actor_id: ActorID, unique: bytes | None = None) -> "TaskID":
        unique = unique if unique is not None else _rand_bytes(_TASK_UNIQUE_SIZE)
        return cls(unique + actor_id.binary())

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        return cls.of(ActorID(b"\xff" * _ACTOR_UNIQUE_SIZE + job_id.binary()))

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[_TASK_UNIQUE_SIZE:])

    def job_id(self) -> JobID:
        return self.actor_id().job_id()


class ObjectID(BaseID):
    SIZE = _OBJECT_ID_SIZE

    @classmethod
    def of(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(_OBJECT_INDEX_SIZE, "little"))

    def task_id(self) -> TaskID:
        """The task that created this object — the lineage hook."""
        return TaskID(self._bytes[:_TASK_ID_SIZE])

    def index(self) -> int:
        return int.from_bytes(self._bytes[_TASK_ID_SIZE:], "little")

    def job_id(self) -> JobID:
        return self.task_id().job_id()


class _Counter:
    """Thread-safe monotonically increasing counter (per-process)."""

    def __init__(self) -> None:
        self._value = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value

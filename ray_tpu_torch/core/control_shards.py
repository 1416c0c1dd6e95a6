"""Sharded control-plane directories (reference analog: the GCS's
independent sharded tables — `src/ray/gcs/gcs_server` table storage — which
is what lets the reference hold 40k actors / 2k nodes in one logical GCS).

The controller's hot directories (actors, workers/leases) are partitioned
by ID hash into N independent shards. Each shard owns:

  * one partition of the actor table and one of the worker/lease table
    (`ShardedDict` routes every key to exactly one shard — the partition
    function is total and disjoint, so snapshot/restore sees each entry
    exactly once), and
  * its own event loop (a thread), which is the single writer for the
    actor DELIVERY state of its actors: send queues, pumps, inflight maps.

Ownership rules (the cross-shard invariants; see
docs/SHARDED_CONTROL_PLANE.md):

  * Structural table mutations (insert/remove of entries) happen only on
    the controller's main loop — shard loops mutate fields of entries they
    own, never table membership. Main-loop iteration is therefore safe
    without locks; cross-thread readers use `snapshot_shards()` (atomic
    per-shard `dict()` copies).
  * Scheduling state (worker grants, node capacity, the object directory,
    placement groups) is main-loop-owned. Shard loops reach it only
    through the coordination layer (`call_main` / `run_on_main`).
  * Cross-shard lookups (named actors, FT snapshots, state listings) go
    through the coordination layer on the main loop.

The hash is crc32 over the ascii hex id, mod shard count — stable across
restarts and cheap enough for per-message routing. Changing the shard
count between runs is safe: restore re-inserts through the table, which
re-routes every entry by the NEW layout.
"""

from __future__ import annotations

import asyncio
import threading
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

HASH_NAME = "crc32%N"


def shard_of(hex_id: str, n: int) -> int:
    """Stable partition of an id (actor/worker hex) over n shards."""
    if n <= 1:
        return 0
    return zlib.crc32(hex_id.encode("ascii")) % n


class ControlShard:
    """One partition of the hot directories + its owning event loop.

    `threaded=False` (inline mode, used by small hosts/tests that want a
    single loop) aliases every shard loop to the controller's main loop —
    the marshaling API below is identical either way, so callers never
    branch on the mode.
    """

    def __init__(self, idx: int, threaded: bool = True):
        self.idx = idx
        self.threaded = threaded
        self.actors: Dict[str, Any] = {}
        self.workers: Dict[str, Any] = {}
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        if threaded:
            self.loop = asyncio.new_event_loop()
            self._thread = threading.Thread(
                target=self._run, name=f"ctrl-shard-{idx}", daemon=True
            )
            self._thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def attach_main_loop(self, loop: asyncio.AbstractEventLoop):
        """Inline mode: the shard executes on the controller's main loop."""
        if not self.threaded:
            self.loop = loop

    # ------------------------------------------------------------ marshaling
    # Always the *_threadsafe variants: they are correct from any thread,
    # including the owning loop's own thread (they defer to the next tick,
    # which is also what keeps FIFO order per submitting thread).
    def call_soon(self, fn: Callable, *args):
        self.loop.call_soon_threadsafe(fn, *args)

    def ensure_task(self, coro) -> None:
        """Fire-and-forget coroutine on the shard loop."""
        asyncio.run_coroutine_threadsafe(coro, self.loop)

    def run_sync(self, fn: Callable, timeout: float = 5.0):
        """Run fn() on the shard loop and wait for its result (coordination
        layer only — never from another shard's loop, which could deadlock
        a pair of shards against each other)."""
        if self.loop is None:
            return fn()
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is self.loop:
            return fn()
        done = threading.Event()
        out: List[Any] = [None, None]

        def run():
            try:
                out[0] = fn()
            except BaseException as e:  # noqa: BLE001
                out[1] = e
            done.set()

        self.loop.call_soon_threadsafe(run)
        if not done.wait(timeout):
            raise TimeoutError(f"shard {self.idx} did not answer in {timeout}s")
        if out[1] is not None:
            raise out[1]
        return out[0]

    def stop(self):
        if self._thread is not None and self.loop is not None:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout=2)


class CrossLoopEvent:
    """Duck-types the `.set()` of an asyncio.Event for waiter lists owned by
    ANOTHER loop (e.g. ObjectState.events on the main loop waking a shard
    pump): set() marshals onto the waiter's loop, where the real Event's
    waiters live."""

    __slots__ = ("loop", "ev")

    def __init__(self, loop: asyncio.AbstractEventLoop, ev: asyncio.Event):
        self.loop = loop
        self.ev = ev

    def set(self):
        try:
            self.loop.call_soon_threadsafe(self.ev.set)
        except RuntimeError:
            pass  # waiter loop already stopped (shutdown)


class ShardedDict:
    """Dict-compatible facade over N shard-owned dicts.

    Routing is by `shard_of(key)`; the underlying per-shard dicts are the
    shards' own attributes, so `ControlShard` code and this facade see the
    same storage. Structural mutation is main-loop-only by convention
    (enforced by the controller's ownership rules, not by locks)."""

    __slots__ = ("_dicts", "_shards", "n")

    def __init__(self, shards: List[ControlShard], attr: str):
        self._shards = shards
        self._dicts = [getattr(s, attr) for s in shards]
        self.n = len(shards)

    # ------------------------------------------------------------- routing
    def shard_idx(self, key: str) -> int:
        return shard_of(key, self.n)

    def shard_for(self, key: str) -> ControlShard:
        return self._shards[self.shard_idx(key)]

    # ------------------------------------------------------------- mapping
    def __getitem__(self, key: str):
        return self._dicts[shard_of(key, self.n)][key]

    def __setitem__(self, key: str, value):
        self._dicts[shard_of(key, self.n)][key] = value

    def __delitem__(self, key: str):
        del self._dicts[shard_of(key, self.n)][key]

    def __contains__(self, key: str) -> bool:
        return key in self._dicts[shard_of(key, self.n)]

    def get(self, key: str, default=None):
        return self._dicts[shard_of(key, self.n)].get(key, default)

    def pop(self, key: str, *default):
        return self._dicts[shard_of(key, self.n)].pop(key, *default)

    def setdefault(self, key: str, default):
        return self._dicts[shard_of(key, self.n)].setdefault(key, default)

    def __len__(self) -> int:
        return sum(len(d) for d in self._dicts)

    def __iter__(self) -> Iterator[str]:
        for d in self._dicts:
            yield from d

    def keys(self):
        return iter(self)

    def values(self) -> List[Any]:
        # A concatenated LIST, not a generator: hot scheduler scans iterate
        # this at C speed (a python-level yield per worker measured ~2s per
        # 1,000-actor wave); extend() never drops the GIL mid-shard.
        out: List[Any] = []
        for d in self._dicts:
            out.extend(d.values())
        return out

    def items(self) -> List[Tuple[str, Any]]:
        out: List[Tuple[str, Any]] = []
        for d in self._dicts:
            out.extend(d.items())
        return out

    def clear(self):
        for d in self._dicts:
            d.clear()

    # ---------------------------------------------------------- snapshots
    def snapshot_shards(self) -> List[Dict[str, Any]]:
        """Atomic shallow copy per shard (a plain `dict(d)` of a str-keyed
        dict never drops the GIL) — THE way to read the table from outside
        the main loop, and the unit the FT snapshot records."""
        return [dict(d) for d in self._dicts]

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for d in self.snapshot_shards():
            out.update(d)
        return out

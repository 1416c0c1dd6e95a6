"""multiprocessing.Pool API over cluster tasks.

Reference analog: `python/ray/util/multiprocessing/pool.py` — drop-in Pool
whose workers are cluster tasks instead of forked processes, so existing
`multiprocessing` code scales past one machine unchanged.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional

from ..core import api


class AsyncResult:
    def __init__(self, refs: List[Any], single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        out = api.get(self._refs, timeout=timeout)
        return out[0] if self._single else out

    def wait(self, timeout: Optional[float] = None):
        api.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        ready, _ = api.wait(self._refs, num_returns=len(self._refs), timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result not ready")
        try:
            self.get(timeout=0)
            return True
        except Exception:  # noqa: BLE001
            return False


class Pool:
    """Tasks are submitted through one shared remote function; `processes`
    bounds in-flight tasks (the cluster's CPUs bound real parallelism)."""

    def __init__(self, processes: Optional[int] = None, **_compat):
        self._processes = processes or 0
        self._closed = False

        @api.remote
        def _call(fn, args, kwargs):
            return fn(*args, **(kwargs or {}))

        self._call = _call

    # ----------------------------------------------------------- lifecycle
    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True

    def join(self):
        if not self._closed:
            raise ValueError("join() before close()")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()

    def _check(self):
        if self._closed:
            raise ValueError("Pool not running")

    # --------------------------------------------------------------- apply
    def apply(self, fn: Callable, args: tuple = (), kwds: Optional[dict] = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args: tuple = (), kwds: Optional[dict] = None):
        self._check()
        return AsyncResult([self._call.remote(fn, args, kwds)], single=True)

    # ----------------------------------------------------------------- map
    def _submit_all(self, fn: Callable, iterables) -> List[Any]:
        refs = []
        window = self._processes if self._processes > 0 else None
        in_flight: set = set()
        for args in iterables:
            if window is not None and len(in_flight) >= window:
                # Backpressure: wait only over the in-flight window (waiting
                # over the full accumulated list would re-confirm the done
                # prefix on every submission — O(n²) control traffic).
                ready, _ = api.wait(list(in_flight), num_returns=1, timeout=None)
                in_flight.difference_update(ready)
            ref = self._call.remote(fn, args, None)
            refs.append(ref)
            if window is not None:
                in_flight.add(ref)
        return refs

    def map(self, fn: Callable, iterable: Iterable[Any], chunksize: Optional[int] = None):
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn, iterable, chunksize=None):
        self._check()
        refs = self._submit_all(fn, ((x,) for x in iterable))
        return AsyncResult(refs, single=False)

    def starmap(self, fn: Callable, iterable: Iterable[tuple], chunksize=None):
        return self.starmap_async(fn, iterable, chunksize).get()

    def starmap_async(self, fn, iterable, chunksize=None):
        self._check()
        refs = self._submit_all(fn, (tuple(args) for args in iterable))
        return AsyncResult(refs, single=False)

    def imap(self, fn: Callable, iterable: Iterable[Any], chunksize: int = 1):
        self._check()
        refs = self._submit_all(fn, ((x,) for x in iterable))
        for ref in refs:
            yield api.get(ref)

    def imap_unordered(self, fn: Callable, iterable: Iterable[Any], chunksize: int = 1):
        self._check()
        pending = set(self._submit_all(fn, ((x,) for x in iterable)))
        while pending:
            ready, rest = api.wait(list(pending), num_returns=1, timeout=None)
            pending = set(rest)
            for r in ready:
                yield api.get(r)

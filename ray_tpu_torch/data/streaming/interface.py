"""Streaming-plane contracts: the pull operator interface + run statistics.

The pull protocol (docs/STREAMING_DATA.md):

  * every physical operator exposes ``next_bundle() -> Optional[RefBundle]``;
    ``None`` means exhausted, permanently;
  * an operator REFILLS its bounded in-flight window only inside
    ``next_bundle`` — it pulls upstream exactly when it has window room, so
    backpressure needs no signaling at all: a slow consumer stops pulling,
    every window upstream fills to its bound, and the source stops reading.
    Blocks resident per operator (submitted but not yet handed downstream)
    never exceed the window — and `StreamStats` MEASURES that instead of
    trusting it (peak_resident, asserted in the perf smoke).

`StreamStats` is driver-side and lock-guarded (the ingest producer thread
and the training thread both touch it). Worker-side fetch-rung deltas ride
back in descriptors / task metadata (`transport.track_fetch`) and are merged
here, so ``fetch`` is a RUN-WIDE ledger: driver + every map/reduce task.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from .. import transport


class StreamStats:
    """Per-run accounting for one PullExecutor execution."""

    def __init__(self):
        self._lock = threading.Lock()
        self.started = time.perf_counter()
        self.finished: Optional[float] = None
        # op index -> counters. "resident" = submitted - yielded: task
        # outputs this op currently holds (in flight or ready, not yet
        # pulled downstream). "wait_s" = time blocked resolving the head
        # task (upstream/compute starvation, the pull-side stall).
        self.ops: Dict[int, Dict[str, Any]] = {}
        self.fetch: Dict[str, int] = {}
        # Same ledger split by pipeline stage ("read"/"map"/"exchange_map"/
        # "exchange"): the bench isolates REDUCE-side traffic (group
        # "exchange") to assert cross-node bytes ≈ bytes consumed.
        self.fetch_groups: Dict[str, Dict[str, int]] = {}
        # Locality placement decisions (exchange reduces + affine maps):
        # node id -> tasks routed there; "none" = no affinity applied.
        self.placements: Dict[str, int] = {}
        # Output bundles handed to the consumer and not yet release()d —
        # visibility into consumer-held blocks (never blocks anything).
        self.delivered = {"resident": 0, "peak": 0, "total": 0}

    def op_entry(self, i: int, name: str, window: int) -> Dict[str, Any]:
        with self._lock:
            return self.ops.setdefault(i, {
                "name": name, "window": window, "submitted": 0, "yielded": 0,
                "rows": 0, "bytes": 0, "resident": 0, "peak_resident": 0,
                "wait_s": 0.0,
            })

    def on_submit(self, i: int) -> None:
        with self._lock:
            d = self.ops[i]
            d["submitted"] += 1
            d["resident"] += 1
            d["peak_resident"] = max(d["peak_resident"], d["resident"])

    def on_yield(self, i: int, rows: int, nbytes: int, wait_s: float) -> None:
        with self._lock:
            d = self.ops[i]
            d["yielded"] += 1
            d["rows"] += rows
            d["bytes"] += nbytes
            d["resident"] -= 1
            d["wait_s"] += wait_s

    def add_fetch(self, delta: Optional[Dict[str, int]],
                  group: Optional[str] = None) -> None:
        if not delta:
            return
        with self._lock:
            transport.merge_fetch_stats(self.fetch, delta)
            if group is not None:
                transport.merge_fetch_stats(
                    self.fetch_groups.setdefault(group, {}), delta)

    def on_placement(self, node: Optional[str]) -> None:
        with self._lock:
            key = node or "none"
            self.placements[key] = self.placements.get(key, 0) + 1

    def on_deliver(self) -> None:
        with self._lock:
            d = self.delivered
            d["total"] += 1
            d["resident"] += 1
            d["peak"] = max(d["peak"], d["resident"])

    def on_release(self) -> None:
        with self._lock:
            self.delivered["resident"] -= 1

    def done(self) -> None:
        self.finished = time.perf_counter()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "elapsed_s": (self.finished or time.perf_counter()) - self.started,
                "ops": {i: dict(d) for i, d in self.ops.items()},
                "fetch": dict(self.fetch),
                "fetch_groups": {g: dict(d)
                                 for g, d in self.fetch_groups.items()},
                "placements": dict(self.placements),
                "delivered": dict(self.delivered),
            }


class PhysicalOperator:
    """Base pull operator. Subclasses implement ``next_bundle``."""

    name = "op"

    def __init__(self, index: int, stats: StreamStats, window: int):
        self.index = index
        self.stats = stats
        self.window = max(1, int(window))
        self.lane = f"data/op{index}"
        stats.op_entry(index, self.name, self.window)

    def next_bundle(self):  # -> Optional[RefBundle]
        raise NotImplementedError

    def size_hint(self) -> Optional[int]:
        """Expected bundle count, when knowable BEFORE execution (read task
        count, materialized inputs). Lets an eager exchange fix its
        partition count without draining upstream first. None = unknown."""
        return None

"""PullExecutor — the bounded-window streaming execution plane.

Replaces the stage-barrier path of `data/executor.py` (kept there as
``execute_staged`` for A/B and as the zip/union fallback) with PULL-based
operators (reference: `data/_internal/execution/streaming_executor.py`, but
pull- instead of push-scheduled):

  * ONE-TO-ONE segments (read + fused map chains) run as
    `_WindowedTaskOp`s: at most ``window`` task outputs resident per op,
    refilled only when the downstream pulls — backpressure reaches the
    source with zero signaling (interface.py has the contract);
  * map/read outputs are arena-segment frames (`transport.put_bundle`):
    the task returns ONLY a span descriptor, chained consumers resolve it
    same-node zero-copy or via a `(name, offset, length)` bulk-span pull,
    and every resolution is rung-counted;
  * exchanges (`ExchangeOp`) keep the all-to-all barrier they inherently
    need (reduce j reads span j of EVERY map segment) but stream both
    edges: map tasks submit eagerly as upstream bundles arrive (when the
    partitioner needs no global statistics), reduce tasks yield through a
    window — and are PLACED on the node holding the largest share of their
    source bytes (locality.py, soft node affinity);
  * every op records flight spans on lane ``data/op{i}`` — ``data.wait``
    (head-of-line starvation while pulling), ``data.bundle`` (per-bundle
    yield, rows/bytes attrs), ``data.drain`` (exchange input barrier) — so
    `flight.ingest_report` can attribute where a pipeline stalls.

Run statistics (`StreamStats`) for the MOST RECENT execution in this
process are reachable via ``last_run_stats()`` — the bench and the perf
smoke assert rung traffic and bounded residency from there.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import cloudpickle

from ...core.api import get as ray_get, wait as ray_wait
from ...core.task_spec import SpreadSchedulingStrategy
from ...util import flight
from .. import transport
from ..context import DataContext
from ..plan import AllToAllOp, InputBlocksOp, LimitOp, LogicalPlan, ReadOp
from ..executor import (
    RefBundle,
    StreamingExecutor,
    _exec_chain,
    _exec_chain_segment,
    _exec_read_chain,
    _exec_read_chain_segment,
    _exchange_reduce,
    _exchange_reduce_segments,
    _partition_map,
    _partition_map_segment,
    _RandomPartition,
    _remote,
    _ShufflePost,
    read_payloads,
)
from . import locality
from .interface import PhysicalOperator, StreamStats

_LAST_STATS: Optional[StreamStats] = None


def last_run_stats() -> Optional[StreamStats]:
    """Stats of the most recent PullExecutor run in this process (the run
    may still be in progress — StreamStats is live and lock-guarded)."""
    return _LAST_STATS


def _limit_of(chain) -> Optional[int]:
    for op in chain or ():
        if isinstance(op, LimitOp):
            return op.n
    return None


class _WindowedTaskOp(PhysicalOperator):
    """Bounded-window submit/resolve engine.

    Subclasses supply tasks via ``_submit_one()`` (returns the pending
    entry, or None when the supply is exhausted). Entries are either
    ``("seg", desc_ref)`` — segment mode, the task's single return is the
    span descriptor (rows/bytes ride inside it) — or
    ``("pair", blocks_ref, meta_ref)`` — classic mode. Resolution blocks
    only on the HEAD entry and opportunistically batch-gets every other
    already-finished one in the same round trip (`_TaskStream`'s trick),
    so in-order yield costs one get per window refill, not per bundle.
    """

    def __init__(self, index: int, stats: StreamStats, window: int,
                 limit: Optional[int] = None):
        super().__init__(index, stats, window)
        self._pending: collections.deque = collections.deque()
        self._resolved: Dict[Any, Any] = {}
        self._rows_out = 0
        self._limit = limit
        self._done = False

    def _submit_one(self):
        raise NotImplementedError

    def _refill(self) -> None:
        while len(self._pending) < self.window:
            entry = self._submit_one()
            if entry is None:
                return
            self._pending.append(entry)
            self.stats.on_submit(self.index)

    def _resolve_batched(self, head_ref):
        """Value of ``head_ref``, batching in any other finished refs."""
        if head_ref not in self._resolved:
            pending = [e[-1] for e in self._pending
                       if e[0] != "ready" and e[-1] not in self._resolved]
            ready, _ = (ray_wait(pending, num_returns=len(pending), timeout=0)
                        if pending else ([], []))
            batch = [head_ref] + ready
            for ref, val in zip(batch, ray_get(batch)):
                self._resolved[ref] = val
        return self._resolved.pop(head_ref)

    def next_bundle(self) -> Optional[RefBundle]:
        if self._done:
            return None
        self._refill()
        if not self._pending:
            self._done = True
            return None
        t0 = time.monotonic_ns()
        entry = self._pending.popleft()
        if entry[0] == "seg":
            desc = self._resolve_batched(entry[1])
            self.stats.add_fetch(desc.pop("fetch", None), group=self.name)
            bundle = RefBundle(entry[1], int(desc["rows"][0]),
                               int(desc["bytes"][0]), desc=desc)
        else:
            meta = self._resolve_batched(entry[2])
            self.stats.add_fetch(meta.get("fetch"), group=self.name)
            bundle = RefBundle(entry[1], meta["num_rows"], meta["size_bytes"])
        t1 = time.monotonic_ns()
        wait_s = (t1 - t0) * 1e-9
        if wait_s > 1e-4:
            # The pull blocked: upstream/compute starvation — attributable.
            flight.record("data.wait", t0, t1, lane=self.lane)
        flight.record("data.bundle", t1, t1, lane=self.lane,
                      attrs={"rows": bundle.num_rows,
                             "bytes": bundle.size_bytes})
        self.stats.on_yield(self.index, bundle.num_rows, bundle.size_bytes,
                            wait_s)
        self._rows_out += bundle.num_rows
        if self._limit is not None and self._rows_out >= self._limit:
            self._done = True
            self._pending.clear()
            self._resolved.clear()
        return bundle


class InputOp(PhysicalOperator):
    """Pre-materialized bundles (InputBlocksOp): pure supply, no tasks."""

    name = "input"

    def __init__(self, index: int, stats: StreamStats, bundles):
        super().__init__(index, stats, window=max(1, len(bundles)))
        self._n = len(bundles)
        self._it = iter(bundles)

    def size_hint(self) -> Optional[int]:
        return self._n

    def next_bundle(self) -> Optional[RefBundle]:
        for b in self._it:
            self.stats.on_submit(self.index)
            self.stats.on_yield(self.index, b.num_rows, b.size_bytes, 0.0)
            return b
        return None


class ReadSourceOp(_WindowedTaskOp):
    """Source: read tasks with the first fused map chain baked in."""

    name = "read"

    def __init__(self, index, stats, window, ctx: DataContext,
                 src: ReadOp, chain):
        super().__init__(index, stats, window, limit=_limit_of(chain))
        payloads = list(read_payloads(ctx, src, chain))
        self._n = len(payloads)
        self._payloads = iter(payloads)
        self._segment = transport.transport_enabled()
        # Reads are the locality ROOT: every downstream placement chases the
        # node a read output landed on, so packed reads cascade the whole
        # pipeline onto one node. Spread them round-robin across the gang.
        spread = {"scheduling_strategy": SpreadSchedulingStrategy()}
        self._fn_seg = _remote(_exec_read_chain_segment).options(**spread)
        self._fn = _remote(_exec_read_chain, num_returns=2).options(**spread)

    def size_hint(self) -> Optional[int]:
        return self._n

    def _submit_one(self):
        for payload in self._payloads:
            if self._segment:
                return ("seg", self._fn_seg.remote(payload))
            blocks_ref, meta_ref = self._fn.remote(payload)
            return ("pair", blocks_ref, meta_ref)
        return None


class MapOp(_WindowedTaskOp):
    """Fused ONE-TO-ONE chain over an upstream operator. With locality
    placement on, each task softly pins to the node its input segment
    lives on — chained maps then stay with their data instead of
    re-pulling it across the wire."""

    name = "map"

    def __init__(self, index, stats, window, ctx: DataContext,
                 upstream: PhysicalOperator, chain):
        super().__init__(index, stats, window, limit=_limit_of(chain))
        self._upstream = upstream
        self._payload = cloudpickle.dumps(chain)
        self._segment = transport.transport_enabled()
        self._locality = ctx.locality_placement
        self._fn_seg = _remote(_exec_chain_segment)
        self._fn = _remote(_exec_chain, num_returns=2)

    def size_hint(self) -> Optional[int]:
        return self._upstream.size_hint()  # 1:1 over upstream bundles

    def _submit_one(self):
        b = self._upstream.next_bundle()
        if b is None:
            return None
        fn = self._fn_seg if self._segment else self._fn
        if self._locality and b.desc is not None and b.desc.get("node"):
            node = b.desc["node"]
            fn = fn.options(**locality.affinity_options(node))
            self.stats.on_placement(node)
        if self._segment:
            return ("seg", fn.remote(self._payload, b.blocks_ref))
        blocks_ref, meta_ref = fn.remote(self._payload, b.blocks_ref)
        return ("pair", blocks_ref, meta_ref)


class ExchangeOp(_WindowedTaskOp):
    """All-to-all over the pull plane. The reduce barrier is inherent
    (partition j spans every map segment), but both edges stream:

      * map tasks submit EAGERLY per arriving upstream bundle whenever the
        partitioner needs no global statistics (random_shuffle /
        shuffle-repartition with an explicit output count — the training
        ingest shape); other kinds drain first (`data.drain` span) because
        their partitioners derive from global row counts or samples;
      * reduce tasks yield through this op's window and are placed via the
        locality scorer — the descriptor values are already driver-side
        (they ARE the map results), so scoring adds one batched
        object_sources round trip, no extra data movement.
    """

    name = "exchange"

    def __init__(self, index, stats, window, ctx: DataContext,
                 op: AllToAllOp, upstream: PhysicalOperator,
                 staged: StreamingExecutor):
        super().__init__(index, stats, window)
        self._ctx = ctx
        self._op = op
        self._upstream = upstream
        self._staged = staged
        self._segment = transport.transport_enabled()
        self._started = False
        self._supply: Iterator[Callable[[], tuple]] = iter(())
        self._passthrough: collections.deque = collections.deque()

    def size_hint(self) -> Optional[int]:
        if self._op.num_outputs:
            return self._op.num_outputs
        if self._op.kind == "random_shuffle":
            return self._upstream.size_hint()  # shuffle keeps the count
        return None

    # -------------------------------------------------------------- start
    def _eager_spec(self):
        """(n, part_fn_factory, post_fn) when maps can submit before the
        input is drained — MUST mirror exchange_spec's construction. The
        partition count comes from num_outputs or the upstream's size hint
        (= what exchange_spec's len(bundles) would be), so results match
        the staged path bit for bit."""
        op = self._op
        shuffleish = (op.kind == "random_shuffle"
                      or (op.kind == "repartition" and op.shuffle))
        if not (self._segment and shuffleish):
            return None
        n = op.num_outputs or self._upstream.size_hint()
        if not n:
            return None
        seed = op.seed
        return (n,
                lambda i: _RandomPartition(n, None if seed is None else seed + i),
                _ShufflePost(seed))

    def _start(self) -> None:
        self._started = True
        op = self._op
        if op.kind in ("zip", "union"):
            bundles = self._drain_upstream()
            for b in self._staged._run_exchange(op, bundles):
                self._passthrough.append(b)
            return
        eager = self._eager_spec()
        if eager is not None:
            n, part_fn_of, post_fn = eager
            map_fn = _remote(_partition_map_segment)
            desc_refs, i = [], 0
            while True:
                b = self._upstream.next_bundle()
                if b is None:
                    break
                payload = cloudpickle.dumps((part_fn_of(i), n))
                desc_refs.append(
                    self._affine(map_fn, b).remote(payload, b.blocks_ref))
                i += 1
            if not desc_refs:
                return
            self._submit_reduces_segment(desc_refs, n, post_fn, False)
            return
        bundles = self._drain_upstream()
        if not bundles:
            return
        spec = self._staged.exchange_spec(op, bundles)
        if spec is None:  # degenerate exchange: inputs pass through
            self._passthrough.extend(bundles)
            return
        part_fns, n, post_fn, reverse = spec
        if self._segment:
            map_fn = _remote(_partition_map_segment)
            desc_refs = [
                self._affine(map_fn, b).remote(
                    cloudpickle.dumps((pf, n)), b.blocks_ref)
                for b, pf in zip(bundles, part_fns)
            ]
            self._submit_reduces_segment(desc_refs, n, post_fn, reverse)
        else:
            map_fn = _remote(_partition_map, num_returns=max(n, 1))
            part_refs = []
            for b, pf in zip(bundles, part_fns):
                refs = map_fn.remote(cloudpickle.dumps((pf, n)), b.blocks_ref)
                part_refs.append(refs if n > 1 else [refs])
            post_payload = cloudpickle.dumps(post_fn)
            reduce_fn = _remote(_exchange_reduce, num_returns=2)
            order = range(n - 1, -1, -1) if reverse else range(n)
            self._supply = iter([
                (lambda j=j: reduce_fn.remote(
                    post_payload, *[refs[j] for refs in part_refs]))
                for j in order
            ])

    def _affine(self, fn, bundle: RefBundle):
        """Exchange MAP tasks chase their input segment's node too — the
        partitioner re-reads the whole upstream bundle, so running it
        anywhere else turns every map input into cross-node traffic."""
        node = None
        if self._ctx.locality_placement and bundle.desc is not None:
            node = bundle.desc.get("node")
        self.stats.on_placement(node)
        if node:
            return fn.options(**locality.affinity_options(node))
        return fn

    def _drain_upstream(self) -> List[RefBundle]:
        t0 = time.monotonic_ns()
        bundles = []
        while True:
            b = self._upstream.next_bundle()
            if b is None:
                break
            bundles.append(b)
        t1 = time.monotonic_ns()
        flight.record("data.drain", t0, t1, lane=self.lane,
                      attrs={"bundles": len(bundles)})
        return bundles

    def _submit_reduces_segment(self, desc_refs, n, post_fn, reverse) -> None:
        post_payload = cloudpickle.dumps(post_fn)
        reduce_fn = _remote(_exchange_reduce_segments, num_returns=2)
        # Locality scoring needs the descriptor VALUES (per-partition byte
        # tables); they are the map results, so this get is the map-phase
        # barrier — small dicts, one batched round trip.
        descs = ray_get(desc_refs)
        for d in descs:
            self.stats.add_fetch(d.pop("fetch", None), group="exchange_map")
        nodes = (locality.segment_nodes(descs)
                 if self._ctx.locality_placement else [None] * len(descs))
        order = range(n - 1, -1, -1) if reverse else range(n)

        def submit(j: int):
            fn = reduce_fn
            node = (locality.best_node_for_partition(descs, j, nodes)
                    if self._ctx.locality_placement else None)
            if node is not None:
                fn = fn.options(**locality.affinity_options(node))
            self.stats.on_placement(node)
            return fn.remote(post_payload, j, *desc_refs)

        self._supply = iter([(lambda j=j: submit(j)) for j in order])

    # --------------------------------------------------------------- pull
    def _submit_one(self):
        if not self._started:
            self._start()
        if self._passthrough:
            return ("ready", self._passthrough.popleft())
        for thunk in self._supply:
            blocks_ref, meta_ref = thunk()
            return ("pair", blocks_ref, meta_ref)
        return None

    def next_bundle(self) -> Optional[RefBundle]:
        if self._done:
            return None
        self._refill()
        if self._pending and self._pending[0][0] == "ready":
            self.stats.on_yield(self.index, self._pending[0][1].num_rows,
                                self._pending[0][1].size_bytes, 0.0)
            return self._pending.popleft()[1]
        return super().next_bundle() if self._pending else self._finish()

    def _finish(self):
        self._done = True
        return None


# ------------------------------------------------------------ the executor
class PullExecutor:
    def __init__(self, ctx: Optional[DataContext] = None):
        self._ctx = ctx or DataContext.get_current()
        self.stats = StreamStats()

    def execute(self, plan: LogicalPlan) -> Iterator[RefBundle]:
        global _LAST_STATS
        _LAST_STATS = self.stats
        ctx = self._ctx
        window = ctx.streaming_window_blocks
        staged = StreamingExecutor(ctx)
        op: Optional[PhysicalOperator] = None
        idx = 0
        for src, chain in plan.segments():
            if isinstance(src, ReadOp):
                op = ReadSourceOp(idx, self.stats, window, ctx, src, chain)
                idx += 1
                continue  # chain is fused into the read tasks
            if isinstance(src, InputBlocksOp):
                op = InputOp(idx, self.stats, src.bundles)
                idx += 1
            elif isinstance(src, AllToAllOp):
                op = ExchangeOp(idx, self.stats, window, ctx, src, op, staged)
                idx += 1
            else:
                raise TypeError(f"Unknown segment source {src}")
            if chain:
                op = MapOp(idx, self.stats, window, ctx, op, chain)
                idx += 1
        return self._drive(op)

    def _drive(self, op: Optional[PhysicalOperator]) -> Iterator[RefBundle]:
        if op is None:
            self.stats.done()
            return
        try:
            while True:
                bundle = op.next_bundle()
                if bundle is None:
                    break
                bundle._on_release = self._released
                self.stats.on_deliver()
                yield bundle
        finally:
            self.stats.done()

    def _released(self, _bundle) -> None:
        self.stats.on_release()

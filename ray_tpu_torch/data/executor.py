"""Streaming executor (reference: `data/_internal/execution/streaming_executor.py`).

Pull-based: bundles of blocks stream through fused task chains with a
bounded number of in-flight tasks (backpressure — reference
`backpressure_policy/`). All-to-all ops run as a two-stage map/reduce
exchange — the shape of the reference's push-based shuffle
(`push_based_shuffle.py`). By default (`data_block_transport`) the
exchange's intermediate partitions ride the BLOCK TRANSPORT
(`transport.py`): each map task lands ALL its partitions as one flat arena
segment and returns only a span descriptor; reduce tasks read their
partition zero-copy from the local store or pull just its byte span over
the bulk plane. The classic form (map `num_returns=P`, one pickled object
put per partition) remains behind the flag and as the universal fallback.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import cloudpickle
import numpy as np

from ..core.api import get as ray_get, put as ray_put, wait as ray_wait
from ..core.remote_function import RemoteFunction
from ..core.task_spec import TaskOptions
from . import transport
from .block import Block, BlockAccessor, concat_blocks, is_columnar
from .context import DataContext
from .plan import (
    AllToAllOp,
    InputBlocksOp,
    LimitOp,
    LogicalPlan,
    OneToOneOp,
    ReadOp,
    apply_chain,
)


class RefBundle:
    """A task's output: ref to a list of blocks + row/byte metadata.

    In the streaming plane (data/streaming/) a map/read output is an
    arena-segment frame and ``blocks_ref`` points at its span DESCRIPTOR
    (transport.put_bundle); the resolved descriptor rides along in ``desc``
    so driver-side consumers skip the extra get. ``release()`` tells the
    producing op's stats the consumer is done with the blocks — that is the
    measurement behind the bounded-residency proof, never a correctness
    requirement (windows refill on pull, not on release)."""

    __slots__ = ("blocks_ref", "num_rows", "size_bytes", "desc", "_on_release")

    def __init__(self, blocks_ref, num_rows: int, size_bytes: int,
                 desc: Optional[dict] = None, on_release=None):
        self.blocks_ref = blocks_ref
        self.num_rows = num_rows
        self.size_bytes = size_bytes
        self.desc = desc
        self._on_release = on_release

    def blocks(self) -> List[Block]:
        """Materialize this bundle's blocks on the calling process, through
        the transport rung ladder when the bundle is descriptor-backed."""
        if self.desc is not None:
            return transport.fetch_bundle(self.desc)
        return transport.resolve_blocks(ray_get(self.blocks_ref))

    def release(self) -> None:
        cb, self._on_release = self._on_release, None
        if cb is not None:
            cb(self)

    def __getstate__(self):
        # The release hook is a driver-side residency-measurement callback
        # closing over lock-guarded StreamStats — unpicklable and
        # meaningless in another process (train shards ship cached bundles
        # to gang workers via cloudpickle).
        return (self.blocks_ref, self.num_rows, self.size_bytes, self.desc)

    def __setstate__(self, state):
        self.blocks_ref, self.num_rows, self.size_bytes, self.desc = state
        self._on_release = None


# --------------------------------------------------------- remote kernels
def _meta_of(blocks: List[Block]) -> dict:
    rows = sum(BlockAccessor(b).num_rows() for b in blocks)
    size = sum(BlockAccessor(b).size_bytes() for b in blocks)
    return {"num_rows": rows, "size_bytes": size}


def _exec_read_chain(payload: bytes):
    """Run a ReadTask then the fused chain; returns (blocks, meta)."""
    read_task, chain = cloudpickle.loads(payload)
    blocks = list(read_task())
    blocks = apply_chain(chain, blocks)
    return blocks, _meta_of(blocks)


def _exec_chain(payload: bytes, blocks: List[Block]):
    chain = cloudpickle.loads(payload)
    out = apply_chain(chain, transport.resolve_blocks(blocks))
    return out, _meta_of(out)


def _fetch_delta(f: dict) -> dict:
    """Nonzero rung counters only — small enough to ride in task metadata."""
    return {k: v for k, v in f.items() if v}


def _exec_read_chain_segment(payload: bytes):
    """ONE-TO-ONE streaming form of _exec_read_chain: the output blocks land
    as a single arena-segment frame; the return value is only the small span
    descriptor (transport.put_bundle) — rows/bytes ride inside it, so the
    task has ONE return and the driver's window resolves one ref per bundle."""
    read_task, chain = cloudpickle.loads(payload)
    blocks = apply_chain(chain, list(read_task()))
    return transport.put_bundle(blocks)


def _exec_chain_segment(payload: bytes, blocks):
    """ONE-TO-ONE streaming map: input may itself be a bundle descriptor
    (resolved through the rung ladder — same-node zero-copy or a bulk span
    pull), output lands as a fresh segment. The rung delta of the input
    fetch travels back in the descriptor so driver-side stream stats see
    worker-side fetch behavior."""
    with transport.track_fetch() as f:
        blocks = transport.resolve_blocks(blocks)
    out = apply_chain(cloudpickle.loads(payload), blocks)
    desc = transport.put_bundle(out)
    desc["fetch"] = _fetch_delta(f)
    return desc


def _build_partitions(payload: bytes, blocks: List[Block]) -> List[List[Block]]:
    """Shared map-side partitioning: concat the input, run the partition
    functor, drop empty pieces. Both exchange wire strategies (classic
    per-partition puts and the block transport) shape THIS result."""
    part_fn, num_parts = cloudpickle.loads(payload)
    parts: List[List[Block]] = [[] for _ in range(num_parts)]
    block = concat_blocks(transport.resolve_blocks(blocks))
    for idx, piece in part_fn(block):
        if BlockAccessor(piece).num_rows() > 0:
            parts[idx].append(piece)
    return parts


def _partition_map(payload: bytes, blocks: List[Block]):
    """Map side of an exchange: returns P lists of blocks (one per partition)."""
    parts = _build_partitions(payload, blocks)
    return tuple(parts) if len(parts) > 1 else parts[0]


def _reduce_post(payload: bytes, blocks: List[Block]):
    """Shared reduce tail: concat this partition's blocks, post-process,
    drop empties, return (blocks, meta) — both wire strategies end here."""
    post_fn = cloudpickle.loads(payload)
    merged = concat_blocks(blocks) if blocks else {}
    out = post_fn(merged)
    out_blocks = out if isinstance(out, list) else [out]
    out_blocks = [b for b in out_blocks if BlockAccessor(b).num_rows() > 0]
    return out_blocks, _meta_of(out_blocks)


def _exchange_reduce(payload: bytes, *parts):
    """Reduce side: concat this partition's parts, post-process, return bundle."""
    blocks: List[Block] = []
    for p in parts:
        blocks.extend(p)
    return _reduce_post(payload, blocks)


def _partition_map_segment(payload: bytes, blocks: List[Block]):
    """Map side of an exchange over the BLOCK TRANSPORT: all P partitions
    land as one flat arena segment; the return value is only the small span
    descriptor (transport.put_partitions)."""
    with transport.track_fetch() as f:
        parts = _build_partitions(payload, blocks)
    desc = transport.put_partitions(parts)
    desc["fetch"] = _fetch_delta(f)
    return desc


def _exchange_reduce_segments(payload: bytes, j: int, *descs):
    """Reduce side over the block transport: fetch ONLY partition j's span
    from each map segment (cross-machine: a (name, offset, length) bulk-plane
    read; same host: zero-copy borrow), then post-process as usual. The
    fetch's rung delta ships in the metadata — the driver's run stats can
    then assert reduce-side traffic took the rungs it should have."""
    blocks: List[Block] = []
    with transport.track_fetch() as f:
        for part in transport.fetch_partitions(list(descs), j):
            blocks.extend(part)
    out_blocks, meta = _reduce_post(payload, blocks)
    meta["fetch"] = _fetch_delta(f)
    return out_blocks, meta


def _sample_rows(blocks: List[Block], key, k: int):
    block = concat_blocks(transport.resolve_blocks(blocks))
    acc = BlockAccessor(block)
    n = acc.num_rows()
    if n == 0:
        return np.asarray([])
    idx = np.linspace(0, n - 1, min(k, n)).astype(np.int64)
    col = key if isinstance(key, str) else key[0]
    return np.asarray(block[col])[idx]


def _zip_blocks(left: List[Block], right: List[Block]):
    lb = concat_blocks(transport.resolve_blocks(left))
    rb = concat_blocks(transport.resolve_blocks(right))
    if BlockAccessor(lb).num_rows() != BlockAccessor(rb).num_rows():
        raise ValueError("zip requires datasets with identical row counts")
    out = dict(lb)
    for k, v in rb.items():
        name = k
        while name in out:
            name = name + "_1"
        out[name] = v
    return [out], _meta_of([out])


def _remote(fn: Callable, num_returns: int = 1) -> RemoteFunction:
    return RemoteFunction(fn, TaskOptions(num_cpus=1.0, num_returns=num_returns))


def read_payloads(ctx: DataContext, src: ReadOp, chain) -> List[bytes]:
    """Task payloads for a read segment (ReadTask + fused chain each) —
    shared by both executors so parallelism estimation cannot drift."""
    parallelism = src.parallelism
    if parallelism is None or parallelism < 0:
        est = src.datasource.estimate_inmemory_data_size()
        if est:
            parallelism = max(ctx.read_op_min_num_blocks,
                              est // ctx.target_max_block_size)
        else:
            parallelism = ctx.read_op_min_num_blocks
    read_tasks = src.datasource.get_read_tasks(int(parallelism))
    return [cloudpickle.dumps((rt, chain)) for rt in read_tasks]


# ------------------------------------------------------------- the executor
class StreamingExecutor:
    def __init__(self, ctx: Optional[DataContext] = None):
        self._ctx = ctx or DataContext.get_current()

    # ------------------------------------------------------------ streaming
    def execute(self, plan: LogicalPlan) -> Iterator[RefBundle]:
        """Yield output bundles, streaming wherever the plan allows.

        Default route is the bounded-window PULL plane (data/streaming/):
        per-operator in-flight windows, segment-framed ONE-TO-ONE outputs,
        locality-placed reduces. `ctx.streaming_pull=False` keeps the legacy
        stage-barrier path below (A/B baseline; also what zip/union still
        use internally)."""
        if self._ctx.streaming_pull:
            from .streaming.executor import PullExecutor

            return PullExecutor(self._ctx).execute(plan)
        return self.execute_staged(plan)

    def execute_staged(self, plan: LogicalPlan) -> Iterator[RefBundle]:
        segments = plan.segments()
        stream: Iterator[RefBundle] = iter(())
        for i, (src, chain) in enumerate(segments):
            if isinstance(src, ReadOp):
                stream = self._run_read_segment(src, chain)
            elif isinstance(src, InputBlocksOp):
                stream = self._run_ref_segment(iter(src.bundles), chain)
            elif isinstance(src, AllToAllOp):
                bundles = list(stream)
                bundles = self._run_exchange(src, bundles)
                stream = self._run_ref_segment(iter(bundles), chain)
            else:
                raise TypeError(f"Unknown segment source {src}")
        return stream

    def execute_to_bundles(self, plan: LogicalPlan) -> List[RefBundle]:
        return list(self.execute(plan))

    # ----------------------------------------------------------- segments
    def _limit_of(self, chain: List[OneToOneOp]) -> Optional[int]:
        for op in chain:
            if isinstance(op, LimitOp):
                return op.n
        return None

    def _run_read_segment(self, src: ReadOp, chain) -> Iterator[RefBundle]:
        payloads = read_payloads(self._ctx, src, chain)
        fn = _remote(_exec_read_chain, num_returns=2)
        yield from self._stream_tasks(
            (lambda p=p: fn.remote(p)) for p in payloads
        ).with_limit(self._limit_of(chain))

    def _run_ref_segment(self, bundles: Iterator[RefBundle], chain) -> Iterator[RefBundle]:
        if not chain:
            yield from bundles
            return
        payload = cloudpickle.dumps(chain)
        fn = _remote(_exec_chain, num_returns=2)
        yield from self._stream_tasks(
            (lambda b=b: fn.remote(payload, b.blocks_ref)) for b in bundles
        ).with_limit(self._limit_of(chain))

    def _stream_tasks(self, submitters) -> "_TaskStream":
        return _TaskStream(submitters, self._ctx.max_in_flight_tasks)

    # ----------------------------------------------------------- exchanges
    def _run_exchange(self, op: AllToAllOp, bundles: List[RefBundle]) -> List[RefBundle]:
        kind = op.kind
        if kind == "union":
            out = list(bundles)
            for other in op.other_plans:
                out.extend(self.execute_to_bundles(other))
            return out
        if kind == "zip":
            return self._exchange_zip(op, bundles)
        if not bundles:
            return []
        spec = self.exchange_spec(op, bundles)
        if spec is None:
            return bundles  # degenerate exchange (e.g. sort of all-empty)
        part_fns, num_parts, post_fn, reverse = spec
        out = self._map_reduce(bundles, part_fns, num_parts, post_fn)
        return out[::-1] if reverse else out

    def exchange_spec(
        self, op: AllToAllOp, bundles: List[RefBundle]
    ) -> Optional[Tuple[List[Callable], int, Callable, bool]]:
        """(per-input partition fns, partition count, reduce post fn, reverse
        output order) for the map/reduce exchange kinds — the ONE definition
        both wire paths and both executors (staged barrier here, streaming
        pull in data/streaming/) shape their exchanges from. None means the
        exchange degenerates to a passthrough. zip/union are not map/reduce
        shaped and stay in _run_exchange."""
        kind = op.kind
        if kind == "repartition" and not op.shuffle:
            n = op.num_outputs
            total = sum(b.num_rows for b in bundles)
            bounds = [round(total * (i + 1) / n) for i in range(n)]
            part_fns, offset = [], 0
            for b in bundles:
                part_fns.append(_EvenPartition(offset, offset + b.num_rows, bounds))
                offset += b.num_rows
            return part_fns, n, _identity_post, False
        if kind == "random_shuffle" or (kind == "repartition" and op.shuffle):
            n = op.num_outputs or len(bundles)
            seed = op.seed
            part_fns = [
                _RandomPartition(n, None if seed is None else seed + i)
                for i in range(len(bundles))
            ]
            return part_fns, n, _ShufflePost(seed), False
        if kind == "sort":
            key, desc = op.key, op.descending
            n = len(bundles)
            sample_fn = _remote(_sample_rows)
            samples = ray_get(
                [sample_fn.remote(b.blocks_ref, key, 16) for b in bundles]
            )
            allsamp = np.sort(np.concatenate([s for s in samples if len(s)]))
            if len(allsamp) == 0:
                return None
            qs = np.linspace(0, len(allsamp) - 1, n + 1).astype(np.int64)[1:-1]
            boundaries = allsamp[qs]
            part_fns = [_RangePartition(key, boundaries) for _ in bundles]
            return part_fns, n, _SortPost(key, desc), bool(desc)
        if kind == "groupby":
            key, aggs = op.key, op.aggs
            n = min(len(bundles), max(1, self._ctx.max_in_flight_tasks))
            part_fns = [_HashPartition(key, n) for _ in bundles]
            return part_fns, n, _GroupByPost(key, aggs), False
        raise ValueError(f"Unknown all-to-all kind {kind}")

    def _map_reduce(
        self,
        bundles: List[RefBundle],
        part_fns: List[Callable],
        num_parts: int,
        post_fn: Callable,
    ) -> List[RefBundle]:
        """Generic exchange: per-input partition map → per-output reduce.

        Two wire strategies for the intermediate partitions:
          * block transport (default, `data_block_transport`): each map task
            emits ONE flat arena segment + span descriptor; reduce task j
            pulls only partition j's byte span over the bulk plane (zero-copy
            borrow on the same host) — data/transport.py;
          * classic: `num_returns=P` map tasks, each partition its own
            pickled object put (P×N objects; kept for A/B measurement and as
            the shape the transport descriptor degrades to).
        """
        post_payload = cloudpickle.dumps(post_fn)
        if transport.transport_enabled():
            map_fn = _remote(_partition_map_segment)
            desc_refs = []
            for b, pf in zip(bundles, part_fns):
                payload = cloudpickle.dumps((pf, num_parts))
                desc_refs.append(map_fn.remote(payload, b.blocks_ref))
            reduce_fn = _remote(_exchange_reduce_segments, num_returns=2)
            out = [
                reduce_fn.remote(post_payload, j, *desc_refs)
                for j in range(num_parts)
            ]
        else:
            map_fn = _remote(_partition_map, num_returns=max(num_parts, 1))
            part_refs: List[List[Any]] = []
            for b, pf in zip(bundles, part_fns):
                payload = cloudpickle.dumps((pf, num_parts))
                refs = map_fn.remote(payload, b.blocks_ref)
                part_refs.append(refs if num_parts > 1 else [refs])
            reduce_fn = _remote(_exchange_reduce, num_returns=2)
            out = [
                reduce_fn.remote(post_payload, *[refs[j] for refs in part_refs])
                for j in range(num_parts)
            ]
        # One batched get for every reduce task's metadata (these used to be
        # fetched one blocking round trip at a time).
        metas = ray_get([meta_ref for _, meta_ref in out])
        return [
            RefBundle(blocks_ref, meta["num_rows"], meta["size_bytes"])
            for (blocks_ref, _), meta in zip(out, metas)
        ]

    def _exchange_zip(self, op, bundles) -> List[RefBundle]:
        right = self.execute_to_bundles(op.other_plans[0])
        left_rows = [b.num_rows for b in bundles]
        total_r = sum(b.num_rows for b in right)
        if sum(left_rows) != total_r:
            raise ValueError("zip requires datasets with identical row counts")
        # Repartition right to match left's block boundaries, then zip pairwise.
        bounds = list(np.cumsum(left_rows))
        part_fns, offset = [], 0
        for b in right:
            part_fns.append(_EvenPartition(offset, offset + b.num_rows, bounds))
            offset += b.num_rows
        right_re = self._map_reduce(right, part_fns, len(bundles), _identity_post)
        zip_fn = _remote(_zip_blocks, num_returns=2)
        refs = [
            zip_fn.remote(lb.blocks_ref, rb.blocks_ref)
            for lb, rb in zip(bundles, right_re)
        ]
        # Batched metadata resolve: one get for the whole zip stage.
        metas = ray_get([meta_ref for _, meta_ref in refs])
        return [
            RefBundle(blocks_ref, meta["num_rows"], meta["size_bytes"])
            for (blocks_ref, _), meta in zip(refs, metas)
        ]


# ------------------------------------------------- partition/post functors
# (classes, not closures, so cloudpickle payloads stay small and stable)
class _EvenPartition:
    def __init__(self, lo: int, hi: int, bounds: List[int]):
        self.lo, self.hi, self.bounds = lo, hi, bounds

    def __call__(self, block: Block):
        acc = BlockAccessor(block)
        for j, bound in enumerate(self.bounds):
            prev = self.bounds[j - 1] if j > 0 else 0
            start = max(self.lo, prev)
            end = min(self.hi, bound)
            if end > start:
                yield j, acc.slice(start - self.lo, end - self.lo)


class _RandomPartition:
    def __init__(self, n: int, seed: Optional[int]):
        self.n, self.seed = n, seed

    def __call__(self, block: Block):
        acc = BlockAccessor(block)
        rng = np.random.default_rng(self.seed)
        assign = rng.integers(0, self.n, acc.num_rows())
        for j in range(self.n):
            idx = np.nonzero(assign == j)[0]
            if len(idx):
                yield j, acc.take(idx)


class _RangePartition:
    def __init__(self, key, boundaries):
        self.key, self.boundaries = key, boundaries

    def __call__(self, block: Block):
        acc = BlockAccessor(block)
        col = block[self.key if isinstance(self.key, str) else self.key[0]]
        assign = np.searchsorted(self.boundaries, col, side="right")
        for j in np.unique(assign):
            idx = np.nonzero(assign == j)[0]
            yield int(j), acc.take(idx)


def _stable_hash(x) -> int:
    """Process-independent hash (builtin `hash` varies with PYTHONHASHSEED)."""
    import zlib

    if isinstance(x, (int, np.integer)):
        return int(x)
    return zlib.crc32(repr(x).encode())


class _HashPartition:
    def __init__(self, key, n: int):
        self.key, self.n = key, n

    def __call__(self, block: Block):
        acc = BlockAccessor(block)
        col = block[self.key if isinstance(self.key, str) else self.key[0]]
        hashes = np.asarray([_stable_hash(x) % self.n for x in col.tolist()])
        for j in np.unique(hashes):
            idx = np.nonzero(hashes == j)[0]
            yield int(j), acc.take(idx)


def _identity_post(block: Block):
    return block


class _ShufflePost:
    def __init__(self, seed):
        self.seed = seed

    def __call__(self, block: Block):
        acc = BlockAccessor(block)
        rng = np.random.default_rng(self.seed)
        return acc.take(rng.permutation(acc.num_rows()))


class _SortPost:
    def __init__(self, key, descending):
        self.key, self.descending = key, descending

    def __call__(self, block: Block):
        acc = BlockAccessor(block)
        if acc.num_rows() == 0:
            return block
        return acc.take(acc.sort_indices(self.key, self.descending))


class _GroupByPost:
    def __init__(self, key, aggs):
        self.key, self.aggs = key, aggs

    def __call__(self, block: Block):
        if not block or BlockAccessor(block).num_rows() == 0:
            return block
        from .grouped import _MapGroupsMarker

        keycol = self.key if isinstance(self.key, str) else self.key[0]
        if len(self.aggs) == 1 and isinstance(self.aggs[0], _MapGroupsMarker):
            return self._map_groups(block, keycol, self.aggs[0])
        col = block[keycol]
        order = np.argsort(col, kind="stable")
        col = col[order]
        uniq, starts = np.unique(col, return_index=True)
        bounds = list(starts[1:]) + [len(col)]
        out: Dict[str, list] = {keycol: list(uniq)}
        for agg in self.aggs:
            out[agg.output_name()] = []
        for gi in range(len(uniq)):
            lo, hi = starts[gi], bounds[gi]
            idx = order[lo:hi]
            for agg in self.aggs:
                out[agg.output_name()].append(agg.compute(block, idx))
        return {k: np.asarray(v) for k, v in out.items()}

    def _map_groups(self, block: Block, keycol: str, marker) -> List[Block]:
        from .block import build_block

        acc = BlockAccessor(block)
        col = block[keycol]
        order = np.argsort(col, kind="stable")
        sorted_col = col[order]
        uniq, starts = np.unique(sorted_col, return_index=True)
        bounds = list(starts[1:]) + [len(sorted_col)]
        out_blocks: List[Block] = []
        for gi in range(len(uniq)):
            idx = order[starts[gi] : bounds[gi]]
            group = acc.take(idx)
            res = marker.fn(BlockAccessor(group).to_batch(marker.batch_format))
            out_blocks.append(build_block(res))
        return out_blocks


# ------------------------------------------------------------- task stream
class _TaskStream:
    """Bounded-in-flight submission with in-order yielding + early stop."""

    def __init__(self, submitters, max_in_flight: int):
        self._submitters = iter(submitters)
        self._max = max_in_flight
        self._limit: Optional[int] = None

    def with_limit(self, n: Optional[int]) -> "_TaskStream":
        self._limit = n
        return self

    def __iter__(self) -> Iterator[RefBundle]:
        in_flight: collections.deque = collections.deque()
        metas: Dict[Any, dict] = {}  # meta_ref -> resolved meta
        produced = 0
        exhausted = False
        while True:
            while not exhausted and len(in_flight) < self._max:
                try:
                    submit = next(self._submitters)
                except StopIteration:
                    exhausted = True
                    break
                in_flight.append(submit())
            if not in_flight:
                return
            blocks_ref, meta_ref = in_flight.popleft()
            if meta_ref not in metas:
                # Batched metadata resolve: block on the HEAD's meta but
                # opportunistically fetch every other already-completed
                # in-flight meta in the SAME get — streaming order and
                # backpressure are unchanged, round trips collapse from one
                # per bundle to one per window refill.
                pending = [m for _, m in in_flight if m not in metas]
                ready, _ = ray_wait(pending, num_returns=len(pending),
                                    timeout=0) if pending else ([], [])
                batch = [meta_ref] + ready
                for ref, meta in zip(batch, ray_get(batch)):
                    metas[ref] = meta
            meta = metas.pop(meta_ref)
            bundle = RefBundle(blocks_ref, meta["num_rows"], meta["size_bytes"])
            yield bundle
            produced += bundle.num_rows
            if self._limit is not None and produced >= self._limit:
                return

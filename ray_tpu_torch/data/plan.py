"""Logical plan: one-to-one transforms + all-to-all boundaries.

Reference: `python/ray/data/_internal/logical/` (logical operators) and
`_internal/planner/` (fusion). Consecutive one-to-one ops are fused into a
single *chain* executed inside one remote task per block — the reference
does the same fusion (`TaskPoolMapOperator` fusion rules) so a
read→map→filter pipeline costs one task per block, not three.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from .block import (
    Block,
    BlockAccessor,
    build_block,
    concat_blocks,
    is_columnar,
    rows_to_block,
)


class Op:
    """Base logical operator."""

    name = "Op"


# ------------------------------------------------------------- one-to-one
class OneToOneOp(Op):
    """Transforms a stream of blocks within one task (fusable)."""

    def apply(self, blocks: List[Block]) -> List[Block]:
        raise NotImplementedError


@dataclass
class MapBatches(OneToOneOp):
    fn: Callable
    batch_size: Optional[int] = None
    batch_format: Optional[str] = "default"
    fn_args: tuple = ()
    fn_kwargs: dict = field(default_factory=dict)
    fn_constructor_args: tuple = ()
    is_callable_class: bool = False
    name = "MapBatches"

    def _callable(self):
        if self.is_callable_class:
            fn = self.fn(*self.fn_constructor_args)
        else:
            fn = self.fn
        return fn

    def apply(self, blocks: List[Block]) -> List[Block]:
        fn = self._callable()
        out: List[Block] = []
        for batch in _rebatch(blocks, self.batch_size):
            acc = BlockAccessor(batch)
            res = fn(acc.to_batch(self.batch_format), *self.fn_args, **self.fn_kwargs)
            out.append(build_block(res))
        return out


def _rebatch(blocks: List[Block], batch_size: Optional[int]):
    """Yield batches of exactly `batch_size` rows (last may be short)."""
    if batch_size is None:
        for b in blocks:
            if BlockAccessor(b).num_rows() > 0:
                yield b
        return
    buf: List[Block] = []
    buffered = 0
    for b in blocks:
        acc = BlockAccessor(b)
        n = acc.num_rows()
        start = 0
        while start < n:
            take = min(batch_size - buffered, n - start)
            buf.append(acc.slice(start, start + take))
            buffered += take
            start += take
            if buffered == batch_size:
                yield concat_blocks(buf)
                buf, buffered = [], 0
    if buffered:
        yield concat_blocks(buf)


@dataclass
class MapRows(OneToOneOp):
    fn: Callable
    name = "Map"

    def apply(self, blocks):
        out = []
        for b in blocks:
            rows = [self.fn(r) for r in BlockAccessor(b).iter_rows()]
            if rows and all(isinstance(r, dict) for r in rows):
                out.append(rows_to_block(rows))
            else:
                out.append(list(rows))
        return out


@dataclass
class FlatMap(OneToOneOp):
    fn: Callable
    name = "FlatMap"

    def apply(self, blocks):
        out = []
        for b in blocks:
            rows: List[Any] = []
            for r in BlockAccessor(b).iter_rows():
                rows.extend(self.fn(r))
            if rows and all(isinstance(r, dict) for r in rows):
                out.append(rows_to_block(rows))
            elif rows:
                out.append(list(rows))
        return out


@dataclass
class Filter(OneToOneOp):
    fn: Callable
    name = "Filter"

    def apply(self, blocks):
        out = []
        for b in blocks:
            acc = BlockAccessor(b)
            if is_columnar(b):
                mask = np.asarray([bool(self.fn(r)) for r in acc.iter_rows()])
                if mask.any():
                    out.append(acc.take(np.nonzero(mask)[0]))
            else:
                kept = [r for r in b if self.fn(r)]
                if kept:
                    out.append(kept)
        return out


@dataclass
class LimitOp(OneToOneOp):
    n: int
    name = "Limit"

    def apply(self, blocks):
        out, remaining = [], self.n
        for b in blocks:
            if remaining <= 0:
                break
            acc = BlockAccessor(b)
            take = min(acc.num_rows(), remaining)
            out.append(acc.slice(0, take))
            remaining -= take
        return out


@dataclass
class SelectColumns(OneToOneOp):
    cols: List[str]
    name = "SelectColumns"

    def apply(self, blocks):
        return [{k: b[k] for k in self.cols} for b in blocks]


@dataclass
class DropColumns(OneToOneOp):
    cols: List[str]
    name = "DropColumns"

    def apply(self, blocks):
        return [{k: v for k, v in b.items() if k not in self.cols} for b in blocks]


@dataclass
class AddColumn(OneToOneOp):
    col: str
    fn: Callable  # batch(dict) -> np.ndarray
    name = "AddColumn"

    def apply(self, blocks):
        out = []
        for b in blocks:
            b = dict(b)
            b[self.col] = np.asarray(self.fn(b))
            out.append(b)
        return out


@dataclass
class RenameColumns(OneToOneOp):
    mapping: Dict[str, str]
    name = "RenameColumns"

    def apply(self, blocks):
        return [{self.mapping.get(k, k): v for k, v in b.items()} for b in blocks]


# ------------------------------------------------------------- all-to-all
@dataclass
class AllToAllOp(Op):
    """Materialization boundary handled by the executor's exchange."""

    kind: str  # repartition | random_shuffle | sort | groupby | zip | union
    num_outputs: Optional[int] = None
    key: Union[None, str, List[str]] = None
    descending: bool = False
    seed: Optional[int] = None
    aggs: Optional[List[Any]] = None
    other_plans: Optional[List[Any]] = None  # for zip/union
    shuffle: bool = False
    name = "AllToAll"


@dataclass
class ReadOp(Op):
    datasource: Any
    parallelism: int = -1
    name = "Read"


@dataclass
class InputBlocksOp(Op):
    """Plan rooted at pre-existing block refs (post-exchange or materialized)."""

    bundles: List[Any]  # List[RefBundle]
    name = "InputBlocks"


class LogicalPlan:
    def __init__(self, ops: List[Op]):
        self.ops = ops

    def with_op(self, op: Op) -> "LogicalPlan":
        return LogicalPlan(self.ops + [op])

    def segments(self) -> List[Tuple[Op, List[OneToOneOp]]]:
        """Split into (source-or-exchange, fused one-to-one chain) segments."""
        assert self.ops and isinstance(self.ops[0], (ReadOp, InputBlocksOp))
        segs: List[Tuple[Op, List[OneToOneOp]]] = []
        current_src: Op = self.ops[0]
        chain: List[OneToOneOp] = []
        for op in self.ops[1:]:
            if isinstance(op, OneToOneOp):
                chain.append(op)
            else:
                segs.append((current_src, chain))
                current_src, chain = op, []
        segs.append((current_src, chain))
        return segs


def apply_chain(chain: List[OneToOneOp], blocks: List[Block]) -> List[Block]:
    for op in chain:
        blocks = op.apply(blocks)
    return blocks

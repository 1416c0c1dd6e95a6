"""The lazy Dataset API (reference: `python/ray/data/dataset.py`).

A Dataset is an immutable logical plan; execution is streamed through the
`StreamingExecutor` on iteration/consumption, or pinned by `materialize()`.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from .block import Block, BlockAccessor, concat_blocks
from .context import DataContext
from .executor import RefBundle, StreamingExecutor, _meta_of
from .grouped import GroupedData
from .iterator import DataIterator
from .plan import (
    AddColumn,
    AllToAllOp,
    DropColumns,
    Filter,
    FlatMap,
    InputBlocksOp,
    LimitOp,
    LogicalPlan,
    MapBatches,
    MapRows,
    ReadOp,
    RenameColumns,
    SelectColumns,
)


class Dataset:
    def __init__(self, plan: LogicalPlan):
        self._plan = plan
        self._cached_bundles: Optional[List[RefBundle]] = None

    # ----------------------------------------------------------- plumbing
    def _with_op(self, op) -> "Dataset":
        return Dataset(self._plan.with_op(op))

    def _executor(self) -> StreamingExecutor:
        return StreamingExecutor(DataContext.get_current())

    def _stream(self) -> Iterator[RefBundle]:
        if self._cached_bundles is not None:
            return iter(self._cached_bundles)
        return self._executor().execute(self._plan)

    # ------------------------------------------------------------- one-to-one
    def map_batches(
        self,
        fn: Callable,
        *,
        batch_size: Optional[int] = None,
        batch_format: Optional[str] = "default",
        compute=None,
        fn_args: tuple = (),
        fn_kwargs: Optional[dict] = None,
        fn_constructor_args: tuple = (),
        **_resources,
    ) -> "Dataset":
        is_class = isinstance(fn, type)
        return self._with_op(
            MapBatches(
                fn,
                batch_size=batch_size,
                batch_format=batch_format,
                fn_args=fn_args,
                fn_kwargs=fn_kwargs or {},
                fn_constructor_args=fn_constructor_args,
                is_callable_class=is_class,
            )
        )

    def map(self, fn: Callable) -> "Dataset":
        return self._with_op(MapRows(fn))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._with_op(FlatMap(fn))

    def filter(self, fn: Callable) -> "Dataset":
        return self._with_op(Filter(fn))

    def limit(self, n: int) -> "Dataset":
        return self._with_op(LimitOp(n))

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self._with_op(SelectColumns(list(cols)))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self._with_op(DropColumns(list(cols)))

    def add_column(self, col: str, fn: Callable) -> "Dataset":
        return self._with_op(AddColumn(col, fn))

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        return self._with_op(RenameColumns(dict(mapping)))

    # ------------------------------------------------------------ all-to-all
    def repartition(self, num_blocks: int, *, shuffle: bool = False) -> "Dataset":
        return self._with_op(AllToAllOp(kind="repartition", num_outputs=num_blocks, shuffle=shuffle))

    def random_shuffle(self, *, seed: Optional[int] = None, num_blocks: Optional[int] = None) -> "Dataset":
        return self._with_op(AllToAllOp(kind="random_shuffle", num_outputs=num_blocks, seed=seed))

    def sort(self, key: Union[str, List[str]], descending: bool = False) -> "Dataset":
        return self._with_op(AllToAllOp(kind="sort", key=key, descending=descending))

    def groupby(self, key: Union[str, List[str]]) -> GroupedData:
        return GroupedData(self, key)

    def zip(self, other: "Dataset") -> "Dataset":
        return self._with_op(AllToAllOp(kind="zip", other_plans=[other._plan]))

    def union(self, *others: "Dataset") -> "Dataset":
        return self._with_op(AllToAllOp(kind="union", other_plans=[o._plan for o in others]))

    def random_sample(self, fraction: float, *, seed: Optional[int] = None) -> "Dataset":
        rng_seed = seed

        def sample(batch):
            rng = np.random.default_rng(rng_seed)
            n = BlockAccessor(batch).num_rows()
            mask = rng.random(n) < fraction
            return BlockAccessor(batch).take(np.nonzero(mask)[0])

        return self.map_batches(sample)

    # ----------------------------------------------------------- consumption
    def materialize(self) -> "MaterializedDataset":
        bundles = list(self._stream())
        plan = LogicalPlan([InputBlocksOp(bundles)])
        mat = MaterializedDataset(plan)
        mat._cached_bundles = bundles
        return mat

    def take(self, limit: int = 20) -> List[Any]:
        out: List[Any] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= limit:
                break
        return out

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def take_batch(self, batch_size: int = 20, *, batch_format: Optional[str] = "default"):
        it = self.iterator().iter_batches(batch_size=batch_size, batch_format=batch_format, prefetch_batches=0)
        try:
            return next(iter(it))
        except StopIteration:
            raise ValueError("Dataset is empty") from None

    def show(self, limit: int = 20):
        for row in self.take(limit):
            print(row)

    def count(self) -> int:
        # Fast path: sum bundle metadata without fetching blocks.
        return sum(b.num_rows for b in self._stream())

    def size_bytes(self) -> int:
        return sum(b.size_bytes for b in self._stream())

    def num_blocks(self) -> int:
        return sum(1 for _ in self._stream())

    def schema(self):
        for block in self.limit(1).iterator()._iter_blocks():
            return BlockAccessor(block).schema()
        return None

    def columns(self) -> Optional[List[str]]:
        s = self.schema()
        return list(s.keys()) if isinstance(s, dict) else None

    # aggregates over the whole dataset
    def sum(self, on: str):
        return self._column_agg(on, np.sum)

    def min(self, on: str):
        return self._column_agg(on, np.min)

    def max(self, on: str):
        return self._column_agg(on, np.max)

    def mean(self, on: str):
        vals = [(np.sum(b[on]), len(b[on])) for b in self.iterator()._iter_blocks()]
        total = sum(v for v, _ in vals)
        n = sum(c for _, c in vals)
        return total / n if n else None

    def std(self, on: str, ddof: int = 1):
        col = np.concatenate([np.asarray(b[on]) for b in self.iterator()._iter_blocks()])
        return float(np.std(col, ddof=ddof))

    def unique(self, column: str) -> List[Any]:
        vals = set()
        for b in self.iterator()._iter_blocks():
            vals.update(np.unique(b[column]).tolist())
        return sorted(vals)

    def _column_agg(self, on: str, fn):
        parts = [fn(b[on]) for b in self.iterator()._iter_blocks() if len(b[on])]
        if not parts:
            return None
        return fn(np.asarray(parts))

    # ------------------------------------------------------------ iteration
    def iterator(self) -> DataIterator:
        return DataIterator(self._stream)

    def iter_rows(self) -> Iterator[Any]:
        return self.iterator().iter_rows()

    def iter_batches(self, **kwargs) -> Iterator[Any]:
        return self.iterator().iter_batches(**kwargs)

    def iter_torch_batches(self, **kwargs) -> Iterator[Any]:
        return self.iterator().iter_torch_batches(**kwargs)

    # reference: `Dataset.iter_jax_batches` (`ray_tpu/data/dataset.py:227-228`)
    # is not ported, with `DataIterator.iter_jax_batches`.

    # ---------------------------------------------------------------- split
    def split(self, n: int, *, equal: bool = False) -> List["MaterializedDataset"]:
        bundles = list(self._stream())
        if equal:
            return self._split_equal(bundles, n)
        groups: List[List[RefBundle]] = [[] for _ in range(n)]
        rows = [0] * n
        for b in sorted(bundles, key=lambda b: -b.num_rows):
            i = rows.index(min(rows))
            groups[i].append(b)
            rows[i] += b.num_rows
        return [_materialized_from(g) for g in groups]

    def _split_equal(self, bundles: List[RefBundle], n: int) -> List["MaterializedDataset"]:
        total = sum(b.num_rows for b in bundles)
        per = total // n
        ds = _materialized_from(bundles)
        out = []
        for i in range(n):
            out.append(ds._slice_rows(i * per, (i + 1) * per).materialize())
        return out

    def split_at_indices(self, indices: List[int]) -> List["MaterializedDataset"]:
        ds = self.materialize()
        bounds = [0] + list(indices) + [ds.count()]
        return [ds._slice_rows(bounds[i], bounds[i + 1]).materialize() for i in range(len(bounds) - 1)]

    def split_proportionately(self, proportions: List[float]) -> List["MaterializedDataset"]:
        ds = self.materialize()
        n = ds.count()
        indices, acc = [], 0.0
        for p in proportions:
            acc += p
            indices.append(int(n * acc))
        return ds.split_at_indices(indices)

    def train_test_split(self, test_size: float, *, shuffle: bool = False, seed=None):
        ds = self.random_shuffle(seed=seed) if shuffle else self
        train, test = ds.split_proportionately([1.0 - test_size])
        return train, test

    def streaming_split(self, n: int, *, equal: bool = False) -> List[DataIterator]:
        return [d.iterator() for d in self.split(n, equal=equal)]

    def _slice_rows(self, start: int, end: int) -> "Dataset":
        def do_slice(batch, _bounds=(start, end)):
            return batch

        # Implemented via a stateful row-window filter over the stream.
        return _RowWindow(self, start, end).as_dataset()

    # -------------------------------------------------------------- writes
    def write_parquet(self, path: str, **kwargs):
        return self._write(path, "parquet")

    def write_csv(self, path: str, **kwargs):
        return self._write(path, "csv")

    def write_json(self, path: str, **kwargs):
        return self._write(path, "json")

    def write_numpy(self, path: str, *, column: Optional[str] = None, **kwargs):
        ds = self.select_columns([column]) if column else self
        return ds._write(path, "npy")

    def write_datasink(self, sink):
        sink.on_write_start()
        results = []
        for i, bundle in enumerate(self._stream()):
            blocks = bundle.blocks()  # descriptor-aware (streaming plane)
            for j, block in enumerate(blocks):
                results.append(sink.write(block, {"task_idx": i, "block_idx": j}))
            bundle.release()
        sink.on_write_complete(results)
        return results

    def _write(self, path: str, fmt: str):
        from .datasource import FileDatasink

        return self.write_datasink(FileDatasink(path, fmt))

    # ---------------------------------------------------------- conversion
    def to_pandas(self, limit: Optional[int] = None):
        blocks = (self.limit(limit) if limit else self).iterator().materialize_blocks()
        import pandas as pd

        if not blocks:
            return pd.DataFrame()
        return pd.concat([BlockAccessor(b).to_pandas() for b in blocks], ignore_index=True)

    def to_arrow_refs(self):
        from ..core.api import put as ray_put

        return [ray_put(BlockAccessor(b).to_arrow()) for b in self.iterator().materialize_blocks()]

    def to_numpy_refs(self):
        from ..core.api import put as ray_put

        return [ray_put(BlockAccessor(b).to_numpy()) for b in self.iterator().materialize_blocks()]

    def __repr__(self):
        names = [op.name for op in self._plan.ops]
        return f"Dataset(ops={names})"


class MaterializedDataset(Dataset):
    """A Dataset pinned in the object store (reference: `MaterializedDataset`)."""


def _materialized_from(bundles: List[RefBundle]) -> MaterializedDataset:
    mat = MaterializedDataset(LogicalPlan([InputBlocksOp(bundles)]))
    mat._cached_bundles = bundles
    return mat


class _RowWindow:
    """Selects global row range [start, end) from a dataset's stream."""

    def __init__(self, ds: Dataset, start: int, end: int):
        self._ds, self._start, self._end = ds, start, end

    def as_dataset(self) -> Dataset:
        from ..core.api import put as ray_put

        out: List[RefBundle] = []
        offset = 0
        for bundle in self._ds._stream():
            lo, hi = offset, offset + bundle.num_rows
            offset = hi
            s = max(lo, self._start)
            e = min(hi, self._end)
            if e <= s:
                continue
            if s == lo and e == hi:
                out.append(bundle)
            else:
                merged = concat_blocks(bundle.blocks())
                piece = BlockAccessor(merged).slice(s - lo, e - lo)
                meta = _meta_of([piece])
                out.append(RefBundle(ray_put([piece]), meta["num_rows"], meta["size_bytes"]))
            if hi >= self._end:
                break
        return _materialized_from(out)

"""GroupedData + aggregate functions (reference: `python/ray/data/grouped_data.py`,
`python/ray/data/aggregate.py`)."""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import numpy as np

from .block import Block, BlockAccessor
from .plan import AllToAllOp


class AggregateFn:
    """An aggregate over one column of a group (reference: `AggregateFn`)."""

    def __init__(self, name: str, on: Optional[str], fn: Callable[[np.ndarray], np.generic]):
        self._name = name
        self._on = on
        self._fn = fn

    def output_name(self) -> str:
        return f"{self._name}({self._on})" if self._on else self._name

    def compute(self, block: Block, idx: np.ndarray):
        if self._on is None:
            return self._fn(idx)
        return self._fn(np.asarray(block[self._on])[idx])


class Count(AggregateFn):
    def __init__(self):
        super().__init__("count", None, lambda idx: np.int64(len(idx)))

    def output_name(self):
        return "count()"


class Sum(AggregateFn):
    def __init__(self, on: str):
        super().__init__("sum", on, np.sum)


class Min(AggregateFn):
    def __init__(self, on: str):
        super().__init__("min", on, np.min)


class Max(AggregateFn):
    def __init__(self, on: str):
        super().__init__("max", on, np.max)


class Mean(AggregateFn):
    def __init__(self, on: str):
        super().__init__("mean", on, np.mean)


class Std(AggregateFn):
    def __init__(self, on: str, ddof: int = 1):
        super().__init__("std", on, lambda v: np.std(v, ddof=min(ddof, max(len(v) - 1, 0))))


class GroupedData:
    """Returned by `Dataset.groupby`."""

    def __init__(self, dataset, key: Union[str, List[str]]):
        self._dataset = dataset
        self._key = key

    def aggregate(self, *aggs: AggregateFn):
        op = AllToAllOp(kind="groupby", key=self._key, aggs=list(aggs))
        return self._dataset._with_op(op)

    def count(self):
        return self.aggregate(Count())

    def sum(self, on: str):
        return self.aggregate(Sum(on))

    def min(self, on: str):
        return self.aggregate(Min(on))

    def max(self, on: str):
        return self.aggregate(Max(on))

    def mean(self, on: str):
        return self.aggregate(Mean(on))

    def std(self, on: str, ddof: int = 1):
        return self.aggregate(Std(on, ddof))

    def map_groups(self, fn, *, batch_format: Optional[str] = "default"):
        """Shuffle rows of each group together, then apply fn per group."""
        op = AllToAllOp(kind="groupby", key=self._key, aggs=[_MapGroupsMarker(fn, batch_format)])
        # map_groups reuses the exchange but with a per-group UDF: handled by
        # a dedicated post step in the executor via the marker aggregate.
        ds = self._dataset._with_op(op)
        return ds


class _MapGroupsMarker(AggregateFn):
    """Sentinel telling _GroupByPost to run a UDF per group instead of
    reducing columns (see executor._GroupByPost handling)."""

    def __init__(self, fn, batch_format):
        self.fn = fn
        self.batch_format = batch_format
        super().__init__("map_groups", None, lambda idx: None)

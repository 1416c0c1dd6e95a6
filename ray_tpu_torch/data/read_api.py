"""Module-level constructors (reference: `python/ray/data/read_api.py`)."""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from .block import build_block
from .dataset import Dataset
from .datasource import (
    BinaryDatasource,
    BlocksDatasource,
    CSVDatasource,
    Datasource,
    ItemsDatasource,
    ImageDatasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    RangeDatasource,
    SQLDatasource,
    TextDatasource,
    TFRecordDatasource,
    WebDatasetDatasource,
)
from .plan import LogicalPlan, ReadOp


def _from_source(source: Datasource, parallelism: int = -1) -> Dataset:
    return Dataset(LogicalPlan([ReadOp(source, parallelism)]))


# ------------------------------------------------------------- generators
def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    return _from_source(RangeDatasource(n), parallelism)


def range_tensor(n: int, *, shape: tuple = (1,), parallelism: int = -1) -> Dataset:
    return _from_source(RangeDatasource(n, tensor_shape=tuple(shape)), parallelism)


# -------------------------------------------------------------- in-memory
def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    if parallelism is None or parallelism < 0:
        parallelism = min(len(items), 8) or 1
    return _from_source(ItemsDatasource(items), parallelism)


def from_numpy(arrays, column: str = "data") -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = [arrays]
    blocks = [{column: a} for a in arrays]
    return _from_source(BlocksDatasource(blocks), len(blocks))


def from_numpy_refs(refs, column: str = "data") -> Dataset:
    from ..core.api import get as ray_get

    return from_numpy(ray_get(list(refs)), column)


def from_pandas(dfs) -> Dataset:
    import pandas as pd

    if isinstance(dfs, pd.DataFrame):
        dfs = [dfs]
    blocks = [build_block(df) for df in dfs]
    return _from_source(BlocksDatasource(blocks), len(blocks))


def from_pandas_refs(refs) -> Dataset:
    from ..core.api import get as ray_get

    return from_pandas(ray_get(list(refs)))


def from_arrow(tables) -> Dataset:
    import pyarrow as pa

    if isinstance(tables, pa.Table):
        tables = [tables]
    blocks = [build_block(t) for t in tables]
    return _from_source(BlocksDatasource(blocks), len(blocks))


def from_arrow_refs(refs) -> Dataset:
    from ..core.api import get as ray_get

    return from_arrow(ray_get(list(refs)))


def from_torch(torch_dataset) -> Dataset:
    items = [{"item": torch_dataset[i]} for i in _builtin_range(len(torch_dataset))]
    return from_items(items)


def from_huggingface(hf_dataset) -> Dataset:
    cols = {name: np.asarray(hf_dataset[name]) for name in hf_dataset.column_names}
    return _from_source(BlocksDatasource([cols]), 1)


_builtin_range = __import__("builtins").range


# ------------------------------------------------------------------ files
def read_csv(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return _from_source(CSVDatasource(paths, **kwargs), parallelism)


def read_json(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return _from_source(JSONDatasource(paths, **kwargs), parallelism)


def read_parquet(paths, *, parallelism: int = -1, columns: Optional[List[str]] = None, **kwargs) -> Dataset:
    return _from_source(ParquetDatasource(paths, columns=columns, **kwargs), parallelism)


def read_parquet_bulk(paths, **kwargs) -> Dataset:
    return read_parquet(paths, **kwargs)


def read_text(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return _from_source(TextDatasource(paths, **kwargs), parallelism)


def read_numpy(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return _from_source(NumpyDatasource(paths, **kwargs), parallelism)


def read_binary_files(paths, *, include_paths: bool = False, parallelism: int = -1, **kwargs) -> Dataset:
    return _from_source(BinaryDatasource(paths, include_paths=include_paths, **kwargs), parallelism)


def read_tfrecords(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return _from_source(TFRecordDatasource(paths, **kwargs), parallelism)


def read_images(
    paths,
    *,
    size: Optional[tuple] = None,
    mode: Optional[str] = None,
    include_paths: bool = False,
    parallelism: int = -1,
) -> Dataset:
    """Image files → 'image' column of HWC arrays (reference:
    `ray.data.read_images`)."""
    return _from_source(
        ImageDatasource(paths, size=size, mode=mode, include_paths=include_paths),
        parallelism,
    )


def read_sql(sql: str, connection_factory, *, parallelism: int = -1) -> Dataset:
    """DB-API query → Dataset (reference: `ray.data.read_sql`). Pass a
    zero-arg connection factory, e.g. `lambda: sqlite3.connect(path)`."""
    return _from_source(SQLDatasource(sql, connection_factory), parallelism)


def read_webdataset(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    """WebDataset tar shards → per-sample rows keyed by extension
    (reference: `ray.data.read_webdataset`)."""
    return _from_source(WebDatasetDatasource(paths, **kwargs), parallelism)


def read_datasource(datasource: Datasource, *, parallelism: int = -1, **kwargs) -> Dataset:
    return _from_source(datasource, parallelism)

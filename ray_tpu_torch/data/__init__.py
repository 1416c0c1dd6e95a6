"""ray_tpu_torch.data — streaming distributed datasets (reference: `python/ray/data`).

Lazy `Dataset` plans stream block bundles through fused remote task chains
with bounded in-flight backpressure; all-to-all ops (shuffle/sort/groupby)
run as map/reduce exchanges. Canonical block = dict of numpy columns, which
feeds `torch.as_tensor(...).to(device)` directly (`Dataset.iter_torch_batches`
with `device=`; the reference's `jax.device_put` feed,
`ray_tpu/data/__init__.py:5-6`, is not ported).
"""

# pandas / pyarrow C-extension init must happen on the importing (main)
# thread. When their first import is triggered lazily inside a task-pool
# thread (e.g. `build_block` probing for DataFrame inputs), later pyarrow
# calls segfault intermittently (observed: ParquetFile open, pandas 3.0 /
# pyarrow 25). Pay the import cost up front, once.
# Where pandas is installed (the reference imports it unconditionally,
# `ray_tpu/data/__init__.py:14`); a machine without pandas and pyarrow runs
# the numpy, items, range and torch paths, and the pandas- and arrow-backed
# readers raise ImportError when called.
try:
    import pandas as _pandas  # noqa: F401  (import side effect intended)
except ImportError:
    _pandas = None

from .block import Block, BlockAccessor, BlockMetadata
from .context import DataContext, ExecutionOptions, ExecutionResources
from .dataset import Dataset, MaterializedDataset
from .datasource import Datasink, Datasource, ReadTask
from .grouped import AggregateFn, Count, GroupedData, Max, Mean, Min, Std, Sum
from .iterator import DataIterator
from .preprocessor import (
    Concatenator,
    LabelEncoder,
    MinMaxScaler,
    Preprocessor,
    StandardScaler,
)
from .datasource import _warm_pyarrow as _warm_pyarrow_now
from .streaming import PullExecutor, StreamingIngest
from .read_api import (
    from_arrow,
    from_arrow_refs,
    from_huggingface,
    from_items,
    from_numpy,
    from_numpy_refs,
    from_pandas,
    from_pandas_refs,
    from_torch,
    range,
    range_tensor,
    read_binary_files,
    read_csv,
    read_datasource,
    read_json,
    read_numpy,
    read_parquet,
    read_parquet_bulk,
    read_text,
    read_images,
    read_sql,
    read_tfrecords,
    read_webdataset,
)

_warm_pyarrow_now()

__all__ = [
    "Block",
    "BlockAccessor",
    "BlockMetadata",
    "DataContext",
    "DataIterator",
    "Dataset",
    "MaterializedDataset",
    "Datasource",
    "Datasink",
    "ReadTask",
    "ExecutionOptions",
    "ExecutionResources",
    "GroupedData",
    "AggregateFn",
    "Count",
    "Sum",
    "Min",
    "Max",
    "Mean",
    "Std",
    "PullExecutor",
    "StreamingIngest",
    "Preprocessor",
    "StandardScaler",
    "MinMaxScaler",
    "LabelEncoder",
    "Concatenator",
    "range",
    "range_tensor",
    "from_items",
    "from_numpy",
    "from_numpy_refs",
    "from_pandas",
    "from_pandas_refs",
    "from_arrow",
    "from_arrow_refs",
    "from_torch",
    "from_huggingface",
    "read_csv",
    "read_json",
    "read_parquet",
    "read_parquet_bulk",
    "read_text",
    "read_numpy",
    "read_binary_files",
    "read_images",
    "read_sql",
    "read_tfrecords",
    "read_webdataset",
    "read_datasource",
]

"""Datasources and datasinks (reference: `python/ray/data/datasource/`).

A `Datasource` produces `ReadTask`s — serializable zero-arg callables that
yield blocks. Read tasks are executed remotely by the streaming executor, so
readers must be importable/picklable.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, Callable, Iterable, List, Optional

import numpy as np

from .block import Block, BlockMetadata, build_block


class ReadTask:
    """Zero-arg callable returning an iterable of blocks, plus size metadata."""

    def __init__(self, read_fn: Callable[[], Iterable[Block]], metadata: BlockMetadata):
        self._read_fn = read_fn
        self.metadata = metadata

    def __call__(self) -> Iterable[Block]:
        return self._read_fn()


class Datasource:
    """Reference: `python/ray/data/datasource/datasource.py`."""

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None

    def get_name(self) -> str:
        return type(self).__name__.replace("Datasource", "")


class Datasink:
    """Reference: `datasource/datasink.py` — receives blocks to persist."""

    def on_write_start(self):
        pass

    def write(self, block: Block, ctx: dict) -> Any:
        raise NotImplementedError

    def on_write_complete(self, write_results: List[Any]):
        pass


# ---------------------------------------------------------------- in-memory
class RangeDatasource(Datasource):
    def __init__(self, n: int, tensor_shape: Optional[tuple] = None, column: str = "id"):
        self._n = n
        self._shape = tensor_shape
        self._column = column

    def estimate_inmemory_data_size(self):
        per = 8 * (int(np.prod(self._shape)) if self._shape else 1)
        return self._n * per

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        parallelism = max(1, min(parallelism, self._n or 1))
        tasks = []
        chunk = self._n // parallelism
        rem = self._n % parallelism
        start = 0
        for i in range(parallelism):
            size = chunk + (1 if i < rem else 0)
            lo, hi = start, start + size
            start = hi
            shape, col = self._shape, self._column

            def read(lo=lo, hi=hi, shape=shape, col=col):
                ids = np.arange(lo, hi, dtype=np.int64)
                if shape:
                    data = np.broadcast_to(ids.reshape((-1,) + (1,) * len(shape)), (hi - lo,) + shape).copy()
                    return [{"data": data}]
                return [{col: ids}]

            meta = BlockMetadata(size, size * 8)
            tasks.append(ReadTask(read, meta))
        return tasks


class ItemsDatasource(Datasource):
    def __init__(self, items: List[Any]):
        self._items = list(items)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n = len(self._items)
        parallelism = max(1, min(parallelism, n or 1))
        tasks = []
        chunk, rem, start = n // parallelism, n % parallelism, 0
        for i in range(parallelism):
            size = chunk + (1 if i < rem else 0)
            part = self._items[start : start + size]
            start += size

            def read(part=part):
                if part and all(isinstance(r, dict) for r in part):
                    return [build_block(part)]
                return [[x for x in part]]

            tasks.append(ReadTask(read, BlockMetadata(size, None)))
        return tasks


class BlocksDatasource(Datasource):
    """Pre-built blocks (from_numpy / from_pandas / from_arrow)."""

    def __init__(self, blocks: List[Block]):
        self._blocks = blocks

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        from .block import BlockAccessor

        tasks = []
        for b in self._blocks:
            acc = BlockAccessor(b)
            tasks.append(ReadTask(lambda b=b: [b], acc.get_metadata()))
        return tasks


# -------------------------------------------------------------------- files
def _expand_paths(paths, suffix: Optional[str] = None) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            pat = os.path.join(p, "**", f"*{suffix}" if suffix else "*")
            out.extend(sorted(f for f in _glob.glob(pat, recursive=True) if os.path.isfile(f)))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(f for f in _glob.glob(p) if os.path.isfile(f)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"No input files found for {paths}")
    return out


def _warm_pyarrow():
    """Import every pyarrow extension submodule on the calling (driver)
    thread. pyarrow's lazy submodule imports segfault when first triggered
    concurrently from pool worker threads (observed with pyarrow 25: crash in
    `ParquetFile.__init__` while `pyarrow._dataset_parquet` initializes), so
    force C++ module init before tasks fan out."""
    try:
        import pyarrow.csv  # noqa: F401
        import pyarrow.dataset  # noqa: F401
        import pyarrow.fs  # noqa: F401
        import pyarrow.json  # noqa: F401
        import pyarrow.parquet  # noqa: F401
    except ImportError:
        pass


class FileBasedDatasource(Datasource):
    """One read task per file group (reference: `file_based_datasource.py`)."""

    _FILE_SUFFIX: Optional[str] = None

    def __init__(self, paths, **reader_args):
        _warm_pyarrow()
        self._paths = _expand_paths(paths, self._FILE_SUFFIX)
        self._reader_args = reader_args

    def _read_file(self, path: str, **kwargs) -> Iterable[Block]:
        raise NotImplementedError

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        parallelism = max(1, min(parallelism, len(self._paths)))
        groups: List[List[str]] = [[] for _ in range(parallelism)]
        for i, p in enumerate(self._paths):
            groups[i % parallelism].append(p)
        tasks = []
        for group in groups:
            if not group:
                continue
            reader, args = self._read_file, self._reader_args

            def read(group=group, reader=reader, args=args):
                blocks = []
                for path in group:
                    blocks.extend(reader(path, **args))
                return blocks

            size = sum(os.path.getsize(p) for p in group if os.path.exists(p))
            tasks.append(ReadTask(read, BlockMetadata(None, size, input_files=group)))
        return tasks


class CSVDatasource(FileBasedDatasource):
    _FILE_SUFFIX = ".csv"

    def _read_file(self, path, **kwargs):
        from pyarrow import csv as pacsv

        from .block import PYARROW_LOCK

        with PYARROW_LOCK:
            table = pacsv.read_csv(path, **kwargs)
        return [build_block(table)]


class JSONDatasource(FileBasedDatasource):
    _FILE_SUFFIX = ".json"

    def _read_file(self, path, **kwargs):
        import json

        rows = []
        with open(path) as f:
            text = f.read().strip()
        if text.startswith("["):
            rows = json.loads(text)
        else:  # JSONL
            rows = [json.loads(line) for line in text.splitlines() if line.strip()]
        return [build_block(rows)] if rows else []


class ParquetDatasource(FileBasedDatasource):
    _FILE_SUFFIX = ".parquet"

    def _read_file(self, path, columns=None, **kwargs):
        import pyarrow.parquet as pq

        from .block import PYARROW_LOCK

        # pq.read_table routes through pyarrow.dataset (FileSystemDataset +
        # fragments), which segfaults intermittently when entered from pool
        # threads in this environment; ParquetFile is the direct reader and
        # has been stable under the same load.
        with PYARROW_LOCK:
            with pq.ParquetFile(path, **kwargs) as f:
                table = f.read(columns=columns, use_threads=False)
        return [build_block(table)]


class TextDatasource(FileBasedDatasource):
    def _read_file(self, path, encoding="utf-8", drop_empty_lines=True, **kwargs):
        with open(path, encoding=encoding) as f:
            lines = f.read().splitlines()
        if drop_empty_lines:
            lines = [ln for ln in lines if ln.strip()]
        return [{"text": np.asarray(lines, dtype=object)}]


class NumpyDatasource(FileBasedDatasource):
    _FILE_SUFFIX = ".npy"

    def _read_file(self, path, **kwargs):
        arr = np.load(path, allow_pickle=False)
        return [{"data": arr}]


class BinaryDatasource(FileBasedDatasource):
    def _read_file(self, path, include_paths=False, **kwargs):
        with open(path, "rb") as f:
            data = f.read()
        col = np.empty(1, dtype=object)
        col[0] = data
        block = {"bytes": col}
        if include_paths:
            block["path"] = np.asarray([path], dtype=object)
        return [block]


class ImageDatasource(FileBasedDatasource):
    """Image files → HWC uint8 arrays (reference:
    `data/datasource/image_datasource.py`). Optional resize + mode convert."""

    _EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")

    def __init__(self, paths, size=None, mode=None, include_paths=False, **kw):
        # Directory/glob inputs are filtered to image extensions; EXPLICIT
        # file paths are always kept (PIL raises on non-images — honest
        # failure beats silent, neighbor-dependent dropping).
        if isinstance(paths, str):
            paths = [paths]
        explicit = {
            os.path.abspath(p)
            for p in paths
            if not os.path.isdir(p) and not any(ch in p for ch in "*?[")
        }
        super().__init__(paths, size=size, mode=mode, include_paths=include_paths, **kw)
        self._paths = [
            p
            for p in self._paths
            if os.path.abspath(p) in explicit
            or os.path.splitext(p)[1].lower() in self._EXTS
        ]
        if not self._paths:
            raise FileNotFoundError(f"No image files found in {paths}")

    def _read_file(self, path, size=None, mode=None, include_paths=False, **kwargs):
        from PIL import Image

        with Image.open(path) as img:
            if mode is not None:
                img = img.convert(mode)
            if size is not None:
                img = img.resize((size[1], size[0]))  # PIL takes (W, H)
            arr = np.asarray(img)
        col = np.empty(1, dtype=object)
        col[0] = arr
        block = {"image": col}
        if include_paths:
            block["path"] = np.asarray([path], dtype=object)
        return [block]


class SQLDatasource(Datasource):
    """SQL query → row blocks (reference: `data/datasource/sql_datasource.py`).
    Takes a zero-arg `connection_factory` (DB-API 2.0) so each read task can
    open its own connection in its own worker process."""

    def __init__(self, sql: str, connection_factory: Callable[[], Any]):
        self._sql = sql
        self._factory = connection_factory

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        sql, factory = self._sql, self._factory

        def read():
            conn = factory()
            try:
                cur = conn.cursor()
                cur.execute(sql)
                cols = [d[0] for d in cur.description]
                rows = cur.fetchall()
            finally:
                conn.close()
            if not rows:
                return []
            return [build_block([dict(zip(cols, r)) for r in rows])]

        # A single task: SQL pushdown-partitioning needs dialect-specific
        # LIMIT/OFFSET or key-range splitting — the reference also reads
        # unpartitioned unless the user shards the query.
        return [ReadTask(read, BlockMetadata(None, None))]


class WebDatasetDatasource(FileBasedDatasource):
    """WebDataset-style tar shards: members grouped by key, field per
    extension (reference: `data/datasource/webdataset_datasource.py`).
    Decodes jpg/png→arrays, txt/cls→str/int, json→objects; other
    extensions stay raw bytes."""

    _FILE_SUFFIX = ".tar"

    def _read_file(self, path, **kwargs):
        import io
        import json as _json
        import tarfile

        samples: dict = {}
        order: List[str] = []
        with tarfile.open(path) as tf:
            for member in tf.getmembers():
                if not member.isfile():
                    continue
                # Key = full path minus extension: same-stem files in
                # different directories are distinct samples (reference
                # webdataset semantics).
                dirname, base = os.path.split(member.name)
                stem, _, ext = base.partition(".")
                key = os.path.join(dirname, stem) if dirname else stem
                data = tf.extractfile(member).read()
                if key not in samples:
                    samples[key] = {"__key__": key}
                    order.append(key)
                samples[key][ext] = self._decode(ext.lower(), data, _json, io)
        rows = [samples[k] for k in order]
        return [build_block(rows)] if rows else []

    @staticmethod
    def _decode(ext, data, _json, io):
        if ext in ("jpg", "jpeg", "png", "bmp", "webp"):
            try:
                from PIL import Image

                with Image.open(io.BytesIO(data)) as img:
                    return np.asarray(img)
            except Exception:  # noqa: BLE001 — undecodable stays raw
                return data
        if ext in ("txt", "text"):
            return data.decode()
        if ext == "cls":
            return int(data.decode().strip())
        if ext == "json":
            return _json.loads(data)
        return data


class TFRecordDatasource(FileBasedDatasource):
    """Minimal TFRecord reader: raw record bytes (no proto decode without TF)."""

    def _read_file(self, path, **kwargs):
        import struct

        records = []
        with open(path, "rb") as f:
            while True:
                header = f.read(8)
                if len(header) < 8:
                    break
                (length,) = struct.unpack("<Q", header)
                f.read(4)  # length crc
                records.append(f.read(length))
                f.read(4)  # data crc
        col = np.empty(len(records), dtype=object)
        for i, r in enumerate(records):
            col[i] = r
        return [{"bytes": col}] if records else []


# ------------------------------------------------------------------- sinks
class FileDatasink(Datasink):
    def __init__(self, path: str, file_format: str):
        self._path = path
        self._format = file_format

    def on_write_start(self):
        os.makedirs(self._path, exist_ok=True)

    def write(self, block: Block, ctx: dict) -> str:
        from .block import BlockAccessor

        idx = ctx.get("task_idx", 0)
        seq = ctx.get("block_idx", 0)
        out = os.path.join(self._path, f"part-{idx:05d}-{seq:05d}.{self._format}")
        acc = BlockAccessor(block)
        if self._format == "parquet":
            import pyarrow.parquet as pq

            pq.write_table(acc.to_arrow(), out)
        elif self._format == "csv":
            from pyarrow import csv as pacsv

            pacsv.write_csv(acc.to_arrow(), out)
        elif self._format == "json":
            import json

            with open(out, "w") as f:
                for row in acc.iter_rows():
                    f.write(json.dumps({k: _json_safe(v) for k, v in row.items()}) + "\n")
        elif self._format == "npy":
            data = acc.to_numpy()
            if isinstance(data, dict):
                if len(data) != 1:
                    raise ValueError("write_numpy requires a single-column dataset; pass column=")
                data = next(iter(data.values()))
            np.save(out, data)
        else:
            raise ValueError(f"Unknown format {self._format}")
        return out


def _json_safe(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v

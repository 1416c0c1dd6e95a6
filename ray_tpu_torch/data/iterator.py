"""DataIterator: batch iteration with prefetch and device feed.

Reference: `python/ray/data/iterator.py` + `_internal/block_batching`.
The device feed is `iter_torch_batches(device=...)`: the reference's JAX
feed `iter_jax_batches` (`ray_tpu/data/iterator.py:4-6`, `:89-103`) imports
jax and is not ported.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, List, Optional

import numpy as np

from .block import Block, BlockAccessor, concat_blocks
from .plan import _rebatch


class DataIterator:
    """Iterates batches over a stream of block bundles."""

    def __init__(self, bundle_source: Callable[[], Iterator[Any]]):
        # bundle_source yields RefBundle; re-callable for epochs.
        self._source = bundle_source

    # ------------------------------------------------------------- blocks
    def _iter_blocks(self) -> Iterator[Block]:
        for bundle in self._source():
            # Streaming-plane bundles are descriptor-backed (blocks() walks
            # the transport rung ladder); legacy bundles resolve with a
            # plain get. release() marks the blocks consumer-done so the
            # run's residency accounting sees the hand-off.
            blocks = bundle.blocks()
            for block in blocks:
                if BlockAccessor(block).num_rows() > 0:
                    yield block
            bundle.release()

    def iter_rows(self) -> Iterator[Any]:
        for block in self._iter_blocks():
            yield from BlockAccessor(block).iter_rows()

    # ------------------------------------------------------------ batches
    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: Optional[str] = "default",
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
        prefetch_batches: int = 1,
        _collate_fn: Optional[Callable] = None,
    ) -> Iterator[Any]:
        def produce() -> Iterator[Any]:
            blocks = self._iter_blocks()
            if local_shuffle_buffer_size:
                blocks = _shuffling_blocks(blocks, local_shuffle_buffer_size, local_shuffle_seed)
            for batch in _rebatch(list_iter(blocks), batch_size):
                acc = BlockAccessor(batch)
                if drop_last and batch_size and acc.num_rows() < batch_size:
                    continue
                out = acc.to_batch(batch_format)
                yield _collate_fn(out) if _collate_fn else out

        if prefetch_batches and prefetch_batches > 0:
            return _prefetched(produce, prefetch_batches)
        return produce()

    def iter_torch_batches(self, *, dtypes=None, device: Optional[str] = None, **kwargs):
        import torch

        def collate(batch):
            out = {}
            for k, v in batch.items():
                t = torch.as_tensor(np.ascontiguousarray(v))
                if dtypes is not None:
                    t = t.to(dtypes[k] if isinstance(dtypes, dict) else dtypes)
                if device:
                    t = t.to(device)
                out[k] = t
            return out

        kwargs.setdefault("batch_format", "numpy")
        return self.iter_batches(_collate_fn=collate, **kwargs)

    # reference: `iter_jax_batches` (`ray_tpu/data/iterator.py:89-103`) is not
    # ported: it imports jax. Callers pass `device=` to iter_torch_batches.

    def materialize_blocks(self) -> List[Block]:
        return list(self._iter_blocks())


def list_iter(blocks: Iterator[Block]) -> List[Block]:
    # _rebatch takes a list-like; wrap lazily via generator-friendly shim
    return _LazyBlockList(blocks)


class _LazyBlockList:
    def __init__(self, it: Iterator[Block]):
        self._it = it

    def __iter__(self):
        return self._it


def _shuffling_blocks(blocks: Iterator[Block], buffer_rows: int, seed) -> Iterator[Block]:
    """Local shuffle: accumulate ≥buffer_rows rows, emit permuted chunks."""
    rng = np.random.default_rng(seed)
    buf: List[Block] = []
    rows = 0
    for b in blocks:
        buf.append(b)
        rows += BlockAccessor(b).num_rows()
        if rows >= buffer_rows:
            merged = concat_blocks(buf)
            acc = BlockAccessor(merged)
            yield acc.take(rng.permutation(acc.num_rows()))
            buf, rows = [], 0
    if buf:
        merged = concat_blocks(buf)
        acc = BlockAccessor(merged)
        yield acc.take(rng.permutation(acc.num_rows()))


def _prefetched(produce: Callable[[], Iterator[Any]], depth: int) -> Iterator[Any]:
    """Run `produce` in a background thread, `depth` items ahead.

    The producer must die promptly when the consumer abandons the generator
    (e.g. `next(iter(...))`) — a live orphan thread still collating into
    torch/jax while other threads enter pyarrow has caused segfaults — so a
    stop event is checked around every queue interaction and set from the
    generator's `finally` (runs on GC/close of the generator).
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    _DONE = object()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in produce():
                if not _put(item):
                    return
            _put(_DONE)
        except BaseException as e:  # noqa: BLE001
            _put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=5.0)

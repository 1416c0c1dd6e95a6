"""StreamingIngest — the backpressured bridge from the pull plane to a
training loop.

One producer thread per rank drives the dataset's bundle stream (epoch
after epoch — re-executing the plan per epoch, so shard/preprocess/shuffle
of epoch N+1 overlaps epoch N's training steps) and batches rows into a
BOUNDED queue (`ctx.ingest_prefetch_batches`). The training thread pulls
with ``next_batch()`` / iteration; when it falls behind, the queue fills,
the producer blocks (``data.backpressure`` span on lane ``data/ingest``),
its pulls stop, and every operator window upstream fills in turn — the
whole pipeline parks at bounded memory. When the TRAINER is starved
instead, ``next_batch`` records ``data.starve``: the two span kinds are
the ingest half of `flight.ingest_report`'s attribution.

Plugs into training two ways:
  * elastic/SPMD loops: ``session.get_streaming_ingest(name)`` inside the
    train fn wraps the rank's dataset shard;
  * the MPMD trainer: ``ingest.as_batch_fn(column=...)`` is a drop-in
    ``batch_fn(step)`` — gap-free across epoch boundaries.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np

from ...util import flight
from ..context import DataContext

_SENTINEL_EPOCH = object()  # epoch boundary marker in the queue
_SENTINEL_DONE = object()   # producer exit (epochs exhausted or error)
LANE = "data/ingest"


class StreamingIngest:
    """Bounded-prefetch batch stream over a Dataset (or DataIterator).

    ``epochs=None`` streams forever (the MPMD ``batch_fn`` shape);
    a finite count makes ``__iter__`` yield per-epoch batch iterators'
    batches back to back and then stop.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        epochs: Optional[int] = None,
        prefetch: Optional[int] = None,
        batch_format: str = "numpy",
        drop_last: bool = True,
        ctx: Optional[DataContext] = None,
    ):
        ctx = ctx or DataContext.get_current()
        self._dataset = dataset
        self._batch_size = int(batch_size)
        self._epochs = epochs
        self._batch_format = batch_format
        self._drop_last = drop_last
        self._q: "queue.Queue" = queue.Queue(
            maxsize=max(1, prefetch or ctx.ingest_prefetch_batches))
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self.batches_produced = 0
        self.batches_consumed = 0
        self.epochs_started = 0
        self.backpressure_s = 0.0
        self.starve_s = 0.0
        self._thread = threading.Thread(
            target=self._produce, name="rtpu-ingest", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- producer
    def _epoch_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        it = self._dataset.iterator() if hasattr(self._dataset, "iterator") \
            else self._dataset
        return it.iter_batches(batch_size=self._batch_size,
                               batch_format=self._batch_format,
                               drop_last=self._drop_last)

    def _produce(self) -> None:
        try:
            while not self._stop.is_set():
                if self._epochs is not None and \
                        self.epochs_started >= self._epochs:
                    break
                self.epochs_started += 1
                for batch in self._epoch_batches():
                    if self._stop.is_set():
                        return
                    self._put(batch)
                    self.batches_produced += 1
                self._put(_SENTINEL_EPOCH)
        except BaseException as e:  # noqa: BLE001 — surfaced on next_batch
            self._error = e
        finally:
            self._put(_SENTINEL_DONE, force=True)

    def _put(self, item, force: bool = False) -> None:
        """Queue-put that records how long backpressure parked us."""
        t0 = time.monotonic_ns()
        while True:
            try:
                self._q.put(item, timeout=0.1)
                break
            except queue.Full:
                if self._stop.is_set() and not force:
                    return
        t1 = time.monotonic_ns()
        stalled = (t1 - t0) * 1e-9
        if stalled > 1e-3:
            self.backpressure_s += stalled
            flight.record("data.backpressure", t0, t1, lane=LANE)

    # ------------------------------------------------------------- consumer
    def next_batch(self, timeout: Optional[float] = None):
        """Next batch, blocking; None once the stream is exhausted.
        Epoch boundaries are transparent here — use ``__iter__`` +
        ``epoch_ends`` when the loop cares."""
        while True:
            item = self._take(timeout)
            if item is _SENTINEL_EPOCH:
                continue
            if item is _SENTINEL_DONE:
                self._raise_if_failed()
                return None
            self.batches_consumed += 1
            return item

    def _take(self, timeout: Optional[float]):
        t0 = time.monotonic_ns()
        item = self._q.get(timeout=timeout)
        t1 = time.monotonic_ns()
        starved = (t1 - t0) * 1e-9
        if starved > 1e-3:
            self.starve_s += starved
            flight.record("data.starve", t0, t1, lane=LANE)
        if item is _SENTINEL_DONE:
            # Keep the terminal state observable by later calls too.
            self._q.put(_SENTINEL_DONE)
        return item

    def __iter__(self):
        while True:
            item = self._take(None)
            if item is _SENTINEL_EPOCH:
                continue
            if item is _SENTINEL_DONE:
                self._raise_if_failed()
                return
            self.batches_consumed += 1
            yield item

    def as_batch_fn(self, column: Optional[str] = None) -> Callable[[int], Any]:
        """An MPMD-trainer ``batch_fn(step)``: gap-free batches, cycling
        epochs forever (construct with ``epochs=None`` for that shape)."""

        def batch_fn(step: int):
            batch = self.next_batch()
            if batch is None:
                raise StopIteration(
                    f"ingest stream exhausted at step {step}")
            if column is not None:
                return batch[column]
            return batch

        return batch_fn

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            raise RuntimeError("StreamingIngest producer failed") \
                from self._error

    def stats(self) -> Dict[str, Any]:
        return {
            "batches_produced": self.batches_produced,
            "batches_consumed": self.batches_consumed,
            "epochs_started": self.epochs_started,
            "backpressure_s": self.backpressure_s,
            "starve_s": self.starve_s,
            "queue_depth": self._q.qsize(),
            "queue_cap": self._q.maxsize,
        }

    def shutdown(self) -> None:
        """Stop the producer and join it. Idempotent. MUST run before the
        driving process tears down the runtime — the producer thread holds
        object refs and a mid-get teardown is the documented segfault
        hazard (see iterator.py's prefetch teardown rationale)."""
        self._stop.set()
        try:  # unblock a producer parked on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)

    def __enter__(self) -> "StreamingIngest":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

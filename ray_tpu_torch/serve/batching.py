"""`@serve.batch` and `@serve.multiplexed` (reference: `serve/batching.py`,
`serve/multiplex.py`).

TPU framing: batch formation happens in the *router* (requests accumulate up
to max_batch_size / batch_wait_timeout_s, then ship as ONE replica call) so a
replica executes one XLA program per formed batch — the reference batches
inside the replica's asyncio loop instead.
"""

from __future__ import annotations

import collections
import functools
from typing import Callable, Optional


class _BatchConfig:
    __slots__ = ("max_batch_size", "batch_wait_timeout_s")

    def __init__(self, max_batch_size: int, batch_wait_timeout_s: float):
        self.max_batch_size = max_batch_size
        self.batch_wait_timeout_s = batch_wait_timeout_s


def batch(
    _fn: Optional[Callable] = None,
    *,
    max_batch_size: int = 8,
    batch_wait_timeout_s: float = 0.01,
):
    """Mark a method as batch-handling: it receives a LIST of the single
    arguments callers passed to `.remote()` and must return a list of equal
    length."""

    def wrap(fn):
        fn._serve_batch_config = _BatchConfig(max_batch_size, batch_wait_timeout_s)
        return fn

    if _fn is not None:
        return wrap(_fn)
    return wrap


def multiplexed(
    _fn: Optional[Callable] = None,
    *,
    max_num_models_per_replica: int = 3,
):
    """Wrap a model-loader method with a per-replica LRU cache keyed by
    model_id (reference: `serve/multiplex.py` `_ModelMultiplexWrapper`)."""

    def wrap(fn):
        @functools.wraps(fn)
        def loader(self, model_id: str):
            cache = getattr(self, "_serve_multiplex_cache", None)
            if cache is None:
                cache = collections.OrderedDict()
                self._serve_multiplex_cache = cache
            if model_id in cache:
                cache.move_to_end(model_id)
                return cache[model_id]
            model = fn(self, model_id)
            cache[model_id] = model
            while len(cache) > max_num_models_per_replica:
                evicted_id, evicted = cache.popitem(last=False)
                del_fn = getattr(evicted, "__del__", None)
                if del_fn is not None:
                    try:
                        del_fn()
                    except Exception:  # noqa: BLE001
                        pass
            return model

        loader._serve_multiplexed = True
        return loader

    if _fn is not None:
        return wrap(_fn)
    return wrap

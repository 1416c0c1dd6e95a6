"""Global execution configuration (reference: `python/ray/data/context.py`)."""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Optional


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


@dataclass
class ExecutionResources:
    cpu: Optional[float] = None
    gpu: Optional[float] = None
    object_store_memory: Optional[float] = None


@dataclass
class ExecutionOptions:
    resource_limits: ExecutionResources = field(default_factory=ExecutionResources)
    locality_with_output: bool = False
    preserve_order: bool = True
    verbose_progress: bool = False


@dataclass
class DataContext:
    """Process-wide dataset execution knobs.

    `max_in_flight_tasks` is the streaming-executor backpressure bound
    (reference: backpressure policies under
    `data/_internal/execution/backpressure_policy/`).
    """

    target_max_block_size: int = 128 * 1024 * 1024
    target_min_block_size: int = 1 * 1024 * 1024
    max_in_flight_tasks: int = max(2, (os.cpu_count() or 8))
    read_op_min_num_blocks: int = 8
    execution_options: ExecutionOptions = field(default_factory=ExecutionOptions)
    enable_progress_bars: bool = False
    eager_free: bool = True

    # Streaming pull plane (data/streaming/, docs/STREAMING_DATA.md).
    # streaming_pull routes Dataset._stream() through the bounded-window
    # PullExecutor; off = the legacy stage-barrier path (kept for A/B).
    streaming_pull: bool = field(
        default_factory=lambda: _env_bool("RAY_TPU_DATA_STREAMING_PULL", True))
    # Per-operator in-flight window: blocks resident (submitted but not yet
    # consumed+released) per op never exceeds this. Backpressure is pull-only
    # refill — an op pulls upstream only when its window has room, so the
    # bound propagates to the source with no explicit signaling.
    streaming_window_blocks: int = field(
        default_factory=lambda: _env_int("RAY_TPU_DATA_STREAMING_WINDOW", 8))
    # Route reduce/consumer tasks to the node holding the largest share of
    # their source segment bytes (soft node affinity via the controller's
    # candidate ordering; see data/streaming/locality.py).
    locality_placement: bool = field(
        default_factory=lambda: _env_bool("RAY_TPU_DATA_LOCALITY", True))
    # StreamingIngest per-rank prefetch queue depth (batches buffered ahead
    # of the training step; epoch N+1 production overlaps epoch N consume).
    ingest_prefetch_batches: int = field(
        default_factory=lambda: _env_int("RAY_TPU_DATA_INGEST_PREFETCH", 4))

    _lock = threading.Lock()
    _current: Optional["DataContext"] = None

    @staticmethod
    def get_current() -> "DataContext":
        with DataContext._lock:
            if DataContext._current is None:
                DataContext._current = DataContext()
            return DataContext._current

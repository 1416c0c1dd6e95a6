"""Streaming data plane: bounded-window pull execution, segment-framed
ONE-TO-ONE routing, locality-aware placement, backpressured train ingest.

docs/STREAMING_DATA.md is the contract; data/README.md has the overview.
"""

from .executor import PullExecutor, last_run_stats
from .ingest import StreamingIngest
from .interface import PhysicalOperator, StreamStats

__all__ = [
    "PullExecutor",
    "StreamingIngest",
    "StreamStats",
    "PhysicalOperator",
    "last_run_stats",
]

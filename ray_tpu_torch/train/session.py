"""In-loop training session API: report / get_context / get_checkpoint.

Reference analog: `python/ray/train/_internal/session.py` (`_TrainSession`,
`report` `:393,653`) — user code calls `ray_tpu_torch.train.report(metrics,
checkpoint=...)` from inside `train_loop_per_worker`; the backend executor
polls results from the worker actors.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class TrainContext:
    world_rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    node_rank: int = 0
    experiment_name: str = ""
    trial_name: str = ""
    trial_id: str = ""
    storage_path: str = ""
    dataset_shards: Dict[str, Any] = field(default_factory=dict)
    latest_checkpoint: Optional[Any] = None
    # Per-worker env (rank vars, jax coordinator). Kept here as well as in
    # os.environ because local-mode worker actors share one process — the
    # session copy is the authoritative per-worker view.
    env_vars: Dict[str, str] = field(default_factory=dict)

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_trial_name(self) -> str:
        return self.trial_name

    def get_trial_id(self) -> str:
        return self.trial_id

    def get_storage(self) -> str:
        return self.storage_path


class _Session:
    def __init__(self, context: TrainContext):
        self.context = context
        self.results: "queue.Queue" = queue.Queue()
        # Cursor-readable copy of every report: a poll RESPONSE lost in
        # flight (the gang poll batch raising because a sibling died) must
        # not lose this worker's reports — the executor re-reads from its
        # last acknowledged index. Cursor polls implicitly ack (and trim)
        # everything below the requested index, so memory stays bounded by
        # the poll interval. The destructive queue stays for drain-style
        # consumers (tune's tuner); cursor mode discards it.
        self.history: list = []
        self.history_base = 0  # absolute index of history[0]
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None
        # Lazily-created ElasticSession (train/elastic): async shard writer
        # + deterministic-resume state for this worker. Owned here so the
        # worker thread can flush it when the loop ends.
        self.elastic = None

    def report(self, metrics: Dict[str, Any], checkpoint=None):
        entry = {"metrics": dict(metrics), "checkpoint": checkpoint}
        self.history.append(entry)
        self.results.put(entry)


_session: Optional[_Session] = None
_session_lock = threading.Lock()
_thread_session = threading.local()


def init_session(context: TrainContext) -> _Session:
    global _session
    with _session_lock:
        _session = _Session(context)
        return _session


def bind_thread_session(session: _Session):
    """Bind a session to the current thread. Needed because (a) the user loop
    runs on its own thread inside the worker actor, and (b) in local mode
    multiple worker actors share one process, so a bare global would collide."""
    _thread_session.value = session


def get_session() -> Optional[_Session]:
    s = getattr(_thread_session, "value", None)
    return s if s is not None else _session


def shutdown_session():
    global _session
    with _session_lock:
        _session = None


# ------------------------------------------------------------------ public
def report(metrics: Dict[str, Any], checkpoint=None):
    """Report metrics (+ optional Checkpoint) from the training loop."""
    s = get_session()
    if s is None:
        raise RuntimeError("report() called outside a training worker")
    s.report(metrics, checkpoint)


def get_context() -> TrainContext:
    s = get_session()
    if s is None:
        return TrainContext()
    return s.context


def get_checkpoint():
    s = get_session()
    return s.context.latest_checkpoint if s else None


def get_dataset_shard(name: str = "train"):
    s = get_session()
    if s is None:
        return None
    return s.context.dataset_shards.get(name)


def get_streaming_ingest(name: str = "train", *, batch_size: int = 256,
                         **kwargs):
    """This rank's dataset shard wrapped in a `StreamingIngest` — a bounded
    per-rank prefetch queue over the streaming pull plane, so epoch N+1's
    shard/preprocess/shuffle overlaps epoch N's steps (backpressure parks
    the producer when the trainer falls behind; docs/STREAMING_DATA.md).
    Callers own shutdown(): use ``with session.get_streaming_ingest(...)``
    around the step loop. None when the rank has no such shard."""
    shard = get_dataset_shard(name)
    if shard is None:
        return None
    from ..data.streaming import StreamingIngest

    return StreamingIngest(shard, batch_size, **kwargs)


def get_elastic_session():
    """The worker's ElasticSession (created on first use) — async sharded
    checkpointing + deterministic resume. See ray_tpu_torch.train.elastic."""
    from .elastic import elastic_session

    return elastic_session()

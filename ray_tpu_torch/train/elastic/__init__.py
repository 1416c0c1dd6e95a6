"""ray_tpu_torch.train.elastic — fault-tolerant gang training.

Three planes (ISSUE 4; TorchTitan arXiv 2410.06511 + the Ray paper's
supervisor pattern, arXiv 1712.05889):

- `supervisor.GangSupervisor` — watches controller death events, aborts the
  whole mesh on any member death, decides restart/shrink/stop with a capped
  budget and exponential backoff. Driven by `BackendExecutor.run()`.
- `ckpt.AsyncShardWriter` / `ckpt.ShardedCheckpoint` — per-rank background
  shard writes with a group-commit marker; crash mid-save leaves the
  previous committed checkpoint restorable; restore reshards on world-size
  change.
- `state.ElasticState` — step counter + global data offsets travel with the
  checkpoint so the resumed loss trajectory matches an unkilled run.

Worker-side usage, inside `train_loop_per_worker`:

    from ray_tpu_torch.train import elastic

    sess = elastic.elastic_session()          # binds rank/world/storage
    tree = sess.restore() or init_tree()      # None on a fresh run
    for step in range(sess.state.step, total_steps):
        tree = train_step(tree, batch_at(sess.state, step))
        sess.save(step + 1, tree)             # async; never blocks the step
    sess.flush()

See docs/ELASTIC_TRAINING.md for the failure model and every knob.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional

from .ckpt import (
    AsyncShardWriter,
    COMMIT_MARKER,
    ShardedCheckpoint,
    latest_common_committed,
    stage_root,
)
from .state import ElasticState
from .supervisor import DEATH_EVENT_KINDS, GangSupervisor, RestartDecision

# Env var carrying the gang-incarnation token (set by BackendExecutor.start
# on every (re)start; all ranks of one incarnation share it so their shards
# land in the same checkpoint directory and never mix with a previous
# incarnation's partial save).
GEN_ENV = "RAY_TPU_TRAIN_ELASTIC_GEN"
# Run-identity namespace (set once per BackendExecutor): unnamed runs share
# the default resolved storage path, and without this token a brand-new run
# would silently restore a PREVIOUS run's committed checkpoints — wrong
# weights and a wrong step counter. Named runs carry their name (stable, so
# elastic resume across driver restarts stays possible by opting into a
# RunConfig name).
RUN_ENV = "RAY_TPU_TRAIN_ELASTIC_RUN"


class ElasticSession:
    """Per-rank elastic checkpoint/restore surface, bound to the ambient
    train session (rank, world size, storage path, incarnation token)."""

    def __init__(
        self,
        root: Optional[str] = None,
        mode: str = "replicated",
        queue_depth: int = 2,
        keep: Optional[int] = 3,
    ):
        # Default mode is "replicated" because DataParallelTrainer (the
        # trainer this session runs under) keeps identical params on every
        # rank: restore after an elastic world-size change takes rank 0's
        # copy. mode="sharded" is for trees that genuinely are axis-0
        # partitions (FSDP-style) — concatenating REPLICATED trees on a
        # shrink would duplicate every weight. Commit is group-wide in both
        # modes (marker requires every rank's shard).
        from ..session import get_context

        ctx = get_context()
        self.rank = ctx.get_world_rank()
        self.world_size = ctx.get_world_size()
        # Both defaults are namespaced by the run token (or experiment
        # name when running outside the trainer) — a fixed shared path
        # would let unrelated runs cross-restore each other's checkpoints
        # (wrong weights AND a wrong step counter).
        run_ns = (
            ctx.env_vars.get(RUN_ENV)
            or os.environ.get(RUN_ENV)
            or ctx.get_experiment_name()
            or "default"
        )
        storage = root or (
            os.path.join(ctx.get_storage(), "elastic", run_ns)
            if ctx.get_storage()
            else os.path.join(
                tempfile.gettempdir(), f"rtpu-elastic-{run_ns}"
            )
        )
        self.root = storage
        gen = (
            ctx.env_vars.get(GEN_ENV)
            or os.environ.get(GEN_ENV)
            or "0"
        )
        self.state = ElasticState()
        tags = (
            {"experiment": ctx.get_experiment_name()}
            if ctx.get_experiment_name()
            else {}
        )
        self.writer = AsyncShardWriter(
            storage, self.rank, self.world_size, gen=gen, mode=mode,
            queue_depth=queue_depth, metric_tags=tags, keep=keep,
        )

    # ------------------------------------------------------------ restore
    def restore(self) -> Optional[Any]:
        """Load the latest committed checkpoint (resharding if the saved
        world size differs); installs its ElasticState on `self.state` and
        returns the tree — or None on a fresh run (state stays zeroed)."""
        found = ShardedCheckpoint.restore(self.root, self.rank, self.world_size)
        if found is None:
            return None
        self.state, tree = found
        return tree

    # --------------------------------------------------------------- save
    def save(
        self,
        step: int,
        tree: Any,
        data_offsets: Optional[Dict[str, int]] = None,
        extra: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Async checkpoint: snapshot + enqueue, return immediately. `step`
        is the NEXT step to run on resume (save(step + 1, ...) after
        finishing step)."""
        self.state.step = int(step)
        if data_offsets is not None:
            self.state.data_offsets.update(
                {str(k): int(v) for k, v in data_offsets.items()}
            )
        if extra is not None:
            self.state.extra.update(extra)
        self.writer.save(step, tree, self.state)

    def flush(self, timeout: float = 60.0) -> bool:
        return self.writer.flush(timeout)

    def close(self) -> None:
        self.writer.close()


def elastic_session(**kwargs) -> ElasticSession:
    """The session-cached ElasticSession for this training worker (one per
    incarnation; repeated calls return the same instance). Must be called
    from inside `train_loop_per_worker`. Raises when `kwargs` conflict
    with the cached session's construction parameters — silently handing a
    `mode='sharded'` caller a cached replicated-mode session would commit
    FSDP-style partitions under mode='replicated' meta, and a later
    world-size-changed restore would replace every rank's partition with
    rank 0's, corrupting the model with no error."""
    from ..session import get_session

    s = get_session()
    if s is None:
        raise RuntimeError(
            "elastic_session() called outside a training worker"
        )
    es = getattr(s, "elastic", None)
    if es is None:
        es = ElasticSession(**kwargs)
        s.elastic = es
    else:
        effective = {
            "root": es.root,
            "mode": es.writer.mode,
            "queue_depth": es.writer._q.maxsize,
            "keep": es.writer.keep,
        }
        for k, v in kwargs.items():
            if k == "root" and v is None:
                continue
            if k == "queue_depth":
                v = max(1, v)  # the writer clamps its queue the same way
            if k in effective and effective[k] != v:
                raise RuntimeError(
                    f"elastic_session({k}={v!r}) conflicts with the "
                    f"already-created session's {k}={effective[k]!r}; the "
                    "first call in the loop fixes the parameters"
                )
    return es


__all__ = [
    "AsyncShardWriter",
    "ShardedCheckpoint",
    "COMMIT_MARKER",
    "stage_root",
    "latest_common_committed",
    "ElasticState",
    "ElasticSession",
    "elastic_session",
    "GangSupervisor",
    "RestartDecision",
    "DEATH_EVENT_KINDS",
    "GEN_ENV",
]

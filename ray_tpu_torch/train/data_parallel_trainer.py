"""DataParallelTrainer — gang of workers running the same loop on data shards."""

from __future__ import annotations

import uuid
from typing import Any, Callable, Dict, Optional

from .backend_executor import Backend, BackendExecutor
from .base_trainer import BaseTrainer
from .config import RunConfig, ScalingConfig
from .result import Result


class CollectiveBackend(Backend):
    """Sets up a host-plane collective group over the gang so workers can
    allreduce out-of-jit arrays (role of Gloo in the reference)."""

    def __init__(self, group_name: Optional[str] = None):
        self.group_name = group_name or f"train_{uuid.uuid4().hex[:8]}"
        self._started_once = False

    def on_start(self, worker_group, scaling):
        if self._started_once:
            # Gang RESTART: the rendezvous actor still holds the dead
            # incarnation's round state (partial refs, tombstones, stale
            # membership) — a re-formed gang joining it would desync. Kill
            # it; the new members' init_collective_group recreates a fresh
            # one under the same name (and the world size may have shrunk
            # within the elasticity band).
            from .. import collective

            try:
                collective.destroy_collective_group(self.group_name)
            except Exception:  # noqa: BLE001 — already gone
                pass
        self._started_once = True
        if len(worker_group) > 1:
            worker_group.setup_collective(self.group_name)


class DataParallelTrainer(BaseTrainer):
    """Reference analog: `python/ray/train/data_parallel_trainer.py`.

    `train_loop_per_worker(config)` runs on every worker; inside it use
    `ray_tpu_torch.train.report/get_context/get_checkpoint`, the gang's collective
    group (`ray_tpu_torch.collective`, group name in config["collective_group"]),
    and `get_dataset_shard` for per-worker data.
    """

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[dict] = None,
        backend: Optional[Backend] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint=None,
    ):
        super().__init__(
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint,
        )
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = dict(train_loop_config or {})
        self.backend = backend or CollectiveBackend()

    def fit(self) -> Result:
        executor = BackendExecutor(
            self.backend,
            self.scaling_config,
            self.run_config,
            experiment_name=self.run_config.name or "train",
        )
        if self.resume_from_checkpoint is not None:
            executor._latest_checkpoint = self.resume_from_checkpoint
        if self.datasets:
            # Registered BEFORE start so gang restarts re-attach shards too.
            executor.set_datasets(self.datasets)
        # No explicit start(): run() performs the first start through the
        # same guarded path as restarts, so a member dying during the
        # INITIAL gang formation also consumes FailureConfig budget and
        # tears down the partial group instead of escaping fit().
        config = dict(self.train_loop_config)
        if isinstance(self.backend, CollectiveBackend):
            config.setdefault("collective_group", self.backend.group_name)
        try:
            result = executor.run(self.train_loop_per_worker, config)
        finally:
            executor.shutdown()
        return result

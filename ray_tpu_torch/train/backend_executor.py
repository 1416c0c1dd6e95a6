"""BackendExecutor — orchestrates a training worker gang.

Reference analog: `python/ray/train/_internal/backend_executor.py:65`
(`start` `:124`, `start_training` `:438`): create WorkerGroup, let the
backend configure the gang (the reference runs `dist.init_process_group`;
our JaxBackend assembles mesh env instead), push the user loop, poll
results, manage checkpoints.

Failure policy (train/elastic, ISSUE 4): gang semantics — one worker dies →
the WHOLE group aborts and restarts (SURVEY.md §7 hard parts). `run()`
loops on GangSupervisor verdicts: every failure (a worker-reported error, a
failed actor call, or a controller death event the supervisor saw first)
becomes a `_WorkerGroupError`; the supervisor aborts the mesh within its
deadline (collectives interrupted, no wedged barrier), decides
restart/shrink/stop against its budget + backoff, and the gang re-forms —
restoring from the latest committed checkpoint with the elasticity band
applied to the new world size.

The MPMD pipeline trainer (`ray_tpu_torch.train.mpmd.trainer`) runs the same
supervisor-verdict loop for its S x dp stage gang — watch -> abort (every
stage's collective group) -> budget/backoff -> reshape (dp re-picked from
feasible capacity) -> restore from the pipeline's common committed step —
with per-stage checkpoint directories instead of this executor's single
gang root.
"""

from __future__ import annotations

import logging
import time
import uuid
from dataclasses import replace
from typing import Any, Callable, Dict, List, Optional

from .checkpoint import CheckpointManager
from .config import FailureConfig, RunConfig, ScalingConfig
from .result import Result
from .worker_group import WorkerGroup


class Backend:
    """Per-framework gang setup hook (reference: `BackendConfig`/`Backend`)."""

    def on_start(self, worker_group: WorkerGroup, scaling: ScalingConfig):
        pass

    def on_shutdown(self, worker_group: WorkerGroup):
        pass


class BackendExecutor:
    def __init__(
        self,
        backend: Backend,
        scaling: ScalingConfig,
        run_config: RunConfig,
        experiment_name: str = "train",
    ):
        self.backend = backend
        self.scaling = scaling
        self.run_config = run_config
        self.experiment_name = experiment_name
        self.worker_group: Optional[WorkerGroup] = None
        # Raw datasets + shards; shards are re-split on every (re)start so
        # gang restarts — including elastic shrinks — keep data coverage.
        self._datasets: Optional[Dict[str, Any]] = None
        self.dataset_shards: Optional[Dict[str, list]] = None
        # Gang incarnation token: one per start(); all ranks of one
        # incarnation share it (elastic checkpoint dirs are keyed by it so
        # two incarnations can never mix shards into one checkpoint).
        self.elastic_gen: str = "0"
        # Run-identity namespace for the elastic checkpoint root: stable
        # across this run's gang restarts, but distinct between runs. A
        # NAMED run keeps its name (elastic resume across driver restarts
        # is then opt-in and explicit, like resume_latest); an unnamed run
        # gets a fresh token so two unrelated runs sharing the default
        # storage path can never silently restore each other's weights.
        self.elastic_run_ns: str = (
            run_config.name or f"anon-{uuid.uuid4().hex[:8]}"
        )
        storage = run_config.resolve_storage()
        ckpt_cfg = run_config.checkpoint_config
        self.checkpoint_manager = CheckpointManager(
            storage,
            num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order,
        )
        self._latest_checkpoint = None
        self._supervisor = None
        # Absolute poll-entry indices whose checkpoint was registered, per
        # incarnation (reset with the cursors in _run_once).
        self._ckpt_reg_idxs: set = set()

    def start(self):
        n = self.scaling.num_workers
        self.elastic_gen = uuid.uuid4().hex[:8]
        contexts = [
            dict(
                world_rank=i,
                world_size=n,
                local_rank=i,  # single-machine runtime; multi-node refines this
                node_rank=0,
                experiment_name=self.experiment_name,
                storage_path=self.run_config.resolve_storage(),
            )
            for i in range(n)
        ]
        self.worker_group = WorkerGroup(
            n,
            self.scaling.worker_resources(),
            contexts,
            self.scaling.placement_strategy,
        )
        # Rank env vars (reference: backend_executor.py:358).
        envs = [
            {
                "RAY_TPU_TRAIN_WORLD_RANK": str(i),
                "RAY_TPU_TRAIN_WORLD_SIZE": str(n),
                "RAY_TPU_TRAIN_ELASTIC_GEN": self.elastic_gen,
                "RAY_TPU_TRAIN_ELASTIC_RUN": self.elastic_run_ns,
            }
            for i in range(n)
        ]
        self.worker_group.set_env_all(envs)
        if self._latest_checkpoint is not None:
            self.worker_group.set_checkpoint_all(self._latest_checkpoint)
        if self._datasets:
            self._reshard_datasets(n)
            self._attach_shards()
        self.backend.on_start(self.worker_group, self.scaling)

    def set_datasets(self, datasets: Dict[str, Any]):
        # Split happens in start() (and on every restart) — splitting here
        # too would just be discarded by the start-time reshard.
        self._datasets = dict(datasets)

    def _reshard_datasets(self, n: int):
        self.dataset_shards = {}
        for name, ds in (self._datasets or {}).items():
            shards = (
                ds.streaming_split(n) if hasattr(ds, "streaming_split") else [ds] * n
            )
            self.dataset_shards[name] = shards

    def _attach_shards(self):
        import cloudpickle

        from ..core import api

        for name, shards in self.dataset_shards.items():
            for worker, shard in zip(self.worker_group.workers, shards):
                api.get(worker.execute.remote(cloudpickle.dumps(_shard_setter(name, shard))))

    def run(
        self,
        train_fn: Callable,
        config: Optional[dict],
        datasets: Optional[dict] = None,
    ) -> Result:
        from .elastic import GangSupervisor

        supervisor = GangSupervisor(
            self.scaling,
            self.run_config.failure_config,
            experiment_name=self.experiment_name,
        )
        self._supervisor = supervisor
        collective_group = getattr(self.backend, "group_name", None)
        # Metrics history survives gang restarts: the steps a dead
        # incarnation reported are part of the run's trajectory.
        history: List[Dict[str, Any]] = []
        # Set at failure time; recovery (death -> re-formed gang) is
        # recorded once the NEXT incarnation has started successfully.
        recovery_t0: Optional[float] = None
        while True:
            try:
                if self.worker_group is None:
                    self._start_guarded()
                supervisor.watch(
                    self.worker_group, collective_group=collective_group
                )
                if recovery_t0 is not None:
                    supervisor.record_recovery(time.monotonic() - recovery_t0)
                    recovery_t0 = None
                result = self._run_once(train_fn, config, supervisor, history)
                supervisor.stop_watch()
                return result
            except _WorkerGroupError as e:
                if recovery_t0 is None:
                    recovery_t0 = time.monotonic()
                # Abort the ENTIRE mesh first (interrupt collectives, kill
                # survivors) — a member blocked on a dead peer must never
                # wedge until the round timeout.
                supervisor.abort_mesh(self.worker_group)
                self.worker_group = None
                decision = supervisor.on_failure(str(e))
                if decision.stop:
                    if (
                        e.during_start
                        and not history
                        and self.checkpoint_manager.latest() is None
                        and e.__cause__ is not None
                    ):
                        raise e.__cause__
                    logging.getLogger(__name__).error(
                        "gang failed permanently after %d attempt(s): %s",
                        supervisor.attempts, e,
                    )
                    return Result(
                        metrics=dict(history[-1]) if history else {},
                        checkpoint=self.checkpoint_manager.latest(),
                        error=str(e),
                        metrics_history=history,
                        path=self.run_config.resolve_storage(),
                    )
                # Gang restart: restore from the latest checkpoint (or the
                # original resume checkpoint when the failure predates any
                # new one), optionally shrunk within the elasticity band,
                # after the decided backoff. The start itself happens at
                # the loop top so a member dying MID-START consumes budget
                # like any other gang failure instead of escaping run().
                self._latest_checkpoint = (
                    self.checkpoint_manager.latest() or self._latest_checkpoint
                )
                # Every restart is logged: with max_failures=-1 a
                # deterministic failure retries forever, and a silent loop
                # would be indistinguishable from a hung run.
                logging.getLogger(__name__).warning(
                    "gang failure (%s) — restart attempt %d/%s after %.1fs",
                    e, supervisor.attempts,
                    "inf" if self.run_config.failure_config.max_failures < 0
                    else self.run_config.failure_config.max_failures,
                    decision.backoff_s,
                )
                if decision.backoff_s > 0:
                    time.sleep(decision.backoff_s)
                # World size is planned AFTER the backoff: the dead gang's
                # resources need the teardown to drain before a feasibility
                # reading means anything.
                world = supervisor.plan_world_size()
                if world and world != self.scaling.num_workers:
                    self.scaling = replace(self.scaling, num_workers=world)
                    supervisor.scaling = self.scaling

    def _start_guarded(self):
        """start() with gang-failure semantics: a member dying mid-start
        (env push, checkpoint broadcast, backend hook) tears down the
        partial group and surfaces as _WorkerGroupError so the elastic
        policy loop owns it."""
        try:
            self.start()
        except Exception as e:  # noqa: BLE001
            if self.worker_group is not None:
                try:
                    self.worker_group.shutdown()
                except Exception:  # noqa: BLE001
                    pass
                self.worker_group = None
            err = _WorkerGroupError(f"gang start failed: {e!r}")
            err.during_start = True
            raise err from e

    def _run_once(self, train_fn, config, supervisor=None, history=None) -> Result:
        if self.worker_group is None:
            self._start_guarded()
        wg = self.worker_group
        try:
            wg.run_async(train_fn, config)
        except Exception as e:  # noqa: BLE001 — a member died before launch
            raise _WorkerGroupError(f"gang launch failed: {e!r}") from e

        history = history if history is not None else []
        # Seed from the accumulated history: a restarted gang that resumes
        # exactly past the final step reports nothing, and Result.metrics
        # must still reflect the run's last reported step.
        last_metrics: Dict[str, Any] = dict(history[-1]) if history else {}
        # Cursor-based polls: reads are idempotent, so a poll RESPONSE lost
        # in flight (the batched get raising because a sibling died mid-
        # round) loses nothing — the salvage pass re-reads the survivors
        # from the last acknowledged cursor before the gang is aborted.
        cursors = [0] * len(wg)
        self._ckpt_reg_idxs = set()  # per-incarnation, like the cursors
        while True:
            # The supervisor usually sees a controller death event before a
            # poll call fails — surface it as the same gang failure.
            if supervisor is not None:
                reason = supervisor.failure()
                if reason:
                    self._salvage_polls(wg, cursors, history)
                    raise _WorkerGroupError(f"gang member died ({reason})")
            try:
                polls = wg.poll(cursors)
            except Exception as e:  # noqa: BLE001 — actor call failed (death)
                self._salvage_polls(wg, cursors, history)
                raise _WorkerGroupError(f"gang poll failed: {e!r}") from e
            # Align result batches across workers; rank-0 metrics win
            # (reference semantics: all workers report, rank 0 is canonical).
            try:
                consumed = self._consume_batches(
                    [p[0] for p in polls], history, offsets=cursors
                )
            except Exception as e:  # noqa: BLE001 — driver-side ckpt I/O
                # A checkpoint-registration failure (disk full, unwritable
                # storage) must flow through the SAME abort path as a gang
                # death: escaping run() raw would skip abort_mesh and leave
                # the (healthy, still-running) members wedged in their next
                # collective round. No salvage here — re-reading the same
                # window would just re-raise, and duplicate the entries
                # already appended to history.
                raise _WorkerGroupError(
                    f"checkpoint registration failed: {e!r}"
                ) from e
            if consumed is not None:
                last_metrics = consumed
            for i, p in enumerate(polls):
                cursors[i] += len(p[0])
            errors = [p[2] for p in polls if p[2]]
            if errors:
                raise _WorkerGroupError("; ".join(errors))
            if all(p[1] for p in polls):
                break
            time.sleep(0.05)

        return Result(
            metrics=last_metrics,
            checkpoint=self.checkpoint_manager.latest(),
            metrics_history=history,
            path=self.run_config.resolve_storage(),
        )

    def _consume_batches(self, batches, history, offsets=None):
        """Rank-0-canonical consumption of one poll window, aligned by
        ABSOLUTE entry index (`offsets[i]` = worker i's cursor at poll
        time): every member reports once per step from the same resumed
        step, so offset+position identifies the step even when the members
        drain unevenly across windows — positional pairing would drift by
        a constant once cursors diverge. This is the ONE place the policy
        lives; steady-state and salvage must agree. Rank 0's metrics drive
        history; a checkpoint comes from rank 0's entry or, at the same
        absolute index, from the first sibling carrying one — including
        indices rank 0 hasn't reached, because the caller acks (and trims)
        every worker's entries afterwards, so a checkpoint skipped here
        would be dropped forever. `_ckpt_reg_idxs` (reset per incarnation
        with the cursors) stops rank 0's later copy of an already-
        registered sibling checkpoint from landing twice. `batches[i]` is
        worker i's report list (None for an unreachable member). Returns
        the last rank-0 metrics consumed, or None."""
        offs = offsets or [0] * len(batches)
        rank0 = batches[0] or []
        last = None
        lo = min((offs[i] for i, b in enumerate(batches) if b), default=0)
        hi = max((offs[i] + len(b) for i, b in enumerate(batches) if b),
                 default=0)
        for idx in range(lo, hi):
            metrics = ckpt = None
            j0 = idx - offs[0]
            in_rank0 = 0 <= j0 < len(rank0)
            if in_rank0:
                entry = rank0[j0]
                metrics = entry["metrics"]
                ckpt = entry.get("checkpoint")
            if ckpt is None:
                for i, b in enumerate(batches[1:], start=1):
                    j = idx - offs[i]
                    if b and 0 <= j < len(b) and b[j].get("checkpoint"):
                        ckpt = b[j]["checkpoint"]
                        if metrics is None:
                            metrics = b[j]["metrics"]
                        break
            if ckpt is not None and idx not in self._ckpt_reg_idxs:
                self.checkpoint_manager.register(ckpt, metrics or {})
                self._ckpt_reg_idxs.add(idx)
            if in_rank0:
                history.append(metrics)
                last = metrics
        return last

    def _salvage_polls(self, wg, cursors, history):
        """Final drain of SURVIVING members' unconsumed reports before the
        mesh is aborted: rank 0 is the canonical metrics source, and the
        steps it reported between the last good poll and the sibling's
        death would otherwise vanish with the failed poll response —
        leaving a hole in the step trajectory that the post-restore re-run
        (which resumes from the last committed checkpoint, possibly past
        those steps) never fills.

        When rank 0 ITSELF is the casualty, its unpolled reports died with
        its process — so here (and only here: no further poll will ever
        deliver them) the hole is filled from the lowest surviving rank,
        aligned by absolute entry index (every member reports once per step
        from the same resumed step, so cursor+offset identifies the step
        regardless of how unevenly the main loop drained the members).
        Best-effort by nature: a step whose entry was already acked on
        every survivor before rank 0's copy arrived stays lost."""
        from ..core import api

        # Every survivor is drained, not just rank 0: the main loop's
        # checkpoint fallback scans polls[1:] when rank 0's entry carries
        # none, so non-rank-0 checkpoint reports are a supported shape the
        # salvage window must not drop (and when rank 0 IS the casualty,
        # the siblings' reports are all there is).
        # All polls submitted up front, then collected against ONE shared
        # deadline: the RPCs run concurrently, so a gang with several
        # unreachable members pays the deadline once, not per member. The
        # salvage pass sits between failure detection and abort_mesh(), so
        # it gets at most HALF the abort budget — the abort itself must
        # still fit in the rest.
        budget = self.run_config.failure_config.abort_deadline_s
        deadline = time.monotonic() + min(5.0, budget / 2)
        refs = [w.poll.remote(cursors[i]) for i, w in enumerate(wg.workers)]
        polls = []
        for ref in refs:
            try:
                res, _, _ = api.get(
                    ref, timeout=max(0.1, deadline - time.monotonic())
                )
            except Exception:  # noqa: BLE001 — this member is the casualty
                res = None
            polls.append(res)
        # Best-effort by contract: a checkpoint-registration failure here
        # must not replace the pending _WorkerGroupError (the caller raises
        # it right after this) — swallowing keeps the abort path intact.
        try:
            self._consume_batches(polls, history, offsets=cursors)
            if polls[0] is None:
                self._backfill_history(polls, cursors, history)
        except Exception as e:  # noqa: BLE001
            logging.getLogger(__name__).warning(
                "salvage drain failed, some final reports lost: %r", e
            )

    def _backfill_history(self, polls, cursors, history):
        """Rank 0 unreachable at salvage: extend history past rank 0's
        consumed prefix with the lowest surviving rank's entries for each
        missing absolute index (see _salvage_polls docstring). Checkpoints
        were already registered by _consume_batches's sibling scan."""
        by_abs: Dict[int, Any] = {}
        for i, res in enumerate(polls[1:], start=1):
            for j, entry in enumerate(res or ()):
                by_abs.setdefault(cursors[i] + j, entry)
        idx = cursors[0]  # rank 0's next-unconsumed absolute entry index
        while idx in by_abs:
            history.append(by_abs[idx]["metrics"])
            idx += 1

    def shutdown(self):
        if self._supervisor is not None:
            self._supervisor.stop_watch()
        if self.worker_group is not None:
            self.backend.on_shutdown(self.worker_group)
            self.worker_group.shutdown()
            self.worker_group = None


class _WorkerGroupError(RuntimeError):
    # True when raised from _start_guarded: the gang never came up, so on
    # budget exhaustion with zero training progress the ORIGINAL exception
    # (an unsatisfiable ScalingConfig, a backend hook ImportError, ...) is
    # re-raised out of fit() instead of being folded into Result.error —
    # deterministic config errors must stay loud.
    during_start = False


def _shard_setter(name, shard):
    def setter():
        from .session import get_session

        s = get_session()
        if s is not None:
            s.context.dataset_shards[name] = shard
        return True

    return setter

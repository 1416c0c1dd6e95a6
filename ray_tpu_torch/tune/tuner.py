"""Tuner + TuneController (reference: `python/ray/tune/tuner.py`,
`tune/execution/tune_controller.py:72` — the event loop at `step` `:709`).

Trials run as TrainWorker actors (shared mechanism with ray_tpu_torch.train —
the reference likewise funnels Train through Tune trial actors,
`base_trainer.py:839`); the controller polls results, drives the scheduler
(ASHA/PBT/...), the searcher, and checkpoint bookkeeping.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from ..core import api
from ..train.checkpoint import Checkpoint
from ..train.config import RunConfig
from ..train.result import Result
from .schedulers import CONTINUE, STOP, FIFOScheduler, PopulationBasedTraining, TrialScheduler
from .search import BUSY, BasicVariantGenerator, Searcher


@dataclasses.dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Optional[TrialScheduler] = None
    search_alg: Optional[Searcher] = None
    trial_resources: Optional[Dict[str, float]] = None


class Trial:
    def __init__(self, trial_id: str, config: Dict[str, Any]):
        self.trial_id = trial_id
        self.config = config
        self.state = "PENDING"
        self.actor = None
        self.results: List[Dict[str, Any]] = []
        self.latest_checkpoint: Optional[Checkpoint] = None
        self.error: Optional[str] = None
        self.iteration = 0

    @property
    def last_result(self) -> Dict[str, Any]:
        return self.results[-1] if self.results else {}


class TuneController:
    def __init__(
        self,
        trainable: Callable,
        tune_config: TuneConfig,
        run_config: RunConfig,
        param_space: Dict[str, Any],
        restore_state: Optional[dict] = None,
    ):
        self.trainable = trainable
        self.tune_config = tune_config
        self.run_config = run_config
        self.metric = tune_config.metric
        self.mode = tune_config.mode
        self.searcher = tune_config.search_alg or BasicVariantGenerator(
            param_space, num_samples=tune_config.num_samples
        )
        self.scheduler = tune_config.scheduler or FIFOScheduler()
        if self.metric:
            self.searcher.set_objective(self.metric, self.mode)
            self.scheduler.set_objective(self.metric, self.mode)
        self.trials: List[Trial] = []
        self._trial_counter = itertools.count()
        self._exhausted = False
        if restore_state is not None:
            # Experiment-level resume (reference:
            # `tune/execution/experiment_state.py` + `Tuner.restore`):
            # terminal trials keep their results; interrupted ones re-run
            # from their latest checkpoint with their original config.
            self.searcher = restore_state["searcher"]
            self._exhausted = restore_state["exhausted"]
            for td in restore_state["trials"]:
                trial = Trial(td["trial_id"], td["config"])
                trial.results = td["results"]
                trial.latest_checkpoint = td["latest_checkpoint"]
                trial.error = td["error"]
                trial.iteration = td["iteration"]
                trial.state = (
                    td["state"] if td["state"] in ("TERMINATED", "ERROR")
                    else "RESTORE_PENDING"
                )
                self.trials.append(trial)
                if trial.state == "RESTORE_PENDING":
                    self.scheduler.on_trial_add(trial)

    # ---------------------------------------------------- experiment state
    def _state_path(self) -> str:
        import os

        exp_dir = self.run_config.resolve_storage()  # already .../<name>
        os.makedirs(exp_dir, exist_ok=True)
        return os.path.join(exp_dir, "experiment_state.pkl")

    def _save_experiment_state(self):
        import os

        import cloudpickle

        state = {
            "searcher": self.searcher,
            "exhausted": self._exhausted,
            "metric": self.metric,
            "mode": self.mode,
            "trials": [
                {
                    "trial_id": t.trial_id,
                    "config": t.config,
                    "state": t.state,
                    "results": t.results,
                    "latest_checkpoint": t.latest_checkpoint,
                    "error": t.error,
                    "iteration": t.iteration,
                }
                for t in self.trials
            ],
        }
        path = self._state_path()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            cloudpickle.dump(state, f)
        os.replace(tmp, path)

    # ------------------------------------------------------------- lifecycle
    def _next_trial(self):
        # Interrupted-then-restored trials launch before new suggestions.
        for t in self.trials:
            if t.state == "RESTORE_PENDING":
                t.state = "PENDING"
                return t
        if self._exhausted:
            return None
        trial_id = f"trial_{next(self._trial_counter):05d}_{uuid.uuid4().hex[:6]}"
        config = self.searcher.suggest(trial_id)
        if config is BUSY:
            return BUSY  # throttled (ConcurrencyLimiter) — retry next tick
        if config is None:
            self._exhausted = True
            # Synchronous schedulers (HyperBand) resolve partially-filled
            # brackets once they know no more trials are coming.
            if hasattr(self.scheduler, "on_no_more_trials"):
                self.scheduler.on_no_more_trials()
            return None
        trial = Trial(trial_id, config)
        self.trials.append(trial)
        self.scheduler.on_trial_add(trial)
        return trial

    def _start_trial(self, trial: Trial, checkpoint: Optional[Checkpoint] = None):
        import cloudpickle

        from ..train.worker_group import TrainWorker

        resources = self.tune_config.trial_resources or {"CPU": 1.0}
        remote_cls = api.remote(TrainWorker)
        trial.actor = remote_cls.options(
            num_cpus=resources.get("CPU", 1.0),
            # reference: num_tpus=resources.get("TPU") or None, ray_tpu/tune/tuner.py:169
            num_gpus=resources.get("GPU") or None,
        ).remote(
            dict(
                world_rank=0,
                world_size=1,
                trial_id=trial.trial_id,
                trial_name=trial.trial_id,
                experiment_name=self.run_config.name or "tune",
                storage_path=self.run_config.resolve_storage(),
            )
        )
        if checkpoint is not None:
            api.get(trial.actor.set_checkpoint.remote(checkpoint))
            trial.latest_checkpoint = checkpoint
        api.get(
            trial.actor.run.remote(cloudpickle.dumps((self.trainable, trial.config)))
        )
        trial.state = "RUNNING"

    def _stop_trial(self, trial: Trial, state: str = "TERMINATED"):
        trial.state = state
        if trial.actor is not None:
            try:
                api.kill(trial.actor)
            except Exception:  # noqa: BLE001
                pass
            trial.actor = None

    # ------------------------------------------------------------------ loop
    def run(self) -> List[Trial]:
        max_conc = self.tune_config.max_concurrent_trials or 4
        stop_criteria = self.run_config.stop or {}

        while True:
            running = [t for t in self.trials if t.state == "RUNNING"]
            # Launch up to the concurrency cap.
            while len(running) < max_conc:
                trial = self._next_trial()
                if trial is None or trial is BUSY:
                    break
                self._start_trial(trial, checkpoint=trial.latest_checkpoint)
                running.append(trial)
            if not running:
                break  # launch loop above already probed _next_trial

            for trial in running:
                try:
                    results, finished, err = api.get(trial.actor.poll.remote(), timeout=60)
                except Exception as e:  # noqa: BLE001 — actor/worker died
                    trial.error = str(e)
                    self._stop_trial(trial, "ERROR")
                    self.searcher.on_trial_complete(trial.trial_id, None)
                    continue
                decision = CONTINUE
                restarted = False
                for entry in results:
                    metrics = entry["metrics"]
                    trial.iteration += 1
                    metrics.setdefault("training_iteration", trial.iteration)
                    metrics["trial_id"] = trial.trial_id
                    trial.results.append(metrics)
                    if entry.get("checkpoint") is not None:
                        trial.latest_checkpoint = entry["checkpoint"]
                    hook = getattr(self.searcher, "on_trial_result", None)
                    if hook is not None:  # BOHB: rung results feed the model
                        hook(trial.trial_id, metrics)
                    d = self.scheduler.on_trial_result(trial, metrics)
                    if d == STOP:
                        decision = STOP
                    if self._hit_stop_criteria(metrics, stop_criteria):
                        decision = STOP
                    if decision == STOP:
                        # Don't record results past the stopping point — a
                        # fast loop may have queued many more already.
                        break
                    if isinstance(self.scheduler, PopulationBasedTraining):
                        if self._maybe_pbt(trial, metrics):
                            # The old actor was replaced — results/finished
                            # flags from this poll belong to the dead actor.
                            restarted = True
                            break
                if restarted:
                    continue
                if err:
                    trial.error = err
                    self._stop_trial(trial, "ERROR")
                    self.searcher.on_trial_complete(trial.trial_id, None)
                    self._save_experiment_state()
                elif decision == STOP or finished:
                    self._stop_trial(trial)
                    self.scheduler.on_trial_complete(trial, trial.last_result)
                    self.searcher.on_trial_complete(trial.trial_id, trial.last_result)
                    self._save_experiment_state()
            time.sleep(0.02)
        self._save_experiment_state()
        return self.trials

    def _hit_stop_criteria(self, metrics: Dict[str, Any], stop: Dict[str, Any]) -> bool:
        for key, bound in stop.items():
            v = metrics.get(key)
            if v is not None and v >= bound:
                return True
        return False

    def _maybe_pbt(self, trial: Trial, metrics: Dict[str, Any]) -> bool:
        """Returns True when the trial's actor was replaced."""
        pbt: PopulationBasedTraining = self.scheduler  # type: ignore[assignment]
        if not pbt.should_perturb(trial, metrics):
            return False
        target_id = pbt.exploit_target(trial)
        if target_id is None:
            return False
        target = next((t for t in self.trials if t.trial_id == target_id), None)
        if target is None or target.latest_checkpoint is None:
            return False
        # Exploit + explore: restart this trial from the target's checkpoint
        # with mutated hyperparams (reference: `pbt.py` _exploit).
        self._stop_trial(trial, "PAUSED")
        trial.config = pbt.explore(dict(target.config))
        self._start_trial(trial, checkpoint=target.latest_checkpoint)
        return True


# ------------------------------------------------------------------- public
class ResultGrid:
    def __init__(self, trials: List[Trial], metric: Optional[str], mode: str):
        self._trials = trials
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._trials)

    def __iter__(self):
        for t in self._trials:
            yield self._to_result(t)

    def _to_result(self, t: Trial) -> Result:
        return Result(
            metrics=t.last_result,
            checkpoint=t.latest_checkpoint,
            error=t.error,
            metrics_history=t.results,
        )

    def get_best_result(
        self, metric: Optional[str] = None, mode: Optional[str] = None
    ) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("Specify `metric` (no default set in TuneConfig)")
        sign = 1.0 if mode == "max" else -1.0

        def best_score(t: Trial):
            scores = [sign * r[metric] for r in t.results if metric in r]
            return max(scores) if scores else float("-inf")

        candidates = [t for t in self._trials if t.results]
        if not candidates:
            raise RuntimeError("No trial reported any results")
        return self._to_result(max(candidates, key=best_score))

    @property
    def errors(self):
        return [t.error for t in self._trials if t.error]

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([t.last_result for t in self._trials])


class Tuner:
    """Reference: `ray.tune.Tuner` — Tuner(trainable, param_space=...,
    tune_config=TuneConfig(...), run_config=RunConfig(...)).fit()."""

    def __init__(
        self,
        trainable: Callable,
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
    ):
        from ..train.base_trainer import BaseTrainer

        if isinstance(trainable, BaseTrainer):
            trainer = trainable
            param_space = param_space or {}

            def trainable_fn(config):  # Trainer-as-trainable (reference
                # `base_trainer.py:839 as_trainable`).
                from ..train.session import report as session_report

                loop_cfg = dict(getattr(trainer, "train_loop_config", {}) or {})
                loop_cfg.update(config.get("train_loop_config", config))
                trainer.train_loop_config = loop_cfg
                result = trainer.fit()
                if result.error:
                    raise RuntimeError(result.error)
                # Surface the inner run's history to the tune session so the
                # controller/scheduler see this trial's metrics.
                for i, metrics in enumerate(result.metrics_history):
                    last = i == len(result.metrics_history) - 1
                    session_report(
                        metrics, checkpoint=result.checkpoint if last else None
                    )

            self.trainable = trainable_fn
        else:
            self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()

    def fit(self) -> ResultGrid:
        controller = TuneController(
            self.trainable, self.tune_config, self.run_config,
            self.param_space, restore_state=getattr(self, "_restore_state", None),
        )
        trials = controller.run()
        return ResultGrid(trials, self.tune_config.metric, self.tune_config.mode)

    @classmethod
    def restore(
        cls,
        path: str,
        trainable: Callable,
        *,
        run_config: Optional[RunConfig] = None,
    ) -> "Tuner":
        """Resume an interrupted experiment from its directory (reference:
        `Tuner.restore` + `tune/execution/experiment_state.py`). Terminal
        trials keep their results; interrupted trials re-run from their
        latest checkpoint."""
        import os

        import cloudpickle

        state_file = (
            path if path.endswith(".pkl")
            else os.path.join(path, "experiment_state.pkl")
        )
        with open(state_file, "rb") as f:
            state = cloudpickle.load(f)
        name = os.path.basename(os.path.dirname(os.path.abspath(state_file)))
        rc = run_config or RunConfig(name=name)
        rc.name = rc.name or name
        tuner = cls(
            trainable,
            tune_config=TuneConfig(metric=state["metric"], mode=state["mode"]),
            run_config=rc,
        )
        tuner._restore_state = state
        return tuner


def run(
    trainable: Callable,
    config: Optional[Dict[str, Any]] = None,
    *,
    metric: Optional[str] = None,
    mode: str = "max",
    num_samples: int = 1,
    scheduler: Optional[TrialScheduler] = None,
    search_alg: Optional[Searcher] = None,
    stop: Optional[dict] = None,
    max_concurrent_trials: Optional[int] = None,
    **_ignored,
) -> ResultGrid:
    """Functional API (reference: `tune.run`)."""
    tuner = Tuner(
        trainable,
        param_space=config or {},
        tune_config=TuneConfig(
            metric=metric,
            mode=mode,
            num_samples=num_samples,
            scheduler=scheduler,
            search_alg=search_alg,
            max_concurrent_trials=max_concurrent_trials,
        ),
        run_config=RunConfig(stop=stop),
    )
    return tuner.fit()

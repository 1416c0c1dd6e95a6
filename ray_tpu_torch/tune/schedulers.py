"""Trial schedulers (reference: `python/ray/tune/schedulers/`): FIFO,
ASHA (async successive halving), HyperBand-lite, MedianStopping, PBT."""

from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    def set_objective(self, metric: str, mode: str):
        self.metric = metric
        self.mode = mode

    def on_trial_add(self, trial):
        """Called when a trial is created (before any result)."""

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial, result: Optional[Dict[str, Any]]):
        pass

    def _score(self, result: Dict[str, Any]) -> Optional[float]:
        v = result.get(self.metric)
        if v is None:
            return None
        return float(v) if self.mode == "max" else -float(v)


class FIFOScheduler(TrialScheduler):
    pass


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference: `schedulers/async_hyperband.py`): rungs at
    grace_period * reduction_factor^k; a trial reaching a rung is stopped if
    it is below the top-1/reduction_factor quantile of scores recorded there."""

    def __init__(
        self,
        time_attr: str = "training_iteration",
        grace_period: int = 1,
        reduction_factor: float = 3,
        max_t: int = 100,
        brackets: int = 1,
    ):
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        self._rungs: Dict[int, List[float]] = defaultdict(list)

    def _milestones(self):
        out = []
        t = self.grace_period
        while t < self.max_t:
            out.append(int(t))
            t *= self.rf
        return out

    def on_trial_result(self, trial, result):
        t = result.get(self.time_attr)
        score = self._score(result)
        if t is None or score is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        for milestone in self._milestones():
            if t == milestone:
                rung = self._rungs[milestone]
                rung.append(score)
                k = max(1, int(len(rung) / self.rf))
                cutoff = sorted(rung, reverse=True)[k - 1]
                if score < cutoff:
                    return STOP
        return CONTINUE


ASHAScheduler = AsyncHyperBandScheduler


class HyperBandScheduler(TrialScheduler):
    """Synchronous HyperBand (reference: `schedulers/hyperband.py`).

    Brackets trade initial budget against halving count; bracket k starts at
    budget max_t * eta^-k with capacity n_k = ceil((s_max+1)/(k+1)) * eta^k.
    Trials fill the MOST aggressive bracket (largest k: cheapest budget,
    most halvings) first — canonical HyperBand order. A rung resolves when
    its full population reported it: the bracket's capacity once the bracket
    is full, or its actual membership once the tuner signals no more trials
    are coming (`on_no_more_trials`) — partial runs still prune instead of
    degrading to random search."""

    def __init__(
        self,
        time_attr: str = "training_iteration",
        max_t: int = 81,
        reduction_factor: float = 3,
    ):
        self.time_attr = time_attr
        self.max_t = max_t
        self.eta = reduction_factor
        s_max = int(math.log(max_t) / math.log(reduction_factor))
        self._bracket_budgets = [
            int(max_t * self.eta ** -k) or 1 for k in range(s_max + 1)
        ]
        self._bracket_capacity = [
            math.ceil((s_max + 1) / (k + 1)) * int(self.eta ** k)
            for k in range(s_max + 1)
        ]
        self._fill_order = list(range(s_max, -1, -1))  # aggressive first
        self._assign: Dict[Any, int] = {}  # trial_id -> bracket
        self._counts: Dict[int, int] = defaultdict(int)
        self._exhausted = False
        # bracket -> milestone -> {trial_id: score}
        self._rungs: Dict[int, Dict[int, Dict[Any, float]]] = defaultdict(
            lambda: defaultdict(dict)
        )
        self._stopped: set = set()
        self._done: set = set()  # completed/errored — will never report again

    def on_trial_add(self, trial):
        if trial.trial_id in self._assign:
            return
        for k in self._fill_order:
            if self._counts[k] < self._bracket_capacity[k]:
                self._assign[trial.trial_id] = k
                self._counts[k] += 1
                return
        # All brackets full: start a new cycle in the most aggressive one
        # (extra entrants join its later rungs; capacities still gate
        # resolution, so over-full rungs resolve at capacity).
        k = self._fill_order[0]
        self._assign[trial.trial_id] = k
        self._counts[k] += 1

    def on_no_more_trials(self):
        """The searcher is exhausted: brackets are as full as they will ever
        get — resolve any rung whose whole current membership has reported."""
        self._exhausted = True
        for bracket in list(self._rungs):
            for milestone in list(self._rungs[bracket]):
                self._maybe_resolve(bracket, milestone)

    def _population(self, bracket: int) -> Optional[int]:
        cap = self._bracket_capacity[bracket]
        assigned = self._counts[bracket]
        if assigned >= cap:
            return cap
        if self._exhausted:
            return max(1, assigned)
        return None  # still filling — wait

    def _maybe_resolve(self, bracket: int, milestone: int):
        rung = self._rungs[bracket][milestone]
        population = self._population(bracket)
        if population is None:
            return
        # Members that completed/were stopped WITHOUT reporting this rung can
        # never fill it — don't wait for them.
        absent = sum(
            1
            for tid, b in self._assign.items()
            if b == bracket
            and tid not in rung
            and (tid in self._done or tid in self._stopped)
        )
        if len(rung) < max(1, population - absent):
            return
        live = {tid: sc for tid, sc in rung.items() if tid not in self._stopped}
        keep = max(1, int(len(rung) / self.eta))
        ranked = sorted(live, key=live.get, reverse=True)
        for tid in ranked[keep:]:
            self._stopped.add(tid)

    def _bracket_of(self, trial) -> int:
        self.on_trial_add(trial)  # direct-driven schedulers (tests) lack add
        return self._assign[trial.trial_id]

    def _milestones(self, bracket: int) -> List[int]:
        out = []
        t = self._bracket_budgets[bracket]
        while t < self.max_t:
            out.append(int(t))
            t *= self.eta
        return out

    def on_trial_result(self, trial, result):
        t = result.get(self.time_attr)
        score = self._score(result)
        if t is None or score is None:
            return CONTINUE
        if trial.trial_id in self._stopped:
            return STOP
        if t >= self.max_t:
            return STOP
        bracket = self._bracket_of(trial)
        # `t >= milestone`, recorded once per (trial, rung): reporting
        # cadences that step past the exact milestone still register.
        for milestone in self._milestones(bracket):
            if t >= milestone:
                rung = self._rungs[bracket][milestone]
                if trial.trial_id not in rung:
                    rung[trial.trial_id] = score
                    self._maybe_resolve(bracket, milestone)
                    if trial.trial_id in self._stopped:
                        return STOP
                else:
                    rung[trial.trial_id] = max(rung[trial.trial_id], score)
        return CONTINUE

    def on_trial_complete(self, trial, result):
        # A finished/errored trial can no longer report later rungs — mark it
        # absent so survivors' rungs still resolve without it.
        self._done.add(trial.trial_id)
        bracket = self._assign.get(trial.trial_id)
        if bracket is not None:
            for milestone in self._milestones(bracket):
                self._maybe_resolve(bracket, milestone)


class MedianStoppingRule(TrialScheduler):
    def __init__(self, time_attr: str = "training_iteration", grace_period: int = 1,
                 min_samples_required: int = 3):
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._best: Dict[Any, float] = {}

    def on_trial_result(self, trial, result):
        score = self._score(result)
        t = result.get(self.time_attr, 0)
        if score is None:
            return CONTINUE
        prev = self._best.get(trial.trial_id)
        self._best[trial.trial_id] = max(score, prev) if prev is not None else score
        if t < self.grace_period or len(self._best) < self.min_samples:
            return CONTINUE
        others = [v for k, v in self._best.items() if k != trial.trial_id]
        if not others:
            return CONTINUE
        median = sorted(others)[len(others) // 2]
        return STOP if self._best[trial.trial_id] < median else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: `schedulers/pbt.py`): every `perturbation_interval`
    the controller asks whether a trial should exploit a better one; the
    controller performs the checkpoint copy + restart, this class decides."""

    def __init__(
        self,
        time_attr: str = "training_iteration",
        perturbation_interval: int = 5,
        hyperparam_mutations: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        seed: Optional[int] = None,
    ):
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self._scores: Dict[Any, float] = {}
        self._last_perturb: Dict[Any, int] = {}
        self._rng = random.Random(seed)

    def on_trial_result(self, trial, result):
        score = self._score(result)
        if score is not None:
            self._scores[trial.trial_id] = score
        return CONTINUE

    def should_perturb(self, trial, result) -> bool:
        t = result.get(self.time_attr, 0)
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last < self.interval or len(self._scores) < 2:
            return False
        ranked = sorted(self._scores.items(), key=lambda kv: kv[1])
        n = len(ranked)
        k = max(1, int(n * self.quantile))
        bottom = {tid for tid, _ in ranked[:k]}
        if trial.trial_id in bottom:
            self._last_perturb[trial.trial_id] = t
            return True
        return False

    def exploit_target(self, trial):
        ranked = sorted(self._scores.items(), key=lambda kv: kv[1], reverse=True)
        k = max(1, int(len(ranked) * self.quantile))
        top = [tid for tid, _ in ranked[:k] if tid != trial.trial_id]
        return self._rng.choice(top) if top else None

    def explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from .search_space import Domain

        new = dict(config)
        for key, spec in self.mutations.items():
            if self._rng.random() < self.resample_prob or key not in new:
                if isinstance(spec, Domain):
                    new[key] = spec.sample(self._rng)
                elif isinstance(spec, list):
                    new[key] = self._rng.choice(spec)
                elif callable(spec):
                    new[key] = spec()
            else:
                factor = self._rng.choice([0.8, 1.2])
                if isinstance(new[key], (int, float)):
                    new[key] = type(new[key])(new[key] * factor)
        return new

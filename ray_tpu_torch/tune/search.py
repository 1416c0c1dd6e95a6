"""Search algorithms (reference: `python/ray/tune/search/`).

BasicVariantGenerator is the default (grid × random sampling). OptunaSearch /
HyperOptSearch adapt external libraries when installed (gated imports — the
environment may not carry them)."""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

from .search_space import Domain, resolve_grid, sample_variant


class Searcher:
    def set_objective(self, metric: str, mode: str):
        self.metric = metric
        self.mode = mode

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: Optional[Dict[str, Any]]):
        pass


class BasicVariantGenerator(Searcher):
    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1, seed=None):
        self.rng = random.Random(seed)
        self._queue: List[Dict[str, Any]] = []
        for variant in resolve_grid(param_space):
            for _ in range(num_samples):
                self._queue.append(sample_variant(variant, self.rng))

    @property
    def total(self) -> int:
        return len(self._queue)

    def suggest(self, trial_id):
        if not self._queue:
            return None
        return self._queue.pop(0)


# Sentinel: the searcher is THROTTLED (not exhausted) — the controller
# should try again later instead of concluding no more trials exist.
BUSY = object()


class TPESearch(Searcher):
    """NATIVE tree-structured Parzen estimator — an original implementation,
    NOT the optuna integration (use OptunaSearch when optuna is installed).
    Reference analog in spirit: `tune/search/optuna` (TPE sampler) /
    `tune/search/hyperopt`. Completed trials split into good/bad by the γ
    quantile; candidates sample near good observations and are scored by a
    kernel-density ratio good(x)/bad(x)."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 16,
                 seed=None, gamma: float = 0.25, n_candidates: int = 24,
                 min_observations: int = 6):
        self.param_space = param_space
        self.num_samples = num_samples
        self.rng = random.Random(seed)
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.min_observations = min_observations
        self._suggested = 0
        self._configs: Dict[str, Dict[str, Any]] = {}
        self._scores: List[tuple] = []  # (score, config)

    def _numeric_keys(self):
        from .search_space import LogUniform, RandInt, Uniform

        return {
            k: v for k, v in self.param_space.items()
            if isinstance(v, (Uniform, LogUniform, RandInt))
        }

    def _random_config(self) -> Dict[str, Any]:
        return sample_variant(
            next(iter(resolve_grid(self.param_space))), self.rng
        )

    def suggest(self, trial_id):
        if self._suggested >= self.num_samples:
            return None
        self._suggested += 1
        if len(self._scores) < self.min_observations:
            config = self._random_config()
        else:
            config = self._tpe_config()
        self._configs[trial_id] = config
        return config

    def _tpe_config(self) -> Dict[str, Any]:
        import math

        ordered = sorted(self._scores, key=lambda t: -t[0])
        n_good = max(1, int(len(ordered) * self.gamma))
        good = [c for _, c in ordered[:n_good]]
        bad = [c for _, c in ordered[n_good:]] or good

        numeric = self._numeric_keys()

        def density(configs, key, x, scale):
            # Gaussian KDE with a fixed bandwidth fraction of the range.
            s = 0.0
            for c in configs:
                v = c.get(key)
                if v is None:
                    continue
                d = (float(x) - float(v)) / scale
                s += math.exp(-0.5 * d * d)
            return s / max(len(configs), 1) + 1e-12

        best, best_ratio = None, float("-inf")
        for _ in range(self.n_candidates):
            # Sample near a random good observation (explore via mutation).
            base = dict(self.rng.choice(good))
            cand = self._random_config()
            for k, dom in numeric.items():
                lo, hi = _domain_bounds(dom)
                scale = max((hi - lo) * 0.2, 1e-9)
                center = float(base.get(k, cand[k]))
                v = self.rng.gauss(center, scale)
                cand[k] = _domain_clip(dom, v)
            ratio = 1.0
            for k, dom in numeric.items():
                lo, hi = _domain_bounds(dom)
                scale = max((hi - lo) * 0.25, 1e-9)
                ratio *= density(good, k, cand[k], scale) / density(
                    bad, k, cand[k], scale
                )
            if ratio > best_ratio:
                best, best_ratio = cand, ratio
        return best or self._random_config()

    def on_trial_complete(self, trial_id, result):
        config = self._configs.pop(trial_id, None)
        if config is None or result is None:
            return
        value = result.get(self.metric)
        if value is None:
            return
        score = float(value) if self.mode == "max" else -float(value)
        self._scores.append((score, config))


def _domain_bounds(dom):
    from .search_space import LogUniform, RandInt, Uniform

    if isinstance(dom, Uniform):
        return dom.low, dom.high
    if isinstance(dom, RandInt):
        return dom.low, dom.high - 1
    if isinstance(dom, LogUniform):
        import math

        return math.exp(dom.log_low), math.exp(dom.log_high)
    raise TypeError(type(dom))


def _domain_clip(dom, v):
    from .search_space import RandInt

    lo, hi = _domain_bounds(dom)
    v = min(max(v, lo), hi)
    return int(round(v)) if isinstance(dom, RandInt) else v


class BOHBSearch(TPESearch):
    """BOHB-STYLE bracketed search, natively implemented (reference analog:
    `tune/search/bohb/` + `schedulers/hb_bohb.py`): pair this searcher with
    the HyperBandScheduler — the model (TPE) learns from every rung report,
    not only terminal results, so later brackets start from informed
    configs. This is an original implementation, not the `hpbandster`
    integration."""

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]):
        """Rung-level observations feed the model early (BOHB's core idea)."""
        config = self._configs.get(trial_id)
        if config is None or result is None:
            return
        value = result.get(self.metric)
        if value is None:
            return
        score = float(value) if self.mode == "max" else -float(value)
        self._scores.append((score, config))

    def on_trial_complete(self, trial_id, result):
        # The final report already reached the model via on_trial_result —
        # scoring it again would double-weight terminal observations.
        self._configs.pop(trial_id, None)


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions from any searcher (reference:
    `tune/search/concurrency_limiter.py`). While at the cap, suggest()
    answers BUSY — throttled, not exhausted."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def set_objective(self, metric, mode):
        super().set_objective(metric, mode)
        self.searcher.set_objective(metric, mode)

    def suggest(self, trial_id):
        if len(self._live) >= self.max_concurrent:
            return BUSY
        config = self.searcher.suggest(trial_id)
        if config is not None and config is not BUSY:
            self._live.add(trial_id)
        return config

    def on_trial_result(self, trial_id, result):
        hook = getattr(self.searcher, "on_trial_result", None)
        if hook is not None:
            hook(trial_id, result)

    def on_trial_complete(self, trial_id, result):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result)


class OptunaSearch(Searcher):
    """Adapter over optuna TPE (reference: `search/optuna/optuna_search.py`).
    Requires optuna (not bundled); for a dependency-free alternative use the
    native TPESearch."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 8, seed=None):
        import optuna  # gated: raises if not installed

        self._optuna = optuna
        self.param_space = param_space
        self.num_samples = num_samples
        self._study = optuna.create_study(
            direction="maximize",
            sampler=optuna.samplers.TPESampler(seed=seed),
        )
        self._trials: Dict[str, Any] = {}
        self._suggested = 0

    def suggest(self, trial_id):
        from .search_space import Choice, LogUniform, RandInt, Uniform

        if self._suggested >= self.num_samples:
            return None
        self._suggested += 1
        otrial = self._study.ask()
        config = {}
        for k, v in self.param_space.items():
            if isinstance(v, Uniform):
                config[k] = otrial.suggest_float(k, v.low, v.high)
            elif isinstance(v, LogUniform):
                import math

                config[k] = otrial.suggest_float(
                    k, math.exp(v.log_low), math.exp(v.log_high), log=True
                )
            elif isinstance(v, RandInt):
                config[k] = otrial.suggest_int(k, v.low, v.high - 1)
            elif isinstance(v, Choice):
                config[k] = otrial.suggest_categorical(k, v.categories)
            elif isinstance(v, Domain):
                config[k] = v.sample(random.Random())
            else:
                config[k] = v
        self._trials[trial_id] = otrial
        return config

    def on_trial_complete(self, trial_id, result):
        otrial = self._trials.pop(trial_id, None)
        if otrial is None or result is None:
            return
        value = result.get(self.metric)
        if value is None:
            return
        score = float(value) if self.mode == "max" else -float(value)
        self._study.tell(otrial, score)

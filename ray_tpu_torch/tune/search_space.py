"""Search-space primitives (reference: `python/ray/tune/search/sample.py` +
`grid_search`). Samplers are plain objects resolved by the variant generator."""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low: float, high: float):
        import math

        self.log_low, self.log_high = math.log(low), math.log(high)

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self.log_low, self.log_high))


class QUniform(Domain):
    def __init__(self, low: float, high: float, q: float):
        self.low, self.high, self.q = low, high, q

    def sample(self, rng):
        value = rng.uniform(self.low, self.high)
        return round(value / self.q) * self.q


class RandInt(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class LogRandInt(Domain):
    def __init__(self, low: int, high: int):
        import math

        self.log_low, self.log_high = math.log(low), math.log(high)

    def sample(self, rng):
        import math

        return int(round(math.exp(rng.uniform(self.log_low, self.log_high))))


class Choice(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class RandN(Domain):
    def __init__(self, mean: float = 0.0, sd: float = 1.0):
        self.mean, self.sd = mean, sd

    def sample(self, rng):
        return rng.gauss(self.mean, self.sd)


class Function(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        return self.fn(None)


class GridSearch:
    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


# Public constructors (reference API names).
def uniform(low, high):
    return Uniform(low, high)


def loguniform(low, high):
    return LogUniform(low, high)


def quniform(low, high, q):
    return QUniform(low, high, q)


def randint(low, high):
    return RandInt(low, high)


def lograndint(low, high):
    return LogRandInt(low, high)


def choice(categories):
    return Choice(categories)


def randn(mean=0.0, sd=1.0):
    return RandN(mean, sd)


def sample_from(fn):
    return Function(fn)


def grid_search(values):
    return GridSearch(values)


def resolve_grid(space: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Expand grid_search entries into the cartesian product of variants."""
    import itertools

    grid_keys = [k for k, v in space.items() if isinstance(v, GridSearch)]
    if not grid_keys:
        return [dict(space)]
    grids = [space[k].values for k in grid_keys]
    variants = []
    for combo in itertools.product(*grids):
        v = dict(space)
        for k, val in zip(grid_keys, combo):
            v[k] = val
        variants.append(v)
    return variants


def sample_variant(variant: Dict[str, Any], rng: random.Random) -> Dict[str, Any]:
    out = {}
    for k, v in variant.items():
        if isinstance(v, Domain):
            out[k] = v.sample(rng)
        elif isinstance(v, dict):
            out[k] = sample_variant(v, rng)
        else:
            out[k] = v
    return out

"""ray_tpu_torch.tune — hyperparameter search (API parity: `ray.tune`, SURVEY.md
Appendix A: Tuner, TuneConfig, run, search-space ops, schedulers, searchers)."""

from ..train.checkpoint import Checkpoint
from ..train.session import get_checkpoint, get_context
from ..train.session import report as _session_report
from .schedulers import (
    ASHAScheduler,
    AsyncHyperBandScheduler,
    HyperBandScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from .search import (BOHBSearch, BasicVariantGenerator, ConcurrencyLimiter,
                     OptunaSearch, Searcher, TPESearch)
from .search_space import (
    choice,
    grid_search,
    lograndint,
    loguniform,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from .tuner import ResultGrid, TuneConfig, TuneController, Tuner, run


def report(metrics, checkpoint=None, **kw):
    """Report metrics from a trial (reference: `ray.tune.report` /
    `session.report`). Extra kwargs are folded into the metrics dict."""
    merged = dict(metrics or {})
    merged.update(kw)
    _session_report(merged, checkpoint=checkpoint)


__all__ = [
    "Tuner",
    "TuneConfig",
    "run",
    "report",
    "get_context",
    "get_checkpoint",
    "Checkpoint",
    "ResultGrid",
    "TuneController",
    "uniform",
    "loguniform",
    "quniform",
    "randint",
    "lograndint",
    "choice",
    "randn",
    "sample_from",
    "grid_search",
    "TrialScheduler",
    "FIFOScheduler",
    "ASHAScheduler",
    "AsyncHyperBandScheduler",
    "HyperBandScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "Searcher",
    "BasicVariantGenerator",
    "BOHBSearch",
    "ConcurrencyLimiter",
    "OptunaSearch",
    "TPESearch",
]

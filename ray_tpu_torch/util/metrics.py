"""User metrics API (reference: `python/ray/util/metrics.py` Counter/Gauge/
Histogram → OpenCensus → `metrics_agent.py` Prometheus). Redesign: metrics
push straight to the controller over the control plane and are served from
its `/metrics` HTTP endpoint (see address.json's metrics_url). Histograms
accumulate observations into configurable bucket boundaries CLIENT-side and
ship per-bucket deltas; the controller aggregates and emits real
`# TYPE <name> histogram` exposition (`_bucket{le=...}` / `_sum` /
`_count`), so `histogram_quantile()` works in Prometheus."""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# Default latency-shaped boundaries (seconds), reference-style.
DEFAULT_BOUNDARIES: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_FLUSH_INTERVAL_S = 0.25


def _backend():
    """The connected cluster backend, or None (never boots a runtime from a
    plain script — see api._runtime_or_attach); un-inited processes just
    keep metrics local."""
    from ..core import api

    rt = api._runtime_or_attach()
    return rt.backend if rt is not None else None


def prune_series(tags: Dict[str, str]) -> None:
    """Drop every exported series whose tags include all of `tags` (e.g.
    `{"replica": tag}` when a Serve replica drains) — dead components must
    not leave gauges frozen in /metrics until the staleness sweep."""
    backend = _backend()
    fn = getattr(backend, "prune_metrics", None) if backend else None
    if fn is not None:
        fn({str(k): str(v) for k, v in tags.items()})


def quantile(xs: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank quantile of a small sample (None when empty) — shared
    by the serve engine's telemetry (TTFT tails) and bench summaries so
    every surface reports the same number for the same window."""
    if not xs:
        return None
    s = sorted(xs)
    return float(s[min(len(s) - 1, int(len(s) * q))])


# Controller-HA observability families (the controller feeds these itself —
# it has no client backend to push through — but the names, boundaries, and
# help text live HERE so tests, docs, and dashboards share one definition;
# see Controller._self_observe / docs/CONTROL_PLANE_HA.md):
#   controller_recoveries_total   checkpoint+replay restores performed
#   controller_recovery_seconds   restore latency (snapshot load + WAL replay)
#   controller_log_bytes          live WAL size on disk (gauge; compaction
#                                 pulls it back down)
#   controller_log_fsync_seconds  per-batch WAL fsync latency
CONTROLLER_HA_BOUNDARIES: Dict[str, Tuple[float, ...]] = {
    "controller_recovery_seconds": (
        0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    ),
    "controller_log_fsync_seconds": (
        0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    ),
}
CONTROLLER_HA_HELP: Dict[str, str] = {
    "controller_recoveries_total":
        "Controller restores performed (checkpoint + WAL replay)",
    "controller_recovery_seconds":
        "Seconds one controller restore took (checkpoint load + log replay)",
    "controller_log_bytes":
        "Bytes of write-ahead event log currently on disk",
    "controller_log_fsync_seconds":
        "Seconds per batched WAL fsync",
}


_ELASTIC: Optional[Dict[str, "_Metric"]] = None
_ELASTIC_LOCK = threading.Lock()


def elastic_metrics() -> Dict[str, "_Metric"]:
    """Elastic-training metric families (train/elastic emits these):
    `elastic_restarts_total` counts gang restarts, `elastic_recovery_seconds`
    is the death-to-reformed-gang MTTR distribution, and
    `ckpt_save_overlap_seconds` is async-checkpoint write time hidden behind
    training steps. Created lazily so importing metrics never boots a
    runtime."""
    global _ELASTIC
    with _ELASTIC_LOCK:
        if _ELASTIC is None:
            _ELASTIC = {
                "elastic_restarts_total": Counter(
                    "elastic_restarts_total",
                    "Gang restarts performed by the elastic train supervisor",
                    tag_keys=("experiment",),
                ),
                "elastic_recovery_seconds": Histogram(
                    "elastic_recovery_seconds",
                    "Seconds from gang-member death to the re-formed gang "
                    "(elastic training MTTR)",
                    boundaries=(0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0),
                    tag_keys=("experiment",),
                ),
                "ckpt_save_overlap_seconds": Histogram(
                    "ckpt_save_overlap_seconds",
                    "Async checkpoint shard write seconds overlapped with "
                    "training (work the step did NOT stall on)",
                    boundaries=(0.001, 0.005, 0.025, 0.1, 0.5, 2.5, 10.0),
                    tag_keys=("experiment",),
                ),
            }
        return _ELASTIC


_RLLIB: Optional[Dict[str, "_Metric"]] = None
_RLLIB_LOCK = threading.Lock()


def rllib_metrics() -> Dict[str, "_Metric"]:
    """RL-training metric families (both podracer planes and the classic
    EnvRunner path feed these): `rllib_env_steps_total` counts sampled env
    transitions by plane, `rllib_learner_step_seconds` is the per-iteration
    learner/update latency distribution, and
    `rllib_actor_learner_queue_depth` is the Sebulba actor->learner
    trajectory queue depth (0 on fused planes — there is no queue). Created
    lazily so importing metrics never boots a runtime."""
    global _RLLIB
    with _RLLIB_LOCK:
        if _RLLIB is None:
            _RLLIB = {
                "rllib_env_steps_total": Counter(
                    "rllib_env_steps_total",
                    "Environment transitions sampled for training",
                    tag_keys=("plane",),
                ),
                "rllib_learner_step_seconds": Histogram(
                    "rllib_learner_step_seconds",
                    "Seconds per learner update step (one training "
                    "iteration's optimize call)",
                    boundaries=(
                        0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                        1.0, 2.5, 5.0, 10.0,
                    ),
                    tag_keys=("plane",),
                ),
                "rllib_actor_learner_queue_depth": Gauge(
                    "rllib_actor_learner_queue_depth",
                    "Trajectory frames produced by the Sebulba actor gang "
                    "not yet consumed by the learner",
                    tag_keys=("plane",),
                ),
            }
        return _RLLIB


_FLEET: Optional[Dict[str, "_Metric"]] = None
_FLEET_LOCK = threading.Lock()


def serve_fleet_metrics() -> Dict[str, "_Metric"]:
    """Fleet-serving metric families (the Serve controller emits these):
    `serve_autoscale_decisions_total` counts applied scale actions by
    direction, `serve_deployment_target_replicas` is each deployment's
    current autoscale target. Created lazily so importing metrics never
    boots a runtime."""
    global _FLEET
    with _FLEET_LOCK:
        if _FLEET is None:
            _FLEET = {
                "serve_autoscale_decisions_total": Counter(
                    "serve_autoscale_decisions_total",
                    "Autoscale actions applied by the Serve controller",
                    tag_keys=("deployment", "direction"),
                ),
                "serve_deployment_target_replicas": Gauge(
                    "serve_deployment_target_replicas",
                    "Current autoscale target replica count per deployment",
                    tag_keys=("deployment",),
                ),
            }
        return _FLEET


_TRAIN: Optional[Dict[str, "_Metric"]] = None
_TRAIN_LOCK = threading.Lock()


def train_metrics() -> Dict[str, "_Metric"]:
    """MPMD-training metric families (stage actors and the trainer driver
    feed these — before the flight-recorder PR, MPMD exported no
    Prometheus families at all): `train_stage_step_seconds` is the
    per-(stage, replica) busy+update time distribution per pipeline step,
    `train_pipeline_bubble_fraction` is the pipeline idle fraction by
    source ("trainer" = the driver's aggregate wall-clock formula,
    "flight" = the span-derived attribution from flight.pipeline_report —
    the two cross-check each other). Created lazily so importing metrics
    never boots a runtime."""
    global _TRAIN
    with _TRAIN_LOCK:
        if _TRAIN is None:
            _TRAIN = {
                "train_stage_step_seconds": Histogram(
                    "train_stage_step_seconds",
                    "Seconds of stage busy time (compute + optimizer "
                    "update) per pipeline step, per stage replica",
                    boundaries=(
                        0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                        1.0, 2.5, 5.0, 10.0, 30.0,
                    ),
                    tag_keys=("stage", "replica"),
                ),
                "train_pipeline_bubble_fraction": Gauge(
                    "train_pipeline_bubble_fraction",
                    "Fraction of the pipeline step spent idle "
                    "(1 - busy / (wall * stages * dp))",
                    tag_keys=("source",),
                ),
            }
        return _TRAIN


_FLIGHT: Optional[Dict[str, "_Metric"]] = None
_FLIGHT_LOCK = threading.Lock()


def flight_metrics() -> Dict[str, "_Metric"]:
    """Flight-recorder health families: `flight_spans_dropped_total`
    counts ring-overflow drops per component (the same bounded-cap +
    single-marker accounting as task_events_dropped). Created lazily so
    importing metrics never boots a runtime."""
    global _FLIGHT
    with _FLIGHT_LOCK:
        if _FLIGHT is None:
            _FLIGHT = {
                "flight_spans_dropped_total": Counter(
                    "flight_spans_dropped_total",
                    "Flight-recorder spans dropped to ring overflow "
                    "(death-kind spans are exempt from the cap)",
                    tag_keys=("component",),
                ),
            }
        return _FLIGHT


class _Metric:
    kind = "gauge"

    def __init__(self, name: str, description: str = "", tag_keys: Tuple[str, ...] = ()):
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _record(self, value: float, tags: Optional[Dict[str, str]]):
        # Same non-booting rule as Histogram._flush: a metric record from an
        # un-inited process is DROPPED, never a reason to boot a runtime
        # (an engine unit test driving step() used to leak a whole local
        # runtime into the test session through one Gauge.set).
        merged = {**self._default_tags, **(tags or {})}
        backend = _backend()
        send = getattr(backend, "record_metric", None) if backend else None
        if send is not None:
            send(self._name, self.kind, value, merged, help=self._description)


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value <= 0:
            raise ValueError("Counter increments must be positive")
        self._record(value, tags)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        self._record(value, tags)


class _Flusher:
    """One daemon thread per process ships every histogram's pending bucket
    deltas every _FLUSH_INTERVAL_S — observations stay a lock-guarded local
    accumulate (no control-plane message per observe), and the tail of a
    burst still lands without requiring another observe to piggyback on."""

    def __init__(self):
        self._lock = threading.Lock()
        self._histograms: List["Histogram"] = []
        self._thread: Optional[threading.Thread] = None

    def register(self, hist: "Histogram"):
        with self._lock:
            if hist not in self._histograms:
                self._histograms.append(hist)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="metrics-flusher"
                )
                self._thread.start()

    def _loop(self):
        while True:
            time.sleep(_FLUSH_INTERVAL_S)
            with self._lock:
                hists = list(self._histograms)
            for h in hists:
                try:
                    h._flush()
                except Exception:  # noqa: BLE001 — metrics never load-bearing
                    pass


_FLUSHER = _Flusher()


class Histogram(_Metric):
    """Bucketed distribution metric. `observe()` accumulates into
    `boundaries` client-side; deltas ship to the controller, which exposes
    cumulative `<name>_bucket{le=...}`, `<name>_sum`, `<name>_count`
    Prometheus series (percentile-capable via `histogram_quantile()`)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        description: str = "",
        boundaries: Optional[Sequence[float]] = None,
        tag_keys: Tuple[str, ...] = (),
    ):
        super().__init__(name, description, tag_keys)
        bounds = tuple(float(b) for b in (boundaries or DEFAULT_BOUNDARIES))
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram boundaries must be sorted/unique: {bounds}")
        self.boundaries = bounds
        self._plock = threading.Lock()
        # tags-key -> [bucket deltas (len = len(bounds)+1, last = +Inf),
        #              sum delta, count delta]
        self._pending: Dict[Tuple[Tuple[str, str], ...], list] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        value = float(value)
        merged = {**self._default_tags, **(tags or {})}
        key = tuple(sorted((str(k), str(v)) for k, v in merged.items()))
        idx = bisect.bisect_left(self.boundaries, value)  # le semantics
        with self._plock:
            acc = self._pending.get(key)
            if acc is None:
                acc = self._pending[key] = [[0] * (len(self.boundaries) + 1), 0.0, 0]
            acc[0][idx] += 1
            acc[1] += value
            acc[2] += 1
        _FLUSHER.register(self)

    def _flush(self):
        with self._plock:
            if not self._pending:
                return
            backend = _backend()
            send = getattr(backend, "record_metric", None) if backend else None
            if send is None:
                return  # keep accumulating; deltas are bounded per tag-set
            pending, self._pending = self._pending, {}
        for key, (buckets, total, count) in pending.items():
            send(
                self._name, "histogram", 0.0, dict(key),
                boundaries=list(self.boundaries), buckets=buckets,
                sum=total, count=count, help=self._description,
            )

"""Cluster flight recorder: a lock-light per-process ring of spans.

Reference analog: TorchTitan's flight recorder + Ray's Dapper-style
timeline. The tracing plane (util/tracing.py) ships *wall-clock* span
events straight into the controller timeline; that is fine for
request-scale spans (milliseconds and up) but useless for the hot paths
we now claim numbers for — engine decode steps, 1F1B microbatch slots,
bulk span pulls — where shipping an RPC per span would dwarf the thing
being measured. The flight recorder closes that gap:

* ``record()`` is a bounded, lock-guarded list append of a small dict —
  no RPC, no allocation beyond the event itself. Timestamps are
  ``time.monotonic_ns()`` so adjacent spans in one process are honest to
  the nanosecond even when NTP steps the wall clock.
* The ring is bounded (``RAY_TPU_FLIGHT_CAP``) with an explicit drop
  counter, the same bounded-cap + single-marker pattern as the worker's
  ``task_events_dropped`` and the controller's ``actor_events_dropped``:
  overflow drops the NEWEST span and one ``flight_spans_dropped`` marker
  rides the next drain. Death-kind spans (``kind`` in ``death/abort``)
  are exempt from the cap — a storm must not evict the evidence.
* Spans leave the process three ways: a periodic flusher thread ships
  drained batches over the existing task_events channel
  (``tracing.record_events``); executing workers piggyback drained spans
  on their batched task_events flush; and the controller can poke every
  worker with a ``flight_pull`` push for an on-demand flush
  (``ray-tpu flight`` / ``GET /api/flight``).
* Cross-host merge is made honest by a clock offset measured at
  registration: both backends time the register RPC and take the
  RTT-midpoint against the controller's returned wall time
  (``set_clock_offset``), so ``wall()`` maps monotonic-ns into the
  *controller's* clock before spans ever leave the process.

Span events drained here are shaped exactly like ``tracing.span_event``
output (``event == "span"``) with ``args.lane`` marking them as flight
spans, so they merge into ``trace_forest`` / ``/api/traces`` for free;
``merged_chrome_trace`` additionally renders one Perfetto lane per
``lane`` key with flow arrows along each ``flow`` key (microbatches,
disagg handoffs) using the same crc32-stable ids as ``api.timeline``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import tracing

# Span kinds exempt from the ring cap: death/abort evidence must survive
# the storm that usually accompanies it.
DEATH_KINDS = frozenset({"death", "abort", "kill"})

_DEF_CAP = 8192
_DEF_FLUSH_S = 0.5


def enabled() -> bool:
    """Recorder master switch (``RAY_TPU_FLIGHT=0`` disables). Read from
    the environment on every call — it is one dict lookup, and the perf
    smoke test flips it per-subprocess."""
    return os.environ.get("RAY_TPU_FLIGHT", "1").lower() not in ("0", "false")


def now_ns() -> int:
    return time.monotonic_ns()


class FlightRecorder:
    """Bounded per-process span ring. All methods are thread-safe; the
    hot path (``record``) holds the lock only for a list append."""

    def __init__(self, cap: Optional[int] = None, component: str = ""):
        self.cap = int(cap if cap is not None
                       else os.environ.get("RAY_TPU_FLIGHT_CAP", _DEF_CAP))
        self.component = component or "proc"
        self._lock = threading.Lock()
        self._buf: List[Dict[str, Any]] = []
        self._dropped = 0
        # monotonic→wall anchor, taken once; clock_offset re-bases onto
        # the controller's clock (RTT-midpoint handshake at registration).
        self._anchor_wall = time.time()
        self._anchor_ns = time.monotonic_ns()
        self._offset = 0.0

    # ------------------------------------------------------------ clock
    def set_clock_offset(self, offset_s: float) -> None:
        """controller_wall ≈ local_wall + offset_s (RTT midpoint)."""
        self._offset = float(offset_s)

    @property
    def clock_offset(self) -> float:
        return self._offset

    def wall(self, ns: int) -> float:
        """Map a local monotonic-ns stamp onto the controller's clock."""
        return self._anchor_wall + (ns - self._anchor_ns) * 1e-9 + self._offset

    def cluster_time(self) -> float:
        """time.time() corrected onto the controller's clock."""
        return time.time() + self._offset

    # ------------------------------------------------------------- ring
    @property
    def dropped(self) -> int:
        return self._dropped

    def __len__(self) -> int:
        return len(self._buf)

    def record(
        self,
        name: str,
        t0_ns: int,
        t1_ns: int,
        *,
        trace: Optional[str] = None,
        lane: str = "",
        kind: str = "",
        flow: Optional[str] = None,
        attrs: Optional[Dict[str, Any]] = None,
        **extra: Any,
    ) -> None:
        """Append one span to the ring. ``t0_ns``/``t1_ns`` are
        ``now_ns()`` stamps; ``lane`` names the Perfetto row; ``flow``
        keys spans that should be connected by flow arrows. Any other
        keyword lands in ``args`` alongside ``attrs`` — instrumentation
        must never TypeError out of the code path it is measuring."""
        args: Dict[str, Any] = dict(attrs) if attrs else {}
        args.update(extra)
        args["lane"] = lane or self.component
        if kind:
            args["kind"] = kind
        if flow:
            args["flow"] = flow
        ev = {
            "ts": self.wall(t0_ns),
            "event": "span",
            "name": name,
            "dur": max((t1_ns - t0_ns) * 1e-9, 0.0),
            "trace": trace or "",
            "args": args,
        }
        with self._lock:
            if len(self._buf) >= self.cap and kind not in DEATH_KINDS:
                self._dropped += 1
                return
            self._buf.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, **kw):
        """``with rec.span("kv.import", trace=tid, lane="serve/engine"):``
        — records even when the body raises (the abort is the
        interesting span), tagging the exception type."""
        t0 = time.monotonic_ns()
        try:
            yield
        except BaseException as e:
            kw.setdefault("attrs", {})
            kw["attrs"] = {**kw["attrs"], "error": type(e).__name__}
            kw.setdefault("kind", "abort")
            self.record(name, t0, time.monotonic_ns(), **kw)
            raise
        self.record(name, t0, time.monotonic_ns(), **kw)

    def drain(self) -> List[Dict[str, Any]]:
        """Pop every buffered span (plus ONE drop marker if the ring
        overflowed since the last drain). Callers own shipping."""
        with self._lock:
            if not self._buf and not self._dropped:
                return []
            out, self._buf = self._buf, []
            dropped, self._dropped = self._dropped, 0
        if dropped:
            out.append({
                "ts": self.cluster_time(),
                "event": "flight_spans_dropped",
                "n": dropped,
                "component": self.component,
            })
            try:  # metrics may be unavailable in stripped-down procs
                from . import metrics as _m
                _m.flight_metrics()["flight_spans_dropped_total"].inc(
                    dropped, tags={"component": self.component})
            except Exception:
                pass
        return out

    def snapshot(self) -> List[Dict[str, Any]]:
        """Copy of the ring WITHOUT clearing — local analysis
        (pipeline_report on a run_local_pipeline) without racing the
        flusher's drain."""
        with self._lock:
            return list(self._buf)

    def requeue(self, events: List[Dict[str, Any]]) -> None:
        """Put drained events back (ship failed: no runtime yet). Excess
        beyond the cap is dropped and counted, same as record()."""
        with self._lock:
            room = self.cap - len(self._buf)
            keep = events[:max(room, 0)]
            self._dropped += len(events) - len(keep)
            self._buf = keep + self._buf


# -------------------------------------------------------- process singleton
_RECORDER: Optional[FlightRecorder] = None
_REC_LOCK = threading.Lock()
_FLUSHER: Optional[threading.Thread] = None


def recorder() -> FlightRecorder:
    global _RECORDER
    rec = _RECORDER
    if rec is None:
        with _REC_LOCK:
            rec = _RECORDER
            if rec is None:
                rec = _RECORDER = FlightRecorder()
    return rec


def _reset_for_tests() -> None:
    global _RECORDER
    with _REC_LOCK:
        _RECORDER = None


def set_clock_offset(offset_s: float) -> None:
    recorder().set_clock_offset(offset_s)


def set_component(name: str) -> None:
    recorder().component = name


def cluster_time() -> float:
    return recorder().cluster_time()


def record(name: str, t0_ns: int, t1_ns: int, **kw) -> None:
    """Module-level convenience: no-op when the recorder is disabled."""
    if enabled():
        recorder().record(name, t0_ns, t1_ns, **kw)
        ensure_flusher()


def span(name: str, **kw):
    """Context-manager convenience; a null context when disabled."""
    if not enabled():
        return contextlib.nullcontext()
    ensure_flusher()
    return recorder().span(name, **kw)


# ------------------------------------------------------------------ shipping
def _ship(events: List[Dict[str, Any]]) -> bool:
    """Ship drained events over the task_events channel. Returns False
    when no runtime is attachable (NEVER boots one — see
    api._runtime_or_attach) so the caller can requeue."""
    if not events:
        return True
    from ..core import api

    rt = api._runtime_or_attach()
    if rt is None:
        return False
    send = getattr(rt.backend, "record_trace_event", None)
    if send is None:
        return False
    try:
        send(events)
        return True
    except Exception:
        return False


def flush() -> int:
    """Drain the ring and ship it now. Returns the number of events
    shipped (0 if nothing buffered or no runtime to ship through)."""
    rec = recorder()
    events = rec.drain()
    if not events:
        return 0
    if not _ship(events):
        rec.requeue(events)
        return 0
    return len(events)


def ensure_flusher() -> None:
    """Start the periodic flusher daemon once per process. Workers also
    piggyback drains on their task_events flush; double-shipping cannot
    happen because drain() is an atomic pop-all."""
    global _FLUSHER
    if _FLUSHER is not None and _FLUSHER.is_alive():
        return
    with _REC_LOCK:
        if _FLUSHER is not None and _FLUSHER.is_alive():
            return
        period = float(os.environ.get("RAY_TPU_FLIGHT_FLUSH_S", _DEF_FLUSH_S))

        def loop():
            while True:
                time.sleep(period)
                try:
                    flush()
                except Exception:
                    pass

        _FLUSHER = threading.Thread(
            target=loop, name="flight-flusher", daemon=True)
        _FLUSHER.start()


# ------------------------------------------------------------ merged export
def _is_flight_span(ev: dict) -> bool:
    return ev.get("event") == "span" and bool((ev.get("args") or {}).get("lane"))


def merged_chrome_trace(
    events: List[dict], trace_id: Optional[str] = None
) -> List[dict]:
    """ONE Perfetto-loadable chrome trace merging the classic task/span
    timeline (chrome_trace_with_flows) with flight lanes: a pid per
    worker, a named tid per ``lane`` key, and flow arrows chaining spans
    that share a ``flow`` key (a microbatch through the pipeline, a
    disagg handoff across replicas). Lane/flow ids reuse the crc32
    machinery so repeated exports are byte-identical."""
    flight_evs, rest = [], []
    for ev in events:
        (flight_evs if _is_flight_span(ev) else rest).append(ev)
    if trace_id is not None:
        flight_evs = [e for e in flight_evs if e.get("trace") == trace_id]
    out = tracing.chrome_trace_with_flows(rest, trace_id)

    named: Dict[tuple, str] = {}
    flows: Dict[str, List[dict]] = {}
    for ev in flight_evs:
        args = ev.get("args") or {}
        pid = tracing._pid_for(ev.get("worker"))
        tid = tracing._lane(("flight", args["lane"]), 100000)
        named.setdefault((pid, None),
                         f"worker {ev['worker']}" if ev.get("worker")
                         else "driver")
        named.setdefault((pid, tid), str(args["lane"]))
        out.append({
            "name": ev.get("name", "span"), "ph": "X", "cat": "flight",
            "ts": ev["ts"] * 1e6, "dur": ev.get("dur", 0.0) * 1e6,
            "pid": pid, "tid": tid,
            "args": {**args, "trace": ev.get("trace") or None},
        })
        fkey = args.get("flow")
        if fkey:
            flows.setdefault(str(fkey), []).append(
                {"ts": ev["ts"], "pid": pid, "tid": tid})
    for fkey, pts in sorted(flows.items()):
        if len(pts) < 2:
            continue
        pts.sort(key=lambda p: p["ts"])
        fid = tracing._lane(("flight-flow", fkey), 1 << 31)
        out.append({"name": fkey, "ph": "s", "id": fid, "cat": "flight",
                    "pid": pts[0]["pid"], "tid": pts[0]["tid"],
                    "ts": pts[0]["ts"] * 1e6})
        for p in pts[1:]:
            out.append({"name": fkey, "ph": "f", "id": fid, "cat": "flight",
                        "pid": p["pid"], "tid": p["tid"],
                        "ts": p["ts"] * 1e6, "bp": "e"})
    for (pid, tid), label in sorted(named.items(),
                                    key=lambda kv: (kv[0][0], kv[0][1] or -1)):
        if tid is None:
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "args": {"name": label}})
        else:
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": label}})
    return out


# -------------------------------------------------------- bubble attribution
_MPMD_COMPUTE = frozenset({"mpmd.fwd", "mpmd.bwd", "mpmd.update"})
_MPMD_WAIT = frozenset({"mpmd.recv_wait", "mpmd.send", "mpmd.bridge"})


def _physical_lane(args: dict) -> str:
    """Group spans by PHYSICAL (stage, replica), not Perfetto lane: with
    interleaving the renderer shows one lane per (stage, chunk, replica)
    but a stage's chunks share one host thread — counting them as
    separate capacity lanes would inflate the bubble denominator to
    wall*S*v*dp while the trainer divides by wall*S*dp."""
    if "stage" in args and "replica" in args:
        return f"s{args['stage']}r{args['replica']}"
    return str(args.get("lane", "?"))


def pipeline_report(events: List[dict]) -> Optional[dict]:
    """Decompose the MPMD pipeline bubble from flight spans.

    Per PHYSICAL (stage, replica) lane — interleaved chunks' spans fold
    into their host stage's lane via the span attrs (see _physical_lane)
    — and per step: busy = Σ compute-span durations (fwd/bwd/update), the
    step window = [min start, max end] across every lane, and
    idle = window·lanes − busy. Idle splits into
    warmup (lane idle before its first compute of the step), drain (lane
    idle after its last compute), and steady (everything between —
    dominated by transport/recv waits, reported separately from the
    channel-wait spans). ``bubble_frac`` = idle / (window·lanes), the
    same denominator as the trainer's aggregate at
    train/mpmd/trainer.py, so the two are directly cross-checkable.
    Returns None when no MPMD spans are present."""
    by_step: Dict[Any, List[dict]] = {}
    for ev in events:
        if ev.get("event") != "span":
            continue
        name = ev.get("name", "")
        if not name.startswith("mpmd."):
            continue
        args = ev.get("args") or {}
        by_step.setdefault(args.get("step", 0), []).append(ev)
    if not by_step:
        return None

    steps = {}
    tot_area = tot_busy = tot_warm = tot_drain = tot_wait = 0.0
    for step, evs in sorted(by_step.items()):
        lanes: Dict[str, dict] = {}
        t0 = min(e["ts"] for e in evs)
        t1 = max(e["ts"] + e.get("dur", 0.0) for e in evs)
        for e in evs:
            args = e.get("args") or {}
            lane = lanes.setdefault(_physical_lane(args), {
                "busy": 0.0, "wait": 0.0, "first": None, "last": None})
            dur = e.get("dur", 0.0)
            if e["name"] in _MPMD_COMPUTE:
                lane["busy"] += dur
                s, en = e["ts"], e["ts"] + dur
                lane["first"] = s if lane["first"] is None else min(lane["first"], s)
                lane["last"] = en if lane["last"] is None else max(lane["last"], en)
            elif e["name"] in _MPMD_WAIT:
                lane["wait"] += dur
        window = max(t1 - t0, 0.0)
        n = len(lanes)
        busy = sum(l["busy"] for l in lanes.values())
        wait = sum(l["wait"] for l in lanes.values())
        warm = sum((l["first"] - t0) for l in lanes.values()
                   if l["first"] is not None)
        drain = sum((t1 - l["last"]) for l in lanes.values()
                    if l["last"] is not None)
        area = window * n
        idle = max(area - busy, 0.0)
        steady = max(idle - warm - drain, 0.0)
        steps[step] = {
            "window_s": window, "lanes": n, "compute_s": busy,
            "transport_wait_s": wait, "warmup_s": warm, "drain_s": drain,
            "steady_s": steady,
            "bubble_frac": (idle / area) if area > 0 else 0.0,
        }
        tot_area += area
        tot_busy += busy
        tot_warm += warm
        tot_drain += drain
        tot_wait += wait
    idle = max(tot_area - tot_busy, 0.0)
    return {
        "steps": steps,
        "lanes": max(s["lanes"] for s in steps.values()),
        "compute_s": tot_busy,
        "transport_wait_s": tot_wait,
        "warmup_s": tot_warm,
        "drain_s": tot_drain,
        "steady_s": max(idle - tot_warm - tot_drain, 0.0),
        "bubble_frac": (idle / tot_area) if tot_area > 0 else 0.0,
    }


# Data-plane span vocabulary (data/streaming/ records these on lanes
# ``data/op{i}`` and ``data/ingest``):
#   data.wait         — an operator's pull blocked resolving its head task
#                       (upstream or compute starvation)
#   data.drain        — an exchange's input barrier (partitioner needed
#                       global statistics before the map phase)
#   data.backpressure — the ingest producer parked on a full prefetch
#                       queue (the TRAINER is the bottleneck)
#   data.starve       — the trainer waited on an empty prefetch queue
#                       (the PIPELINE is the bottleneck)
#   data.bundle       — one bundle yielded (zero-dur marker; rows/bytes)
_DATA_STALLS = ("data.wait", "data.drain", "data.backpressure", "data.starve")


def ingest_report(events: List[dict]) -> Optional[dict]:
    """Attribute where a streaming data pipeline blocks, from flight spans
    on the ``data/*`` lanes — pipeline_report's role for the ingest plane.

    Per lane: stall seconds by kind plus bundle/row/byte throughput. The
    ``bottleneck`` is the (lane, kind) pair with the most stall time —
    ``data.backpressure`` on ``data/ingest`` reads as "the trainer is
    slower than the pipeline" (healthy overlap), while ``data.wait`` on an
    operator lane names the op whose upstream can't keep up. Returns None
    when no data spans are present."""
    lanes: Dict[str, dict] = {}
    t0 = t1 = None
    for ev in events:
        if ev.get("event") != "span":
            continue
        name = ev.get("name", "")
        if not name.startswith("data."):
            continue
        args = ev.get("args") or {}
        lane = str(args.get("lane", "?"))
        if not lane.startswith("data/"):
            continue
        d = lanes.setdefault(lane, {
            "stalls_s": {}, "bundles": 0, "rows": 0, "bytes": 0})
        dur = ev.get("dur", 0.0)
        ts = ev.get("ts", 0.0)
        t0 = ts if t0 is None else min(t0, ts)
        t1 = ts + dur if t1 is None else max(t1, ts + dur)
        if name in _DATA_STALLS:
            d["stalls_s"][name] = d["stalls_s"].get(name, 0.0) + dur
        elif name == "data.bundle":
            d["bundles"] += 1
            d["rows"] += int(args.get("rows", 0))
            d["bytes"] += int(args.get("bytes", 0))
    if not lanes:
        return None
    bottleneck = None
    worst = 0.0
    for lane, d in lanes.items():
        for kind, s in d["stalls_s"].items():
            if s > worst:
                worst = s
                bottleneck = {"lane": lane, "kind": kind, "stall_s": s}
    return {
        "window_s": max((t1 or 0.0) - (t0 or 0.0), 0.0),
        "lanes": {k: lanes[k] for k in sorted(lanes)},
        "bottleneck": bottleneck,
    }


def flight_payload(events: List[dict], trace_id: Optional[str] = None) -> dict:
    """ONE shared export for every flight surface (``ray-tpu flight``,
    ``GET /api/flight``) — both emit exactly this, so they cannot
    drift."""
    flight_evs = [e for e in events if _is_flight_span(e)]
    dropped = sum(e.get("n", 0) for e in events
                  if e.get("event") == "flight_spans_dropped")
    lanes: Dict[str, int] = {}
    for e in flight_evs:
        lane = str((e.get("args") or {}).get("lane"))
        lanes[lane] = lanes.get(lane, 0) + 1
    return {
        "n_spans": len(flight_evs),
        "dropped": dropped,
        "lanes": dict(sorted(lanes.items())),
        "pipeline": pipeline_report(events),
        "ingest": ingest_report(events),
        "trace_events": merged_chrome_trace(events, trace_id),
    }

"""Per-request tracing over the controller timeline.

Reference analog: `python/ray/util/tracing/tracing_helper.py` (OpenTelemetry
spans around remote calls) + the chrome-trace timeline
(`ray.timeline()` / `GcsTaskManager`). Redesign: every TaskSpec carries
`parent_task_id` (the submitting task) and a Dapper-style `trace_id`
inherited from the submitting context, so the controller's timeline events
already form multi-process span forests — no extra exporter process. Three
event kinds feed it:

* task lifecycle (``task_submitted`` / ``task_dispatched`` / ``task_done``)
  recorded by the controller and by workers' batched task_events channel;
* ``task_phase`` events (dep-fetch, deserialize, execute, store-result)
  recorded by executing workers per task;
* free ``span`` events (``record_span``) from anywhere in the cluster —
  the Serve plane records proxy/replica/engine request spans this way.

This module assembles the forest (`trace_forest`, keyed by trace_id) and
emits Perfetto/chrome://tracing JSON with DETERMINISTIC lane and flow ids
(`zlib.crc32`, not the per-process-salted builtin `hash`).
"""

from __future__ import annotations

import uuid
import zlib
from typing import Any, Dict, List, Optional


# ------------------------------------------------------------ trace context
def _context():
    """The current runtime's per-thread TaskContext, or None (never boots a
    runtime in a plain script — see api._runtime_or_attach)."""
    from ..core import api

    rt = api._runtime_or_attach()
    return rt._context if rt is not None else None


def get_trace_id() -> Optional[str]:
    """Trace id of the currently executing task/request on this thread."""
    ctx = _context()
    return getattr(ctx, "trace_id", None) if ctx is not None else None


def set_trace_id(trace_id: Optional[str]) -> None:
    """Install a trace id on this thread — entry points (e.g. the Serve
    HTTP proxy) call this so every downstream submission inherits it."""
    ctx = _context()
    if ctx is not None:
        ctx.trace_id = trace_id


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def span_event(
    name: str,
    start: float,
    dur: float,
    trace_id: Optional[str] = None,
    task: Optional[str] = None,
    attrs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Build a span timeline event (wall-clock `start`, seconds `dur`)."""
    ev: Dict[str, Any] = {
        "ts": float(start), "event": "span", "name": name,
        "dur": max(float(dur), 0.0),
        "trace": trace_id or get_trace_id(),
    }
    if task:
        ev["task"] = task
    if attrs:
        ev["args"] = dict(attrs)
    return ev


def record_events(events: List[Dict[str, Any]]) -> None:
    """Ship span events (see span_event) into the controller timeline as ONE
    control-plane message. No-op without a connected cluster backend."""
    if not events:
        return
    from ..core import api

    rt = api._runtime_or_attach()
    if rt is None:
        return
    send = getattr(rt.backend, "record_trace_event", None)
    if send is not None:
        send(events)


def record_span(
    name: str,
    start: float,
    dur: float,
    trace_id: Optional[str] = None,
    task: Optional[str] = None,
    attrs: Optional[Dict[str, Any]] = None,
) -> None:
    """Ship one span event into the controller timeline."""
    record_events([span_event(name, start, dur, trace_id, task, attrs)])


# ----------------------------------------------------------- span assembly
class Span:
    def __init__(self, task_id: str, name: str, parent: Optional[str]):
        self.task_id = task_id
        self.name = name
        self.parent = parent
        self.submitted_at: Optional[float] = None
        self.dispatched_at: Optional[float] = None
        self.done_at: Optional[float] = None
        self.trace: Optional[str] = None
        self.worker: Optional[str] = None
        self.phases: List[dict] = []  # task_phase events, in arrival order
        self.children: List["Span"] = []

    @property
    def duration(self) -> Optional[float]:
        if self.submitted_at is None or self.done_at is None:
            return None
        return self.done_at - self.submitted_at

    def to_dict(self) -> dict:
        return {
            "task_id": self.task_id,
            "name": self.name,
            "parent": self.parent,
            "submitted_at": self.submitted_at,
            "dispatched_at": self.dispatched_at,
            "done_at": self.done_at,
            "duration": self.duration,
            "trace": self.trace,
            "worker": self.worker,
            "phases": list(self.phases),
            "children": [c.to_dict() for c in self.children],
        }


def build_trace(events: List[dict]) -> Dict[str, Span]:
    """Assemble spans from timeline events (api.timeline()); returns
    {task_id: Span} with parent/child links populated."""
    spans: Dict[str, Span] = {}

    def span_for(task: str) -> Span:
        span = spans.get(task)
        if span is None:
            span = spans[task] = Span(task, "", None)
        return span

    for ev in events:
        task = ev.get("task")
        if not task:
            continue
        kind = ev.get("event")
        if kind == "task_submitted":
            span = span_for(task)
            span.name = ev.get("name", span.name)
            span.parent = ev.get("parent", span.parent)
            span.trace = ev.get("trace") or span.trace
            span.submitted_at = ev["ts"]
        elif kind == "task_dispatched":
            span = span_for(task)
            span.dispatched_at = ev["ts"]
            span.worker = ev.get("worker") or span.worker
        elif kind == "task_done":
            span_for(task).done_at = ev["ts"]
        elif kind == "task_phase":
            span = span_for(task)
            span.trace = ev.get("trace") or span.trace
            span.worker = ev.get("worker") or span.worker
            span.phases.append(
                {"phase": ev.get("phase", ""), "ts": ev["ts"],
                 "dur": ev.get("dur", 0.0)}
            )
        elif kind == "task_phases":
            # Compact per-task form (one event carries every phase triple) —
            # what executing workers ship since the drain-throughput round;
            # expanded here so downstream consumers see identical dicts.
            span = span_for(task)
            span.trace = ev.get("trace") or span.trace
            span.worker = ev.get("worker") or span.worker
            for name, t0, dur in ev.get("spans", ()):
                span.phases.append({"phase": name, "ts": t0, "dur": dur})
        elif kind == "task_span":
            # Consolidated submit/dispatch/done event from the worker's
            # burst fast path — expands to the classic three.
            span = span_for(task)
            span.name = ev.get("name", span.name)
            span.parent = ev.get("parent", span.parent)
            span.trace = ev.get("trace") or span.trace
            span.worker = ev.get("worker") or span.worker
            if span.submitted_at is None:
                span.submitted_at = ev["ts"]
            if span.dispatched_at is None:
                span.dispatched_at = ev["ts"]
            span.done_at = ev.get("done", span.done_at)
    for span in spans.values():
        if span.parent and span.parent in spans:
            spans[span.parent].children.append(span)
    # Resolve effective trace ids: inherit down the tree; a root without an
    # explicit trace roots its own (= its task id), matching the executing
    # worker's context inheritance.
    def resolve(span: Span, inherited: Optional[str]):
        span.trace = span.trace or inherited or span.task_id
        for c in span.children:
            resolve(c, span.trace)

    for span in spans.values():
        if not span.parent or span.parent not in spans:
            resolve(span, None)
    return spans


def roots(spans: Dict[str, Span]) -> List[Span]:
    """Top-level spans (submitted by the driver or an unknown parent)."""
    return [s for s in spans.values() if not s.parent or s.parent not in spans]


def get_task_tree() -> List[dict]:
    """Span forest for the live session (driver-side helper)."""
    from ..core import api

    spans = build_trace(api.timeline())
    return [s.to_dict() for s in roots(spans)]


# ------------------------------------------------------------ trace forest
def trace_forest(events: List[dict]) -> Dict[str, dict]:
    """Group the whole timeline by trace id: task span trees + free spans.

    Returns {trace_id: {trace_id, start, end, duration, tasks, spans}} where
    `tasks` are root Span dicts and `spans` are raw ``span`` events.
    """
    spans = build_trace(events)
    traces: Dict[str, dict] = {}

    def bucket(tid: str) -> dict:
        t = traces.get(tid)
        if t is None:
            t = traces[tid] = {
                "trace_id": tid, "start": None, "end": None,
                "tasks": [], "spans": [],
            }
        return t

    def stretch(t: dict, ts: Optional[float], end: Optional[float]):
        if ts is not None:
            t["start"] = ts if t["start"] is None else min(t["start"], ts)
        if end is not None:
            t["end"] = end if t["end"] is None else max(t["end"], end)

    for root in roots(spans):
        t = bucket(root.trace or root.task_id)
        t["tasks"].append(root.to_dict())

        def walk(s: Span):
            stretch(t, s.submitted_at, s.done_at or s.submitted_at)
            for c in s.children:
                walk(c)

        walk(root)
    for ev in events:
        if ev.get("event") != "span" or not ev.get("trace"):
            continue
        t = bucket(ev["trace"])
        t["spans"].append(ev)
        stretch(t, ev["ts"], ev["ts"] + ev.get("dur", 0.0))
    for t in traces.values():
        t["duration"] = (
            t["end"] - t["start"]
            if t["start"] is not None and t["end"] is not None
            else None
        )
    return traces


def trace_summaries(events: List[dict], limit: int = 50) -> List[dict]:
    """Recent-first summary rows for the dashboard / CLI trace listing."""
    rows = []
    for t in trace_forest(events).values():
        name = ""
        if t["spans"]:
            name = min(t["spans"], key=lambda e: e["ts"]).get("name", "")
        elif t["tasks"]:
            name = t["tasks"][0].get("name", "")
        rows.append(
            {
                "trace_id": t["trace_id"],
                "name": name,
                "start": t["start"],
                "duration": t["duration"],
                "n_tasks": sum(_count_tasks(x) for x in t["tasks"]),
                "n_spans": len(t["spans"]),
            }
        )
    rows.sort(key=lambda r: r["start"] or 0.0, reverse=True)
    return rows[:limit]


def _count_tasks(span_dict: dict) -> int:
    return 1 + sum(_count_tasks(c) for c in span_dict.get("children", ()))


# ------------------------------------------------------ shared trace export
def trace_payload(
    events: List[dict], trace_id: Optional[str] = None, limit: int = 50
) -> dict:
    """ONE export path for every trace surface. ``ray-tpu trace`` and the
    dashboard's ``/api/traces`` each used to rebuild this JSON by hand
    and had already drifted; both now emit exactly this dict (plus a
    surface-local timestamp), so a regression in one is a regression in
    both — and is caught by one test."""
    if trace_id is not None:
        return {"trace": trace_forest(events).get(trace_id)}
    return {"traces": trace_summaries(events, limit=limit)}


# ----------------------------------------------------- chrome-trace export
def _lane(key: Any, mod: int) -> int:
    """Deterministic lane id: crc32, NOT builtin hash() — hash() is salted
    per process (PYTHONHASHSEED), which made exports nondeterministic
    across runs (lanes and flow arrows reshuffled every invocation)."""
    return zlib.crc32(str(key).encode()) % mod


def _pid_for(worker: Optional[str]) -> int:
    return _lane(worker or "driver", 99990) + 1


def chrome_trace_with_flows(
    events: List[dict], trace_id: Optional[str] = None
) -> List[dict]:
    """Chrome-trace events + flow arrows (ph 's'/'f') along parent→child
    submissions, viewable in chrome://tracing / Perfetto. Lanes are stable:
    pid = per-worker lane, tid = per-task (or per-trace for free spans),
    both derived with crc32 so repeated exports are identical. Pass
    `trace_id` to export a single request's forest."""
    out: List[dict] = []
    spans = build_trace(events)
    if trace_id is not None:
        spans = {k: s for k, s in spans.items() if s.trace == trace_id}
    named_pids: Dict[int, str] = {}

    def name_pid(worker: Optional[str]) -> int:
        pid = _pid_for(worker)
        named_pids.setdefault(pid, f"worker {worker}" if worker else "driver")
        return pid

    for span in spans.values():
        if span.submitted_at is None:
            continue
        end = span.done_at or span.submitted_at
        pid = name_pid(span.worker)
        tid = _lane(span.task_id, 1000)
        out.append(
            {
                "name": span.name or span.task_id[:8],
                "ph": "X",
                "ts": span.submitted_at * 1e6,
                "dur": max(0.0, (end - span.submitted_at)) * 1e6,
                "pid": pid,
                "tid": tid,
                "args": {"task_id": span.task_id, "parent": span.parent,
                         "trace": span.trace},
            }
        )
        for ph in span.phases:
            out.append(
                {
                    "name": ph["phase"], "ph": "X", "cat": "phase",
                    "ts": ph["ts"] * 1e6, "dur": ph["dur"] * 1e6,
                    "pid": pid, "tid": tid,
                    "args": {"task_id": span.task_id},
                }
            )
        if span.parent and span.parent in spans:
            parent = spans[span.parent]
            if parent.submitted_at is None:
                continue
            flow_id = _lane((span.parent, span.task_id), 1 << 31)
            out.append(
                {"name": "submit", "ph": "s", "id": flow_id,
                 "pid": name_pid(parent.worker),
                 "tid": _lane(span.parent, 1000),
                 "ts": parent.submitted_at * 1e6, "cat": "task"},
            )
            out.append(
                {"name": "submit", "ph": "f", "id": flow_id, "pid": pid,
                 "tid": tid,
                 "ts": span.submitted_at * 1e6, "cat": "task", "bp": "e"},
            )
    for ev in events:
        if ev.get("event") != "span":
            continue
        if trace_id is not None and ev.get("trace") != trace_id:
            continue
        pid = name_pid(ev.get("worker"))
        out.append(
            {
                "name": ev.get("name", "span"), "ph": "X", "cat": "request",
                "ts": ev["ts"] * 1e6, "dur": ev.get("dur", 0.0) * 1e6,
                "pid": pid,
                "tid": _lane(("trace", ev.get("trace")), 1000),
                "args": {**(ev.get("args") or {}), "trace": ev.get("trace")},
            }
        )
    for pid, label in sorted(named_pids.items()):
        out.append(
            {"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": label}}
        )
    return out


def validate_chrome_trace(trace_events: List[dict]) -> dict:
    """Schema check for a chrome-trace export: raises ValueError on the
    first malformation, returns per-phase counts on success. Shared by
    the ``api.timeline`` test and the flight-recorder tests so every
    export surface stays Perfetto-loadable."""
    import json

    if not isinstance(trace_events, list):
        raise ValueError(f"trace must be a list, got {type(trace_events)}")
    counts: Dict[str, int] = {}
    flow_starts, flow_finishes = set(), set()
    for i, ev in enumerate(trace_events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not a dict")
        ph = ev.get("ph")
        if ph not in ("X", "M", "s", "f", "B", "E", "i", "C"):
            raise ValueError(f"event {i}: bad ph {ph!r}")
        counts[ph] = counts.get(ph, 0) + 1
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"event {i}: missing name")
        if ph == "M":
            if not isinstance(ev.get("pid"), int):
                raise ValueError(f"event {i}: metadata without int pid")
            if not isinstance((ev.get("args") or {}).get("name"), str):
                raise ValueError(f"event {i}: metadata without args.name")
            continue
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                raise ValueError(f"event {i}: {key} must be int")
        if not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"event {i}: ts must be numeric")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: X span needs dur >= 0")
        if ph in ("s", "f"):
            if "id" not in ev:
                raise ValueError(f"event {i}: flow event without id")
            (flow_starts if ph == "s" else flow_finishes).add(ev["id"])
    dangling = flow_finishes - flow_starts
    if dangling:
        raise ValueError(f"flow finishes without a start: {sorted(dangling)[:5]}")
    json.dumps(trace_events)  # must be serializable as-is
    return counts

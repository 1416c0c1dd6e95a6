"""Ops CLI — `python -m ray_tpu_torch.scripts.cli <command>`.

Reference analogs: `python/ray/scripts/scripts.py` (`ray status/timeline`) and
`python/ray/util/state/state_cli.py` (`ray list tasks/actors/objects/...`).

Address resolution order: --address flag, RAY_TPU_ADDRESS env, then the
session_latest symlink's address.json under the session root (under TMPDIR,
core/host_names.SESSION_ROOT; reference: a fixed root in /tmp, ray_tpu/scripts/cli.py:6-7).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _resolve_address(flag: str | None) -> dict:
    if flag:
        return {"address": flag}
    env = os.environ.get("RAY_TPU_ADDRESS")
    if env:
        return {"address": env}
    from ..core.host_names import SESSION_ROOT

    # reference: "/tmp/ray_tpu/session_latest/address.json", ray_tpu/scripts/cli.py:24
    path = os.path.join(SESSION_ROOT, "session_latest", "address.json")
    try:
        with open(path) as f:
            info = json.load(f)
        if not os.path.exists(f"/proc/{info.get('pid', 0)}"):
            raise SystemExit(
                "session_latest points at a dead controller; pass --address"
            )
        from ..core.rpc import adopt_auth_token

        adopt_auth_token(info.get("auth_token", ""))
        return info
    except FileNotFoundError:
        raise SystemExit(
            # reference: names /tmp/ray_tpu/session_latest, ray_tpu/scripts/cli.py:38-40
            "No running session found (no --address, no RAY_TPU_ADDRESS, no "
            f"{os.path.join(SESSION_ROOT, 'session_latest')})."
        )


def _backend(info: dict):
    from ray_tpu_torch.core.cluster_backend import ClusterBackend

    backend = ClusterBackend(info["address"])
    backend._connect(register_as="register_client")
    return backend


def _table(rows, columns):
    if not rows:
        print("(empty)")
        return
    widths = [max(len(str(r.get(c, ""))) for r in rows + [{c: c}]) for c in columns]
    print("  ".join(c.ljust(w) for c, w in zip(columns, widths)))
    for r in rows:
        print("  ".join(str(r.get(c, "")).ljust(w) for c, w in zip(columns, widths)))


def cmd_status(backend, info, args):
    res = backend._request({"type": "cluster_resources"})
    nodes = backend._request({"type": "nodes"})["nodes"]
    summary = backend._request({"type": "state_summary", "counts_only": True})
    print(f"Cluster: {info['address']}")
    if info.get("metrics_url"):
        print(f"Metrics: {info['metrics_url']}")
    print(f"Nodes: {sum(1 for n in nodes if n['Alive'])} alive / {len(nodes)} total")
    total, avail = res["total"], res["available"]
    for k in sorted(total):
        print(f"  {k}: {total[k] - avail.get(k, 0.0):g}/{total[k]:g} used")
    print(
        f"Tasks: {summary['running_tasks']} running, {summary['pending_tasks']} pending"
    )
    print(f"Workers: {summary['num_workers']}  Objects: {summary['objects']} "
          f"({summary['store_bytes'] / 1e6:.1f} MB in store)")


def cmd_list(backend, info, args):
    kind = args.kind
    if kind == "tasks":
        rows = backend._request({"type": "list_tasks"})["tasks"]
        for r in rows:
            r["task_id"] = r["task_id"][:16]
        _table(rows, ["task_id", "name", "state", "worker_id", "node_id"])
    elif kind == "actors":
        rows = backend._request({"type": "list_actors"})["actors"]
        for r in rows:
            r["actor_id"] = r["actor_id"][:16]
        _table(rows, ["actor_id", "name", "state", "node_id", "restarts", "pending_calls"])
    elif kind == "objects":
        resp = backend._request({"type": "list_objects", "limit": args.limit})
        rows = resp["objects"]
        for r in rows:
            r["object_id"] = r["object_id"][:16]
            r["locations"] = ",".join(r["locations"]) or "-"
        _table(rows, ["object_id", "status", "size", "locations", "holders", "pinned"])
        if resp["total"] > len(rows):
            print(f"... {resp['total'] - len(rows)} more (raise --limit)")
    elif kind == "nodes":
        rows = backend._request({"type": "nodes"})["nodes"]
        for r in rows:
            r["Resources"] = json.dumps(r["Resources"])
        _table(rows, ["NodeID", "Alive", "Resources"])
    elif kind == "workers":
        rows = backend._request({"type": "list_workers"})["workers"]
        _table(rows, ["worker_id", "state", "node_id", "pid", "has_tpu", "current_task"])


def cmd_logs(backend, info, args):
    # Loop with returned cursors: logs can exceed the server's per-poll cap.
    cursors = {}
    shown = set()
    while True:
        resp = backend._request(
            {"type": "tail_logs", "worker_id": args.worker, "cursors": cursors}
        )
        logs = resp["logs"]
        if not logs:
            break
        for wid, chunk in sorted(logs.items()):
            if not args.worker and wid not in shown:
                print(f"==== {wid} ====")
                shown.add(wid)
            cursors[wid] = chunk["offset"]
            sys.stdout.write(chunk["data"])


def cmd_job(backend, info, args):
    if args.job_command == "submit":
        import shlex

        entrypoint = " ".join(shlex.quote(a) for a in args.entrypoint)
        resp = backend._request(
            {"type": "submit_job", "entrypoint": entrypoint, "runtime_env": None}
        )
        print(resp.get("job_id", resp))
    elif args.job_command == "status":
        print(json.dumps(backend._request({"type": "job_status", "job_id": args.job_id})))
    elif args.job_command == "logs":
        resp = backend._request({"type": "job_logs", "job_id": args.job_id})
        sys.stdout.write(resp.get("data", resp.get("error", "")))
    elif args.job_command == "stop":
        print(backend._request({"type": "stop_job", "job_id": args.job_id}))
    elif args.job_command == "list":
        rows = backend._request({"type": "list_jobs"})["jobs"]
        _table(rows, ["job_id", "status", "entrypoint", "returncode"])


def cmd_serve(backend, info, args):
    """`serve deploy/status/shutdown/delete` (reference: `serve/scripts.py`).
    Runs as a driver so it can reach the Serve controller actor."""
    import ray_tpu_torch

    ray_tpu_torch.init(address=info["address"], ignore_reinit_error=True, log_to_driver=False)
    from ray_tpu_torch import serve

    if args.serve_command == "deploy":
        sys.path.insert(0, os.getcwd())  # import_path resolves from cwd
        with open(args.config_file) as f:
            text = f.read()
        if args.config_file.endswith((".yaml", ".yml")):
            import yaml

            cfg = yaml.safe_load(text)
        else:
            cfg = json.loads(text)
        handles = serve.run_config(cfg)
        print(f"deployed: {', '.join(handles) or '(nothing)'}")
    elif args.serve_command == "status":
        print(json.dumps(serve.status(), indent=2, default=str))
    elif args.serve_command == "delete":
        serve.delete(args.app)
        print(f"deleted {args.app}")
    elif args.serve_command == "shutdown":
        serve.shutdown()
        print("serve shut down")


def cmd_workflow(backend, info, args):
    """`workflow list/status/resume/cancel/delete` (reference:
    `ray.workflow` ops surface). Storage-rooted, so no live cluster needed
    for list/status; resume runs as a driver."""
    from ray_tpu_torch import workflow

    if args.storage:
        workflow.init(args.storage)
    cmd = args.workflow_command
    if cmd == "list":
        rows = [
            {"workflow_id": wid, "status": status}
            for wid, status in workflow.list_all()
        ]
        _table(rows, ["workflow_id", "status"])
    elif cmd == "status":
        print(json.dumps(workflow.get_metadata(args.workflow_id), indent=2, default=str))
    elif cmd == "resume":
        import ray_tpu_torch

        ray_tpu_torch.init(address=info["address"], ignore_reinit_error=True, log_to_driver=False)
        out = workflow.resume(args.workflow_id)
        print(f"resumed {args.workflow_id} -> {out!r}")
    elif cmd == "cancel":
        workflow.cancel(args.workflow_id)
        print(f"cancel requested for {args.workflow_id}")
    elif cmd == "delete":
        workflow.delete(args.workflow_id)
        print(f"deleted {args.workflow_id}")


def cmd_timeline(backend, info, args):
    events = backend._request({"type": "state_summary"})["timeline"]
    if args.output:
        if args.raw:
            data = events
        else:
            from ray_tpu_torch.util.tracing import chrome_trace_with_flows

            data = chrome_trace_with_flows(events)
        with open(args.output, "w") as f:
            json.dump(data, f)
        kind = "raw events" if args.raw else "chrome-trace events"
        print(f"wrote {len(data)} {kind} to {args.output}")
    else:
        for ev in events[-args.tail:]:
            fields = {k: v for k, v in ev.items() if k not in ("ts", "event")}
            print(f"{ev['ts']:.3f} {ev['event']:28s} {fields}")


def _print_span_tree(span, t0, depth=0):
    start = span["submitted_at"]
    dur = span["duration"]
    off = f"+{(start - t0) * 1e3:8.1f}ms" if start is not None else " " * 10
    dur_s = f"{dur * 1e3:8.1f}ms" if dur is not None else "   (open)"
    print(f"{off} {dur_s}  {'  ' * depth}{span['name'] or span['task_id'][:8]}"
          f"  [{span['task_id'][:8]}]")
    for ph in span.get("phases", ()):
        print(f"{'':10} {ph['dur'] * 1e3:8.1f}ms  {'  ' * (depth + 1)}"
              f"· {ph['phase']}")
    for child in span.get("children", ()):
        _print_span_tree(child, t0, depth + 1)


def cmd_trace(backend, info, args):
    """`trace` — list recent traces; `trace <id>` — one request's span
    forest; `-o FILE` writes that trace as Perfetto-loadable JSON."""
    from ray_tpu_torch.util import tracing

    events = backend._request({"type": "state_summary"})["timeline"]
    # Same payload builder as the dashboard's /api/traces — ONE export
    # path (tracing.trace_payload), so CLI and HTTP cannot drift.
    if not args.trace_id:
        rows = tracing.trace_payload(events, limit=args.limit)["traces"]
        for r in rows:
            r["start"] = f"{r['start']:.3f}" if r["start"] is not None else ""
            r["duration_ms"] = (
                f"{r['duration'] * 1e3:.1f}" if r["duration"] is not None else ""
            )
        _table(rows, ["trace_id", "name", "start", "duration_ms", "n_tasks", "n_spans"])
        return
    t = tracing.trace_payload(events, trace_id=args.trace_id)["trace"]
    if t is None:
        raise SystemExit(f"unknown trace {args.trace_id}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(
                tracing.chrome_trace_with_flows(events, trace_id=args.trace_id), f
            )
        print(f"wrote trace {args.trace_id} to {args.output}")
        return
    t0 = t["start"] or 0.0
    dur = f"{t['duration'] * 1e3:.1f}ms" if t["duration"] is not None else "(open)"
    print(f"trace {t['trace_id']}  start={t0:.3f}  duration={dur}")
    for ev in sorted(t["spans"], key=lambda e: e["ts"]):
        print(f"+{(ev['ts'] - t0) * 1e3:8.1f}ms {ev.get('dur', 0) * 1e3:8.1f}ms"
              f"  {ev.get('name', 'span')}  {ev.get('args') or ''}")
    for root in t["tasks"]:
        _print_span_tree(root, t0)


def cmd_flight(backend, info, args):
    """`flight` — merged cluster flight-recorder view: pokes every worker
    to flush its span ring, then prints the lane/drop/pipeline summary;
    `-o FILE` writes ONE merged Perfetto chrome-trace instead."""
    import time as _time

    from ray_tpu_torch.util import flight

    # Pull-on-demand: workers flush their rings via the task_events
    # piggyback; give those posts a beat to land in the controller timeline.
    try:
        backend._request({"type": "flight_pull"})
        _time.sleep(args.wait)
    except Exception:  # noqa: BLE001 — older controller: use what's there
        pass
    events = backend._request({"type": "state_summary"})["timeline"]
    # Same payload builder as the dashboard's /api/flight — ONE export
    # path (flight.flight_payload), so CLI and HTTP cannot drift.
    payload = flight.flight_payload(events, trace_id=args.trace_id)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(payload["trace_events"], f)
        print(f"wrote {len(payload['trace_events'])} merged chrome-trace "
              f"events to {args.output}")
        return
    print(f"flight spans: {payload['n_spans']}  dropped: {payload['dropped']}")
    for lane in sorted(payload["lanes"]):
        print(f"  {lane:28s} {payload['lanes'][lane]}")
    rep = payload["pipeline"]
    if rep:
        print(f"pipeline bubble: {rep['bubble_frac']:.3f} over "
              f"{len(rep['steps'])} step(s), {rep['lanes']} lane(s)")
        print(f"  warmup {rep['warmup_s']:.3f}s  steady {rep['steady_s']:.3f}s"
              f"  drain {rep['drain_s']:.3f}s")
        print(f"  transport-wait {rep['transport_wait_s']:.3f}s  "
              f"compute {rep['compute_s']:.3f}s")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ray-tpu", description=__doc__)
    parser.add_argument("--address", default=None, help="controller host:port")
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("status", help="cluster summary")
    p_list = sub.add_parser("list", help="list tasks/actors/objects/nodes/workers")
    p_list.add_argument("kind", choices=["tasks", "actors", "objects", "nodes", "workers"])
    p_list.add_argument("--limit", type=int, default=100)
    p_logs = sub.add_parser("logs", help="dump worker logs")
    p_logs.add_argument("worker", nargs="?", default=None, help="worker id (all if omitted)")
    p_tl = sub.add_parser("timeline", help="chrome-trace events")
    p_tl.add_argument("-o", "--output", default=None,
                      help="write Perfetto-loadable chrome-trace JSON")
    p_tl.add_argument("--raw", action="store_true",
                      help="with -o: dump raw controller events instead")
    p_tl.add_argument("--tail", type=int, default=50)
    p_tr = sub.add_parser("trace", help="list/inspect per-request traces")
    p_tr.add_argument("trace_id", nargs="?", default=None)
    p_tr.add_argument("-o", "--output", default=None,
                      help="with a trace id: write that trace as chrome-trace JSON")
    p_tr.add_argument("--limit", type=int, default=25)
    p_fl = sub.add_parser("flight", help="merged cluster flight-recorder view")
    p_fl.add_argument("trace_id", nargs="?", default=None,
                      help="restrict the -o chrome trace to one request")
    p_fl.add_argument("-o", "--output", default=None,
                      help="write merged Perfetto chrome-trace JSON")
    p_fl.add_argument("--wait", type=float, default=0.5,
                      help="seconds to wait for worker flushes after the pull")
    p_job = sub.add_parser("job", help="submit/inspect cluster jobs")
    job_sub = p_job.add_subparsers(dest="job_command", required=True)
    p_sub = job_sub.add_parser("submit")
    p_sub.add_argument("entrypoint", nargs=argparse.REMAINDER,
                       help="command line, e.g. -- python train.py")
    for name in ("status", "logs", "stop"):
        p = job_sub.add_parser(name)
        p.add_argument("job_id")
    job_sub.add_parser("list")
    p_wf = sub.add_parser("workflow", help="list/inspect/resume durable workflows")
    wf_sub = p_wf.add_subparsers(dest="workflow_command", required=True)
    for wname in ("list", "status", "resume", "cancel", "delete"):
        p = wf_sub.add_parser(wname)
        if wname != "list":
            p.add_argument("workflow_id")
        p.add_argument("--storage", default=None, help="workflow storage root")
    p_serve = sub.add_parser("serve", help="deploy/inspect Serve applications")
    serve_sub = p_serve.add_subparsers(dest="serve_command", required=True)
    p_deploy = serve_sub.add_parser("deploy")
    p_deploy.add_argument("config_file", help="JSON or YAML app config")
    serve_sub.add_parser("status")
    p_del = serve_sub.add_parser("delete")
    p_del.add_argument("app")
    serve_sub.add_parser("shutdown")
    args = parser.parse_args(argv)
    if args.command == "job" and args.job_command == "submit":
        ep = list(args.entrypoint)
        if ep and ep[0] == "--":  # drop ONLY the argparse separator; a later
            ep = ep[1:]           # literal -- belongs to the entrypoint
        args.entrypoint = ep

    info = _resolve_address(args.address)
    backend = _backend(info)
    try:
        {
            "status": cmd_status,
            "list": cmd_list,
            "logs": cmd_logs,
            "timeline": cmd_timeline,
            "trace": cmd_trace,
            "flight": cmd_flight,
            "job": cmd_job,
            "serve": cmd_serve,
            "workflow": cmd_workflow,
        }[args.command](backend, info, args)
    finally:
        backend.conn.close()
        backend.io.stop()


if __name__ == "__main__":
    main()

"""Dashboard — HTTP observability UI + JSON API over controller state.

Reference analog: `dashboard/` (47k LoC: aiohttp head + per-node agents + a
React/TS frontend). Redesign: controller state already lives in one process,
so the dashboard is an asyncio HTTP server inside it — JSON endpoints backed
directly by the controller's state-API handlers plus one self-contained HTML
page (no build step, no node_modules). Prometheus stays on its own port
(`/metrics`); the page links to it.

Endpoints:
    GET /                  HTML overview (auto-refreshing tables)
    GET /api/cluster       resource totals/availability + counts
    GET /api/nodes         node directory
    GET /api/actors        actor directory
    GET /api/tasks         pending/running tasks
    GET /api/objects       object index (?limit=N)
    GET /api/workers       worker pool
    GET /api/jobs          submitted jobs
    GET /api/pgs           placement groups
    GET /api/events        recent timeline events (?limit=N)
    GET /api/traces        recent request traces (summary rows, ?limit=N)
    GET /api/traces?trace_id=ID  one trace's full span forest
    GET /api/flight        merged flight-recorder payload (lanes, pipeline
                           bubble report, ONE Perfetto chrome-trace;
                           ?trace_id=ID restricts the chrome-trace)
    GET /api/logs?worker_id=ID   tail of one worker's log
"""

from __future__ import annotations

import asyncio
import json
import time
import urllib.parse
from typing import Optional

MAX_REQUEST_LINE = 8192


class DashboardServer:
    def __init__(self, controller):
        self.controller = controller
        self.port = 0
        self._server: Optional[asyncio.base_events.Server] = None

    async def start(self, port: int = 0):
        from ..core import config as rt_config

        bind = rt_config.get("bind_address") or rt_config.get("node_ip")
        self._server = await asyncio.start_server(
            self._on_connection, host=bind, port=port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    def close(self):
        if self._server is not None:
            self._server.close()

    # ------------------------------------------------------------- plumbing
    async def _on_connection(self, reader, writer):
        try:
            line = await asyncio.wait_for(reader.readline(), 5)
            if len(line) > MAX_REQUEST_LINE:
                return
            for _ in range(100):  # drain request headers (bounded)
                h = await asyncio.wait_for(reader.readline(), 5)
                if h in (b"\r\n", b"\n", b""):
                    break
            parts = line.split(b" ")
            target = parts[1].decode() if len(parts) > 1 else "/"
            parsed = urllib.parse.urlsplit(target)
            query = dict(urllib.parse.parse_qsl(parsed.query))
            status, ctype, body = await self._route(parsed.path, query)
            writer.write(
                f"HTTP/1.0 {status}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n\r\n".encode()
                + body
            )
            await writer.drain()
        except Exception:  # noqa: BLE001 — a broken client must not hurt the controller
            pass
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _route(self, path: str, query: dict):
        c = self.controller
        if path in ("/", "/index.html"):
            return "200 OK", "text/html; charset=utf-8", _INDEX_HTML
        if not path.startswith("/api/"):
            return "404 Not Found", "text/plain", b"not found"
        try:
            name = path[len("/api/"):]
            if name == "cluster":
                data = await self._cluster_summary()
            elif name == "nodes":
                data = await c.h_nodes(None, {}, {})
            elif name == "actors":
                data = await c.h_list_actors(None, {}, {})
            elif name == "tasks":
                data = await c.h_list_tasks(None, {}, {})
            elif name == "objects":
                data = await c.h_list_objects(
                    None, {}, {"limit": int(query.get("limit", 200))}
                )
            elif name == "workers":
                data = await c.h_list_workers(None, {}, {})
            elif name == "jobs":
                data = await c.h_list_jobs(None, {}, {})
            elif name == "pgs":
                data = {
                    "placement_groups": [
                        {
                            "pg_id": k,
                            "name": v.get("name", ""),
                            "strategy": v["strategy"],
                            "ready": v["ready"],
                            "bundles": v["bundles"],
                            "bundle_nodes": v["bundle_nodes"],
                        }
                        for k, v in c.pgs.items()
                    ]
                }
            elif name == "events":
                limit = max(0, int(query.get("limit", 100)))
                data = {"events": list(c.timeline[-limit:]) if limit else []}
            elif name == "traces":
                from ..util import tracing

                # Same bounded window as state_summary (what the CLI and
                # api.timeline() see): keeps the two surfaces consistent and
                # caps the forest assembly this does on the controller's
                # event loop (the full timeline can hold 100k events).
                # ONE export path shared with `ray-tpu trace`
                # (tracing.trace_payload): CLI and HTTP cannot drift.
                events = list(c.timeline[-10000:])
                trace_id = query.get("trace_id")
                if trace_id:
                    t = tracing.trace_payload(events, trace_id=trace_id)["trace"]
                    if t is None:
                        return (
                            "404 Not Found",
                            "application/json",
                            json.dumps({"error": f"unknown trace {trace_id}"}).encode(),
                        )
                    data = t
                else:
                    limit = max(1, int(query.get("limit", 50)))
                    data = tracing.trace_payload(events, limit=limit)
            elif name == "flight":
                from ..util import flight

                # Pull-on-demand: poke every live worker to flush its span
                # ring, give the task_events piggybacks a beat to land, then
                # build the merged payload — the same builder as
                # `ray-tpu flight` (flight.flight_payload), so the two
                # surfaces emit identical output for the same timeline.
                await c.h_flight_pull(None, {}, {})
                await asyncio.sleep(0.25)
                data = flight.flight_payload(
                    list(c.timeline[-10000:]), trace_id=query.get("trace_id")
                )
            elif name == "logs":
                wid = query.get("worker_id", "")
                if not wid:
                    return (
                        "400 Bad Request",
                        "application/json",
                        b'{"error": "worker_id query parameter required"}',
                    )
                # Real tail: learn the end offset first, then read only the
                # last chunk (a long-lived worker log can be GBs).
                tail_bytes = min(int(query.get("bytes", 65536)), 1 << 20)
                head = await c.h_tail_logs(
                    None, {}, {"worker_id": wid, "init": True}
                )
                end = head.get("logs", {}).get(wid, {}).get("offset", 0)
                got = await c.h_tail_logs(
                    None, {},
                    {"worker_id": wid,
                     "cursors": {wid: max(0, end - tail_bytes)}},
                )
                data = {"worker_id": wid,
                        "log": got.get("logs", {}).get(wid, {}).get("data", "")}
            else:
                return "404 Not Found", "text/plain", b"unknown api"
            body = json.dumps({"ts": time.time(), **data}, default=str).encode()
            return "200 OK", "application/json", body
        except Exception as e:  # noqa: BLE001
            return (
                "500 Internal Server Error",
                "application/json",
                json.dumps({"error": repr(e)}).encode(),
            )

    async def _cluster_summary(self) -> dict:
        c = self.controller
        totals = await c.h_cluster_resources(None, {}, {})
        summary = await c.h_state_summary(None, {}, {"counts_only": True})
        return {
            "resources": totals,
            "summary": summary,
            "metrics_url": f"http://127.0.0.1:{c.metrics_port}/metrics",
            "session_dir": c.session_dir,
            "nodes_alive": sum(1 for n in c.nodes.values() if n.alive),
        }


_INDEX_HTML = b"""<!doctype html>
<html><head><meta charset="utf-8"><title>ray_tpu_torch dashboard</title>
<style>
  body { font: 13px/1.5 system-ui, sans-serif; margin: 24px; color: #1a1a22; }
  h1 { font-size: 18px; } h2 { font-size: 14px; margin: 20px 0 6px; }
  table { border-collapse: collapse; min-width: 520px; }
  th, td { border: 1px solid #d5d5de; padding: 3px 9px; text-align: left; }
  th { background: #f2f2f7; font-weight: 600; }
  .tiles { display: flex; gap: 12px; flex-wrap: wrap; margin: 12px 0; }
  .tile { border: 1px solid #d5d5de; border-radius: 6px; padding: 8px 14px; }
  .tile b { display: block; font-size: 20px; }
  .muted { color: #6a6a75; } a { color: #2440b3; }
</style></head>
<body>
<h1>ray_tpu_torch dashboard</h1>
<div class="tiles" id="tiles"></div>
<p class="muted">auto-refresh 2s &middot; <a id="mlink" href="#">prometheus /metrics</a></p>
<h2>Nodes</h2><div id="nodes"></div>
<h2>Actors</h2><div id="actors"></div>
<h2>Tasks</h2><div id="tasks"></div>
<h2>Workers</h2><div id="workers"></div>
<h2>Placement groups</h2><div id="pgs"></div>
<h2>Jobs</h2><div id="jobs"></div>
<h2>Traces</h2><div id="traces"></div>
<h2>Recent events</h2><div id="events"></div>
<script>
function esc(s) {
  return String(s).replace(/&/g,'&amp;').replace(/</g,'&lt;').replace(/>/g,'&gt;');
}
function table(rows, cols) {
  if (!rows || !rows.length) return '<p class="muted">none</p>';
  let h = '<table><tr>' + cols.map(c => '<th>'+esc(c)+'</th>').join('') + '</tr>';
  for (const r of rows)
    h += '<tr>' + cols.map(c => '<td>'+esc(JSON.stringify(r[c] ?? ''))+'</td>').join('') + '</tr>';
  return h + '</table>';
}
async function j(p) { return (await fetch(p)).json(); }
async function refresh() {
  try {
    const cl = await j('/api/cluster');
    document.getElementById('mlink').href = cl.metrics_url;
    const s = cl.summary, res = cl.resources;
    document.getElementById('tiles').innerHTML =
      ['nodes_alive','num_workers','pending_tasks','running_tasks','objects']
        .map(k => '<div class="tile"><b>'+esc(k==='nodes_alive'?cl[k]:s[k])+'</b>'+esc(k.replace(/_/g,' '))+'</div>').join('') +
      '<div class="tile"><b>'+esc(JSON.stringify(res.total ?? res))+'</b>resources</div>';
    const [n,a,t,w,p,jb,e,tr] = await Promise.all([
      j('/api/nodes'), j('/api/actors'), j('/api/tasks'),
      j('/api/workers'), j('/api/pgs'), j('/api/jobs'), j('/api/events'),
      j('/api/traces?limit=15')]);
    document.getElementById('nodes').innerHTML =
      table(n.nodes, ['NodeID','Alive','Resources','Available']);
    document.getElementById('actors').innerHTML =
      table(a.actors, ['actor_id','name','state','node_id','restarts','pending_calls']);
    document.getElementById('tasks').innerHTML =
      table(t.tasks, ['task_id','name','state','node_id','required_resources']);
    document.getElementById('workers').innerHTML =
      table(w.workers, ['worker_id','state','pid','node_id','current_task','actor']);
    document.getElementById('pgs').innerHTML =
      table(p.placement_groups, ['pg_id','name','strategy','ready','bundle_nodes']);
    document.getElementById('jobs').innerHTML =
      table(jb.jobs, ['job_id','status','entrypoint']);
    document.getElementById('traces').innerHTML =
      table(tr.traces, ['trace_id','name','start','duration','n_tasks','n_spans']);
    document.getElementById('events').innerHTML =
      table((e.events||[]).slice().reverse().slice(0,25), ['ts','event','task','node']);
  } catch (err) { console.error(err); }
}
refresh(); setInterval(refresh, 2000);
</script></body></html>
"""

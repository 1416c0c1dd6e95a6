"""Node agent — per-node daemon for multi-node clusters.

Reference analog: the raylet (`src/ray/raylet/node_manager.cc`) + the node's
plasma store + the object-manager push/pull plane
(`src/ray/object_manager/{pull,push}_manager.h`). Redesign (TPU-first): the
agent owns no scheduler state — the controller (head) schedules globally and
directs transfers; the agent's jobs are mechanical:

  * register with the controller (`register_node`) announcing resources —
    the `NodeManager` handshake (`node_manager.cc:1765` lease protocol's
    node side);
  * spawn/reap worker processes on this node when the controller asks
    (reference: `WorkerPool`, `worker_pool.h:156`);
  * own this node's shm arena (plasma role) — workers on the node attach it;
  * serve object fetches to peer nodes and pull objects from peers on
    controller command (pull/push manager roles).

Workers die with the agent (PR_SET_PDEATHSIG) so killing the agent is a
faithful "node death" for chaos tests.
"""

from __future__ import annotations

import asyncio
import ctypes
import json
import os
import signal
import subprocess
import sys
import traceback
import time
from typing import Dict, Optional

from . import config as rt_config
from . import store
from .devices import ACCELERATOR, pin_worker_devices  # the GPU worker kind (reference: none)
from .rpc import Connection, auth_token, open_rpc_connection


def serve_fetch(local_store, msg: dict):
    """Shared fetch-plane request handling (agents AND the controller serve
    the same three verbs): fetch_object (whole), stat_object (size),
    fetch_chunk (slice). Returns the response payload or None to ignore."""
    mtype = msg.get("type")
    if mtype == "fetch_object":
        if msg.get("name"):
            return {"data": local_store.read_raw(msg["name"])}
        with open(msg["path"], "rb") as f:
            return {"data": f.read()}
    if mtype == "stat_object":
        if msg.get("name"):
            return {"size": local_store.raw_size(msg["name"])}
        return {"size": os.path.getsize(msg["path"])}
    if mtype == "fetch_chunk":
        if msg.get("name"):
            return {"data": local_store.read_raw_slice(
                msg["name"], msg["offset"], msg["length"]
            )}
        with open(msg["path"], "rb") as f:
            f.seek(msg["offset"])
            return {"data": f.read(msg["length"])}
    return None


async def pull_chunked(peer, where: dict, local_store, hex_id: str,
                       size_hint: int = 0):
    """Shared chunked-pull client (agents AND the controller's head pulls):
    stat (skipped when the size is already known) → whole-object fast path
    for small objects → bounded-parallel chunk fetches streamed straight
    into the destination store (create_begin → write → commit; no full-
    object staging in heap). Returns (name, size)."""
    import asyncio

    chunk = rt_config.get("transfer_chunk_bytes")
    tmo = rt_config.get("transfer_chunk_timeout_s")
    size = size_hint
    if not size:
        stat = await peer.request({"type": "stat_object", **where}, timeout=tmo)
        if stat.get("error"):
            raise RuntimeError(stat["error"])
        size = stat["size"]
    if size <= chunk:
        resp = await peer.request({"type": "fetch_object", **where}, timeout=tmo)
        if resp.get("error"):
            raise RuntimeError(resp["error"])
        return local_store.create_raw(hex_id, resp["data"])
    # Same-host zero-copy adoption first (plasma shared-segment design): no
    # allocation, no copy — this host's page-supply throughput (~0.5 GiB/s
    # for fresh pages at 8 GiB scale, measured r5) is the wall every copy
    # path hits, and same-machine "transfers" never need one.
    if (
        where.get("bulk")
        and size >= rt_config.get("bulk_min_bytes")
        and rt_config.get("bulk_same_host_map")
        and rt_config.get("bulk_same_host_borrow")
        and hasattr(local_store, "adopt_borrow")
    ):
        from . import bulk as bulk_mod

        host = where["bulk"].rsplit(":", 1)[0]
        if host in bulk_mod._local_addrs():
            t0 = time.monotonic()
            try:
                path, base, pin = await asyncio.get_running_loop().run_in_executor(
                    None, bulk_mod.bulk_borrow, where["bulk"], where, size, tmo
                )
                name = local_store.adopt_borrow(hex_id, path, base, size, pin)
                if size >= (256 << 20) and rt_config.get("transfer_log_big"):
                    print(
                        f"pull_timing id={hex_id[:8]} size={size >> 20}MiB "
                        f"BORROW {time.monotonic() - t0:.3f}s",
                        flush=True, file=sys.stderr,
                    )
                return name, size
            except Exception:  # noqa: BLE001 — fall back to the copy planes
                traceback.print_exc()
    t0 = time.monotonic()
    name, writer = local_store.create_begin(hex_id, size)
    if writer is None:
        return name, size  # completed earlier pull / locally produced
    t_create = time.monotonic() - t0
    # Bulk plane first: sendfile → recv_into straight between arena mappings
    # (bulk.py). Any failure falls back to the RPC chunk plane below, which
    # rewrites every offset, so a half-written bulk span is harmless.
    if where.get("bulk") and size >= rt_config.get("bulk_min_bytes"):
        from . import bulk as bulk_mod

        pulled = False
        try:
            await asyncio.get_running_loop().run_in_executor(
                None, bulk_mod.bulk_pull_into, where["bulk"], where, size, writer
            )
            pulled = True
        except Exception:  # noqa: BLE001
            traceback.print_exc()
        if pulled:
            # Outside the fallback-swallowing try: a commit failure must
            # surface, not send released-writer writes down the chunk plane.
            t_bulk = time.monotonic() - t0 - t_create
            writer.commit()
            if size >= (256 << 20) and rt_config.get("transfer_log_big"):
                t_commit = time.monotonic() - t0 - t_create - t_bulk
                print(
                    f"pull_timing id={hex_id[:8]} size={size >> 20}MiB "
                    f"create={t_create:.2f}s bulk={t_bulk:.2f}s "
                    f"commit={t_commit:.2f}s "
                    f"({size / 2**30 / max(t_bulk, 1e-9):.2f} GiB/s bulk)",
                    flush=True, file=sys.stderr,
                )
            return name, size
    if size >= (256 << 20) and rt_config.get("transfer_log_big"):
        print(
            f"pull_timing id={hex_id[:8]} size={size >> 20}MiB taking CHUNK "
            f"plane (bulk addr={bool(where.get('bulk'))}, "
            f"min={rt_config.get('bulk_min_bytes') >> 20}MiB)",
            flush=True, file=sys.stderr,
        )
    try:
        sem = asyncio.Semaphore(rt_config.get("transfer_chunk_parallel"))

        async def get_chunk(off: int):
            length = min(chunk, size - off)
            async with sem:
                resp = await peer.request(
                    {"type": "fetch_chunk", **where,
                     "offset": off, "length": length},
                    timeout=tmo,
                )
            if resp.get("error"):
                raise RuntimeError(resp["error"])
            writer.write(off, resp["data"])

        await asyncio.gather(*(get_chunk(o) for o in range(0, size, chunk)))
        writer.commit()
    except BaseException:
        writer.abort()
        raise
    return name, size


def _set_pdeathsig():
    """Linux: kill this process when the parent (agent) dies."""
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        PR_SET_PDEATHSIG = 1
        libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    except Exception:  # noqa: BLE001
        pass


class NodeAgent:
    def __init__(
        self,
        node_id: str,
        controller_address: str,
        resources: Dict[str, float],
        session_dir: str,
        object_store_memory: Optional[int] = None,
        labels: Optional[Dict[str, str]] = None,
        node_ip: Optional[str] = None,
    ):
        self.node_id = node_id
        # This machine's advertised address (reference: per-node
        # node_ip_address, `services.py:295-305`); launcher args override the
        # per-machine RAY_TPU_NODE_IP env/config default.
        self.node_ip = node_ip or rt_config.get("node_ip")
        self.controller_address = controller_address
        self.resources = resources
        self.session_dir = session_dir
        self.object_store_memory = object_store_memory or (1 << 30)
        self.labels = dict(labels or {})
        self.local_store: store.LocalStore = store.LocalStore()
        self.conn: Optional[Connection] = None
        self.fetch_port = 0
        self._server: Optional[asyncio.base_events.Server] = None
        self._worker_procs: Dict[str, subprocess.Popen] = {}
        self._peer_conns: Dict[str, Connection] = {}
        # Pull admission control (reference: pull_manager.h quota): bounds
        # concurrent inbound object materializations; same-object requests
        # join the in-flight pull.
        self._pull_sem = asyncio.Semaphore(rt_config.get("transfer_max_pulls"))
        self._pulls_inflight: Dict[str, asyncio.Future] = {}
        from ..util.system_metrics import SystemMetricsSampler

        self._sys_sampler = SystemMetricsSampler()
        self._shutdown = asyncio.Event()
        # Two-level scheduling: set in start() when local_dispatch is on.
        self.dispatcher = None

    # ------------------------------------------------------------ lifecycle
    async def start(self):
        store.set_session_tag(str(os.getpid()))
        self.local_store = store.make_store(
            create_arena=True, arena_capacity=self.object_store_memory
        )
        bind = rt_config.get("bind_address") or self.node_ip
        self._server = await asyncio.start_server(
            self._on_peer_connection, host=bind, port=0
        )
        self.fetch_port = self._server.sockets[0].getsockname()[1]
        from .bulk import BulkServer

        self._bulk_server = BulkServer(self.local_store, bind_host=bind)
        bulk_port = self._bulk_server.start()
        from .forkserver import ForkServerClient

        self._forkserver = ForkServerClient(self.session_dir, self.node_id)
        if rt_config.get("worker_forkserver"):
            self._forkserver.start(pdeathsig=True)

        if rt_config.get("local_dispatch"):
            from .local_dispatch import LocalDispatcher

            self.dispatcher = LocalDispatcher(self)
            self.dispatcher.start()
        # Registration is re-announcable: a head failover closes this conn
        # and _reconnect_controller re-sends the SAME frame (the restarted
        # controller accepts re-registration over a dead record).
        self._register_payload = {
            "type": "register_node",
            "node_id": self.node_id,
            "resources": self.resources,
            "fetch_addr": f"{self.node_ip}:{self.fetch_port}",
            "bulk_addr": f"{self.node_ip}:{bulk_port}",
            "local_dispatch": self.dispatcher is not None,
            "session_tag": store.SESSION_TAG,
            "object_store_memory": self.object_store_memory,
            "labels": self.labels,
            "pid": os.getpid(),
        }
        resp = await self._connect_controller()
        if not (resp or {}).get("ok"):
            raise RuntimeError(f"node registration rejected: {resp}")

    async def _connect_controller(self) -> dict:
        host, port = self.controller_address.rsplit(":", 1)
        reader, writer = await open_rpc_connection(host, int(port))
        # on_close attaches only AFTER a successful registration: a failed
        # probe conn's close must not spawn another reconnect loop (loops
        # multiplying per failed attempt is how an agent ends up racing
        # itself into 'already registered' rejections).
        conn = Connection(reader, writer, on_push=self._on_controller_push)
        conn.start()
        try:
            resp = await conn.request(dict(self._register_payload), timeout=15)
        except (ConnectionError, OSError):
            conn.close()
            raise
        if (resp or {}).get("ok"):
            conn.on_close = self._on_controller_close
            self.conn = conn
        else:
            conn.close()
        return resp or {}

    async def _memory_monitor_loop(self):
        """Sample node memory pressure; over the limit, report worker RSS
        candidates — the controller picks and kills the victim (it knows
        which workers host actors). Reference: `memory_monitor.h:52`."""
        from ..util.memory_monitor import MemoryPressureSampler

        interval = rt_config.get("memory_monitor_interval_s")
        if not interval:
            return
        sampler = MemoryPressureSampler(
            rt_config.get("memory_limit_bytes"),
            rt_config.get("memory_usage_threshold"),
        )
        while not self._shutdown.is_set():
            await asyncio.sleep(interval)
            try:
                over = sampler.over_threshold()
                if over is None:
                    continue
                pids = {
                    wid: p.pid for wid, p in list(self._worker_procs.items())
                    if p.poll() is None
                }
                if not pids:
                    continue
                await self.conn.send({
                    "type": "memory_pressure",
                    "node_id": self.node_id,
                    "candidates": sampler.candidates(pids),
                    **over,
                })
                await asyncio.sleep(interval)  # give the kill time to land
            except Exception:  # noqa: BLE001
                traceback.print_exc()

    async def serve_forever(self):
        asyncio.ensure_future(self._memory_monitor_loop())
        await self._shutdown.wait()
        self._kill_workers()
        if self._server:
            self._server.close()
        if getattr(self, "_bulk_server", None) is not None:
            self._bulk_server.stop()
        if getattr(self, "_forkserver", None) is not None:
            self._forkserver.stop()
        if self.dispatcher is not None:
            self.dispatcher.stop()
        arena = getattr(self.local_store, "arena", None)
        self.local_store.close_all(unlink=False)
        if arena is not None:
            arena.unlink()

    def _kill_workers(self):
        # list(): the fork-flusher thread may still be registering
        # PidHandles mid-burst; a live dict would raise mid-iteration.
        for proc in list(self._worker_procs.values()):
            if proc.poll() is None:
                proc.terminate()

    async def _on_controller_close(self):
        # Controller connection dropped: the head may be RESTARTING from
        # its WAL (GCS-FT semantics), not gone. Re-announce this node with
        # capped exponential backoff; only a head that stays dead past the
        # deadline ends the session. Workers keep running throughout — the
        # data plane never needed the head.
        if self._shutdown.is_set() or getattr(self, "_reconnecting", False):
            return
        print(f"[agent {self.node_id}] controller connection lost; "
              "attempting re-announce", file=sys.stderr, flush=True)
        self._reconnecting = True
        asyncio.ensure_future(self._reconnect_controller())

    async def _reconnect_controller(self):
        try:
            deadline = time.monotonic() + rt_config.get(
                "head_reconnect_deadline_s"
            )
            delay = 0.2
            while not self._shutdown.is_set() and time.monotonic() < deadline:
                await asyncio.sleep(delay)
                delay = min(delay * 2, 2.0)
                try:
                    resp = await self._connect_controller()
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    continue
                if resp.get("ok"):
                    print(f"[agent {self.node_id}] re-announced to controller",
                          file=sys.stderr, flush=True)
                    return
        finally:
            self._reconnecting = False
        # Deadline passed with no successful re-announce FROM THIS LOOP —
        # but never shut a healthy agent down: a registration this loop saw
        # rejected as 'already registered' means another path won.
        if self._shutdown.is_set():
            return
        if self.conn is not None and not self.conn._closed:
            return
        print(f"[agent {self.node_id}] controller did not come back; "
              "shutting down", file=sys.stderr, flush=True)
        self._shutdown.set()

    # ------------------------------------------------- controller messages
    async def _on_controller_push(self, msg: dict):
        try:
            mtype = msg["type"]
            if mtype == "ping" and msg.get("req_id") is not None:
                # Liveness probe (controller `_health_check_loop`); the
                # response doubles as the node's system-metrics report
                # (reference: `reporter_agent.py:277` node reporter).
                await self.conn.respond(
                    msg["req_id"],
                    {
                        "ok": True,
                        "sys": self._sys_sampler.sample(),
                        # Spawn liveness for workers THIS agent launched: the
                        # controller has no proc handle for them, so a slow
                        # remote env boot (image pull, heavy conda activate)
                        # would otherwise be misread as dead and burn the
                        # (node, env) attempt budget (ADVICE r4).
                        "spawned_alive": [
                            wid for wid, p in list(self._worker_procs.items())
                            if p.poll() is None
                        ],
                    },
                )
            elif mtype == "enqueue_task":
                if self.dispatcher is not None:
                    self.dispatcher.enqueue(
                        msg["task"], msg["spec"], msg.get("deps") or {}
                    )
                else:  # dispatch disabled after registration — send home
                    await self.conn.send(
                        {"type": "agent_spillback", "tasks": [msg["task"]]}
                    )
            elif mtype == "cancel_task":
                if self.dispatcher is not None:
                    self.dispatcher.cancel(
                        msg["task"], force=bool(msg.get("force")),
                        worker_procs=self._worker_procs,
                    )
            elif mtype == "revoke_lease":
                if self.dispatcher is not None:
                    self.dispatcher.on_revoke(msg["worker_id"])
            elif mtype == "spawn_worker":
                self._spawn_worker(
                    msg["worker_id"], tpu=bool(msg.get("tpu")),
                    isolation=msg.get("isolation"),
                )
            elif mtype == "pull_object":
                # Long transfer — detach so other commands keep flowing.
                asyncio.ensure_future(self._handle_pull(msg))
            elif mtype == "free_object":
                self.local_store.release(msg["name"], unlink=True)
            elif mtype == "kill_worker":
                proc = self._worker_procs.get(msg["worker_id"])
                if proc is not None and proc.poll() is None:
                    proc.terminate()
            elif mtype == "tail_log" and msg.get("req_id") is not None:
                await self.conn.respond(msg["req_id"], self._tail_log(msg))
            elif mtype == "exit":
                self._shutdown.set()
        except Exception:  # noqa: BLE001
            traceback.print_exc()

    def _spawn_worker(self, worker_id: str, tpu: bool = False,
                      isolation: Optional[dict] = None):
        # Spawn-env template, built once (same fix as the controller's
        # _spawn_worker): dict(os.environ) iterates the environ Mapping in
        # Python per spawn — a pure-overhead tax on registration storms.
        base = getattr(self, "_spawn_env_base", None)
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        if base is None:
            base = dict(os.environ)
            base["PYTHONPATH"] = pkg_root + os.pathsep + base.get("PYTHONPATH", "")
            base["RAY_TPU_ADDRESS"] = self.controller_address
            base["RAY_TPU_NODE_IP"] = self.node_ip  # workers bind/advertise here
            base["RAY_TPU_SESSION_DIR"] = self.session_dir
            base["RAY_TPU_SESSION_TAG"] = store.SESSION_TAG  # this node's arena
            base["RAY_TPU_NODE_ID"] = self.node_id
            base["PYTHONUNBUFFERED"] = "1"  # log tailing needs unbuffered stdout
            self._spawn_env_base = base
        env = dict(base)
        env["RAY_TPU_WORKER_ID"] = worker_id
        # reference: TPU plugin env, ray_tpu/core/node_agent.py:482-488
        env["RAY_TPU_WORKER_TPU"] = "1" if tpu else "0"
        pin_worker_devices(env, tpu, self.resources.get(ACCELERATOR, 0))
        log_path = os.path.join(self.session_dir, f"worker-{worker_id}.log")
        argv = [sys.executable, "-m", "ray_tpu_torch.core.worker_main"]
        if isolation is not None:
            # conda/container wrap (reference: runtime-env workers start
            # through the agent's env setup) — forkserver can't serve these.
            from ..runtime_env.isolation import build_argv

            env["RAY_TPU_ENV_KEY"] = isolation["key"]
            try:
                argv = build_argv(isolation, argv, env, self.session_dir)
            except Exception as e:  # noqa: BLE001 — binary missing here
                try:
                    self.conn.post({
                        "type": "worker_spawn_failed", "worker_id": worker_id,
                        "error": repr(e), "tpu": tpu,
                    })
                except Exception:  # noqa: BLE001
                    pass
                return
        def _popen_cold(wid, e, lp, argv=list(argv), cwd=pkg_root):
            log_f = open(lp, "ab")
            self._worker_procs[wid] = subprocess.Popen(
                argv,
                env=e,
                stdout=log_f,
                stderr=subprocess.STDOUT,
                cwd=cwd,
                preexec_fn=_set_pdeathsig,
            )

        fs = getattr(self, "_forkserver", None)
        # GPU workers fork too (see the controller's _spawn_worker).
        # (reference: `not tpu and ...`, TPU workers cold, ray_tpu/core/node_agent.py:520)
        if isolation is None and fs is not None and fs.usable:
            # Async + batched, off the event loop (see ForkServerClient.
            # spawn_async); failed trips recover via spawn-ledger expiry.
            fs.spawn_async(
                worker_id, env, log_path, self._worker_procs.__setitem__
            )
            return
        _popen_cold(worker_id, env, log_path)

    def _tail_log(self, msg: dict) -> dict:
        """Serve this node's worker-log increments to the controller."""
        from .log_utils import read_log_chunk

        path = os.path.join(self.session_dir, f"worker-{msg['worker_id']}.log")
        if msg.get("init"):
            try:
                return {"data": "", "offset": os.path.getsize(path)}
            except OSError:
                return {}
        got = read_log_chunk(path, msg.get("offset", 0))
        if got is None:
            return {}
        data, offset = got
        return {"data": data.decode(errors="replace"), "offset": offset}

    # ------------------------------------------------------------ transfer
    async def _peer(self, addr: str) -> Connection:
        conn = self._peer_conns.get(addr)
        if conn is not None and not conn._closed:
            return conn
        host, port = addr.rsplit(":", 1)
        reader, writer = await open_rpc_connection(host, int(port))
        conn = Connection(reader, writer)
        conn.start()
        self._peer_conns[addr] = conn
        return conn

    async def _handle_pull(self, msg: dict):
        """Fetch an object from a peer node into the local arena, streamed
        in bounded-parallel CHUNKS with per-chunk progress deadlines and
        node-level admission control. Reference analog: `PullManager`
        (`pull_manager.h:52`) + the object manager's chunked transfer
        (`object_manager.h`, default 5 MiB chunks). Same-object pulls JOIN
        the in-flight transfer instead of racing its partial writes (a
        controller-side timeout retry must never observe half-written
        bytes through create_begin's already-exists fast path)."""
        import asyncio

        req_id = msg.get("req_id")
        hex_id = msg["id"]
        inflight = self._pulls_inflight.get(hex_id)
        if inflight is not None:
            try:
                result = dict(await inflight)
            except Exception as e:  # noqa: BLE001
                result = {"ok": False, "error": repr(e)}
            if req_id is not None:
                await self.conn.respond(req_id, result)
            return
        fut = asyncio.get_running_loop().create_future()
        self._pulls_inflight[hex_id] = fut
        try:
            async with self._pull_sem:
                peer = await self._peer(msg["addr"])
                where = (
                    {"name": msg["name"]} if msg.get("name")
                    else {"path": msg["path"]}
                )
                if msg.get("bulk"):
                    where["bulk"] = msg["bulk"]
                name, size = await pull_chunked(
                    peer, where, self.local_store, hex_id,
                    size_hint=msg.get("size", 0),
                )
                result = {"ok": True, "name": name, "size": size}
            fut.set_result(result)
        except Exception as e:  # noqa: BLE001
            result = {"ok": False, "error": repr(e)}
            fut.set_exception(e)
            fut.exception()  # consumed here even with no joiners
        finally:
            self._pulls_inflight.pop(hex_id, None)
        if req_id is not None:
            await self.conn.respond(req_id, result)

    # ------------------------------------------------------- peer fetches
    async def _on_peer_connection(self, reader, writer):
        conn = Connection(reader, writer, expected_token=auth_token())

        async def on_push(msg: dict):
            if msg.get("req_id") is None:
                return
            try:
                payload = serve_fetch(self.local_store, msg)
                if payload is None:
                    return
                await conn.respond(msg["req_id"], payload)
            except Exception as e:  # noqa: BLE001
                await conn.respond(msg["req_id"], {"error": repr(e)})

        conn.on_push = on_push
        conn.start()


async def run_agent(args: dict):
    agent = NodeAgent(
        node_id=args["node_id"],
        controller_address=args["address"],
        resources=args.get("resources", {}),
        session_dir=args["session_dir"],
        object_store_memory=args.get("object_store_memory"),
        labels=args.get("labels"),
        node_ip=args.get("node_ip"),
    )
    # Graceful stop on SIGTERM (cluster_utils.remove_node(allow_graceful=True),
    # `kill <pid>` by an operator): run the serve_forever teardown — killing
    # workers and unlinking this node's arena — instead of leaking the shm
    # segment (reference: raylet's SIGTERM handler drains + shuts down
    # plasma, `src/ray/raylet/main.cc` shutdown_raylet_gracefully).
    loop = asyncio.get_running_loop()
    loop.add_signal_handler(signal.SIGTERM, agent._shutdown.set)
    await agent.start()
    print(f"RAY_TPU_NODE_READY={agent.node_id}", flush=True)
    await agent.serve_forever()


def main():
    args = json.loads(os.environ["RAY_TPU_NODE_ARGS"])
    try:
        asyncio.run(run_agent(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()

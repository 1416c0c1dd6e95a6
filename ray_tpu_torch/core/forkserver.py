"""Warm-worker forkserver: fork pre-imported worker processes in ~10 ms.

Reference analog: `WorkerPool::PrestartWorkers` + startup tokens
(`src/ray/raylet/worker_pool.h:354`, `:455`). The reference amortizes worker
boot by pre-forking on backlog hints; here the amortization is structural —
a per-node TEMPLATE process pays the interpreter+import cost once (python +
numpy + the worker module + torch, its CUDA left uninitialised), then
`fork()`s a ready worker per request in ~10 ms. (reference: jax-on-CPU,
ray_tpu/core/forkserver.py:7) This is what turns the
2,000-actor envelope from boot-bound (ENVELOPE_r3: 1,943 s) into
fork-bound.

Design constraints:
  * The template starts no thread of its own and runs no asyncio loop
    while it serves — fork() of a multithreaded process can deadlock the
    child on locks held by threads that do not survive the fork. What it
    imports may start threads: numpy's BLAS starts its pool at import (8
    threads on an 8-core host), and `import torch` adds none. torch is
    imported (the expensive part) but the template runs NO torch op — the
    first parallel op starts torch's intra-op pool, and a child forked
    after that can hang — and never initialises CUDA (a CUDA context does
    not survive fork). `TEMPLATE_REPORT` (also in the template's log) says
    what held when the template began to serve; forked children inherit it.
  * GPU workers fork from the template too. The template sees no card
    (`CUDA_VISIBLE_DEVICES=""`, like every CPU worker) and never calls
    into CUDA, so the CUDA driver reads a child's `CUDA_VISIBLE_DEVICES` (its
    cards, set from the spawn request's env) at the child's first CUDA
    call. A fork saves the child `import torch` (~10 s a cold interpreter
    on the H100 host). At most one GPU worker boots per node.
  (reference: a single-threaded jax template and cold TPU workers,
  ray_tpu/core/forkserver.py:13-20)
  * Children are auto-reaped (SIGCHLD ignored in the template); callers
    track liveness by pid via PidHandle, which quacks like Popen.

Wire: one unix-domain request per connection on the session-dir socket —
[u32 len][json {worker_id, env, log_path}] → [u32 len][json {pid}].
"""

from __future__ import annotations

import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Dict, Optional

from .devices import pin_worker_devices  # the GPU worker kind (reference: none)

_LEN = struct.Struct("<I")
READY_LINE = "RAY_TPU_FORKSERVER_READY"


def _send_msg(sock: socket.socket, obj: dict):
    body = json.dumps(obj).encode()
    sock.sendall(_LEN.pack(len(body)) + body)


def _recv_msg(sock: socket.socket) -> dict:
    buf = b""
    while len(buf) < 4:
        chunk = sock.recv(4 - len(buf))
        if not chunk:
            raise ConnectionError("forkserver peer closed")
        buf += chunk
    (n,) = _LEN.unpack(buf)
    body = b""
    while len(body) < n:
        chunk = sock.recv(n - len(body))
        if not chunk:
            raise ConnectionError("forkserver peer closed")
        body += chunk
    return json.loads(body)


class PidHandle:
    """Popen-shaped handle over a bare pid (forked workers have no Popen).

    SIGCHLD is ignored in the forking TEMPLATE (children reparent nowhere —
    the template auto-reaps), so liveness here is signal-0 probing."""

    def __init__(self, pid: int):
        self.pid = pid
        self._rc: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self._rc is not None:
            return self._rc
        try:
            os.kill(self.pid, 0)
            return None
        except (ProcessLookupError, PermissionError):
            self._rc = -1
            return self._rc

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired("forked-worker", timeout)
            time.sleep(0.02)
        return self._rc

    def _signal(self, sig):
        try:
            os.kill(self.pid, sig)
        except ProcessLookupError:
            self._rc = -1

    def terminate(self):
        self._signal(signal.SIGTERM)

    def kill(self):
        self._signal(signal.SIGKILL)

    def send_signal(self, sig):
        self._signal(sig)


class ForkServerClient:
    """Owns one template process and hands out forked workers."""

    def __init__(self, session_dir: str, name: str):
        self.session_dir = session_dir
        self.sock_path = os.path.join(session_dir, f"forkserver-{name}.sock")
        self.log_path = os.path.join(session_dir, f"forkserver-{name}.log")
        self.proc: Optional[subprocess.Popen] = None
        self._ready = False
        # spawn_async coalescing (see there).
        self._q: list = []
        self._q_lock = threading.Lock()
        self._flusher_active = False
        # Wedged-template latch: consecutive failed TRIPS against a template
        # whose process is still alive (socket up, requests timing out). The
        # spawn-ledger recovery path re-checks `ready`, which only went False
        # on template DEATH — without this latch a wedged-but-alive template
        # loops warm retries forever and CPU workers never boot (ADVICE r4).
        self._trip_failures = 0
        self._wedged = False

    def start(self, pdeathsig: bool = False):
        """Launch the template (non-blocking: readiness is polled later).

        pdeathsig=True chains process lineage to the caller: caller death
        kills the template, which kills its forked workers — the node-agent
        semantics ("workers die with the agent"). Head-side templates leave
        it off so workers survive a controller crash (controller FT)."""
        env = dict(os.environ)
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        env["RAY_TPU_FORK_SOCK"] = self.sock_path
        env["RAY_TPU_FORK_PDEATHSIG"] = "1" if pdeathsig else "0"
        # Forked workers must see the SAME cwd as cold-spawned ones (the
        # spawner's), not the template's pkg_root — tasks with relative
        # paths would otherwise behave differently depending on which spawn
        # path won the readiness race.
        env["RAY_TPU_FORK_CWD"] = os.getcwd()
        env["PYTHONUNBUFFERED"] = "1"
        # CPU pin — same as cold CPU-worker spawns: the template sees no card
        # (a GPU worker forked from it is given its cards in its spawn env).
        # (reference: TPU plugin env, ray_tpu/core/forkserver.py:152-157)
        env["RAY_TPU_WORKER_TPU"] = "0"
        pin_worker_devices(env, False, 0)
        try:
            os.unlink(self.sock_path)
        except OSError:
            pass
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.forkserver"],
            env=env,
            stdout=open(self.log_path, "ab"),
            stderr=subprocess.STDOUT,
            cwd=pkg_root,
        )

    @property
    def ready(self) -> bool:
        """True while the template is alive and accepting fork requests.
        Re-checks liveness every call: a dead template must flip this back
        to False so spawners fall back to cold Popen instead of retrying
        the warm path forever."""
        if self._wedged:
            return False
        if self.proc is None or self.proc.poll() is not None:
            self._ready = False
            return False
        if not self._ready:
            self._ready = os.path.exists(self.sock_path)
        return self._ready

    @property
    def usable(self) -> bool:
        """True while the template is ready OR still BOOTING (alive, not
        wedged). Spawn demand should queue on a booting template instead of
        falling back to cold Popen: a burst of cold interpreter boots
        starves the template's own import on a small host, locking the
        whole session into the ~200x slower cold path (observed: a
        100-actor burst at session start kept the template unready for its
        entire 41 s; the same burst through the template is ~1 s of forks)."""
        if self._wedged:
            return False
        return self.proc is not None and self.proc.poll() is None

    def spawn(self, worker_id: str, env: Dict[str, str], log_path: str) -> PidHandle:
        """Fork a worker (blocking, ~10 ms). Raises if the template is gone."""
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(10.0)
        try:
            sock.connect(self.sock_path)
            _send_msg(sock, {"worker_id": worker_id, "env": env,
                             "log_path": log_path})
            resp = _recv_msg(sock)
        finally:
            sock.close()
        if "pid" not in resp:
            raise RuntimeError(f"forkserver error: {resp.get('error')}")
        return PidHandle(resp["pid"])

    def spawn_async(self, worker_id: str, env: Dict[str, str], log_path: str,
                    register) -> None:
        """Queue a fork; `register(worker_id, PidHandle)` fires from the
        flusher thread. Queued requests coalesce into BATCHED template round
        trips — a 2,000-actor burst pays ~60 round trips instead of 2,000
        (each trip costs a template scheduling delay on a loaded host, and
        none of them may block the caller's event loop).

        A failed TRIP (template death, timeout) deliberately does NOT
        cold-respawn here: the forks may have succeeded before the failure
        (a reply timeout proves nothing), and a blind respawn would
        duplicate live worker_ids. Recovery is the spawn ledger: boots that
        never register expire and re-fire demand through _schedule, which
        re-checks `ready` (False once the template is gone) and takes the
        cold path."""
        with self._q_lock:
            self._q.append((worker_id, env, log_path, register))
            if self._flusher_active:
                return
            self._flusher_active = True
        threading.Thread(
            target=self._flush_spawns, name="rtpu-fork-flush", daemon=True
        ).start()

    def _flush_spawns(self):
        # Wait out the template's boot (interpreter + imports, seconds —
        # longer on a thrashed host) before the first trip: demand queued
        # here is exactly what must NOT fall back to cold Popen.
        deadline = time.monotonic() + 120.0
        while (
            not self.ready
            and self.usable
            and time.monotonic() < deadline
        ):
            time.sleep(0.25)
        while True:
            with self._q_lock:
                batch = self._q[:32]
                del self._q[:32]
                if not batch:
                    self._flusher_active = False
                    return
            try:
                t0 = time.monotonic()
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.settimeout(30.0)
                try:
                    sock.connect(self.sock_path)
                    _send_msg(sock, {"batch": [
                        {"worker_id": w, "env": e, "log_path": lp}
                        for w, e, lp, _ in batch
                    ]})
                    resp = _recv_msg(sock)
                finally:
                    sock.close()
                import sys as _sys
                print(f"fs-trip n={len(batch)} {time.monotonic()-t0:.2f}s",
                      flush=True, file=_sys.stderr)
                pids = resp.get("pids")
                if pids is None:
                    raise RuntimeError(f"forkserver error: {resp.get('error')}")
                for (wid, _, _, register), pid in zip(batch, pids):
                    if pid:
                        register(wid, PidHandle(pid))
                self._trip_failures = 0
                # A successful trip disproves the wedge diagnosis (e.g. two
                # transient timeouts under host load) — un-latch so the rest
                # of the session keeps the ~10 ms warm path.
                self._wedged = False
            except Exception:  # noqa: BLE001 — template gone/wedged; see
                # spawn_async docstring for why there is NO cold fallback
                # here (duplicate worker_id risk).
                import traceback

                traceback.print_exc()
                self._trip_failures += 1
                if self._trip_failures >= 2 and not self._wedged:
                    # Two consecutive failed trips = the template is wedged
                    # even if its process is alive. Latch `ready` False so
                    # ledger-expiry respawns take the cold Popen path. Do NOT
                    # kill the template: on agent nodes its forked workers
                    # chain pdeathsig to it — killing it would take live
                    # workers down with it.
                    self._wedged = True
                    print(
                        f"forkserver: latched wedged after "
                        f"{self._trip_failures} failed trips; cold spawns",
                        flush=True,
                    )

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
        try:
            os.unlink(self.sock_path)
        except OSError:
            pass


# ------------------------------------------------------------------ template
# (reference: none — the port's template reports its state.)
# What held in the template when it began to serve (set there, inherited by
# every forked child): {"torch": imported, "cuda_initialized": ...,
# "threads": OS threads of the process}. Empty outside a template's lineage.
TEMPLATE_REPORT: Dict[str, object] = {}


def _report_template():
    # The template runs as __main__: report on the module children import.
    from . import forkserver

    torch = sys.modules.get("torch")
    forkserver.TEMPLATE_REPORT.update(
        torch=torch is not None,
        cuda_initialized=bool(torch is not None and torch.cuda.is_initialized()),
        threads=len(os.listdir("/proc/self/task")) if os.path.isdir("/proc/self/task") else -1,
    )
    print(f"forkserver template: {json.dumps(forkserver.TEMPLATE_REPORT)}", flush=True)


def _set_pdeathsig():
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except Exception:  # noqa: BLE001
        pass


def _child_exec(req: dict):
    """Forked child → worker. Never returns.

    (r5 note: batching the child's COW faults with MADV_POPULATE_WRITE on
    all writable-private ranges was tried and is a NET LOSS — children
    lazily touch far less of the template heap than a full populate
    copies; 500-actor burst regressed 59s → 231s.)"""
    if os.environ.get("RAY_TPU_FORK_PDEATHSIG") == "1":
        _set_pdeathsig()  # die with the TEMPLATE (which dies with the agent)
    os.setsid()
    fd = os.open(req["log_path"], os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    signal.signal(signal.SIGCHLD, signal.SIG_DFL)
    os.environ.update(req["env"])
    try:
        os.chdir(os.environ.get("RAY_TPU_FORK_CWD", os.getcwd()))
    except OSError:
        pass  # spawner's cwd vanished; keep the template's
    from . import worker_main

    worker_main.main()
    os._exit(0)


def template_main():
    sock_path = os.environ["RAY_TPU_FORK_SOCK"]
    if os.environ.get("RAY_TPU_FORK_PDEATHSIG") == "1":
        _set_pdeathsig()  # die with the node agent

    # The expensive part, paid exactly once per node: interpreter + imports.
    import numpy  # noqa: F401
    from . import worker_main  # noqa: F401  (pulls rpc/store/serialization)
    # The in-task client API stack too — _init_client_api would otherwise
    # import+compile these per forked child (~120 ms each on the bench host).
    from . import api, cluster_backend, remote_function, runtime  # noqa: F401
    from ..util import placement_group  # noqa: F401  (api's lazy import)
    # The flight ring is imported lazily by worker_main's task-events flush
    # and by _connect's clock handshake — post-fork, that's private pages in
    # every child. Import here so the module body lands on template pages;
    # the per-process recorder singleton itself is NOT created (children
    # build their own empty ring on first record()).
    from ..util import flight as _flight

    _flight.enabled()  # warm the env parse too
    # Native libs: dlopen + ctypes prototype setup once; children inherit
    # the loaded handle through fork instead of re-opening per boot.
    from .. import native as _native

    _native.load_arena_lib()
    _native.load_channel_lib()
    # reference: `import jax`, ray_tpu/core/forkserver.py:375-378
    try:
        import torch  # noqa: F401  — import only: no op, no CUDA
    except Exception:  # noqa: BLE001 — workers degrade to import-at-use
        pass

    # Pre-WARM (not just pre-import) the child's boot paths: many stdlib /
    # codec layers build caches on FIRST USE (asyncio's event-loop policy +
    # selector machinery, pickle/cloudpickle dispatch tables, msgpack
    # packer state, struct/re caches). Exercising each once HERE puts those
    # caches on template pages every child shares copy-on-write, instead of
    # each child privately rebuilding them — measured ~1.5 MB off per-child
    # USS, which is what bounds how many workers one host can hold
    # resident (the 10k-actor envelope wave).
    try:
        import asyncio

        _loop = asyncio.new_event_loop()

        async def _warm_srv():
            s = await asyncio.start_server(
                lambda r, w: None, host="127.0.0.1", port=0
            )
            s.close()
            await s.wait_closed()

        _loop.run_until_complete(_warm_srv())
        _loop.close()
        asyncio.set_event_loop(None)

        import cloudpickle

        class _Warm:
            def ping(self):
                return 1

        cloudpickle.loads(cloudpickle.dumps((_Warm, (), {})))
        del _Warm
        from . import serialization as _ser

        _ser.unpack(_ser.pack({"warm": 1}))
        from .rpc import decode_msg as _dec, encode_msg as _enc

        _dec(_enc({"type": "warm", "a": [1, 2.0, "s", b"b", (1, 2)],
                   "d": {"k": 1}})[4:])
        import collections  # noqa: F401
        import concurrent.futures  # noqa: F401
        import inspect  # noqa: F401
        import queue  # noqa: F401
        import traceback  # noqa: F401
        # The protobuf stack (google.protobuf + upb + the generated pb2) is
        # the single largest post-fork import — every child decodes its
        # first TaskSpec through it. Import AND roundtrip once here so the
        # descriptor pool / reflection caches live on shared pages.
        from .task_spec import (  # noqa: F401
            TaskOptions as _TO,
            TaskSpec as _TS,
            spec_from_proto_bytes as _sfpb,
            spec_to_proto_bytes as _stpb,
        )
        from .ids import JobID as _JID, TaskID as _TID
        from .task_spec import TaskType as _TT

        _jid = _JID.from_int(1)
        _tid = _TID.for_driver(_jid)
        _sfpb(_stpb(_TS(
            task_id=_tid, job_id=_jid, task_type=_TT.NORMAL_TASK,
            func_payload=b"", arg_refs=[], num_returns=1, return_ids=[],
            resources={}, options=_TO(), name="warm",
        )))
    except Exception:  # noqa: BLE001 — warming is best-effort; children
        # simply rebuild whatever failed to warm
        pass

    # Freeze the heap into the permanent generation: forked children never
    # GC-walk (and so never copy-on-write-fault) the template's ~100s of MB
    # of imported modules. On lazily-backed guests COW faults are extra
    # expensive (core/mem.py), so this directly cuts fork-to-ready time.
    import gc

    gc.collect()
    gc.freeze()
    _report_template()  # reference: none

    signal.signal(signal.SIGCHLD, signal.SIG_IGN)  # auto-reap forked workers
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    tmp = sock_path + ".tmp"
    try:
        os.unlink(tmp)
    except OSError:
        pass
    srv.bind(tmp)
    os.chmod(tmp, 0o600)
    srv.listen(64)
    os.rename(tmp, sock_path)  # atomic: socket existence signals readiness
    print(READY_LINE, flush=True)

    while True:
        try:
            conn, _ = srv.accept()
        except OSError:
            return
        try:
            _t0 = time.time()
            req = _recv_msg(conn)
            reqs = req["batch"] if "batch" in req else [req]
            print(f"fs-tmpl recv n={len(reqs)} wall={time.time():.2f}", flush=True)
            pids = []
            for r in reqs:
                # Per-item failure (fork EAGAIN) records pid 0 and CONTINUES:
                # a partial abort after some children forked would make the
                # caller guess which booted — and a guessed cold respawn
                # duplicates a live worker_id.
                try:
                    pid = os.fork()
                except OSError:
                    pids.append(0)
                    continue
                if pid == 0:
                    srv.close()
                    conn.close()
                    try:
                        _child_exec(r)
                    finally:
                        os._exit(1)
                pids.append(pid)
            if "batch" in req:
                _send_msg(conn, {"pids": pids})
            else:
                _send_msg(conn, {"pid": pids[0]})
            print(f"fs-tmpl replied n={len(pids)} took={time.time()-_t0:.2f}s", flush=True)
        except Exception as e:  # noqa: BLE001 — report; keep serving
            try:
                _send_msg(conn, {"error": repr(e)})
            except OSError:
                pass
        finally:
            conn.close()


if __name__ == "__main__":
    template_main()

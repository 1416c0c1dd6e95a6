"""Bulk object-transfer plane: raw sockets + sendfile/recv_into, no pickle.

Reference analog: the object manager's chunked transfer over its buffer pool
(`src/ray/object_manager/object_buffer_pool.h:30`) and plasma's fd-passing
handover (`src/ray/object_manager/plasma/fling.cc:1`). Redesign for a
Python-hosted runtime on a weak host CPU: the hot path never holds object
bytes in Python objects at all —

  * the SERVER hands the kernel a (fd, offset, length) span of the shm
    segment backing the object (`os.sendfile`: page cache → socket, zero
    userspace copies, GIL released);
  * the RECEIVER lands bytes straight in the destination arena mapping
    (`socket.recv_into` on a memoryview slice of the incremental writer:
    one kernel→arena copy, GIL released).

The control plane (who pulls what from where) stays on the authenticated
closed-grammar msgpack RPC plane (`rpc.py` — no pickle on the wire); this
module moves only sealed bytes, after the same fixed-format auth preamble. Large objects split into a few contiguous
spans pulled over parallel connections (`bulk_streams`); each span's recv
loop enforces a PROGRESS deadline (`transfer_chunk_timeout_s` of no bytes ⇒
abort), mirroring the per-chunk deadlines of the RPC chunk plane.

SAME-HOST handover (`mode: "map"`): instead of bytes, the server answers
with the backing file's (path, offset, size) and holds the object pinned
until the client acks — the plasma fd-passing design
(`plasma/fling.cc:1`), by name instead of SCM_RIGHTS (POSIX shm is
name-addressable, so passing the name is the same capability). The puller
preads the span straight into its own arena mapping: ONE copy, no TCP
stack — intra-host transfers never ride the network, exactly like the
reference, where the object manager only runs across machines.

Wire format, per request on a persistent authed connection:
    -> [u32 len][json {name|path, offset, length, mode?}]
    <- [u8 status][u64 n][n bytes]   status 0 = data, 1 = utf8 error,
                                     2 = map json; client acks 1 byte after
                                     copying (the server holds the pin)
"""

from __future__ import annotations

import contextlib
import errno
import json
import os
import queue
import socket
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

from . import config as rt_config
from .rpc import _AUTH_MAGIC, _LEN, auth_token
from .serialization import _pwrite_all

_HDR = struct.Struct("<BQ")
_SENDFILE_SPAN = 32 << 20  # max bytes per sendfile syscall (keeps EINTR cheap)
_RECV_SPAN = 4 << 20


class ChunkPipeline:
    """Bounded-window chunked transfer bookkeeping (reference analog: the
    push manager's chunked in-flight window, `push_manager.h:30`).

    One READER (the calling thread) fills fixed-size chunks via `fill_fn`;
    `landers` LANDER thread(s) land them at their offsets via `land_fn`
    (positional writes — landing order does not matter). At most `window`
    chunk buffers exist, so a stalled lander back-pressures the reader
    through the free-buffer pool, and a stalled reader leaves landers
    parked on an empty queue. PROGRESS deadlines on both sides: the reader
    aborts when no buffer frees within `deadline_s` (landing stalled), and
    `fill_fn` is expected to enforce its own read-side progress deadline
    (socket timeout). Any side's exception aborts the whole transfer —
    `run()` re-raises it after unwinding the threads, so the caller's
    writer.abort() leaves no partial object visible.
    """

    def __init__(self, length: int, chunk: int, window: int,
                 land_fn: Callable[[memoryview, int], None],
                 deadline_s: float, landers: int = 1):
        if chunk <= 0 or window < 2:
            raise ValueError("ChunkPipeline needs chunk > 0 and window >= 2")
        self.length = length
        self.chunk = chunk
        self.window = window
        self.land_fn = land_fn
        self.deadline_s = deadline_s
        self.landers = max(1, landers)
        self._free: "queue.Queue" = queue.Queue()
        self._filled: "queue.Queue" = queue.Queue()
        self._errors: list = []
        # Window-bound observability (asserted by tests): buffers checked
        # out of the free pool and not yet returned.
        self.max_outstanding = 0
        self._outstanding = 0
        self._stat_lock = threading.Lock()

    def _land_loop(self):
        while True:
            item = self._filled.get()
            if item is None:
                return
            buf, off, ln = item
            try:
                if not self._errors:
                    self.land_fn(memoryview(buf)[:ln], off)
            except BaseException as e:  # noqa: BLE001 — reader re-raises
                self._errors.append(e)
            finally:
                with self._stat_lock:
                    self._outstanding -= 1
                self._free.put(buf)

    def run(self, fill_fn: Callable[[memoryview], None]):
        """Pump `length` bytes: `fill_fn(view)` must fill the whole view
        (raising on EOF/timeout); chunks land concurrently."""
        for _ in range(self.window):
            self._free.put(bytearray(min(self.chunk, max(self.length, 1))))
        threads = [
            threading.Thread(target=self._land_loop, daemon=True,
                             name="rtpu-bulk-land")
            for _ in range(self.landers)
        ]
        for t in threads:
            t.start()
        try:
            got = 0
            while got < self.length:
                try:
                    buf = self._free.get(timeout=self.deadline_s)
                except queue.Empty:
                    raise socket.timeout(
                        f"bulk landing stalled: no chunk landed within "
                        f"{self.deadline_s}s (window {self.window})"
                    ) from None
                if self._errors:
                    raise self._errors[0]
                with self._stat_lock:
                    self._outstanding += 1
                    self.max_outstanding = max(
                        self.max_outstanding, self._outstanding
                    )
                ln = min(self.chunk, self.length - got)
                fill_fn(memoryview(buf)[:ln])
                self._filled.put((buf, got, ln))
                got += ln
        except BaseException:
            self._errors.append(None)  # poison: landers skip remaining work
            raise
        finally:
            for _ in threads:
                self._filled.put(None)
            for t in threads:
                t.join(timeout=max(self.deadline_s, 1.0))
        if any(t.is_alive() for t in threads):
            # A lander is still stuck past the deadline: returning success
            # here would finalize an object with a hole in it AND leave a
            # daemon thread pwrite-ing a descriptor the caller is about to
            # close/recycle. Poison the pipeline (the lander skips any
            # further land_fn work when it unblocks) and abort the
            # transfer instead.
            self._errors.insert(0, None)
            raise socket.timeout(
                f"bulk landing stuck: lander did not finish within "
                f"{self.deadline_s}s of transfer end"
            )
        if self._errors and self._errors[0] is not None:
            raise self._errors[0]


def _native_land_mode() -> Optional[str]:
    """Which native landing path to use, or None for pure Python.

    `bulk_native_lander`: "auto" (stream when the extension builds),
    "stream" (whole-span poll/read/pwrite loop in C — the payload never
    passes through Python), "ring" (Python recv_into + native pinned lander
    thread consuming a (buf, off, len) descriptor ring), "off". Any value
    other than "off" degrades to the pure-Python pipeline when the native
    extension is unbuildable (no g++, unsupported platform)."""
    mode = str(rt_config.get("bulk_native_lander")).lower()
    if mode in ("off", "0", "false", "no"):
        return None
    from .. import native as _native

    if _native.load_bulk_lib() is None:
        return None
    return "ring" if mode == "ring" else "stream"


# Chunk buffers a stuck native lander may still be pwrite-ing when its close
# deadline expires: freeing them would be a use-after-free, so they are
# parked here forever (same contract as ChunkPipeline's stuck-lander abort,
# which leaves its daemon thread holding the Python buffer).
_LEAKED_RING_BUFFERS: list = []


def _land_stream_native(sock: socket.socket, fd: int, dst_off: int,
                        length: int, deadline_s: float):
    """Whole-span native landing: one ctypes call (GIL released throughout)
    runs the poll/read/pwrite loop in C. poll() enforces the same PROGRESS
    deadline as the Python path — any byte re-arms it."""
    from .. import native as _native

    lib = _native.load_bulk_lib()
    rc = lib.rt_bulk_land_stream(
        sock.fileno(), fd, dst_off, length,
        int(max(deadline_s, 0.001) * 1000),
    )
    if rc == length:
        return
    err = int(-rc)
    import errno as _errno

    if err == _errno.ETIMEDOUT:
        raise socket.timeout(
            f"bulk landing stalled: no socket progress within {deadline_s}s "
            f"(native stream lander)"
        )
    if err == _errno.EPIPE:
        raise ConnectionError("bulk peer closed mid-span")
    raise OSError(err, f"native bulk landing failed: {os.strerror(err)}")


def _land_ring_native(sock: socket.socket, fd: int, dst_off: int, length: int,
                      chunk: int, window: int, deadline_s: float):
    """Bounded-window landing with the pwrites on a NATIVE pinned thread:
    this thread recv_into's chunk buffers (GIL released in the syscall) and
    hands (buffer, offset, len) descriptors to the C ring; completion is
    FIFO, so buffer `k` is recyclable once `k+1` chunks have landed. Same
    window bound and progress deadlines as ChunkPipeline, without a Python
    lander thread in the GIL rotation."""
    import ctypes
    import errno as _errno

    from .. import native as _native

    def _ring_err(rc: int):
        err = int(-rc)
        if err == _errno.ETIMEDOUT:
            raise socket.timeout(
                f"bulk landing stalled: no chunk landed within {deadline_s}s "
                f"(native ring lander, window {window})"
            )
        raise OSError(err, f"native bulk landing failed: {os.strerror(err)}")

    lib = _native.load_bulk_lib()
    h = lib.rt_lander_create(fd, window)
    if not h:
        raise OSError("native ring lander create failed")
    bufs = [bytearray(min(chunk, max(length, 1))) for _ in range(window)]
    cbufs: list = [None] * window  # keep ctypes views alive while in flight
    tmo_ms = int(max(deadline_s, 0.001) * 1000)
    try:
        got = 0
        submitted = 0
        sock.settimeout(deadline_s)
        while got < length:
            slot = submitted % window
            if submitted >= window:
                # Recycle the slot only after its previous chunk landed.
                rc = lib.rt_lander_wait(h, submitted - window + 1, tmo_ms)
                if rc != 0:
                    _ring_err(rc)
            buf = bufs[slot]
            ln = min(chunk, length - got)
            view = memoryview(buf)[:ln]
            filled = 0
            while filled < ln:
                r = sock.recv_into(view[filled:])
                if r == 0:
                    raise ConnectionError("bulk peer closed mid-span")
                filled += r
            cb = (ctypes.c_char * ln).from_buffer(buf)
            rc = lib.rt_lander_submit(h, cb, dst_off + got, ln, tmo_ms)
            if rc < 0:
                _ring_err(rc)
            cbufs[slot] = cb
            submitted += 1
            got += ln
        rc = lib.rt_lander_wait(h, submitted, tmo_ms)
        if rc != 0:
            _ring_err(rc)
    finally:
        if lib.rt_lander_close(h, tmo_ms) != 0:
            # Lander stuck past the deadline mid-pwrite: the buffers must
            # outlive it (see bulk.cpp header). The transfer itself aborts
            # via the exception already in flight.
            _LEAKED_RING_BUFFERS.append((bufs, cbufs))


def _recv_exact_into(sock: socket.socket, view: memoryview, deadline_s: float):
    """Fill `view` from the socket; the deadline applies to PROGRESS (any
    recv returning bytes resets it), not the whole span."""
    got = 0
    n = len(view)
    sock.settimeout(deadline_s)
    while got < n:
        r = sock.recv_into(view[got:got + _RECV_SPAN])
        if r == 0:
            raise ConnectionError("bulk peer closed mid-span")
        got += r


def _recv_exact(sock: socket.socket, n: int, deadline_s: float) -> bytes:
    buf = bytearray(n)
    _recv_exact_into(sock, memoryview(buf), deadline_s)
    return bytes(buf)


class BulkServer:
    """Per-process bulk-read server over the local object store.

    Plain blocking sockets on daemon threads — NOT asyncio: the event loop
    must never carry object bytes (that is what capped the old chunk plane
    at 0.16 GiB/s), and sendfile/recv syscalls release the GIL anyway.
    """

    def __init__(self, local_store, bind_host: str = "127.0.0.1"):
        self.local_store = local_store
        self._bind_host = bind_host
        self._sock: Optional[socket.socket] = None
        self.port = 0
        self._accept_thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()

    def start(self) -> int:
        self._sock = socket.create_server(
            (self._bind_host, 0), backlog=64, reuse_port=False
        )
        self.port = self._sock.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="rtpu-bulk-accept", daemon=True
        )
        self._accept_thread.start()
        return self.port

    def stop(self):
        self._stopped.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    # ------------------------------------------------------------- serving
    def _accept_loop(self):
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # closed
            threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="rtpu-bulk-conn", daemon=True,
            ).start()

    def _check_auth(self, sock: socket.socket) -> bool:
        tok = auth_token()
        if not tok:
            return True
        try:
            magic = _recv_exact(sock, len(_AUTH_MAGIC), 10.0)
            if magic != _AUTH_MAGIC:
                return False
            (n,) = _LEN.unpack(_recv_exact(sock, 4, 10.0))
            if not 0 < n <= 512:
                return False
            import hmac

            return hmac.compare_digest(_recv_exact(sock, n, 10.0), tok.encode())
        except (OSError, ConnectionError):
            return False

    def _serve_conn(self, sock: socket.socket):
        tmo = rt_config.get("transfer_chunk_timeout_s")
        with contextlib.closing(sock):
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if not self._check_auth(sock):
                return
            while not self._stopped.is_set():
                try:
                    hdr = _recv_exact(sock, 4, tmo)
                except (OSError, ConnectionError):
                    return  # idle close / peer gone
                (n,) = _LEN.unpack(hdr)
                if n > 1 << 20:
                    return
                try:
                    req = json.loads(_recv_exact(sock, n, tmo))
                except (OSError, ConnectionError, ValueError):
                    return
                streaming = [False]
                try:
                    self._serve_one(sock, req, streaming)
                except (BrokenPipeError, ConnectionError, socket.timeout):
                    return
                except Exception as e:  # noqa: BLE001
                    if streaming[0]:
                        # Mid-payload failure: an error frame here would be
                        # consumed as object bytes — the only safe signal is
                        # closing the connection (client sees a short read).
                        return
                    err = repr(e).encode()
                    try:
                        sock.sendall(_HDR.pack(1, len(err)) + err)
                    except OSError:
                        return

    def _serve_one(self, sock: socket.socket, req: dict, streaming: list):
        offset = int(req.get("offset", 0))
        length = req.get("length")
        if req.get("mode") in ("map", "borrow"):
            self._serve_map(sock, req)
            return
        tmo = rt_config.get("transfer_chunk_timeout_s")
        if req.get("name"):
            with self.local_store.bulk_source(req["name"]) as (fd, base, total):
                ln = self._span_len(offset, length, total, req)
                streaming[0] = True
                sock.sendall(_HDR.pack(0, ln))
                self._sendfile(sock, fd, base + offset, ln, tmo)
        elif req.get("path"):
            fd = os.open(req["path"], os.O_RDONLY)
            try:
                total = os.fstat(fd).st_size
                ln = self._span_len(offset, length, total, req)
                streaming[0] = True
                sock.sendall(_HDR.pack(0, ln))
                self._sendfile(sock, fd, offset, ln, tmo)
            finally:
                os.close(fd)
        else:
            raise ValueError("bulk request needs name or path")

    @staticmethod
    def _span_len(offset: int, length, total: int, req: dict) -> int:
        """Validate the requested span against the object's ACTUAL extent —
        arena-backed sources hand out the whole-arena fd, so an oversized
        span would read a NEIGHBORING object's bytes."""
        ln = int(length if length is not None else total - offset)
        if offset < 0 or ln < 0 or offset + ln > total:
            raise ValueError(
                f"span {offset}+{ln} outside object of {total} bytes "
                f"({req.get('name') or req.get('path')})"
            )
        return ln

    def _serve_map(self, sock: socket.socket, req: dict):
        """Same-host handover: reply with (path, offset, size); hold the pin
        until the client acks that it copied the span — or, in `borrow`
        mode, until the client CLOSES the connection (the span is adopted
        zero-copy; the open socket IS the lease — plasma's shared-segment
        lifetime, carried by a connection instead of an fd refcount)."""
        tmo = rt_config.get("transfer_chunk_timeout_s")
        if req.get("mode") == "borrow" and not (
            req.get("name")
            and getattr(self.local_store, "supports_borrow_of", lambda n: False)(
                req["name"]
            )
        ):
            # Pin-less sources (plain shm, chained borrows, raw paths) must
            # not hand out leases they cannot honor — decline; the client
            # falls back to the copy planes.
            raise ValueError("source cannot pin this object for a borrow")
        with (
            self.local_store.bulk_map_source(req["name"])
            if req.get("name")
            else contextlib.nullcontext((req["path"], 0, os.stat(req["path"]).st_size))
        ) as (path, base, total):
            body = json.dumps(
                {"path": path, "offset": base, "size": total}
            ).encode()
            sock.sendall(_HDR.pack(2, len(body)) + body)
            if req.get("mode") == "borrow":
                # Park until EOF — the borrower never writes; its close (or
                # death) releases the pin. No deadline: the borrow is as
                # long-lived as the borrowed object.
                sock.settimeout(None)
                try:
                    while sock.recv(4096):
                        pass
                except OSError:
                    pass
                return
            # Pin must outlive the client's pread: wait for the 1-byte ack.
            _recv_exact(sock, 1, max(tmo, total / (256 << 20)))

    @staticmethod
    def _sendfile(sock: socket.socket, fd: int, offset: int, length: int,
                  tmo: float):
        # os.sendfile bypasses Python's socket-timeout machinery, and
        # settimeout() puts the fd in non-blocking mode (instant EAGAIN when
        # the send buffer fills). Flip to blocking for the payload and let
        # the KERNEL enforce the progress deadline via SO_SNDTIMEO.
        sock.settimeout(None)
        sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_SNDTIMEO,
            struct.pack("ll", int(max(tmo, 1)), 0),
        )
        sent = 0
        while sent < length:
            want = min(_SENDFILE_SPAN, length - sent)
            try:
                n = os.sendfile(sock.fileno(), fd, offset + sent, want)
            except InterruptedError:
                continue
            except BlockingIOError as e:
                raise socket.timeout("bulk send stalled past deadline") from e
            except OSError as e:
                if e.errno in (errno.EINVAL, errno.ENOSYS):
                    # Filesystem without sendfile support: pread+send (still
                    # no Python-side staging beyond one span buffer).
                    data = os.pread(fd, want, offset + sent)
                    sock.sendall(data)
                    sent += len(data)
                    continue
                raise
            if n == 0:
                raise ConnectionError("sendfile made no progress (peer gone?)")
            sent += n


# ---------------------------------------------------------------- client
def _open_bulk_conn(addr: str, timeout_s: float) -> socket.socket:
    host, port = addr.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)), timeout=timeout_s)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    rcv = rt_config.get("bulk_rcvbuf_bytes")
    if rcv:
        # Deep receive buffer = kernel-side pipeline: the sender keeps
        # streaming across receiver scheduling gaps (GIL handoffs, noisy
        # hosts) instead of stalling on a full default window. Setting
        # SO_RCVBUF also DISABLES receive autotuning and clamps to
        # net.core.rmem_max — on a stock-tuned host that can SHRINK the
        # effective window below what autotuning reaches, so only apply
        # when the clamped result would actually exceed the current buffer.
        try:
            cur = sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
            try:
                with open("/proc/sys/net/core/rmem_max") as f:
                    rmem_max = int(f.read())
            except (OSError, ValueError):
                rmem_max = 0
            # The kernel stores min(2*requested, 2*rmem_max); getsockopt
            # reports that doubled value.
            effective = 2 * min(rcv, rmem_max) if rmem_max else 2 * rcv
            if effective > cur:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcv)
        except OSError:
            pass
    tok = auth_token()
    if tok:
        body = tok.encode()
        sock.sendall(_AUTH_MAGIC + _LEN.pack(len(body)) + body)
    return sock


def _recv_to_sink(sock: socket.socket, sink, offset: int, length: int,
                  deadline_s: float):
    """Land a span via recv into reusable anon buffers + pwrite to the
    destination's backing file — the write()-path allocates cold tmpfs pages
    ~7× faster than recv_into a fresh mapping would fault them (mem.py).

    The landing runs OFF the GIL when the native extension builds
    (`bulk_native_lander`): "stream" hands the socket+file fds to one C
    poll/read/pwrite loop (no Python in the payload path at all), "ring"
    keeps the recv here but lands chunks on a native pinned thread. Both
    keep the per-chunk PROGRESS deadlines and abort-with-no-partial-object
    semantics of the Python paths below, which remain the fallback:

    large spans ride a bounded-window CHUNK PIPELINE (ChunkPipeline): this
    thread recv_into's one chunk while lander thread(s) pwrite the previous
    ones, so the socket drains during the landing write instead of after it
    (the kernel socket buffer only hides ~a rcvbuf of that overlap; the
    window hides chunk-multiples). Small spans keep the serial loop — the
    thread handoff is pure overhead below a couple of chunks."""
    dst_path, dst_base = sink
    fd = os.open(dst_path, os.O_WRONLY)
    try:
        chunk = rt_config.get("bulk_chunk_bytes")
        window = rt_config.get("bulk_window_chunks")
        mode = _native_land_mode()
        if mode == "stream":
            # Off-GIL whole-span landing: on CPU-starved receivers the GIL
            # handoff between the Python reader and lander threads serializes
            # the pipeline's overlap (0.74 -> 1.1+ GiB/s measured in-cluster
            # on a 1-vCPU host — docs/ROOFLINE_put_path.md).
            _land_stream_native(sock, fd, dst_base + offset, length,
                                deadline_s)
            return
        if mode == "ring" and window >= 2 and length >= 2 * chunk:
            _land_ring_native(sock, fd, dst_base + offset, length, chunk,
                              window, deadline_s)
            return
        sock.settimeout(deadline_s)
        if (
            rt_config.get("bulk_pipeline")
            and window >= 2
            and length >= 2 * chunk
        ):
            def fill(view: memoryview):
                got = 0
                n = len(view)
                while got < n:
                    r = sock.recv_into(view[got:])
                    if r == 0:
                        raise ConnectionError("bulk peer closed mid-span")
                    got += r

            def land(view: memoryview, off: int):
                _pwrite_all(fd, view, dst_base + offset + off)

            ChunkPipeline(
                length, chunk, window, land, deadline_s,
                landers=rt_config.get("bulk_land_threads"),
            ).run(fill)
            return
        buf = bytearray(min(_RECV_SPAN, length))
        mv = memoryview(buf)
        got = 0
        while got < length:
            r = sock.recv_into(mv[: min(_RECV_SPAN, length - got)])
            if r == 0:
                raise ConnectionError("bulk peer closed mid-span")
            _pwrite_all(fd, mv[:r], dst_base + offset + got)
            got += r
    finally:
        os.close(fd)


def _request_span(sock: socket.socket, where: dict, offset: int, length: int,
                  tmo: float) -> None:
    """Send one (name|path, offset, length) span request and validate the
    reply header — the shared front half of every span pull."""
    req = json.dumps({
        "name": where.get("name"), "path": where.get("path"),
        "offset": offset, "length": length,
    }).encode()
    sock.sendall(_LEN.pack(len(req)) + req)
    status, n = _HDR.unpack(_recv_exact(sock, _HDR.size, tmo))
    if status != 0:
        raise RuntimeError(
            f"bulk fetch failed: {_recv_exact(sock, n, tmo).decode(errors='replace')}"
        )
    if n != length:
        raise RuntimeError(f"bulk length mismatch: asked {length}, got {n}")


def _land_span(sock: socket.socket, writer, land_at: int, length: int,
               tmo: float) -> None:
    """Land a validated span reply into `writer` at `land_at` — the shared
    back half of every span pull (native off-GIL lander when the writer
    exposes a sink, raw-view recv otherwise)."""
    sink = getattr(writer, "sink", lambda: None)()
    if sink is not None:
        _recv_to_sink(sock, sink, land_at, length, tmo)
    else:
        if hasattr(writer, "ensure_populated"):
            writer.ensure_populated()
        _recv_exact_into(sock, writer.raw_view(land_at, length), tmo)


def _flight_pull_span(name: str, t0_ns: int, length: int, rung: str,
                      err: Optional[BaseException] = None) -> None:
    """One flight-recorder span per bulk pull: bytes, landing rung, and
    whether a deadline abort cut it short (abort spans are death-kind —
    exempt from the ring cap, the evidence survives the storm)."""
    from ..util import flight

    if not flight.enabled():
        return
    attrs = {"bytes": length, "rung": rung}
    kind = ""
    if err is not None:
        attrs["abort"] = True
        attrs["error"] = type(err).__name__
        kind = "abort"
    flight.record(name, t0_ns, flight.now_ns(), lane="bulk", kind=kind,
                  attrs=attrs)


def pull_span(addr: str, name: str, offset: int, length: int, writer,
              timeout_s: float, land_at: int = 0):
    """Pull one (offset, length) span of a stored object into `writer` at
    `land_at`, riding the native off-GIL lander when it builds (same
    landing ladder as whole-object pulls: stream -> ring -> Python chunk
    pipeline -> serial loop). Public entry for span consumers that land
    into a store object — the serve KV-transfer plane pulls prefix-cache
    block runs through here; the data plane's whole-object path is the
    `land_at == offset` special case (`_pull_span`)."""
    import time as _time

    t0 = _time.monotonic_ns()
    rung = (_native_land_mode() or "python") \
        if getattr(writer, "sink", lambda: None)() is not None else "python"
    try:
        sock = _open_bulk_conn(addr, timeout_s)
        with contextlib.closing(sock):
            _request_span(sock, {"name": name}, offset, length, timeout_s)
            _land_span(sock, writer, land_at, length, timeout_s)
    except BaseException as e:
        _flight_pull_span("bulk.pull", t0, length, rung, e)
        raise
    _flight_pull_span("bulk.pull", t0, length, rung)


def fetch_span_bytes(addr: str, name: str, offset: int, length: int,
                     timeout_s: float) -> bytearray:
    """Pull one span into private memory (no store object — partition/
    block-sized reads where the consumer deserializes immediately: the
    data plane's shuffle partitions, and the MPMD training pipeline's
    cross-node activation/grad tensors in train/mpmd/transport.py)."""
    import time as _time

    t0 = _time.monotonic_ns()
    buf = bytearray(length)
    try:
        sock = _open_bulk_conn(addr, timeout_s)
        with contextlib.closing(sock):
            _request_span(sock, {"name": name}, offset, length, timeout_s)
            _recv_exact_into(sock, memoryview(buf), timeout_s)
    except BaseException as e:
        _flight_pull_span("bulk.fetch_span", t0, length, "python", e)
        raise
    _flight_pull_span("bulk.fetch_span", t0, length, "python")
    return buf


def _pull_span(addr: str, where: dict, writer, offset: int, length: int,
               tmo: float):
    sock = _open_bulk_conn(addr, tmo)
    with contextlib.closing(sock):
        _request_span(sock, where, offset, length, tmo)
        _land_span(sock, writer, offset, length, tmo)


_local_addrs_cache: Optional[set] = None


def _local_addrs() -> set:
    """Addresses that mean 'this host' for the same-host map handover.
    Cached: the gethostbyname_ex resolver round trip is static for the
    process lifetime and must not tax every pull."""
    global _local_addrs_cache
    if _local_addrs_cache is not None:
        return _local_addrs_cache
    out = {"127.0.0.1", "localhost", "::1"}
    node_ip = rt_config.get("node_ip")
    if node_ip:
        out.add(node_ip)
    try:
        out.add(socket.gethostname())
        out.update(socket.gethostbyname_ex(socket.gethostname())[2])
    except OSError:
        pass
    _local_addrs_cache = out
    return out


def _copy_span_from_file(src_fd: int, src_base: int, size: int, writer):
    """Land `size` bytes of an open file into the writer, fastest path first:

    1. file→file `copy_file_range` into the writer's backing-file span
       (`sink()`): zero userspace copies AND no mmap faults — the
       write()-side tmpfs allocation path is ~25× faster than faulting
       pages through a fresh mapping on lazily-backed guest kernels (see
       mem.py). Measured on this host class (r5): copy_file_range 2.6
       GiB/s vs sendfile 1.8-2.3 vs pread+pwrite 1.9 for a cold 1 GiB.
    2. `sendfile` when copy_file_range is unsupported (pre-5.3 kernels /
       cross-fs).
    3. Fallback: batch the destination faults (`ensure_populated`) and
       preadv straight into the writer's mapping.
    """
    sink = getattr(writer, "sink", lambda: None)()
    if sink is not None:
        dst_path, dst_base = sink
        dfd = os.open(dst_path, os.O_WRONLY)
        try:
            done = 0
            use_cfr = hasattr(os, "copy_file_range")
            os.lseek(dfd, dst_base, os.SEEK_SET)
            while done < size:
                want = min(_SENDFILE_SPAN, size - done)
                try:
                    if use_cfr:
                        n = os.copy_file_range(
                            src_fd, dfd, want, src_base + done, dst_base + done
                        )
                    else:
                        n = os.sendfile(dfd, src_fd, src_base + done, want)
                except InterruptedError:
                    continue
                except OSError as e:
                    if e.errno in (errno.EINVAL, errno.ENOSYS, errno.EXDEV):
                        if use_cfr:
                            use_cfr = False  # retry the span via sendfile
                            os.lseek(dfd, dst_base + done, os.SEEK_SET)
                            continue
                        if done == 0:
                            break  # no file→file path here; fall through
                    raise
                if n <= 0:
                    raise ConnectionError("bulk map copy hit EOF")
                done += n
            else:
                return
        finally:
            os.close(dfd)
    if hasattr(writer, "ensure_populated"):
        writer.ensure_populated()
    done = 0
    while done < size:
        span = min(_SENDFILE_SPAN, size - done)
        got = os.preadv(src_fd, [writer.raw_view(done, span)], src_base + done)
        if got <= 0:
            raise ConnectionError("bulk map pread hit EOF")
        done += got


def bulk_borrow(addr: str, where: dict, size: int, tmo: float):
    """Same-host zero-copy adoption: ask the source for its span and KEEP
    the connection open as the pin lease. Returns (path, offset, sock) —
    closing `sock` releases the source-side pin. Raises if the server
    declines or metadata mismatches (caller falls back to the copy path)."""
    sock = _open_bulk_conn(addr, tmo)
    try:
        req = json.dumps({
            "name": where.get("name"), "path": where.get("path"),
            "mode": "borrow",
        }).encode()
        sock.sendall(_LEN.pack(len(req)) + req)
        status, n = _HDR.unpack(_recv_exact(sock, _HDR.size, tmo))
        if status == 1:
            raise RuntimeError(
                f"bulk borrow failed: "
                f"{_recv_exact(sock, n, tmo).decode(errors='replace')}"
            )
        if status != 2:
            raise RuntimeError("bulk borrow declined by server")
        info = json.loads(_recv_exact(sock, n, tmo))
        path, base = info["path"], int(info["offset"])
        # Path-addressed borrows must return EXACTLY the requested file
        # (the old check skipped validation entirely for them); name-
        # addressed ones may only hand out shm segments — a borrow mmaps
        # whatever comes back, so /tmp/ (world-writable, spill files ride
        # the copy planes) is not an acceptable source (ADVICE r5 #4).
        if where.get("path"):
            if path != where["path"]:
                raise RuntimeError(
                    f"bulk borrow returned {path!r} for requested "
                    f"{where['path']!r}"
                )
        elif not path.startswith("/dev/shm/"):
            raise RuntimeError(f"bulk borrow refused suspicious path {path!r}")
        if int(info["size"]) != size:
            raise RuntimeError(
                f"bulk borrow size mismatch: expected {size}, "
                f"source has {info['size']}"
            )
        return path, base, sock
    except BaseException:
        sock.close()
        raise


def _pull_map(addr: str, where: dict, size: int, writer, tmo: float) -> bool:
    """Same-host handover: ask for (path, offset), copy the span file→file
    (or pread it) — never over TCP. Returns False if the server declined."""
    sock = _open_bulk_conn(addr, tmo)
    with contextlib.closing(sock):
        req = json.dumps({
            "name": where.get("name"), "path": where.get("path"),
            "mode": "map",
        }).encode()
        sock.sendall(_LEN.pack(len(req)) + req)
        status, n = _HDR.unpack(_recv_exact(sock, _HDR.size, tmo))
        if status == 1:
            raise RuntimeError(
                f"bulk map failed: {_recv_exact(sock, n, tmo).decode(errors='replace')}"
            )
        if status != 2:
            return False
        info = json.loads(_recv_exact(sock, n, tmo))
        path, base = info["path"], int(info["offset"])
        # Same discipline as bulk_borrow: a path-addressed map must return
        # the requested file; name-addressed maps may serve shm segments or
        # session-dir spill files, nothing else.
        if where.get("path"):
            if path != where["path"]:
                raise RuntimeError(
                    f"bulk map returned {path!r} for requested "
                    f"{where['path']!r}"
                )
        elif not path.startswith(("/dev/shm/", "/tmp/")):
            raise RuntimeError(f"bulk map refused suspicious path {path!r}")
        if int(info["size"]) != size:
            # Stale controller metadata: reading `size` bytes from the arena
            # span would cross into a neighboring object.
            raise RuntimeError(
                f"bulk map size mismatch: expected {size}, source has {info['size']}"
            )
        fd = os.open(path, os.O_RDONLY)
        try:
            _copy_span_from_file(fd, base, size, writer)
        finally:
            os.close(fd)
        sock.sendall(b"\x01")  # release the server-side pin
    return True


def bulk_pull_into(addr: str, where: dict, size: int, writer,
                   streams: Optional[int] = None) -> None:
    """Pull `size` bytes of the object at `where` from the peer's bulk port
    straight into `writer`'s arena mapping: same-host map handover when the
    peer is this machine, else `streams` parallel connections of contiguous
    spans. Blocking — call in an executor."""
    import sys as _sys
    import time as _time

    tmo = rt_config.get("transfer_chunk_timeout_s")
    host = addr.rsplit(":", 1)[0]
    big = size >= (256 << 20) and rt_config.get("transfer_log_big")
    if rt_config.get("bulk_same_host_map") and host in _local_addrs():
        _m0 = _time.monotonic()
        if _pull_map(addr, where, size, writer, tmo):
            if big:
                _md = _time.monotonic() - _m0
                print(f"bulk_plane MAP {size >> 20}MiB {_md:.2f}s "
                      f"({size / 2**30 / max(_md, 1e-9):.2f} GiB/s)",
                      flush=True, file=_sys.stderr)
            return
    elif big:
        print(f"bulk_plane TCP (host={host!r} not local or map off)",
              flush=True, file=_sys.stderr)
    if streams is None:
        # The chunk pipeline already overlaps recv with landing on ONE
        # connection; extra striped sockets just multiply threads (reader +
        # lander per stream) and measured SLOWER on small receivers (0.87
        # GiB/s at 1 stream vs 0.69 at 4 on a 2-vCPU host). Parallel spans
        # remain the non-pipelined default and an explicit caller choice.
        streams = (
            1 if rt_config.get("bulk_pipeline")
            and size >= 2 * rt_config.get("bulk_chunk_bytes")
            else rt_config.get("bulk_streams")
        )
    streams = max(1, min(streams, max(1, size // (8 << 20))))
    if streams == 1:
        _pull_span(addr, where, writer, 0, size, tmo)
        return
    span = -(-size // streams)
    offs = list(range(0, size, span))
    with ThreadPoolExecutor(max_workers=streams, thread_name_prefix="rtpu-bulk-pull") as ex:
        futs = [
            ex.submit(_pull_span, addr, where, writer, off,
                      min(span, size - off), tmo)
            for off in offs
        ]
        for f in futs:
            f.result()

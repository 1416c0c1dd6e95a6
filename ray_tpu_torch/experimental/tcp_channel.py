"""Cross-host channels for compiled DAGs.

Reference analog: `python/ray/experimental/channel.py:49` — the reference
hides the transport behind one `write`/`begin_read`/`end_read` surface so a
compiled DAG can pipeline stages whether its actors share a machine or not.
Here the cross-node transport is a persistent TCP stream per DAG edge
(single writer, N readers, depth-1 backpressure — identical semantics to the
shm seqlock `Channel`), so steady-state execution still does zero task
submissions and zero connection setups.

Roles are positional, not typed: the producer process calls
`TcpChannel.bind(...)` once (registering a listening socket in a
process-local table), and any `TcpChannel` descriptor that lands in that
process afterwards resolves to the writer end by name; descriptors landing
anywhere else are reader ends that lazily connect on first `begin_read`.
This lets the driver create every edge descriptor centrally at compile time
and ship the same object to both sides, exactly like the shm channels.

Wire protocol per message: `<QQQ>` header (seq, flag, byte-length) then the
pickled payload. Each reader acks with `<Q>` (its last fully-consumed seq)
after `end_read`; the writer blocks publishing seq S until every reader has
acked S-1 — buffer-reuse backpressure without shared memory.
"""

from __future__ import annotations

import pickle
import select
import socket
import struct
import threading
import time
from typing import Any, Dict, Optional, Tuple

from .channel import ChannelClosed

_HDR = struct.Struct("<QQQ")
_ACK = struct.Struct("<Q")
_FLAG_STOP = 1

# Process-local registry: channel name -> _WriterState. Populated by
# TcpChannel.bind(); consulted by TcpChannel.write() to resolve the writer
# role (plasma-fd-passing analog: whoever holds the bound socket is the
# producer).
_BOUND: Dict[str, "_WriterState"] = {}


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("tcp channel peer closed")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


class _WriterState:
    """Server side of one edge: listening socket + per-slot connections +
    ack bookkeeping. Lives in the producer process only."""

    def __init__(self, name: str, num_readers: int, bind_host: str):
        self.name = name
        self.num_readers = num_readers
        self.server = socket.create_server((bind_host, 0))
        self.port = self.server.getsockname()[1]
        self.conns: Dict[int, socket.socket] = {}
        self.acks = [0] * num_readers
        self.seq = 0
        self.cond = threading.Condition()
        self.closed = False
        t = threading.Thread(
            target=self._accept_loop, name=f"tcpch-accept-{name}", daemon=True
        )
        t.start()

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self.server.accept()
            except OSError:
                return  # server closed (destroy)
            try:
                (slot,) = _ACK.unpack(_recv_exact(conn, 8))
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except Exception:  # noqa: BLE001 — malformed hello
                conn.close()
                continue
            with self.cond:
                if self.closed:
                    # Writer already closed: the late connector still gets a
                    # clean stop sentinel, not a hangup.
                    try:
                        conn.sendall(_HDR.pack(self.seq + 1, _FLAG_STOP, 0))
                    except OSError:
                        pass
                    conn.close()
                    continue
                if not 0 <= slot < self.num_readers:
                    conn.close()
                    continue
                old = self.conns.get(slot)
                if old is not None:
                    old.close()
                self.conns[slot] = conn
                self.cond.notify_all()

    def _drain_acks(self, deadline: Optional[float]):
        """Block until every reader has acked the previous message."""
        while min(self.acks) < self.seq:
            with self.cond:
                socks = {c: s for s, c in self.conns.items()}
            wait = 0.2
            if deadline is not None:
                wait = min(wait, deadline - time.monotonic())
                if wait <= 0:
                    raise TimeoutError("tcp channel write blocked: readers lagging")
            readable, _, _ = select.select(list(socks), [], [], max(wait, 0.001))
            for conn in readable:
                try:
                    (acked,) = _ACK.unpack(_recv_exact(conn, 8))
                except (ConnectionError, OSError) as e:
                    raise ConnectionError(
                        f"tcp channel {self.name}: reader {socks[conn]} died"
                    ) from e
                slot = socks[conn]
                self.acks[slot] = max(self.acks[slot], acked)

    def write_payload(self, payload: bytes, flag: int, timeout: Optional[float]):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.cond:
            while len(self.conns) < self.num_readers:
                wait = 1.0 if deadline is None else deadline - time.monotonic()
                if wait <= 0 or not self.cond.wait(timeout=min(wait, 1.0)):
                    if deadline is not None and time.monotonic() >= deadline:
                        raise TimeoutError(
                            f"tcp channel {self.name}: "
                            f"{len(self.conns)}/{self.num_readers} readers connected"
                        )
        self._drain_acks(deadline)
        self.seq += 1
        msg = _HDR.pack(self.seq, flag, len(payload)) + payload
        with self.cond:
            conns = list(self.conns.values())
        for conn in conns:
            conn.sendall(msg)

    def send_stop(self):
        """Best-effort stop sentinel to every *connected* reader (readers
        that never connected are covered by teardown closing the server)."""
        with self.cond:
            self.closed = True
            conns = list(self.conns.values())
        msg = _HDR.pack(self.seq + 1, _FLAG_STOP, 0)
        for conn in conns:
            try:
                conn.sendall(msg)
            except OSError:
                pass

    def destroy(self):
        with self.cond:
            self.closed = True
            conns = list(self.conns.values())
            self.conns.clear()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        try:
            self.server.close()
        except OSError:
            pass


class TcpChannel:
    """Same surface as `channel.Channel`, TCP transport. Construct reader
    descriptors directly; construct the writer end via `TcpChannel.bind`."""

    def __init__(
        self,
        name: str,
        addr: Tuple[str, int],
        num_readers: int = 1,
        reader_slot: int = 0,
    ):
        self.name = name
        self.addr = tuple(addr)
        self.num_readers = num_readers
        self.reader_slot = reader_slot
        self._sock: Optional[socket.socket] = None
        self._last_read_seq = 0
        # Resumable-read state: bytes already received of the in-progress
        # header/payload, kept across a TimeoutError so a retried
        # begin_read (CompiledDAGRef.get's health-poll slices, or a caller
        # retrying a timed-out get) CONTINUES the stream instead of parsing
        # mid-payload bytes as a fresh header and desyncing the channel.
        self._rxbuf = bytearray()
        self._rxhdr: Optional[Tuple[int, int, int]] = None

    # ------------------------------------------------------------- writer
    @classmethod
    def bind(
        cls,
        name: str,
        num_readers: int,
        *,
        advertise_host: str,
        bind_host: str = "0.0.0.0",
    ) -> "TcpChannel":
        if name in _BOUND:
            raise ValueError(f"tcp channel {name!r} already bound in this process")
        ws = _WriterState(name, num_readers, bind_host)
        _BOUND[name] = ws
        return cls(name, (advertise_host, ws.port), num_readers)

    def _writer(self) -> _WriterState:
        ws = _BOUND.get(self.name)
        if ws is None:
            raise RuntimeError(
                f"tcp channel {self.name}: write() from a process that never "
                "bound it (reader ends are read-only)"
            )
        return ws

    def write(self, value: Any, timeout: Optional[float] = 60.0):
        self._writer().write_payload(pickle.dumps(value), 0, timeout)

    def close_writer(self):
        ws = _BOUND.get(self.name)
        if ws is not None:
            ws.send_stop()

    # ------------------------------------------------------------- reader
    def _connect(self) -> socket.socket:
        if self._sock is None:
            sock = socket.create_connection(self.addr, timeout=30.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.sendall(_ACK.pack(self.reader_slot))
            sock.settimeout(None)
            self._sock = sock
        return self._sock

    def _fill(self, sock: socket.socket, need: int, deadline: Optional[float]):
        """Append to _rxbuf until it holds `need` bytes; on timeout the
        partial bytes are KEPT for the next attempt."""
        while len(self._rxbuf) < need:
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("tcp channel read timed out")
                sock.settimeout(remaining)
            try:
                b = sock.recv(min(1 << 20, need - len(self._rxbuf)))
            except socket.timeout as e:
                raise TimeoutError("tcp channel read timed out") from e
            if not b:
                raise ConnectionError("tcp channel peer closed")
            self._rxbuf.extend(b)

    def begin_read(self, timeout: Optional[float] = None) -> Any:
        sock = self._connect()
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            if self._rxhdr is None:
                self._fill(sock, _HDR.size, deadline)
                self._rxhdr = _HDR.unpack(bytes(self._rxbuf[: _HDR.size]))
                del self._rxbuf[: _HDR.size]
            seq, flag, length = self._rxhdr
            if flag == _FLAG_STOP:
                self._last_read_seq = seq
                self._rxhdr = None
                self.end_read()
                raise ChannelClosed
            self._fill(sock, length, deadline)
            payload = bytes(self._rxbuf[:length])
            del self._rxbuf[:length]
            # Acked state advances only once the message is fully consumed
            # — a timeout mid-payload must not let end_read() ack it.
            self._last_read_seq = seq
            self._rxhdr = None
        finally:
            sock.settimeout(None)
        return pickle.loads(payload)

    def end_read(self):
        if self._sock is not None:
            try:
                self._sock.sendall(_ACK.pack(self._last_read_seq))
            except OSError:
                pass

    def read(self, timeout: Optional[float] = None) -> Any:
        value = self.begin_read(timeout)
        self.end_read()
        return value

    # ---------------------------------------------------------- lifecycle
    def with_reader_slot(self, slot: int) -> "TcpChannel":
        if not 0 <= slot < self.num_readers:
            raise ValueError(f"reader slot {slot} out of range [0, {self.num_readers})")
        return TcpChannel(self.name, self.addr, self.num_readers, slot)

    def destroy(self):
        ws = _BOUND.pop(self.name, None)
        if ws is not None:
            ws.destroy()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def __reduce__(self):
        return (TcpChannel, (self.name, self.addr, self.num_readers, self.reader_slot))

"""Reusable shared-memory channels (reference: `python/ray/experimental/channel.py:49,99,135`
`Channel.write/begin_read`).

The reference reuses one mmap'd plasma buffer per edge of a compiled DAG so
steady-state execution does zero allocations and zero task submissions. Same
design here: a named POSIX shm segment with a seqlock header, single writer,
N readers; the writer blocks until every reader has acked the previous
message (backpressure = buffer reuse safety).

Header layout (little-endian u64s):
    [0]            seq     — message sequence number, bumped after payload is in place
    [8]            length  — payload byte length
    [16]           flag    — 0 normal, 1 stop sentinel
    [24 + 8*k]     ack_k   — last seq acked by reader slot k (k < num_readers)

Each reader owns a distinct ack slot and writes its *absolute* last-read seq
(idempotent store, no read-modify-write) — concurrent acks from readers in
different processes cannot race.

Growth: a payload larger than the buffer used to fail the write outright
(the compiled-DAG 1 MiB default was a hard ceiling). Channels are now
growable by default: the writer allocates a fresh, larger segment, announces
it with a RELOCATE message (flag 2, payload = new segment name) through the
old segment, waits for every reader slot to ack the relocation, then
publishes the oversized payload in the new segment (sequence numbers restart
at 0 there — both sides reset together, so the seqlock protocol is
unchanged). Readers follow the forward pointer transparently inside
begin_read. The relocated-from segment is unlinked by its owner (writer if
it created it, else the creator's destroy()/resource tracker); grown
segments are owned by the writer process that created them.
"""

from __future__ import annotations

import pickle
import struct
import time
from multiprocessing import shared_memory
from typing import Any, Optional

_FLAG_STOP = 1
_FLAG_RELOC = 2


class ChannelClosed(Exception):
    pass


class Channel:
    def __init__(
        self,
        buffer_size: int = 1 << 20,
        *,
        name: Optional[str] = None,
        create: bool = True,
        num_readers: int = 1,
        reader_slot: int = 0,
        growable: bool = True,
    ):
        self.num_readers = num_readers
        self.reader_slot = reader_slot
        self.growable = growable
        self._header = 24 + 8 * num_readers
        if create:
            # Creator stays tracker-registered: unlink() (ours in destroy(),
            # or the tracker's at process exit for leaked channels) balances
            # the registration.
            self._shm = shared_memory.SharedMemory(
                create=True, size=self._header + buffer_size, name=name
            )
            self._shm.buf[: self._header] = b"\0" * self._header
        else:
            # Attach WITHOUT tracker registration: forked workers share the
            # parent's resource tracker, and duplicate unregisters for the
            # same segment name crash the tracker daemon at exit.
            self._shm = _attach_untracked(name)
        self._owner = create
        self._last_read_seq = 0
        self._bind_native()

    def _bind_native(self):
        """Hot wait/copy ops run in C++ when the native lib builds (proper
        acquire/release atomics + adaptive spin instead of a 500µs poll);
        same header layout, so native and Python ends interoperate."""
        self._native = None
        self._base_addr = 0
        try:
            from ..native import load_channel_lib

            lib = load_channel_lib()
            if lib is not None:
                import ctypes

                self._native = lib
                self._base_addr = ctypes.addressof(
                    ctypes.c_char.from_buffer(self._shm.buf)
                )
        except Exception:  # noqa: BLE001 — fall back to pure Python
            self._native = None

    @property
    def name(self) -> str:
        return self._shm.name

    def with_reader_slot(self, slot: int) -> "Channel":
        """A view of this channel for reader slot `slot` (what you ship to
        the consumer process)."""
        if not 0 <= slot < self.num_readers:
            raise ValueError(f"reader slot {slot} out of range [0, {self.num_readers})")
        ch = Channel.__new__(Channel)
        ch.num_readers = self.num_readers
        ch.reader_slot = slot
        ch.growable = self.growable
        ch._header = self._header
        ch._shm = self._shm
        ch._owner = False
        ch._last_read_seq = self._last_read_seq
        ch._native = self._native
        ch._base_addr = self._base_addr
        return ch

    # ------------------------------------------------------------- header
    def _get(self, off: int) -> int:
        return struct.unpack_from("<Q", self._shm.buf, off)[0]

    def _set(self, off: int, val: int):
        struct.pack_into("<Q", self._shm.buf, off, val)

    def _min_ack(self) -> int:
        return min(self._get(24 + 8 * k) for k in range(self.num_readers))

    # -------------------------------------------------------------- write
    def write(self, value: Any, timeout: Optional[float] = 60.0):
        self._write_payload(pickle.dumps(value), 0, timeout)

    def _write_payload(self, payload: bytes, flag: int, timeout: Optional[float]):
        if len(payload) > len(self._shm.buf) - self._header:
            if not self.growable or flag != 0:
                raise ValueError(
                    f"Serialized value ({len(payload)}B) exceeds channel buffer "
                    f"({len(self._shm.buf) - self._header}B); recreate the DAG "
                    "with a larger _buffer_size_bytes"
                )
            self._relocate(len(payload), timeout)
        if self._native is not None:
            timeout_us = -1 if timeout is None else int(timeout * 1e6)
            rc = self._native.rtpu_ch_write(
                self._base_addr, self.num_readers, payload, len(payload),
                flag, timeout_us,
            )
            if rc == -1:
                raise TimeoutError("channel write blocked: readers lagging")
            return
        seq = self._get(0)
        # Backpressure: previous message must be acked by every reader slot.
        deadline = None if timeout is None else time.monotonic() + timeout
        while seq > 0 and self._min_ack() < seq:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("channel write blocked: readers lagging")
            time.sleep(0.0005)
        self._shm.buf[self._header : self._header + len(payload)] = payload
        self._set(8, len(payload))
        self._set(16, flag)
        self._set(0, seq + 1)  # publish

    def _relocate(self, needed: int, timeout: Optional[float]):
        """Grow-on-demand: allocate a larger segment, forward every reader to
        it via a RELOCATE message through the old one, then retire the old
        segment. Called with the writer role only (single writer per edge).
        Readers must all ack the relocation before the writer switches —
        afterwards both sides restart the seqlock at seq 0 in the new
        segment, so ordering is preserved without any cross-segment state."""
        old_cap = len(self._shm.buf) - self._header
        # 1.25x headroom so a steady stream of same-sized payloads relocates
        # once, not per message as pickle overhead fluctuates.
        new_cap = max(needed + needed // 4, 2 * old_cap)
        new_shm = shared_memory.SharedMemory(
            create=True, size=self._header + new_cap
        )
        new_shm.buf[: self._header] = b"\0" * self._header
        try:
            self._write_payload(pickle.dumps(new_shm.name), _FLAG_RELOC, timeout)
            # Every reader slot must observe the forward pointer before the
            # old segment is retired (their ack lands in the OLD header).
            seq = self._get(0)
            deadline = None if timeout is None else time.monotonic() + timeout
            while self._min_ack() < seq:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        "channel relocate blocked: readers lagging"
                    )
                time.sleep(0.0005)
        except BaseException:
            new_shm.close()
            try:
                new_shm.unlink()
            except OSError:
                pass
            raise
        old, was_owner = self._shm, self._owner
        # The old MAPPING is retired, never closed here: sibling views in
        # this process (other reader slots, the driver's teardown handle)
        # share the SharedMemory object, and native reads may be mid-flight
        # against its address. Unlinking by name is safe while mapped; the
        # pages free when the last attachment closes (destroy/exit).
        # Retained mappings are bounded by the geometric growth (< 2x the
        # final size across all relocations).
        self._retired_shms().append(old)
        self._shm = new_shm
        self._owner = True  # this process created the grown segment
        self._bind_native()
        if was_owner:
            try:
                old.unlink()
            except OSError:
                pass
        # else: the creating process's destroy()/resource tracker unlinks it.

    def _follow_relocation(self):
        """Reader side of _relocate: attach the new segment named in the
        RELOCATE payload, ack in the old one (releasing the writer), and
        restart this reader's sequence counter for the fresh header."""
        length = self._get(8)
        new_name = pickle.loads(
            self._shm.buf[self._header : self._header + length]
        )
        self._ack()
        old, was_owner = self._shm, self._owner
        self._retired_shms().append(old)  # see _relocate: never close here
        self._shm = _attach_untracked(new_name)
        self._owner = False
        self._last_read_seq = 0
        self._bind_native()
        if was_owner:
            # The reader created the original segment (driver-made channel
            # whose writer lives in an actor): retiring it here balances the
            # creation-time tracker registration.
            try:
                old.unlink()
            except OSError:
                pass

    # --------------------------------------------------------------- read
    def begin_read(self, timeout: Optional[float] = None) -> Any:
        """Block until the next message; returns the deserialized value.
        Caller must `end_read()` when done with it. RELOCATE messages are
        consumed internally (the reader re-attaches to the grown segment and
        keeps waiting for the actual payload)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = (
                None if deadline is None
                else max(deadline - time.monotonic(), 0.0)
            )
            if self._native is not None:
                import ctypes

                out_len = ctypes.c_uint64()
                out_flag = ctypes.c_uint64()
                timeout_us = -1 if remaining is None else int(remaining * 1e6)
                rc = self._native.rtpu_ch_wait_read(
                    self._base_addr, self._last_read_seq,
                    ctypes.byref(out_len), ctypes.byref(out_flag), timeout_us,
                )
                if rc == -1:
                    raise TimeoutError("channel read timed out")
                self._last_read_seq += 1
                flag, length = out_flag.value, out_len.value
            else:
                while self._get(0) <= self._last_read_seq:
                    if deadline is not None and time.monotonic() > deadline:
                        raise TimeoutError("channel read timed out")
                    time.sleep(0.0005)
                self._last_read_seq += 1
                flag, length = self._get(16), self._get(8)
            if flag == _FLAG_STOP:
                self._ack()
                raise ChannelClosed
            if flag == _FLAG_RELOC:
                self._follow_relocation()
                continue
            return pickle.loads(
                self._shm.buf[self._header : self._header + length]
            )

    def end_read(self):
        self._ack()

    def _ack(self):
        # Idempotent absolute store into this reader's own slot — safe under
        # concurrent acks from other readers.
        if self._native is not None:
            self._native.rtpu_ch_ack(
                self._base_addr, self.reader_slot, self._last_read_seq
            )
            return
        self._set(24 + 8 * self.reader_slot, self._last_read_seq)

    def read(self, timeout: Optional[float] = None) -> Any:
        """begin_read + end_read (for values that are fully copied out)."""
        value = self.begin_read(timeout)
        self.end_read()
        return value

    def _retired_shms(self) -> list:
        if not hasattr(self, "_retired"):
            self._retired = []
        return self._retired

    # ---------------------------------------------------------- lifecycle
    def close_writer(self):
        """Send the stop sentinel; readers raise ChannelClosed."""
        try:
            self._write_payload(b"", _FLAG_STOP, timeout=5.0)
        except (TimeoutError, ValueError):
            pass

    def destroy(self):
        for shm in self._retired_shms():
            try:
                shm.close()
            except Exception:  # noqa: BLE001
                pass
        self._retired = []
        try:
            self._shm.close()
            if self._owner:
                self._shm.unlink()
        except Exception:  # noqa: BLE001
            pass

    def __reduce__(self):
        # Re-attach on the other side. Readers inherit seq 0, so ship
        # channels BEFORE the first write (compiled DAGs do).
        return (
            _attach_channel,
            (self.name, self.num_readers, self.reader_slot, self.growable),
        )


def _attach_channel(
    name: str, num_readers: int, reader_slot: int, growable: bool = True
) -> "Channel":
    return Channel(
        name=name, create=False, num_readers=num_readers,
        reader_slot=reader_slot, growable=growable,
    )


class RemoteShmChannel:
    """Driver-side DESCRIPTOR for a shm channel that lives on another host
    (both endpoints of the edge are there; the driver never touches the
    bytes). Holds no mapping — it exists to be pickled into stage arg plans,
    where it unpickles as a real attached `Channel`. The segment itself is
    created by the producer actor (`_StageHost.create_shm_channel`) and
    unlinked by that process's resource tracker at exit."""

    def __init__(self, name: str, num_readers: int, reader_slot: int = 0):
        self.name = name
        self.num_readers = num_readers
        self.reader_slot = reader_slot

    def with_reader_slot(self, slot: int) -> "RemoteShmChannel":
        if not 0 <= slot < self.num_readers:
            raise ValueError(f"reader slot {slot} out of range [0, {self.num_readers})")
        return RemoteShmChannel(self.name, self.num_readers, slot)

    def close_writer(self):
        pass  # stop sentinels for remote-interior edges ride actor teardown

    def destroy(self):
        pass  # owning process's resource tracker unlinks at exit

    def __reduce__(self):
        return (_attach_channel, (self.name, self.num_readers, self.reader_slot))


def _attach_untracked(name: str) -> shared_memory.SharedMemory:
    from multiprocessing import resource_tracker

    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig

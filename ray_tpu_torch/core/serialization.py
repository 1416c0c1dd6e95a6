"""Serialization: cloudpickle + out-of-band zero-copy buffers.

Mirrors the capability of the reference's `python/ray/_private/serialization.py`
(cloudpickle fork + pickle5 out-of-band buffers, zero-copy numpy reads from
plasma) without its plasma-specific framing. We use pickle protocol 5 with
`buffer_callback` so large numpy / jax host arrays are carried as raw buffers
next to a small pickle payload; on the read side the arrays are reconstructed
as views over the (possibly shared-memory) buffer — no copy.

Wire format:
    [u32 npayload][payload][u32 nbufs]{[u64 len][buffer bytes]}*
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import threading
from typing import Any, List, Optional, Tuple

import cloudpickle

# Protocol 5 gives us out-of-band buffer support.
_PROTO = 5


class _ContainedRefs(threading.local):
    """Collector for ObjectRefs nested inside a value being serialized —
    `ObjectRef.__reduce__` reports into it. The controller pins contained
    objects for the container's lifetime (reference analog: nested-ref
    tracking in `ReferenceCounter::AddNestedObjectIds`)."""

    def __init__(self):
        self.active: Optional[List[str]] = None


CONTAINED = _ContainedRefs()


def serialize(value: Any) -> Tuple[bytes, List[pickle.PickleBuffer]]:
    """Serialize to (payload, out_of_band_buffers). Also records nested
    ObjectRef ids into `last_contained_refs`."""
    buffers: List[pickle.PickleBuffer] = []
    CONTAINED.active = contained = []
    try:
        payload = cloudpickle.dumps(value, protocol=_PROTO, buffer_callback=buffers.append)
    finally:
        CONTAINED.active = None
    _LAST_CONTAINED.value = contained
    return payload, buffers


class _LastContained(threading.local):
    def __init__(self):
        self.value: List[str] = []


_LAST_CONTAINED = _LastContained()


def last_contained_refs() -> List[str]:
    """Nested ObjectRef hex ids recorded by the most recent serialize() on
    this thread."""
    return list(_LAST_CONTAINED.value)


def deserialize(payload: bytes, buffers: List[Any]) -> Any:
    return pickle.loads(payload, buffers=buffers)


def pack(value: Any) -> bytes:
    """Serialize into a single contiguous frame (copies buffers once)."""
    payload, buffers = serialize(value)
    out = io.BytesIO()
    out.write(struct.pack("<I", len(payload)))
    out.write(payload)
    out.write(struct.pack("<I", len(buffers)))
    for buf in buffers:
        raw = buf.raw()
        out.write(struct.pack("<Q", raw.nbytes))
        out.write(raw)
    return out.getvalue()


def packed_size(payload: bytes, buffers: List[pickle.PickleBuffer]) -> int:
    total = 4 + len(payload) + 4
    for buf in buffers:
        total += 8 + buf.raw().nbytes
    return total


def pack_into(payload: bytes, buffers: List[pickle.PickleBuffer], mv: memoryview) -> int:
    """Pack a pre-serialized value into a writable memoryview (e.g. shm segment).

    Returns bytes written. The large-buffer copy happens exactly once, directly
    into the destination mapping.
    """
    offset = 0
    struct.pack_into("<I", mv, offset, len(payload))
    offset += 4
    mv[offset : offset + len(payload)] = payload
    offset += len(payload)
    struct.pack_into("<I", mv, offset, len(buffers))
    offset += 4
    for buf in buffers:
        raw = buf.raw()
        n = raw.nbytes
        struct.pack_into("<Q", mv, offset, n)
        offset += 8
        mv[offset : offset + n] = raw.cast("B") if raw.ndim != 1 else raw
        offset += n
    return offset


_PWRITE_SPAN = 32 << 20


def _pwrite_all(fd: int, data, off: int) -> int:
    """pwrite `data` fully at `off`; returns bytes written. Spans are capped
    so partial writes (signals, >2 GiB caps) are handled."""
    mv = memoryview(data)
    if mv.ndim != 1 or mv.format != "B":
        mv = mv.cast("B")
    total = mv.nbytes
    done = 0
    while done < total:
        n = os.pwritev(fd, [mv[done:done + _PWRITE_SPAN]], off + done)
        if n <= 0:
            raise OSError(f"pwritev made no progress at offset {off + done}")
        done += n
    return total


def _pwrite_striped(fd: int, data, off: int) -> int:
    """pwrite a LARGE buffer as N thread-striped spans. Page supply (cold
    tmpfs allocation) is the put path's wall on this host class — one
    writer measures ~0.93 GiB/s while two stripes measure ~1.1 and four
    ~1.25 (pwritev releases the GIL, and the kernel allocates per-cpu).
    Positional writes at disjoint offsets need no ordering. Falls back to
    the single-thread path for small buffers or stripe_threads <= 1."""
    from . import config as rt_config

    mv = memoryview(data)
    if mv.ndim != 1 or mv.format != "B":
        mv = mv.cast("B")
    total = mv.nbytes
    threads = rt_config.get("put_stripe_threads")
    if threads <= 1 or total < rt_config.get("put_stripe_min_bytes"):
        return _pwrite_all(fd, mv, off)
    stripe = -(-total // threads)
    errs: List[BaseException] = []

    def write_stripe(lo: int, hi: int):
        try:
            _pwrite_all(fd, mv[lo:hi], off + lo)
        except BaseException as e:  # noqa: BLE001 — re-raised by caller
            errs.append(e)

    ts = [
        threading.Thread(
            target=write_stripe,
            args=(i * stripe, min((i + 1) * stripe, total)),
            name="rtpu-put-stripe", daemon=True,
        )
        for i in range(threads)
        if i * stripe < total
    ]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]
    return total


def pack_into_fd(payload: bytes, buffers: List[pickle.PickleBuffer],
                 fd: int, base: int) -> int:
    """Pack a pre-serialized value into a FILE at `base`, via write syscalls
    instead of memcpy into a fresh mapping.

    Same wire format as `pack_into`. Why a second path exists: on
    lazily-backed guest kernels (see core/mem.py) first-touch faults through
    a fresh shm mapping run ~7× slower than the tmpfs write() path even when
    batched with madvise — so large creates go through the backing FILE of
    the destination segment (coherent with its mappings; tmpfs page cache IS
    the backing store). Buffers past put_stripe_min_bytes stripe their
    write across put_stripe_threads (the 16 GiB roundtrip's put side is
    page-supply-bound; see _pwrite_striped)."""
    off = base
    off += _pwrite_all(fd, struct.pack("<I", len(payload)), off)
    off += _pwrite_all(fd, payload, off)
    off += _pwrite_all(fd, struct.pack("<I", len(buffers)), off)
    for buf in buffers:
        raw = buf.raw()
        off += _pwrite_all(fd, struct.pack("<Q", raw.nbytes), off)
        off += _pwrite_striped(fd, raw, off)
    return off - base


def unpack(frame: memoryview | bytes) -> Any:
    """Deserialize from a frame; numpy arrays view the frame buffer (zero-copy)."""
    mv = memoryview(frame)
    offset = 0
    (npayload,) = struct.unpack_from("<I", mv, offset)
    offset += 4
    payload = bytes(mv[offset : offset + npayload])
    offset += npayload
    (nbufs,) = struct.unpack_from("<I", mv, offset)
    offset += 4
    buffers = []
    for _ in range(nbufs):
        (n,) = struct.unpack_from("<Q", mv, offset)
        offset += 8
        buffers.append(mv[offset : offset + n])
        offset += n
    return deserialize(payload, buffers)

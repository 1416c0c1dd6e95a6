"""PlasmaLite — shared-memory object store for one machine.

Reference analog: the plasma store (`src/ray/object_manager/plasma/store.h:55`)
— per-node immutable shared-memory objects, zero-copy reads, LRU eviction with
disk spilling (`raylet LocalObjectManager`). Redesign: instead of a store
server process brokered over a unix socket, each object is its own named POSIX
shm segment (`/dev/shm/rtput-<hex>`; the reference's are `rtpu-`,
ray_tpu/core/store.py:7); creators write the serialized frame
directly into the mapping, readers attach by name and deserialize zero-copy
(numpy arrays view the mapping). Lifetime/refcounts live in the controller;
this module is the mechanical mmap layer used by every process.
"""

from __future__ import annotations

import contextlib
import os
import threading
from multiprocessing import shared_memory
from typing import Any, Dict, Optional, Tuple

from . import mem, serialization

# Objects smaller than this ride the control plane inline instead of shm
# (reference: small objects go to the in-process memory store, big to plasma).
# Resolved at import: set RAY_TPU_INLINE_THRESHOLD_BYTES before the process
# starts (it shapes wire formats; mid-run changes would desync processes).
from . import config as _rt_config  # noqa: E402

INLINE_THRESHOLD = _rt_config.get("inline_threshold_bytes")

# Creates at or above this size go through the destination's backing FILE
# (pwritev / pack_into_fd) instead of memcpy into a fresh mapping: on
# lazily-backed guest kernels the write() path allocates tmpfs pages ~7×
# faster than first-touch faults through an mmap (see core/mem.py).
FD_WRITE_MIN = 1 << 20

from .host_names import SESSION_ROOT, SHM_PREFIX  # noqa: E402

_SHM_PREFIX = SHM_PREFIX  # (reference: "rtpu-", ray_tpu/core/store.py:37)

# Per-session tag (the controller's pid) baked into segment names so (a) a
# second session on the machine can never collide and (b) leaked segments are
# attributable to a session whose liveness /proc can answer.
SESSION_TAG = ""


def set_session_tag(tag: str):
    global SESSION_TAG
    SESSION_TAG = str(tag)


def _untrack(seg: shared_memory.SharedMemory):
    """Detach the segment from Python's resource tracker.

    Without this (3.12 has no ``track=False``), the tracker of whichever
    process merely *attached* the segment unlinks it at that process's exit,
    yanking shared objects out from under live readers. Lifetime is owned by
    the controller instead.
    """
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(seg._name, "shared_memory")
    except Exception:  # noqa: BLE001
        pass


BORROW_PREFIX = "borrow!"


def make_borrow_name(path: str, offset: int, size: int) -> str:
    """Self-describing zero-copy location: any process on this machine can
    open and map the span from the name alone (plasma's shared-segment
    property, carried in the name instead of an fd). The pin that keeps the
    source span alive is held by the node agent that adopted the borrow."""
    return f"{BORROW_PREFIX}{path}!{offset}!{size}"


def parse_borrow_name(name: str):
    """(path, offset, size) or None."""
    if not name.startswith(BORROW_PREFIX):
        return None
    path, off, size = name[len(BORROW_PREFIX):].rsplit("!", 2)
    return path, int(off), int(size)


def shm_name_for(object_hex: str) -> str:
    # shm_open names are limited (~255 incl. leading /); 28-byte ids are 56 hex.
    return f"{_SHM_PREFIX}{SESSION_TAG}-{object_hex}"


class LocalStore:
    """Per-process handle cache over the machine-wide shm segments."""

    def __init__(self):
        self._open: Dict[str, shared_memory.SharedMemory] = {}
        self._lock = threading.Lock()
        # Borrowed spans (same-host zero-copy adoption): name -> (mmap, pin)
        # — the mmap keeps views valid, the pin socket (agent only) keeps the
        # SOURCE span alive until release.
        self._borrows: Dict[str, tuple] = {}

    # ------------------------------------------------------------- borrows
    def supports_borrow_of(self, name: str) -> bool:
        """Only sources that can PIN the span for the borrow's lifetime may
        serve borrows. Plain shm segments have no pin (an unlink would
        strand borrowers that haven't mapped yet), and chained borrows
        would pin the intermediary, not the origin."""
        return False

    def adopt_borrow(self, object_hex: str, path: str, offset: int,
                     size: int, pin) -> str:
        """Register a same-host borrowed span as a local object. `pin` is an
        open socket whose closure releases the source-side pin (may be None
        in processes that merely READ an already-adopted borrow). Maps the
        span EAGERLY so the data outlives any later unlink of the name."""
        name = make_borrow_name(path, offset, size)
        stale_pin = None
        with self._lock:
            entry = self._borrows.get(name)
            if entry is None:
                self._borrows[name] = (None, pin)
            elif entry[1] is None and pin is not None:
                self._borrows[name] = (entry[0], pin)
            else:
                stale_pin = pin  # duplicate adoption — one lease suffices
        if stale_pin is not None:
            try:
                stale_pin.close()
            except OSError:
                pass
        try:
            self._borrow_view(name)
        except OSError:
            pass  # reads will surface the error with context
        return name

    def _borrow_view(self, name: str) -> memoryview:
        import mmap as _mmap

        parsed = parse_borrow_name(name)
        path, offset, size = parsed
        with self._lock:
            entry = self._borrows.get(name)
            if entry is not None and entry[0] is not None:
                return memoryview(entry[0])[offset:offset + size]
            fd = os.open(path, os.O_RDONLY)
            try:
                mm = _mmap.mmap(fd, 0, prot=_mmap.PROT_READ)
            finally:
                os.close(fd)
            pin = entry[1] if entry is not None else None
            self._borrows[name] = (mm, pin)
            return memoryview(mm)[offset:offset + size]

    # ------------------------------------------------------------- creation
    def create_packed(self, object_hex: str, payload: bytes, buffers) -> Tuple[str, int]:
        """Write a pre-serialized value into a fresh segment; returns (name, size)."""
        size = serialization.packed_size(payload, buffers)
        name = shm_name_for(object_hex)
        try:
            seg = shared_memory.SharedMemory(name=name, create=True, size=max(size, 1))
        except FileExistsError:
            # A prior attempt (e.g. a worker that died mid-write before a task
            # retry) may have left a half-written segment — replace it.
            try:
                stale = shared_memory.SharedMemory(name=name)
                _untrack(stale)
                stale.close()
                stale.unlink()
            except FileNotFoundError:
                pass
            seg = shared_memory.SharedMemory(name=name, create=True, size=max(size, 1))
        _untrack(seg)
        try:
            if size >= FD_WRITE_MIN:
                fd = os.open(f"/dev/shm/{name}", os.O_WRONLY)
                try:
                    serialization.pack_into_fd(payload, buffers, fd, 0)
                finally:
                    os.close(fd)
            else:
                serialization.pack_into(payload, buffers, seg.buf)
        except BaseException:
            seg.close()
            seg.unlink()
            raise
        with self._lock:
            self._open[name] = seg
        return name, size

    def put(self, object_hex: str, value: Any) -> Tuple[Optional[str], Optional[bytes], int]:
        """Serialize a value. Returns (shm_name, inline_frame, size): exactly one
        of shm_name/inline_frame is set depending on the inline threshold."""
        payload, buffers = serialization.serialize(value)
        size = serialization.packed_size(payload, buffers)
        if size <= INLINE_THRESHOLD:
            frame = bytearray(size)
            serialization.pack_into(payload, buffers, memoryview(frame))
            return None, bytes(frame), size
        name, size = self.create_packed(object_hex, payload, buffers)
        return name, None, size

    # ------------------------------------------------- raw bytes (transfer)
    def create_raw(self, object_hex: str, data: bytes) -> Tuple[str, int]:
        """Write an already-packed frame (received from a peer node)."""
        name = shm_name_for(object_hex)
        size = len(data)
        try:
            seg = shared_memory.SharedMemory(name=name, create=True, size=max(size, 1))
        except FileExistsError:
            return name, size  # a concurrent pull already materialized it
        _untrack(seg)
        if size >= FD_WRITE_MIN:
            fd = os.open(f"/dev/shm/{name}", os.O_WRONLY)
            try:
                serialization._pwrite_all(fd, data, 0)
            finally:
                os.close(fd)
        else:
            seg.buf[:size] = data
        with self._lock:
            self._open[name] = seg
        return name, size

    def read_raw(self, shm_name: str) -> bytes:
        """Packed frame bytes of a local object (for serving a peer's pull)."""
        if shm_name.startswith(BORROW_PREFIX):
            return bytes(self._borrow_view(shm_name))
        with self._lock:
            seg = self._open.get(shm_name)
            if seg is None:
                seg = shared_memory.SharedMemory(name=shm_name)
                _untrack(seg)
                self._open[shm_name] = seg
        return bytes(seg.buf)

    # --------------------------------------- chunked transfer (pull plane)
    def raw_size(self, shm_name: str) -> int:
        if shm_name.startswith(BORROW_PREFIX):
            return parse_borrow_name(shm_name)[2]
        with self._lock:
            seg = self._open.get(shm_name)
            if seg is None:
                seg = shared_memory.SharedMemory(name=shm_name)
                _untrack(seg)
                self._open[shm_name] = seg
        return seg.size

    def read_raw_slice(self, shm_name: str, offset: int, length: int) -> bytes:
        if shm_name.startswith(BORROW_PREFIX):
            return bytes(self._borrow_view(shm_name)[offset:offset + length])
        with self._lock:
            seg = self._open.get(shm_name)
            if seg is None:
                seg = shared_memory.SharedMemory(name=shm_name)
                _untrack(seg)
                self._open[shm_name] = seg
        return bytes(seg.buf[offset:offset + length])

    @contextlib.contextmanager
    def bulk_source(self, shm_name: str):
        """(fd, base_offset, size) of the file backing `shm_name` — the bulk
        server (`bulk.py`) sendfiles spans straight from the page cache."""
        if shm_name.startswith(BORROW_PREFIX):
            path, offset, size = parse_borrow_name(shm_name)
            fd = os.open(path, os.O_RDONLY)
            try:
                yield fd, offset, size
            finally:
                os.close(fd)
            return
        fd = os.open(f"/dev/shm/{shm_name}", os.O_RDONLY)
        try:
            yield fd, 0, os.fstat(fd).st_size
        finally:
            os.close(fd)

    @contextlib.contextmanager
    def bulk_map_source(self, shm_name: str):
        """(path, offset, size) for SAME-HOST handover — the puller opens the
        backing file itself and preads (plasma fd-passing, by name)."""
        if shm_name.startswith(BORROW_PREFIX):
            # Chained borrow: hand out the ORIGINAL file span.
            yield parse_borrow_name(shm_name)
            return
        path = f"/dev/shm/{shm_name}"
        yield path, 0, os.stat(path).st_size

    def create_begin(self, object_hex: str, size: int):
        """Begin an incremental (chunked) write of a pulled object. Returns
        (name, writer) — writer is None if the object already exists (pulls
        are deduped per node upstream, so an existing segment is a COMPLETED
        copy; failed writers abort-unlink, and a crash mid-write is a node
        death — the controller drops this node's locations entirely)."""
        name = shm_name_for(object_hex)
        try:
            seg = shared_memory.SharedMemory(name=name, create=True, size=max(size, 1))
        except FileExistsError:
            return name, None
        _untrack(seg)
        with self._lock:
            self._open[name] = seg
        return name, _ShmWriter(self, name, seg)

    # -------------------------------------------------------------- reading
    def read(self, shm_name: str) -> Any:
        """Attach and deserialize. Numpy arrays are zero-copy views over the
        mapping; the segment handle stays open in this process's cache so the
        views remain valid."""
        if shm_name.startswith(BORROW_PREFIX):
            return serialization.unpack(self._borrow_view(shm_name))
        with self._lock:
            seg = self._open.get(shm_name)
            if seg is None:
                seg = shared_memory.SharedMemory(name=shm_name)
                _untrack(seg)
                self._open[shm_name] = seg
        return serialization.unpack(seg.buf)

    def read_from_file(self, path: str) -> Any:
        """Restore a spilled object (copies into private memory)."""
        with open(path, "rb") as f:
            data = f.read()
        return serialization.unpack(data)

    # ------------------------------------------------------------- lifetime
    def spill(self, shm_name: str, spill_dir: str) -> str:
        """Copy a segment to disk and drop the shm (controller-directed)."""
        os.makedirs(spill_dir, exist_ok=True)
        if shm_name.startswith(BORROW_PREFIX):
            import hashlib

            path = os.path.join(
                spill_dir,
                "borrow-" + hashlib.md5(shm_name.encode()).hexdigest(),
            )
            with open(path, "wb") as f:
                f.write(self._borrow_view(shm_name))  # memoryview: no copy
            self.release(shm_name)
            return path
        path = os.path.join(spill_dir, shm_name)
        with self._lock:
            seg = self._open.get(shm_name)
            if seg is None:
                seg = shared_memory.SharedMemory(name=shm_name)
                _untrack(seg)
                self._open[shm_name] = seg
        with open(path, "wb") as f:
            f.write(bytes(seg.buf))
        self.release(shm_name, unlink=True)
        return path

    def release(self, shm_name: str, unlink: bool = False):
        if shm_name.startswith(BORROW_PREFIX):
            with self._lock:
                entry = self._borrows.pop(shm_name, None)
            if entry is not None:
                mm, pin = entry
                if pin is not None:
                    try:
                        pin.close()  # releases the source-side span pin
                    except OSError:
                        pass
                if mm is not None:
                    try:
                        mm.close()
                    except (BufferError, ValueError):
                        pass  # live views; mapping dies with the process
            return  # never unlink the source-owned file
        with self._lock:
            seg = self._open.pop(shm_name, None)
        if seg is None and unlink:
            try:
                seg = shared_memory.SharedMemory(name=shm_name)
                _untrack(seg)
            except FileNotFoundError:
                return
        if seg is not None:
            try:
                seg.close()
            except BufferError:
                # Live zero-copy views still reference the mapping; keep the
                # handle open (re-cache) and skip close. Unlink below still
                # removes the name so the memory is freed once views die.
                with self._lock:
                    self._open[shm_name] = seg
                if unlink:
                    try:
                        seg.unlink()
                    except FileNotFoundError:
                        pass
                return
            if unlink:
                try:
                    seg.unlink()
                except FileNotFoundError:
                    pass

    def close_all(self, unlink: bool = False):
        with self._lock:
            names = list(self._open)
        for name in names:
            self.release(name, unlink=unlink)


def cleanup_stale_segments():
    """Remove segments leaked by *dead* sessions.

    Segment names embed the owning controller's pid (`rtput-<pid>-<hex>`; reference `rtpu-`); a
    segment is stale iff that pid no longer exists. Live sessions on the same
    machine are never touched. Called at controller startup.
    """
    shm_dir = "/dev/shm"
    try:
        entries = os.listdir(shm_dir)
    except OSError:
        return
    for fn in entries:
        if not fn.startswith(_SHM_PREFIX):
            continue
        tag = fn[len(_SHM_PREFIX) :].split("-", 1)[0]
        if not tag.isdigit():
            continue
        if os.path.exists(f"/proc/{tag}"):
            continue  # owning controller still alive
        marker = restorable_marker_path(tag)
        try:
            marker_age = __import__("time").time() - os.path.getmtime(marker)
        except OSError:
            marker_age = None
        if marker_age is not None and marker_age < 3600.0:
            # A standalone controller died holding this tag but its session
            # is restorable (GCS-FT): a restart will re-adopt the segments.
            # The marker is removed on graceful teardown; after an hour a
            # never-restarted session stops shielding its segments (leak cap).
            continue
        if marker_age is not None:
            try:
                os.unlink(marker)  # expired marker
            except OSError:
                pass
        try:
            os.unlink(os.path.join(shm_dir, fn))
        except OSError:
            pass


def restorable_marker_path(tag: str) -> str:
    # (reference: "/tmp/ray_tpu", ray_tpu/core/store.py:448)
    return os.path.join(SESSION_ROOT, f"restorable_{tag}")


def mark_restorable(tag: str, on: bool):
    """Standalone controllers protect their dead-session segments from
    other sessions' startup cleanup while a restore remains possible."""
    path = restorable_marker_path(tag)
    try:
        if on:
            os.makedirs(SESSION_ROOT, exist_ok=True)  # (reference: ray_tpu/core/store.py:457)
            with open(path, "w") as f:
                f.write("")
        else:
            os.unlink(path)
    except OSError:
        pass


# =============================================================== native arena
# C++ arena-backed store (plasma-equivalent allocator in ray_tpu_torch/native).
# Objects live in ONE session shm segment managed by the native allocator;
# names are "arena:<object_hex>". Falls back to per-object segments when the
# arena is full or the native lib is unavailable.

ARENA_PREFIX = "arena:"


def arena_segment_name() -> str:
    # Matches the `rtput-<pid>-…` convention (reference `rtpu-`) so cleanup_stale_segments()
    # reclaims arenas of dead sessions too.
    return f"/{_SHM_PREFIX}{SESSION_TAG}-arena"


class _ShmWriter:
    """Incremental writer for a chunked pull into a plain shm segment."""

    __slots__ = ("_store", "_name", "_seg", "_populated", "_wfd")

    def __init__(self, store, name, seg):
        self._store = store
        self._name = name
        self._seg = seg
        self._populated = False
        self._wfd = None

    def ensure_populated(self):
        """Batch the destination's first-touch page faults (mem.py) before a
        memcpy-style landing (recv_into/preadv). Idempotent."""
        if not self._populated:
            self._populated = True
            mem.populate_write(self._seg.buf)

    def sink(self):
        """(path, base_offset) of the backing file — bulk landings go through
        it via write()-path syscalls, no mmap faults at all (mem.py)."""
        return f"/dev/shm/{self._name}", 0

    def _fd(self) -> int:
        if self._wfd is None:
            self._wfd = os.open(f"/dev/shm/{self._name}", os.O_WRONLY)
        return self._wfd

    def write(self, offset: int, data: bytes):
        serialization._pwrite_all(self._fd(), data, offset)

    def raw_view(self, offset: int, length: int) -> memoryview:
        """Writable window for the bulk plane's recv_into (no staging)."""
        return memoryview(self._seg.buf)[offset:offset + length]

    def _close_fd(self):
        if self._wfd is not None:
            try:
                os.close(self._wfd)
            except OSError:
                pass
            self._wfd = None

    def commit(self):
        self._close_fd()  # plain shm has no seal step

    def abort(self):
        self._close_fd()
        try:
            with self._store._lock:
                self._store._open.pop(self._name, None)
            self._seg.close()
            self._seg.unlink()
        except Exception:  # noqa: BLE001
            pass


class _ArenaWriter:
    """Incremental writer into the native arena (create → write → seal)."""

    __slots__ = ("_store", "_hex", "_view", "_file_off", "_populated")

    def __init__(self, store, object_hex, view, file_off=None):
        self._store = store
        self._hex = object_hex
        self._view = view
        self._file_off = file_off
        self._populated = False

    def ensure_populated(self):
        """Batch the destination's first-touch page faults (mem.py) before a
        memcpy-style landing (recv_into/preadv). Idempotent."""
        if not self._populated:
            self._populated = True
            mem.populate_write(self._view)

    def sink(self):
        """(path, base_offset) of the object's span in the arena's backing
        file, or None — bulk landings go through it via write()-path
        syscalls, no mmap faults at all (mem.py)."""
        if self._file_off is None:
            return None
        name = self._store.arena.name.lstrip("/")
        return f"/dev/shm/{name}", self._file_off

    def write(self, offset: int, data: bytes):
        if self._file_off is not None and len(data) >= FD_WRITE_MIN:
            serialization._pwrite_all(
                self._store._write_fd(), data, self._file_off + offset
            )
        else:
            self._view[offset:offset + len(data)] = data

    def raw_view(self, offset: int, length: int) -> memoryview:
        """Writable window for the bulk plane's recv_into (no staging)."""
        return self._view[offset:offset + length]

    def commit(self):
        self._view.release()
        self._store.arena.seal(self._hex)

    def abort(self):
        try:
            self._view.release()
            self._store.arena.delete(self._hex)
        except Exception:  # noqa: BLE001
            pass


class ArenaStore:
    """LocalStore-compatible store over the native shm arena."""

    def __init__(self, arena, fallback: Optional[LocalStore] = None):
        self.arena = arena
        self.fallback = fallback or LocalStore()
        self._pinned: Dict[str, Any] = {}  # hex -> root memoryview (1 pin each)
        self._lock = threading.Lock()
        self._wfd: Optional[int] = None  # cached write fd on the backing file

    def _write_fd(self) -> int:
        """Write fd on the arena's backing file, for large creates via the
        write() syscall path (pwritev with explicit offsets — safe to share
        across threads). See FD_WRITE_MIN."""
        with self._lock:
            if self._wfd is None:
                self._wfd = os.open(
                    f"/dev/shm/{self.arena.name.lstrip('/')}", os.O_WRONLY
                )
            return self._wfd

    # ------------------------------------------------------------- creation
    def create_packed(self, object_hex: str, payload: bytes, buffers) -> Tuple[str, int]:
        size = serialization.packed_size(payload, buffers)
        try:
            view, file_off = self.arena.create(object_hex, size, with_offset=True)
        except MemoryError:
            # Arena full → classic per-object segment keeps progress.
            return self.fallback.create_packed(object_hex, payload, buffers)
        try:
            if size >= FD_WRITE_MIN:
                serialization.pack_into_fd(
                    payload, buffers, self._write_fd(), file_off
                )
            else:
                serialization.pack_into(payload, buffers, view)
        except BaseException:
            view.release()
            self.arena.delete(object_hex)
            raise
        view.release()
        self.arena.seal(object_hex)
        return ARENA_PREFIX + object_hex, size

    def put(self, object_hex: str, value: Any) -> Tuple[Optional[str], Optional[bytes], int]:
        payload, buffers = serialization.serialize(value)
        size = serialization.packed_size(payload, buffers)
        if size <= INLINE_THRESHOLD:
            frame = bytearray(size)
            serialization.pack_into(payload, buffers, memoryview(frame))
            return None, bytes(frame), size
        name, size = self.create_packed(object_hex, payload, buffers)
        return name, None, size

    def adopt_borrow(self, object_hex: str, path: str, offset: int,
                     size: int, pin) -> str:
        return self.fallback.adopt_borrow(object_hex, path, offset, size, pin)

    def supports_borrow_of(self, name: str) -> bool:
        # Arena objects carry a real pin (bulk_map_source holds locate());
        # everything else (plain shm, chained borrows) must be copied.
        return name.startswith(ARENA_PREFIX)

    # -------------------------------------------------------------- reading
    def read(self, name: str) -> Any:
        if not name.startswith(ARENA_PREFIX):
            return self.fallback.read(name)
        hex_id = name[len(ARENA_PREFIX):]
        with self._lock:
            view = self._pinned.get(hex_id)
            if view is None:
                view = self.arena.get(hex_id)
                if view is None:
                    raise FileNotFoundError(f"object {hex_id} not in arena")
                self._pinned[hex_id] = view  # hold the pin for zero-copy views
        return serialization.unpack(view)

    def read_from_file(self, path: str) -> Any:
        return self.fallback.read_from_file(path)

    # ------------------------------------------------- raw bytes (transfer)
    def create_raw(self, object_hex: str, data: bytes) -> Tuple[str, int]:
        size = len(data)
        try:
            existing = self.arena.get(object_hex)
        except BlockingIOError:
            existing = None  # another writer mid-pull; controller dedups
        if existing is not None:
            existing.release()
            self.arena.release(object_hex)
            return ARENA_PREFIX + object_hex, size
        try:
            view, file_off = self.arena.create(object_hex, size, with_offset=True)
        except MemoryError:
            return self.fallback.create_raw(object_hex, data)
        if size >= FD_WRITE_MIN:
            serialization._pwrite_all(self._write_fd(), data, file_off)
        else:
            view[:size] = data
        view.release()
        self.arena.seal(object_hex)
        return ARENA_PREFIX + object_hex, size

    def read_raw(self, name: str) -> bytes:
        if not name.startswith(ARENA_PREFIX):
            return self.fallback.read_raw(name)
        hex_id = name[len(ARENA_PREFIX):]
        view = self.arena.get(hex_id)
        if view is None:
            raise FileNotFoundError(f"object {hex_id} not in arena")
        try:
            return bytes(view)
        finally:
            try:
                view.release()
                self.arena.release(hex_id)
            except BufferError:
                pass

    # --------------------------------------- chunked transfer (pull plane)
    def raw_size(self, name: str) -> int:
        if not name.startswith(ARENA_PREFIX):
            return self.fallback.raw_size(name)
        hex_id = name[len(ARENA_PREFIX):]
        view = self.arena.get(hex_id)
        if view is None:
            raise FileNotFoundError(f"object {hex_id} not in arena")
        try:
            return view.nbytes
        finally:
            try:
                view.release()
                self.arena.release(hex_id)
            except BufferError:
                pass

    def read_raw_slice(self, name: str, offset: int, length: int) -> bytes:
        if not name.startswith(ARENA_PREFIX):
            return self.fallback.read_raw_slice(name, offset, length)
        hex_id = name[len(ARENA_PREFIX):]
        view = self.arena.get(hex_id)
        if view is None:
            raise FileNotFoundError(f"object {hex_id} not in arena")
        try:
            return bytes(view[offset:offset + length])
        finally:
            try:
                view.release()
                self.arena.release(hex_id)
            except BufferError:
                pass

    @contextlib.contextmanager
    def bulk_source(self, name: str):
        """(fd, base_offset, size) for sendfile — the object's span INSIDE
        the arena's backing file, pinned for the duration of the serve."""
        if not name.startswith(ARENA_PREFIX):
            with self.fallback.bulk_source(name) as src:
                yield src
            return
        hex_id = name[len(ARENA_PREFIX):]
        # fd first: once locate() pins the object, every exit path must
        # reach the release() below (an os.open failure between the two
        # would leak the pin and block eviction of that span forever).
        fd = os.open(f"/dev/shm/{self.arena.name.lstrip('/')}", os.O_RDONLY)
        try:
            loc = self.arena.locate(hex_id)
            if loc is None:
                raise FileNotFoundError(f"object {hex_id} not in arena")
            offset, size = loc
            try:
                yield fd, offset, size
            finally:
                self.arena.release(hex_id)
        finally:
            os.close(fd)

    @contextlib.contextmanager
    def bulk_map_source(self, name: str):
        """(path, offset, size) for SAME-HOST handover, pinned while the
        puller preads the span (plasma fd-passing, by name)."""
        if not name.startswith(ARENA_PREFIX):
            with self.fallback.bulk_map_source(name) as src:
                yield src
            return
        hex_id = name[len(ARENA_PREFIX):]
        loc = self.arena.locate(hex_id)
        if loc is None:
            raise FileNotFoundError(f"object {hex_id} not in arena")
        offset, size = loc
        try:
            yield f"/dev/shm/{self.arena.name.lstrip('/')}", offset, size
        finally:
            self.arena.release(hex_id)

    def create_begin(self, object_hex: str, size: int):
        try:
            existing = self.arena.get(object_hex)
        except BlockingIOError:
            # Unsealed entry: a LOCAL producer is mid-write (pulls for the
            # same hex are deduped upstream — node_agent._pulls_inflight).
            # Report present; the producer's seal completes the object.
            return ARENA_PREFIX + object_hex, None
        if existing is not None:
            existing.release()
            self.arena.release(object_hex)
            return ARENA_PREFIX + object_hex, None
        try:
            view, file_off = self.arena.create(object_hex, size, with_offset=True)
        except MemoryError:
            return self.fallback.create_begin(object_hex, size)
        return ARENA_PREFIX + object_hex, _ArenaWriter(
            self, object_hex, view, file_off
        )

    # ------------------------------------------------------------- lifetime
    def spill(self, name: str, spill_dir: str) -> str:
        if not name.startswith(ARENA_PREFIX):
            return self.fallback.spill(name, spill_dir)
        hex_id = name[len(ARENA_PREFIX):]
        os.makedirs(spill_dir, exist_ok=True)
        path = os.path.join(spill_dir, f"arena-{hex_id}")
        with self._lock:
            view = self._pinned.pop(hex_id, None)
        if view is None:
            view = self.arena.get(hex_id)
            if view is None:
                raise FileNotFoundError(hex_id)
        with open(path, "wb") as f:
            f.write(bytes(view))
        try:
            view.release()
        except BufferError:
            pass  # exported numpy views keep the pin; delete below may defer
        self.arena.release(hex_id)
        self.arena.delete(hex_id)
        return path

    def release(self, name: str, unlink: bool = False):
        if not name.startswith(ARENA_PREFIX):
            return self.fallback.release(name, unlink)
        hex_id = name[len(ARENA_PREFIX):]
        with self._lock:
            view = self._pinned.pop(hex_id, None)
        if view is not None:
            try:
                view.release()
                self.arena.release(hex_id)
            except BufferError:
                # Live zero-copy views — keep the pin; the object stays until
                # the views die and the process exits/closes.
                with self._lock:
                    self._pinned[hex_id] = view
                return
        if unlink:
            self.arena.delete(hex_id)  # no-op if other processes still pin it

    def close_all(self, unlink: bool = False):
        with self._lock:
            pinned = dict(self._pinned)
            self._pinned.clear()
            if self._wfd is not None:
                try:
                    os.close(self._wfd)
                except OSError:
                    pass
                self._wfd = None
        for hex_id, view in pinned.items():
            try:
                view.release()
                self.arena.release(hex_id)
            except BufferError:
                pass
        self.fallback.close_all(unlink=unlink)


def make_store(
    create_arena: bool = False,
    arena_capacity: Optional[int] = None,
):
    """Store factory: native arena when buildable (controller creates, others
    attach), else the per-object-segment LocalStore.

    Opt out with RAY_TPU_STORE=segments.
    """
    if os.environ.get("RAY_TPU_STORE", "") == "segments":
        return LocalStore()
    try:
        from ..native import Arena
    except Exception:  # noqa: BLE001
        return LocalStore()
    name = arena_segment_name()
    try:
        if create_arena:
            capacity = arena_capacity or (1 << 30)
            # Never claim more than half of what /dev/shm can still hold.
            try:
                st = os.statvfs("/dev/shm")
                capacity = min(capacity, st.f_bavail * st.f_frsize // 2)
            except OSError:
                pass
            arena = Arena(name, capacity=capacity, create=True)
            if _rt_config.get("arena_prefault"):
                # Background warmup tracking the allocation watermark —
                # object writes hit warm pages (core/mem.py rationale)
                # without paying to fault capacity the session never uses.
                # used_safe() holds the arena's handle lock across the
                # native read, so an explicit detach() (borrow/attach churn,
                # close paths, tests) can never free the handle between the
                # snapshot and the dereference — the unlocked snapshot here
                # was a use-after-free segfault under a concurrent
                # create/borrow/detach loop (ISSUE 4 satellite; stress test
                # in tests/test_arena.py). A raise inside used_safe() ends
                # the prefault loop cleanly (mem.populate_watermark_async
                # treats any used_fn exception as "arena gone").
                mem.populate_watermark_async(
                    arena._base, arena.capacity, arena.used_safe
                )
        else:
            arena = Arena(name, create=False)
    except Exception:  # noqa: BLE001  (native build failed / arena absent)
        return LocalStore()
    return ArenaStore(arena)

"""Native (C++) components, built on demand with g++ and bound via ctypes.

The reference keeps its runtime core in C++ (`src/ray/…`); here the
machine-local object plane's hot allocator lives in `src/arena.cpp`
(plasma-equivalent arena — SURVEY.md §2.1), the seqlock channel ops in
`src/channel.cpp`, and the bulk-plane off-GIL landing (stream + ring
landers) in `src/bulk.cpp`. Each .so is compiled once per source change
into `_build/` (no pip, no pybind — plain g++ + ctypes per the
environment contract); every loader degrades to None so the Python
fallbacks keep working where no toolchain exists.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "arena.cpp")
_BUILD_DIR = os.path.join(_DIR, "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _lib_path(src: str, stem: str) -> str:
    """Content-addressed output path: staleness keyed on the source hash,
    never mtime (a fresh clone stamps all files with the same mtime)."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"lib{stem}-{digest}.so")


def _compile(src: str, lib_path: str, what: str) -> Optional[str]:
    """Compile one .so if absent. Returns an error string or None."""
    if os.path.exists(lib_path):
        return None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = lib_path + f".tmp.{os.getpid()}"
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
        "-o", tmp, src, "-lpthread", "-lrt",
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:  # g++ absent/hung
        return f"{what} build failed: {e!r}"
    if proc.returncode != 0:
        return f"{what} build failed:\n{proc.stderr[-2000:]}"
    os.replace(tmp, lib_path)  # atomic: concurrent builders race safely
    # Prune siblings from older source revisions (content-addressed names
    # accumulate otherwise; live processes keep their mmap via the open fd).
    stem = os.path.basename(lib_path).rsplit("-", 1)[0]
    for f in os.listdir(_BUILD_DIR):
        if f.startswith(stem + "-") and f.endswith(".so") and f != os.path.basename(lib_path):
            try:
                os.remove(os.path.join(_BUILD_DIR, f))
            except OSError:
                pass
    return None


def load_arena_lib() -> Optional[ctypes.CDLL]:
    """The cached handle to the native library, or None if unbuildable."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        lib_path = _lib_path(_SRC, "ray_tpu_torch_arena")  # reference: "ray_tpu_arena", ray_tpu/native/__init__.py:76
        err = _compile(_SRC, lib_path, "arena")
        if err is not None:
            _build_error = err
            return None
        lib = _dlopen(_SRC, lib_path, "arena")
        if lib is None:
            _build_error = "arena dlopen failed (see stderr)"
            return None
        lib.rt_arena_create.restype = ctypes.c_void_p
        lib.rt_arena_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
        lib.rt_arena_attach.restype = ctypes.c_void_p
        lib.rt_arena_attach.argtypes = [ctypes.c_char_p]
        lib.rt_arena_alloc.restype = ctypes.c_int64
        lib.rt_arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        lib.rt_arena_seal.restype = ctypes.c_int
        lib.rt_arena_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rt_arena_get.restype = ctypes.c_int64
        lib.rt_arena_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)
        ]
        lib.rt_arena_release.restype = ctypes.c_int
        lib.rt_arena_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rt_arena_delete.restype = ctypes.c_int
        lib.rt_arena_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rt_arena_evict_lru.restype = ctypes.c_uint64
        lib.rt_arena_evict_lru.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.rt_arena_base.restype = ctypes.c_void_p
        lib.rt_arena_base.argtypes = [ctypes.c_void_p]
        for fn in ("rt_arena_capacity", "rt_arena_used", "rt_arena_num_objects",
                   "rt_arena_data_offset"):
            getattr(lib, fn).restype = ctypes.c_uint64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.rt_arena_detach.restype = ctypes.c_int
        lib.rt_arena_detach.argtypes = [ctypes.c_void_p]
        lib.rt_arena_unlink.restype = ctypes.c_int
        lib.rt_arena_unlink.argtypes = [ctypes.c_char_p]
        _lib = lib
        return _lib


def _dlopen(src: str, lib_path: str, what: str) -> Optional[ctypes.CDLL]:
    """CDLL with one rebuild retry: a concurrent builder's prune can remove
    this digest's file between the existence check and dlopen (shared
    checkout mid-update) — rebuild from source rather than crash."""
    try:
        return ctypes.CDLL(lib_path)
    except OSError:
        if _compile(src, lib_path, what) is not None:
            return None
        try:
            return ctypes.CDLL(lib_path)
        except OSError:
            return None


def build_error() -> Optional[str]:
    return _build_error


# ------------------------------------------------------- channel (seqlock)
_CH_SRC = os.path.join(_DIR, "src", "channel.cpp")
_ch_lib: Optional[ctypes.CDLL] = None
_ch_error: Optional[str] = None


def load_channel_lib() -> Optional[ctypes.CDLL]:
    """Native seqlock channel ops (`src/channel.cpp`) — used by the
    compiled-DAG/pipeline channels; None if unbuildable (Python fallback)."""
    global _ch_lib, _ch_error
    with _lock:
        if _ch_lib is not None:
            return _ch_lib
        if _ch_error is not None:
            return None
        lib_path = _lib_path(_CH_SRC, "ray_tpu_torch_channel")  # reference: "ray_tpu_channel", ray_tpu/native/__init__.py:154
        err = _compile(_CH_SRC, lib_path, "channel")
        if err is not None:
            _ch_error = err
            return None
        lib = _dlopen(_CH_SRC, lib_path, "channel")
        if lib is None:
            _ch_error = "channel dlopen failed (see stderr)"
            return None
        lib.rtpu_ch_write.restype = ctypes.c_int64
        lib.rtpu_ch_write.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int64,
        ]
        lib.rtpu_ch_wait_read.restype = ctypes.c_int64
        lib.rtpu_ch_wait_read.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int64,
        ]
        lib.rtpu_ch_ack.restype = None
        lib.rtpu_ch_ack.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
        _ch_lib = lib
        return _ch_lib


def channel_build_error() -> Optional[str]:
    return _ch_error


# ------------------------------------------------------- bulk lander (off-GIL)
_BULK_SRC = os.path.join(_DIR, "src", "bulk.cpp")
_bulk_lib: Optional[ctypes.CDLL] = None
_bulk_error: Optional[str] = None


def load_bulk_lib() -> Optional[ctypes.CDLL]:
    """Native bulk-plane landing ops (`src/bulk.cpp`): the whole-span
    poll/read/pwrite stream loop and the pinned ring-lander thread — used by
    `core/bulk.py` to take the receive path off the GIL; None if unbuildable
    (the pure-Python ChunkPipeline remains the fallback)."""
    global _bulk_lib, _bulk_error
    with _lock:
        if _bulk_lib is not None:
            return _bulk_lib
        if _bulk_error is not None:
            return None
        lib_path = _lib_path(_BULK_SRC, "ray_tpu_torch_bulk")  # reference: "ray_tpu_bulk", ray_tpu/native/__init__.py:201
        err = _compile(_BULK_SRC, lib_path, "bulk")
        if err is not None:
            _bulk_error = err
            return None
        lib = _dlopen(_BULK_SRC, lib_path, "bulk")
        if lib is None:
            _bulk_error = "bulk dlopen failed (see stderr)"
            return None
        lib.rt_bulk_land_stream.restype = ctypes.c_longlong
        lib.rt_bulk_land_stream.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_int,
        ]
        lib.rt_lander_create.restype = ctypes.c_void_p
        lib.rt_lander_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.rt_lander_submit.restype = ctypes.c_longlong
        lib.rt_lander_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_int,
        ]
        lib.rt_lander_wait.restype = ctypes.c_int
        lib.rt_lander_wait.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
        ]
        lib.rt_lander_completed.restype = ctypes.c_longlong
        lib.rt_lander_completed.argtypes = [ctypes.c_void_p]
        lib.rt_lander_error.restype = ctypes.c_int
        lib.rt_lander_error.argtypes = [ctypes.c_void_p]
        lib.rt_lander_close.restype = ctypes.c_int
        lib.rt_lander_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _bulk_lib = lib
        return _bulk_lib


def bulk_build_error() -> Optional[str]:
    return _bulk_error


class Arena:
    """Pythonic handle over one shm arena (create or attach)."""

    def __init__(self, name: str, capacity: Optional[int] = None, create: bool = False):
        lib = load_arena_lib()
        if lib is None:
            raise RuntimeError(f"native arena unavailable: {build_error()}")
        self._lib = lib
        self.name = name
        if create:
            if capacity is None:
                raise ValueError("capacity required to create an arena")
            self._h = lib.rt_arena_create(name.encode(), capacity, 0)
        else:
            self._h = lib.rt_arena_attach(name.encode())
        if not self._h:
            raise RuntimeError(
                f"arena {'create' if create else 'attach'} failed for {name!r}"
            )
        self._base = lib.rt_arena_base(self._h)
        self._owner = create
        # Guards the handle's LIFETIME for CROSS-THREAD readers: detach()
        # frees the native handle, so a thread that snapshots self._h and
        # then dereferences it races a concurrent detach into a
        # use-after-free (the store's prefault thread reading used-bytes
        # during a borrow/detach cycle was the observed segfault —
        # core/store.py). used_safe() and detach() share this lock; the
        # other methods stay unlocked by contract — they are only called
        # from the thread that owns the handle's lifetime. Any future
        # background reader must go through the lock like used_safe().
        import threading

        self._hlock = threading.RLock()

    # -------------------------------------------------------------- objects
    def create(self, object_id: str, size: int, with_offset: bool = False):
        """Allocate an unsealed object; returns a writable view of it — or
        (view, file_offset) with ``with_offset`` (the bulk plane's same-host
        map handover sendfiles into that span of the backing file; the offset
        is only knowable here because `locate()` requires a sealed object)."""
        off = self._lib.rt_arena_alloc(self._h, object_id.encode(), size)
        if off < 0:
            raise MemoryError(f"arena alloc failed for {object_id} ({size}B)")
        view = self._view(off, size)
        if with_offset:
            return view, off + self._lib.rt_arena_data_offset(self._h)
        return view

    def seal(self, object_id: str):
        if self._lib.rt_arena_seal(self._h, object_id.encode()) != 0:
            raise KeyError(object_id)

    def get(self, object_id: str) -> Optional[memoryview]:
        """Pin + return a read view of a sealed object; None if absent.
        Balance every successful get with release(). Handle-lifetime safe:
        the bulk server's serve threads call this concurrently with session
        teardown's detach() (see _hlock note above — rt_arena_get on a
        freed handle was a real segfault, observed from
        bulk._serve_map → bulk_map_source during the chaos kill test)."""
        with self._hlock:
            if not self._h:
                return None  # arena detached (session tearing down)
            size = ctypes.c_uint64()
            off = self._lib.rt_arena_get(self._h, object_id.encode(), ctypes.byref(size))
            if off == -1:
                return None
            if off == -2:
                raise BlockingIOError(f"object {object_id} not sealed yet")
            return self._view(off, size.value)

    def locate(self, object_id: str):
        """Pin + return (file_offset, size) of a sealed object within the
        arena's backing file (object offsets are payload-relative; adding
        data_offset makes them file offsets — bulk.py sendfiles from them).
        None if absent. Balance every successful locate with release().
        Handle-lifetime safe like get() — bulk serve threads race detach."""
        with self._hlock:
            if not self._h:
                return None
            size = ctypes.c_uint64()
            off = self._lib.rt_arena_get(self._h, object_id.encode(), ctypes.byref(size))
            if off == -1:
                return None
            if off == -2:
                raise BlockingIOError(f"object {object_id} not sealed yet")
            return off + self._lib.rt_arena_data_offset(self._h), size.value

    def release(self, object_id: str):
        with self._hlock:
            if not self._h:
                return  # arena already detached; the pin died with it
            self._lib.rt_arena_release(self._h, object_id.encode())

    def delete(self, object_id: str) -> bool:
        return self._lib.rt_arena_delete(self._h, object_id.encode()) == 0

    def evict_lru(self, want_bytes: int) -> list:
        """Evict sealed, unpinned objects; returns their ids."""
        cap = 4096
        buf = ctypes.create_string_buffer(cap * 64)
        count = ctypes.c_uint64()
        self._lib.rt_arena_evict_lru(self._h, want_bytes, buf, cap, ctypes.byref(count))
        out = []
        for k in range(count.value):
            raw = buf.raw[k * 64 : (k + 1) * 64]
            out.append(raw.split(b"\0", 1)[0].decode())
        return out

    # --------------------------------------------------------------- stats
    @property
    def capacity(self) -> int:
        return self._lib.rt_arena_capacity(self._h)

    @property
    def used(self) -> int:
        return self._lib.rt_arena_used(self._h)

    @property
    def num_objects(self) -> int:
        return self._lib.rt_arena_num_objects(self._h)

    # ------------------------------------------------------------ internals
    def _view(self, offset: int, size: int) -> memoryview:
        buf = (ctypes.c_char * size).from_address(self._base + offset)
        return memoryview(buf).cast("B")

    def used_safe(self) -> int:
        """used-bytes read that is safe against a concurrent detach()
        (raises RuntimeError once detached — callers like the prefault
        thread treat that as "arena gone, stop")."""
        with self._hlock:
            if not self._h:
                raise RuntimeError("arena detached")
            return self._lib.rt_arena_used(self._h)

    def detach(self):
        with self._hlock:
            if self._h:
                self._lib.rt_arena_detach(self._h)
                self._h = None

    def unlink(self):
        self._lib.rt_arena_unlink(self.name.encode())

    def __del__(self):
        try:
            self.detach()
        except Exception:  # noqa: BLE001
            pass

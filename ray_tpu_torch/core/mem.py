"""Page-population helpers for shm-backed object writes.

Why this exists: on this class of host (Firecracker/virtualized kernels with
lazily-backed guest memory), a first-touch page fault through an mmap of a
tmpfs file costs ~40-50us/page — memcpy into a fresh shm mapping crawls at
~0.1 GiB/s while the plain `write()` syscall path to the SAME tmpfs file
runs at ~3 GiB/s (measured in-repo; see bench in the round-4 notes). The
reference sidesteps this class of problem by writing objects through the
plasma store process which owns long-lived, already-faulted arenas
(`src/ray/object_manager/plasma/store.h:55`); our per-session arena mapping
is long-lived too, but every NEW allocation's pages still fault on first
touch.

`populate_write(buf)` batches those faults into one
`madvise(MADV_POPULATE_WRITE)` syscall (~2.6 GiB/s), after which memcpy /
`recv_into` / `preadv` land at warm-page speed. On kernels without
MADV_POPULATE_WRITE (<5.14) the call fails with EINVAL and we fall back to
doing nothing — the write path still works, just slower.
"""

from __future__ import annotations

import ctypes
import os
import mmap

_MADV_POPULATE_WRITE = 23  # linux uapi mman-common.h (kernel >= 5.14)
_PAGE = mmap.PAGESIZE
_POPULATE_MIN = 1 << 20  # below 1 MiB the fault cost doesn't matter

_libc = None
_unavailable = False


def _get_libc():
    global _libc, _unavailable
    if _libc is None and not _unavailable:
        try:
            _libc = ctypes.CDLL(None, use_errno=True)
            _libc.madvise.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
            ]
            _libc.madvise.restype = ctypes.c_int
        except Exception:  # noqa: BLE001
            _unavailable = True
    return _libc


def populate_watermark_async(addr: int, length: int, used_fn,
                             ahead: int = 512 << 20, chunk: int = 64 << 20,
                             name: str = "rtpu-arena-prefault"):
    """Keep the arena mapping faulted-in AHEAD of its allocation watermark,
    from a nice-19 background daemon thread (content-preserving madvise —
    safe concurrent with writers in any process).

    Why ahead-of-use rather than the whole capacity: tmpfs pages, once
    faulted into the guest, stay resident for the life of the arena FILE
    (frees return blocks to the allocator, not pages to the host), so
    populating is a one-time cost per page — but populating the FULL
    capacity up front burns seconds of this 1-vCPU box per session whether
    or not the store is ever used. Tracking `used_fn()` (allocator
    used-bytes, a shared-header read) pays only for what the session
    actually touches, plus `ahead` of headroom so foreground writes land on
    warm pages. Analog: plasma's optional pool preallocation
    (`src/ray/object_manager/plasma/plasma_allocator.cc`).
    """
    libc = _get_libc()
    if libc is None or length <= 0:
        return

    def run():
        try:
            # Linux: threads are schedulable tasks — demote THIS thread so
            # the warmup never competes with foreground work for the CPU
            # (the fault work is charged to the caller of madvise).
            os.setpriority(os.PRIO_PROCESS, 0, 19)
        except OSError:
            pass
        import time

        base = addr & ~(_PAGE - 1)
        end = addr + length
        # Mappings are page-granular, so the span's LAST page belongs to the
        # mapping even when addr+length ends mid-page — rounding the end up
        # is safe, and every chunk below is clamped to it. (Rounding the
        # STEP up unclamped made the final madvise run past the mapping on
        # non-page-aligned capacities → EINVAL → prefault silently aborted
        # short of the end; ADVICE r4.)
        end_up = (end + _PAGE - 1) & ~(_PAGE - 1)
        done = base  # populated up to here; stays page-aligned (madvise
        # rejects unaligned ADDRESSES with EINVAL — only lengths round)
        while done < end:
            try:
                used = int(used_fn())
            except Exception:  # noqa: BLE001 — arena detached/closed
                return
            # Headroom grows WITH usage: a control-plane-only session warms
            # ~64 MiB (instant), a data-heavy one keeps up to `ahead` of
            # warm runway. A fixed large headroom at boot cost ~1s of this
            # 1-vCPU box per session — enough to push the controller's
            # first FT snapshot past restart-test windows.
            runway = max(64 << 20, min(ahead, used))
            target = min(addr + used + runway, end)
            if target <= done:
                time.sleep(0.5)
                continue
            step = min(chunk, target - done)
            step = (step + _PAGE - 1) & ~(_PAGE - 1)
            step = min(step, end_up - done)  # never run past the mapping
            if step <= 0:
                return
            try:
                if libc.madvise(done, step, _MADV_POPULATE_WRITE) != 0:
                    import errno as _errno

                    err = ctypes.get_errno()
                    if done == base and err == _errno.EINVAL:
                        return  # unsupported kernel (<5.14) — nothing to warm
                    # Transient range/pressure error (e.g. ENOMEM under
                    # memory pressure): skip this chunk rather than aborting
                    # the whole warmup; the pages fault lazily if touched.
                    done += step
                    continue
            except Exception:  # noqa: BLE001
                return
            done += step

    import threading

    threading.Thread(target=run, name=name, daemon=True).start()


def populate_write(buf) -> bool:
    """Pre-fault the pages backing a writable buffer (best effort).

    Returns True if the madvise succeeded. Safe to call repeatedly (an
    already-populated range is a fast no-op walk) and on any size (small
    buffers are skipped).
    """
    libc = _get_libc()
    if libc is None:
        return False
    try:
        view = memoryview(buf)
        n = view.nbytes
        if n < _POPULATE_MIN or view.readonly:
            return False
        addr = ctypes.addressof(ctypes.c_char.from_buffer(view))
    except (TypeError, ValueError, BufferError):
        return False
    start = addr & ~(_PAGE - 1)
    length = (addr + n + _PAGE - 1 & ~(_PAGE - 1)) - start
    # Partial neighbor pages at the edges get populated too — harmless (they
    # belong to the same mapping, and populating a resident page is a no-op).
    return libc.madvise(start, length, _MADV_POPULATE_WRITE) == 0

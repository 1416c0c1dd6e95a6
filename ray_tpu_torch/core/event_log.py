"""Durable write-ahead event log for the controller (GCS FT replay role).

Reference analog: the GCS's Redis-backed table persistence
(`redis_store_client.h:33`) + startup replay (`gcs_init_data.cc`) — the
mechanism behind the reference paper's fault-tolerance claim (Moritz et
al., arXiv 1712.05889 §4.2: "the GCS … enables us to recover from
failures by replaying the event log"). Redesign: instead of a remote
store, every state-mutating control-plane transition appends a compact
msgpack record to a segmented, CRC-guarded, fsync-batched log in the
session dir. The periodic snapshot becomes log COMPACTION (snapshot =
checkpoint + truncate-before), and restore becomes snapshot + replay —
recovery loses nothing after the last fsync instead of everything after
the last snapshot tick.

Record wire format (fixed header, then payload):

    [u32 payload_len][u32 crc32(payload)][payload = msgpack([seq, kind, fields])]

* `seq` is a monotonically increasing u64 across segments — the snapshot
  records the seq it covers (`wal_seq`) and replay starts after it.
* CRC is over the payload only; a bit flip or a torn final record fails
  the check and replay TRUNCATES the log at the first bad record (the
  torn tail was never acknowledged durable — see docs/CONTROL_PLANE_HA.md
  for the recovery ordering contract).
* Segments (`wal-<first_seq>.seg`) rotate at `wal_segment_bytes`;
  `checkpoint(seq)` unlinks segments wholly covered by a snapshot.

Durability model: appends write() synchronously (survives kill -9 of the
process — the page cache outlives it); fsync is BATCHED by a flusher
thread (`wal_fsync_interval_s` / `wal_fsync_bytes`) and bounds loss to
the fsync window only for whole-machine crashes. `sync="always"` forces
an fsync per append for tests that want zero-window semantics.

Fault-point injection (chaos harness): `RAY_TPU_FAULT_POINTS` names
crash sites, comma-separated, each optionally scoped to a record kind
with `@kind`:

    crash-before-fsync[@kind]   exit before the record reaches the fd
    crash-after-log[@kind]      exit after write+fsync, before the ack
    torn-tail[@kind]            write HALF the record, fsync, exit

Each fires once per process (the exit guarantees it); the chaos suite
asserts recovery invariants — no actor lost, none doubled — at each site.
"""

from __future__ import annotations

import os
import struct
import sys
import threading
import zlib
from typing import Callable, Iterator, List, Optional, Tuple

import msgpack

_HDR = struct.Struct("<II")  # payload_len, crc32(payload)
_MAX_RECORD = 64 << 20  # sanity bound for replay (corrupt length field)

FAULT_ENV = "RAY_TPU_FAULT_POINTS"


def fault_match(point: str, kind: str = "") -> bool:
    """True when RAY_TPU_FAULT_POINTS names `point` (bare, or scoped to
    this record kind with `point@kind`)."""
    spec = os.environ.get(FAULT_ENV, "")
    if not spec:
        return False
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, _, tag = entry.partition("@")
        if name == point and (not tag or tag == kind):
            return True
    return False


def fault_fire(point: str, kind: str = ""):
    """Hard-exit at an injected fault site (kill -9 semantics: no atexit,
    no flush beyond what the site already did)."""
    print(f"FAULT_POINT_FIRED point={point} kind={kind}", file=sys.stderr,
          flush=True)
    os._exit(137)


class EventLog:
    """Segmented append-only record log; single-writer (the controller's
    main loop appends; a daemon thread batches fsyncs)."""

    def __init__(
        self,
        root: str,
        segment_bytes: int = 8 << 20,
        sync: str = "batch",
        fsync_interval_s: float = 0.05,
        fsync_bytes: int = 256 << 10,
        on_fsync: Optional[Callable[[float], None]] = None,
    ):
        self.root = root
        self.segment_bytes = int(segment_bytes)
        self.sync = sync  # "batch" | "always" | "none"
        self.fsync_interval_s = float(fsync_interval_s)
        self.fsync_bytes = int(fsync_bytes)
        self.on_fsync = on_fsync  # observer: seconds one fsync took
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._fd: Optional[int] = None
        self._seg_path: Optional[str] = None
        self._seg_size = 0
        self._dirty_bytes = 0
        self._closed = False
        self.truncated_records = 0  # torn-tail records dropped at open
        # Position after the last GOOD record on disk (torn tails cut now,
        # so append never writes after garbage).
        self.seq = self._recover_tail()
        self._flusher: Optional[threading.Thread] = None
        if self.sync == "batch":
            self._flusher = threading.Thread(
                target=self._flush_loop, name="wal-fsync", daemon=True
            )
            self._flusher.start()

    # ------------------------------------------------------------ segments
    def _segments(self) -> List[Tuple[int, str]]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("wal-") and name.endswith(".seg"):
                try:
                    out.append((int(name[4:-4]), os.path.join(self.root, name)))
                except ValueError:
                    continue
        out.sort()
        return out

    def _open_segment(self, first_seq: int):
        if self._fd is not None:
            os.close(self._fd)
        self._seg_path = os.path.join(self.root, f"wal-{first_seq:016d}.seg")
        self._fd = os.open(self._seg_path, os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o600)
        self._seg_size = os.fstat(self._fd).st_size

    def _recover_tail(self) -> int:
        """Walk every segment, validate records, truncate at the first bad
        one (CRC mismatch / short header / insane length), and return the
        last good seq. Opens the tail segment for append."""
        last_seq = 0
        segs = self._segments()
        for i, (first, path) in enumerate(segs):
            good_end, seqs, bad = _scan_segment(path)
            if seqs:
                last_seq = seqs[-1]
            if bad:
                # Torn/corrupt record: cut the segment there. History past
                # a bad record is untrusted — and a LATER segment would be
                # a gap in the seq stream, so corruption mid-history drops
                # everything after it too (replay must never skip a gap;
                # the cut is surfaced as a recovery_truncated marker).
                with open(path, "ab") as f:
                    f.truncate(good_end)
                self.truncated_records += bad
                for _nfirst, npath in segs[i + 1:]:
                    try:
                        os.unlink(npath)
                    except OSError:
                        pass
                    self.truncated_records += 1
                segs = segs[: i + 1]
                break
        if segs:
            # Seed from the segment NAME too: after a rotation the tail
            # segment can be empty (its records live in earlier, possibly
            # checkpoint-compacted segments) — re-seeding from records alone
            # would restart seq at 0, and appends below the checkpoint's
            # wal_seq would be silently skipped by every later replay.
            last_seq = max(last_seq, segs[-1][0] - 1)
            self._open_segment(segs[-1][0])
        else:
            self._open_segment(1)
        return last_seq

    # -------------------------------------------------------------- append
    def append(self, kind: str, fields: dict) -> int:
        """Buffer one record (seq assigned here). Write is synchronous
        (kill -9 durable); fsync policy per `sync`. Returns the seq."""
        if self._closed:
            return self.seq
        if fault_match("crash-before-fsync", kind):
            # Exit before the record touches the fd: the transition is LOST
            # and the client's resubmission/dedup path must absorb it.
            fault_fire("crash-before-fsync", kind)
        with self._lock:
            seq = self.seq = self.seq + 1
            payload = msgpack.packb([seq, kind, fields], use_bin_type=True)
            frame = _HDR.pack(len(payload), zlib.crc32(payload)) + payload
            if fault_match("torn-tail", kind):
                os.write(self._fd, frame[: max(len(frame) // 2, 1)])
                os.fsync(self._fd)
                fault_fire("torn-tail", kind)
            os.write(self._fd, frame)
            self._seg_size += len(frame)
            self._dirty_bytes += len(frame)
            if self.sync == "always" or (
                self.sync == "batch" and self._dirty_bytes >= self.fsync_bytes
            ):
                self._fsync_locked()
            if self._seg_size >= self.segment_bytes:
                self._fsync_locked()
                self._open_segment(seq + 1)
        if fault_match("crash-after-log", kind):
            # Record is durable but the ack never leaves: replay + client
            # resubmission meet, and dedup must collapse them.
            self.flush()
            fault_fire("crash-after-log", kind)
        return seq

    def _fsync_locked(self):
        if self._fd is None or not self._dirty_bytes:
            return
        import time as _t

        t0 = _t.monotonic()
        os.fsync(self._fd)
        self._dirty_bytes = 0
        if self.on_fsync is not None:
            try:
                self.on_fsync(_t.monotonic() - t0)
            except Exception:  # noqa: BLE001 — observability never fatal
                pass

    def flush(self):
        with self._lock:
            self._fsync_locked()

    def _flush_loop(self):
        import time as _t

        while not self._closed:
            _t.sleep(self.fsync_interval_s)
            try:
                self.flush()
            except OSError:
                return  # fd closed under us (shutdown)

    # ----------------------------------------------------------- recovery
    def replay(self, from_seq: int = 0) -> Iterator[Tuple[int, str, dict]]:
        """Yield (seq, kind, fields) for every durable record with
        seq > from_seq, in order. Pure read — safe to call repeatedly
        (the idempotency fixpoint test replays twice)."""
        for _first, path in self._segments():
            for seq, kind, fields in _iter_segment(path):
                if seq > from_seq:
                    yield seq, kind, fields

    def total_bytes(self) -> int:
        return sum(
            os.path.getsize(p) for _s, p in self._segments()
            if os.path.exists(p)
        )

    def checkpoint(self, covered_seq: int):
        """A snapshot covering every transition up to `covered_seq` landed:
        unlink segments whose records are ALL <= covered_seq (the active
        segment always survives)."""
        with self._lock:
            segs = self._segments()
            for i, (first, path) in enumerate(segs):
                nxt = segs[i + 1][0] if i + 1 < len(segs) else None
                # A segment is fully covered when the NEXT segment starts at
                # or below covered_seq+1 (its own records all precede that).
                if nxt is None or nxt > covered_seq + 1 or path == self._seg_path:
                    continue
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def reset(self):
        """Discard ALL segments and restart at seq 0 — a controller booting
        a FRESH session over a session dir whose restore failed must not
        leave the dead session's records where a later failover would
        replay them as this session's state."""
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None
            for _first, path in self._segments():
                try:
                    os.unlink(path)
                except OSError:
                    pass
            self.seq = 0
            self._dirty_bytes = 0
            self._open_segment(1)

    def close(self):
        self._closed = True
        with self._lock:
            try:
                self._fsync_locked()
            except OSError:
                pass
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None


def _scan_segment(path: str) -> Tuple[int, List[int], int]:
    """(offset after last good record, seqs seen, bad-record count ≥ that
    offset). A single bad record poisons the rest of the file — framing is
    lost past it, so everything after counts as one truncation event."""
    seqs: List[int] = []
    good_end = 0
    bad = 0
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return 0, seqs, 0
    off = 0
    while off + _HDR.size <= len(data):
        ln, crc = _HDR.unpack_from(data, off)
        body_off = off + _HDR.size
        if ln > _MAX_RECORD or body_off + ln > len(data):
            bad = 1
            break
        payload = data[body_off:body_off + ln]
        if zlib.crc32(payload) != crc:
            bad = 1
            break
        try:
            seq, _kind, _fields = msgpack.unpackb(payload, raw=False)
        except Exception:  # noqa: BLE001 — CRC passed but decode didn't
            bad = 1
            break
        seqs.append(seq)
        off = body_off + ln
        good_end = off
    if off < len(data) and not bad:
        bad = 1  # trailing partial header
    return good_end, seqs, bad


def _iter_segment(path: str) -> Iterator[Tuple[int, str, dict]]:
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return
    off = 0
    while off + _HDR.size <= len(data):
        ln, crc = _HDR.unpack_from(data, off)
        body_off = off + _HDR.size
        if ln > _MAX_RECORD or body_off + ln > len(data):
            return
        payload = data[body_off:body_off + ln]
        if zlib.crc32(payload) != crc:
            return
        try:
            seq, kind, fields = msgpack.unpackb(payload, raw=False)
        except Exception:  # noqa: BLE001
            return
        yield seq, kind, fields
        off = body_off + ln

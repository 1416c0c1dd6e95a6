"""KV block transfer — computed prefix KV shipped between replicas as
`(name, offset, length)` spans over the bulk plane.

Same wire idiom as the data plane's shuffle transport (the reference's
`data/transport.py`): the exporter packs its blocks into ONE pickle-5 frame whose
out-of-band buffers are the per-block byte arrays laid out contiguously
(`serialization.pack` wire format:
``[u32 npayload][payload][u32 nbufs]{[u64 len][buffer]}*``), stores the
frame as a first-class arena object (`ClusterBackend.put_serialized`), and
publishes a small DESCRIPTOR: the span table keyed by the kv_manager's
chained blake2b digests — the SAME global content address the prefix
index, the fleet router, and the host tier all use — plus the pinning
ObjectRef and the producer-local store name.

Import fallback ladder (each rung correctness-preserving; the last rung is
exactly today's behavior):

  * descriptor carries ``inline`` bytes (no cluster backend / local mode)
    -> use them directly;
  * SAME-node consumer -> ``local_store.read(name)``: the blobs come back
    as zero-copy numpy views over the producer's arena mapping;
  * cross-node -> ``object_sources`` resolves a live copy, then the needed
    blocks' spans coalesce into contiguous runs pulled with
    ``bulk.pull_span`` (native off-GIL lander when built) into a scratch
    store object;
  * anything fails -> None: the caller imports nothing and the sequence
    RECOMPUTES its prefill — degraded mode is the pre-disaggregation path.

All-or-nothing: a fetch that cannot produce EVERY requested block returns
None rather than a partial set, so a crashed exporter can never leave a
half-imported prefix behind (the chaos gate in tests/test_serve_disagg.py).
"""

from __future__ import annotations

import os
import pickle
import secrets
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

DESCRIPTOR_VERSION = 1


def _rebuild_blob(dtype_str: str, shape, buf) -> np.ndarray:
    """Zero-copy view over whatever buffer the unpickler hands us (the
    arena mapping on a same-node read)."""
    return np.frombuffer(buf, dtype=np.dtype(dtype_str)).reshape(shape)


class _OOBBlock:
    """Wraps one block's contiguous byte array so it travels as ONE
    out-of-band pickle-5 buffer at a knowable frame offset."""

    __slots__ = ("arr",)

    def __init__(self, arr: np.ndarray):
        self.arr = arr

    def __reduce__(self):
        return (
            _rebuild_blob,
            (self.arr.dtype.str, self.arr.shape, pickle.PickleBuffer(self.arr)),
        )


def _backend():
    # _runtime_or_attach, never _global_runtime: an engine used outside a
    # cluster (unit tests, plain scripts) must degrade to inline
    # descriptors, not BOOT a local runtime as a side effect (a metrics
    # leak the reference once had).
    try:
        from ...core import api

        rt = api._runtime_or_attach()
        return rt.backend if rt is not None else None
    except Exception:  # noqa: BLE001 — no runtime (engine unit tests)
        return None


# ------------------------------------------------------------------ export
def export_descriptor(
    digests: Sequence[bytes],
    blobs: Sequence[np.ndarray],
    sig: str,
    block_size: int,
) -> Optional[Dict[str, Any]]:
    """Store `blobs` (one contiguous array per digest, chain order) as one
    arena segment and return the span descriptor. Degrades to an inline
    descriptor (bytes embedded) without a span-capable backend."""
    if not digests:
        return None
    blobs = [np.ascontiguousarray(b) for b in blobs]
    base = {
        "v": DESCRIPTOR_VERSION,
        "sig": sig,
        "block_size": int(block_size),
        "dtype": blobs[0].dtype.str,
        "shape": tuple(blobs[0].shape),
        "digests": [h.hex() for h in digests],
    }
    backend = _backend()
    put_serialized = getattr(backend, "put_serialized", None)
    if put_serialized is None:
        return {**base, "inline": [b.tobytes() for b in blobs]}

    from ...core import api

    payload, buffers, spans = pack_frame(base["digests"], blobs)
    rt = api._runtime_or_attach()
    ref, name, span_ok = put_serialized(
        payload, buffers, rt.current_task_id.hex()
    )
    if not span_ok:
        spans = None  # inline/head frame: span-addressed reads impossible
    return {**base, "ref": ref, "name": name, "spans": spans}


def pack_frame(digests_hex: Sequence[str], blobs: Sequence[np.ndarray]):
    """(payload, out-of-band buffers, spans) of one export frame — the
    k-th buffer is the k-th block, so span k addresses digest k's bytes
    inside the stored object. Shared by export_descriptor and the
    kv-transfer perf gate (which drives a store+BulkServer directly)."""
    from ...core import serialization

    wrapped = {"digests": list(digests_hex),
               "blocks": [_OOBBlock(b) for b in blobs]}
    payload, buffers = serialization.serialize(wrapped)
    spans: Optional[List[Tuple[int, int]]] = None
    if len(buffers) == len(blobs):
        # Frame layout: [u32 npayload][payload][u32 nbufs] then per buffer
        # [u64 len][bytes]; the k-th buffer is the k-th block, in order.
        cur = 4 + len(payload) + 4
        spans = []
        for b in buffers:
            n = b.raw().nbytes
            spans.append((cur + 8, n))
            cur += 8 + n
    return payload, buffers, spans


# ------------------------------------------------------------------ import
def _runs(idx: List[int], spans: List[Tuple[int, int]]) -> List[Tuple[int, int, List[int]]]:
    """Coalesce needed block indices into contiguous byte runs:
    (run_offset, run_length, member indices). Blocks are laid out in digest
    order with an 8-byte length header between them, so adjacent needed
    blocks merge into one bulk pull."""
    out: List[Tuple[int, int, List[int]]] = []
    for k in idx:
        off, n = spans[k]
        if out and off <= out[-1][0] + out[-1][1] + 8:
            po, pn, members = out.pop()
            out.append((po, off + n - po, members + [k]))
        else:
            out.append((off, n, [k]))
    return out


def _fetch_remote_runs(
    src: dict, desc: Dict[str, Any], needed: List[int], timeout_s: float,
    store=None,
) -> Optional[Dict[int, np.ndarray]]:
    """Pull the needed blocks' spans from the source's bulk server into a
    scratch store object (native lander path), slice out each block, and
    COPY it to private memory (the scratch is released before return)."""
    from ...core import bulk as bulk_mod

    if store is None:
        store = getattr(_backend(), "local_store", None)
    spans = desc["spans"]
    dtype = np.dtype(desc["dtype"])
    shape = tuple(desc["shape"])
    out: Dict[int, np.ndarray] = {}
    for run_off, run_len, members in _runs(needed, spans):
        if store is not None:
            sname, writer = store.create_begin(secrets.token_hex(28), run_len)
            try:
                bulk_mod.pull_span(
                    src["bulk"], src["name"], run_off, run_len, writer,
                    timeout_s,
                )
                writer.commit()
                raw = store.read_raw(sname)
                view = memoryview(raw)
                for k in members:
                    off, n = spans[k]
                    rel = off - run_off
                    out[k] = np.frombuffer(
                        view[rel:rel + n], dtype=dtype
                    ).reshape(shape).copy()
            finally:
                try:
                    store.release(sname, unlink=True)
                except Exception:  # noqa: BLE001
                    pass
        else:
            for k in members:
                off, n = spans[k]
                buf = bulk_mod.fetch_span_bytes(
                    src["bulk"], src["name"], off, n, timeout_s
                )
                out[k] = np.frombuffer(buf, dtype=dtype).reshape(shape)
    return out


def fetch_blocks(
    desc: Dict[str, Any],
    needed_hex: Sequence[str],
    timeout_s: float = 10.0,
) -> Optional[List[Tuple[str, np.ndarray]]]:
    """Materialize the requested digests' block bytes, all or nothing.
    Returns [(digest_hex, blob)] in `needed_hex` order, or None on any
    failure (the caller recomputes — degraded mode is today's behavior)."""
    if not needed_hex:
        return []
    digests: List[str] = desc.get("digests") or []
    pos = {h: i for i, h in enumerate(digests)}
    try:
        idx = [pos[h] for h in needed_hex]
    except KeyError:
        return None  # descriptor doesn't carry a requested digest

    from ...util import flight

    # The exporter stamped its trace id on the descriptor, so this span
    # (and the bulk.pull spans nested under the span_pull rung) lands in
    # the same x-request-id forest as the prefill that produced the KV.
    trace = desc.get("trace")
    t0 = flight.now_ns()

    def _done(result, rung: str):
        flight.record(
            "kv.fetch", t0, flight.now_ns(), trace=trace,
            lane="serve/kv", flow=f"disagg/{trace}" if trace else None,
            attrs={"rung": rung, "blocks": len(idx),
                   "ok": result is not None})
        return result

    inline = desc.get("inline")
    if inline is not None:
        dtype = np.dtype(desc["dtype"])
        shape = tuple(desc["shape"])
        try:
            return _done([
                (needed_hex[j],
                 np.frombuffer(inline[i], dtype=dtype).reshape(shape))
                for j, i in enumerate(idx)
            ], "inline")
        except Exception:  # noqa: BLE001
            return _done(None, "inline")

    backend = _backend()
    if backend is None:
        return None
    # Test/diagnostic knob: force the bulk span-pull rung even same-node
    # (proves the cross-machine path on a one-box cluster).
    force_span = os.environ.get("RAY_TPU_KV_FORCE_SPAN_PULL") == "1"

    # Rung 1: same-node zero-copy read straight off the producer's arena.
    name = desc.get("name")
    store = getattr(backend, "local_store", None)
    if name and store is not None and not force_span:
        try:
            wrapped = store.read(name)
            blocks = wrapped["blocks"]
            return _done(
                [(needed_hex[j], blocks[i]) for j, i in enumerate(idx)],
                "local")
        except Exception:  # noqa: BLE001 — not local / gone; pull spans
            pass

    # Rung 2: resolve a live copy and pull only the needed spans.
    spans = desc.get("spans")
    ref = desc.get("ref")
    sources_of = getattr(backend, "object_sources", None)
    if spans is not None and ref is not None and sources_of is not None:
        try:
            src = sources_of([ref.id.hex()])[0]
        except Exception:  # noqa: BLE001
            src = None
        if src:
            try:
                got = _fetch_remote_runs(src, desc, idx, timeout_s)
            except Exception:  # noqa: BLE001 — source died/evicted mid-read
                got = None
            if got is not None and len(got) == len(idx):
                return _done(
                    [(needed_hex[j], got[i]) for j, i in enumerate(idx)],
                    "span_pull")

    # Rung 3: whole-object get (borrow/map zero-copy same host, classic
    # transfer otherwise; lineage re-execution absorbs eviction).
    if ref is not None and not force_span:
        try:
            from ...core import api

            wrapped = api.get(ref, timeout=timeout_s)
            blocks = wrapped["blocks"]
            return _done(
                [(needed_hex[j], blocks[i]) for j, i in enumerate(idx)],
                "object_get")
        except Exception:  # noqa: BLE001
            return _done(None, "object_get")
    return _done(None, "none")

"""Trajectory transport for the Sebulba plane — whole time-major batches
over the arena + bulk planes.

An actor-gang member finishes a rollout fragment holding a dict of [T, N]
numpy arrays. Instead of pickling the dict through an RPC return (double
copy through the driver) it lands the WHOLE batch as ONE first-class arena
object: every array travels as an out-of-band pickle-5 buffer inside one
packed frame (`put_serialized` — the PR 8 span layout), and only a tiny
descriptor rides the actor's RPC reply. The learner imports by rung:

  1. inline — small fragments stay in the descriptor itself;
  2. same-node — the learner deserializes straight off the arena mapping
     (`local_store.read`), deep-copies the array views (nothing here may
     outlive the producer's pin), and releases its read pin;
  3. cross-node — `object_sources` resolves a live copy and ONE
     `bulk.fetch_span_bytes` pull lands the whole frame (span = the full
     object), which `serialization.unpack` opens without further copies;
  4. no rung left -> loud RuntimeError; the supervisor owns the failure.

Pinning contract (same as mpmd.transport): the producer holds each
published batch's ref until its NEXT publish on the same edge — by then the
learner has imported (the driver sequences collect -> update -> collect).

`stats` records which rung every publish/fetch took so the chaos/bench
tests can assert trajectory frames actually ride arena segments instead of
trusting size thresholds.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np

DEFAULT_INLINE_MAX = 64 * 1024


def _rebuild(dtype_str: str, shape, buf) -> np.ndarray:
    return np.frombuffer(buf, dtype=np.dtype(dtype_str)).reshape(shape)


class _OOBLeaf:
    """Array wrapper whose bytes travel as one out-of-band pickle-5 buffer
    (single-tensor analog in mpmd.transport; here one per batch column)."""

    __slots__ = ("arr",)

    def __init__(self, arr: np.ndarray):
        self.arr = arr

    def __reduce__(self):
        return (
            _rebuild,
            (self.arr.dtype.str, self.arr.shape, pickle.PickleBuffer(self.arr)),
        )


def _wrap(batch: Dict[str, Any]) -> Dict[str, Any]:
    return {
        k: _OOBLeaf(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
        for k, v in batch.items()
    }


class TrajTransport:
    """Publish/fetch of one trajectory-batch dict over the arena + bulk
    planes."""

    def __init__(
        self,
        inline_max_bytes: int = DEFAULT_INLINE_MAX,
        timeout_s: float = 60.0,
    ):
        self.inline_max = int(inline_max_bytes)
        self.timeout_s = timeout_s
        self.stats = {
            "pub_inline": 0, "pub_arena": 0,
            "fetch_inline": 0, "fetch_local": 0, "fetch_span": 0,
        }
        self._pin = None  # previous publish's ref, held until the next one

    # ----------------------------------------------------------- producer
    def publish(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Land `batch` on the arena, return the descriptor to ship. The
        previous publish's pin is dropped here — the driver's sequencing
        (update(i) completes before collect(i+1) starts) guarantees the
        learner imported it."""
        from ...core import api, serialization, store

        rt = api._global_runtime()
        backend = rt.backend if rt is not None else None
        put_serialized = getattr(backend, "put_serialized", None)
        nbytes = sum(
            v.nbytes for v in batch.values() if isinstance(v, np.ndarray)
        )
        # Below the store's own inline threshold put_serialized lands the
        # frame on the INLINE plane (no shared-store name, nothing for
        # fetch() to read) — such batches must stay in the RPC reply.
        inline_floor = max(self.inline_max, store.INLINE_THRESHOLD)
        if (
            put_serialized is None
            or nbytes <= inline_floor
            or getattr(backend, "remote_client", False)
        ):
            self._pin = None
            self.stats["pub_inline"] += 1
            return {"inline": batch}
        payload, buffers = serialization.serialize(_wrap(batch))
        try:
            task_hex = rt.current_task_id.hex()
        except Exception:  # noqa: BLE001 — outside a task context
            self._pin = None
            self.stats["pub_inline"] += 1
            return {"inline": batch}
        frame_len = serialization.packed_size(payload, buffers)
        ref, name, span_ok = put_serialized(payload, buffers, task_hex)
        if name is None:  # landed inline/remote after all (threshold drift)
            self._pin = None
            self.stats["pub_inline"] += 1
            return {"inline": batch}
        self._pin = ref  # drops the PREVIOUS ref; holds this one
        self.stats["pub_arena"] += 1
        return {
            "name": name,
            "hex": ref.id.hex(),
            # Span = the WHOLE packed frame: the cross-node import is one
            # bulk pull + unpack, not per-array requests.
            "frame_len": frame_len if span_ok else None,
        }

    # ----------------------------------------------------------- consumer
    def fetch(self, desc: Dict[str, Any]) -> Dict[str, np.ndarray]:
        if "inline" in desc:
            self.stats["fetch_inline"] += 1
            return desc["inline"]
        from ...core import api
        from ...core import bulk as bulk_mod

        backend = api._global_runtime().backend
        name = desc.get("name")
        local_store = getattr(backend, "local_store", None)
        if name and local_store is not None:
            try:
                raw = local_store.read(name)
            except Exception:  # noqa: BLE001 — not on this node / evicted
                pass
            else:
                # Unpacked arrays are views over the producer's arena
                # segment; copy eagerly so nothing outlives its pin, then
                # release our read pin so the producer's drop can free it.
                out = {
                    k: (np.array(v, copy=True) if isinstance(v, np.ndarray)
                        else v)
                    for k, v in raw.items()
                }
                try:
                    local_store.release(name)
                except Exception:  # noqa: BLE001 — release is best-effort
                    pass
                self.stats["fetch_local"] += 1
                return out
        frame_len = desc.get("frame_len")
        sources_of = getattr(backend, "object_sources", None)
        if frame_len is not None and sources_of is not None:
            (src,) = sources_of([desc["hex"]])
            if src:
                from ...core import serialization

                buf = bulk_mod.fetch_span_bytes(
                    src["bulk"], src["name"], 0, frame_len, self.timeout_s
                )
                self.stats["fetch_span"] += 1
                return serialization.unpack(buf)
        raise RuntimeError(
            f"trajectory object {desc.get('hex', '?')} unreachable "
            "(source gone and no span-servable copy) — failing the step for "
            "the gang supervisor"
        )

    def drop_pin(self):
        self._pin = None

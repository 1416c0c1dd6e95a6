"""Activation/gradient transport for the MPMD pipeline (port of the
reference's `ray_tpu/train/mpmd/transport.py`).

Control rides the compiled-DAG channels (`experimental/channel.py` shm
seqlock on a shared node, `tcp_channel.py` across nodes — the exact edges
`dag/compiled.py` builds); BULK tensor bytes ride the arena + bulk planes:
the sender lands the activation as a first-class arena object
(`put_serialized`, one out-of-band buffer at a knowable frame offset — the
span layout; the reference names its history) and ships only a tiny descriptor through the
channel. The receiver imports by rung:

  1. inline — small tensors travel in the channel payload itself (the
     channels grow on demand, so this is a latency choice, not a limit);
  2. same-node — the descriptor names the segment in the shared store; the
     consumer deserializes straight off the arena mapping (zero RPCs, one
     memcpy into the consumer-owned array — the copy the device transfer
     would do anyway, taken eagerly so no view outlives the producer's pin);
  3. cross-node — `object_sources` resolves a live copy and
     `bulk.fetch_span_bytes` pulls exactly the tensor's span over the
     native off-GIL lander (one wire request, no whole-object get);
  4. no rung left -> the step fails loudly and the elastic layer owns it.

**Tensors on the wire** (the port's): the planes carry numpy arrays. An
edge takes a torch tensor on any device and hands the receiver a CPU
tensor (`to_host` / `from_host`); numpy has no bfloat16, so a bf16 tensor
travels as its uint16 bits with a dtype tag in the descriptor (the
reference ships ml_dtypes' bfloat16 arrays).

**Wire precision** (`wire_dtype`): with "bf16", f32 tensors are cast to
bfloat16 at publish (round-to-nearest-even, torch's cast, where the
reference uses ml_dtypes: the bits are the same) and restored to f32 at
fetch, halving every rung's bytes.
Master weights and the ZeRO update never see the wire dtype — only the
activation/grad hop is compressed. Default "f32" is a bit-exact identity
so the parity gates stay bitwise meaningful; bf16 is gated by an allclose
loss-curve test. `WireCodec.stats` counts raw vs wire bytes per frame so
benches and the perf smoke can assert the ~2x cut.

**Double-buffered sends** (`ChannelEdge(send_depth=2)`): publish stays on
the caller's thread, but the blocking channel write moves to a per-edge
sender thread behind a bounded ring — the send of microbatch k overlaps
the compute of k+1 instead of stalling on the reader's ack. Pinning
extends to a 2-deep ring: the sender holds each published object's ref
until the NEXT write on the same edge completes (write k returning means
the reader acked — finished importing — message k-1, so at most
`send_depth` pins are live). Deeper send buffering only RELAXES a
schedule proven deadlock-free at depth 1: every blocking wait that could
wedge happens strictly later, never earlier.
"""

from __future__ import annotations

import pickle
import queue
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch  # the wire's tensors and its bf16 cast (the reference: ml_dtypes)

DEFAULT_INLINE_MAX = 256 * 1024

WIRE_DTYPES = ("f32", "bf16")

# The dtype tag of a bf16 tensor's uint16 bits (the reference's arrays carry
# ml_dtypes.bfloat16 itself, `ray_tpu/train/mpmd/transport.py:296-297`).
BF16_TAG = "bfloat16"


def to_host(t):
    """A tensor on any device -> (host numpy array of its own, dtype tag or
    None): a bf16 tensor becomes its uint16 bits tagged `BF16_TAG`. A numpy
    array passes as it is. (Port only: the reference's values are numpy
    already.)"""
    if isinstance(t, np.ndarray):
        return t, None
    t = t.detach().contiguous()
    tag = None
    if t.dtype == torch.bfloat16:
        t, tag = t.view(torch.int16), BF16_TAG
    arr = t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()
    return (arr.view(np.uint16) if tag else arr), tag


def from_host(arr: np.ndarray, tag: Optional[str] = None) -> torch.Tensor:
    """Inverse of `to_host`: a CPU tensor owning its bytes (a read-only or
    borrowed array is copied)."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable or not arr.flags.owndata:
        arr = arr.copy()
    if tag == BF16_TAG:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _bf16_bits(arr: np.ndarray) -> np.ndarray:
    """f32 -> bfloat16 bits (u16), round to nearest even: torch's cast, where
    the reference uses ml_dtypes (`ray_tpu/train/mpmd/transport.py:79-81`)."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _bf16_restore(bits: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """bfloat16 bits (u16) -> `dtype` (reference: ml_dtypes, `:92-96`)."""
    t = torch.from_numpy(np.ascontiguousarray(bits).view(np.int16).copy()).view(torch.bfloat16)
    return t.to(torch.float32).numpy().astype(dtype, copy=False)


class WireCodec:
    """Optional lossy wire encoding for one pipeline hop. "f32" is the
    identity; "bf16" casts f32 arrays to bfloat16 for the wire (shipped as
    a u16 view — numpy has no native bfloat16 — and restored to f32 on the
    other side). Non-f32 arrays (tokens, already-bf16 payloads) pass
    through unchanged. Thread-safe byte counters in `.stats`."""

    def __init__(self, wire_dtype: str = "f32"):
        if wire_dtype not in WIRE_DTYPES:
            raise ValueError(
                f"wire_dtype must be one of {WIRE_DTYPES}, got {wire_dtype!r}"
            )
        self.wire_dtype = wire_dtype
        self._lock = threading.Lock()
        self.stats = {"frames": 0, "raw_bytes": 0, "wire_bytes": 0}

    def encode(self, arr: np.ndarray):
        """-> (wire_arr, meta): meta is None for identity frames, else the
        original dtype str the decoder must restore."""
        arr = np.asarray(arr)
        out, meta = arr, None
        if self.wire_dtype == "bf16" and arr.dtype == np.float32:
            out = _bf16_bits(arr)  # reference: ml_dtypes (`:79-81`)
            meta = arr.dtype.str
        with self._lock:
            self.stats["frames"] += 1
            self.stats["raw_bytes"] += arr.nbytes
            self.stats["wire_bytes"] += out.nbytes
        return out, meta

    def decode(self, arr: np.ndarray, meta: Optional[str]) -> np.ndarray:
        if meta is None:
            return arr
        return _bf16_restore(np.asarray(arr), np.dtype(meta))  # reference: ml_dtypes (`:92-96`)


def _rebuild_oob(dtype_str: str, shape, buf) -> np.ndarray:
    return np.frombuffer(buf, dtype=np.dtype(dtype_str)).reshape(shape)


class _OOBArray:
    """Single-tensor analog of data/transport's _OOBColumn: the array's
    bytes travel as ONE out-of-band pickle-5 buffer at a computable frame
    offset; unpickling yields the ndarray directly."""

    __slots__ = ("arr",)

    def __init__(self, arr: np.ndarray):
        self.arr = arr

    def __reduce__(self):
        return (
            _rebuild_oob,
            (self.arr.dtype.str, self.arr.shape, pickle.PickleBuffer(self.arr)),
        )


class ActTransport:
    """Publish/fetch of one tensor over the arena + bulk planes."""

    def __init__(
        self,
        inline_max_bytes: int = DEFAULT_INLINE_MAX,
        timeout_s: float = 120.0,
        wire_dtype: str = "f32",
    ):
        self.inline_max = int(inline_max_bytes)
        self.timeout_s = timeout_s
        self.codec = WireCodec(wire_dtype)
        # Which rung each publish/fetch took — tests and the bench assert
        # the arena path actually engaged instead of trusting thresholds.
        # Wire bytes live in codec.stats and are merged into stats().
        self.stats = {
            "pub_inline": 0, "pub_arena": 0,
            "fetch_inline": 0, "fetch_local": 0, "fetch_span": 0,
        }

    def all_stats(self) -> Dict[str, int]:
        """Rung counters + the codec's raw/wire byte counters, one dict."""
        return {**self.stats, **self.codec.stats}

    # ----------------------------------------------------------- producer
    def publish(self, arr: np.ndarray):
        """Returns (desc, pin). `pin` (an ObjectRef or None) must be held by
        the caller until the consumer is done — the edge keeps it until its
        next send completes (see module docstring)."""
        from ...core import api, serialization, store

        arr, wire = self.codec.encode(np.ascontiguousarray(arr))
        arr = np.ascontiguousarray(arr)

        def inline_desc():
            d = {"inline": arr}
            if wire is not None:
                d["wire"] = wire
            return d

        # _global_runtime (not the non-initializing peek): worker processes
        # build their runtime lazily on first API use, and a publish from a
        # stage actor's first step IS that first use.
        rt = api._global_runtime()
        backend = rt.backend if rt is not None else None
        put_serialized = getattr(backend, "put_serialized", None)
        # Below the store's own inline threshold put_serialized would land
        # the frame on the INLINE plane — no shared-store name, no
        # span-servable copy, nothing for fetch() to read — so such tensors
        # must stay inline in the channel regardless of inline_max.
        inline_floor = max(self.inline_max, store.INLINE_THRESHOLD)
        if (
            put_serialized is None
            or arr.nbytes <= inline_floor
            or getattr(backend, "remote_client", False)
        ):
            self.stats["pub_inline"] += 1
            return inline_desc(), None
        payload, buffers = serialization.serialize(_OOBArray(arr))
        if len(buffers) != 1:  # something unexpected went out-of-band
            self.stats["pub_inline"] += 1
            return inline_desc(), None
        try:
            task_hex = rt.current_task_id.hex()
        except Exception:  # noqa: BLE001 — outside a task context
            self.stats["pub_inline"] += 1
            return inline_desc(), None
        # Frame layout ([u32 npayload][payload][u32 nbufs]{[u64 len][bytes]})
        # puts the single buffer's data at a fixed offset.
        off = 4 + len(payload) + 4 + 8
        ref, name, span_ok = put_serialized(payload, buffers, task_hex)
        if name is None:
            # Inline/remote plane after all (threshold drift): the stored
            # object has no locally-readable name — keep the tensor in the
            # channel payload so the consumer never needs the object.
            self.stats["pub_inline"] += 1
            return inline_desc(), None
        desc = {
            "name": name,
            "hex": ref.id.hex(),
            "span": (off, arr.nbytes) if span_ok else None,
            "dtype": arr.dtype.str,
            "shape": tuple(arr.shape),
        }
        if wire is not None:
            desc["wire"] = wire
        self.stats["pub_arena"] += 1
        return desc, ref

    # ----------------------------------------------------------- consumer
    def fetch(self, desc: Dict[str, Any]) -> np.ndarray:
        wire = desc.get("wire")
        if "inline" in desc:
            self.stats["fetch_inline"] += 1
            return self.codec.decode(desc["inline"], wire)
        from ...core import api
        from ...core import bulk as bulk_mod

        backend = api._global_runtime().backend
        # Rung 2: same-node shared-store read (the deps-map fast path's
        # equivalent — no controller round trip). Copy eagerly: the
        # unpickled array is a view over the producer's arena segment, and
        # nothing here may outlive the producer's pin.
        name = desc.get("name")
        local_store = getattr(backend, "local_store", None)
        if name and local_store is not None:
            try:
                out = np.array(local_store.read(name), copy=True)
            except Exception:  # noqa: BLE001 — not on this node / evicted
                pass
            else:
                # The copy is ours — release the read pin immediately, or
                # every per-microbatch activation object stays pinned in
                # this consumer process forever and the producer's drop
                # can never actually free arena space.
                try:
                    local_store.release(name)
                except Exception:  # noqa: BLE001 — release is best-effort
                    pass
                self.stats["fetch_local"] += 1
                return self.codec.decode(out, wire)
        # Rung 3: span pull over the bulk plane.
        span = desc.get("span")
        sources_of = getattr(backend, "object_sources", None)
        if span is not None and sources_of is not None:
            (src,) = sources_of([desc["hex"]])
            if src:
                off, length = span
                buf = bulk_mod.fetch_span_bytes(
                    src["bulk"], src["name"], off, length, self.timeout_s
                )
                self.stats["fetch_span"] += 1
                out = np.frombuffer(
                    buf, dtype=np.dtype(desc["dtype"])
                ).reshape(desc["shape"])
                return self.codec.decode(out, wire)
        raise RuntimeError(
            f"activation object {desc.get('hex', '?')} unreachable "
            "(source gone and no span-servable copy) — failing the step for "
            "the elastic layer"
        )


_RING_CLOSE = object()


class ChannelEdge:
    """One direction of one pipeline edge over a compiled-DAG channel.
    Construct with the writer end in the producer process and a reader-slot
    view in the consumer process (channels pickle-attach, exactly as
    compiled DAG arg plans ship them).

    `send_depth=1` keeps the classic synchronous write (send blocks until
    the reader acked the previous message). `send_depth>=2` moves the
    blocking write to a per-edge sender thread behind a ring of
    send_depth-1 queued messages + 1 in the write — the producer's compute
    overlaps the reader's ack. The pin contract extends with the ring: a
    published object's ref is dropped only after the NEXT write on this
    edge returns, so at most `send_depth` pins are live at once."""

    def __init__(
        self,
        channel,
        transport: Optional[ActTransport] = None,
        timeout_s: float = 120.0,
        send_depth: int = 1,
    ):
        self._ch = channel
        self._transport = transport or ActTransport()
        self.timeout_s = timeout_s
        self._depth = max(1, int(send_depth))
        self._pin = None  # previous send's arena object, held until acked
        self._ring: Optional["queue.Queue"] = None
        self._sender: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def send(self, arr) -> None:
        # A tensor crosses as a host array with its dtype tag (reference:
        # an ndarray, `ray_tpu/train/mpmd/transport.py:296-297`).
        arr, tag = to_host(arr)
        desc, pin = self._transport.publish(arr)
        if tag is not None:
            desc["tag"] = tag
        if self._depth == 1:
            self._ch.write(desc, timeout=self.timeout_s)
            # write() returned => the reader acked the PREVIOUS message,
            # whose import finished before its ack — the old pin is dead
            # weight now.
            self._pin = pin
            return
        if self._err is not None:
            raise RuntimeError(
                f"pipeline edge sender failed: {self._err!r}"
            ) from self._err
        if self._ring is None:
            self._ring = queue.Queue(maxsize=self._depth - 1)
            self._sender = threading.Thread(
                target=self._drain, daemon=True, name="mpmd-edge-sender"
            )
            self._sender.start()
        try:
            self._ring.put((desc, pin), timeout=self.timeout_s)
        except queue.Full:
            raise RuntimeError(
                f"pipeline edge send ring full for {self.timeout_s:.0f}s "
                "(reader wedged?) — failing the step for the elastic layer"
            ) from None

    def _drain(self) -> None:
        prev_pin = None
        while True:
            item = self._ring.get()
            if item is _RING_CLOSE:
                break
            desc, pin = item
            try:
                self._ch.write(desc, timeout=self.timeout_s)
            except BaseException as e:  # noqa: BLE001 — surfaced on next send
                self._err = e
                break
            # This write returning means the reader acked the previous
            # message — ITS pin is droppable; the just-written message's
            # pin must survive until the next write returns.
            prev_pin = pin  # noqa: F841 — holding the ref IS the point
        self._pin = None

    def recv(self) -> torch.Tensor:
        desc = self._ch.begin_read(timeout=self.timeout_s)
        try:
            # A CPU tensor (reference: the ndarray, `:341-346`).
            return from_host(self._transport.fetch(desc), desc.get("tag"))
        finally:
            self._ch.end_read()

    def close(self) -> None:
        if self._ring is not None:
            try:
                self._ring.put(_RING_CLOSE, timeout=5.0)
                self._sender.join(timeout=5.0)
            except Exception:  # noqa: BLE001 — best-effort drain
                pass
            self._ring = None
        try:
            self._ch.close_writer()
        except Exception:  # noqa: BLE001
            pass
        self._pin = None


class LocalEdge:
    """In-process edge (thread-to-thread) with channel-like depth-1
    backpressure — the parity tests run the REAL 1F1B interleaving
    without a cluster. Takes the same wire codec as the cluster path so
    the bf16 loss-curve gate exercises the actual cast/restore."""

    def __init__(
        self,
        depth: int = 1,
        timeout_s: float = 60.0,
        codec: Optional[WireCodec] = None,
    ):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.timeout_s = timeout_s
        self.codec = codec or WireCodec()

    def send(self, arr) -> None:
        # Tensors as in ChannelEdge (reference: ndarrays, `:379-384`).
        arr, tag = to_host(arr)
        self._q.put((*self.codec.encode(arr), tag), timeout=self.timeout_s)

    def recv(self) -> torch.Tensor:
        wire_arr, meta, tag = self._q.get(timeout=self.timeout_s)
        return from_host(self.codec.decode(wire_arr, meta), tag)

    def close(self) -> None:
        pass

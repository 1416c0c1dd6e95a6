"""Collective communication (API parity: `ray.util.collective.collective`).

The reference wires NCCL/Gloo communicators between actor processes
(`collective.py:120 init_collective_group`, ops at `:258-615`). TPU-first
redesign — THREE planes, matching SURVEY.md §5:

1. **In-jit (ICI)**: `ops.allreduce(x, axis="dp")` etc. lower to
   `jax.lax.p*` inside a jitted program over a Mesh — the "communicator" is
   the XLA compiler. This is where tensor traffic belongs on TPU.
2. **Host-level group collectives (DCN analog)**: the `ray.util.collective`
   actor-group API over the OBJECT STORE. The rendezvous actor exchanges
   only ObjectRefs and blocks members on round completion (no payload ever
   transits the actor, no busy-polling) — the reference's rendezvous-only
   pattern (`nccl_collective_group.py:132-155`, where the Info actor stores
   NCCL ids and data rides NCCL). Tensors move peer-to-peer through the
   store; large-world allreduce uses bandwidth-optimal reduce-scatter +
   allgather (per-member traffic ~3×size instead of world×size).
3. **Multi-host jax runtime bootstrap**: `init_jax_distributed` arranges
   `jax.distributed.initialize` across a WorkerGroup so a multi-host mesh
   can be built (the moral equivalent of `dist.init_process_group` in
   `train/torch/config.py:106`).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from . import ops
from .ops import (
    all_gather,
    all_to_all,
    allreduce_jit,
    barrier_jit,
    ppermute,
    psum,
    reduce_scatter,
)


class Backend:
    XLA = "xla"      # in-jit, over ICI — the TPU-native plane
    HOST = "host"    # object-store host collectives (Gloo role)
    # Aliases for reference API compatibility; both map to HOST on CPU paths.
    GLOO = "host"
    NCCL = "xla"


class GroupRendezvous:
    """Control-plane-only rendezvous for one collective group (detached
    actor, max_concurrency sized to the world so members can BLOCK in
    `contribute_and_await` — long-poll semantics, no client-side spinning).

    Carries ObjectRefs (and rank bookkeeping) exclusively; tensor bytes
    stay in the object store."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._lock = threading.Lock()
        self._members: Dict[int, bool] = {}
        self._ready = threading.Event()
        self._rounds: Dict[str, dict] = {}
        self._rank_map: Dict[str, int] = {}  # actor hex -> assigned rank

    # ------------------------------------------------------------ membership
    def join(self, rank: int) -> int:
        with self._lock:
            self._members[rank] = True
            n = len(self._members)
            if n >= self.world_size:
                self._ready.set()
        return n

    def await_ready(self, timeout: float = 60.0) -> bool:
        return self._ready.wait(timeout)

    def assign_ranks(self, mapping: Dict[str, int]) -> bool:
        with self._lock:
            self._rank_map.update(mapping)
        return True

    def assigned_rank(self, actor_hex: str) -> int:
        with self._lock:
            return self._rank_map.get(actor_hex, -1)

    def get_world_size(self) -> int:
        return self.world_size

    # ---------------------------------------------------------------- rounds
    def _round(self, key: str) -> dict:
        r = self._rounds.get(key)
        if r is None:
            r = self._rounds[key] = {
                "refs": {},
                "event": threading.Event(),
                "served": 0,
            }
        return r

    def contribute_and_await(self, key: str, rank: int, ref, timeout: float = 300.0):
        """Deposit this member's ref for round `key`, then BLOCK until every
        member has contributed. Returns {rank: ref} or None on timeout.

        A timeout ABORTS the round for everyone (symmetric failure): the
        waiters that timed out and any straggler arriving later all get
        None, and the round's refs are dropped — no member computes a
        result others missed, and nothing leaks in the actor."""
        with self._lock:
            r = self._round(key)
            if r.get("aborted"):
                # Tombstone: fail fast; reclaim once every member observed it.
                r["served"] += 1
                if r["served"] >= self.world_size:
                    self._rounds.pop(key, None)
                return None
            r["refs"][rank] = ref
            if len(r["refs"]) >= self.world_size:
                r["event"].set()
        if not r["event"].wait(timeout):
            with self._lock:
                r["aborted"] = True
                r["event"].set()  # release other waiters into the abort path
                r["refs"].clear()  # drop payload refs; KEEP the tombstone so
                # a straggler arriving later fails fast instead of opening a
                # fresh round and stalling its own full timeout.
                r["served"] += 1
                if r["served"] >= self.world_size:
                    self._rounds.pop(key, None)
            return None
        with self._lock:
            if r.get("aborted"):
                r["served"] += 1
                if r["served"] >= self.world_size:
                    self._rounds.pop(key, None)
                return None
            refs = dict(r["refs"])
            r["served"] += 1
            if r["served"] >= self.world_size:
                self._rounds.pop(key, None)  # all members served — free refs
        return refs

    # Tombstoned (aborted) rounds kept so stragglers fail fast instead of
    # re-opening the round and wedging; beyond this many table entries the
    # oldest tombstones are dropped — dead members never bump `served`, so
    # without a bound repeated aborts would leak entries in this detached
    # actor forever.
    _MAX_ROUNDS = 1024

    def abort_rounds(self) -> int:
        """Abort every in-progress round: waiters blocked in
        contribute_and_await are released into the None/abort path, and
        stragglers that have not contributed yet fail fast on the kept
        tombstones (dropping them would let a live straggler re-open the
        round and block out its full timeout alone). The gang supervisor
        calls this when a member dies so surviving members never sit out
        the full round timeout on a peer that will never arrive (the reference's
        requirement: "interrupt the collective, no wedged barrier"). COMPLETED rounds
        (event set with payload refs present — every contribution arrived,
        laggards just haven't collected yet) are left alone: aborting one
        would hand some members the real result and others None, desyncing
        a group with no member dead. Aborted p2p tombstones have no served
        counter and persist until the _MAX_ROUNDS eviction — after a
        non-destructive abort, destroy/re-create the group before reusing
        p2p keys. Returns the number of rounds aborted."""
        with self._lock:
            n = 0
            for r in self._rounds.values():
                if not r.get("aborted") and not (
                    r["event"].is_set() and r["refs"]
                ):
                    r["aborted"] = True
                    r["refs"].clear()
                    r["event"].set()
                    n += 1
            if len(self._rounds) > self._MAX_ROUNDS:
                excess = len(self._rounds) - self._MAX_ROUNDS
                for key in [
                    k for k, r in self._rounds.items() if r.get("aborted")
                ][:excess]:
                    self._rounds.pop(key)
            return n

    # ------------------------------------------------------------------ p2p
    def put_p2p(self, key: str, ref) -> bool:
        with self._lock:
            r = self._round(key)
            if r.get("aborted"):
                return False  # tombstoned incarnation: don't park a payload
            r["refs"][0] = ref
            r["event"].set()
        return True

    def await_p2p(self, key: str, timeout: float = 300.0):
        with self._lock:
            r = self._round(key)
        if not r["event"].wait(timeout):
            return None
        with self._lock:
            if r.get("aborted"):
                # abort_rounds cleared refs and set the event to release
                # this waiter; KEEP the tombstone (same rule as
                # contribute_and_await) so a straggler peer fails fast
                # instead of re-opening the round.
                return None
            self._rounds.pop(key, None)
            return r["refs"][0]


# Back-compat alias (round-1 name).
GroupInfo = GroupRendezvous

_LOCAL = threading.local()


def _info_actor(group_name: str, world_size: Optional[int] = None, create: bool = False):
    from ..core import api

    name = f"__collective_{group_name}"
    handle = api.get_actor_or_none(name)
    if handle is None and create:
        remote_cls = api.remote(GroupRendezvous)
        try:
            handle = remote_cls.options(
                name=name,
                lifetime="detached",
                # Members BLOCK inside contribute_and_await; every member
                # needs a thread, with headroom for bookkeeping calls.
                max_concurrency=(world_size or 16) * 2 + 4,
            ).remote(world_size)
        except ValueError:
            handle = api.get_actor(name)
    if handle is None:
        raise ValueError(f"Collective group '{group_name}' does not exist")
    return handle


def _ctx() -> dict:
    if not hasattr(_LOCAL, "groups"):
        _LOCAL.groups = {}
    return _LOCAL.groups


_VALID_BACKENDS = {"host", "gloo", "xla", "nccl"}


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = Backend.HOST,
    group_name: str = "default",
):
    """Called by each member (inside its actor/task) to join a group."""
    from ..core import api

    b = str(backend).lower()
    if b not in _VALID_BACKENDS:
        raise ValueError(f"Unknown collective backend {backend!r}; valid: {_VALID_BACKENDS}")
    if b in ("xla", "nccl"):
        import warnings

        warnings.warn(
            "Device-plane collectives on TPU compile into jit programs "
            "(ray_tpu_torch.collective.ops.* under shard_map/pjit); group "
            f"'{group_name}' will use the host plane for out-of-jit arrays.",
            stacklevel=2,
        )
    info = _info_actor(group_name, world_size, create=True)
    api.get(info.join.remote(rank))
    if not api.get(info.await_ready.remote(60.0)):
        raise TimeoutError(f"Group {group_name} rendezvous timed out")
    _ctx()[group_name] = {"info": info, "rank": rank, "world_size": world_size, "seq": 0}


def create_collective_group(
    actors: List,
    world_size: int,
    ranks: List[int],
    backend: str = Backend.HOST,
    group_name: str = "default",
):
    """Declarative variant (reference `collective.py:151`): the DRIVER
    assigns ranks to actor handles up front; member processes auto-join on
    their first collective call (rank resolved from their actor id)."""
    from ..core import api

    if len(actors) != len(ranks):
        raise ValueError("actors and ranks must have equal length")
    info = _info_actor(group_name, world_size, create=True)
    mapping = {a._id.hex(): r for a, r in zip(actors, ranks)}
    api.get(info.assign_ranks.remote(mapping))
    return True


def abort_collective_group(group_name: str = "default", timeout: float = 5.0) -> bool:
    """Interrupt every in-flight round of a group WITHOUT destroying it:
    members blocked in a collective get a prompt TimeoutError instead of
    waiting out the full round timeout on a dead peer. Driver-callable
    (no membership required). Returns False when the group doesn't exist
    or the abort didn't land within `timeout`."""
    from ..core import api

    try:
        handle = api.get_actor_or_none(f"__collective_{group_name}")
        if handle is None:
            return False
        api.get(handle.abort_rounds.remote(), timeout=timeout)
        return True
    except Exception:  # noqa: BLE001 — rendezvous actor itself may be dying
        return False


def destroy_collective_group(group_name: str = "default"):
    from ..core import api

    try:
        handle = api.get_actor_or_none(f"__collective_{group_name}")
        if handle is not None:
            api.kill(handle)
    finally:
        _ctx().pop(group_name, None)


def _group(group_name: str) -> dict:
    """Resolve this process's membership — explicit init or driver-assigned
    rank (create_collective_group) discovered from the runtime actor id."""
    g = _ctx().get(group_name)
    if g is not None:
        return g
    from ..core import api
    from ..core.runtime_context import get_runtime_context

    actor_hex = get_runtime_context().get_actor_id()
    if actor_hex:
        info = _info_actor(group_name)
        rank = api.get(info.assigned_rank.remote(actor_hex))
        if rank >= 0:
            api.get(info.join.remote(rank))
            world = api.get(info.get_world_size.remote())
            g = {"info": info, "rank": rank, "world_size": world, "seq": 0}
            _ctx()[group_name] = g
            return g
    raise RuntimeError(
        f"init_collective_group('{group_name}') must be called in this process "
        "first (or the driver must assign this actor a rank via "
        "create_collective_group)"
    )


def get_rank(group_name: str = "default") -> int:
    g = _ctx().get(group_name)
    return g["rank"] if g else -1


def get_collective_group_size(group_name: str = "default") -> int:
    g = _ctx().get(group_name)
    return g["world_size"] if g else -1


def _exchange(g: dict, tag: str, value) -> Dict[int, "object"]:
    """One rendezvous round: put `value` in the store, swap refs via the
    group actor (blocking — no polling), return {rank: ref}."""
    from ..core import api

    g["seq"] += 1
    key = f"{tag}:{g['seq']}"
    ref = api.put(value)
    # Wrapped in a list: TOP-LEVEL ObjectRef args are resolved to values
    # before actor execution (reference semantics); nested refs travel as
    # refs — which is the whole point of the rendezvous-only design.
    wrapped = api.get(g["info"].contribute_and_await.remote(key, g["rank"], [ref]))
    if wrapped is None:
        raise TimeoutError(
            f"collective round {key} timed out/aborted — the group is "
            f"desynchronized; destroy_collective_group() and re-init"
        )
    return {r: w[0] for r, w in wrapped.items()}


def _reduce(vals: List[np.ndarray], op: str) -> np.ndarray:
    if op == "sum":
        out = np.array(vals[0], copy=True)
        for v in vals[1:]:
            out = out + v
        return out
    if op == "max":
        return np.maximum.reduce(vals)
    if op == "min":
        return np.minimum.reduce(vals)
    if op == "prod":
        return np.multiply.reduce(vals)
    raise ValueError(f"unknown op {op}")


_RS_AG_MIN_WORLD = 5
_RS_AG_MIN_SIZE = 4096  # elements; below this the chunking overhead dominates


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    """Host-plane allreduce (reference `collective.py:258`). Tensors ride
    the object store peer-to-peer; for world ≥ 5 and non-trivial sizes the
    bandwidth-optimal reduce-scatter + allgather runs (per-member traffic
    ~3×size; the naive gather is world×size). For on-device tensors inside
    jit use `ops.psum`/`allreduce_jit`."""
    from ..core import api

    g = _group(group_name)
    x = np.asarray(tensor)
    if g["world_size"] >= _RS_AG_MIN_WORLD and x.size >= _RS_AG_MIN_SIZE:
        return _allreduce_rs_ag(g, x, op)
    refs = _exchange(g, f"ar-{op}", x)
    vals = [np.asarray(api.get(refs[r])) for r in sorted(refs)]
    return _reduce(vals, op)


def _allreduce_rs_ag(g: dict, x: np.ndarray, op: str) -> np.ndarray:
    """Reduce-scatter + allgather over flat chunks (ring-equivalent traffic)."""
    from ..core import api

    world, rank = g["world_size"], g["rank"]
    flat = x.reshape(-1)
    pad = (-len(flat)) % world
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, flat.dtype)])
    chunks = flat.reshape(world, -1)
    # Round 1: publish per-chunk objects; fetch every member's chunk `rank`.
    my_chunk_refs = [api.put(np.array(chunks[c], copy=True)) for c in range(world)]
    lists = _exchange(g, f"rs-{op}", my_chunk_refs)
    # Each exchanged value is itself a (tiny) list-of-refs object; fetch the
    # manifest, then only chunk `rank` of every member's payload.
    manifests = {m: api.get(lists[m]) for m in lists}
    mine = [np.asarray(api.get(manifests[m][rank])) for m in sorted(manifests)]
    reduced = _reduce(mine, op)
    # Round 2: publish the reduced chunk; gather all reduced chunks.
    out_refs = _exchange(g, f"ag-{op}", reduced)
    parts = [np.asarray(api.get(out_refs[m])) for m in sorted(out_refs)]
    full = np.concatenate(parts)
    if pad:
        full = full[: len(full) - pad]
    return full.reshape(x.shape)


def allgather(tensor, group_name: str = "default"):
    from ..core import api

    g = _group(group_name)
    refs = _exchange(g, "gather", np.asarray(tensor))
    return [np.array(api.get(refs[r]), copy=True) for r in sorted(refs)]


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    """Root publishes ONE object; every member reads it from the store
    (zero-copy locally, one transfer per remote node) — the rendezvous actor
    sees only the ref."""
    from ..core import api

    g = _group(group_name)
    x = np.asarray(tensor) if g["rank"] == src_rank else None
    refs = _exchange(g, "bcast", x)
    return np.array(api.get(refs[src_rank]), copy=True)


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    """Each member gets chunk `rank` of the axis-0-split reduction. Large
    tensors use the chunked manifest (members fetch ONLY their chunk from
    each peer — per-member traffic ~2×size instead of world×size)."""
    from ..core import api

    g = _group(group_name)
    world, rank = g["world_size"], g["rank"]
    x = np.asarray(tensor)
    if world >= _RS_AG_MIN_WORLD and x.size >= _RS_AG_MIN_SIZE:
        chunks = np.array_split(x, world, axis=0)
        my_chunk_refs = [api.put(np.array(c, copy=True)) for c in chunks]
        lists = _exchange(g, f"rsc-{op}", my_chunk_refs)
        manifests = {m: api.get(lists[m]) for m in lists}
        mine = [np.asarray(api.get(manifests[m][rank])) for m in sorted(manifests)]
        return _reduce(mine, op)
    refs = _exchange(g, f"rsc-{op}", x)
    vals = [np.asarray(api.get(refs[r])) for r in sorted(refs)]
    total = _reduce(vals, op)
    return np.array_split(total, world, axis=0)[rank]


def reduce_scatter_flat(vec, group_name: str = "default", op: str = "sum"):
    """ZeRO gradient exchange, host plane: elementwise-reduce a FLAT 1-D
    vector across the group and return THIS rank's np.array_split chunk of
    the result (the exact chunking `ops.zero_shard_bounds` describes, which
    is also the elastic checkpoint's axis-0 reshard rule — so optimizer
    shards, wire chunks, and checkpoint shards all agree for any world
    size). Per-member traffic ~2x size via the per-chunk manifest (each
    member fetches only its chunk from every peer); world_size 1 degrades
    to a local reduce. Reduction order is sorted-rank, so every member
    computes bit-identical results."""
    from ..core import api

    g = _group(group_name)
    world, rank = g["world_size"], g["rank"]
    x = np.asarray(vec).reshape(-1)
    if world == 1:
        return np.array(x, copy=True)
    chunks = np.array_split(x, world)
    my_chunk_refs = [api.put(np.array(c, copy=True)) for c in chunks]
    lists = _exchange(g, f"rsf-{op}", my_chunk_refs)
    manifests = {m: api.get(lists[m]) for m in lists}
    mine = [np.asarray(api.get(manifests[m][rank])) for m in sorted(manifests)]
    return _reduce(mine, op)


def all_gather_flat(chunk, group_name: str = "default"):
    """Inverse half of the ZeRO update: concatenate every rank's flat chunk
    in rank order (np.array_split layout) back into the full vector."""
    from ..core import api

    g = _group(group_name)
    if g["world_size"] == 1:
        return np.array(np.asarray(chunk).reshape(-1), copy=True)
    refs = _exchange(g, "agf", np.asarray(chunk).reshape(-1))
    return np.concatenate(
        [np.asarray(api.get(refs[r])).reshape(-1) for r in sorted(refs)]
    )


def barrier(group_name: str = "default"):
    _exchange(_group(group_name), "barrier", None)


def _p2p_key(g: dict, src: int, dst: int) -> str:
    # Both endpoints count their mutual transfers, so the pair's keys line up
    # regardless of what other collectives either side ran in between.
    p2p = g.setdefault("p2p", {})
    p2p[(src, dst)] = p2p.get((src, dst), 0) + 1
    return f"p2p:{src}->{dst}:{p2p[(src, dst)]}"


def send(tensor, dst_rank: int, group_name: str = "default"):
    """Point-to-point: the ref rides the rendezvous actor, the payload rides
    the store."""
    from ..core import api

    g = _group(group_name)
    key = _p2p_key(g, g["rank"], dst_rank)
    ref = api.put(np.asarray(tensor))
    ok = api.get(g["info"].put_p2p.remote(key, [ref]))  # nested: stays a ref
    if not ok:
        # Tombstoned round: the group was aborted while the receiver
        # waited — the payload was refused, and pretending delivery
        # succeeded would desync sender and receiver.
        raise TimeoutError(
            f"send to rank {dst_rank} aborted (group {group_name!r} aborted)"
        )


def recv(src_rank: int, group_name: str = "default"):
    from ..core import api

    g = _group(group_name)
    key = _p2p_key(g, src_rank, g["rank"])
    wrapped = api.get(g["info"].await_p2p.remote(key, 300.0))
    if wrapped is None:
        raise TimeoutError("recv timed out")
    return np.array(api.get(wrapped[0]), copy=True)


__all__ = [
    "Backend",
    "init_collective_group",
    "create_collective_group",
    "abort_collective_group",
    "destroy_collective_group",
    "get_rank",
    "get_collective_group_size",
    "allreduce",
    "allgather",
    "broadcast",
    "reducescatter",
    "reduce_scatter_flat",
    "all_gather_flat",
    "barrier",
    "send",
    "recv",
    # in-jit plane
    "ops",
    "psum",
    "all_gather",
    "reduce_scatter",
    "all_to_all",
    "ppermute",
    "allreduce_jit",
    "barrier_jit",
]

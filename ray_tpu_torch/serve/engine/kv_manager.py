"""Paged KV-cache block manager with automatic prefix caching
(reference-era analog: vLLM's BlockManager + its hash-based prefix cache,
`vllm/core/block_manager.py` — the PagedAttention half of iteration-level
scheduling).

The physical KV cache is a fixed pool of `num_blocks` blocks of
`block_size` token slots each (the engine owns the actual [L, NB, H, BS, Dh]
arrays; this class owns only the *map*). Each live sequence holds an ordered
block table — logical token position `p` lives in physical block
`table[p // block_size]` at offset `p % block_size`.

Prefix caching: every FULL block whose KV has been computed is registered
under a content hash CHAINED over token ids (block i's key commits to every
token in blocks 0..i, so two sequences share a block only when their entire
prefixes match). Blocks are refcounted; `allocate_cached` walks a new
prompt's chain through the hash index and reuses every leading hit — the
prefill skips straight to the first cold block. Freed blocks whose content
is registered are RETAINED on an LRU "cached" list instead of being blanked:
they serve future hits, yet remain reclaimable — the free list exhausting
falls back to evicting the coldest cached block. Admission math
(`can_allocate` / `free_blocks`) therefore counts blank + cached blocks;
`KVStats.utilization` counts only live (referenced) blocks.

Tiered cache (the cluster-wide half of the reference's design): with a `host_tier`
(`kv_tier.HostKVTier`) attached, an HBM eviction SAVES the block's bytes to
host RAM instead of killing the content — the manager queues (hash, block)
save orders the engine drains (`drain_saves`) before the block is
overwritten, and `allocate_cached` consults the tier on an index miss:
a tier hit acquires a fresh block, re-registers the hash, and queues a
(hash, block, bytes, remote) LOAD (`drain_loads`) the engine applies to
the HBM arrays before its next kernel launch. `adopt_block` is the same mechanism
driven by a REMOTE import (`engine.import_blocks`): blocks computed by a
prefill-pool replica land here as cached entries. The manager stays a pure
map — every byte move is drained by the engine at a step boundary, ordered
saves -> COW -> loads -> kernels so evicted bytes are read before anything
overwrites them. Hot-hash digest entries survive HBM eviction while the
bytes remain host-resident (the fleet router keeps steering matching
prompts here, where the import is a host-RAM copy, not a recompute).

Invariants (enforced by `check_invariants`):
  * every block is blank (free list) XOR cached (ref 0, content retained)
    XOR live (ref >= 1) — never two at once, none lost;
  * a block's refcount equals its number of table references;
  * a refcounted-shared block is NEVER written in place: extending a
    sequence into a shared block forks it copy-on-write — the manager
    rewrites the table and queues a (src, dst) physical copy for the engine
    (`drain_cow`); only full, immutable blocks are ever hash-shared.

Admission control rides on `can_allocate`: the scheduler refuses (queues,
never crashes) a prefill whose prompt + first token doesn't fit
blank + reclaimable blocks, and preempts the youngest running sequence when
decode growth hits the budget mid-flight.

Block 0 is RESERVED as the null/scratch block: the engine pads decode
batches to bucket shapes by pointing dummy lanes' block tables at block 0,
so their writes land somewhere harmless. It is never handed out.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple


class KVCacheExhausted(RuntimeError):
    """Raised by allocate/grow when blank + evictable blocks cannot cover
    the request.

    The scheduler treats this as back-pressure (requeue/preempt), never as a
    crash — it reaches user code only on programming errors (e.g. a prompt
    longer than the whole pool, which `fits_ever` screens at submit)."""


def _chain_hash(prev: bytes, tokens: Sequence[int]) -> bytes:
    """Content key of one full block given its predecessor's key — collision
    resistance matters (a collision would silently serve another prompt's
    KV), so this is a real hash, not Python's."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(b",".join(str(int(t)).encode() for t in tokens))
    return h.digest()


# Wire width of one hot-prefix digest entry (`prefix_digest`): the fleet
# router only needs to DISCRIMINATE prefixes (a truncation collision routes
# to a replica that turns out to miss — no correctness impact), so digests
# ship 8 of the 16 hash bytes. `serve/fleet/routing.py` derives its routing
# keys with the same truncation.
DIGEST_HASH_BYTES = 8

# Hot-prefix hashes retained for digest export (recency-ordered).
_HOT_CAP = 512


@dataclasses.dataclass(frozen=True)
class KVStats:
    num_blocks: int          # allocatable blocks (excludes the null block)
    free_blocks: int         # allocatable NOW: blank + reclaimable cached
    used_blocks: int         # referenced by >= 1 live sequence
    cached_blocks: int       # ref == 0 but content retained (subset of free)
    num_seqs: int
    utilization: float       # LIVE fraction of the pool, 0..1
    hits: int = 0            # full blocks reused from the prefix cache
    misses: int = 0          # cacheable full blocks that had to be computed
    evictions: int = 0       # cached blocks reclaimed for new allocations
    cow_copies: int = 0      # copy-on-write forks of shared blocks
    host_hits: int = 0       # hits served from the host-RAM tier (subset)
    host_blocks: int = 0     # blocks resident in the host tier
    host_bytes: int = 0      # bytes resident in the host tier


class KVBlockManager:
    """Refcounting free-list allocator mapping sequence ids to ordered block
    tables, with a chained-hash prefix cache over full blocks."""

    NULL_BLOCK = 0

    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        enable_prefix_caching: bool = True,
        host_tier=None,
    ):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.caching = enable_prefix_caching
        # Host-RAM tier below HBM (kv_tier.HostKVTier, None = off). Accessed
        # only under the engine lock, like every other mutation here.
        self._tier = host_tier if enable_prefix_caching else None
        if self._tier is not None:
            self._tier.on_evict = self._on_tier_evict
        # Block 0 reserved; LIFO free list so recently-freed (cache-warm)
        # blocks are reused first.
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        # ref == 0 blocks whose content is still registered: insertion order
        # is recency (oldest first = LRU eviction order).
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self._ref: Dict[int, int] = {}            # live blocks only
        self._tables: Dict[str, List[int]] = {}
        self._lens: Dict[str, int] = {}           # tokens stored per sequence
        self._hash_of: Dict[int, bytes] = {}      # registered block -> key
        self._index: Dict[bytes, int] = {}        # key -> canonical block
        self._chain: Dict[str, List[bytes]] = {}  # per-seq registered keys
        # Recency-ordered registered/hit hashes (hottest LAST): the bounded
        # hot-prefix digest the fleet router steers by. Advisory only —
        # entries die with their index entry on eviction.
        self._hot: "OrderedDict[bytes, None]" = OrderedDict()
        # (src, dst) physical copies the ENGINE must apply before the next
        # kernel launch — the manager owns only the map.
        self._pending_copies: List[Tuple[int, int]] = []
        # block -> (hash, bytes, remote): tier/import content the engine
        # must land in the HBM arrays before its next kernel launch
        # (drain_loads); `remote` marks content adopted from ANOTHER
        # replica's export (adopt_block) vs a local host-tier re-admission
        # — the engine's import counter tracks only the former. An eviction
        # of a pending-load block just drops the entry — the bytes never
        # reached HBM, so there is nothing to save and the index entry dies
        # with it.
        self._pending_loads: Dict[int, Tuple[bytes, object, bool]] = {}
        # (hash, block): evicted registered blocks whose bytes the engine
        # must copy OUT to the host tier before anything overwrites them
        # (drain_saves runs FIRST in the engine's step-top drain order).
        self._pending_saves: List[Tuple[bytes, int]] = []
        # Landed watermark per sequence: tokens whose KV is KNOWN computed
        # (prefix-cache hits at admission + every register_computed
        # notification). Lags the true cursor by at most the notification
        # granularity; `fork` trims the child to it so a speculatively
        # over-allocated parent can never leak an un-COWed shared tail.
        self._landed: Dict[str, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.cow_copies = 0
        self.host_hits = 0

    # ------------------------------------------------------------- queries
    @property
    def free_blocks(self) -> int:
        """Blocks allocatable right now (blank + evictable cached)."""
        return len(self._free) + self._evictable()

    def _evictable(self) -> int:
        # Cached blocks that are the source of a still-pending COW copy must
        # survive until the engine applies it; they drop out of the
        # reclaimable count until drain_cow().
        if not self._pending_copies:
            return len(self._cached)
        protected = {s for s, _ in self._pending_copies}
        return sum(1 for b in self._cached if b not in protected)

    def blocks_for(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)  # ceil div

    def can_allocate(self, num_tokens: int) -> bool:
        return self.blocks_for(num_tokens) <= self.free_blocks

    def fits_ever(self, num_tokens: int) -> bool:
        """Could this many tokens fit an EMPTY pool? (submit-time sanity)"""
        return self.blocks_for(num_tokens) <= self.num_blocks - 1

    def block_table(self, seq_id: str) -> List[int]:
        return list(self._tables[seq_id])

    def seq_len(self, seq_id: str) -> int:
        return self._lens[seq_id]

    def num_registered(self, seq_id: str) -> int:
        """Full blocks of `seq_id` already in the prefix index — the
        scheduler's cheap check for whether registration has blocks to
        catch up on (multi-token speculative appends can jump PAST a block
        boundary, so an exact `landed % block_size == 0` test misses)."""
        return len(self._chain.get(seq_id, ()))

    def _touch_hot(self, h: bytes) -> None:
        self._hot[h] = None
        self._hot.move_to_end(h)
        while len(self._hot) > _HOT_CAP:
            self._hot.popitem(last=False)

    def prefix_digest(self, max_entries: int = 64) -> List[str]:
        """Bounded digest of the HOTTEST prefix hashes (truncated hex,
        hottest first) — piggybacked on controller telemetry so fleet
        routers can steer prompts toward the replica already holding their
        prefix. Empty when prefix caching is off."""
        if not self.caching or max_entries < 1:
            return []
        out = []
        for h in reversed(self._hot):
            out.append(h[:DIGEST_HASH_BYTES].hex())
            if len(out) >= max_entries:
                break
        return out

    def stats(self) -> KVStats:
        total = self.num_blocks - 1
        live = len(self._ref)
        return KVStats(
            num_blocks=total,
            free_blocks=len(self._free) + self._evictable(),
            used_blocks=live,
            cached_blocks=len(self._cached),
            num_seqs=len(self._tables),
            utilization=live / total if total else 0.0,
            hits=self.hits,
            misses=self.misses,
            evictions=self.evictions,
            cow_copies=self.cow_copies,
            host_hits=self.host_hits,
            host_blocks=self._tier.blocks if self._tier is not None else 0,
            host_bytes=self._tier.bytes_used if self._tier is not None else 0,
        )

    # ------------------------------------------------------- block plumbing
    def _acquire(self) -> int:
        """One blank block: the free list first, then LRU-evict the coldest
        cached block. Without a host tier the evictee's index entry dies
        with it; with one, its bytes are queued to SAVE into host RAM (the
        engine drains before anything overwrites the block) and its hot-hash
        digest entry survives — the fleet router keeps steering matching
        prompts here, where `allocate_cached`'s tier consult makes the
        re-admission a host-RAM copy instead of a recompute."""
        if self._free:
            return self._free.pop()
        protected = {s for s, _ in self._pending_copies}
        for b in self._cached:
            if b not in protected:
                del self._cached[b]
                h = self._hash_of.pop(b)
                del self._index[h]
                self.evictions += 1
                pending = self._pending_loads.pop(b, None)
                if self._tier is not None and pending is None:
                    # Bytes are in HBM and about to be reused: save them to
                    # the host tier (skip when the tier already holds them).
                    if not self._tier.contains(h):
                        self._pending_saves.append((h, b))
                    # Host-resident content stays advertised (hot entry
                    # kept); the tier's own eviction drops it for real.
                elif pending is not None and self._tier is not None \
                        and self._tier.contains(h):
                    pass  # bytes still live in the tier — stay advertised
                else:
                    self._hot.pop(h, None)
                return b
        raise KVCacheExhausted("KV pool exhausted (no blank or evictable blocks)")

    def _on_tier_evict(self, h: bytes) -> None:
        """Host-tier budget eviction: the content is now gone everywhere
        below the fleet — stop advertising it (unless it is independently
        registered in HBM)."""
        if h not in self._index:
            self._hot.pop(h, None)

    def _incref(self, b: int) -> None:
        if b in self._ref:
            self._ref[b] += 1
        else:  # reviving a cached (ref 0) block
            del self._cached[b]
            self._ref[b] = 1

    def _release_one(self, b: int) -> None:
        r = self._ref[b] - 1
        if r > 0:
            self._ref[b] = r
            return
        del self._ref[b]
        if b in self._hash_of:
            # Content stays findable: most-recently-freed lands at the LRU
            # tail, so eviction takes the coldest prefix first.
            self._cached[b] = None
        else:
            assert b != self.NULL_BLOCK and b not in self._free, (
                f"block {b} double-freed"
            )
            self._free.append(b)

    # --------------------------------------------------------- allocation
    def allocate(self, seq_id: str, num_tokens: int) -> List[int]:
        """Claim blocks for a new sequence of `num_tokens` tokens, with no
        cache lookup (token ids unknown). Raises KVCacheExhausted when
        blank + evictable blocks can't cover it (the caller keeps the
        request queued) and ValueError on reuse of a live seq_id."""
        table, _ = self.allocate_cached(seq_id, None, num_tokens)
        return table

    def allocate_cached(
        self,
        seq_id: str,
        token_ids: Optional[Sequence[int]],
        num_tokens: int,
    ) -> Tuple[List[int], int]:
        """Claim blocks for a new sequence, reusing every leading full block
        whose chained content hash is already registered.

        `token_ids` is the prompt (length <= num_tokens; the surplus covers
        generated tokens). Returns (block_table, cached_tokens):
        `cached_tokens` prompt positions already hold valid KV — the prefill
        starts at that offset. At least one prompt token is always left cold
        so the engine has a real position to read next-token logits from.
        """
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already has an allocation")
        if num_tokens < 1:
            raise ValueError("allocate needs >= 1 token")
        if token_ids is not None and len(token_ids) > num_tokens:
            raise ValueError("token_ids longer than the allocation")
        need_total = self.blocks_for(num_tokens)
        # Chain walk: per leading full block, an HBM index hit ("idx", b),
        # a host-tier hit ("tier", h, bytes) — acquired below and loaded by
        # the engine before its next kernel — or a miss (walk ends).
        walk: List[Tuple] = []
        chain: List[bytes] = []
        if self.caching and token_ids is not None and len(token_ids) > 1:
            # Cap: never serve the WHOLE prompt from cache — the last
            # position must be recomputed to produce first-token logits.
            cacheable = (len(token_ids) - 1) // self.block_size
            prev = b""
            for i in range(cacheable):
                h = _chain_hash(
                    prev,
                    token_ids[i * self.block_size:(i + 1) * self.block_size],
                )
                b = self._index.get(h)
                if b is not None:
                    walk.append(("idx", b))
                elif self._tier is not None:
                    blob = self._tier.get(h)  # touches the tier's LRU
                    if blob is None:
                        break
                    walk.append(("tier", h, blob))
                else:
                    break
                chain.append(h)
                self._touch_hot(h)
                prev = h
            self.hits += len(walk)
            self.host_hits += sum(1 for w in walk if w[0] == "tier")
            self.misses += cacheable - len(walk)
        idx_hits = [w[1] for w in walk if w[0] == "idx"]
        # Hits currently resting on the cached list are about to be revived —
        # they can't double as eviction fodder for our own fresh blocks
        # (COW-protected ones were never counted evictable to begin with).
        # Tier hits and cold blocks both need a real acquisition.
        protected = {s for s, _ in self._pending_copies}
        reviving = sum(
            1 for b in idx_hits
            if b not in self._ref and b not in protected
        )
        need_new = need_total - len(idx_hits)
        if need_new > len(self._free) + self._evictable() - reviving:
            raise KVCacheExhausted(
                f"{need_new} blocks needed, "
                f"{len(self._free) + self._evictable() - reviving} available"
            )
        # Revive/share EVERY index hit first: a tier-hit acquisition below
        # may evict from the cached list, and a hit resting there must not
        # be its victim.
        for w in walk:
            if w[0] == "idx":
                self._incref(w[1])
        table: List[int] = []
        for w in walk:
            if w[0] == "idx":
                table.append(w[1])
            else:
                _, h, blob = w
                nb = self._acquire()
                self._ref[nb] = 1
                self._index[h] = nb
                self._hash_of[nb] = h
                self._pending_loads[nb] = (h, blob, False)
                table.append(nb)
        for _ in range(need_total - len(walk)):
            nb = self._acquire()
            self._ref[nb] = 1
            table.append(nb)
        self._tables[seq_id] = table
        self._lens[seq_id] = num_tokens
        self._chain[seq_id] = chain
        self._landed[seq_id] = len(walk) * self.block_size
        return list(table), len(walk) * self.block_size

    def fork(self, parent_id: str, child_id: str) -> List[int]:
        """Share `parent_id`'s table up to its LANDED watermark with a new
        sequence (beam / n-best style). Shared blocks incref; whichever
        sequence later extends into a shared partial block triggers
        copy-on-write there.

        The child is TRIMMED to the parent's landed watermark (tokens whose
        KV is known computed: admission cache hits + every
        `register_computed` notification): a parent carrying a SPECULATIVE
        over-allocation (`_lens` grown past the landed watermark to fund
        drafts the verify step may reject) must not hand the child slots
        whose content is undefined — grow()'s COW check keys off `_lens`,
        so an un-trimmed child writing below the over-allocated tail would
        miss its copy (a caveat the reference once documented, now handled).
        The watermark lags true compute by at most the notification
        granularity; the trimmed tail is re-derivable (the child recomputes
        or re-hits it). A parent allocated via plain `allocate()` (token
        ids unknown) that was never advanced by `grow(..., num_computed=)`
        or `register_computed` has watermark 0 and shares NOTHING — the
        manager cannot tell its content from speculative garbage."""
        if child_id in self._tables:
            raise ValueError(f"sequence {child_id!r} already has an allocation")
        table = self._tables[parent_id]  # KeyError = unknown parent
        landed = self._landed.get(parent_id, 0)
        keep = min(self.blocks_for(landed), len(table))
        shared = table[:keep]
        for b in shared:
            self._incref(b)
        self._tables[child_id] = list(shared)
        self._lens[child_id] = min(landed, self._lens[parent_id])
        chain = self._chain.get(parent_id, ())
        self._chain[child_id] = list(chain[:keep])
        self._landed[child_id] = self._lens[child_id]
        return list(shared)

    def grow(
        self,
        seq_id: str,
        new_len: int,
        token_ids: Optional[Sequence[int]] = None,
        num_computed: Optional[int] = None,
    ) -> List[int]:
        """Extend `seq_id`'s table to cover `new_len` tokens (decode append).

        If the next write position falls inside a SHARED block (fork), that
        block is forked copy-on-write first: the table is rewritten and a
        (src, dst) physical copy is queued for `drain_cow`. With `token_ids`
        (the sequence's full token list) and `num_computed` (tokens whose KV
        is actually written), newly-completed full blocks are registered in
        the prefix index. Returns the (possibly extended) block table;
        KVCacheExhausted when the pool is dry — the scheduler preempts.

        `new_len` below the current coverage is a no-op on the table
        (registration still runs): a speculative grow funds draft slots the
        verify step may reject, so the NEXT step legitimately asks for less
        than the table already covers."""
        table = self._tables[seq_id]
        cur = self._lens[seq_id]
        if new_len < cur:
            new_len = cur
        need = self.blocks_for(new_len) - len(table)
        wi = cur // self.block_size      # block the next write lands in
        need_cow = int(
            wi < len(table) and self._ref[table[wi]] > 1
        )
        if need + need_cow > len(self._free) + self._evictable():
            raise KVCacheExhausted(
                f"{need + need_cow} blocks needed, "
                f"{len(self._free) + self._evictable()} free"
            )
        if need_cow:
            src = table[wi]
            dst = self._acquire()
            self._ref[dst] = 1
            self._pending_copies.append((src, dst))
            table[wi] = dst
            self._release_one(src)   # still held by the other owner(s)
            self.cow_copies += 1
        for _ in range(need):
            nb = self._acquire()
            self._ref[nb] = 1
            table.append(nb)
        self._lens[seq_id] = new_len
        if token_ids is not None and num_computed is not None:
            self.register_computed(seq_id, token_ids, num_computed)
        return list(table)

    def register_computed(
        self,
        seq_id: str,
        token_ids: Sequence[int],
        num_computed: int,
    ) -> None:
        """Register every newly-FULL block whose KV is written (positions
        < `num_computed`) in the prefix index. Must only be called after the
        engine has actually landed those positions' K/V — registering ahead
        of the compute would serve garbage to the next prompt.

        If a block's key already has a canonical twin (same content computed
        by an earlier sequence), this table adopts the twin and releases its
        own copy — identical prefixes converge to identical tables."""
        landed = min(num_computed, len(token_ids))
        if landed > self._landed.get(seq_id, 0):
            self._landed[seq_id] = landed
        if not self.caching:
            return
        chain = self._chain.setdefault(seq_id, [])
        table = self._tables[seq_id]
        full = min(num_computed, len(token_ids)) // self.block_size
        while len(chain) < full:
            i = len(chain)
            prev = chain[-1] if chain else b""
            h = _chain_hash(
                prev, token_ids[i * self.block_size:(i + 1) * self.block_size]
            )
            b = table[i]
            canon = self._index.get(h)
            if canon is not None and canon != b:
                self._incref(canon)
                table[i] = canon
                self._release_one(b)
            elif canon is None:
                self._index[h] = b
                self._hash_of[b] = h
            self._touch_hot(h)
            chain.append(h)

    # ----------------------------------------------------- tier / transfer
    def holds(self, h: bytes) -> Optional[int]:
        """Physical block registered under content hash `h`, or None."""
        return self._index.get(h)

    def adopt_block(self, h: bytes, blob) -> Optional[int]:
        """Adopt externally-computed KV content (a remote replica's export,
        fetched by `engine.import_blocks`): acquire a block, register it
        under `h`, park it on the cached LRU (MRU end), and queue the bytes
        as a pending LOAD the engine lands before its next kernel. Returns
        the block, or None when the pool has nothing to give (the import
        degrades to recompute — never an error)."""
        if not self.caching or h in self._index:
            return None
        try:
            b = self._acquire()
        except KVCacheExhausted:
            return None
        self._index[h] = b
        self._hash_of[b] = h
        self._cached[b] = None  # ref 0, content retained, MRU end
        self._pending_loads[b] = (h, blob, True)
        self._touch_hot(h)
        return b

    def export_sources(self, digests: Sequence[bytes]) -> List[Optional[Tuple]]:
        """Where each digest's bytes live right now, aligned with `digests`:
        ("hbm", block) for registered blocks whose content is landed,
        ("blob", bytes) for content still in flight (pending load) or only
        host-tier-resident, None when nowhere. The engine reads HBM sources
        at a step boundary, where the arrays are stable."""
        out: List[Optional[Tuple]] = []
        for h in digests:
            b = self._index.get(h)
            if b is not None:
                pending = self._pending_loads.get(b)
                if pending is not None and pending[0] == h:
                    out.append(("blob", pending[1]))
                else:
                    out.append(("hbm", b))
            elif self._tier is not None:
                blob = self._tier.peek(h)
                out.append(None if blob is None else ("blob", blob))
            else:
                out.append(None)
        return out

    def drain_loads(self) -> List[Tuple[bytes, int, object, bool]]:
        """(hash, block, bytes, remote) loads the engine must land in the
        HBM arrays before its next kernel launch — host-tier hits at
        admission (remote=False) + adopted imports (remote=True). Entries
        for since-evicted blocks were already dropped at eviction."""
        out = [
            (h, b, blob, remote)
            for b, (h, blob, remote) in self._pending_loads.items()
        ]
        self._pending_loads.clear()
        return out

    def drain_saves(self) -> List[Tuple[bytes, int]]:
        """(hash, block) eviction saves: the engine must copy these blocks'
        HBM bytes into the host tier BEFORE applying COW copies, loads, or
        kernels (the block is already reallocated — this drain order is
        what keeps the bytes readable)."""
        out, self._pending_saves = self._pending_saves, []
        return out

    def drain_cow(self) -> List[Tuple[int, int]]:
        """(src, dst) physical block copies queued by copy-on-write forks.
        The engine MUST apply these to the KV arrays before its next kernel
        launch; draining also re-exposes the sources to eviction."""
        out, self._pending_copies = self._pending_copies, []
        return out

    def free(self, seq_id: str) -> int:
        """Release a finished/preempted sequence's references. Blocks
        reaching refcount 0 return to the free list — except registered
        (full, hashed) blocks, which are RETAINED on the cached LRU list to
        serve future prefix hits until evicted. Raises KeyError on an
        unknown (or already-freed) seq_id — the double-free guard."""
        table = self._tables.pop(seq_id)  # KeyError = double free
        del self._lens[seq_id]
        self._chain.pop(seq_id, None)
        self._landed.pop(seq_id, None)
        for b in table:
            self._release_one(b)
        return len(table)

    def check_invariants(self) -> None:
        """Every block is in exactly one place (free xor cached xor live),
        refcounts match table references, and the hash index is bijective
        over registered blocks."""
        seen = set(self._free)
        assert len(seen) == len(self._free), "free list has duplicates"
        assert self.NULL_BLOCK not in seen, "null block on the free list"
        for b in self._cached:
            assert b not in seen, f"block {b} free AND cached"
            assert b in self._hash_of, f"cached block {b} has no registered hash"
            assert b not in self._ref, f"cached block {b} has live refs"
            seen.add(b)
        refs: Dict[int, int] = {}
        for sid, table in self._tables.items():
            assert len(table) == self.blocks_for(self._lens[sid]), (
                f"{sid!r}: table/len mismatch"
            )
            assert len(self._chain.get(sid, ())) <= len(table), (
                f"{sid!r}: more registered blocks than table entries"
            )
            for b in table:
                assert b not in self._free and b not in self._cached, (
                    f"block {b} live AND free/cached"
                )
                refs[b] = refs.get(b, 0) + 1
        assert refs == self._ref, (
            f"refcount drift: counted {refs}, recorded {self._ref}"
        )
        seen.update(refs)
        assert len(seen) == self.num_blocks - 1, "lost/leaked blocks"
        for h, b in self._index.items():
            assert self._hash_of.get(b) == h, f"index/hash_of drift on block {b}"
        for b, h in self._hash_of.items():
            assert self._index.get(h) == b, f"hash_of/index drift on block {b}"
        for sid, landed in self._landed.items():
            assert landed <= self._lens[sid], (
                f"{sid!r}: landed watermark {landed} past allocation "
                f"{self._lens[sid]}"
            )
        for b, (h, *_rest) in self._pending_loads.items():
            assert b not in self._free, f"pending-load block {b} on free list"
            assert self._hash_of.get(b) == h, (
                f"pending-load block {b} no longer registered under its hash"
            )

"""Prefix-affinity replica selection (pure policy, no actors, no JAX).

The routing key is the SAME chained blake2b content hash the engine's
`KVBlockManager` registers full KV blocks under: `routing_chain(prompt)`
hashes the prompt's leading full blocks into a chain h1..hB (hB commits to
every token in blocks 0..B-1).  A replica whose prefix cache holds the
first j blocks of that prompt has h1..hj in its hot-prefix digest, so the
deepest digest match predicts exactly how many blocks of prefill the
replica would skip.

Selection order (`pick_replica`):

  1. SPILL GUARD — replicas whose load (engine queue depth + the caller's
     own outstanding count) is at or past `spill_threshold` are excluded;
     affinity must never pile more requests onto an already-drowning
     replica.  If EVERY replica is past the threshold, fall through to
     pure power-of-two load balancing (placement quality is moot when the
     whole fleet is saturated).
  2. AFFINITY — among eligible replicas, pick the deepest digest match;
     ties break by lower load, then rendezvous rank (deterministic).
  3. RENDEZVOUS — cold prefix (no digest hit anywhere, or every digest is
     stale/absent): rendezvous-hash the deepest chain key over replica
     tags.  Identical prompts from ANY router converge on the same
     replica, so the second arrival hits the cache the first one warmed.
  4. POWER-OF-TWO — no routing key at all (prompt shorter than one block,
     non-LLM method): classic two-choices on load.

Digest entries travel the control plane truncated to `DIGEST_HASH_BYTES`
hex (the digest is advisory — a truncation collision merely routes to a
replica that turns out to miss; correctness-critical matching stays inside
the engine on full 16-byte hashes).
"""

from __future__ import annotations

import hashlib
import random
from typing import Dict, List, Optional, Sequence, Tuple

# The hash AND its wire truncation are the kv_manager's: the router's
# chain entries must compare equal to replica digest entries byte for byte.
from ..engine.kv_manager import DIGEST_HASH_BYTES, _chain_hash

# Leading full blocks hashed into the routing key. Deeper adds nothing:
# affinity only needs to discriminate prefixes, not verify them.
MAX_ROUTING_BLOCKS = 8


def routing_chain(
    prompt: Sequence[int],
    block_size: int,
    max_blocks: int = MAX_ROUTING_BLOCKS,
) -> List[str]:
    """Chained content hashes (truncated hex) of the prompt's leading FULL
    blocks — `chain[i]` commits to blocks 0..i. Mirrors the engine's
    admission rule: the last prompt token never counts toward a cacheable
    block, so a prompt of exactly one block yields an empty chain."""
    if block_size <= 0 or len(prompt) <= 1:
        return []
    full = min((len(prompt) - 1) // block_size, max_blocks)
    chain: List[str] = []
    prev = b""
    for i in range(full):
        h = _chain_hash(prev, prompt[i * block_size:(i + 1) * block_size])
        chain.append(h[:DIGEST_HASH_BYTES].hex())
        prev = h
    return chain


def rendezvous_rank(key: str, tag: str) -> bytes:
    """Highest-random-weight score of (routing key, replica tag) — every
    router ranks replicas identically, so cold prefixes converge without
    any shared state. Also THE rendezvous hash for multiplexed-model
    routing (`handle.py._pick_replica` calls this) — one construction,
    tuned once."""
    return hashlib.blake2b(f"{key}:{tag}".encode(), digest_size=8).digest()


def _digest_depth(chain: Sequence[str], digest) -> int:
    """Deepest chain entry present in a replica's hot-prefix digest
    (1-based; 0 = no match). The digest is bounded and hot-ordered, so a
    shallow hash may have aged out while a deeper one survives — the
    deepest match alone is the signal."""
    if not digest:
        return 0
    d = digest if isinstance(digest, (set, frozenset)) else set(digest)
    for i in range(len(chain) - 1, -1, -1):
        if chain[i] in d:
            return i + 1
    return 0


def pick_replica(
    chain: Sequence[str],
    tags: Sequence[str],
    metas: Sequence[Optional[Dict]],
    outstanding: Dict[int, int],
    spill_threshold: int,
    rng: Optional[random.Random] = None,
) -> Tuple[int, str]:
    """Choose a replica index for one request.

    `metas[i]` is replica i's latest telemetry (None when stale/absent):
    `{"digest": [hex...], "queue_depth": int, ...}`. `outstanding` is the
    caller's local in-flight count per index — the freshest load signal it
    has between telemetry refreshes. Returns (index, reason) with reason in
    {"affinity", "rendezvous", "pow2", "spill"} for metrics/tests.
    """
    n = len(tags)
    if n == 0:
        raise ValueError("no replicas")
    if n == 1:
        return 0, "pow2"
    pick = rng or random

    def load(i: int) -> int:
        q = 0
        m = metas[i] if i < len(metas) else None
        if m:
            q = int(m.get("queue_depth") or 0)
        return q + int(outstanding.get(i, 0))

    eligible = [i for i in range(n) if load(i) < spill_threshold]
    if not eligible:
        # Whole fleet saturated: spread by load, ignore affinity.
        a, b = pick.sample(range(n), 2)
        return (a if load(a) <= load(b) else b), "spill"

    if chain:
        key = chain[-1]
        best, best_rank = None, None
        for i in eligible:
            depth = _digest_depth(chain, (metas[i] or {}).get("digest"))
            rank = (depth, -load(i), rendezvous_rank(key, tags[i]))
            if best_rank is None or rank > best_rank:
                best, best_rank = i, rank
        if best_rank[0] > 0:
            return best, "affinity"
        # Cold prefix everywhere (or digests stale): deterministic
        # convergence — the SECOND arrival of this prefix must find the
        # replica the first one warmed.
        best = max(eligible, key=lambda i: rendezvous_rank(key, tags[i]))
        return best, "rendezvous"

    # No routing key: power-of-two choices on load.
    if len(eligible) == 1:
        return eligible[0], "pow2"
    a, b = pick.sample(eligible, 2)
    return (a if load(a) <= load(b) else b), "pow2"


# --------------------------------------------------- disaggregated pools
def split_pools(
    roles: Sequence[Optional[str]],
) -> Tuple[List[int], List[int]]:
    """(prefill indices, decode indices) from per-replica pool roles.
    A replica with no role / role "mixed" belongs to neither pool —
    disaggregated orchestration only engages when BOTH pools are non-empty
    (`serve/handle.py`), so a mixed fleet keeps the colocated path. The
    pool split is what implements role routing: the router runs
    `pick_replica` over the PREFILL pool with the prompt's digest chain
    (deepest-affinity placement — that pool owns the prefix caches) and
    over the DECODE pool with no chain (pure load: its cache is fed by
    imports, so placement is about lane pressure, not affinity)."""
    prefill: List[int] = []
    decode: List[int] = []
    for i, role in enumerate(roles):
        if role == "prefill":
            prefill.append(i)
        elif role == "decode":
            decode.append(i)
    return prefill, decode

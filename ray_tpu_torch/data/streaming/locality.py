"""Locality scorer: route consumers to the node holding their input bytes.

A reduce task for partition ``j`` reads span ``j`` of EVERY map segment; a
chained map task reads exactly one bundle segment. Both placements reduce to
one question — which node holds the largest share of the bytes this task
will fetch? Score = Σ segment_bytes grouped by the segment's source node,
routed via soft ``NodeAffinitySchedulingStrategy`` (the controller's
``_candidate_nodes`` affinity ordering tries the pinned node first and falls
back to the normal hybrid order, so a busy/dead best node degrades to
default scheduling instead of stalling).

Source nodes resolve through ONE batched ``object_sources`` controller round
trip per exchange (the same directory lookup the span-fetch rung uses) with
the descriptor's recorded producer node as fallback — descriptors always
know where they were born even when the directory is momentarily behind.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from ...core import api
from ...core.task_spec import NodeAffinitySchedulingStrategy

# Pin only when one node holds a DOMINANT share of the task's input bytes.
# Locality on a near-tie buys almost nothing (half the bytes cross the wire
# either way) but costs everything: argmax breaks every ~50/50 partition to
# the same marginally-larger node, piling the whole reduce stage onto it
# while its peers idle. Below the threshold the scheduler's own hybrid
# balance wins.
DOMINANT_SHARE = 0.65


def segment_nodes(descs: Sequence[Dict[str, Any]]) -> List[Optional[str]]:
    """Current source node of each descriptor's segment (best effort)."""
    out: List[Optional[str]] = [d.get("node") for d in descs]
    try:
        backend = api._global_runtime().backend
        sources_of = getattr(backend, "object_sources", None)
        if sources_of is None:
            return out
        resolved = sources_of([d["ref"].id.hex() for d in descs])
        for i, src in enumerate(resolved):
            if src and src.get("node"):
                out[i] = src["node"]
    except Exception:  # noqa: BLE001 — placement is advisory, never fatal
        pass
    return out


def best_node_for_partition(
    descs: Sequence[Dict[str, Any]],
    j: int,
    nodes: Sequence[Optional[str]],
) -> Optional[str]:
    """Node holding a dominant share of partition-``j`` bytes across the
    map segments; None on a near-tie (let the scheduler balance)."""
    score: Dict[str, int] = {}
    total = 0
    for d, node in zip(descs, nodes):
        try:
            nbytes = int(d["bytes"][j])
        except (KeyError, IndexError, TypeError, ValueError):
            continue
        if nbytes <= 0:
            continue
        total += nbytes
        if node is not None:
            score[node] = score.get(node, 0) + nbytes
    if not score or total <= 0:
        return None
    node, best = max(score.items(), key=lambda kv: kv[1])
    return node if best >= DOMINANT_SHARE * total else None


def best_node_for_bundles(bundles) -> Optional[str]:
    """Placement for a task consuming WHOLE bundles (train-side consumers):
    the node holding the largest share of the bundles' descriptor bytes."""
    descs = [b.desc for b in bundles if getattr(b, "desc", None) is not None]
    if not descs:
        return None
    nodes = segment_nodes(descs)
    score: Dict[str, int] = {}
    total = 0
    for d, node in zip(descs, nodes):
        nbytes = int(sum(d.get("bytes") or [0]))
        total += nbytes
        if node is not None:
            score[node] = score.get(node, 0) + nbytes
    if not score or total <= 0:
        return None
    node, best = max(score.items(), key=lambda kv: kv[1])
    return node if best >= DOMINANT_SHARE * total else None


def affinity_options(node: Optional[str]) -> Dict[str, Any]:
    """kwargs for ``RemoteFunction.options`` pinning softly to ``node``."""
    if node is None:
        return {}
    return {"scheduling_strategy":
            NodeAffinitySchedulingStrategy(node_id=node, soft=True)}
